from repro_torch.optim.adam import adam_apply, adam_init, clip_by_global_norm
from repro_torch.optim.schedule import constant, warmup_cosine
from repro_torch.optim.sgd import (momentum_apply, momentum_init, sgd_apply,
                                   sgd_init)

__all__ = [
    "adam_apply", "adam_init", "clip_by_global_norm",
    "constant", "warmup_cosine",
    "momentum_apply", "momentum_init", "sgd_apply", "sgd_init",
]
