from repro_torch.optim.sgd import momentum_apply, momentum_init, sgd_apply, sgd_init

__all__ = ["momentum_apply", "momentum_init", "sgd_apply", "sgd_init"]
