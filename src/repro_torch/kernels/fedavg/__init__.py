from repro_torch.kernels.fedavg.ops import (
    eager_accumulate,
    fedavg_accumulate_k,
    fedavg_reduce,
    fedavg_reduce_tree,
    flatten_update,
    unflatten_update,
)

__all__ = [
    "eager_accumulate",
    "fedavg_accumulate_k",
    "fedavg_reduce",
    "fedavg_reduce_tree",
    "flatten_update",
    "unflatten_update",
]
