from repro_torch.fl.round import (
    AggregationConfig,
    abstract_caches,
    abstract_params,
    build_decode_step,
    build_prefill_step,
    build_train_step,
    input_specs,
    serve_shardings,
    train_shardings,
)
from repro_torch.fl.server import apply_server_opt, init_server_state

__all__ = [
    "AggregationConfig",
    "abstract_caches",
    "abstract_params",
    "build_decode_step",
    "build_prefill_step",
    "build_train_step",
    "input_specs",
    "serve_shardings",
    "train_shardings",
    "apply_server_opt",
    "init_server_state",
]
