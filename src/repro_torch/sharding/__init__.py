from repro_torch.sharding.rules import (
    PartitionSpec,
    batch_specs,
    block_bytes,
    cache_specs,
    divisibility_fix,
    gather_tree,
    param_specs,
    shard_tree,
)

# the JAX package's names, ``to_named`` as ``shard_tree`` (the storage
# the specs name); the rest are the port's own
__all__ = [
    "batch_specs",
    "cache_specs",
    "divisibility_fix",
    "param_specs",
    "shard_tree",
]
