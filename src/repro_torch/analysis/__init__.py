from repro_torch.analysis.collectives import (CollectiveStats, RecordingWire,
                                              recorded_stats)
from repro_torch.analysis.op_cost import OpCost, op_count, step_cost
from repro_torch.analysis.roofline import (
    HBM_BW,
    NIC_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    Roofline,
    from_counts,
    model_flops,
)

# the JAX package's names, each HLO reader as its counterpart over the
# port's eager step (``collective_stats`` -> ``recorded_stats``,
# ``count_op`` -> ``op_count``, ``from_compiled`` -> ``from_counts``,
# ``ICI_BW`` / ``DCN_BW`` -> ``NVLINK_BW`` / ``NIC_BW``)
__all__ = [
    "CollectiveStats",
    "recorded_stats",
    "op_count",
    "Roofline",
    "from_counts",
    "model_flops",
    "PEAK_FLOPS",
    "HBM_BW",
    "NVLINK_BW",
    "NIC_BW",
]
