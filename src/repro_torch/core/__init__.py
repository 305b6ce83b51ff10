"""LIFL core, ported: the data plane (object store, gateway,
aggregation, engines) and the control plane (placement, hierarchy,
reuse, coordinator, sidecar).  Every module but ``engine`` is the JAX
package's own, copied with only the import prefix changed."""
from repro_torch.core.aggregation import Aggregator, FedAvgState, fedavg_oracle
from repro_torch.core.coordinator import (
    ClientInfo,
    Coordinator,
    RoundConfig,
    RoundPlan,
    Selector,
)
from repro_torch.core.engine import (
    AggregationEngine,
    BlockedNumpyEngine,
    ENGINE_NAMES,
    EngineConfig,
    NaiveEngine,
    TorchEngine,
    make_engine,
)
from repro_torch.core.gateway import UpdateEnvelope
from repro_torch.core.objectstore import InProcObjectStore
from repro_torch.core.placement import NodeState
from repro_torch.core.sidecar import EventSidecar, MetricsMap

__all__ = [
    "AggregationEngine", "Aggregator", "BlockedNumpyEngine", "ClientInfo",
    "Coordinator", "ENGINE_NAMES", "EngineConfig", "EventSidecar",
    "FedAvgState", "InProcObjectStore", "MetricsMap", "NaiveEngine",
    "NodeState", "RoundConfig", "RoundPlan", "Selector", "TorchEngine",
    "UpdateEnvelope", "fedavg_oracle", "make_engine",
]
