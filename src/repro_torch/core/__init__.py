"""LIFL core, ported: the paper's contribution as composable components.

Data plane  — objectstore (shared-memory, immutable keyed objects),
              gateway (in-place message queuing), routing + tag (sockmap
              direct routing, TAG), aggregation (step-based eager/lazy
              FedAvg); the fused counterpart lives in repro_torch.fl.round.
Control     — placement (BestFit locality packing, RC/MC capacity),
              hierarchy (EWMA planner), reuse (warm pool + executable
              cache), coordinator (selector + round lifecycle), sidecar
              (event-driven metrics).
simulation  — event-driven cluster sim for the paper-figure benchmarks.

Every module but ``engine`` and ``simulation`` is the JAX package's own,
copied with only the import prefix changed; the engines' kernel-backed
one is ``TorchEngine`` (the JAX package's ``JaxEngine``).
"""
from repro_torch.core.aggregation import Aggregator, FedAvgState, fedavg_oracle
from repro_torch.core.engine import (
    AggregationEngine,
    BlockedNumpyEngine,
    ENGINE_NAMES,
    EngineConfig,
    NaiveEngine,
    TorchEngine,
    autotune_block_elems,
    make_engine,
)
from repro_torch.core.coordinator import (
    ClientInfo,
    Coordinator,
    RoundConfig,
    RoundPlan,
    Selector,
)
from repro_torch.core.gateway import (
    Gateway,
    UpdateEnvelope,
    deserialize_update,
    serialize_update,
)
from repro_torch.core.hierarchy import (
    EWMA,
    HierarchyPlan,
    HierarchyPlanner,
    NodePlan,
    aggregation_completion_time,
)
from repro_torch.core.objectstore import (
    InProcObjectStore,
    SharedMemoryObjectStore,
    new_object_key,
    sweep_dead_segments,
)
from repro_torch.core.placement import (
    FoldPlan,
    FoldSite,
    NodeState,
    Placement,
    PlacementState,
    build_fold_plan,
    choose_fanout,
    choose_top_node,
    inter_node_transfers,
    measure_max_capacity,
    place_updates,
    plan_cross_node_transfers,
)
from repro_torch.core.reuse import AggregatorPool, ExecutableCache, Role, State
from repro_torch.core.routing import RoutingManager, SockMap, register_node, clear_registry
from repro_torch.core.sidecar import EventSidecar, MetricsMap, MetricsServer
from repro_torch.core.simulation import DataPlaneCosts, SimConfig, SimResult, simulate_round
from repro_torch.core.tag import (
    CHANNEL_NET,
    CHANNEL_SHM,
    ROLE_AGGREGATOR,
    ROLE_CLIENT,
    TAG,
    build_two_level_tag,
)
