"""Event-driven cluster simulator — reproduces the paper's system-level
experiments (Fig 4, Fig 8, Fig 9/10) without a 20-node testbed.

Entities: clients (optionally hibernating mobile devices), per-node
gateways, aggregators (leaf/middle/top), a network with distinct
intra-node (shared-memory) and inter-node (kernel TCP) costs, and the
control plane (placement + hierarchy planner + reuse pool).

Cost model constants are calibrated from the paper's own measurements
(§6.1): inter-node ResNet-152 transfer ≈ 4.2 s; MC_i = 20 on the
testbed; eager aggregation saves ≈20% ACT; data-plane per-transfer
latencies from Fig 7(a).  Each figure benchmark states which constants
it uses so the reproduction is auditable.
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.hierarchy import HierarchyPlanner
from repro_torch.core.placement import NodeState, choose_top_node, place_updates
from repro_torch.core.reuse import AggregatorPool, Role


@dataclass
class DataPlaneCosts:
    """Per-transfer latency + CPU of one model update, by path.

    Defaults ≈ paper Fig 7(a/b) for ResNet-152 (~232 MB): LIFL intra-node
    (shared memory) ~0.7 s; serverful gRPC ~2.1 s (3× LIFL); serverless
    broker+sidecar ~4.1 s (5.8×); inter-node wire transfer ~4.2 s (§6.1).
    """

    t_intra_shm: float = 0.7
    t_intra_serverful: float = 2.1
    t_intra_serverless: float = 4.1
    t_inter_node: float = 4.2
    cpu_intra_shm: float = 0.15
    cpu_intra_serverful: float = 0.8
    cpu_intra_serverless: float = 2.4
    cpu_inter_node: float = 1.0
    t_agg: float = 0.55        # fold one ResNet-152 update (naive engine)
    cpu_agg: float = 0.55
    t_cold_start: float = 2.0  # container cold start
    cpu_cold_start: float = 1.0
    # Relative fold throughput of the aggregation engines (core/engine.py)
    # vs the naive scalar baseline.  Defaults from benchmarks/
    # bench_agg_kernel.py on the dev host (see BENCH_agg.json); bench_tta
    # re-calibrates from a live measurement before simulating.  "torch"
    # (TorchEngine: pinned staging + the fedavg kernels) over "naive", one
    # 44.8 MB ResNet-18 update folded from the host: chip_smoke.py's
    # engine_speedup on an NVIDIA H100 80GB HBM3 (700 W power limit), the
    # median of three runs in one call (4.09-5.59; the host's numpy
    # folds set the spread).
    agg_engine_speedup: Dict[str, float] = field(default_factory=lambda: {
        "naive": 1.0, "blocked": 4.0, "jnp": 2.0, "pallas": 8.0,
        "torch": 5.12,
    })

    def _speedup(self, engine: str) -> float:
        if engine == "auto":
            # the engine make_engine("auto") builds: "torch" in the port
            from repro_torch.core.engine import _auto_name
            engine = _auto_name()
        if engine not in self.agg_engine_speedup:
            raise ValueError(
                f"no fold-speedup calibration for engine {engine!r} "
                f"(known: {sorted(self.agg_engine_speedup)}); add it to "
                f"DataPlaneCosts.agg_engine_speedup")
        return self.agg_engine_speedup[engine]

    def t_agg_for(self, engine: str) -> float:
        return self.t_agg / self._speedup(engine)

    def cpu_agg_for(self, engine: str) -> float:
        return self.cpu_agg / self._speedup(engine)


@dataclass
class SimConfig:
    n_nodes: int = 5
    mc_per_node: float = 20.0          # MC_i (paper §6.1)
    placement_policy: str = "bestfit"  # worstfit = SL-H (Least Connection)
    hierarchy: bool = True
    reuse: bool = True
    eager: bool = True
    fan_in: int = 2
    dataplane: str = "shm"             # shm | serverful | serverless
    agg_engine: str = "naive"          # fold engine (core/engine.py)
    costs: DataPlaneCosts = field(default_factory=DataPlaneCosts)
    seed: int = 0


@dataclass
class SimResult:
    act_s: float                 # aggregation completion time
    cpu_s: float                 # CPU time consumed by aggregation svc
    aggregators_created: int
    aggregators_active: int
    nodes_used: int
    inter_node_transfers: int
    cold_starts: int
    reused: int


def _transfer_cost(cfg: SimConfig) -> Tuple[float, float]:
    c = cfg.costs
    if cfg.dataplane == "shm":
        return c.t_intra_shm, c.cpu_intra_shm
    if cfg.dataplane == "serverful":
        return c.t_intra_serverful, c.cpu_intra_serverful
    if cfg.dataplane == "serverless":
        return c.t_intra_serverless, c.cpu_intra_serverless
    raise ValueError(cfg.dataplane)


def simulate_round(
    num_updates: int,
    cfg: SimConfig,
    pool: Optional[AggregatorPool] = None,
    arrival_span_s: float = 0.0,
) -> SimResult:
    """Simulate one aggregation round of ``num_updates`` model updates.

    ``arrival_span_s``: client updates arrive uniformly over this span
    (eager aggregation overlaps it; lazy waits for the last arrival).
    """
    rng = random.Random(cfg.seed)
    c = cfg.costs
    t_agg = c.t_agg_for(cfg.agg_engine)
    cpu_agg = c.cpu_agg_for(cfg.agg_engine)
    t_intra, cpu_intra = _transfer_cost(cfg)
    pool = pool if pool is not None else AggregatorPool(cold_start_s=c.t_cold_start)

    nodes = {
        f"node{i}": NodeState(node=f"node{i}", max_capacity=cfg.mc_per_node)
        for i in range(cfg.n_nodes)
    }
    placement = place_updates(num_updates, nodes, policy=cfg.placement_policy)
    # overflow updates queue behind capacity — they still run, serialized
    top = choose_top_node(nodes, placement.assignment) or "node0"

    planner = HierarchyPlanner(fan_in=cfg.fan_in)
    created_before = pool.stats.created
    cold_before = pool.stats.cold_starts
    reused_before = pool.stats.reused

    cpu = 0.0
    node_times: List[float] = []
    inter_transfers = 0

    for node, idxs in placement.assignment.items():
        n_node = len(idxs)
        if n_node == 0:
            continue
        if cfg.hierarchy:
            n_leaves = max(1, math.ceil(n_node / cfg.fan_in))
            has_middle = n_leaves > 1
        else:
            n_leaves, has_middle = 1, False

        # reuse disabled -> caller passes a fresh pool, so every acquire
        # is a cold start; warm pool -> acquire returns idle instances
        cold_delay = 0.0
        for _ in range(n_leaves):
            _, d = pool.acquire(node, Role.LEAF)
            cold_delay = max(cold_delay, d)
            cpu += c.cpu_cold_start if d > 0 else 0.0
        if has_middle:
            _, d = pool.acquire(node, Role.MIDDLE)
            cold_delay = max(cold_delay, d)
            cpu += c.cpu_cold_start if d > 0 else 0.0

        per_leaf = math.ceil(n_node / n_leaves)
        # leaf level: receive per_leaf updates + fold each
        if cfg.eager:
            # arrivals (and the cold start) overlap aggregation; only the
            # last update's transfer+fold is exposed (§5.4)
            leaf_t = max(arrival_span_s, cold_delay) + per_leaf * (t_intra + t_agg)
        else:
            # lazy: wait for all arrivals, then aggregate the batch
            leaf_t = cold_delay + arrival_span_s + per_leaf * (t_intra + t_agg)
        cpu += n_node * (cpu_intra + cpu_agg)

        mid_t = 0.0
        if has_middle:
            mid_in = n_leaves
            if cfg.eager:
                mid_t = t_intra + mid_in * t_agg
            else:
                mid_t = mid_in * t_intra + mid_in * t_agg
            cpu += mid_in * (cpu_intra + cpu_agg)
        node_times.append(leaf_t + mid_t)
        if node != top:
            inter_transfers += 1

    # top level: one intermediate per used node
    _, d_top = pool.acquire(top, Role.TOP)
    n_used = max(1, len(placement.assignment))
    remote = max(0, n_used - 1)
    t_in_top = c.t_inter_node if remote else t_intra
    if cfg.eager:
        top_t = t_in_top + n_used * t_agg
    else:
        top_t = remote * c.t_inter_node + t_intra + n_used * t_agg
    cpu += remote * (c.cpu_inter_node + cpu_agg) + cpu_agg
    cpu += cpu_intra * 1

    act = (max(node_times) if node_times else 0.0) + top_t + (
        0.0 if cfg.reuse else c.t_cold_start
    )

    for agg_id in list(pool.instances):
        pool.release(agg_id)

    return SimResult(
        act_s=act,
        cpu_s=cpu,
        aggregators_created=pool.stats.created - created_before,
        aggregators_active=pool.count(),
        nodes_used=len(placement.assignment),
        inter_node_transfers=inter_transfers,
        cold_starts=pool.stats.cold_starts - cold_before,
        reused=pool.stats.reused - reused_before,
    )
