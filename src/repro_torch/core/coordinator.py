"""LIFL coordinator + selector: round lifecycle orchestration (Fig 3/6).

Per round (§3, §5):
  1. the selector picks a diverse cohort, over-provisioned beyond the
     aggregation goal n (resilience: stragglers/failures just don't make
     the goal — no round stall);
  2. load balancing bin-packs the expected updates onto worker nodes
     (BestFit, §5.1) — this *is* the client→node mapping that makes
     in-place queuing locality-aware;
  3. the hierarchy planner sizes each node's two-level tree from the
     EWMA'd queue estimates (§5.2) and the pool acquires/reuses warm
     aggregators (§5.3);
  4. the routing manager installs the TAG; gateways feed leaf
     aggregators; eager aggregation streams to the top (§5.4);
  5. on goal: bump the global model version, trigger the async
     checkpoint (App-B).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hierarchy import HierarchyPlan, HierarchyPlanner
from repro_torch.core.placement import (
    FoldPlan,
    NodeState,
    Placement,
    PlacementState,
    build_fold_plan,
    choose_fanout,
    choose_top_node,
    inter_node_transfers,
    place_updates,
)
from repro_torch.core.reuse import AggregatorPool, Role
from repro_torch.core.tag import TAG, build_two_level_tag

#: relative EWMA-load drift (vs a node's MC) that invalidates a cached
#: plan: the cache key quantizes each node's background load
#: (queue_estimate + ship) into buckets of ``PLAN_DRIFT_REL × MC`` —
#: sub-threshold drift keeps the key (and the plan) stable, a node
#: drifting past it forces a replan.
PLAN_DRIFT_REL = 0.05


@dataclass
class ClientInfo:
    client_id: str
    num_samples: int = 1
    available: bool = True
    last_selected_round: int = -1


class Selector:
    """Diversity-aware client selection + gateway mapping (paper §2.2).

    Diversity heuristic: least-recently-selected first with random
    tie-breaking — every client cycles through over time, matching the
    representative-sampling role without modeling Oort-style utility."""

    def __init__(self, clients: Sequence[ClientInfo], seed: int = 0):
        self.clients = {c.client_id: c for c in clients}
        self.rng = random.Random(seed)

    def select(self, n: int, round_id: int) -> List[ClientInfo]:
        pool = [c for c in self.clients.values() if c.available]
        self.rng.shuffle(pool)
        pool.sort(key=lambda c: c.last_selected_round)
        chosen = pool[:n]
        for c in chosen:
            c.last_selected_round = round_id
        return chosen


@dataclass
class RoundConfig:
    aggregation_goal: int          # n in Eq. 1
    over_provision: float = 1.3    # select n·factor clients (§3 resilience)
    fan_in: int = 2                # leaf fan-in I (§5.2)
    placement_policy: str = "bestfit"
    eager: bool = True
    # "inproc": the single-process tree (simulator-faithful, any OS);
    # "shmproc": real aggregator worker processes over shared-memory
    # rings (repro_torch.runtime.shmrt) — Linux, event-driven, zero-copy
    runtime: str = "inproc"
    # where the round's root fold runs (the FoldPlan root tier):
    # "controller" — the driver folds partials in its own process;
    # "worker"     — the top aggregator is itself a runtime aggregator
    #                (a parked worker process under shmproc);
    # "node"       — the root lives on the busiest worker node and the
    #                other nodes ship partials daemon→daemon (netrt) —
    #                only the final folded Σc·u returns to the controller
    topology: str = "controller"
    # fold-tree fanout cap: None keeps the historical two-level plan
    # (bit for bit); an int K folds >K mids through log-depth inner
    # stages; "auto" picks K from the fleet's exec/wire EWMAs
    # (placement.choose_fanout) at plan time
    fold_fanout: Any = None
    # reuse the previous round's placement + fold plan when the cohort
    # shape (count, policy, topology, fleet signature) is unchanged —
    # only the round tag is restamped.  False replans from scratch
    # every round (the bit-exactness reference path).
    plan_cache: bool = True


@dataclass
class RoundPlan:
    round_id: int
    selected: List[ClientInfo]
    placement: Placement
    hierarchy: HierarchyPlan
    tag: TAG
    top_node: Optional[str]
    cold_starts: int
    reused: int
    fold_plan: Optional[FoldPlan] = None

    @property
    def inter_node_updates(self) -> int:
        return inter_node_transfers(self.placement.assignment, self.top_node or "")


@dataclass
class _JobState:
    """One registered job's slot on a shared coordinator: its own
    selector/cohort, fair-share weight, and round/version counters."""

    name: str
    selector: Selector
    weight: float = 1.0
    round_id: int = 0
    model_version: int = 0


class Coordinator:
    """Cluster-wide control-plane component.

    Historically one per FL job; under the serve layer ONE coordinator
    is shared by several jobs (:meth:`register_job`) whose placements
    draw on the same RC capacity model — each job packs against
    ``share × MC`` per node (weighted fair-share, §5.1 extended), so
    the fleet splits in proportion to job weights instead of the first
    planner draining it."""

    def __init__(
        self,
        selector: Selector,
        nodes: Dict[str, NodeState],
        planner: Optional[HierarchyPlanner] = None,
        pool: Optional[AggregatorPool] = None,
    ):
        self.selector = selector
        self.nodes = nodes
        self.planner = planner or HierarchyPlanner()
        self.pool = pool or AggregatorPool()
        self.model_version = 0
        self.round_id = 0
        self.history: List[RoundPlan] = []
        # multi-job serve mode: job name → its slot.  Empty for the
        # single-job library path, which keeps the legacy fields above.
        self._jobs: Dict[str, _JobState] = {}
        # outstanding placement charges: (job, rid) → node → updates
        # placed.  While ANY round is in flight its charges stay on
        # NodeState.assigned so a concurrent job's packer sees real
        # occupancy; finish_round lifts exactly its own round's charge.
        self._charges: Dict[Tuple[str, int], Dict[str, float]] = {}
        # incremental planning state (O(round-delta), not O(pool)):
        # the persistent residual index the packer runs on (repaired
        # by churn handlers + per-node drift compares, never rebuilt
        # per round), the set of nodes actually carrying placement
        # load (so the between-rounds reset touches only them), and a
        # one-slot-per-job plan cache keyed on cohort shape
        self.placement_state = PlacementState(nodes)
        self._loaded: set = set()
        self._plan_cache: Dict[str, Tuple] = {}   # job → (key, slot…)
        self.plan_cache_stats = {"hits": 0, "misses": 0,
                                 "invalidations": 0}

    # ------------------------------------------------------------------
    # multi-job registry (serve mode)
    # ------------------------------------------------------------------
    def register_job(self, job: str, clients, weight: float = 1.0,
                     seed: int = 0) -> None:
        """Register a named job: its client pool (a ``Selector`` or a
        sequence of :class:`ClientInfo`) and fair-share weight."""
        if not job:
            raise ValueError("job name must be non-empty")
        sel = clients if isinstance(clients, Selector) \
            else Selector(clients, seed=seed)
        self._jobs[job] = _JobState(name=job, selector=sel,
                                    weight=float(weight))

    def job_share(self, job: str) -> float:
        """``weight_j / Σ weights`` over registered jobs (1.0 when the
        job is unregistered — the single-job path)."""
        js = self._jobs.get(job)
        if js is None:
            return 1.0
        total = sum(j.weight for j in self._jobs.values())
        return js.weight / total if total > 0 else 1.0

    def job_round(self, job: str = "") -> int:
        """The job's next round number."""
        js = self._jobs.get(job)
        return js.round_id if js is not None else self.round_id

    def job_version(self, job: str = "") -> int:
        js = self._jobs.get(job)
        return js.model_version if js is not None else self.model_version

    # ------------------------------------------------------------------
    def _plan_key(self, cfg: RoundConfig, job: str, share: float,
                  num_updates: int) -> Tuple:
        """Cohort-shape signature a cached plan is keyed on: the round's
        placement inputs (count, policy, topology, fanout, share) plus a
        per-node fleet signature.  Capacity and already-charged load are
        exact (a different in-flight charge is a different packing
        problem); the EWMA-fed background load is drift-quantized so a
        cached plan survives sub-threshold telemetry noise but not a
        node drifting past ``PLAN_DRIFT_REL`` of its capacity."""
        sig = tuple(
            (n, ns.max_capacity, ns.assigned,
             int((ns.queue_estimate
                  + (ns.wire_time_s / ns.exec_time_s
                     if ns.exec_time_s > 0 else 0.0))
                 / (PLAN_DRIFT_REL * max(ns.max_capacity, 1e-9))))
            for n, ns in self.nodes.items())
        return (cfg.topology, cfg.placement_policy, cfg.fold_fanout,
                share, num_updates, sig)

    def _invalidate_plans(self) -> None:
        """Node churn: every cached plan references the dead fleet."""
        if self._plan_cache:
            self.plan_cache_stats["invalidations"] += len(self._plan_cache)
            self._plan_cache.clear()

    def plan_round(self, cfg: RoundConfig,
                   sampler: Optional[Callable] = None,
                   job: str = "",
                   tag_rounds: bool = False) -> RoundPlan:
        js = self._jobs.get(job)
        if job and js is None:
            raise KeyError(f"job {job!r} not registered")
        selector = js.selector if js is not None else self.selector
        rid = js.round_id if js is not None else self.round_id
        share = self.job_share(job)
        n_select = int(np.ceil(cfg.aggregation_goal * cfg.over_provision))
        if sampler is not None:
            # pluggable per-round client sampling: the sampler sees the
            # available pool and owns the choice (seed its own RNG for
            # reproducible cohorts); selection bookkeeping still applies
            pool = [c for c in selector.clients.values() if c.available]
            selected = list(sampler(rid, pool))
            for c in selected:
                c.last_selected_round = rid
        else:
            selected = selector.select(n_select, rid)

        # re-planning the same round replaces its charge, not stacks it
        stale = self._charges.pop((job, rid), None)
        if stale:
            for node, c in stale.items():
                ns = self.nodes.get(node)
                if ns is not None:
                    ns.assigned = max(0.0, ns.assigned - c)
        # reset per-round assignment, keep k/E from metrics — but only
        # while no other round holds a charge: with rounds in flight
        # (rolling rounds, a concurrent job) their placements are real
        # occupancy the packer must see.  O(loaded), not O(pool): only
        # the nodes a charge ever touched can carry assignment.
        if not self._charges:
            for node in self._loaded:
                ns = self.nodes.get(node)
                if ns is not None:
                    ns.assigned = 0.0
            self._loaded.clear()

        round_tag = rid if (job or tag_rounds) else None
        key = self._plan_key(cfg, job, share, len(selected))
        slot = self._plan_cache.get(job) if cfg.plan_cache else None
        hit = slot is not None and slot["key"] == key
        if hit:
            # cache hit: same cohort shape against the same fleet state
            # — reuse the placement and fold tree, restamp the round
            # tag, and re-apply the placement charge (integer-valued
            # adds, so the batch add reproduces the from-scratch floats
            # bit for bit)
            self.plan_cache_stats["hits"] += 1
            placement, top = slot["placement"], slot["top"]
            charge = slot["charge"]
            for node, c in charge.items():
                ns = self.nodes.get(node)
                if ns is not None:
                    ns.assigned += c
            fold_plan = slot["plan"].restamp(round_tag)
        else:
            if cfg.plan_cache:
                self.plan_cache_stats["misses"] += 1
                if slot is not None:
                    self.plan_cache_stats["invalidations"] += 1
            placement = place_updates(
                len(selected), self.nodes, policy=cfg.placement_policy,
                share=share, state=self.placement_state,
            )
            top = choose_top_node(self.nodes, placement.assignment)
            fanout = cfg.fold_fanout
            if fanout == "auto":
                fanout = choose_fanout(
                    sum(1 for idxs in placement.assignment.values() if idxs),
                    self.nodes)
            fold_plan = build_fold_plan(
                placement.assignment, top_node=top, topology=cfg.topology,
                nodes=self.nodes, job=job, round_tag=round_tag,
                fanout=fanout)
            charge = {n: float(len(idxs))
                      for n, idxs in placement.assignment.items() if idxs}
            if cfg.plan_cache:
                slot = {"key": key, "placement": placement, "top": top,
                        "plan": fold_plan, "charge": charge,
                        "leaves": None, "tag": None}
                self._plan_cache[job] = slot
        self._charges[(job, rid)] = dict(charge)
        self._loaded.update(charge)

        queue_by_node = {
            node: float(len(idxs)) for node, idxs in placement.assignment.items()
        }
        hierarchy = self.planner.plan(queue_by_node, top_node=top)

        # acquire aggregators (reuse warm ones first — §5.3)
        cold = reused_before = self.pool.stats.reused
        cold_before = self.pool.stats.cold_starts
        for node, plan in hierarchy.per_node.items():
            for _ in range(plan.num_leaves):
                self.pool.acquire(node, Role.LEAF)
            if plan.has_middle:
                self.pool.acquire(node, Role.MIDDLE)
        if top is not None:
            self.pool.acquire(top, Role.TOP)
        cold_starts = self.pool.stats.cold_starts - cold_before
        reused = self.pool.stats.reused - reused_before

        # the TAG is a pure function of (leaf layout, fan-in, top): on a
        # plan-cache hit with an unchanged hierarchy the cached TAG is
        # reused instead of re-materializing O(cohort) channel entries
        leaves = {n: p.num_leaves for n, p in hierarchy.per_node.items()}
        if hit and slot["leaves"] == leaves:
            tag = slot["tag"]
        else:
            tag = build_two_level_tag(
                leaves, clients_per_leaf=cfg.fan_in,
                top_node=top or next(iter(self.nodes)),
            )
        if cfg.plan_cache and slot is not None:
            slot["leaves"], slot["tag"] = leaves, tag
        plan = RoundPlan(
            round_id=rid, selected=selected, placement=placement,
            hierarchy=hierarchy, tag=tag, top_node=top,
            cold_starts=cold_starts, reused=reused, fold_plan=fold_plan,
        )
        self.history.append(plan)
        return plan

    # ------------------------------------------------------------------
    def finish_round(self, checkpoint_fn: Optional[Callable] = None,
                     job: str = "",
                     round_id: Optional[int] = None) -> int:
        """Aggregation goal reached: release instances back to the warm
        pool, lift the round's placement charge off the capacity model,
        bump the job's model version, kick the async checkpoint (App-B).

        ``round_id`` names which of the job's rounds closed (rolling
        rounds may close out of order); default = the job's oldest
        outstanding round."""
        for agg_id in list(self.pool.instances):
            self.pool.release(agg_id)
        if round_id is None:
            mine = sorted(r for (j, r) in self._charges if j == job)
            round_id = mine[0] if mine else self.job_round(job)
        charge = self._charges.pop((job, round_id), None)
        if charge:
            for node, c in charge.items():
                ns = self.nodes.get(node)
                if ns is not None:
                    ns.assigned = max(0.0, ns.assigned - c)
        js = self._jobs.get(job)
        if js is not None:
            js.model_version += 1
            js.round_id = max(js.round_id, round_id) + 1
            version = js.model_version
        else:
            self.model_version += 1
            self.round_id = max(self.round_id, round_id) + 1
            version = self.model_version
        if checkpoint_fn is not None:
            checkpoint_fn(version)
        return version

    def scale_down(self) -> int:
        """Terminate idle aggregators after load drops (load-proportional
        resource use — what Fig 10(b) shows for LIFL vs SF)."""
        return self.pool.terminate_idle()

    # ------------------------------------------------------------------
    def handle_event(self, event) -> None:
        """Ordinary event handler for the round driver: node churn
        reshapes the next ``plan_round`` (the shared ``nodes`` dict) and
        retires the lost node's pooled aggregators; each subtree's
        ``PartialReady`` feeds that node's RC capacity model (§5.1) —
        E_{i,t} from the measured fold time, k_{i,t} from the folded
        count — so multi-node placement learns per-node speed from the
        same events that ride the wire."""
        from repro_torch.runtime.events import (NodeJoined, NodeLost,
                                          NodeRejoined, PartialReady,
                                          PartialShipped, TopFolded)

        if isinstance(event, NodeJoined):
            ns = NodeState(node=event.node,
                           max_capacity=event.capacity or 20.0)
            self.nodes[event.node] = ns
            self.placement_state.add(ns)
            self._invalidate_plans()
        elif isinstance(event, NodeRejoined):
            # a restarted daemon re-adopted under its old name: put it
            # back in the RC capacity model iff NodeLost removed it
            # (same-epoch re-dials never lost capacity state)
            if event.node not in self.nodes:
                ns = NodeState(node=event.node,
                               max_capacity=event.capacity or 20.0)
                self.nodes[event.node] = ns
                self.placement_state.add(ns)
                self._invalidate_plans()
        elif isinstance(event, NodeLost):
            if self.nodes.pop(event.node, None) is not None:
                self._invalidate_plans()
            self.placement_state.remove(event.node)
            self._loaded.discard(event.node)
            for agg_id, inst in list(self.pool.instances.items()):
                if inst.node == event.node:
                    self.pool.terminate(agg_id)
        elif isinstance(event, PartialReady):
            ns = self.nodes.get(event.agg_id.split("@", 1)[-1])
            if ns is not None:
                exec_s = max(event.exec_s, 1e-6)
                ns.exec_time_s = 0.5 * ns.exec_time_s + 0.5 * exec_s
                # k_{i,t} is a RATE (updates/s), not a count, and the
                # planner computes Q = k·E with the BLENDED E — so the
                # rate must be taken against that same blended value or
                # the units mix across rounds (a node whose measured
                # exec is far below the 1.0s default would look
                # saturated while idle).  Q then tracks the in-flight
                # update count (Little's law), in `updates` units.
                ns.arrival_rate = 0.5 * ns.arrival_rate + 0.5 * (
                    float(event.count) / ns.exec_time_s)
        elif isinstance(event, TopFolded):
            # the root fold's measured cost was dropped on the floor
            # until the obs layer stamped it (exec_s) — price it into
            # the root node's EWMA exactly like a mid's PartialReady,
            # but only when the fold actually ran ON that node (worker/
            # node tiers); a controller-tier fold burns controller CPU
            # and says nothing about the node it is nominally named for
            if event.tier in ("worker", "node") and event.exec_s > 0.0:
                ns = self.nodes.get(event.node)
                if ns is not None:
                    exec_s = max(event.exec_s, 1e-6)
                    ns.exec_time_s = 0.5 * ns.exec_time_s + 0.5 * exec_s
                    ns.arrival_rate = 0.5 * ns.arrival_rate + 0.5 * (
                        float(event.count) / ns.exec_time_s)
        elif isinstance(event, PartialShipped):
            # daemon-measured serialize+send wall for one sealed partial
            # (src side): the uplink occupancy NodeState prices into RC
            if event.wire_s > 0.0:
                ns = self.nodes.get(event.src)
                if ns is not None:
                    ns.wire_time_s = (0.5 * ns.wire_time_s
                                      + 0.5 * event.wire_s)
