"""Opportunistic aggregator reuse (paper §5.3) + warm-runtime cache.

LIFL aggregators are *homogenized* runtimes (same code/libs at every
level), so an idle leaf can be promoted to middle, the first finished
middle to top — no new instance, no cold start, no state sync
(aggregators are stateless).  This sidesteps the cascading cold start
of scaling a function chain.

Host analogue of "cold start" in a JAX service: process/runtime spin-up
plus XLA compilation.  The pool therefore also carries a compiled-
executable cache keyed by the aggregation signature — a warm aggregator
is one whose runtime *and* executable are already resident; role
promotion is free because every level runs the same jaxpr.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple


class Role(str, Enum):
    LEAF = "leaf"
    MIDDLE = "middle"
    TOP = "top"


class State(str, Enum):
    COLD = "cold"          # no runtime yet
    WARMING = "warming"    # runtime starting (cold-start window)
    IDLE = "idle"          # warm, no task
    BUSY = "busy"


@dataclass
class AggregatorInstance:
    agg_id: str
    node: str
    role: Role = Role.LEAF
    state: State = State.COLD
    created_ts: float = 0.0
    cold_starts: int = 0
    promotions: int = 0
    tasks_done: int = 0
    # the instance's aggregation engine (core/engine.py): created
    # lazily via AggregatorPool.engine_for and kept resident across
    # release/acquire, so a warm aggregator re-enters a round with its
    # accumulator/scratch buffers already allocated — the fold-level
    # half of the §5.3 reuse benefit.  (The round runtimes' aggregators
    # are not pool-managed; they key warm engines by tree position —
    # see repro_torch.runtime.driver InProcRuntime.engine_for.)
    engine: Optional[Any] = None
    # creation sequence number: the idle index replays the historical
    # "first created wins" reuse order through it
    seq: int = 0


@dataclass
class PoolStats:
    created: int = 0
    reused: int = 0
    promoted: int = 0
    cold_starts: int = 0
    terminated: int = 0


class AggregatorPool:
    """Per-cluster registry of aggregator instances with reuse policy."""

    def __init__(self, cold_start_s: float = 1.0, engine: str = "auto"):
        self.cold_start_s = cold_start_s
        self.engine_spec = engine
        self.instances: Dict[str, AggregatorInstance] = {}
        self.stats = PoolStats()
        self._counter = 0
        # per-node idle index: a min-heap of (seq, agg_id) with lazy
        # deletion, so acquire is O(log idle) instead of a linear scan
        # over EVERY instance in the cluster (O(pool²) per round at 10k
        # clients).  The seq key reproduces the historical scan's
        # "first created wins" selection exactly.
        self._idle: Dict[str, List[Tuple[int, str]]] = {}

    # ------------------------------------------------------------------
    def acquire(self, node: str, role: Role) -> Tuple[AggregatorInstance, float]:
        """Get an aggregator for (node, role): reuse an idle warm
        instance on that node if any (role conversion is free — §5.3),
        else create one (pay the cold start).  Returns (instance,
        startup_delay_s)."""
        heap = self._idle.get(node)
        while heap:
            _seq, agg_id = heapq.heappop(heap)
            inst = self.instances.get(agg_id)
            if inst is None or inst.state != State.IDLE \
                    or inst.node != node:
                continue   # stale entry (terminated / re-acquired)
            if inst.role != role:
                inst.promotions += 1
                self.stats.promoted += 1
            inst.role = role
            inst.state = State.BUSY
            self.stats.reused += 1
            return inst, 0.0
        self._counter += 1
        inst = AggregatorInstance(
            agg_id=f"agg{self._counter}@{node}", node=node, role=role,
            state=State.BUSY, created_ts=time.perf_counter(), cold_starts=1,
            seq=self._counter,
        )
        self.instances[inst.agg_id] = inst
        self.stats.created += 1
        self.stats.cold_starts += 1
        return inst, self.cold_start_s

    def engine_for(self, inst: AggregatorInstance):
        """The instance's warm aggregation engine, created on first use
        (simulated cold starts never pay for one) and handed to the
        ``Aggregator`` driving this instance: ``Aggregator(...,
        engine=pool.engine_for(inst))``."""
        if inst.engine is None:
            from repro_torch.core.engine import make_engine

            inst.engine = make_engine(self.engine_spec)
        return inst.engine

    def release(self, agg_id: str) -> None:
        inst = self.instances.get(agg_id)
        if inst is not None:
            if inst.state != State.IDLE:   # re-release: already indexed
                heapq.heappush(self._idle.setdefault(inst.node, []),
                               (inst.seq, inst.agg_id))
            inst.state = State.IDLE
            inst.tasks_done += 1
            if inst.engine is not None:
                # round over: hand the accumulator back to the warm
                # buffer pool (invalidates the old handle; result() has
                # already copied out)
                inst.engine.recycle()

    def terminate(self, agg_id: str) -> None:
        if self.instances.pop(agg_id, None) is not None:
            self.stats.terminated += 1

    def terminate_idle(self, node: Optional[str] = None) -> int:
        """Scale-down path of the re-planner."""
        victims = [
            a for a, i in self.instances.items()
            if i.state == State.IDLE and (node is None or i.node == node)
        ]
        for a in victims:
            self.terminate(a)
        return len(victims)

    def idle_count(self, node: Optional[str] = None) -> int:
        return sum(
            1 for i in self.instances.values()
            if i.state == State.IDLE and (node is None or i.node == node)
        )

    def count(self) -> int:
        return len(self.instances)


class ExecutableCache:
    """Warm XLA-executable cache keyed by the aggregation signature.

    Signature = (update shape, dtype, fan-in, level arity) — LIFL's
    homogenized runtime means one executable serves leaf/middle/top, so
    a hierarchy re-plan re-uses the same compiled artifact (compile =
    the JAX cold start; measured by benchmarks/bench_control_overhead).
    """

    def __init__(self, builder: Callable[..., Any]):
        self._builder = builder
        self._cache: Dict[Tuple, Any] = {}
        self.hits = 0
        self.misses = 0

    def get(self, **signature) -> Any:
        key = tuple(sorted(signature.items()))
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        exe = self._builder(**signature)
        self._cache[key] = exe
        return exe

    def __len__(self):
        return len(self._cache)
