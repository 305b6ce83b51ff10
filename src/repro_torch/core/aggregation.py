"""The aggregator function itself: step-based processing (paper App-G).

Multiple producers -> single consumer, three steps:
  Recv — object keys arrive in a FIFO (payloads stay in shared memory);
  Agg  — dequeue + fold (FedAvg cumulative averaging) until the
         aggregation goal n is met; with *eager* timing Recv∥Agg overlap
         (fold on arrival); *lazy* queues everything then folds;
  Send — emit the intermediate/global update one level up.

FedAvg (Eq. 1): w = Σ_k c_k·w_k / Σ_k c_k — implemented as a running
(Σ c·w, Σ c) pair so eager and lazy are numerically identical (cumulative
averaging is exact, §2.1).  The fold's hot loop is delegated to a
pluggable aggregation *engine* (core/engine.py): blocked numpy tiles on
hosts, the kernels/fedavg Pallas path on TPU, with the seed's scalar
path kept as the ``naive`` baseline.  ``_drain`` dequeues bursts of up
to ``batch_k`` pending envelopes and folds them in one K-way pass, so a
burst of arrivals costs ~one read of the accumulator rather than K.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import AggregationEngine, make_engine
from repro_torch.core.gateway import UpdateEnvelope
from repro_torch.core.objectstore import InProcObjectStore
from repro_torch.core.sidecar import EventSidecar


@dataclass
class FedAvgState:
    """Running weighted sum — supports fold (one update), fold_many (a
    K-way burst) and merge (combine two partial aggregates: the
    hierarchy's associativity).  The arithmetic is the engine's."""

    acc: Optional[Any] = None
    weight: float = 0.0
    count: int = 0
    engine: Any = None

    def __post_init__(self) -> None:
        if not isinstance(self.engine, AggregationEngine):
            # bare FedAvgState() keeps the seed's scalar semantics
            self.engine = make_engine(self.engine or "naive")

    def _ensure_acc(self, n: int) -> None:
        if self.acc is None:
            self.acc = self.engine.begin(n)

    def fold(self, update: np.ndarray, w: float) -> None:
        self._ensure_acc(update.size)
        self.acc = self.engine.fold(self.acc, update, w)
        self.weight += w
        self.count += 1

    def fold_many(self, updates: List[np.ndarray], weights: List[float]) -> None:
        if not updates:
            return
        self._ensure_acc(updates[0].size)
        self.acc = self.engine.fold_many(self.acc, updates, weights)
        self.weight += float(sum(weights))
        self.count += len(updates)

    def absorb(self, partial: np.ndarray, weight: float, count: int = 0) -> None:
        """Fold one published raw partial Σ c·u into the running sum —
        the root fold of a FoldPlan, identical arithmetic to the
        driver's controller-side top fold (``engine.add_partial``), so
        where the fold runs never changes the bits."""
        self._ensure_acc(partial.size)
        self.acc = self.engine.add_partial(self.acc, partial)
        self.weight += float(weight)
        self.count += int(count)

    def merge(self, other: "FedAvgState") -> None:
        if other.acc is None:
            return
        partial = other.engine.to_numpy(other.acc)
        if self.acc is None:
            self.acc = self.engine.begin(partial.size)
        self.acc = self.engine.add_partial(self.acc, partial)
        self.weight += other.weight
        self.count += other.count

    def result(self) -> Tuple[np.ndarray, float]:
        assert self.acc is not None and self.weight > 0
        acc = self.engine.to_numpy(self.acc)
        return acc / np.float32(self.weight), self.weight


class Aggregator:
    """One LIFL aggregator instance (leaf/middle/top — homogenized)."""

    def __init__(
        self,
        agg_id: str,
        store,
        goal: int,
        *,
        eager: bool = True,
        sidecar: Optional[EventSidecar] = None,
        on_complete: Optional[Callable[[np.ndarray, float], None]] = None,
        engine: Any = "auto",
        batch_k: int = 8,
    ):
        self.agg_id = agg_id
        self.store = store
        self.goal = goal
        self.eager = eager
        self.sidecar = sidecar
        self.on_complete = on_complete
        self.engine = make_engine(engine)
        self.batch_k = max(1, int(batch_k))
        self.fifo: Deque[UpdateEnvelope] = deque()
        self.state = FedAvgState(engine=self.engine)
        self.done = False
        self.result: Optional[Tuple[np.ndarray, float]] = None
        self.agg_exec_s = 0.0
        # root-fold inputs (recv_partial) count toward the goal in
        # partials, not updates — state.count then carries the subtree
        # totals instead
        self.partials_absorbed = 0

    # ------------------------------------------------------------------
    # Recv step — called by the sockmap notify hook (event-driven)
    # ------------------------------------------------------------------
    def recv(self, env: UpdateEnvelope) -> None:
        self.fifo.append(env)
        if self.sidecar:
            self.sidecar.on_recv(
                self.store.meta(env.object_key).nbytes,
                time.perf_counter() - env.enqueue_ts,
            )
        if self.eager:
            # Recv ∥ Agg: fold immediately (App-G)
            self._drain()

    # ------------------------------------------------------------------
    # Agg step
    # ------------------------------------------------------------------
    def _drain(self) -> None:
        """Dequeue-and-fold in K-way bursts through the engine layer.

        Under eager timing arrivals trickle in and bursts are usually
        size 1; under lazy timing (or an arrival burst outpacing the
        fold) up to ``batch_k`` queued envelopes are folded in a single
        pass over the accumulator."""
        while self.fifo and not self.done:
            k = min(len(self.fifo), self.batch_k, self.goal - self.state.count)
            if k <= 0:
                break
            envs = [self.fifo.popleft() for _ in range(k)]
            t0 = time.perf_counter()
            views = [np.asarray(self.store.get(e.object_key)) for e in envs]
            if k == 1:
                self.state.fold(views[0], envs[0].num_samples)
            else:
                self.state.fold_many(views, [e.num_samples for e in envs])
            for e in envs:
                self.store.release(e.object_key)
            self.engine.sync(self.state.acc)  # async engines: the timed
            dt = time.perf_counter() - t0     # fold must have executed
            self.agg_exec_s += dt
            if self.sidecar:
                self.sidecar.on_aggregate(k, dt)
            if self.state.count >= self.goal:
                self._send()

    def flush(self) -> None:
        """Lazy timing: called once the goal's worth of updates queued."""
        self._drain()

    def recv_partial(self, key: str, weight: float, count: int = 0) -> None:
        """Root-fold input: absorb a published raw partial Σ c·u from
        the store.  Folds immediately (the driver only routes partials
        here once every input is at hand, in plan order) and publishes
        when ``goal`` partials have been absorbed."""
        t0 = time.perf_counter()
        view = np.asarray(self.store.get(key))
        if self.sidecar:
            self.sidecar.on_recv(view.nbytes, 0.0)
        self.state.absorb(view, weight, count)
        self.store.release(key)
        self.engine.sync(self.state.acc)
        dt = time.perf_counter() - t0
        self.agg_exec_s += dt
        if self.sidecar:
            self.sidecar.on_aggregate(1, dt)
        self.partials_absorbed += 1
        if self.partials_absorbed >= self.goal and not self.done:
            self._send()

    # ------------------------------------------------------------------
    # Send step
    # ------------------------------------------------------------------
    def _send(self) -> None:
        self.done = True
        self.result = self.state.result()
        if self.sidecar:
            self.sidecar.on_send(self.result[0].nbytes)
        if self.on_complete:
            self.on_complete(*self.result)


def fedavg_oracle(updates: List[np.ndarray], weights: List[float]) -> np.ndarray:
    """Reference weighted mean (tests compare every path against this)."""
    num = sum(np.float32(w) * u.astype(np.float32) for u, w in zip(updates, weights))
    return num / np.float32(sum(weights))
