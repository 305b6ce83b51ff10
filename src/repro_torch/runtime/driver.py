"""RoundDriver: one plan-interpreting loop owns the round lifecycle.

A *runtime* is anything that can host aggregators and speak the event
protocol (`events.py`); the driver never cares whether aggregators are
objects in this process (``InProcRuntime``), forked worker processes
over shared-memory rings (``ShmProcRuntime`` wrapping ``shmrt``), or
daemon-side aggregators across nodes (``netrt.RemoteRuntime``).

The round's aggregation topology is an explicit
:class:`~repro_torch.core.placement.FoldPlan` the driver *executes* (per
round)::

    PLAN ──▶ SPAWN ──▶ DISPATCH ──▶ COLLECT ──▶ FOLD(root site) ──▶ DONE
                │           │            │            │
                │           ▼            ▼            ▼ root tier:
                │    UpdateArrived  PartialReady   controller | worker | node
                │                   WorkerCrashed  (crash ⇒ re-root on a
                │                   RoundDeadline   surviving node)
                └──────────────────────▶ re-dispatch on crash

The root tier decides where the final fold runs: ``controller`` folds
fetched partials in this process (the legacy topology, bit for bit),
``worker`` spawns the top as a runtime aggregator (a parked worker
process under shmproc), and ``node`` roots the fold on the busiest
worker node — partials ship daemon→daemon and only the folded Σ c·u
returns (~1 × model per round instead of nodes × model).

Semantics every runtime shares, by construction:

  * mids fold in delivery order through the blocked-engine arithmetic
    and publish their **raw partial sum** Σ c·u (not the normalized
    mean) into the object store;
  * the root fold consumes partials sorted by ``agg_id`` — the plan
    fixes the order (explicit seq numbers on the wire), independent of
    completion timing — so every runtime × topology combination
    produces **bit-identical** params (test-asserted over multi-round
    runs);
  * a :class:`~repro_torch.runtime.events.WorkerCrashed` mid-round loses the
    crashed subtree's *unpublished folds only*: the dispatched update
    objects still live in the store, so the driver re-dispatches the
    surviving keys to a fresh/sibling worker and the round still
    reaches its full goal (no quota shrinking);
  * ordering guards: events from finished rounds are dropped, and a
    ``RoundDeadline`` that fires after ``GoalReached`` is ignored.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Deque, Dict, Iterable, List, Optional, Protocol, Set,
    Tuple, Type,
)

import numpy as np

from repro_torch.core.aggregation import Aggregator, FedAvgState
from repro_torch.core.engine import make_engine
from repro_torch.core.gateway import UpdateEnvelope
from repro_torch.core.objectstore import InProcObjectStore
from repro_torch.core.placement import (
    FoldPlan, FoldSite, build_fold_plan, engine_key, join_agg_id,
    split_agg_id,
)
from repro_torch.core.sidecar import EventSidecar, MetricsMap
from repro_torch.obs.trace import RoundTrace, Tracer
from repro_torch.runtime.events import (
    GoalReached,
    PartialReady,
    PartialShipped,
    RoundDeadline,
    RoundEvent,
    RoundOpened,
    TopFolded,
    UpdateArrived,
    WorkerCrashed,
)


# ===========================================================================
# the Runtime protocol: what a round host must provide
# ===========================================================================


class Runtime(Protocol):
    """An aggregation runtime the driver can run rounds on.

    The four protocol methods are the entire control surface; the
    concrete classes below add store plumbing (``put_update`` /
    ``get_partial`` / …) that the driver uses for payloads."""

    name: str
    stats: Dict[str, Any]
    metrics: MetricsMap

    def spawn_aggregator(self, agg_id: str, *, goal: int, n_elems: int,
                         round_id: int = 0, kind: str = "mid") -> None: ...

    def deliver(self, agg_id: str, key: str, weight: float,
                round_id: int = 0) -> None: ...

    def deliver_partial(self, agg_id: str, key: str, weight: float,
                        count: int, round_id: int = 0,
                        seq: int = 0) -> None: ...

    def poll_events(self, timeout: float = 0.0) -> List[RoundEvent]: ...

    def quiesce(self, timeout: float = 5.0) -> None: ...


def _partial_alive(rt, key: str) -> bool:
    """Whether a published partial's bytes are still reachable (a node
    death takes its store down with it).  Runtimes without the hook are
    single-node: partials live as long as the process."""
    fn = getattr(rt, "partial_alive", None)
    return True if fn is None else bool(fn(key))


#: feed-protocol sentinel: a cohort feed returns this to declare the
#: round's cohort closed (no more updates will ever arrive for it).
#: Distinct from ``None``, which means "nothing pending *yet*" and
#: keeps a serve-mode round open.
COHORT_CLOSED = object()


def _iter_feed(updates: Iterable) -> Callable[[], Any]:
    """Adapt a plain iterable of ``(node, client_id, flat, weight)``
    tuples to the pull-feed protocol: one item per call, then
    :data:`COHORT_CLOSED` forever."""
    it = iter(updates)

    def feed():
        try:
            return next(it)
        except StopIteration:
            return COHORT_CLOSED

    return feed


def _partial_node(rt, key: str) -> Optional[str]:
    """Which node a published partial physically lives on (None for
    single-node runtimes, where agg ids name logical nodes only)."""
    fn = getattr(rt, "partial_node", None)
    return fn(key) if fn is not None else None


class _WarmEngineMixin:
    """Warm aggregation engines keyed by ``(job, tree-position)``:
    a re-spawned aggregator at the same position re-enters the next
    round with its accumulator/scratch resident (§5.3 at the fold
    level).  The agg-id's per-round tag is stripped for the pool
    lookup (``placement.engine_key``) so warmth carries across rolling
    rounds, while two jobs sharing a node fleet never share an
    accumulator.  Requires ``self.agg_engine`` and ``self._engines``."""

    def engine_for(self, agg_id: str):
        key = engine_key(agg_id)
        eng = self._engines.get(key)
        if eng is None:
            eng = make_engine(self.agg_engine)
            self._engines[key] = eng
        return eng

    def recycle_engines(self) -> None:
        for eng in self._engines.values():
            eng.recycle()


class InProcRuntime(_WarmEngineMixin):
    """Single-process runtime: aggregators are :class:`Aggregator`
    objects over an in-proc object store."""

    name = "inproc"

    def __init__(self, *, metrics: Optional[MetricsMap] = None,
                 agg_engine: Any = "auto", eager: bool = True,
                 node: str = "inproc"):
        self.metrics = metrics if metrics is not None else MetricsMap()
        self.store = InProcObjectStore(node)
        self.agg_engine = agg_engine
        self.eager = eager
        self._engines: Dict[str, Any] = {}
        self._open: Dict[str, Tuple[Aggregator, int]] = {}
        self._events: Deque[RoundEvent] = deque()
        self.stats = {"cold_starts": 0, "warm_starts": 0, "crashes": 0}
        self._closed = False

    # -- protocol -------------------------------------------------------
    def spawn_aggregator(self, agg_id: str, *, goal: int, n_elems: int,
                         round_id: int = 0, kind: str = "mid") -> None:
        if agg_id in self._open:
            raise ValueError(f"{agg_id!r} already has an open task")
        # warm = an engine is already resident at this (job, position)
        key = "warm_starts" if engine_key(agg_id) in self._engines \
            else "cold_starts"
        self.stats[key] += 1
        agg = Aggregator(
            agg_id, self.store, goal, eager=self.eager,
            sidecar=EventSidecar(agg_id, self.metrics),
            engine=self.engine_for(agg_id),
            on_complete=lambda *_args, a=agg_id: self._publish(a),
        )
        self._open[agg_id] = (agg, round_id)

    def _publish(self, agg_id: str) -> None:
        """Goal met: publish the raw partial sum Σ c·u into the store
        (one copy — the in-proc analogue of the shm seal+disown)."""
        agg, round_id = self._open.pop(agg_id)
        key = self.store.put(agg.engine.to_numpy(agg.state.acc))
        self._events.append(PartialReady(
            round_id=round_id, agg_id=agg_id, key=key,
            weight=agg.state.weight, count=agg.state.count,
            exec_s=agg.agg_exec_s, worker=-1))

    def deliver(self, agg_id: str, key: str, weight: float,
                round_id: int = 0) -> None:
        agg, _ = self._open[agg_id]
        agg.recv(UpdateEnvelope(key, round_id, agg_id, weight,
                                enqueue_ts=time.perf_counter()))

    def deliver_partial(self, agg_id: str, key: str, weight: float,
                        count: int, round_id: int = 0, seq: int = 0) -> None:
        agg, _ = self._open[agg_id]
        agg.recv_partial(key, weight, count)

    def partial_alive(self, key: str) -> bool:
        return self.store.contains(key)

    def drain(self, agg_id: str) -> None:
        """Close out a short/lazy task: fold whatever is queued and
        publish, or retire the task empty."""
        entry = self._open.get(agg_id)
        if entry is None:
            return  # already published (eager goal met) — no-op
        agg, _ = entry
        if agg.state.count > 0 or agg.fifo:
            agg.goal = agg.state.count + len(agg.fifo)
            agg.flush()
            if not agg.done:
                agg._send()
        else:
            self._open.pop(agg_id, None)  # EMPTY closure: nothing folded

    def poll_events(self, timeout: float = 0.0) -> List[RoundEvent]:
        evs = list(self._events)
        self._events.clear()
        if not evs and timeout > 0:
            time.sleep(min(timeout, 0.05))  # nothing pending: don't spin
        return evs

    def quiesce(self, timeout: float = 5.0,
                round_id: Optional[int] = None) -> None:
        # a published-but-unabsorbed partial would strand its store
        # object (the exception path can abandon queued events).
        # ``round_id`` scopes the barrier to one in-flight round
        # (rolling rounds): the other round's open tasks and queued
        # events survive it.
        keep: Deque[RoundEvent] = deque()
        for ev in self._events:
            if round_id is not None \
                    and getattr(ev, "round_id", None) != round_id:
                keep.append(ev)
                continue
            if isinstance(ev, PartialReady):
                self.store.delete(ev.key)
        self._events = keep
        if round_id is None:
            self._open.clear()
        else:
            self._open = {a: (agg, rid) for a, (agg, rid)
                          in self._open.items() if rid != round_id}

    # -- payload plumbing ----------------------------------------------
    def put_update(self, flat: np.ndarray) -> str:
        return self.store.put(flat)

    def update_alive(self, key: str) -> bool:
        return self.store.contains(key)

    def get_partial(self, key: str) -> np.ndarray:
        return self.store.get(key)

    def release_partial(self, key: str) -> None:
        self.store.release(key)

    def discard_partial(self, key: str) -> None:
        self.store.delete(key)

    def discard_update(self, key: str) -> None:
        self.store.delete(key)

    def worker_count(self) -> int:
        return 0

    def health(self) -> Dict[str, int]:
        """Pool gauges for live scrapes: inproc has no worker pool, so
        only the open-aggregator count is meaningful."""
        return {"workers": 0, "workers_busy": 0, "workers_parked": 0,
                "ring_depth": 0, "open_aggs": len(self._open)}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._open.clear()
        self._engines.clear()
        self.store.close()


class ShmProcRuntime(_WarmEngineMixin):
    """Multi-process runtime: a thin event adapter over
    :class:`repro_torch.runtime.shmrt.ShmRuntime` — mids are forked worker
    processes, partials are sealed shm objects, crashes surface as
    :class:`WorkerCrashed` events instead of exceptions."""

    name = "shmproc"

    def __init__(self, *, metrics: Optional[MetricsMap] = None,
                 agg_engine: Any = "auto", **rt_kwargs):
        from repro_torch.runtime.shmrt import ShmRuntime, WorkerCrash

        self.metrics = metrics if metrics is not None else MetricsMap()
        self._rt = ShmRuntime(metrics=self.metrics, **rt_kwargs)
        self._crash_cls = WorkerCrash
        self.agg_engine = agg_engine
        self._engines: Dict[str, Any] = {}   # driver-side (top) engines
        self._task_rounds: Dict[str, int] = {}  # open task → its round
        self._round_id = 0
        self._closed = False

    @property
    def store(self):
        return self._rt.store

    @property
    def store_prefix(self) -> str:
        """The /dev/shm name prefix every segment of this runtime lives
        under — the welcome handshake advertises it so a controller can
        sweep a SIGKILLed daemon's leftovers on re-adoption."""
        return self._rt.prefix

    @property
    def stats(self):
        return self._rt.stats

    # -- protocol -------------------------------------------------------
    def spawn_aggregator(self, agg_id: str, *, goal: int, n_elems: int,
                         round_id: int = 0, kind: str = "mid") -> None:
        self._round_id = round_id
        self._task_rounds[agg_id] = round_id
        self._rt.submit_task(agg_id, goal=goal, n_elems=n_elems,
                             round_id=round_id)

    def deliver(self, agg_id: str, key: str, weight: float,
                round_id: int = 0) -> None:
        self._rt.dispatch(agg_id, key, weight, round_id=round_id)

    def deliver_partial(self, agg_id: str, key: str, weight: float,
                        count: int, round_id: int = 0, seq: int = 0) -> None:
        # ring FIFO ⇒ the worker absorbs in dispatch order (plan order)
        self._rt.dispatch_partial(agg_id, key, weight, count,
                                  round_id=round_id)

    def partial_alive(self, key: str) -> bool:
        return self._rt.store.contains(key)

    def drain(self, agg_id: str) -> None:
        self._rt.drain(agg_id)

    def poll_events(self, timeout: float = 0.0) -> List[RoundEvent]:
        evs: List[RoundEvent] = []
        deadline = time.perf_counter() + timeout
        while True:
            left = deadline - time.perf_counter()
            try:
                parts = self._rt.poll(timeout=max(0.0, left) if not evs
                                      else 0.0)
            except self._crash_cls as e:
                evs.append(WorkerCrashed(
                    round_id=self._round_id, agg_id=e.agg_id or "",
                    worker=e.widx, exitcode=e.exitcode))
                continue  # scoop any results buffered behind the crash
            evs.extend(
                PartialReady(round_id=p.round_id, agg_id=p.agg_id,
                             key=p.key, weight=p.weight, count=p.count,
                             exec_s=p.exec_s, worker=p.worker)
                for p in parts)
            return evs

    def quiesce(self, timeout: float = 5.0,
                round_id: Optional[int] = None) -> None:
        if round_id is None:
            self._task_rounds.clear()
            self._rt.quiesce(timeout=timeout)
            return
        # rolling rounds: close out only this round's tasks — the
        # other in-flight round keeps its workers busy
        mine = {a for a, r in self._task_rounds.items() if r == round_id}
        for a in mine:
            self._task_rounds.pop(a, None)
        self._rt.quiesce(timeout=timeout, agg_ids=mine)

    def take_spans(self) -> List["Span"]:
        """Worker-side spans (task pickup→publish, ring-wait) derived
        from records already on the result rings — no extra IPC."""
        from repro_torch.obs.trace import Span

        out: List[Span] = []
        for d in self._rt.take_spans():
            try:
                out.append(Span(
                    kind=d["kind"], owner=d.get("owner", ""),
                    node=self.name, round_id=int(d.get("round_id", 0)),
                    t0=float(d.get("t0", 0.0)),
                    dur_s=float(d.get("dur_s", 0.0)),
                    worker=int(d.get("worker", -1)),
                    n=float(d.get("n", 0.0))))
            except (KeyError, TypeError, ValueError):
                continue
        return out

    # -- payload plumbing ----------------------------------------------
    def put_update(self, flat: np.ndarray) -> str:
        return self._rt.store.put(flat)

    def update_alive(self, key: str) -> bool:
        return self._rt.store.contains(key)

    def get_partial(self, key: str) -> np.ndarray:
        return self._rt.store.get(key)

    def release_partial(self, key: str) -> None:
        self._rt.store.release(key)

    def discard_partial(self, key: str) -> None:
        # the dispatcher owns published partials (disowned by workers)
        self._rt.store.destroy(key)

    def discard_update(self, key: str) -> None:
        self._rt.store.delete(key)  # parks the segment for recycling

    def worker_count(self) -> int:
        return len(self._rt.worker_pids())

    def health(self) -> Dict[str, int]:
        return self._rt.health()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._rt.shutdown()


def make_runtime(spec: Any, *, metrics: Optional[MetricsMap] = None,
                 agg_engine: Any = "auto", eager: bool = True,
                 **kwargs) -> Any:
    """Resolve a runtime spec: an instance passes through, a name
    builds one (``"inproc"`` | ``"shmproc"``)."""
    if not isinstance(spec, str):
        return spec
    if spec == "inproc":
        return InProcRuntime(metrics=metrics, agg_engine=agg_engine,
                             eager=eager, **kwargs)
    if spec == "shmproc":
        return ShmProcRuntime(metrics=metrics, agg_engine=agg_engine,
                              **kwargs)
    raise ValueError(f"unknown runtime {spec!r} "
                     "(expected 'inproc' or 'shmproc')")


# ===========================================================================
# the driver
# ===========================================================================


@dataclass
class RoundOutcome:
    """What one driven round produced (runtime-agnostic)."""

    round_id: int
    accepted: int = 0                      # updates that made the round
    delta: Optional[np.ndarray] = None     # flat weighted-mean update
    weight: float = 0.0
    count: int = 0                         # updates folded end-to-end
    crashes: int = 0
    redispatched: int = 0                  # crash-recovery re-dispatches
    deadline_hit: bool = False
    cold_starts: int = 0
    warm_starts: int = 0
    workers: int = 0
    exec_s: Dict[str, float] = field(default_factory=dict)  # agg_id → E
    dispatched: Dict[str, int] = field(default_factory=dict)  # node → n
    fold_tier: str = "controller"          # where the root fold ran
    root_node: str = ""                    # which node rooted the round
    # updates the dispatch loop PULLED from the cohort generator but
    # never delivered (deadline expired mid-cohort, subtree given up,
    # node already full).  Pulling IS the client's training — dropping
    # these on the floor silently loses externally submitted updates,
    # so the trainer requeues its externals from here (the locally
    # trained ones are regenerable and stay dropped, as before).
    skipped: List[Tuple[str, str, np.ndarray, float]] = \
        field(default_factory=list)


@dataclass
class _RoundState:
    """Mutable per-round bookkeeping threaded through the loop."""

    round_id: int
    n_elems: int
    out: RoundOutcome
    sent: Dict[str, List[Tuple[str, float]]]      # agg_id → delivered keys
    partials: Dict[str, PartialReady]
    spawn_goals: Dict[str, int] = field(default_factory=dict)
    lost: Set[str] = field(default_factory=set)   # subtrees given up
    attempts: Dict[str, int] = field(default_factory=dict)  # re-dispatches
    plan: Optional[FoldPlan] = None
    deadline: Optional[float] = None              # absolute perf_counter
    # runtime-side root fold in flight (worker/node tiers)
    top_id: Optional[str] = None
    top_partial: Optional[PartialReady] = None
    top_crashed: bool = False
    # deep (fanout-capped) plans: the inner fold stages in flight —
    # their PartialReady results are intercepted like the root's
    pending_tops: Set[str] = field(default_factory=set)
    top_results: Dict[str, PartialReady] = field(default_factory=dict)
    deep_crashed: bool = False
    # first-dispatch stamp per subtree (dispatch → PartialReady spans)
    first_dispatch: Dict[str, float] = field(default_factory=dict)
    # rolling-round bookkeeping: the owning job, the plan's agg-id tags
    # (mirrored onto re-rooted top ids), which phase the round is in,
    # and whether its event absorption is in draining mode — the event
    # router needs the latter when it absorbs a cross-round event on
    # behalf of the OTHER in-flight round
    job: str = ""
    tag_job: str = ""
    tag_rid: Optional[int] = None
    phase: str = "open"
    draining: bool = False


class RoundDriver:
    """The single round loop; also the event bus components hang off.

    Handlers subscribe per event type with :meth:`on` (subscribe to
    :class:`RoundEvent` for a catch-all); anything — the elastic
    controller, the coordinator, user code via ``Session.emit`` — can
    inject events with :meth:`dispatch`.  Ordering guards live here:
    stale-round events are dropped and a deadline after the goal is
    ignored, whoever emits them."""

    def __init__(self, runtime: Optional[Any] = None, *,
                 metrics: Optional[MetricsMap] = None,
                 redispatch_limit: int = 3,
                 tracer: Optional[Tracer] = None,
                 trace_sink: Optional[Callable[[RoundTrace], None]] = None,
                 max_open_rounds: int = 1):
        self.runtime = runtime
        self.metrics = metrics if metrics is not None else (
            runtime.metrics if runtime is not None else MetricsMap())
        # event-edge tracing (obs/): on by default — the enabled path is
        # FATAL-gated < 2% overhead (bench_obs); pass a disabled Tracer
        # to opt out entirely
        self.tracer = tracer if tracer is not None else Tracer(enabled=True)
        self.trace_sink = trace_sink
        self.last_trace: Optional[RoundTrace] = None
        # crash recovery gives up on a subtree after this many respawns
        # (a deterministic crasher must not hang the round)
        self.redispatch_limit = int(redispatch_limit)
        # rolling rounds: how many rounds may be open at once.  1 is
        # the library default (begin_round refuses nesting, as ever);
        # the serve scheduler runs with 2 so round N+1's dispatch can
        # overlap round N's fold.
        self.max_open_rounds = int(max_open_rounds)
        self._handlers: Dict[Type[RoundEvent],
                             List[Callable[[RoundEvent], None]]] = {}
        # per-round lifecycle state (was a single _open_round/_goal
        # global): rid → goal-reached flag, plus the in-flight round
        # states the event router targets
        self._open_rounds: Dict[int, bool] = {}
        self._inflight: Dict[int, _RoundState] = {}
        self._next_round = 0
        self.stats = {
            "events_dispatched": 0, "stale_dropped": 0,
            "deadline_ignored": 0, "crashes": 0, "redispatched": 0,
        }

    # ------------------------------------------------------------------
    # event bus
    # ------------------------------------------------------------------
    def on(self, event_type: Type[RoundEvent],
           handler: Callable[[RoundEvent], None]) -> None:
        """Subscribe ``handler`` to an event type (or ``RoundEvent``
        for every event)."""
        self._handlers.setdefault(event_type, []).append(handler)

    def dispatch(self, event: RoundEvent) -> bool:
        """Route one event through the ordering guards and handlers.
        Returns ``False`` when a guard dropped it."""
        rid = event.round_id
        if rid is not None and rid < self._next_round \
                and rid not in self._open_rounds \
                and not isinstance(event, PartialShipped):
            # leftovers from a finished round: drop, whoever sent them.
            # With rolling rounds the horizon alone isn't enough — a
            # round can close out of order while an earlier-numbered
            # one is still in flight, so membership in the open set
            # keeps a live round's events deliverable.  PartialShipped
            # is exempt: it is pure telemetry (mutates no round state)
            # pushed async by a *remote* daemon, so it routinely loses
            # the race with its own round's close-out — dropping it
            # would make observed ship counts flap
            self.stats["stale_dropped"] += 1
            return False
        if isinstance(event, RoundDeadline) and self._open_rounds.get(rid):
            # goal already reached for that round: the deadline is moot
            self.stats["deadline_ignored"] += 1
            return False
        if isinstance(event, GoalReached) and rid in self._open_rounds:
            self._open_rounds[rid] = True
        self.stats["events_dispatched"] += 1
        for etype in (type(event), RoundEvent):
            for fn in self._handlers.get(etype, ()):
                fn(event)
        return True

    # alias for external injectors (Session.emit, operators, tests)
    emit = dispatch

    # ------------------------------------------------------------------
    # round lifecycle bookkeeping (public so tests can drive the guards)
    # ------------------------------------------------------------------
    def begin_round(self, round_id: int) -> None:
        if round_id in self._open_rounds:
            raise RuntimeError(f"round {round_id} already open")
        if len(self._open_rounds) >= self.max_open_rounds:
            raise RuntimeError(
                f"round {min(self._open_rounds)} still open")
        self._open_rounds[round_id] = False

    def end_round(self, round_id: int) -> None:
        self._open_rounds.pop(round_id, None)
        self._next_round = max(self._next_round, round_id + 1)

    def abort_round(self, round_id: int) -> None:
        """The round failed before completing: close it WITHOUT
        advancing the stale-round horizon, so a retry under the same
        ``round_id`` isn't guard-dropped (runtime-level seq guards
        already fence the aborted round's late records)."""
        self._open_rounds.pop(round_id, None)

    # ------------------------------------------------------------------
    # the round loop
    # ------------------------------------------------------------------
    def run_round(
        self,
        *,
        round_id: int,
        assignment: Dict[str, List[int]],
        updates: Iterable[Tuple[str, str, np.ndarray, float]],
        goal: int,
        n_elems: int,
        top_node: Optional[str] = None,
        deadline_s: Optional[float] = None,
        fold_plan: Optional[FoldPlan] = None,
        job: str = "",
    ) -> RoundOutcome:
        """Drive one round: spawn the planned mids, pump ``updates``
        (``(node, client_id, flat, weight)`` tuples — typically a lazy
        generator whose iteration *is* the client training) until the
        goal, collect every counted subtree's partial (re-dispatching
        around crashes), and execute the plan's root fold.  Returns the
        outcome; the caller applies the server optimizer.

        ``fold_plan`` makes the aggregation topology explicit (see
        :class:`~repro_torch.core.placement.FoldPlan`); without one, a
        controller-top plan is derived from ``assignment`` +
        ``top_node`` — the legacy behavior, bit for bit.

        This is the synchronous wrapper over :meth:`open_round`: the
        handle is stepped to completion in place, which reproduces the
        historical single-round loop exactly."""
        return self.open_round(
            round_id=round_id, assignment=assignment, updates=updates,
            goal=goal, n_elems=n_elems, top_node=top_node,
            deadline_s=deadline_s, fold_plan=fold_plan, job=job).run()

    def open_round(
        self,
        *,
        round_id: int,
        assignment: Dict[str, List[int]],
        updates: Any,
        goal: int,
        n_elems: int,
        top_node: Optional[str] = None,
        deadline_s: Optional[float] = None,
        fold_plan: Optional[FoldPlan] = None,
        job: str = "",
    ) -> "RoundHandle":
        """Open a round and return its resumable :class:`RoundHandle`
        — the rolling-round seam.  ``updates`` is either the usual
        iterable of ``(node, client_id, flat, weight)`` tuples, or a
        zero-arg *feed* callable returning one such tuple per call,
        ``None`` when nothing is pending yet (serve mode keeps the
        round open and hands control back), or :data:`COHORT_CLOSED`
        to close the cohort (a pluggable close-out policy lives inside
        the feed)."""
        rt = self.runtime
        if rt is None:
            raise RuntimeError("RoundDriver has no runtime attached")
        self.begin_round(round_id)
        if fold_plan is None:
            fold_plan = build_fold_plan(assignment, top_node=top_node,
                                        topology="controller")
        out = RoundOutcome(round_id=round_id)
        st = _RoundState(round_id=round_id, n_elems=n_elems, out=out,
                         sent={}, partials={}, plan=fold_plan, job=job)
        if fold_plan.root:
            _kind, st.tag_job, st.tag_rid, _node = split_agg_id(
                fold_plan.root)
            st.job = st.job or st.tag_job
        stats0 = {k: rt.stats.get(k, 0)
                  for k in ("cold_starts", "warm_starts")}
        self._inflight[round_id] = st
        tok_round = self.tracer.begin("round", owner="driver",
                                      round_id=round_id)
        self.dispatch(RoundOpened(round_id=round_id, job=st.job, goal=goal))
        gen = self._round_gen(st, rt, updates=updates, goal=goal,
                              top_node=top_node, deadline_s=deadline_s)
        return RoundHandle(self, st, gen, tok_round, stats0)

    def _quiesce_runtime(self, round_id: Optional[int] = None) -> None:
        """Park the runtime after a round.  With no other round in
        flight this is the legacy full barrier; while another round is
        open the barrier is scoped to ``round_id`` so the other
        round's open aggregators and queued events survive it."""
        rt = self.runtime
        if rt is None:
            return
        others = [r for r in self._inflight if r != round_id]
        if round_id is None or not others:
            rt.quiesce()
            return
        try:
            rt.quiesce(round_id=round_id)
        except TypeError:  # a runtime without the scoped barrier
            rt.quiesce()

    def _finish_trace(self, tok_round: int, round_id: int,
                      out: RoundOutcome, rt, completed: bool,
                      job: str = "") -> None:
        """Close the round span and merge this round's samples — driver
        spans, runtime-derived worker spans, and whatever per-daemon
        telemetry the quiesce edge drained — into one RoundTrace."""
        tr = self.tracer
        round_span = tr.end(tok_round, n=float(out.accepted))
        if round_span is not None:
            # per-job TTA distribution — what the SLO tracker reads
            self.metrics.observe("tta", job or "_", round_span.dur_s)
        if not tr.enabled:
            return
        spans = tr.drain()
        take_spans = getattr(rt, "take_spans", None)
        if take_spans is not None:
            try:
                spans.extend(take_spans())
            except Exception:
                pass
        if self._inflight:
            # rolling rounds share one tracer: the other in-flight
            # round's finished spans go back on the buffer (its own
            # close-out will claim them) and its open begins survive —
            # no reset while anything is still measuring
            other = [s for s in spans
                     if s.round_id is not None and s.round_id != round_id]
            spans = [s for s in spans
                     if s.round_id is None or s.round_id == round_id]
            for s in other:
                tr.add(s)
        else:
            tr.reset()                  # exception paths leave begins open
        telemetry: Dict[str, Dict[str, list]] = {}
        take_telem = getattr(rt, "take_telemetry", None)
        if take_telem is not None:
            # fold-phase samples (partial ship, node-side top fold,
            # fetch) land AFTER the quiesce drain: one on-demand pull
            # per round scoops them so each trace is self-contained
            pull = getattr(rt, "pull_telemetry", None)
            if pull is not None:
                try:
                    pull()
                except Exception:
                    pass
            try:
                telemetry = take_telem()
            except Exception:
                telemetry = {}
        trace = RoundTrace(
            round_id=round_id,
            wall_s=round_span.dur_s if round_span is not None else 0.0,
            spans=spans, telemetry=telemetry,
            meta={"completed": completed, "accepted": out.accepted,
                  "count": out.count, "crashes": out.crashes,
                  "fold_tier": out.fold_tier, "root_node": out.root_node,
                  "job": job, "runtime": getattr(rt, "name", "?")})
        self.last_trace = trace
        if self.trace_sink is not None:
            try:
                self.trace_sink(trace)
            except Exception:
                pass

    def _round_gen(self, st: "_RoundState", rt, *, updates, goal,
                   top_node, deadline_s):
        """The round body as a generator: each ``yield`` is a point the
        round can pause at (and names the phase it paused in).  Driven
        straight through by :meth:`RoundHandle.run` this is the legacy
        loop, operation for operation; interleaved by the rolling
        scheduler it pauses after every dispatch/collect increment so
        another round can make progress on the same driver."""
        out = st.out
        round_id = st.round_id
        fold_plan = st.plan
        tr = self.tracer
        traced = tr.enabled
        # --- SPAWN: one mid per planned fold site ----------------------
        st.phase = "spawn"
        tok = tr.begin("spawn", owner="driver", round_id=round_id)
        planned = {s.node: s.goal for s in fold_plan.mids}
        mid_ids = {s.node: s.agg_id for s in fold_plan.mids}
        for node, k in planned.items():
            rt.spawn_aggregator(mid_ids[node], goal=k, n_elems=st.n_elems,
                                round_id=round_id)
            st.spawn_goals[mid_ids[node]] = k
            st.sent[mid_ids[node]] = []
        tr.end(tok, n=float(len(planned)))
        yield "spawn"

        dispatched = {node: 0 for node in planned}
        accepted = 0
        deadline = (time.perf_counter() + deadline_s) if deadline_s else None
        st.deadline = deadline

        def fire_deadline() -> None:
            # the wall-clock budget always closes the round; the
            # ordering guard only decides whether handlers see the
            # RoundDeadline event (ignored once the goal was met)
            if not out.deadline_hit:
                self.dispatch(RoundDeadline(round_id=round_id,
                                            deadline_s=deadline_s))
                out.deadline_hit = True

        # --- DISPATCH: pump updates until the aggregation goal ---------
        # the pump is manually iterated so the two sub-costs the TTA
        # breakdown needs stay separable: pulling the feed IS the
        # client's local training; put+deliver is the wire/store edge
        st.phase = "dispatch"
        tok = tr.begin("dispatch", owner="driver", round_id=round_id)
        train_s = deliver_s = 0.0
        pulls = delivers = 0
        feed = updates if callable(updates) else _iter_feed(updates)
        while True:
            _t = time.perf_counter() if traced else 0.0
            item = feed()
            if item is COHORT_CLOSED:
                break
            if item is None:
                # nothing pending yet (serve mode): surface runtime
                # events, hand control back, come around
                self._route(rt.poll_events(0.0), st, draining=False)
                yield "dispatch"
                continue
            node, client_id, flat, weight = item
            if traced:
                train_s += time.perf_counter() - _t
                pulls += 1
            if deadline is not None and time.perf_counter() > deadline:
                # budget expired mid-cohort: stop pumping — but the
                # update already pulled from the feed is real work;
                # record it so the owner can requeue it
                out.skipped.append((node, client_id, flat, weight))
                fire_deadline()
                break
            agg_id = mid_ids.get(node)
            if (agg_id is None or agg_id in st.lost
                    or dispatched[node] >= planned[node]):
                # nothing planned / subtree given up / node full
                out.skipped.append((node, client_id, flat, weight))
                continue
            _t = time.perf_counter() if traced else 0.0
            key = rt.put_update(flat)
            rt.deliver(agg_id, key, weight, round_id=round_id)
            if traced:
                now = time.perf_counter()
                deliver_s += now - _t
                delivers += 1
                st.first_dispatch.setdefault(agg_id, now)
            st.sent[agg_id].append((key, weight))
            dispatched[node] += 1
            accepted += 1
            self.dispatch(UpdateArrived(
                round_id=round_id, client_id=client_id, node=node,
                agg_id=agg_id, key=key, weight=weight))
            # opportunistic: surface partials/crashes while clients train
            self._route(rt.poll_events(0.0), st, draining=False)
            if accepted >= goal:
                break
            yield "dispatch"
        if traced:
            tr.point("client_train", train_s, owner="driver",
                     round_id=round_id, parent=tok, n=float(pulls))
            tr.point("deliver", deliver_s, owner="driver",
                     round_id=round_id, parent=tok, n=float(delivers))
        if accepted >= goal:
            self.dispatch(GoalReached(round_id=round_id, goal=goal,
                                      accepted=accepted))
        out.accepted = accepted
        out.dispatched = dict(dispatched)
        tr.end(tok, n=float(accepted))

        # --- COLLECT: close out stragglers, wait for counted subtrees --
        st.phase = "collect"
        st.draining = True
        tok = tr.begin("collect", owner="driver", round_id=round_id)
        counted = {mid_ids[node] for node in planned if dispatched[node]}
        for agg_id in mid_ids.values():
            rt.drain(agg_id)  # no-op if the task already published
        while (counted - st.lost) - set(st.partials):
            expired = deadline is not None and time.perf_counter() > deadline
            # on expiry, one last non-blocking sweep picks up partials
            # that already published before the budget ran out
            self._route(rt.poll_events(timeout=0.0 if expired else 0.05),
                        st, draining=True)
            if expired:
                fire_deadline()
                counted = set(st.partials)  # close with what we have
                break
            yield "collect"
        with tr.span("quiesce", owner="driver", round_id=round_id,
                     parent=tok):
            self._quiesce_runtime(round_id)
        tr.end(tok, n=float(len(st.partials)))

        # --- FOLD: execute the plan's root site ------------------------
        st.phase = "fold"
        # the rolling seam: the scheduler opens round N+1 the first
        # time round N pauses here — its SPAWN/DISPATCH overlap this
        # round's root fold
        yield "fold"
        tok = tr.begin("fold", owner="driver", round_id=round_id)
        order = sorted(set(st.partials) & counted)
        if order:
            root = fold_plan.site(fold_plan.root) if fold_plan.root \
                else None
            tier = root.tier if root is not None else "controller"
            folded = False
            if (root is not None and fold_plan.inners
                    and hasattr(rt, "deliver_partial")):
                folded = yield from self._fold_deep(st, rt, order, root)
            if (not folded and tier != "controller"
                    and hasattr(rt, "deliver_partial")):
                folded = yield from self._fold_on_runtime(
                    st, rt, order, root)
            if not folded:
                # re-collected subtrees keep their agg_ids, so the
                # counted set still names every foldable partial
                self._fold_in_controller(
                    st, rt, sorted(set(st.partials) & counted),
                    root.node if root is not None else top_node)
        tr.end(tok, n=float(len(order)))

    # ------------------------------------------------------------------
    # root-fold execution (plan interpretation)
    # ------------------------------------------------------------------
    def _fold_in_controller(self, st: "_RoundState", rt, order: List[str],
                            top_node: Optional[str]) -> None:
        """The controller-tier root fold: pull every partial to this
        process and fold sorted by agg_id — the legacy topology, kept
        bit for bit (and the fallback when a runtime-side fold gives
        up)."""
        out = st.out
        order = [a for a in order
                 if _partial_alive(rt, st.partials[a].key)]
        if not order:
            return
        top = top_node or order[0].split("@", 1)[-1]
        # the plan's job/round tags ride the top id too: warm-engine
        # pools stay per-job (engine_for strips the round tag), and the
        # TopFolded below is attributable to its job.  Untagged plans
        # produce the historical "top@node" byte for byte.
        top_id = join_agg_id("top", st.tag_job, st.tag_rid, top)
        engine = rt.engine_for(top_id)
        state = FedAvgState(engine=engine)
        state._ensure_acc(st.n_elems)
        sidecar = EventSidecar("top", self.metrics)
        t0 = time.perf_counter()
        for agg_id in order:
            p = st.partials[agg_id]
            view = rt.get_partial(p.key)   # zero-copy shm view
            state.acc = engine.add_partial(state.acc, view)
            state.weight += p.weight
            state.count += p.count
            rt.release_partial(p.key)
            out.exec_s[agg_id] = p.exec_s
        engine.sync(state.acc)
        fold_dt = time.perf_counter() - t0
        sidecar.on_aggregate(len(order), fold_dt)
        out.delta, out.weight = state.result()
        out.count = state.count
        sidecar.on_send(out.delta.nbytes)
        out.fold_tier, out.root_node = "controller", top
        if self.tracer.enabled:
            self.tracer.point(
                "fold.mid", sum(st.partials[a].exec_s for a in order),
                owner="driver", round_id=st.round_id, n=float(len(order)))
            self.tracer.point("fold.top", fold_dt, owner=top_id,
                              node=top, round_id=st.round_id, t0=t0,
                              n=float(len(order)))
        self.dispatch(TopFolded(
            round_id=st.round_id, agg_id=top_id, node=top,
            tier="controller", count=out.count, weight=out.weight,
            exec_s=fold_dt))

    def _fold_on_runtime(self, st: "_RoundState", rt, order: List[str],
                         root: FoldSite) -> bool:
        """Execute the plan's root fold *inside the runtime* — the top
        aggregator is a runtime aggregator on the root node (a parked
        worker process under shmproc; a daemon-side aggregator, fed by
        daemon→daemon partial shipping, under netrt), and only its
        folded Σ c·u comes back to the controller.

        Partials are delivered in sorted-agg_id order with an explicit
        sequence number, so the fold order — and therefore the bits —
        match the controller-tier fold exactly.  A dead root (node
        loss, spawn/ship failure) re-roots the round on the busiest
        surviving node, re-collecting any partials that died with the
        root, up to ``redispatch_limit`` attempts; returns False to
        fall back to a controller-side fold.

        A generator (driven via ``yield from`` inside the round body):
        both wait loops pause, so a rolling round N+1 keeps dispatching
        while this round's shipped partials fold remotely."""
        out = st.out
        want = set(order)
        root_node = root.node
        for attempt in range(self.redispatch_limit + 1):
            # 1. partials that died with their node: re-dispatch those
            # subtrees from their staged update keys and re-collect
            dead = [a for a in sorted(want) if a in st.partials
                    and not _partial_alive(rt, st.partials[a].key)]
            for a in dead:
                st.partials.pop(a)
                self._redispatch(
                    WorkerCrashed(round_id=st.round_id, agg_id=a),
                    st, draining=True)
            while (want - st.lost) - set(st.partials):
                expired = (st.deadline is not None
                           and time.perf_counter() > st.deadline)
                if expired:
                    break
                self._route(rt.poll_events(timeout=0.05), st,
                            draining=True)
                yield "fold"
            if st.deadline is not None \
                    and time.perf_counter() > st.deadline:
                # budget already gone: don't spawn a root and ship
                # model-size partials only to abandon the fold — close
                # controller-side with what's at hand
                return False
            live = sorted(
                a for a in (want - st.lost) & set(st.partials)
                if _partial_alive(rt, st.partials[a].key))
            if not live:
                return False
            # 2. root placement: keep the planned root while a partial
            # still lives there; otherwise re-root on the busiest
            # surviving node (largest folded count, name tie-break)
            homes = {a: (_partial_node(rt, st.partials[a].key)
                         or a.split("@", 1)[-1]) for a in live}
            if root_node not in set(homes.values()):
                by_node: Dict[str, int] = {}
                for a, n in homes.items():
                    by_node[n] = by_node.get(n, 0) + st.partials[a].count
                root_node = max(by_node, key=lambda n: (by_node[n], n))
            # a fresh agg_id per attempt: a failed attempt may have left
            # a stale open task under the old id on a surviving daemon.
            # Plan tags (job, rolling round) are mirrored onto the top
            # id; untagged plans keep the historical "top@node" form
            top_id = join_agg_id(
                "top" if attempt == 0 else f"top.{attempt}",
                st.tag_job, st.tag_rid, root_node)
            st.top_id, st.top_partial, st.top_crashed = top_id, None, False
            try:
                rt.spawn_aggregator(top_id, goal=len(live),
                                    n_elems=st.n_elems,
                                    round_id=st.round_id, kind="top")
                for seq, a in enumerate(live):
                    p = st.partials[a]
                    rt.deliver_partial(top_id, p.key, p.weight, p.count,
                                       round_id=st.round_id, seq=seq)
            except BaseException:
                st.top_id = None
                raise  # no live node at all: run_round aborts retriable
            while st.top_partial is None and not st.top_crashed:
                if (st.deadline is not None
                        and time.perf_counter() > st.deadline):
                    break
                self._route(rt.poll_events(timeout=0.05), st,
                            draining=True)
                yield "fold"
            st.top_id = None
            if st.top_partial is not None:
                p = st.top_partial
                view = rt.get_partial(p.key)
                # Σ weight accumulated in the same (sorted) order the
                # controller fold uses, so the division is bit-identical
                w, c = 0.0, 0
                for a in live:
                    w += st.partials[a].weight
                    c += st.partials[a].count
                    out.exec_s[a] = st.partials[a].exec_s
                out.delta = np.asarray(view, dtype=np.float32) \
                    / np.float32(w)
                rt.release_partial(p.key)
                out.weight, out.count = w, c
                out.exec_s[top_id] = p.exec_s
                out.fold_tier, out.root_node = root.tier, root_node
                # the end-of-round sweep reclaims the top's object too
                st.partials[top_id] = p
                if self.tracer.enabled:
                    self.tracer.point(
                        "fold.mid",
                        sum(st.partials[a].exec_s for a in live),
                        owner="driver", round_id=st.round_id,
                        n=float(len(live)))
                    self.tracer.point(
                        "fold.top", p.exec_s, owner=top_id,
                        node=root_node, round_id=st.round_id,
                        worker=p.worker, n=float(len(live)))
                self.dispatch(TopFolded(
                    round_id=st.round_id, agg_id=top_id, node=root_node,
                    tier=root.tier, count=c, weight=w, exec_s=p.exec_s))
                return True
            if st.deadline is not None \
                    and time.perf_counter() > st.deadline:
                return False  # budget expired: fold what's fetchable
            # root crashed: loop — the dead node's partials are filtered
            # and re-collected, and the next attempt re-roots
        return False

    def _fold_deep(self, st: "_RoundState", rt, order: List[str],
                   root: FoldSite):
        """Execute a deep (fanout-capped) plan's inner fold stages as
        runtime aggregators, bottom-up: a stage spawns once every one
        of its child partials is resolved, folds them in sorted-agg_id
        order (explicit seq), and its published partial feeds the next
        level — so a 100-mid round folds through log-depth stages
        instead of one 100-way root fold.

        The root's Σ weight/count are accumulated *flat over the sorted
        leaf partials* — exactly the expression the two-level fold
        evaluates — so the final division is bit-identical to the flat
        plan whenever the partial sums are (integer-valued updates, or
        any fanout that preserves the fold grouping).

        Bails out (``False`` → the flat fallback) on a crashed stage,
        an expired deadline, or a plan leaf that never published — the
        degraded paths stay on the battle-tested flat fold."""
        out = st.out
        plan = st.plan
        leaves = sorted(s.agg_id for s in plan.mids)
        if set(order) != set(leaves):
            return False          # lost subtree / deadline close-out
        resolved: Dict[str, PartialReady] = {
            a: st.partials[a] for a in leaves}
        pending = {s.agg_id: s for s in plan.inners}
        st.top_results, st.deep_crashed = {}, False
        while pending:
            batch = [a for a in sorted(pending)
                     if all(c in resolved for c in pending[a].children)]
            if not batch:
                return False      # malformed plan: no resolvable stage
            st.pending_tops = set(batch)
            try:
                for a in batch:
                    s = pending.pop(a)
                    rt.spawn_aggregator(a, goal=len(s.children),
                                        n_elems=st.n_elems,
                                        round_id=st.round_id, kind="top")
                    for seq, c in enumerate(sorted(s.children)):
                        p = resolved[c]
                        rt.deliver_partial(a, p.key, p.weight, p.count,
                                           round_id=st.round_id, seq=seq)
            except BaseException:
                st.pending_tops = set()
                raise
            while st.pending_tops - set(st.top_results) \
                    and not st.deep_crashed:
                if (st.deadline is not None
                        and time.perf_counter() > st.deadline):
                    st.pending_tops = set()
                    return False
                self._route(rt.poll_events(timeout=0.05), st,
                            draining=True)
                yield "fold"
            st.pending_tops = set()
            if st.deep_crashed:
                return False
            for a in batch:
                p = st.top_results[a]
                resolved[a] = p
                st.partials[a] = p   # end-of-round sweep reclaims it
                out.exec_s[a] = p.exec_s
        # --- the root fold over the final level ------------------------
        final = sorted(root.children)
        if any(a not in resolved for a in final):
            return False
        w, c = 0.0, 0
        for a in leaves:
            w += st.partials[a].weight
            c += st.partials[a].count
            out.exec_s[a] = st.partials[a].exec_s
        if root.tier != "controller":
            st.top_id = root.agg_id
            st.top_partial, st.top_crashed = None, False
            try:
                rt.spawn_aggregator(root.agg_id, goal=len(final),
                                    n_elems=st.n_elems,
                                    round_id=st.round_id, kind="top")
                for seq, a in enumerate(final):
                    p = resolved[a]
                    rt.deliver_partial(root.agg_id, p.key, p.weight,
                                       p.count, round_id=st.round_id,
                                       seq=seq)
            except BaseException:
                st.top_id = None
                raise
            while st.top_partial is None and not st.top_crashed:
                if (st.deadline is not None
                        and time.perf_counter() > st.deadline):
                    break
                self._route(rt.poll_events(timeout=0.05), st,
                            draining=True)
                yield "fold"
            st.top_id = None
            if st.top_partial is None:
                return False      # root crashed/expired: flat fallback
            p = st.top_partial
            view = rt.get_partial(p.key)
            out.delta = np.asarray(view, dtype=np.float32) / np.float32(w)
            rt.release_partial(p.key)
            out.exec_s[root.agg_id] = p.exec_s
            st.partials[root.agg_id] = p
            fold_dt = p.exec_s
        else:
            engine = rt.engine_for(root.agg_id)
            state = FedAvgState(engine=engine)
            state._ensure_acc(st.n_elems)
            sidecar = EventSidecar("top", self.metrics)
            t0 = time.perf_counter()
            for a in final:
                p = st.partials[a]
                view = rt.get_partial(p.key)
                state.acc = engine.add_partial(state.acc, view)
                rt.release_partial(p.key)
            engine.sync(state.acc)
            fold_dt = time.perf_counter() - t0
            sidecar.on_aggregate(len(final), fold_dt)
            state.weight, state.count = w, c
            out.delta, _w = state.result()
            sidecar.on_send(out.delta.nbytes)
        out.weight, out.count = w, c
        out.fold_tier, out.root_node = root.tier, root.node
        if self.tracer.enabled:
            self.tracer.point(
                "fold.mid", sum(st.partials[a].exec_s for a in leaves),
                owner="driver", round_id=st.round_id, n=float(len(leaves)))
            self.tracer.point(
                "fold.inner",
                sum(resolved[s.agg_id].exec_s for s in plan.inners),
                owner="driver", round_id=st.round_id,
                n=float(len(plan.inners)))
            self.tracer.point(
                "fold.top", fold_dt, owner=root.agg_id, node=root.node,
                round_id=st.round_id, n=float(len(final)))
        self.dispatch(TopFolded(
            round_id=st.round_id, agg_id=root.agg_id, node=root.node,
            tier=root.tier, count=c, weight=w, exec_s=fold_dt))
        return True

    # ------------------------------------------------------------------
    def _route(self, events: List[RoundEvent], st: "_RoundState", *,
               draining: bool) -> None:
        """Fold a batch of runtime events into per-round state.  With
        rolling rounds the poll that surfaces an event may belong to
        the OTHER in-flight round — each round-scoped event is absorbed
        into the state of the round it names, under that round's own
        draining mode; everything else lands on the polling round."""
        for ev in events:
            tgt = None
            if ev.round_id is not None and ev.round_id != st.round_id:
                tgt = self._inflight.get(ev.round_id)
            if tgt is not None:
                self._absorb_one(ev, tgt, draining=tgt.draining)
            else:
                self._absorb_one(ev, st, draining=draining)

    def _absorb_one(self, ev: RoundEvent, st: "_RoundState", *,
                    draining: bool) -> None:
        """Fold one runtime event into the round's state."""
        rt = self.runtime
        if isinstance(ev, PartialReady):
            if (st.top_id is not None and ev.agg_id == st.top_id
                    and ev.round_id == st.round_id
                    and st.top_partial is None):
                # the runtime-side root fold published its Σ c·u.
                # Absorbed silently — TopFolded is the public
                # signal: handlers (the coordinator's RC model
                # included) must see the same event stream whatever
                # tier the root ran on, or the next round's
                # placement would diverge between topologies.
                st.top_partial = ev
                return
            if (ev.agg_id in st.pending_tops
                    and ev.round_id == st.round_id
                    and ev.agg_id not in st.top_results):
                # an inner fold stage of a deep plan published its
                # partial — absorbed silently, same as the root above
                st.top_results[ev.agg_id] = ev
                return
            if (ev.round_id != st.round_id or ev.agg_id not in st.sent
                    or ev.agg_id in st.partials):
                # stale leftover (aborted round / force-released
                # task): reclaim the orphan object, don't surface
                self.stats["stale_dropped"] += 1
                rt.discard_partial(ev.key)
                return
            st.partials[ev.agg_id] = ev
            if self.tracer.enabled:
                t0d = st.first_dispatch.get(ev.agg_id)
                if t0d is not None:
                    # dispatch → publish latency for this subtree
                    self.tracer.point(
                        "subtree", time.perf_counter() - t0d,
                        owner=ev.agg_id, round_id=st.round_id,
                        t0=t0d, worker=ev.worker, n=float(ev.count))
            self.dispatch(ev)
        elif isinstance(ev, WorkerCrashed):
            if not self.dispatch(ev):
                # stale leftover from a finished round (the guard
                # counted it): the agg_id may name THIS round's
                # identically-named subtree — re-dispatching it
                # would respawn a healthy mid
                return
            st.out.crashes += 1
            self.stats["crashes"] += 1
            if st.top_id is not None and ev.agg_id == st.top_id:
                # the root fold died (node loss / ship failure):
                # _fold_on_runtime re-roots; nothing to re-dispatch
                st.top_crashed = True
                return
            if ev.agg_id in st.pending_tops:
                # an inner fold stage died: the deep fold bails out
                # and the round falls back to the flat root fold
                st.deep_crashed = True
                return
            self._redispatch(ev, st, draining=draining)
        else:
            self.dispatch(ev)

    def _redispatch(self, ev: WorkerCrashed, st: "_RoundState", *,
                    draining: bool) -> None:
        """Crash recovery: the dead worker's unpublished folds are gone,
        but every update object it was sent still lives (sealed) in the
        store — re-dispatch the surviving keys to a fresh/sibling
        worker so the round reaches its full goal.  A subtree that
        keeps crashing (poisoned update, worker-side OOM) is given up
        after ``redispatch_limit`` attempts so the round can't hang."""
        rt = self.runtime
        agg_id = ev.agg_id
        if not agg_id or agg_id not in st.sent or agg_id in st.partials:
            return  # no expected work died with it (warming fork etc.)
        tries = st.attempts.get(agg_id, 0)
        if tries >= self.redispatch_limit:
            st.lost.add(agg_id)  # deterministic crasher: drop the subtree
            return
        surviving = [(k, w) for k, w in st.sent[agg_id]
                     if rt.update_alive(k)]
        if not surviving and draining:
            st.lost.add(agg_id)  # nothing recoverable: give the subtree up
            return
        # mid-pump a zero-dispatch subtree is still respawned, so later
        # updates for its node keep a live route
        st.attempts[agg_id] = tries + 1
        rt.spawn_aggregator(agg_id, goal=st.spawn_goals[agg_id],
                            n_elems=st.n_elems, round_id=st.round_id)
        for key, weight in surviving:
            rt.deliver(agg_id, key, weight, round_id=st.round_id)
        if draining and len(surviving) < st.spawn_goals[agg_id]:
            rt.drain(agg_id)  # no more arrivals are coming
        if surviving:
            st.out.redispatched += 1
            self.stats["redispatched"] += 1


class RoundHandle:
    """A resumable in-flight round — what :meth:`RoundDriver.open_round`
    returns.  :meth:`step` advances the round one increment and reports
    the phase it paused in (``'spawn' | 'dispatch' | 'collect' |
    'fold' | 'done'``); :meth:`run` steps to completion, which is the
    legacy synchronous ``run_round`` behavior exactly.  The rolling
    scheduler interleaves two handles, opening round N+1 once round N
    first pauses in ``'fold'``."""

    def __init__(self, driver: RoundDriver, st: _RoundState,
                 gen, tok_round: int, stats0: Dict[str, int]):
        self.driver = driver
        self.st = st
        self._gen = gen
        self._tok_round = tok_round
        self._stats0 = stats0
        self.phase = "open"

    @property
    def round_id(self) -> int:
        return self.st.round_id

    @property
    def outcome(self) -> RoundOutcome:
        return self.st.out

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def step(self) -> str:
        """Advance the round to its next pause point; returns the phase
        paused in, or ``'done'`` once the round closed (outcome final)."""
        if self.phase == "done":
            return "done"
        try:
            self.phase = next(self._gen)
        except StopIteration:
            self._finish(completed=True)
        except BaseException:
            # a failing client/handler must not brick the driver: park
            # the runtime (scoped, so a co-open round survives) and
            # close this round retriable, then re-raise
            try:
                self.driver._quiesce_runtime(self.st.round_id)
            except Exception:
                pass
            self._finish(completed=False)
            raise
        return self.phase

    def run(self) -> RoundOutcome:
        """Drive the round to completion in place."""
        while not self.done:
            self.step()
        return self.st.out

    def abort(self) -> RoundOutcome:
        """Close an unfinished round early: release its staged store
        objects and free its driver slot WITHOUT advancing the
        stale-round horizon (a retry may reuse the round id)."""
        if self.done:
            return self.st.out
        self._gen.close()
        try:
            self.driver._quiesce_runtime(self.st.round_id)
        except Exception:
            pass
        self._finish(completed=False)
        return self.st.out

    def _finish(self, completed: bool) -> None:
        # always release the round's store objects and close the
        # round, success or not — same sweep order as ever
        drv, st = self.driver, self.st
        rt = drv.runtime
        for p in st.partials.values():
            try:
                rt.discard_partial(p.key)
            except Exception:
                pass
        for keys in st.sent.values():
            for key, _ in keys:
                try:
                    rt.discard_update(key)
                except Exception:
                    pass
        if completed:
            drv.end_round(st.round_id)
        else:
            drv.abort_round(st.round_id)  # retriable: same rid stays live
        drv._inflight.pop(st.round_id, None)
        drv._finish_trace(self._tok_round, st.round_id, st.out, rt,
                          completed, job=st.job)
        out = st.out
        out.cold_starts = rt.stats.get("cold_starts", 0) \
            - self._stats0["cold_starts"]
        out.warm_starts = rt.stats.get("warm_starts", 0) \
            - self._stats0["warm_starts"]
        out.workers = rt.worker_count()
        self.phase = st.phase = "done"
