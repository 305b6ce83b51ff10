"""Event-driven dispatcher: forks, parks, routes, supervises.

The control-plane half of the multi-process runtime (paper Fig 3 +
§5.3 reuse semantics across real process boundaries):

  * **cold start** — ``submit_task`` with no idle worker forks one
    (rings + doorbells are created first and inherited), pays the
    process spin-up, and waits for READY;
  * **warm start** — an idle worker is re-tasked by writing one 64-byte
    TASK record into its ring: the process, its engine scratch, and its
    store mappings are already resident (the ``AggregatorPool``
    IDLE→BUSY transition, across processes);
  * **routing** — envelopes are routed by tree position (``agg_id``):
    the dispatcher keeps an ``agg_id → worker`` table for the round,
    the sockmap-TAG analog;
  * **supervision** — ``poll`` detects dead workers (crash ≠ drain),
    reclaims their shm segments by name prefix, and surfaces a
    :class:`WorkerCrash`; ``shutdown`` drains gracefully and unlinks
    every ring; an atexit hook backstops abnormal exits.

Metrics: every PARTIAL feeds the event sidecar (`agg_updates`,
`agg_exec_s`) — exactly the series ``placement.py``'s capacity model
(RC = MC − k·E) consumes; ``node_exec_time`` exposes the E_{i,t}
estimate per tree position.
"""
from __future__ import annotations

import atexit
import os
import secrets
import time
import warnings
from dataclasses import dataclass, field
from multiprocessing import get_context
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.objectstore import (
    SharedMemoryObjectStore,
    new_object_key,
    unlink_segment,
)
from repro_torch.core.sidecar import EventSidecar, MetricsMap
from repro_torch.runtime.shmrt.messages import Record, RecordKind
from repro_torch.runtime.shmrt.ring import Doorbell, SpscRing
from repro_torch.runtime.shmrt.worker import worker_main

_FORK = get_context("fork")


class WorkerCrash(RuntimeError):
    def __init__(self, widx: int, agg_id: Optional[str], exitcode):
        super().__init__(
            f"aggregator worker {widx} died (exit {exitcode}) "
            f"while assigned {agg_id!r}")
        self.widx = widx
        self.agg_id = agg_id
        self.exitcode = exitcode


@dataclass
class PartialResult:
    """A published intermediate aggregate: fold via ``store.get(key)``."""

    agg_id: str
    key: str
    weight: float
    count: int
    exec_s: float
    round_id: int
    worker: int


@dataclass
class _Worker:
    idx: int
    proc: object = None
    task_ring: SpscRing = None
    result_ring: SpscRing = None
    state: str = "cold"          # cold|warming|idle|busy
    agg_id: Optional[str] = None
    seq: int = 0
    ready_ts: float = 0.0
    submit_ts: float = 0.0
    ack_latency_s: Optional[float] = None
    ack_ts: float = 0.0          # pickup ts of the open task (worker clock)
    wait_s: float = 0.0          # TELEM ring-wait for the open task
    cold_started: bool = False   # this task paid a fork
    tasks_done: int = 0


class ShmRuntime:
    """Single-node multi-process aggregation runtime.

    One instance owns the object store prefix, the worker fleet, and
    all rings.  Typical round (see ``FederatedTrainer``):

        rt = ShmRuntime()
        rt.submit_task("mid@node0", goal=4, n_elems=N)
        for u, w in updates:
            rt.dispatch("mid@node0", rt.store.put(u), w)
        for p in rt.collect(n_partials=1):
            acc += rt.store.get(p.key)      # zero-copy fold
            rt.store.destroy(p.key)
        rt.release("mid@node0")             # park the worker warm
    """

    def __init__(self, *, nslots: int = 1024, batch_k: int = 8,
                 prefix: Optional[str] = None,
                 metrics: Optional[MetricsMap] = None,
                 max_workers: int = 32):
        # per-instance nonce: two runtimes in one process (e.g. an
        # inproc-vs-shmproc comparison script) must not collide on ring
        # or object segment names
        self.prefix = prefix or (
            f"lifl{os.getpid() & 0xffff:x}{secrets.token_hex(2)}")
        self.store = SharedMemoryObjectStore(
            node="dispatcher", prefix=self.prefix)
        self.nslots = nslots
        self.batch_k = batch_k
        self.max_workers = max_workers
        self.metrics = metrics if metrics is not None else MetricsMap()
        self._workers: List[_Worker] = []
        self._route: Dict[str, _Worker] = {}     # agg_id -> worker (TAG)
        self._exec_ewma: Dict[str, float] = {}   # agg_id -> E_{i,t}
        self.stats = {
            "cold_starts": 0, "warm_starts": 0, "partials": 0,
            "crashes": 0, "forked": 0, "stale_partials": 0,
            "cold_latency_s": 0.0, "warm_latency_s": 0.0,
        }
        # poll() buffers through these queues so a WorkerCrash raised
        # mid-scan never discards partials already popped off other
        # workers' rings (they surface on the next poll), and multiple
        # same-scan crashes are raised one per call, not collapsed
        self._results: List[PartialResult] = []
        self._crashes: List[WorkerCrash] = []
        # worker-side span dicts (worker.task = ACK→PARTIAL on the
        # worker's own clock, worker.wait = TELEM's ring-wait), drained
        # by take_spans() into the round trace; bounded so an untraced
        # caller never accumulates them without limit
        self._spans: List[Dict] = []
        self._spans_cap = 4096
        self._closed = False
        atexit.register(self._atexit)

    # ------------------------------------------------------------------
    # worker lifecycle
    # ------------------------------------------------------------------
    def _fork_worker(self) -> _Worker:
        idx = len(self._workers)
        if idx >= self.max_workers:
            raise RuntimeError(f"worker fleet capped at {self.max_workers}")
        w = _Worker(idx=idx)
        w.task_ring = SpscRing(
            f"{self.prefix}-tq{idx}", nslots=self.nslots, create=True,
            data_bell=Doorbell(), space_bell=Doorbell())
        w.result_ring = SpscRing(
            f"{self.prefix}-rq{idx}", nslots=self.nslots, create=True,
            data_bell=Doorbell(), space_bell=Doorbell())
        w.proc = _FORK.Process(
            target=worker_main,
            args=(idx, w.task_ring, w.result_ring, self.prefix, self.batch_k),
            daemon=True, name=f"lifl-agg-worker-{idx}",
        )
        with warnings.catch_warnings():
            # jax warns that fork + its threads can deadlock; the worker
            # child is numpy-only by construction (worker.py) and never
            # re-enters XLA, so the hazard doesn't apply
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=RuntimeWarning)
            w.proc.start()
        w.state = "warming"
        self.stats["forked"] += 1
        self._workers.append(w)
        return w

    def _await_ready(self, w: _Worker, timeout: float = 30.0) -> None:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            raw = w.result_ring.pop(timeout=0.5)
            if raw is not None and Record.unpack(raw).kind == RecordKind.READY:
                w.ready_ts = time.perf_counter()
                w.state = "idle"
                return
            if not w.proc.is_alive():
                raise WorkerCrash(w.idx, None, w.proc.exitcode)
        raise TimeoutError(f"worker {w.idx} did not come up in {timeout}s")

    def _acquire(self) -> _Worker:
        for w in self._workers:
            if w.state == "idle":
                if not w.proc.is_alive():
                    # died while parked (OOM-kill etc.): reap instead of
                    # pushing a task into a ring nobody drains
                    self._reap(w)
                    continue
                self.stats["warm_starts"] += 1
                w.cold_started = False
                return w
        w = self._fork_worker()
        self._await_ready(w)
        self.stats["cold_starts"] += 1
        w.cold_started = True
        return w

    # ------------------------------------------------------------------
    # round-facing API
    # ------------------------------------------------------------------
    def submit_task(self, agg_id: str, goal: int, n_elems: int,
                    round_id: int = 0) -> int:
        """Assign an aggregation task to a (warm if possible) worker.
        Returns the worker index.  The TASK record is the entire
        dispatch: one 64-byte write + a doorbell."""
        if agg_id in self._route:
            raise ValueError(f"{agg_id!r} already has an open task")
        t0 = time.perf_counter()  # cold dispatch latency includes the fork
        w = self._acquire()
        w.seq += 1
        w.agg_id = agg_id
        w.state = "busy"
        w.submit_ts = t0
        w.ack_latency_s = None
        ok = w.task_ring.push(Record(
            kind=RecordKind.TASK, key=_tag16(agg_id), round_id=round_id,
            flags=w.seq, a=goal, b=n_elems, ts=w.submit_ts,
        ).pack(), timeout=5.0)
        if not ok:
            raise RuntimeError(f"task ring full for worker {w.idx}")
        self._route[agg_id] = w
        return w.idx

    def dispatch(self, agg_id: str, object_key: str, weight: float,
                 round_id: int = 0) -> None:
        """Route one envelope (16-byte key + aux) by tree position."""
        w = self._route[agg_id]
        ok = w.task_ring.push(Record(
            kind=RecordKind.UPDATE, key=object_key, round_id=round_id,
            num_samples=weight, ts=time.perf_counter(),
        ).pack(), timeout=30.0)
        if not ok:
            if not w.proc.is_alive():
                self._reap(w)
            raise RuntimeError(
                f"update ring for {agg_id!r} blocked >30s (worker "
                f"{w.idx} alive={w.proc.is_alive()})")

    def dispatch_partial(self, agg_id: str, object_key: str, weight: float,
                         count: int, round_id: int = 0) -> None:
        """Route one published raw partial Σ c·u into a root-fold task.
        The ring is FIFO, so the worker absorbs partials exactly in the
        order they are dispatched — the caller fixes the fold order."""
        w = self._route[agg_id]
        ok = w.task_ring.push(Record(
            kind=RecordKind.PARTIAL_IN, key=object_key, round_id=round_id,
            num_samples=weight, a=int(count), ts=time.perf_counter(),
        ).pack(), timeout=30.0)
        if not ok:
            if not w.proc.is_alive():
                self._reap(w)
            raise RuntimeError(
                f"partial ring for {agg_id!r} blocked >30s (worker "
                f"{w.idx} alive={w.proc.is_alive()})")

    def drain(self, agg_id: str) -> None:
        """Close out a straggler-shortened task: the worker publishes
        whatever it has folded."""
        w = self._route.get(agg_id)
        if w is not None:
            w.task_ring.push(Record(
                kind=RecordKind.DRAIN, flags=w.seq).pack(), timeout=5.0)

    # ------------------------------------------------------------------
    def _scan(self) -> None:
        """Drain every result ring into the internal queues and reap
        dead workers.  Never raises; never drops a record."""
        for w in self._workers:
            if w.state == "dead":
                continue
            while True:
                raw = w.result_ring.pop()
                if raw is None:
                    break
                rec = Record.unpack(raw)
                if rec.kind == RecordKind.ACK:
                    if rec.flags != w.seq:
                        continue  # stale ack from a force-released task
                    w.ack_latency_s = rec.ts - w.submit_ts
                    w.ack_ts = rec.ts
                    kind = "cold" if w.cold_started else "warm"
                    self.stats[f"{kind}_latency_s"] = w.ack_latency_s
                    self.metrics.update(
                        w.agg_id or f"worker{w.idx}",
                        f"dispatch_{kind}_s", w.ack_latency_s)
                elif rec.kind == RecordKind.TELEM:
                    if rec.flags != w.seq:
                        continue  # stale telemetry, like a stale ack
                    w.wait_s = rec.num_samples
                    self.metrics.update(w.agg_id or f"worker{w.idx}",
                                        "ring_wait_s", rec.num_samples)
                    # distribution under a fixed owner (per-agg owners
                    # would mint unbounded histograms)
                    self.metrics.observe("shm", "ring_dwell_s",
                                         rec.num_samples)
                elif rec.kind == RecordKind.PARTIAL:
                    if rec.flags != w.seq:
                        # a force-released task's late partial: reclaim
                        # the orphaned object, don't surface it
                        self.stats["stale_partials"] += 1
                        unlink_segment(self.store.segment_name(rec.key))
                        continue
                    self._results.append(self._on_partial(w, rec))
                elif rec.kind == RecordKind.EMPTY:
                    if rec.flags != w.seq:
                        continue
                    # task closed with nothing folded: no partial
                    self._route.pop(w.agg_id, None)
                    w.agg_id = None
                    w.state = "idle"
                # READY/ERROR records carry no round state here
            if w.state in ("busy", "warming") and not w.proc.is_alive():
                agg_id = w.agg_id
                self._reap(w)
                self._crashes.append(
                    WorkerCrash(w.idx, agg_id, w.proc.exitcode))
            elif w.state == "idle" and not w.proc.is_alive():
                # a dead *idle* worker loses capacity, not work: reap
                # quietly, the next submit just forks a fresh one
                self._reap(w)

    def _wait_any_result(self, max_wait: float) -> None:
        """Block on the result-ring doorbells (event-driven idle) —
        capped at 50 ms so a crashed worker, which never rings, is
        still detected promptly by the next _scan."""
        bells = [w.result_ring.data_bell for w in self._workers
                 if w.state not in ("dead",) and w.result_ring is not None
                 and w.result_ring.data_bell is not None
                 and w.result_ring.data_bell.fileno() >= 0]
        slice_s = min(max_wait, 0.05)
        if not bells:
            time.sleep(min(slice_s, 0.0005))
            return
        import select as _select

        ready, _, _ = _select.select(bells, [], [], slice_s)
        for bell in ready:
            bell.drain()

    def poll(self, timeout: float = 0.0) -> List[PartialResult]:
        """Scan result rings; returns published partials.  Detects and
        reaps crashed workers: each crash raises one
        :class:`WorkerCrash` (after its segments are reclaimed), with
        already-collected partials preserved for the next call."""
        deadline = time.perf_counter() + timeout
        while True:
            self._scan()
            if self._crashes:
                raise self._crashes.pop(0)
            left = deadline - time.perf_counter()
            if self._results or left <= 0:
                out, self._results = self._results, []
                return out
            self._wait_any_result(left)

    def collect(self, n_partials: int, timeout: float = 60.0
                ) -> List[PartialResult]:
        """Block until ``n_partials`` intermediate aggregates arrived.
        On WorkerCrash, partials gathered so far are re-queued so the
        caller can retry ``collect`` with a reduced count."""
        got: List[PartialResult] = []
        deadline = time.perf_counter() + timeout
        try:
            while len(got) < n_partials:
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError(
                        f"collected {len(got)}/{n_partials} partials in "
                        f"{timeout}s")
                got.extend(self.poll(timeout=min(left, 0.05)))
        except WorkerCrash:
            self._results = got + self._results
            raise
        return got

    def quiesce(self, timeout: float = 5.0,
                agg_ids: Optional[set] = None) -> None:
        """Wait for every open task to close (PARTIAL or EMPTY), then
        force-release stragglers.  Call between rounds so a late EMPTY
        from a zero-update drain can't collide with the next round's
        task under the same agg_id (stale records are seq-guarded).
        ``agg_ids`` scopes the barrier to those tasks only (a rolling
        round closing out while the next one's tasks stay open)."""
        def waiting():
            if agg_ids is None:
                return bool(self._route)
            return any(a in agg_ids for a in self._route)

        deadline = time.perf_counter() + timeout
        while waiting() and time.perf_counter() < deadline:
            try:
                self._scan()
            except Exception:
                pass
            if self._crashes and agg_ids is None:
                # already reaped; round is over.  (Scoped barriers keep
                # the buffer: a crash may belong to the OTHER in-flight
                # round, which still needs to see it via poll().)
                self._crashes.clear()
            if waiting():
                time.sleep(0.001)
        for agg_id in list(self._route):
            if agg_ids is None or agg_id in agg_ids:
                self.release(agg_id)

    def _on_partial(self, w: _Worker, rec: Record) -> PartialResult:
        agg_id = w.agg_id or f"worker{w.idx}"
        exec_s = rec.b / 1e9
        self.stats["partials"] += 1
        w.tasks_done += 1
        # event sidecar: the series the placement capacity model reads
        sidecar = EventSidecar(agg_id, self.metrics)
        sidecar.on_aggregate(int(rec.a), exec_s)
        sidecar.on_send(self.store.meta(rec.key).nbytes)
        prev = self._exec_ewma.get(agg_id)
        self._exec_ewma[agg_id] = (
            exec_s if prev is None else 0.5 * prev + 0.5 * exec_s)
        result = PartialResult(
            agg_id=agg_id, key=rec.key, weight=rec.num_samples,
            count=int(rec.a), exec_s=exec_s, round_id=rec.round_id,
            worker=w.idx,
        )
        # worker spans, derived entirely from records already in
        # flight: task = pickup→publish on the worker's own clock,
        # wait = the TELEM ring-starvation total inside that window
        if w.ack_ts > 0.0 and rec.ts > w.ack_ts:
            self._add_span({
                "kind": "worker.task", "owner": agg_id,
                "round_id": rec.round_id, "t0": w.ack_ts,
                "dur_s": rec.ts - w.ack_ts, "worker": w.idx,
                "n": float(rec.a)})
        if w.wait_s > 0.0:
            self._add_span({
                "kind": "worker.wait", "owner": agg_id,
                "round_id": rec.round_id, "t0": w.ack_ts,
                "dur_s": w.wait_s, "worker": w.idx, "n": float(rec.a)})
        w.ack_ts = 0.0
        w.wait_s = 0.0
        # task complete: route entry dies, worker awaits release/re-task
        self._route.pop(agg_id, None)
        w.agg_id = None
        w.state = "idle"
        return result

    def _add_span(self, d: Dict) -> None:
        if len(self._spans) >= self._spans_cap:
            del self._spans[: self._spans_cap // 2]
        self._spans.append(d)

    def take_spans(self) -> List[Dict]:
        """Return-and-clear the worker span dicts gathered since the
        last take (the runtime wrapper turns them into Span objects)."""
        out, self._spans = self._spans, []
        return out

    def release(self, agg_id: str) -> None:
        """Explicitly park a worker warm (no-op if its task finished —
        publishing a partial already IDLEs it)."""
        w = self._route.pop(agg_id, None)
        if w is not None:
            w.agg_id = None
            w.state = "idle"

    # ------------------------------------------------------------------
    # supervision / teardown
    # ------------------------------------------------------------------
    def node_exec_time(self, agg_id: str, default: float = 1.0) -> float:
        """EWMA'd E_{i,t} for the capacity model (placement.py)."""
        return self._exec_ewma.get(agg_id, default)

    def idle_count(self) -> int:
        return sum(1 for w in self._workers if w.state == "idle")

    def worker_pids(self) -> Dict[int, int]:
        return {w.idx: w.proc.pid for w in self._workers
                if w.state != "dead"}

    def health(self) -> Dict[str, int]:
        """Live pool gauges for the ``stats`` scrape: worker states and
        total ring occupancy (tasks pushed but not yet drained)."""
        busy = parked = depth = 0
        for w in self._workers:
            if w.state in ("busy", "warming"):
                busy += 1
            elif w.state == "idle":
                parked += 1
            for ring in (w.task_ring, w.result_ring):
                try:
                    depth += len(ring)
                except (TypeError, ValueError, OSError):
                    pass
        return {"workers": len(self._workers), "workers_busy": busy,
                "workers_parked": parked, "ring_depth": depth}

    def _reap(self, w: _Worker) -> None:
        """A worker died mid-task: reclaim every segment it created
        (its object keys start with ``<widx:02x>``) and its rings."""
        self.stats["crashes"] += 1
        w.state = "dead"
        if w.agg_id is not None:
            self._route.pop(w.agg_id, None)
        reclaimed = self.reclaim_worker_segments(w.idx)
        self.metrics.update(f"worker{w.idx}", "crash_segments_reclaimed",
                            float(reclaimed))

    def reclaim_worker_segments(self, widx: int) -> int:
        """Unlink /dev/shm segments created by worker ``widx`` (its
        object keys start ``w<idx>``; gateway keys are pure hex, so the
        prefix can't false-positive on a live update object)."""
        pat = f"{self.prefix}-w{widx & 0xff:02x}"
        n = 0
        shm_dir = "/dev/shm"
        if os.path.isdir(shm_dir):
            for name in os.listdir(shm_dir):
                if name.startswith(pat):
                    if unlink_segment(name):
                        n += 1
        return n

    def shutdown(self, timeout: float = 10.0) -> None:
        """Graceful drain: SHUTDOWN every worker, join, then unlink all
        runtime segments (rings + any stranded objects)."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w.state != "dead" and w.proc is not None:
                try:
                    w.task_ring.push(
                        Record(kind=RecordKind.SHUTDOWN).pack(), timeout=1.0)
                except Exception:
                    pass
        deadline = time.perf_counter() + timeout
        for w in self._workers:
            if w.proc is None:
                continue
            w.proc.join(timeout=max(0.1, deadline - time.perf_counter()))
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2.0)
        for w in self._workers:
            for ring in (w.task_ring, w.result_ring):
                if ring is not None:
                    try:
                        ring.unlink()
                    except Exception:
                        pass
            for bell in (w.task_ring.data_bell, w.task_ring.space_bell,
                         w.result_ring.data_bell, w.result_ring.space_bell):
                if bell is not None:
                    bell.close()
        self._workers.clear()
        self._route.clear()
        self.store.close()

    def _atexit(self) -> None:
        try:
            self.shutdown(timeout=2.0)
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def _tag16(agg_id: str) -> str:
    """Squeeze an aggregator id into the 16-char key field (a stable
    routing tag, not a store key)."""
    s = "".join(c for c in agg_id if c.isalnum())[:16]
    return s or new_object_key()
