"""Event-driven spans + per-round traces (paper §4.3, the LIFL agent).

The paper's monitoring plane has three pieces: eBPF programs that fire
*only* on send events (zero cost when idle), in-kernel metric maps the
samples land in, and a LIFL agent that drains those maps toward the
metrics server.  This module is the host-side reification of the first
and last pieces for the repro:

  * :class:`Span` / :class:`Tracer` — monotonic-clock begin/end samples
    produced only at existing event edges (driver phase transitions,
    worker publishes, daemon frame handling).  No resident thread, no
    polling; a disabled tracer is two attribute loads per hook.
  * :class:`RoundTrace` — the per-round merge target: driver spans,
    worker spans derived from ring records, and the per-daemon
    ``MetricsMap`` series drained over the wire on quiesce (the agent's
    periodic retrieval, piggybacked on an event edge the round already
    has).
  * :meth:`RoundTrace.breakdown` — attributes round wall time to the
    paper's tiers (client train, wire, mid folds, top fold, control)
    with an explicit unaccounted residual, from *disjoint* driver-side
    intervals so the tiers always sum to the wall clock.

Spans ride the same wire seam as ``runtime/events.py``: frozen
dataclass, JSON codec, a name registry (``SPAN_KINDS``) the tests
iterate.
"""
from __future__ import annotations

import io
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class Span:
    """One timed interval on somebody's monotonic clock.

    ``t0`` is ``time.perf_counter()`` *of the process that measured it*
    — comparable within one process, not across hosts.  Cross-process
    aggregation therefore happens on durations (``dur_s``), never on
    absolute stamps.
    """

    kind: str = ""
    owner: str = ""            # agg_id / "driver" / node name
    node: str = ""             # where the interval was measured
    round_id: Optional[int] = None
    t0: float = 0.0            # perf_counter at begin (measurer's clock)
    dur_s: float = 0.0
    id: int = -1
    parent: int = -1           # id of the enclosing span (-1: root)
    worker: int = -1           # shm worker index (-1: not a worker span)
    n: float = 0.0             # payload: update count, bytes, ...


#: every span kind the subsystem emits; the wire codec and tests
#: iterate this (same contract as events.EVENT_TYPES).
SPAN_KINDS: Tuple[str, ...] = (
    "round",          # whole run_round call (driver)
    "spawn",          # SPAWN phase: aggregator placement on the runtime
    "dispatch",       # DISPATCH phase: the pump loop, contiguous
    "collect",        # COLLECT phase: waiting on outstanding subtrees
    "fold",           # FOLD phase: root-site fold orchestration
    "client_train",   # Σ time pulling the updates generator (child of dispatch)
    "deliver",        # Σ time in runtime deliver/put_update (child of dispatch)
    "quiesce",        # runtime quiesce barrier (child of collect)
    "subtree",        # per-subtree first-dispatch → PartialReady latency
    "fold.mid",       # Σ measured mid-fold exec over absorbed partials
    "fold.top",       # measured root fold exec at the plan's root site
    "worker.task",    # shm worker: task pickup (ACK) → publish (PARTIAL)
    "worker.wait",    # shm worker: ring-pop wait inside the task (TELEM)
)

_SPAN_KIND_SET = frozenset(SPAN_KINDS)


def span_to_wire(span: Span) -> bytes:
    """Serialize a span for a process/network boundary (JSON) — the
    same seam as ``events.to_wire``."""
    if span.kind not in _SPAN_KIND_SET:
        raise TypeError(f"not a wire-registered span kind: {span.kind!r}")
    d = asdict(span)
    kind = d.pop("kind")
    return json.dumps({"span": kind, **d},
                      separators=(",", ":")).encode("utf-8")


def span_from_wire(raw) -> Span:
    """Inverse of :func:`span_to_wire`; accepts bytes or str."""
    if isinstance(raw, (bytes, bytearray)):
        raw = raw.decode("utf-8")
    d = json.loads(raw)
    kind = d.pop("span", None)
    if kind not in _SPAN_KIND_SET:
        raise ValueError(f"unknown span kind on the wire: {kind!r}")
    return Span(kind=kind, **d)


class Tracer:
    """Edge-driven span recorder.  ``begin``/``end`` cost one clock read
    each; a disabled tracer costs one attribute load per hook and emits
    nothing, which is what ``bench_obs`` holds the enabled path against.
    """

    __slots__ = ("enabled", "_clock", "_lock", "_spans", "_open", "_next")

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._open: Dict[int, tuple] = {}
        self._next = 0

    def begin(self, kind: str, owner: str = "", node: str = "",
              round_id: Optional[int] = None, parent: int = -1,
              worker: int = -1) -> int:
        """Open a span; returns a token for :meth:`end` (-1 when
        disabled — ``end(-1)`` is a no-op, so callers never branch)."""
        if not self.enabled:
            return -1
        t0 = self._clock()
        with self._lock:
            tok = self._next
            self._next += 1
            self._open[tok] = (kind, owner, node, round_id, parent, worker, t0)
        return tok

    def end(self, token: int, n: float = 0.0) -> Optional[Span]:
        if token < 0 or not self.enabled:
            return None
        t1 = self._clock()
        with self._lock:
            opened = self._open.pop(token, None)
            if opened is None:
                return None
            kind, owner, node, round_id, parent, worker, t0 = opened
            span = Span(kind=kind, owner=owner, node=node,
                        round_id=round_id, t0=t0, dur_s=t1 - t0,
                        id=token, parent=parent, worker=worker, n=n)
            self._spans.append(span)
        return span

    def point(self, kind: str, dur_s: float, owner: str = "",
              node: str = "", round_id: Optional[int] = None,
              parent: int = -1, worker: int = -1, n: float = 0.0,
              t0: float = 0.0) -> Optional[Span]:
        """Record an already-measured interval (aggregates, spans
        reconstructed from ring records / remote clocks)."""
        if not self.enabled:
            return None
        with self._lock:
            tok = self._next
            self._next += 1
            span = Span(kind=kind, owner=owner, node=node,
                        round_id=round_id, t0=t0, dur_s=dur_s,
                        id=tok, parent=parent, worker=worker, n=n)
            self._spans.append(span)
        return span

    @contextmanager
    def span(self, kind: str, **kw) -> Iterator[int]:
        tok = self.begin(kind, **kw)
        try:
            yield tok
        finally:
            self.end(tok)

    def add(self, span: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._spans.append(span)

    def drain(self) -> List[Span]:
        """Take every finished span (the agent's map retrieval)."""
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def reset(self) -> None:
        """Drop any still-open spans — exception paths can abandon
        begins; the driver resets between rounds so they can't pile up."""
        with self._lock:
            self._open.clear()


#: a process-wide disabled tracer, handed to components whose caller
#: did not ask for tracing — keeps every hook unconditional.
NULL_TRACER = Tracer(enabled=False)


@dataclass
class RoundTrace:
    """Everything the subsystem learned about one round, merged: driver
    + worker spans, and the per-daemon ``MetricsMap`` series drained
    over the wire (``{node: {"owner/metric": [sum, count]}}``)."""

    round_id: int = 0
    wall_s: float = 0.0
    spans: List[Span] = field(default_factory=list)
    telemetry: Dict[str, Dict[str, List[float]]] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    # -- queries -----------------------------------------------------
    def sum_kind(self, kind: str) -> float:
        return sum(s.dur_s for s in self.spans if s.kind == kind)

    def spans_of(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]

    def telemetry_series(self, series: str) -> Tuple[float, int]:
        """Sum one ``owner/metric`` series across every drained node."""
        tot, cnt = 0.0, 0
        for per_node in self.telemetry.values():
            v = per_node.get(series)
            if v:
                tot += float(v[0])
                cnt += int(v[1])
        return tot, cnt

    # -- accounting --------------------------------------------------
    def breakdown(self) -> Dict[str, float]:
        """Attribute round wall time to the paper's tiers.

        The driver loop is single-threaded, so its phase spans (spawn /
        dispatch / collect / fold) are disjoint intervals of the wall
        clock; ``client_train`` and ``deliver`` are measured sub-sums of
        the dispatch phase.  Tiers are a re-binning of that partition:

          client_train  time spent pulling the updates generator
                        (iteration *is* local training)
          mid_folds     measured mid-tier fold exec, clamped to the
                        deliver+collect window it can occupy (shmproc
                        folds run in parallel workers and may overlap)
          wire          what remains of deliver+collect after mid-fold
                        exec: serialize, ring/socket, ship, waiting
          top_fold      measured root fold exec within the fold phase
          control       spawn + loop glue + fold orchestration overhead
          unaccounted   wall − Σ(phases): inter-phase bookkeeping

        The six tiers sum to ``wall_s`` by construction; ``coverage``
        is the attributed fraction (acceptance: ≥ 0.95).
        """
        wall = self.wall_s or self.sum_kind("round")
        spawn = self.sum_kind("spawn")
        dispatch = self.sum_kind("dispatch")
        collect = self.sum_kind("collect")
        fold = self.sum_kind("fold")

        train = min(self.sum_kind("client_train"), dispatch)
        deliver = min(self.sum_kind("deliver"), dispatch - train)
        dispatch_other = max(0.0, dispatch - train - deliver)

        mid = min(self.sum_kind("fold.mid"), deliver + collect)
        wire = max(0.0, deliver + collect - mid)
        top = min(self.sum_kind("fold.top"), fold)
        control = spawn + dispatch_other + max(0.0, fold - top)
        unaccounted = max(0.0, wall - (spawn + dispatch + collect + fold))
        coverage = 1.0 - (unaccounted / wall) if wall > 0 else 0.0
        return {
            "wall_s": wall,
            "client_train_s": train,
            "wire_s": wire,
            "mid_fold_s": mid,
            "top_fold_s": top,
            "control_s": control,
            "unaccounted_s": unaccounted,
            "coverage": coverage,
        }

    def summary(self) -> str:
        """One human line per tier — what examples print."""
        b = self.breakdown()
        wall = b["wall_s"] or 1.0
        parts = []
        for key, label in (("client_train_s", "train"), ("wire_s", "wire"),
                           ("mid_fold_s", "mid-fold"), ("top_fold_s", "top-fold"),
                           ("control_s", "control"), ("unaccounted_s", "other")):
            parts.append(f"{label} {b[key] * 1e3:7.2f}ms ({b[key] / wall:5.1%})")
        return (f"round {self.round_id}: wall {b['wall_s'] * 1e3:.2f}ms | "
                + " | ".join(parts))

    # -- wire --------------------------------------------------------
    def to_wire(self) -> Dict[str, Any]:
        spans = []
        for s in self.spans:
            d = asdict(s)
            kind = d.pop("kind")
            spans.append({"span": kind, **d})
        return {
            "round_id": self.round_id,
            "wall_s": self.wall_s,
            "spans": spans,
            "telemetry": self.telemetry,
            "meta": self.meta,
        }

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "RoundTrace":
        spans = []
        for sd in d.get("spans", ()):
            sd = dict(sd)
            kind = sd.pop("span", "")
            spans.append(Span(kind=kind, **sd))
        return cls(round_id=int(d["round_id"]),
                   wall_s=float(d.get("wall_s", 0.0)),
                   spans=spans,
                   telemetry={str(n): {str(k): [float(v[0]), int(v[1])]
                                       for k, v in per.items()}
                              for n, per in d.get("telemetry", {}).items()},
                   meta=dict(d.get("meta", {})))

    def to_json_line(self) -> str:
        return json.dumps(self.to_wire(), separators=(",", ":"))


def write_trace(path: str, trace: RoundTrace) -> None:
    """Append one round's trace as a JSONL record (flushed per line, so
    a killed process loses at most the line it was writing)."""
    with io.open(path, "a", encoding="utf-8") as f:
        f.write(trace.to_json_line())
        f.write("\n")
        f.flush()


def read_traces(path: str) -> List[RoundTrace]:
    """Tolerant JSONL reader for post-mortems of chaos/fault runs: a
    truncated tail line (daemon/driver killed mid-write) or a corrupt
    record is skipped, everything parseable is returned in file order."""
    out: List[RoundTrace] = []
    try:
        f = io.open(path, "r", encoding="utf-8", errors="replace")
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue          # truncated by a kill mid-write
            try:
                out.append(RoundTrace.from_wire(d))
            except (KeyError, TypeError, ValueError):
                continue          # schema drift / corrupt record
    return out
