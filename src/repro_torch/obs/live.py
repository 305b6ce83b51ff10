"""Live fleet telemetry: streaming histograms + the scraping agent.

The paper's LIFL agent (§4.3) *periodically* drains each node's
in-kernel metric maps toward a metrics server that drives scaling and
admission decisions.  PR 7 gave the repro the round-edge half of that
loop (quiesce piggyback + on-demand ``telemetry`` pull); this module
adds the live half:

  * :class:`Histogram` — a log-bucketed streaming histogram with a
    bounded relative error and a *fixed* bucket count (the in-kernel
    map analogue: constant memory however many samples land).  It is
    mergeable (daemon → controller absorb), JSON-wire-serializable on
    the same seam as spans/events, and answers p50/p90/p99 with
    relative error ≤ ``rel_err`` for any value in its tracked range.
  * :class:`SLOTracker` — per-job targets (p99 TTA, max shed fraction)
    fed by scrapes; a *sustained* violation emits one typed
    :class:`~repro_torch.runtime.events.SLOBreached` on the driver bus.
  * :class:`FleetMonitor` — the agent: a thread that scrapes every
    daemon's ``stats`` frame on a jittered period *mid-round* (its own
    monitor connections — never the driver's), detects stale daemons
    faster than round-edge EOF detection, and feeds the SLO tracker.

Everything here is host-side bookkeeping: the histograms record only
at existing event edges (gateway admit, trace seal, TELEM records,
ping), so the idle-cost contract of ``obs/`` holds.
"""
from __future__ import annotations

import math
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "FleetMonitor",
    "Histogram",
    "SLOTarget",
    "SLOTracker",
]


class Histogram:
    """Log-bucketed streaming histogram (DDSketch-flavoured).

    Bucket ``i`` covers ``(γ^(lo+i-1), γ^(lo+i)]`` with
    ``γ = (1+rel_err)/(1-rel_err)``; a quantile answers the bucket's
    geometric representative ``2·γ^g/(γ+1)``, which is within
    ``rel_err`` of any value in the bucket.  The bucket count is fixed
    at construction — values outside ``[min_value, min_value·γ^n)``
    clamp into the edge buckets (the error bound holds only inside the
    tracked range), and values ≤ 0 or below ``min_value`` land in a
    dedicated zero bucket.  Defaults track 10 ns … ~10 h, which covers
    every latency this platform measures.
    """

    __slots__ = ("rel_err", "min_value", "n_buckets", "_gamma",
                 "_log_gamma", "_lo", "zero", "sum", "_buckets")

    WIRE_KEYS = ("rel_err", "min_value", "n_buckets", "zero", "sum",
                 "buckets")

    def __init__(self, rel_err: float = 0.05, min_value: float = 1e-8,
                 n_buckets: int = 288):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1): {rel_err}")
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0: {min_value}")
        self.rel_err = float(rel_err)
        self.min_value = float(min_value)
        self.n_buckets = int(n_buckets)
        self._gamma = (1.0 + self.rel_err) / (1.0 - self.rel_err)
        self._log_gamma = math.log(self._gamma)
        self._lo = math.ceil(math.log(self.min_value) / self._log_gamma)
        self.zero = 0              # samples ≤ min_value (incl. 0, <0)
        self.sum = 0.0             # exact running sum (for the mean)
        self._buckets: Dict[int, int] = {}   # sparse; index ∈ [0, n)

    # -- recording ---------------------------------------------------
    def observe(self, value: float, count: int = 1) -> None:
        v = float(value)
        self.sum += v * count
        if not v > self.min_value or v != v:       # ≤ min, or NaN
            self.zero += count
            return
        i = math.ceil(math.log(v) / self._log_gamma) - self._lo
        i = 0 if i < 0 else (self.n_buckets - 1
                             if i >= self.n_buckets else i)
        self._buckets[i] = self._buckets.get(i, 0) + count

    @property
    def count(self) -> int:
        return self.zero + sum(self._buckets.values())

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum / n if n else 0.0

    # -- queries -----------------------------------------------------
    def _value_of(self, bucket: int) -> float:
        g = self._lo + bucket
        return 2.0 * (self._gamma ** g) / (self._gamma + 1.0)

    def quantile(self, q: float, default: float = 0.0) -> float:
        """The q-quantile estimate (q ∈ [0, 1]); ``default`` when the
        histogram is empty.  Relative error ≤ ``rel_err`` for values
        inside the tracked range."""
        n = self.count
        if n == 0:
            return default
        rank = q * (n - 1)
        cum = self.zero
        if cum > rank:
            return 0.0
        for i in sorted(self._buckets):
            cum += self._buckets[i]
            if cum > rank:
                return self._value_of(i)
        return self._value_of(max(self._buckets))   # q == 1 edge

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p90(self) -> float:
        return self.quantile(0.90)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def quantiles(self) -> Dict[str, float]:
        """The standard export tuple plus count/mean — what health
        snapshots and Prometheus rendering consume."""
        return {"p50": self.p50, "p90": self.p90, "p99": self.p99,
                "count": self.count, "mean": self.mean}

    # -- merge / drain -----------------------------------------------
    def _compatible(self, other: "Histogram") -> bool:
        return (self.rel_err == other.rel_err
                and self.min_value == other.min_value
                and self.n_buckets == other.n_buckets)

    def merge(self, other: "Histogram") -> "Histogram":
        """Absorb ``other`` in place (bucket-count addition — exact,
        associative, commutative).  Shapes must match."""
        if not self._compatible(other):
            raise ValueError("cannot merge histograms with different "
                             "rel_err/min_value/n_buckets")
        self.zero += other.zero
        self.sum += other.sum
        for i, c in other._buckets.items():
            self._buckets[i] = self._buckets.get(i, 0) + c
        return self

    def copy(self) -> "Histogram":
        h = Histogram(self.rel_err, self.min_value, self.n_buckets)
        h.zero = self.zero
        h.sum = self.sum
        h._buckets = dict(self._buckets)
        return h

    def drain(self) -> "Histogram":
        """Return-and-reset (the agent's destructive map retrieval —
        the histogram analogue of ``MetricsMap.drain``)."""
        out = self.copy()
        self.zero = 0
        self.sum = 0.0
        self._buckets.clear()
        return out

    # -- wire --------------------------------------------------------
    def to_wire(self) -> Dict[str, Any]:
        """JSON-safe codec on the spans/events seam: plain dict, string
        bucket keys, round-trips through :meth:`from_wire`."""
        return {
            "rel_err": self.rel_err,
            "min_value": self.min_value,
            "n_buckets": self.n_buckets,
            "zero": self.zero,
            "sum": self.sum,
            "buckets": {str(i): int(c)
                        for i, c in sorted(self._buckets.items())},
        }

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "Histogram":
        h = cls(rel_err=float(d["rel_err"]),
                min_value=float(d["min_value"]),
                n_buckets=int(d["n_buckets"]))
        h.zero = int(d.get("zero", 0))
        h.sum = float(d.get("sum", 0.0))
        for k, c in dict(d.get("buckets", {})).items():
            h._buckets[int(k)] = int(c)
        return h


# ---------------------------------------------------------------------------
# per-job SLO tracking
# ---------------------------------------------------------------------------


@dataclass
class SLOTarget:
    """One job's service-level objective: the p99 time-to-aggregate it
    promises its pushers, and how much admission shedding it tolerates
    before the platform should act (scale, re-weight, alert)."""

    p99_tta_s: float = float("inf")
    max_shed_frac: float = 1.0

    @classmethod
    def coerce(cls, spec: Any) -> "SLOTarget":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(f"not an SLO spec: {spec!r}")


class SLOTracker:
    """Scrape-fed per-job SLO evaluation with hysteresis.

    Each :meth:`observe` compares one scrape's measured p99 TTA and
    shed fraction against the job's target.  ``breach_after``
    *consecutive* violating scrapes emit one typed ``SLOBreached``
    event through ``emit`` (the driver bus); the breach re-arms after
    a clean scrape, so a persistent straggler fires once per sustained
    episode, not once per scrape."""

    def __init__(self, *, breach_after: int = 3,
                 emit: Optional[Callable[[Any], Any]] = None):
        self.breach_after = int(breach_after)
        self._emit = emit
        self._lock = threading.Lock()
        self._targets: Dict[str, SLOTarget] = {}
        self._state: Dict[str, Dict[str, Any]] = {}
        self.breaches = 0

    def set_target(self, job: str, target: Any) -> None:
        with self._lock:
            self._targets[job] = SLOTarget.coerce(target)
            self._state.setdefault(job, {
                "violations": 0, "breached": False,
                "p99_tta_s": 0.0, "shed_frac": 0.0, "scrapes": 0})

    def target(self, job: str) -> Optional[SLOTarget]:
        return self._targets.get(job)

    def observe(self, job: str, *, p99_tta_s: float,
                shed_frac: float) -> Optional[Any]:
        """Feed one scrape; returns the emitted ``SLOBreached`` when
        this scrape crossed the sustained-violation threshold."""
        with self._lock:
            tgt = self._targets.get(job)
            st = self._state.setdefault(job, {
                "violations": 0, "breached": False,
                "p99_tta_s": 0.0, "shed_frac": 0.0, "scrapes": 0})
            st["scrapes"] += 1
            st["p99_tta_s"] = float(p99_tta_s)
            st["shed_frac"] = float(shed_frac)
            if tgt is None:
                return None
            over_tta = p99_tta_s > tgt.p99_tta_s
            over_shed = shed_frac > tgt.max_shed_frac
            if not (over_tta or over_shed):
                st["violations"] = 0
                st["breached"] = False
                return None
            st["violations"] += 1
            if st["violations"] < self.breach_after or st["breached"]:
                return None
            st["breached"] = True
            self.breaches += 1
            metric, measured, target = (
                ("p99_tta_s", float(p99_tta_s), tgt.p99_tta_s)
                if over_tta else
                ("shed_frac", float(shed_frac), tgt.max_shed_frac))
            window = st["violations"]
        from repro_torch.runtime.events import SLOBreached

        ev = SLOBreached(job=job, metric=metric, measured=measured,
                         target=target, window=window)
        if self._emit is not None:
            try:
                self._emit(ev)
            except Exception:
                pass
        return ev

    def status(self, job: Optional[str] = None) -> Dict[str, Any]:
        """Per-job view: target (if any) + the last scrape's numbers."""
        with self._lock:
            jobs = [job] if job is not None else sorted(
                set(self._targets) | set(self._state))
            out: Dict[str, Any] = {}
            for j in jobs:
                tgt = self._targets.get(j)
                st = self._state.get(j, {
                    "violations": 0, "breached": False,
                    "p99_tta_s": 0.0, "shed_frac": 0.0, "scrapes": 0})
                out[j] = {
                    "target": ({"p99_tta_s": tgt.p99_tta_s,
                                "max_shed_frac": tgt.max_shed_frac}
                               if tgt is not None else None),
                    **st,
                }
        return out[job] if job is not None else out


# ---------------------------------------------------------------------------
# the scraping agent
# ---------------------------------------------------------------------------

#: driver phases that mean "a round is in flight between SPAWN and FOLD"
_MID_ROUND_PHASES = frozenset(("spawn", "dispatch", "collect", "fold"))


class FleetMonitor(threading.Thread):
    """The paper's per-node agent, controller-side: scrape every netd's
    ``stats`` frame on a jittered period — *while rounds run* — plus
    the service's own gateway/driver surfaces, and feed the SLO
    tracker.

    The monitor owns its connections (``role="monitor"`` hello): the
    driver thread's controller conns are never touched, so a scrape
    can land mid-``recv_expect`` without corrupting a round.  A daemon
    that stops answering (SIGKILL, hang) shows ``stale=True`` on the
    very next scrape — typically well before the driver's round-edge
    EOF detection notices.
    """

    def __init__(self, service: Any, *, period_s: float = 0.5,
                 jitter_frac: float = 0.3, scrape_timeout: float = 1.0,
                 seed: int = 0, log_cap: int = 256):
        super().__init__(name="fleet-monitor", daemon=True)
        self.service = service
        self.period_s = float(period_s)
        self.jitter_frac = float(jitter_frac)
        self.scrape_timeout = float(scrape_timeout)
        self._rng = random.Random(seed)
        self._stopev = threading.Event()
        self._lock = threading.Lock()
        self._conns: Dict[str, Any] = {}     # monitor-owned, per node
        #: node → last scrape result (stale flag, health, epoch, age)
        self.fleet: Dict[str, Dict[str, Any]] = {}
        self.scrapes = 0
        self.mid_round_scrapes = 0
        self.stale_events = 0
        self.scrape_wall_s = 0.0             # Σ time inside scrape_once
        self.log: Deque[Dict[str, Any]] = deque(maxlen=log_cap)

    # -- lifecycle ---------------------------------------------------
    def stop(self, timeout: float = 5.0) -> None:
        self._stopev.set()
        if self.is_alive():
            self.join(timeout=timeout)
        for conn in self._conns.values():
            try:
                conn.close()
            except Exception:
                pass
        self._conns.clear()

    def run(self) -> None:
        while not self._stopev.is_set():
            t0 = time.perf_counter()
            try:
                self.scrape_once()
            except Exception:
                pass                 # the agent must outlive bad scrapes
            self.scrape_wall_s += time.perf_counter() - t0
            # jittered period: a fleet of monitors must not thundering-
            # herd their daemons on synchronized ticks
            delay = self.period_s * (
                1.0 + self.jitter_frac * (2.0 * self._rng.random() - 1.0))
            self._stopev.wait(max(0.01, delay))

    # -- node targets ------------------------------------------------
    def _node_addrs(self) -> Dict[str, str]:
        rt = getattr(self.service, "runtime", None)
        nodes = getattr(rt, "_nodes", None)
        if not isinstance(nodes, dict):
            return {}
        out = {}
        for name, node in nodes.items():
            addr = getattr(node, "addr", None)
            if addr:
                out[name] = addr
        return out

    def _monitor_conn(self, name: str, addr: str):
        conn = self._conns.get(name)
        if conn is not None and getattr(conn, "alive", False):
            return conn
        from repro_torch.runtime.netrt.transport import connect

        conn = connect(addr, timeout=self.scrape_timeout)
        conn.send("hello", {"role": "monitor", "proto": 1})
        conn.recv_expect(("welcome",), self.scrape_timeout)
        self._conns[name] = conn
        return conn

    def _scrape_node(self, name: str, addr: str) -> Dict[str, Any]:
        from repro_torch.runtime.netrt.transport import PeerDead

        now = time.perf_counter()
        prev = self.fleet.get(name, {})
        try:
            conn = self._monitor_conn(name, addr)
            t0 = time.perf_counter()
            conn.send("stats", {})
            reply = conn.recv_expect(("stats_reply",),
                                     self.scrape_timeout)
            rtt = time.perf_counter() - t0
        except (PeerDead, OSError) as e:
            self._conns.pop(name, None)
            if not prev.get("stale", False):
                self.stale_events += 1
            return {"stale": True, "error": f"{type(e).__name__}: {e}",
                    "last_ok_age_s": (now - prev["t_scrape"]
                                      if "t_scrape" in prev else -1.0),
                    "t_scrape": prev.get("t_scrape", now),
                    "epoch": prev.get("epoch", 0),
                    "health": prev.get("health", {})}
        m = reply.meta
        self.service.metrics.observe("wire", "stats_rtt_s", rtt)
        return {"stale": False, "t_scrape": now, "rtt_s": rtt,
                "epoch": int(m.get("epoch", 0)),
                "uptime_s": float(m.get("uptime_s", 0.0)),
                "health": dict(m.get("health", {})),
                "series": dict(m.get("series", {})),
                "hists": dict(m.get("hists", {}))}

    # -- one scrape --------------------------------------------------
    def scrape_once(self) -> Dict[str, Any]:
        """One agent tick: daemons, driver phases, gateway, SLOs."""
        svc = self.service
        # is a round between SPAWN and FOLD right now? (the live-drain
        # point the round-edge path can never see)
        drv = getattr(svc, "driver", None)
        phases = []
        if drv is not None:
            phases = [st.phase for st in
                      list(getattr(drv, "_inflight", {}).values())]
        mid_round = any(p in _MID_ROUND_PHASES for p in phases)

        fleet: Dict[str, Dict[str, Any]] = {}
        for name, addr in self._node_addrs().items():
            fleet[name] = self._scrape_node(name, addr)

        gw = getattr(svc, "gateway", None)
        shed_fracs = {}
        slo_fired = []
        trainers = getattr(svc, "_trainers", {})
        slo = getattr(svc, "slo", None)
        for job in list(trainers):
            p99 = svc.metrics.quantile("tta", job, 0.99)
            frac = gw.shed_frac(job) if gw is not None else 0.0
            shed_fracs[job] = frac
            if slo is not None:
                ev = slo.observe(job, p99_tta_s=p99, shed_frac=frac)
                if ev is not None:
                    slo_fired.append(ev)

        with self._lock:
            self.fleet = fleet
            self.scrapes += 1
            if mid_round:
                self.mid_round_scrapes += 1
            rec = {"t": time.perf_counter(), "mid_round": mid_round,
                   "phases": phases,
                   "stale": sorted(n for n, f in fleet.items()
                                   if f.get("stale")),
                   "shed_fracs": shed_fracs,
                   "slo_fired": [type(e).__name__ for e in slo_fired]}
            self.log.append(rec)
        return rec

    # -- views -------------------------------------------------------
    def fleet_view(self) -> Dict[str, Dict[str, Any]]:
        """Snapshot of the last scrape's per-node state (stale flags,
        health gauges, epochs) — what ``service.health()`` embeds."""
        with self._lock:
            return {n: dict(f) for n, f in self.fleet.items()}

    def counters(self) -> Dict[str, Any]:
        with self._lock:
            return {"scrapes": self.scrapes,
                    "mid_round_scrapes": self.mid_round_scrapes,
                    "stale_events": self.stale_events,
                    "scrape_wall_s": self.scrape_wall_s,
                    "period_s": self.period_s}
