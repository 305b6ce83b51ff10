"""Event-driven metrics sidecar (paper §4.3) — the eBPF analogue.

The paper attaches eBPF programs to each aggregator's socket SKMSG hook:
metrics collection runs *only* when a send() event fires and costs
nothing when idle.  The host-side analogue here is a hook table invoked
on aggregation events (no resident thread, no polling); metrics land in
an in-memory ``MetricsMap`` (the eBPF map analogue) that the LIFL agent
drains periodically toward the metrics server.

The in-graph counterpart (update norms fused into the compiled step) is
in fl/round.py::_metrics — together they mirror the two halves of C4.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class MetricsMap:
    """In-kernel key-value table analogue (BPF_MAP_TYPE_HASH).

    Two value kinds live side by side under one lock: (sum, count)
    series (``update``/``drain``) and log-bucketed distribution
    histograms (``observe``/``drain_hists``) — the latter answer
    p50/p90/p99 with bounded relative error at constant memory, which
    a (sum, count) pair cannot (see :class:`repro_torch.obs.live.Histogram`).
    """

    def __init__(self):
        self._m: Dict[Tuple[str, str], float] = defaultdict(float)
        self._count: Dict[Tuple[str, str], int] = defaultdict(int)
        self._hists: Dict[Tuple[str, str], "object"] = {}
        self._lock = threading.Lock()

    def update(self, owner: str, metric: str, value: float) -> None:
        with self._lock:
            self._m[(owner, metric)] += value
            self._count[(owner, metric)] += 1

    # -- histograms ---------------------------------------------------
    def observe(self, owner: str, metric: str, value: float) -> None:
        """Record one sample into the (owner, metric) distribution
        histogram, creating it on first observation."""
        from repro_torch.obs.live import Histogram

        with self._lock:
            h = self._hists.get((owner, metric))
            if h is None:
                h = self._hists[(owner, metric)] = Histogram()
            h.observe(value)

    def quantile(self, owner: str, metric: str, q: float,
                 default: float = 0.0) -> float:
        with self._lock:
            h = self._hists.get((owner, metric))
            return h.quantile(q, default) if h is not None else default

    def hist(self, owner: str, metric: str):
        """A copy of the (owner, metric) histogram, or None."""
        with self._lock:
            h = self._hists.get((owner, metric))
            return h.copy() if h is not None else None

    def hists_snapshot(self) -> Dict[str, dict]:
        """Non-destructive wire view ``{"owner/metric": hist_wire}`` —
        what the live ``stats`` frame carries (a scrape must not erase
        what the round-edge drain will collect)."""
        with self._lock:
            return {f"{o}/{m}": h.to_wire()
                    for (o, m), h in self._hists.items() if h.count}

    def drain_hists(self) -> Dict[str, dict]:
        """Destructive retrieval in the same wire shape — the histogram
        analogue of :meth:`drain_series` (round-edge telemetry)."""
        with self._lock:
            out = {f"{o}/{m}": h.to_wire()
                   for (o, m), h in self._hists.items() if h.count}
            self._hists.clear()
        return out

    def absorb_hists(self, hists: Dict[str, dict],
                     prefix: str = "") -> None:
        """Merge a wire-shaped histogram map (a drained remote map),
        optionally namespacing owners with ``prefix`` — mirror of
        :meth:`absorb_series`."""
        from repro_torch.obs.live import Histogram

        for key, wire in hists.items():
            owner, _, metric = key.partition("/")
            incoming = Histogram.from_wire(wire)
            with self._lock:
                k = (prefix + owner, metric)
                h = self._hists.get(k)
                if h is None:
                    self._hists[k] = incoming
                else:
                    h.merge(incoming)

    def drain(self) -> Dict[Tuple[str, str], Tuple[float, int]]:
        """Agent-side periodic retrieval; resets the map."""
        with self._lock:
            out = {k: (self._m[k], self._count[k]) for k in self._m}
            self._m.clear()
            self._count.clear()
        return out

    def peek(self, owner: str, metric: str) -> Tuple[float, int]:
        with self._lock:
            k = (owner, metric)
            return self._m.get(k, 0.0), self._count.get(k, 0)

    def snapshot(self) -> Dict[Tuple[str, str], Tuple[float, int]]:
        """Non-destructive view of every (owner, metric) series —
        what ``Session.metrics()`` surfaces."""
        with self._lock:
            return {k: (self._m[k], self._count[k]) for k in self._m}

    def absorb(self, owner: str, metric: str, total: float,
               count: int) -> None:
        """Merge an already-aggregated series (a drained remote map)
        without inflating the sample count the way per-call ``update``
        would."""
        with self._lock:
            self._m[(owner, metric)] += total
            self._count[(owner, metric)] += count

    def absorb_series(self, series: Dict[str, list],
                      prefix: str = "") -> None:
        """Merge a wire-flattened map (``{"owner/metric": [sum, count]}``,
        see :func:`series_flatten`), optionally namespacing every owner
        with ``prefix`` — how the controller files each daemon's drain."""
        for key, sc in series.items():
            owner, _, metric = key.partition("/")
            self.absorb(prefix + owner, metric, float(sc[0]), int(sc[1]))

    def drain_series(self) -> Dict[str, list]:
        """:meth:`drain` (destructive — the agent's retrieval) in the
        JSON-safe wire shape the ``telemetry`` frame carries."""
        return series_flatten(self.drain())


def series_flatten(
    m: Dict[Tuple[str, str], Tuple[float, int]],
) -> Dict[str, list]:
    """``{(owner, metric): (sum, count)}`` → JSON-safe
    ``{"owner/metric": [sum, count]}`` (owners never contain '/')."""
    return {f"{o}/{met}": [float(v), int(c)] for (o, met), (v, c) in m.items()}


@dataclass
class EventSidecar:
    """Per-aggregator sidecar: a set of hooks fired on events.

    Strictly event-driven: zero activity (and zero cost) between events.
    ``on_send`` mirrors the SKMSG attachment point.
    """

    owner_id: str
    metrics: MetricsMap

    invocations: int = 0

    def on_send(self, nbytes: int) -> None:
        self.invocations += 1
        self.metrics.update(self.owner_id, "tx_bytes", float(nbytes))
        self.metrics.update(self.owner_id, "tx_msgs", 1.0)

    def on_recv(self, nbytes: int, queue_delay_s: float) -> None:
        self.invocations += 1
        self.metrics.update(self.owner_id, "rx_bytes", float(nbytes))
        self.metrics.update(self.owner_id, "queue_delay_s", queue_delay_s)

    def on_aggregate(self, n_updates: int, exec_time_s: float) -> None:
        """Execution time of the aggregation task — feeds E_{i,t} for the
        capacity model (§5.1) and hierarchy planner (§5.2)."""
        self.invocations += 1
        self.metrics.update(self.owner_id, "agg_updates", float(n_updates))
        self.metrics.update(self.owner_id, "agg_exec_s", exec_time_s)
        # distribution under a fixed owner: per-aggregator owners would
        # mint one histogram per ephemeral agg id
        self.metrics.observe("fold", "exec_s", exec_time_s)


class MetricsServer:
    """Cluster-wide sink (serverless control plane, Fig 3): receives the
    per-node agent's drained metrics; serves smoothed rates to the
    autoscaler/planner."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[Tuple[str, str], float] = defaultdict(float)
        self.counts: Dict[Tuple[str, str], int] = defaultdict(int)

    def push(self, drained: Dict[Tuple[str, str], Tuple[float, int]]) -> None:
        with self._lock:
            for k, (v, c) in drained.items():
                self.totals[k] += v
                self.counts[k] += c

    def rate(self, owner: str, metric: str) -> Tuple[float, int]:
        with self._lock:
            k = (owner, metric)
            return self.totals.get(k, 0.0), self.counts.get(k, 0)

    def mean(self, owner: str, metric: str, default: float = 0.0) -> float:
        tot, cnt = self.rate(owner, metric)
        return tot / cnt if cnt else default
