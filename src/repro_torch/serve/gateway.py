"""Ingress gateway: admission control in front of ``submit_update``.

LIFL's serving story (§3, §6) assumes clients push updates whenever
their local training finishes — the platform, not the caller, decides
what happens when they arrive faster than the fleet can fold.  This
module is that valve: a bounded ingress budget (global and per job)
in front of every trainer's external-update queue.  An over-budget
submission is **never silently dropped** — the pusher gets a ``busy``
verdict carrying ``retry_after_s`` (which
:func:`~repro_torch.runtime.netrt.push_update` feeds straight into its
:class:`~repro_torch.runtime.netrt.transport.Backoff`), an
:class:`~repro_torch.runtime.events.UpdateShed` event rides the driver bus,
and the counters here surface through ``Session.metrics()["ingress"]``.

The pressure signal is queue depth *and* measured ingest latency: the
gateway keeps a streaming histogram of its own admit wall time and
lifts the retry hint with the measured p99, so a slow fold path pushes
clients out even while the queue still looks shallow (Just-in-Time
Aggregation's point: measured ingest telemetry, not queue-depth
proxies, should drive the valve).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from repro_torch.obs.live import Histogram
from repro_torch.runtime.events import UpdateShed


@dataclass
class AdmissionPolicy:
    """How much ingress the service absorbs before pushing back.

    ``max_queue`` bounds the sum of all jobs' pending externals;
    ``job_quota`` bounds one job's (default: the global budget — a
    single job may use all of it when alone).  ``retry_base_s`` /
    ``retry_cap_s`` shape the busy reply's ``retry_after_s`` hint;
    ``ingest_gain`` scales how strongly the *measured* ingest p99
    lifts that hint (0 restores pure queue-depth pricing)."""

    max_queue: int = 256
    job_quota: Optional[int] = None
    retry_base_s: float = 0.05
    retry_cap_s: float = 2.0
    ingest_gain: float = 4.0

    def quota_for(self) -> int:
        return self.job_quota if self.job_quota is not None \
            else self.max_queue

    def retry_after(self, depth: int, quota: int,
                    ingest_p99_s: float = 0.0) -> float:
        """The busy reply's hint: base lifted by the measured ingest
        p99 (a slow fold path = longer hint at the same depth), scaled
        up with the overshoot pressure, capped."""
        over = max(0, depth - quota + 1) / max(1, quota)
        base = self.retry_base_s + self.ingest_gain * max(0.0, ingest_p99_s)
        return min(self.retry_cap_s, base * (1.0 + 4.0 * over))


class IngressGateway:
    """The admission valve shared by every ingest path of a service.

    Jobs register a ``(submit_fn, depth_fn)`` pair — the trainer's
    idempotent ``submit_update`` and its pending-queue depth.  Every
    submission (local ``Session.submit_update`` or a ``submit_update``
    wire frame) goes through :meth:`admit`, which either forwards to
    the trainer or sheds with a retry hint.  Thread-safe: the serve
    loop, local callers, and multiple pusher threads contend here."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None,
                 emit: Optional[Callable[[Any], Any]] = None,
                 metrics: Any = None):
        self.policy = policy or AdmissionPolicy()
        self._emit = emit          # driver.dispatch for UpdateShed
        self._metrics = metrics    # service MetricsMap (optional)
        self._jobs: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "admitted": 0, "shed": 0, "duplicates": 0}
        # per-job verdict counters — what per-job shed fractions (the
        # SLO tracker's second axis) are computed from
        self.job_counters: Dict[str, Dict[str, int]] = {}
        # measured admit wall time (enqueue-into-trainer included) —
        # the distribution the retry hint is priced from
        self.ingest_hist = Histogram()

    # ------------------------------------------------------------------
    def register(self, job: str, submit_fn: Callable[..., bool],
                 depth_fn: Callable[[], int]) -> None:
        self._jobs[job] = (submit_fn, depth_fn)
        self.job_counters.setdefault(
            job, {"admitted": 0, "shed": 0, "duplicates": 0})

    def depth(self, job: Optional[str] = None) -> int:
        """Pending externals for one job, or the global total."""
        if job is not None:
            entry = self._jobs.get(job)
            return entry[1]() if entry is not None else 0
        return sum(depth() for _sub, depth in self._jobs.values())

    def ingest_p99(self) -> float:
        """Measured p99 admit latency — what prices the retry hint."""
        with self._lock:
            return self.ingest_hist.p99

    def ingest_quantiles(self) -> Dict[str, float]:
        with self._lock:
            return self.ingest_hist.quantiles()

    def retry_after_now(self) -> float:
        """What a shed RIGHT NOW would quote: current depth + measured
        ingest p99 through the policy.  The health surface exposes it
        so an operator can see the hint rise with measured latency."""
        pol = self.policy
        return pol.retry_after(self.depth(), pol.quota_for(),
                               self.ingest_p99())

    # ------------------------------------------------------------------
    def admit(self, job: str, client_id: str, flat, weight: float = 1.0,
              *, submission_id: Optional[str] = None,
              round_id: Optional[int] = None) -> Dict[str, Any]:
        """Run one submission through admission control.

        Returns a verdict dict: ``{"admitted": bool, "busy": bool,
        "duplicate": bool, "queued": depth, "retry_after_s": hint}``.
        ``busy`` means over budget — come back after the hint; a
        ``ValueError`` from the trainer (wrong size, stale round)
        propagates: refusals are permanent, not backpressure."""
        entry = self._jobs.get(job)
        if entry is None:
            raise KeyError(f"unknown job {job!r}")
        submit_fn, depth_fn = entry
        pol = self.policy
        t0 = time.perf_counter()
        with self._lock:
            d_job = depth_fn()
            d_all = self.depth()
            quota = pol.quota_for()
            if d_all >= pol.max_queue or d_job >= quota:
                retry = pol.retry_after(max(d_job, d_all), quota,
                                        self.ingest_hist.p99)
                self.counters["shed"] += 1
                self.job_counters[job]["shed"] += 1
                if self._emit is not None:
                    self._emit(UpdateShed(
                        job=job, client_id=client_id,
                        retry_after_s=retry, queued=d_job))
                return {"admitted": False, "busy": True,
                        "duplicate": False, "queued": d_job,
                        "retry_after_s": retry}
            ok = submit_fn(client_id, flat, weight,
                           submission_id=submission_id, round_id=round_id)
            depth = depth_fn()
            dt = time.perf_counter() - t0
            self.ingest_hist.observe(dt)
        if self._metrics is not None:
            self._metrics.observe("gateway", "ingest_s", dt)
        if ok:
            self.counters["admitted"] += 1
            self.job_counters[job]["admitted"] += 1
        else:
            self.counters["duplicates"] += 1
            self.job_counters[job]["duplicates"] += 1
        return {"admitted": ok, "busy": False, "duplicate": not ok,
                "queued": depth, "retry_after_s": 0.0}

    def shed_frac(self, job: Optional[str] = None) -> float:
        """Shed / (shed + admitted + duplicates) for one job, or
        globally — the SLO tracker's second axis."""
        c = (self.job_counters.get(job, {}) if job is not None
             else self.counters)
        tries = (c.get("admitted", 0) + c.get("shed", 0)
                 + c.get("duplicates", 0))
        return c.get("shed", 0) / tries if tries else 0.0
