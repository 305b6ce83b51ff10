"""AggregationService: the continuous, multi-job aggregation plane.

One service owns what used to be per-``Session`` infrastructure — a
single aggregation runtime, a single :class:`RoundDriver` event loop
(``max_open_rounds=2``), and a single :class:`Coordinator` whose RC
capacity model is shared by every job — and runs the round lifecycle
itself instead of waiting for a caller::

    svc = AggregationService(nodes, runtime="inproc")
    svc.add_job("mnist",  model_a, params_a, clients_a, weight=2.0)
    svc.add_job("speech", model_b, params_b, clients_b, weight=1.0)
    addr = svc.serve("127.0.0.1:0")        # external pushers aim here
    svc.run_rounds({"mnist": 6, "speech": 6},
                   policy=MinCohortIdleGap(min_cohort=4))
    print(svc.pipeline_overlap())           # rolling-round gain

Three LIFL arguments meet here:

* **Admission control** (gateway.py): every ingest path goes through
  the bounded ingress valve; over-budget pushers get ``busy`` +
  ``retry_after_s``, never a silent drop.
* **Rolling rounds** (scheduler.py): round N+1's SPAWN/DISPATCH runs
  while round N's root fold completes — the overlap window is measured
  per round pair (``pipeline_overlap``).
* **Weighted fair-share**: each job's placement packs against
  ``share × MC`` per node (``NodeState.residual_for``), so concurrent
  jobs split the fleet by weight instead of first-planner-wins.

Determinism contract: a job's sequence of round deltas is bit-exact
with the same cohorts run sequentially through the library
``run_round`` path — the rolling/fair-share machinery reorders *time*,
never the fold (``tests/test_serve.py`` holds this).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.bf16 import as_f32
from repro_torch.core import Coordinator, MetricsMap, NodeState, Selector
from repro_torch.core.engine import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.obs.live import FleetMonitor, SLOTracker
from repro_torch.runtime.driver import COHORT_CLOSED, RoundDriver, make_runtime
from repro_torch.runtime.events import (
    NodeJoined, NodeLost, NodeRejoined, PartialReady, PartialShipped,
    TopFolded,
)
from repro_torch.runtime.trainer import ClientRuntime, FederatedTrainer
from repro_torch.serve.gateway import AdmissionPolicy, IngressGateway
from repro_torch.serve.scheduler import MinCohortIdleGap, RoundScheduler


class AggregationService:
    """Continuous aggregation over one shared fleet (see module doc)."""

    def __init__(self, nodes: Optional[Dict[str, NodeState]] = None, *,
                 runtime: Any = "inproc", agg_engine: str = "auto",
                 admission: Optional[AdmissionPolicy] = None,
                 max_open_rounds: int = 2, seed: int = 0,
                 device: Optional[str] = None):
        # the card unless the caller names another device: the shared
        # runtime's engines and every job's params and clients live
        # there; a host without one fails here, never on the CPU
        self.device = resolve_device(device)
        self.metrics = MetricsMap()
        self.nodes = nodes if nodes is not None else {
            f"node{i}": NodeState(node=f"node{i}", max_capacity=20.0)
            for i in range(2)
        }
        self.runtime = make_runtime(
            runtime, metrics=self.metrics,
            agg_engine=EngineConfig(name=agg_engine, device=str(self.device)))
        self.driver = RoundDriver(self.runtime, metrics=self.metrics,
                                  max_open_rounds=max_open_rounds,
                                  trace_sink=self._sink_trace)
        self.coordinator = Coordinator(Selector([], seed=seed), self.nodes)
        # the coordinator subscribes ONCE here — trainers never wire
        # their own handlers onto an injected driver (that would feed
        # every EWMA sample twice per extra job)
        for et in (NodeJoined, NodeLost, NodeRejoined, PartialReady,
                   TopFolded, PartialShipped):
            self.driver.on(et, self.coordinator.handle_event)
        self.gateway = IngressGateway(admission, emit=self.driver.dispatch,
                                      metrics=self.metrics)
        self.slo = SLOTracker(emit=self.driver.dispatch)
        self.monitor: Optional[FleetMonitor] = None
        self._trainers: Dict[str, FederatedTrainer] = {}
        self._ticket = 0               # globally-unique driver round ids
        #: every closed round, in close order: job, job-local round,
        #: the admitted cohort in dispatch order, and the outcome
        self.round_log: List[Dict[str, Any]] = []
        self._windows: List[Dict[str, float]] = []   # open/close stamps
        self._server = None
        self._serve_thread: Optional[threading.Thread] = None
        self._serve_stop: Optional[threading.Event] = None
        self._closed = False

    # ------------------------------------------------------------------
    # jobs
    # ------------------------------------------------------------------
    def add_job(self, job: str, model, params: Any,
                clients: Sequence[Any] = (), *, weight: float = 1.0,
                round_cfg: Optional[Any] = None, server_opt: str = "fedavg",
                server_lr: float = 1.0, seed: int = 0,
                slo: Optional[Any] = None) -> FederatedTrainer:
        """Register a job: its model/params, client roster (``
        ClientRuntime`` or bare ``ClientInfo`` — external pushers need
        only the latter), and fair-share weight.  Returns the job's
        trainer (the service owns its lifecycle).  ``slo`` (an
        :class:`~repro_torch.obs.live.SLOTarget` or kwargs dict) arms the
        SLO tracker for this job: sustained violation on live scrapes
        emits :class:`~repro_torch.runtime.events.SLOBreached`."""
        if job in self._trainers:
            raise ValueError(f"job {job!r} already registered")
        roster = [c if isinstance(c, ClientRuntime)
                  else ClientRuntime(info=c, dataset=None)
                  for c in clients]
        tr = FederatedTrainer(
            model, params, roster, nodes=self.nodes, round_cfg=round_cfg,
            server_opt=server_opt, server_lr=server_lr,
            runtime=self.runtime, seed=seed, job=job, job_weight=weight,
            coordinator=self.coordinator, driver=self.driver,
            device=self.device,
        )
        tr.metrics = self.metrics
        self._trainers[job] = tr
        self.gateway.register(job, tr.submit_update,
                              lambda t=tr: len(t._external))
        if slo is not None:
            self.slo.set_target(job, slo)
        return tr

    def trainer(self, job: str) -> FederatedTrainer:
        return self._trainers[job]

    @property
    def jobs(self) -> List[str]:
        return list(self._trainers)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def submit(self, job: str, client_id: str, update: np.ndarray,
               weight: float = 1.0, *,
               submission_id: Optional[str] = None,
               round_id: Optional[int] = None) -> Dict[str, Any]:
        """Submit one external update through admission control.
        Returns the gateway verdict (``busy`` + ``retry_after_s`` when
        over budget — the caller retries, nothing was dropped)."""
        flat = as_f32(update).reshape(-1)   # bf16 words widened exactly
        return self.gateway.admit(job, client_id, flat, weight,
                                  submission_id=submission_id,
                                  round_id=round_id)

    # ------------------------------------------------------------------
    # the rolling-round loop
    # ------------------------------------------------------------------
    def _sink_trace(self, trace) -> None:
        # one driver, many jobs: route each round's trace to its job's
        # trainer so Session-style per-job trace()/TTA keeps working
        tr = self._trainers.get(trace.meta.get("job", ""))
        if tr is not None:
            tr._sink_trace(trace)

    def _make_feed(self, tr: FederatedTrainer, plan, policy,
                   record: Dict[str, Any]) -> Callable[[], Any]:
        """The serve-mode cohort feed: admitted externals, node slots
        from the plan's placement, close-out by ``policy``."""
        slots = deque()
        for node in sorted(plan.placement.assignment):
            slots.extend([node] * len(plan.placement.assignment[node]))
        opened = time.perf_counter()
        state = {"last": opened, "n": 0}

        def feed():
            now = time.perf_counter()
            if slots and tr._external:
                cid, flat, w = tr._external.popleft()
                tr._popped_external.append((cid, flat, w))
                node = slots.popleft()
                state["last"] = now
                state["n"] += 1
                record["cohort"].append((node, cid, float(w)))
                return (node, cid, flat, w)
            if not slots or policy.should_close(
                    n=state["n"], opened_s=now - opened,
                    idle_s=now - state["last"]):
                return COHORT_CLOSED
            return None

        return feed

    def open_round(self, job: str, *,
                   policy: Optional[Any] = None) -> Any:
        """Open one rolling round for ``job``: plan via the shared
        coordinator (fair-share placement, job+round-tagged fold plan),
        driver round id from the global ticket counter, cohort from the
        job's admitted externals under ``policy``."""
        tr = self._trainers[job]
        policy = policy if policy is not None else MinCohortIdleGap(
            min_cohort=max(1, tr.round_cfg.aggregation_goal // 2))
        ticket = self._ticket
        self._ticket += 1
        record: Dict[str, Any] = {
            "ticket": ticket, "job": job, "cohort": [],
        }
        rnd = tr.open_round(
            feed_factory=lambda plan: self._make_feed(
                tr, plan, policy, record),
            driver_round_id=ticket, tag_rounds=True)
        record["round"] = rnd.plan.round_id
        record["assignment"] = {
            n: list(v) for n, v in rnd.plan.placement.assignment.items()}
        record["top_node"] = rnd.plan.top_node
        rnd.serve_record = record
        return rnd

    def run_rounds(self, per_job: Dict[str, int], *,
                   policy: Optional[Any] = None,
                   policies: Optional[Dict[str, Any]] = None
                   ) -> List[Dict[str, Any]]:
        """Drive ``per_job[job]`` rounds per job, rolling, interleaved
        round-robin across jobs on the shared driver.  Blocks until all
        rounds closed; returns their records (also appended to
        ``round_log``).  External pushers keep submitting concurrently
        — admission control and the close-out policy decide which round
        each update lands in."""
        remaining = {j: int(n) for j, n in per_job.items() if n > 0}
        order = [j for j in self._trainers if j in remaining]
        cursor = {"i": 0}

        def open_next():
            live = [j for j in order if remaining.get(j, 0) > 0]
            if not live:
                return None
            job = live[cursor["i"] % len(live)]
            cursor["i"] += 1
            remaining[job] -= 1
            pol = (policies or {}).get(job, policy)
            return self.open_round(job, policy=pol)

        t_stamp = time.perf_counter

        def on_open(rnd):
            rnd.serve_record["t_open"] = t_stamp()

        def on_close(rnd):
            rec = rnd.serve_record
            rec["t_close"] = t_stamp()
            out = rnd.handle.outcome
            rec["accepted"] = out.accepted
            rec["outcome"] = out
            self.round_log.append(rec)
            self._windows.append(
                {"ticket": rec["ticket"], "t_open": rec["t_open"],
                 "t_close": rec["t_close"]})

        sched = RoundScheduler(open_next,
                               max_open=self.driver.max_open_rounds,
                               on_open=on_open, on_close=on_close)
        closed = sched.run()
        return [r.serve_record for r in closed]

    def pipeline_overlap(self) -> float:
        """Measured rolling-round gain: Σ overlap between consecutive
        (by open order) round windows / Σ round walls.  0.0 under
        strictly sequential rounds; > 0 whenever round N+1 opened
        before round N closed."""
        if len(self._windows) < 2:
            return 0.0
        ws = sorted(self._windows, key=lambda w: w["t_open"])
        wall = sum(w["t_close"] - w["t_open"] for w in ws)
        if wall <= 0:
            return 0.0
        overlap = 0.0
        for a, b in zip(ws, ws[1:]):
            overlap += max(0.0, min(a["t_close"], b["t_close"])
                           - max(a["t_open"], b["t_open"]))
        return overlap / wall

    # ------------------------------------------------------------------
    # wire ingest (external pusher processes)
    # ------------------------------------------------------------------
    def serve(self, addr: str = "127.0.0.1:0") -> str:
        """Accept ``submit_update`` frames (see
        :func:`repro_torch.runtime.netrt.push_update`); the frame's ``job``
        meta routes it (default: the first registered job).  Over-
        budget submissions get a ``busy`` reply with ``retry_after_s``.
        Returns the bound address; idempotent while serving."""
        if self._server is not None:
            return self._server.addr
        from repro_torch.runtime.netrt.transport import FrameServer, PeerDead

        server = FrameServer(addr)
        stop = threading.Event()

        def loop() -> None:
            while not stop.is_set():
                for conn, frame in server.poll(0.1):
                    if frame is None:
                        continue
                    try:
                        self._serve_frame(conn, frame)
                    except PeerDead:
                        pass
                    except Exception as e:  # reject, don't die
                        try:
                            conn.send("error",
                                      {"msg": f"{type(e).__name__}: {e}"})
                        except PeerDead:
                            pass

        self._server = server
        self._serve_stop = stop
        self._serve_thread = threading.Thread(
            target=loop, name="aggsvc-serve", daemon=True)
        self._serve_thread.start()
        return server.addr

    def _serve_frame(self, conn, frame) -> None:
        from repro_torch.runtime.netrt.transport import resolve_dtype

        if frame.kind == "hello":
            conn.send("welcome", {"node": "aggsvc", "proto": 1,
                                  "capacity": 0.0, "runtime": "serve",
                                  "jobs": list(self._trainers)})
        elif frame.kind == "ping":
            conn.send("pong", {"t": frame.meta.get("t")})
        elif frame.kind == "submit_update":
            job = frame.meta.get("job") or next(iter(self._trainers))
            flat = np.frombuffer(
                frame.blob, dtype=resolve_dtype(frame.meta["dtype"]),
            ).reshape(frame.meta["shape"])
            verdict = self.submit(
                job, frame.meta["client_id"], flat,
                weight=frame.meta.get("weight", 1.0),
                submission_id=frame.meta.get("submission_id"),
                round_id=frame.meta.get("round_id"))
            if verdict["busy"]:
                conn.send("busy", {
                    "client_id": frame.meta["client_id"],
                    "retry_after_s": verdict["retry_after_s"],
                    "queued": verdict["queued"]})
            else:
                conn.send("ack", {
                    "client_id": frame.meta["client_id"],
                    "queued": verdict["queued"],
                    "duplicate": verdict["duplicate"]})
        else:
            conn.send("error", {"msg": f"unknown frame {frame.kind!r}"})

    @property
    def serve_addr(self) -> Optional[str]:
        return self._server.addr if self._server is not None else None

    # ------------------------------------------------------------------
    # live telemetry (the agent → metrics-server loop, paper §4.3)
    # ------------------------------------------------------------------
    def start_monitor(self, *, period_s: float = 0.5,
                      **kwargs: Any) -> FleetMonitor:
        """Start (or return) the :class:`FleetMonitor` scraping every
        daemon's ``stats`` frame on a jittered ``period_s`` — mid-round
        included — and feeding the per-job SLO tracker."""
        if self.monitor is None:
            self.monitor = FleetMonitor(self, period_s=period_s, **kwargs)
            self.monitor.start()
        return self.monitor

    def _fleet_nodes_alive(self) -> int:
        nodes = getattr(self.runtime, "_nodes", None)
        if isinstance(nodes, dict):
            return sum(1 for n in nodes.values()
                       if getattr(n, "alive", False))
        return 1   # a local runtime IS its one (alive) node

    def health(self) -> Dict[str, Any]:
        """One structured fleet snapshot: service gauges, per-job SLO
        state + TTA quantiles, gateway pressure, per-node health from
        the last live scrape.  ``Session.status()`` mirrors these
        top-level keys (key-parity is test-enforced) and
        ``repro_torch.obs.export`` renders them for Prometheus/humans."""
        jobs: Dict[str, Any] = {}
        for job, tr in self._trainers.items():
            h = self.metrics.hist("tta", job)
            jobs[job] = {
                "queue_depth": len(tr._external),
                "rounds": len(tr.log),
                "tta": (h.quantiles() if h is not None else
                        {"p50": 0.0, "p90": 0.0, "p99": 0.0,
                         "count": 0, "mean": 0.0}),
                "slo": self.slo.status(job),
            }
        gw = self.gateway
        gateway = {
            "counters": dict(gw.counters),
            "queue_depth": gw.depth(),
            "ingest": gw.ingest_quantiles(),
            "retry_after_s_now": gw.retry_after_now(),
        }
        fleet: Dict[str, Any] = {}
        if self.monitor is not None:
            fleet = self.monitor.fleet_view()
        else:
            nodes = getattr(self.runtime, "_nodes", None)
            if isinstance(nodes, dict):
                fleet = {name: {"stale": not getattr(n, "alive", False),
                                "epoch": getattr(n, "epoch", 0)}
                         for name, n in nodes.items()}
            else:
                rt_health = getattr(self.runtime, "health", None)
                fleet = {"local": {"stale": False,
                                   "health": (rt_health()
                                              if callable(rt_health)
                                              else {})}}
        return {
            "open_rounds": len(self.driver._open_rounds),
            "gateway_queue_depth": gw.depth(),
            "fleet_nodes_alive": self._fleet_nodes_alive(),
            "jobs": jobs,
            "gateway": gateway,
            "fleet": fleet,
            "driver": dict(self.driver.stats),
            "rounds_closed": len(self.round_log),
            "monitor": (self.monitor.counters()
                        if self.monitor is not None else None),
            "planner": dict(self.coordinator.plan_cache_stats),
        }

    # ------------------------------------------------------------------
    def ingress_metrics(self) -> Dict[str, Any]:
        """Gateway counters plus every job's trainer-side ingress."""
        out: Dict[str, Any] = dict(self.gateway.counters)
        out["queued_now"] = self.gateway.depth()
        out["jobs"] = {j: dict(t.ingress)
                       for j, t in self._trainers.items()}
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.monitor is not None:
            self.monitor.stop()
            self.monitor = None
        if self._serve_stop is not None:
            self._serve_stop.set()
            self._serve_thread.join(timeout=5.0)
            self._server.close()
            self._server = self._serve_thread = self._serve_stop = None
        for tr in self._trainers.values():
            tr._runtime = None     # the service owns the shared runtime
            tr.close()
        close = getattr(self.runtime, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "AggregationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
