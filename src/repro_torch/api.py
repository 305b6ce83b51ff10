"""repro_torch.api — the platform's public surface, on PyTorch.

A :class:`Session` is the one object user code talks to: it owns a
:class:`~repro_torch.runtime.trainer.FederatedTrainer`, its
:class:`~repro_torch.runtime.driver.RoundDriver` event loop, and the
selected aggregation runtime (``"inproc"``, ``"shmproc"``, or — when
``nodes`` is a list of daemon addresses — the multi-node
``RemoteRuntime``), on one device (the card unless the caller names
another), and exposes the whole platform as four verbs::

    with Session.open(model, params, clients, runtime="shmproc") as s:
        s.submit_update("edge-7", flat_delta, weight=12)   # external client
        rec = s.run_round(client_lr=0.05)                   # drive one round
        print(s.metrics()["rounds"][-1], s.evaluate(batch))
    # context exit closes the runtime (idempotent; shm segments unlinked)

Multi-node: point ``nodes`` at running ``netd`` daemons and the same
round loop drives a cross-node hierarchical round (only sealed partial
sums cross the wire); ``serve`` turns the session into an ingest
endpoint for external client processes::

    with Session.open(model, params, clients,
                      nodes=["10.0.0.2:7000", "10.0.0.3:7000"]) as s:
        addr = s.serve("0.0.0.0:7500")   # accepts submit_update frames
        s.run_round(client_lr=0.05)

Everything else — typed events, elastic scaling, node churn — plugs in
through the same event protocol::

    s.on(WorkerCrashed, lambda ev: print("crash:", ev.agg_id))
    s.emit(NodeLost(node="node3"))      # next plan excludes the node

Where the folds run: the client training, the in-process mids and the
controller's top fold on the session's device (the fedavg kernels on
the card); ``shmproc``'s forked workers fold with numpy on the host, as
in the JAX package; each ``netd`` folds on its own ``--device``.

``checkpoint_dir=`` checkpoints the global params every
``checkpoint_every`` model versions, asynchronously, in the JAX
package's format (``repro_torch.checkpoint``): either package restores
what the other wrote.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Type

import numpy as np

from repro_torch.runtime.events import RoundEvent
from repro_torch.runtime.trainer import ClientRuntime, FederatedTrainer, _flatten_tree


class Session:
    """Public facade over one federated-learning job.

    Build with :meth:`open`; use as a context manager.  ``close`` is
    idempotent — double-close and close-after-crash neither raise nor
    leak shared-memory segments."""

    def __init__(self, trainer: FederatedTrainer,
                 admission: Optional[Any] = None):
        self._trainer = trainer
        self._server = None           # Session.serve ingest endpoint
        self._serve_thread: Optional[threading.Thread] = None
        self._serve_stop: Optional[threading.Event] = None
        # admission control (serve/gateway.py): a bounded ingress valve
        # in front of submit_update — over-budget submissions get a
        # busy verdict + retry_after_s instead of unbounded queueing
        self._gateway = None
        if admission is not None and admission is not False:
            from repro_torch.serve.gateway import AdmissionPolicy, IngressGateway

            policy = (AdmissionPolicy() if admission is True
                      else admission)
            self._gateway = IngressGateway(
                policy, emit=trainer.driver.dispatch)
            self._gateway.register("", trainer.submit_update,
                                   lambda: len(trainer._external))

    # ------------------------------------------------------------------
    @classmethod
    def open(
        cls,
        model,
        params: Any,
        clients: Sequence[ClientRuntime],
        *,
        runtime: Any = "inproc",
        nodes: Any = None,        # {name: NodeState} | [netd addresses]
        round_cfg: Optional[Any] = None,
        server_opt: str = "fedavg",
        server_lr: float = 1.0,
        agg_engine: str = "auto",
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 5,
        seed: int = 0,
        wire_compress: Any = 0,
        trace_path: Optional[str] = None,
        admission: Optional[Any] = None,
        device: Any = None,
    ) -> "Session":
        """Open a session: ``model.loss(params, batch)`` plus a client
        fleet, on the chosen aggregation runtime.

        ``nodes`` is either the usual ``{name: NodeState}`` mapping
        (single-node runtimes) or a list of ``netd`` daemon addresses
        (``"host:port"`` / ``"unix:/path"``) — the multi-node mode: a
        :class:`~repro_torch.runtime.netrt.RemoteRuntime` is connected to the
        fleet, and each daemon's name/capacity (from its welcome
        handshake) becomes a placement ``NodeState``.  When
        ``round_cfg`` is omitted, the multi-node default config uses
        the locality placement policy (minimizes cross-node partials)
        and the ``node`` fold topology — the round's top fold runs on
        the busiest worker node, partials ship daemon→daemon, and only
        the final folded Σc·u returns to the controller; a caller
        supplying its own ``RoundConfig`` picks both explicitly
        (``topology`` defaults to ``"controller"``).
        ``wire_compress`` (zlib level, or True for 6) compresses
        update/partial blobs on the frame transport.

        ``params`` is the port's parameter tree (``model.init`` or
        :func:`repro_torch.convert.params_from_jax`); it is moved to
        ``device``, which is the card when None.  With no CUDA device
        and no ``device`` given this raises ``RuntimeError``; tests
        pass ``device="cpu"``.

        ``trace_path`` appends every round's :class:`RoundTrace` as one
        JSONL record (flushed per line) — read back with
        :func:`repro_torch.obs.read_traces`, which tolerates the truncated
        tail a mid-round kill leaves behind.

        ``admission`` (an :class:`~repro_torch.serve.AdmissionPolicy`, or
        ``True`` for the defaults) puts the serve-plane ingress valve
        in front of ``submit_update``: over-budget submissions get a
        busy verdict carrying ``retry_after_s`` (a ``busy`` frame on
        the serve endpoint) instead of queueing without bound."""
        remote = None
        if wire_compress and not isinstance(nodes, (list, tuple)):
            # single-node runtimes never touch the frame transport, so
            # silently accepting the flag would leave the caller
            # believing their traffic is compressed
            raise ValueError(
                "wire_compress= requires multi-node mode (nodes as a "
                "list of netd addresses) — single-node runtimes have "
                "no wire to compress")
        if isinstance(nodes, (list, tuple)):
            from repro_torch.core.placement import NodeState
            from repro_torch.runtime.netrt import RemoteRuntime

            if runtime != "inproc":
                # the node-side runtime was fixed when each netd was
                # launched (netd --runtime); silently ignoring the
                # caller's choice would be worse than refusing
                raise ValueError(
                    "runtime= cannot be combined with a list of node "
                    "addresses — multi-node sessions always run on the "
                    "RemoteRuntime; pick the per-node runtime with "
                    "netd --runtime instead")
            remote = RemoteRuntime(nodes, agg_engine=agg_engine,
                                   compress=wire_compress)
            nodes = {name: NodeState(node=name, max_capacity=cap)
                     for name, cap in remote.node_info().items()}
            runtime = remote
            if round_cfg is None:
                from repro_torch.core import RoundConfig
                round_cfg = RoundConfig(aggregation_goal=8,
                                        placement_policy="locality",
                                        topology="node")
        try:
            sess = cls(FederatedTrainer(
                model, params, clients,
                nodes=nodes, round_cfg=round_cfg, server_opt=server_opt,
                server_lr=server_lr, agg_engine=agg_engine, runtime=runtime,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                seed=seed,
                trace_path=trace_path,
                device=device,
            ), admission=admission)
        except BaseException:
            if remote is not None:
                remote.close()   # the fleet connections must not leak
            raise
        if remote is not None:
            # the connections already exist, so attach eagerly: a
            # session closed before its first round must still close
            # them (single-node runtimes stay lazy), and the wire
            # sidecar should land in the session's metrics map
            remote.metrics = sess._trainer.metrics
            # the controller's top fold runs on the session's device
            remote.agg_engine = sess._trainer.agg_engine
            sess._trainer._ensure_runtime()
        return sess

    # ------------------------------------------------------------------
    # the four verbs
    # ------------------------------------------------------------------
    def run_round(self, **kwargs) -> Dict[str, float]:
        """Drive one federated round (see
        :meth:`FederatedTrainer.run_round` for kwargs)."""
        return self._trainer.run_round(**kwargs)

    def submit_update(self, client_id: str, update: Any,
                      weight: float = 1.0, *,
                      submission_id: Optional[str] = None,
                      round_id: Optional[int] = None) -> bool:
        """Inject an externally-computed model update (a flat float32
        vector in the JAX layout, or a params-shaped tree of tensors in
        the port's layout); it takes a cohort slot in the next round.
        Pass a ``submission_id`` to make retries idempotent (duplicates
        return ``False`` without queueing) and a ``round_id`` to refuse
        submissions aimed at an already-finished round.  Returns
        ``True`` when the update was queued.

        With ``admission`` configured (:meth:`open`) the submission
        runs through the ingress gateway and the full verdict dict
        comes back instead: ``{"admitted", "busy", "duplicate",
        "queued", "retry_after_s"}`` — ``busy`` means over budget,
        retry after the hint (nothing was queued or dropped)."""
        if isinstance(update, np.ndarray):
            # a numpy update of any shape is one leaf, as under
            # jax.tree.flatten: the trainer flattens it and checks its
            # size (the port's tree flattener takes tensors only)
            flat = update
        else:
            flat, _, _ = _flatten_tree(update)
        if self._gateway is not None:
            return self._gateway.admit(
                "", client_id, flat, weight,
                submission_id=submission_id, round_id=round_id)
        return self._trainer.submit_update(
            client_id, flat, weight,
            submission_id=submission_id, round_id=round_id)

    def metrics(self) -> Dict[str, Any]:
        """Snapshot of the job: per-round records, model version, the
        event sidecar series, and driver/event-loop counters.

        ``sidecar`` keeps the legacy flat-sum shape
        (``"owner/metric": total``); ``sidecar_series`` carries the full
        per-series statistics — ``{"sum", "count", "mean"}`` — that the
        sums alone were hiding (a big ``agg_exec_s`` total can mean one
        slow fold or a thousand fast ones)."""
        tr = self._trainer
        snap = tr.metrics.snapshot()
        out: Dict[str, Any] = {
            "rounds": list(tr.log),
            "model_version": tr.coordinator.model_version,
            "runtime": tr.runtime if isinstance(tr.runtime, str)
            else getattr(tr.runtime, "name", "custom"),
            "sidecar": {f"{owner}/{metric}": total for
                        (owner, metric), (total, _n) in snap.items()},
            "sidecar_series": {
                f"{owner}/{metric}": {
                    "sum": total, "count": n,
                    "mean": (total / n) if n else 0.0}
                for (owner, metric), (total, n) in snap.items()},
        }
        out["ingress"] = dict(tr.ingress)
        if self._gateway is not None:
            gw = self._gateway.counters
            out["ingress"]["admitted"] = gw["admitted"]
            out["ingress"]["shed"] += gw["shed"]
            out["ingress"]["queued_now"] = self._gateway.depth()
        if tr._driver is not None:
            out["driver"] = dict(tr._driver.stats)
        # serve/live gauges — same names as the service health surface
        # (tests/test_live.py holds the key parity)
        out["open_rounds"] = (len(tr._driver._open_rounds)
                              if tr._driver is not None else 0)
        out["gateway_queue_depth"] = (self._gateway.depth()
                                      if self._gateway is not None
                                      else len(tr._external))
        out["fleet_nodes_alive"] = self._fleet_nodes_alive()
        out["planner"] = dict(tr.coordinator.plan_cache_stats)
        return out

    def _fleet_nodes_alive(self) -> int:
        rt = self._trainer._runtime
        nodes = getattr(rt, "_nodes", None)
        if isinstance(nodes, dict):
            return sum(1 for n in nodes.values()
                       if getattr(n, "alive", False))
        return 1   # a local runtime IS its one (alive) node

    def status(self) -> Dict[str, Any]:
        """One structured fleet snapshot — the single-job mirror of
        :meth:`AggregationService.health` (identical top-level keys,
        test-enforced), renderable with
        :func:`repro_torch.obs.to_prometheus` / :func:`repro_torch.obs.summary_line`.
        """
        tr = self._trainer
        job = tr.job or ""
        h = tr.metrics.hist("tta", job)
        jobs = {job: {
            "queue_depth": len(tr._external),
            "rounds": len(tr.log),
            "tta": (h.quantiles() if h is not None else
                    {"p50": 0.0, "p90": 0.0, "p99": 0.0,
                     "count": 0, "mean": 0.0}),
            "slo": None,    # per-job SLO targets live on the service
        }}
        if self._gateway is not None:
            gw = self._gateway
            gateway = {"counters": dict(gw.counters),
                       "queue_depth": gw.depth(),
                       "ingest": gw.ingest_quantiles(),
                       "retry_after_s_now": gw.retry_after_now()}
            gw_depth = gw.depth()
        else:
            gateway = {"counters": dict(tr.ingress),
                       "queue_depth": len(tr._external),
                       "ingest": {}, "retry_after_s_now": 0.0}
            gw_depth = len(tr._external)
        rt = tr._runtime
        nodes = getattr(rt, "_nodes", None)
        if isinstance(nodes, dict):
            fleet = {name: {"stale": not getattr(n, "alive", False),
                            "epoch": getattr(n, "epoch", 0)}
                     for name, n in nodes.items()}
        else:
            rt_health = getattr(rt, "health", None)
            fleet = {"local": {"stale": False,
                               "health": (rt_health()
                                          if callable(rt_health)
                                          else {})}}
        return {
            "open_rounds": (len(tr._driver._open_rounds)
                            if tr._driver is not None else 0),
            "gateway_queue_depth": gw_depth,
            "fleet_nodes_alive": self._fleet_nodes_alive(),
            "jobs": jobs,
            "gateway": gateway,
            "fleet": fleet,
            "driver": (dict(tr._driver.stats)
                       if tr._driver is not None else {}),
            "rounds_closed": len(tr.log),
            "monitor": None,   # the FleetMonitor belongs to the service
            "planner": dict(tr.coordinator.plan_cache_stats),
        }

    def trace(self, round_id: Optional[int] = None):
        """The :class:`~repro_torch.obs.RoundTrace` for ``round_id`` (latest
        round when omitted): driver/worker spans plus any per-daemon
        telemetry drained over the wire.  ``trace.breakdown()``
        attributes the round's wall time to tiers (client train, wire,
        mid folds, top fold, control + unaccounted residual)."""
        return self._trainer.trace(round_id)

    def evaluate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self._trainer.evaluate(batch)

    # ------------------------------------------------------------------
    # serve mode: ingest updates from external client processes
    # ------------------------------------------------------------------
    def serve(self, addr: str = "127.0.0.1:0") -> str:
        """Start accepting ``submit_update`` frames from external
        client processes on ``addr`` (see
        :func:`repro_torch.runtime.netrt.push_update` for the client side).
        Each accepted update is queued exactly like
        :meth:`submit_update` — it takes a cohort slot in the next
        round.  Returns the bound address (ephemeral ports resolved);
        idempotent while already serving.  The listener runs on a
        daemon thread and stops with :meth:`close`."""
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
            target=loop, name="session-serve", daemon=True)
        self._serve_thread.start()
        return server.addr

    def _serve_frame(self, conn, frame) -> None:
        from repro_torch.runtime.netrt.transport import resolve_dtype

        if frame.kind == "hello":
            conn.send("welcome", {"node": "session", "proto": 1,
                                  "capacity": 0.0, "runtime": "serve"})
        elif frame.kind == "ping":
            conn.send("pong", {"t": frame.meta.get("t")})
        elif frame.kind == "submit_update":
            # the frombuffer view is already a fresh read-only array
            # over this frame's blob; the trainer copies iff it must
            # (dtype/contiguity), so no extra model-size memcpy here
            flat = np.frombuffer(
                frame.blob, dtype=resolve_dtype(frame.meta["dtype"]),
            ).reshape(frame.meta["shape"])
            verdict = self.submit_update(
                frame.meta["client_id"], flat,
                weight=frame.meta.get("weight", 1.0),
                submission_id=frame.meta.get("submission_id"),
                round_id=frame.meta.get("round_id"))
            if isinstance(verdict, dict):       # admission configured
                if verdict["busy"]:
                    conn.send("busy", {
                        "client_id": frame.meta["client_id"],
                        "retry_after_s": verdict["retry_after_s"],
                        "queued": verdict["queued"]})
                    return
                conn.send("ack", {"client_id": frame.meta["client_id"],
                                  "queued": verdict["queued"],
                                  "duplicate": verdict["duplicate"]})
                return
            conn.send("ack", {"client_id": frame.meta["client_id"],
                              "queued": len(self._trainer._external),
                              "duplicate": not verdict})
        else:
            conn.send("error", {"msg": f"unknown frame {frame.kind!r}"})

    @property
    def serve_addr(self) -> Optional[str]:
        return self._server.addr if self._server is not None else None

    # ------------------------------------------------------------------
    # event protocol
    # ------------------------------------------------------------------
    def on(self, event_type: Type[RoundEvent],
           handler: Callable[[RoundEvent], None]) -> None:
        """Subscribe a handler to a typed round event."""
        self._trainer.driver.on(event_type, handler)

    def emit(self, event: RoundEvent) -> bool:
        """Inject an event into the driver (node churn, scale
        decisions, deadlines).  Returns False if an ordering guard
        dropped it."""
        return self._trainer.driver.emit(event)

    # ------------------------------------------------------------------
    @property
    def params(self) -> Any:
        return self._trainer.params

    @property
    def trainer(self) -> FederatedTrainer:
        return self._trainer

    @property
    def nodes(self) -> Dict[str, Any]:
        return self._trainer.nodes

    @property
    def closed(self) -> bool:
        return self._trainer.closed

    def close(self) -> None:
        if self._serve_stop is not None:
            self._serve_stop.set()
            self._serve_thread.join(timeout=5.0)
            self._server.close()
            self._server = self._serve_thread = self._serve_stop = None
        self._trainer.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
