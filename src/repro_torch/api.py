"""repro_torch.api — the platform's public surface, on PyTorch.

A :class:`Session` is the one object user code talks to: it owns a
:class:`~repro_torch.runtime.trainer.FederatedTrainer`, its
:class:`~repro_torch.runtime.driver.RoundDriver` event loop and the
in-process aggregation runtime, on one device (the card unless the
caller names another)::

    with Session.open(model, params, clients) as s:
        s.submit_update("edge-7", flat_delta, weight=12)   # external client
        rec = s.run_round(client_lr=0.05)                   # drive one round
        print(s.metrics()["rounds"][-1], s.evaluate(batch))

Typed events plug in through the same protocol as in the JAX package::

    s.on(UpdateArrived, lambda ev: print("update:", ev.client_id))
    s.emit(NodeLost(node="node3"))      # next plan excludes the node

Not ported yet, and refused with ``NotImplementedError``: the
``shmproc`` runtime, multi-node ``nodes=[addresses]``, wire compression
and :meth:`Session.serve` (ROADMAP A.4), admission control (A.4), and
checkpoints (A.8).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Type

import numpy as np

from repro_torch.core.coordinator import RoundConfig
from repro_torch.runtime.events import RoundEvent
from repro_torch.runtime.trainer import ClientRuntime, FederatedTrainer, _flatten_tree

_MULTI = "ROADMAP A.4: multi-process and multi-node runtimes with the GPU engine"


class Session:
    """Public facade over one federated-learning job.

    Build with :meth:`open`; use as a context manager.  ``close`` is
    idempotent — double-close and close-after-crash neither raise nor
    leak shared-memory segments."""

    def __init__(self, trainer: FederatedTrainer):
        self._trainer = trainer

    # ------------------------------------------------------------------
    @classmethod
    def open(
        cls,
        model,
        params: Any,
        clients: Sequence[ClientRuntime],
        *,
        runtime: Any = "inproc",
        nodes: Any = None,        # {name: NodeState}
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
        fleet, on the in-process aggregation runtime.

        ``params`` is the port's parameter tree (``model.init`` or
        :func:`repro_torch.convert.params_from_jax`); it is moved to
        ``device``, which is the card when None.  With no CUDA device
        and no ``device`` given this raises ``RuntimeError``; tests
        pass ``device="cpu"``.

        ``trace_path`` appends every round's :class:`RoundTrace` as one
        JSONL record (flushed per line)."""
        if runtime != "inproc" or (
                isinstance(round_cfg, RoundConfig)
                and round_cfg.runtime != "inproc"):
            raise NotImplementedError(
                f"runtime={runtime!r}: only 'inproc' is ported ({_MULTI})")
        if isinstance(nodes, (list, tuple)):
            raise NotImplementedError(
                f"nodes=[addresses] (multi-node) is not ported ({_MULTI})")
        if wire_compress:
            raise NotImplementedError(
                f"wire_compress= is not ported ({_MULTI})")
        if admission is not None and admission is not False:
            raise NotImplementedError(
                "admission= (the serve-plane ingress gateway) is not "
                f"ported ({_MULTI})")
        return cls(FederatedTrainer(
            model, params, clients,
            nodes=nodes, round_cfg=round_cfg, server_opt=server_opt,
            server_lr=server_lr, agg_engine=agg_engine, runtime=runtime,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            seed=seed,
            trace_path=trace_path,
            device=device,
        ))

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
        ``True`` when the update was queued."""
        if isinstance(update, np.ndarray) and update.ndim == 1:
            flat = update
        else:
            flat, _, _ = _flatten_tree(update)
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
        if tr._driver is not None:
            out["driver"] = dict(tr._driver.stats)
        # serve/live gauges — same names as the service health surface
        # (tests/test_live.py holds the key parity)
        out["open_rounds"] = (len(tr._driver._open_rounds)
                              if tr._driver is not None else 0)
        out["gateway_queue_depth"] = len(tr._external)
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
    # serve mode: not ported yet
    # ------------------------------------------------------------------
    def serve(self, addr: str = "127.0.0.1:0") -> str:
        """Ingest endpoint for external client processes — needs the
        frame transport of the multi-node runtime."""
        raise NotImplementedError(f"Session.serve is not ported ({_MULTI})")

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
        self._trainer.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
