"""Training runtime: ``FederatedTrainer``, the paper-faithful engine.

Real per-client local SGD (torch autograd on the device), LIFL
hierarchical aggregation through the actual control-plane objects
(selector → BestFit placement → EWMA hierarchy → warm engines → eager
aggregation), failure handling via over-provisioning + aggregation
goal.  The round itself is driven by
:class:`repro_torch.runtime.driver.RoundDriver`.

The port of the JAX package's ``runtime/trainer.py``.  Parameters are a
tree of tensors on the trainer's device, conv kernels OIHW; client
deltas leave the device as one fp32 numpy vector in the JAX package's
leaf order and layout, so the object store, the fold and the wire are
the JAX package's.  ``FusedFLTrainer`` runs the fused round of
``fl/round.py`` (large models, one step per round) on one device.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import (
    Any, Deque, Dict, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch.bf16 import as_f32
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
# the flat wire vector: element for element the JAX package's
# _flatten_tree of the same params (its leaf order, HWIO)
from repro_torch.convert import flatten_jax_layout as _flatten_tree
from repro_torch.convert import unflatten_jax_layout as _unflatten_like
from repro_torch.core import (
    ClientInfo,
    Coordinator,
    MetricsMap,
    NodeState,
    RoundConfig,
    Selector,
)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.reuse import ExecutableCache
from repro_torch.device import resolve_device
from repro_torch.fl.round import AggregationConfig, build_train_step
from repro_torch.fl.server import apply_server_opt, init_server_state
from repro_torch.optim import sgd_apply
from repro_torch.obs.trace import RoundTrace, write_trace
from repro_torch.runtime.driver import RoundDriver, make_runtime
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime.events import (
    NodeJoined,
    NodeLost,
    NodeRejoined,
    PartialReady,
    PartialShipped,
    TopFolded,
)


# ===========================================================================
# paper-faithful engine (diverged clients, host aggregation tree)
# ===========================================================================


@contextlib.contextmanager
def _onednn_off_on_the_cpu(device: torch.device) -> Iterator[None]:
    """Client SGD on the CPU runs with oneDNN off: its conv backward
    crashes torch's CPU build (2.13.0+cpu) at odd batch sizes with more
    than one thread, which a Dirichlet shard's last batch often is.  The
    flag is read when the backward runs, so it covers the whole loop.
    On the card nothing changes."""
    if device.type != "cpu":
        yield
        return
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


@dataclass
class ClientRuntime:
    """A training client: local SGD for ``epochs`` over its shard."""

    info: ClientInfo
    dataset: Any                      # ClientDataset
    hibernate_s: Tuple[float, float] = (0.0, 0.0)  # mobile availability (§6.2)
    failure_prob: float = 0.0

    def local_update(self, model, params, *, lr: float, batch_size: int,
                     epochs: int, rng: np.random.Generator
                     ) -> Optional[Tuple[Any, float]]:
        """-> (delta pytree, num_samples) or None if the client fails."""
        if rng.random() < self.failure_prob:
            return None  # detected by missing heartbeat; goal absorbs it
        device = tree_leaves(params)[0].device
        p = params
        n = 0
        with _onednn_off_on_the_cpu(device):
            for batch in self.dataset.batches(
                    batch_size, epochs=epochs,
                    seed=int(rng.integers(1 << 30))):
                tb = {k: torch.from_numpy(v).to(device)
                      for k, v in batch.items()}
                leaves, treedef = tree_flatten(p)
                leaves = [l.detach().requires_grad_(True) for l in leaves]
                loss, _ = model.loss(tree_unflatten(treedef, leaves), tb)
                grads = torch.autograd.grad(loss, leaves)
                p, _ = sgd_apply(p, tree_unflatten(treedef, list(grads)),
                                 {}, lr=lr)
                n += len(batch["labels"])
        if n == 0:
            return None
        delta = tree_map(lambda new, old: new.float() - old.float(), p, params)
        return delta, float(self.dataset.num_samples)


#: run_round's PR-2 era kwargs → their canonical names (the client-side
#: hyperparameters are now prefixed so they can't be confused with the
#: server optimizer's ``server_lr``).
_DEPRECATED_ROUND_KWARGS = {
    "lr": "client_lr",
    "batch_size": "client_batch_size",
    "epochs": "client_epochs",
}


class FederatedTrainer:
    """LIFL rounds over real clients with the host aggregation tree.

    One :class:`RoundDriver` loop serves every runtime; pick one with
    ``runtime="inproc"`` (single process), ``runtime="shmproc"``
    (forked aggregator workers over shared-memory rings, folding with
    numpy on the host) or a runtime instance (the multi-node
    ``RemoteRuntime``).  ``device`` is where the params, the client
    training and the trainer's own aggregation engines (the in-process
    mids, the controller's top fold) live: the card unless the caller
    names another; with no CUDA device, asking for the card raises."""

    def __init__(
        self,
        model,                       # .loss(params, batch) -> (loss, aux)
        params: Any,
        clients: Sequence[ClientRuntime],
        *,
        nodes: Optional[Dict[str, NodeState]] = None,
        round_cfg: Optional[RoundConfig] = None,
        server_opt: str = "fedavg",
        server_lr: float = 1.0,
        agg_engine: str = "auto",
        runtime: Optional[Any] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 5,
        seed: int = 0,
        trace_path: Optional[str] = None,
        job: str = "",
        job_weight: float = 1.0,
        coordinator: Optional[Coordinator] = None,
        driver: Optional[RoundDriver] = None,
        device: Any = None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        # engines are built per tree position by the runtime: a name
        # that means the torch engine carries the trainer's device
        if isinstance(agg_engine, str) and agg_engine in ("auto", "torch"):
            agg_engine = EngineConfig(name=agg_engine,
                                      device=str(self.device))
        self.agg_engine = agg_engine
        self.clients = {c.info.client_id: c for c in clients}
        self.nodes = nodes or {
            f"node{i}": NodeState(node=f"node{i}", max_capacity=20.0)
            for i in range(5)
        }
        self.round_cfg = round_cfg or RoundConfig(aggregation_goal=8)
        # selectable aggregation runtime: explicit arg > round config
        self.runtime = runtime if runtime is not None else self.round_cfg.runtime
        self.server_opt = server_opt
        self.server_lr = server_lr
        self.server_state = init_server_state(server_opt, self.params)
        # serve mode: several trainers (one per job) share ONE
        # coordinator — each registers its cohort under its job name
        # and plans against a weighted fair share of the fleet.  The
        # default (no injection) is the historical one-trainer-one-
        # coordinator library path, untouched.
        self.job = job
        if coordinator is not None:
            self.coordinator = coordinator
            if job:
                coordinator.register_job(
                    job, [c.info for c in clients], weight=job_weight,
                    seed=seed)
        else:
            self.coordinator = Coordinator(
                Selector([c.info for c in clients], seed=seed), self.nodes
            )
        self.metrics = MetricsMap()
        self.rng = np.random.default_rng(seed)
        self.ckpt = AsyncCheckpointer(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        self.log: List[Dict[str, float]] = []
        # externally submitted updates (Session.submit_update): each one
        # takes a selected client's slot in the next round's cohort
        self._external: Deque[Tuple[str, np.ndarray, float]] = deque()
        # idempotent ingress: (client_id, submission_id) pairs already
        # accepted — a retried submission (lost ack, client backoff)
        # dedupes here instead of double-folding.  Bounded LRU so a
        # long job can't grow it without limit; `ingress` counts every
        # accept/dedupe/refusal for Session.metrics.
        self._seen_submissions: "OrderedDict[Tuple[str, str], int]" = \
            OrderedDict()
        self._seen_submissions_cap = 4096
        self.ingress: Dict[str, int] = {
            "queued": 0, "duplicates": 0, "refused": 0,
            "stale_round": 0, "requeued": 0, "shed": 0}
        # externals popped by the current round's cohort generator —
        # the requeue pass matches them against RoundOutcome.skipped
        self._popped_external: List[Tuple[str, np.ndarray, float]] = []
        # per-round traces (obs/): the driver's trace sink lands here;
        # bounded so a long job can't grow without limit.  trace_path
        # additionally appends each round as a JSONL record (flushed
        # per line — post-mortems survive a mid-round kill).
        self.trace_path = trace_path
        self.traces: "OrderedDict[int, RoundTrace]" = OrderedDict()
        self._traces_cap = 64
        self._runtime = None          # lazy: persists across rounds (warm)
        # an injected driver is shared infrastructure (serve mode): the
        # owner wires the coordinator's event handlers ONCE — wiring
        # them here per-trainer would double-count every EWMA sample
        self._driver: Optional[RoundDriver] = driver
        self._owns_driver = driver is None
        self._closed = False

    # ------------------------------------------------------------------
    # the one driver (lazy; wired to the control-plane event handlers)
    # ------------------------------------------------------------------
    @property
    def driver(self) -> RoundDriver:
        """The event bus is always available (subscribing a handler
        must not boot a runtime); the runtime itself attaches lazily on
        the first ``run_round``."""
        if self._driver is None:
            if self._closed:
                raise RuntimeError("trainer is closed")
            self._driver = RoundDriver(metrics=self.metrics,
                                       trace_sink=self._sink_trace)
            # node churn reshapes the next plan, and every subtree's
            # PartialReady feeds its node's RC capacity model: the
            # coordinator is an ordinary event handler on the driver.
            # TopFolded prices the root fold and PartialShipped the
            # uplink — the obs-stamped costs close the feedback loop.
            self._driver.on(NodeJoined, self.coordinator.handle_event)
            self._driver.on(NodeLost, self.coordinator.handle_event)
            self._driver.on(NodeRejoined, self.coordinator.handle_event)
            self._driver.on(PartialReady, self.coordinator.handle_event)
            self._driver.on(TopFolded, self.coordinator.handle_event)
            self._driver.on(PartialShipped, self.coordinator.handle_event)
        return self._driver

    def _sink_trace(self, trace: RoundTrace) -> None:
        self.traces[trace.round_id] = trace
        while len(self.traces) > self._traces_cap:
            self.traces.popitem(last=False)
        if self.trace_path:
            try:
                write_trace(self.trace_path, trace)
            except OSError:
                pass  # a full/vanished disk must not fail the round

    def trace(self, round_id: Optional[int] = None) -> Optional[RoundTrace]:
        """The per-round trace (latest round when ``round_id`` is None)."""
        if round_id is None:
            if not self.traces:
                return None
            round_id = next(reversed(self.traces))
        return self.traces.get(round_id)

    def _ensure_runtime(self):
        if self._runtime is None:
            self._runtime = make_runtime(
                self.runtime, metrics=self.metrics,
                agg_engine=self.agg_engine, eager=self.round_cfg.eager)
            self.driver.runtime = self._runtime
        return self._runtime

    # ------------------------------------------------------------------
    def submit_update(self, client_id: str, flat: np.ndarray,
                      weight: float = 1.0, *,
                      submission_id: Optional[str] = None,
                      round_id: Optional[int] = None) -> bool:
        """Queue an externally-computed flat update; it rides the next
        ``run_round`` in place of a locally-trained client.

        Idempotent when the caller supplies a ``submission_id``: a
        ``(client_id, submission_id)`` pair already accepted is counted
        and ignored (returns ``False``) — the retry contract that lets
        :func:`~repro_torch.runtime.netrt.push_update` redeliver after a lost
        ack without ever double-folding.  A ``round_id`` pins the
        submission to a round: one older than the next round to run is
        refused (``ValueError``) — it could only fold into a round its
        sender never meant.  Returns ``True`` when queued."""
        next_round = self.coordinator.job_round(self.job)
        if round_id is not None and round_id < next_round:
            self.ingress["stale_round"] += 1
            raise ValueError(
                f"stale round_id {round_id}: next round is {next_round}")
        if submission_id is not None:
            seen_key = (client_id, submission_id)
            if seen_key in self._seen_submissions:
                self.ingress["duplicates"] += 1
                return False
        # any shape whose total size matches is accepted — flatten here
        # so a (rows, cols) wire payload can't reach the 1-D fold loop;
        # bf16 words off the wire are widened exactly
        flat = as_f32(flat).reshape(-1)
        if flat.size != self._flat_params_size():
            self.ingress["refused"] += 1
            raise ValueError(
                f"update has {flat.size} elements, model has "
                f"{self._flat_params_size()}")
        if submission_id is not None:
            self._seen_submissions[seen_key] = next_round
            while len(self._seen_submissions) > self._seen_submissions_cap:
                self._seen_submissions.popitem(last=False)
        self._external.append((client_id, flat, float(weight)))
        self.ingress["queued"] += 1
        return True

    # ------------------------------------------------------------------
    def run_round(self, *, client_lr: Optional[float] = None,
                  client_batch_size: Optional[int] = None,
                  client_epochs: Optional[int] = None,
                  deadline_s: Optional[float] = None,
                  sampler: Optional[Any] = None,
                  **legacy) -> Dict[str, float]:
        """One federated round through the driver (both runtimes)."""
        vals = {"client_lr": client_lr,
                "client_batch_size": client_batch_size,
                "client_epochs": client_epochs}
        for old, val in legacy.items():
            new = _DEPRECATED_ROUND_KWARGS.get(old)
            if new is None:
                raise TypeError(
                    f"run_round() got an unexpected keyword "
                    f"argument {old!r}")
            if vals[new] is not None:
                raise TypeError(
                    f"run_round() got both {old!r} and its replacement "
                    f"{new!r}")
            warnings.warn(
                f"run_round({old}=...) is deprecated; use {new}=...",
                DeprecationWarning, stacklevel=2)
            vals[new] = val
        client_lr = vals["client_lr"] if vals["client_lr"] is not None else 0.01
        client_batch_size = (vals["client_batch_size"]
                             if vals["client_batch_size"] is not None else 32)
        client_epochs = (vals["client_epochs"]
                         if vals["client_epochs"] is not None else 1)
        if self._closed:
            raise RuntimeError("trainer is closed")

        tround = self.open_round(
            client_lr=client_lr, client_batch_size=client_batch_size,
            client_epochs=client_epochs, deadline_s=deadline_s,
            sampler=sampler)
        tround.handle.run()
        return tround.finalize()

    # ------------------------------------------------------------------
    def open_round(self, *, client_lr: float = 0.01,
                   client_batch_size: int = 32, client_epochs: int = 1,
                   deadline_s: Optional[float] = None,
                   sampler: Optional[Any] = None,
                   feed: Optional[Any] = None,
                   feed_factory: Optional[Any] = None,
                   goal: Optional[int] = None,
                   driver_round_id: Optional[int] = None,
                   tag_rounds: bool = False) -> "_TrainerRound":
        """Plan one round and open it on the driver; returns a
        :class:`_TrainerRound` whose ``handle`` is resumable (the serve
        scheduler interleaves two) and whose :meth:`~_TrainerRound.
        finalize` applies the server optimizer once the handle is done.

        ``feed`` replaces the cohort generator (serve mode: the gateway
        feeds admitted external updates under a close-out policy);
        ``driver_round_id`` decouples the driver's globally-unique
        round id from the job's own round number (the plan's)."""
        if self._closed:
            raise RuntimeError("trainer is closed")
        t0 = time.perf_counter()
        self._ensure_runtime()
        if not self.driver._inflight:
            # rolling rounds share the popped-external log; reset it
            # only when nothing is in flight or the requeue pass of a
            # live round would lose its matches
            self._popped_external = []
        # sampler: per-round client selection as a pluggable policy —
        # `sampler(round_id, pool) -> cohort` replaces the built-in
        # diversity selector for this round (seed it for reproducibility)
        plan = self.coordinator.plan_round(
            self.round_cfg, sampler=sampler, job=self.job,
            tag_rounds=tag_rounds)
        goal = goal if goal is not None else self.round_cfg.aggregation_goal
        if feed_factory is not None:
            # serve mode: the feed needs the plan (node slots) before
            # the driver sees it
            updates = feed_factory(plan)
        elif feed is not None:
            updates = feed
        else:
            updates = self._cohort_updates(
                plan, lr=client_lr, batch_size=client_batch_size,
                epochs=client_epochs)
        handle = self.driver.open_round(
            round_id=(driver_round_id if driver_round_id is not None
                      else plan.round_id),
            assignment=plan.placement.assignment,
            updates=updates,
            goal=goal,
            n_elems=self._flat_params_size(),
            top_node=plan.top_node,
            deadline_s=deadline_s,
            fold_plan=plan.fold_plan,
            job=self.job,
        )
        return _TrainerRound(self, plan, handle, t0)

    # ------------------------------------------------------------------
    def _cohort_updates(self, plan, *, lr, batch_size, epochs
                        ) -> Iterator[Tuple[str, str, np.ndarray, float]]:
        """Yield ``(node, client_id, flat, weight)`` for the planned
        cohort — the one update source both runtimes consume, so
        selection/failure semantics can't drift between them.  Iteration
        *is* the client training; the driver stops pulling at the goal.
        Externally submitted updates take cohort slots first."""
        selected = plan.selected
        client_nodes: Dict[str, str] = {}
        for node, idxs in plan.placement.assignment.items():
            for i in idxs:
                if i < len(selected):
                    client_nodes[selected[i].client_id] = node

        for cid, node in client_nodes.items():
            if self._external:
                ext_cid, flat, weight = self._external.popleft()
                self._popped_external.append((ext_cid, flat, weight))
                yield node, ext_cid, flat, weight
                continue
            cr = self.clients[cid]
            out = cr.local_update(
                self.model, self.params, lr=lr, batch_size=batch_size,
                epochs=epochs, rng=self.rng,
            )
            if out is None:
                continue  # failed/hibernating client — over-provisioning absorbs
            delta, weight = out
            flat, _, _ = _flatten_tree(delta)
            yield node, cid, flat, weight

    def _flat_params_size(self) -> int:
        # must equal len(_flatten_tree(params)[0])
        return int(sum(l.numel() for l in tree_leaves(self.params)))

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Tear down the runtime (graceful drain + shm unlink for
        ``shmproc``) once a checkpoint in flight is written.  Idempotent:
        double-close and close-after-crash are no-ops;
        ``evaluate``/``params`` stay usable after."""
        if self._closed:
            return
        self._closed = True
        if self.ckpt is not None:
            self.ckpt.wait()
        if self._runtime is not None:
            self._runtime.close()
            self._runtime = None
        self._driver = None

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "FederatedTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def evaluate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        tb = {k: torch.from_numpy(np.asarray(v)).to(self.device)
              for k, v in batch.items()}
        with torch.no_grad():
            loss, aux = self.model.loss(self.params, tb)
        out = {"loss": float(loss)}
        out.update({k: float(v) for k, v in aux.items()})
        return out


class _TrainerRound:
    """One opened round on a :class:`FederatedTrainer`: the driver's
    resumable handle plus the trainer-side close-out (requeue skipped
    externals, apply the server optimizer, finish the coordinator
    round).  ``run_round`` drives it synchronously; the serve scheduler
    steps ``handle`` itself and calls :meth:`finalize` when done."""

    def __init__(self, trainer: FederatedTrainer, plan, handle, t0: float):
        self.trainer = trainer
        self.plan = plan
        self.handle = handle
        self.t0 = t0
        self.record: Optional[Dict[str, float]] = None

    def finalize(self) -> Dict[str, float]:
        """Close the round out trainer-side (requires ``handle.done``).
        Idempotent: the second call returns the first record."""
        if self.record is not None:
            return self.record
        if not self.handle.done:
            raise RuntimeError("round still in flight")
        tr, plan, outcome = self.trainer, self.plan, self.handle.outcome

        # --- requeue skipped external submissions -----------------------
        # An external update the driver pulled but never dispatched
        # (deadline hit, lost subtree, full node) must not vanish: unlike
        # a locally trained client it cannot be regenerated, so it rides
        # the next cohort instead.  Match by array identity — the same
        # object the generator yielded comes back in outcome.skipped.
        if outcome.skipped and tr._popped_external:
            ext_ids = {id(flat): (cid, flat, w)
                       for cid, flat, w in tr._popped_external}
            requeued = [ext_ids[id(flat)]
                        for _node, _cid, flat, _w in outcome.skipped
                        if id(flat) in ext_ids]
            for item in reversed(requeued):
                tr._external.appendleft(item)
            tr.ingress["requeued"] += len(requeued)

        # --- server applies the aggregated update -----------------------
        if outcome.delta is not None:
            delta_tree = _unflatten_like(outcome.delta, tr.params)
            tr.params, tr.server_state = apply_server_opt(
                tr.server_opt, tr.params, tr.server_state, delta_tree,
                lr=-tr.server_lr,  # delta = new - old, so apply +lr·delta
            )
        # (E_{i,t}/k_{i,t} now reach the capacity model through the
        # PartialReady events the coordinator subscribes to — the same
        # events that arrive over the wire in multi-node rounds)
        version = tr.coordinator.finish_round(job=tr.job,
                                              round_id=plan.round_id)
        if tr.ckpt and version % tr.checkpoint_every == 0:
            tr.ckpt.submit(version, tr.params)
        # round over: hand accumulators back so next round's aggregators
        # at the same positions start warm instead of reallocating —
        # UNLESS another round is still in flight (rolling mode): its
        # mids share engine keys with this round's (the round tag is
        # stripped for pool lookup) and recycling a buffer someone is
        # mid-fold into would hand it out twice
        if not tr.driver._inflight:
            tr._runtime.recycle_engines()

        rec = {
            "round": plan.round_id,
            "updates": float(outcome.accepted),
            "nodes_used": float(len(plan.placement.assignment)),
            "inter_node": float(plan.inter_node_updates),
            "cold_starts": float(outcome.cold_starts),
            "reused": float(outcome.warm_starts),
            "workers": float(outcome.workers),
            "crashes": float(outcome.crashes),
            "redispatched": float(outcome.redispatched),
            "wall_s": time.perf_counter() - self.t0,
        }
        tr.log.append(rec)
        self.record = rec
        return rec


# ===========================================================================
# fused engine (large models, one step per round)
# ===========================================================================


class FusedFLTrainer:
    """The JAX package's ``FusedFLTrainer``.  The step runs eagerly (the
    JAX package jits it); ``ExecutableCache`` holds it under the same
    signature.  On a mesh over ranks (``launch/mesh.py``) every rank
    builds the trainer with the same arguments, draws the same params,
    takes the whole batch each round and ends it with the same params;
    only rank 0 writes checkpoints."""

    def __init__(self, cfg, mesh, agg: AggregationConfig, *, opts=None,
                 device: Any = None, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 20):
        self.cfg = cfg
        self.mesh = mesh
        self.agg = agg
        self.device = resolve_device(device)
        step, model = build_train_step(cfg, mesh, agg, opts=opts)
        self.model = model
        self._cache = ExecutableCache(lambda **sig: step)
        self.step_fn = self._cache.get(batch=agg.num_microbatches,
                                       opt=agg.server_opt)
        self.params = None
        self.server_state = None
        self.ckpt = AsyncCheckpointer(checkpoint_dir) \
            if checkpoint_dir and mesh.rank == 0 else None
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.round_id = 0
        self.history: List[Dict[str, float]] = []

    def init(self, seed: int = 0) -> None:
        """Random params from ``seed``, drawn on the trainer's device.  On
        a mesh over ranks each rank draws them, and the ranks' per-leaf
        checksums must agree."""
        self.params = self.model.init(seed, device=self.device)
        self.server_state = init_server_state(self.agg.server_opt,
                                              self.params)
        if self.mesh.distributed:
            check_ranks_agree(self.mesh, self.params)

    def maybe_restore(self) -> bool:
        """Checkpoint/restart: resume from the latest checkpoint if any
        (into the current params' structure; without params, into a
        fresh init's)."""
        if not self.checkpoint_dir or latest_step(self.checkpoint_dir) is None:
            return False
        like = self.params if self.params is not None \
            else self.model.init(0, device=self.device)
        self.params, step = restore_checkpoint(self.checkpoint_dir, like,
                                               device=self.device)
        self.server_state = init_server_state(self.agg.server_opt,
                                              self.params)
        self.round_id = step
        return True

    def train_round(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        assert self.params is not None, "call init() or maybe_restore() first"
        tb = {k: torch.as_tensor(np.asarray(v), device=self.device)
              for k, v in batch.items()}
        self.params, self.server_state, metrics = self.step_fn(
            self.params, self.server_state, tb)
        self.round_id += 1
        rec = {k: float(v) for k, v in metrics.items()}
        rec["round"] = self.round_id
        self.history.append(rec)
        if self.ckpt and self.round_id % self.checkpoint_every == 0:
            self.ckpt.submit(self.round_id, self.params)
        return rec


def check_ranks_agree(mesh, tree) -> None:
    """Refuse unless every rank of ``mesh`` holds the same ``tree``, by
    per-leaf checksums: the fp64 sum of its values and the int64 sum of
    its words, each all-reduced with its negation under MAX (equal on
    every rank exactly when the max is the min)."""
    leaves = tree_leaves(tree)
    words = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    for what, sums in (
            ("values", torch.stack([l.sum(dtype=torch.float64)
                                    for l in leaves])),
            ("words", torch.stack([
                l.view(words[l.element_size()]).sum(dtype=torch.int64)
                for l in leaves]))):
        both = torch.cat([sums, -sums])
        mesh.wire.all_reduce([both], torch.distributed.group.WORLD,
                             "init_check", op=torch.distributed.ReduceOp.MAX)
        hi, lo = both[:len(leaves)], -both[len(leaves):]
        if not torch.equal(hi, lo):
            bad = int((hi != lo).nonzero()[0])
            raise RuntimeError(
                f"the ranks drew different params: leaf {bad}'s {what} "
                "checksum differs between ranks")
