"""RemoteRuntime — the multi-node Runtime the unchanged RoundDriver drives.

One ``RemoteRuntime`` fronts a fleet of :mod:`netd` daemons.  It
implements the full :class:`~repro_torch.runtime.driver.Runtime` protocol
(``spawn_aggregator`` / ``deliver`` / ``poll_events`` / ``quiesce`` +
store plumbing), so ``RoundDriver.run_round`` — and therefore
``FederatedTrainer`` and ``Session`` — runs a cross-node hierarchical
round with **zero new round-loop code**:

  * ``put_update`` stages the flat update locally (one reference, no
    copy); ``deliver`` serializes it once into the owning node's store
    (the node-boundary copy) and the node's intra-node path stays
    zero-copy shared memory;
  * mid-aggregators run on their home nodes (``mid@<node>`` routes to
    the daemon named ``<node>``); only the sealed partial Σ c·u comes
    back over the wire (``fetch``), one model-size payload per node
    per round, for the driver's top fold;
  * a dead daemon (EOF/reset/send failure) becomes one ``NodeLost``
    plus one synthesized ``WorkerCrashed`` per open subtree routed
    there — the driver's existing crash re-dispatch then replays the
    staged update keys, which this runtime re-routes to a surviving
    node.  Dead-peer teardown releases every in-flight bookkeeping
    entry for that node (delivered-key sets, partial homes) so nothing
    leaks with the peer.

Staged updates live until the driver's end-of-round ``discard_update``
sweep, which is exactly what makes crash re-dispatch to a *different*
node possible: ``update_alive`` answers from the staging dict, not the
dead node's store.
"""
from __future__ import annotations

import json
import select
import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Set

import numpy as np

from repro_torch.core.objectstore import new_object_key
from repro_torch.core.sidecar import MetricsMap
from repro_torch.runtime.driver import _WarmEngineMixin
from repro_torch.runtime.events import (
    NodeLost,
    NodeRejoined,
    PartialReady,
    RoundEvent,
    WorkerCrashed,
    from_wire,
)
from repro_torch.runtime.netrt.transport import (
    Backoff,
    Frame,
    FrameConn,
    PeerDead,
    connect,
    resolve_dtype,
)


class NoLiveNodeError(ConnectionError):
    """Every node daemon of this runtime is unreachable."""


class BusyError(RuntimeError):
    """The serving side kept shedding this submission (admission
    backpressure) past the client's patience — carries the server's
    last ``retry_after_s`` hint for an outer scheduler to honor."""

    def __init__(self, msg: str, *, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class _Node:
    """Controller-side state for one netd peer."""

    __slots__ = ("name", "addr", "conn", "capacity", "workers", "alive",
                 "delivered", "stats", "runtime_name", "epoch",
                 "store_prefix", "telemetry")

    def __init__(self, name: str, addr: str, conn: FrameConn,
                 capacity: float, runtime_name: str, epoch: int = 0,
                 store_prefix: str = ""):
        self.name = name
        self.addr = addr
        self.conn = conn
        self.capacity = capacity
        self.runtime_name = runtime_name
        self.epoch = epoch                 # welcome's restart counter
        self.store_prefix = store_prefix   # its /dev/shm name space
        self.workers = 0
        self.alive = True
        self.delivered: Set[str] = set()   # keys resident in its store
        self.stats: Dict[str, float] = {}  # last quiesced totals
        # accumulated drained telemetry ("owner/metric" → [sum, count]);
        # emptied by RemoteRuntime.take_telemetry (the trace grab)
        self.telemetry: Dict[str, List[float]] = {}


class RemoteRuntime(_WarmEngineMixin):
    """The cross-node aggregation runtime (see module docstring)."""

    name = "net"

    def __init__(self, nodes: Iterable[str], *,
                 metrics: Optional[MetricsMap] = None,
                 agg_engine: Any = "auto",
                 connect_timeout: float = 10.0,
                 compress: Any = 0,
                 readopt: bool = True,
                 readopt_timeout: float = 0.5,
                 fault_plan: Any = None):
        self.metrics = metrics if metrics is not None else MetricsMap()
        self.agg_engine = agg_engine
        # zlib level for outbound update/partial blobs; the hello meta
        # carries it so the daemon compresses its replies too
        self.compress = 6 if compress is True else int(compress or 0)
        # re-adoption: probe dead nodes' addresses (jittered backoff)
        # on every poll — a daemon restarted under its old node name
        # re-registers via the welcome handshake and rejoins the fleet
        self.readopt = bool(readopt)
        self.readopt_timeout = float(readopt_timeout)
        self.fault_plan = fault_plan   # faults.FaultPlan (chaos tests)
        self._engines: Dict[str, Any] = {}    # driver-side (top) engines
        self._staged: Dict[str, np.ndarray] = {}
        self._route: Dict[str, str] = {}      # agg_id → node name
        self._open: Dict[str, int] = {}       # agg_id → spawn round_id
        self._partial_home: Dict[str, str] = {}
        self._pending: Deque[RoundEvent] = deque()
        self._local = {"node_lost": 0, "synth_crashes": 0, "refused": 0,
                       "readopted": 0, "epoch_bumps": 0}
        self._readopt_bo: Dict[str, Backoff] = {}   # dead node → schedule
        self._readopt_next: Dict[str, float] = {}   # dead node → next try
        self._closed = False
        self._nodes: Dict[str, _Node] = {}
        addrs = list(nodes)
        if not addrs:
            raise ValueError("RemoteRuntime needs at least one node address")
        for addr in addrs:
            self._attach(addr, connect_timeout)

    # ------------------------------------------------------------------
    # connection management
    # ------------------------------------------------------------------
    def _attach(self, addr: str, timeout: float) -> None:
        conn = connect(addr, timeout=timeout, compress=self.compress,
                       faults=self.fault_plan)
        conn.send("hello", {"role": "controller", "proto": 1,
                            "compress": self.compress})
        stash: List[Frame] = []
        w = conn.recv_expect(("welcome",), timeout, stash=stash).meta
        node = _Node(w["node"], addr, conn, float(w.get("capacity", 20.0)),
                     w.get("runtime", "?"), epoch=int(w.get("epoch", 0)),
                     store_prefix=w.get("store_prefix", "") or "")
        if node.name in self._nodes:
            conn.close()
            raise ValueError(f"duplicate node name {node.name!r} "
                             f"({addr} vs {self._nodes[node.name].addr})")
        self._nodes[node.name] = node

    # ------------------------------------------------------------------
    # re-adoption of restarted daemons
    # ------------------------------------------------------------------
    def try_readopt(self, force: bool = False) -> List[str]:
        """One re-adoption pass over the dead nodes: re-dial each one's
        recorded address (non-blocking-ish: a single connect attempt
        per node, paced by a per-node jittered backoff unless
        ``force``), re-run the welcome handshake, and re-adopt a daemon
        that answers under the old node name.  The epoch counter in the
        welcome tells a restarted process (epoch bump — its store is
        empty, so residency is cleared and staged keys re-ship on the
        driver's re-dispatch) from a transient disconnect (same epoch —
        the daemon parked and swept when we vanished, so the controller
        treats both identically).  Dead-epoch teardown itself already
        ran in ``_lose_node``; re-adoption only has to bring the node
        back.  Returns the re-adopted node names; a ``NodeRejoined``
        event per adoption reaches the driver on the next poll."""
        if not self.readopt or self._closed:
            return []
        adopted: List[str] = []
        now = time.perf_counter()
        for node in self._nodes.values():
            if node.alive:
                continue
            if not force and now < self._readopt_next.get(node.name, 0.0):
                continue
            bo = self._readopt_bo.setdefault(
                node.name, Backoff(base=0.2, cap=2.0))
            try:
                # single dial (deadline_s=0 disables connect's retry
                # loop): a refused port must cost one syscall, not a
                # blocking retry window inside poll_events
                conn = connect(node.addr, timeout=self.readopt_timeout,
                               compress=self.compress,
                               faults=self.fault_plan,
                               backoff=Backoff(deadline_s=0.0))
                conn.send("hello", {"role": "controller", "proto": 1,
                                    "compress": self.compress})
                w = conn.recv_expect(
                    ("welcome",), max(self.readopt_timeout, 2.0)).meta
            except PeerDead:
                self._readopt_next[node.name] = \
                    time.perf_counter() + (bo.next_delay() or bo.cap)
                continue
            if w.get("node") != node.name:
                # the address answers, but it isn't our daemon anymore
                conn.close()
                self._readopt_next[node.name] = \
                    time.perf_counter() + (bo.next_delay() or bo.cap)
                continue
            self._adopt(node, conn, w)
            adopted.append(node.name)
        return adopted

    def _adopt(self, node: _Node, conn: FrameConn, w: Dict) -> None:
        old_epoch = node.epoch
        old_prefix = node.store_prefix
        node.conn = conn
        node.alive = True
        node.capacity = float(w.get("capacity", node.capacity))
        node.runtime_name = w.get("runtime", node.runtime_name)
        node.epoch = int(w.get("epoch", 0))
        node.store_prefix = w.get("store_prefix", "") or ""
        # whatever epoch we got, the daemon-side store owes us nothing:
        # a restarted process is empty, a parked one swept on our
        # disconnect — every staged key re-ships its blob on demand
        node.delivered.clear()
        self._readopt_bo.pop(node.name, None)
        self._readopt_next.pop(node.name, None)
        self._local["readopted"] += 1
        if node.epoch != old_epoch:
            self._local["epoch_bumps"] += 1
            if old_prefix and old_prefix != node.store_prefix:
                # a fresh process under the old name: its predecessor
                # died without atexit (SIGKILL), so the old epoch's shm
                # segments are orphans — reclaim the whole name space.
                # Best-effort: on a remote host the names simply don't
                # exist in our /dev/shm and nothing happens.
                from repro_torch.core.objectstore import sweep_dead_segments

                swept = sweep_dead_segments(old_prefix)
                if swept:
                    self._local["swept_segments"] = (
                        self._local.get("swept_segments", 0) + swept)
        self._pending.append(NodeRejoined(
            node=node.name, epoch=node.epoch, old_epoch=old_epoch,
            capacity=node.capacity))

    def _alive(self) -> List[_Node]:
        return [n for n in self._nodes.values() if n.alive]

    @property
    def _net_sidecar(self):
        """Wire-traffic sidecar (``net/tx_bytes``/``net/rx_bytes`` in
        ``Session.metrics()``).  Lazy: Session re-points ``metrics`` at
        the trainer's map after construction, so the sidecar must bind
        at first use, not in ``__init__``."""
        sc = self.__dict__.get("_net_sidecar_inst")
        if sc is None or sc.metrics is not self.metrics:
            from repro_torch.core.sidecar import EventSidecar

            sc = EventSidecar("net", self.metrics)
            self.__dict__["_net_sidecar_inst"] = sc
        return sc

    def node_info(self) -> Dict[str, float]:
        """name → capacity (MC_i), in daemon-connection order — feeds
        the controller's placement model."""
        return {n.name: n.capacity for n in self._nodes.values()}

    def _lose_node(self, node: _Node, why: str = "") -> List[RoundEvent]:
        """Dead-peer teardown: close, release the node's in-flight round
        state, surface NodeLost + one synthetic WorkerCrashed per open
        subtree so the driver re-dispatches to a survivor."""
        if not node.alive:
            return []
        node.alive = False
        node.conn.close()
        self._local["node_lost"] += 1
        # fresh re-adoption schedule: the first probe may run at the
        # very next poll (a rolling restart should rejoin quickly)
        self._readopt_bo.pop(node.name, None)
        self._readopt_next.pop(node.name, None)
        evs: List[RoundEvent] = [NodeLost(node=node.name)]
        # its store died with it: partials homed there are unreachable
        for key, home in list(self._partial_home.items()):
            if home == node.name:
                del self._partial_home[key]
        node.delivered.clear()
        for agg_id, name in list(self._route.items()):
            if name != node.name:
                continue
            del self._route[agg_id]
            rid = self._open.pop(agg_id, None)
            if rid is not None:
                self._local["synth_crashes"] += 1
                evs.append(WorkerCrashed(round_id=rid, agg_id=agg_id,
                                         worker=-1, exitcode=None))
        return evs

    def _send(self, node: _Node, kind: str, meta: Dict,
              blob: bytes = b"") -> bool:
        """Best-effort send; a dead peer is torn down (events queued for
        the next poll) and the send reports failure."""
        if not node.alive:
            return False
        try:
            node.conn.send(kind, meta, blob=blob)
            return True
        except PeerDead as e:
            self._pending.extend(self._lose_node(node, str(e)))
            return False

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _resolve(self, agg_id: str) -> _Node:
        """Home node for a subtree: ``mid@<node>`` prefers ``<node>``;
        a lost home falls back to the first surviving node (the crash
        re-dispatch path)."""
        name = self._route.get(agg_id)
        if name is not None:
            node = self._nodes.get(name)
            if node is not None and node.alive:
                return node
        home = agg_id.split("@", 1)[-1]
        node = self._nodes.get(home)
        if node is None or not node.alive:
            live = self._alive()
            if not live:
                # last resort before giving up the round: a restarted
                # daemon may already be listening again — force one
                # re-adoption pass (ignores the backoff pacing)
                self.try_readopt(force=True)
                live = self._alive()
                if not live:
                    raise NoLiveNodeError("all node daemons are unreachable")
            node = live[0]
        self._route[agg_id] = node.name
        return node

    # ------------------------------------------------------------------
    # Runtime protocol
    # ------------------------------------------------------------------
    def spawn_aggregator(self, agg_id: str, *, goal: int, n_elems: int,
                         round_id: int = 0, kind: str = "mid") -> None:
        # "agg_kind", not "kind": the frame codec owns the meta key
        # "kind" (it is the frame type itself)
        meta = {"agg_id": agg_id, "goal": goal, "n_elems": n_elems,
                "round_id": round_id, "agg_kind": kind}
        # each failed send tears one dead node down, so this walks the
        # survivors and terminates: _resolve raises NoLiveNodeError
        # once nobody is left
        while not self._send(self._resolve(agg_id), "spawn", meta):
            pass
        self._open[agg_id] = round_id

    def deliver(self, agg_id: str, key: str, weight: float,
                round_id: int = 0) -> None:
        node = self._resolve(agg_id)
        meta = {"agg_id": agg_id, "key": key, "weight": weight,
                "round_id": round_id}
        if key in node.delivered:
            # the store already holds it: 16-byte key, no payload
            self._send(node, "deliver", meta)
            return
        flat = self._staged[key]
        meta["dtype"] = str(flat.dtype)
        meta["shape"] = list(flat.shape)
        # a failed send is NOT an error: the teardown queued a synthetic
        # WorkerCrashed, and the driver replays this key from staging
        if self._send(node, "deliver", meta, blob=flat):
            node.delivered.add(key)
            self._net_sidecar.on_send(flat.nbytes)

    def deliver_partial(self, agg_id: str, key: str, weight: float,
                        count: int, round_id: int = 0, seq: int = 0) -> None:
        """Route a published partial into the node-side root fold.

        A partial homed on the root node is delivered by key alone (its
        bytes never move); one homed elsewhere triggers daemon→daemon
        shipping — the home daemon dials the root and sends the sealed
        Σ c·u directly, so the controller never carries it.  Any
        failure surfaces as a :class:`WorkerCrashed` for the root fold,
        which the driver answers by re-rooting."""
        root = self._resolve(agg_id)
        meta = {"agg_id": agg_id, "key": key, "weight": float(weight),
                "count": int(count), "seq": int(seq),
                "round_id": round_id, "partial": True}
        home_name = self._partial_home.get(key)
        home = self._nodes.get(home_name) if home_name else None
        if home is None or not home.alive:
            # lost between the driver's liveness filter and this send:
            # the root fold can never complete — tell the driver now
            self._local["synth_crashes"] += 1
            self._pending.append(WorkerCrashed(
                round_id=round_id, agg_id=agg_id, worker=-1))
            return
        if home_name == root.name:
            # resident on the root already: 16-byte key, no payload.
            # A send failure means the ROOT died — _lose_node already
            # queued the root fold's WorkerCrashed (it is in _open).
            self._send(root, "deliver", meta)
            return
        meta["peer"] = root.addr
        meta["dst"] = root.name
        if not self._send(home, "ship_partial", meta):
            # the home died mid-ship: its teardown only covers subtrees
            # routed *there* — the root fold is routed to the root, so
            # surface its crash explicitly
            self._local["synth_crashes"] += 1
            self._pending.append(WorkerCrashed(
                round_id=round_id, agg_id=agg_id, worker=-1))

    def partial_alive(self, key: str) -> bool:
        home = self._partial_home.get(key)
        node = self._nodes.get(home) if home else None
        return node is not None and node.alive

    def partial_node(self, key: str) -> Optional[str]:
        return self._partial_home.get(key)

    def drain(self, agg_id: str) -> None:
        name = self._route.get(agg_id)
        node = self._nodes.get(name) if name else None
        if node is not None:
            self._send(node, "drain", {"agg_id": agg_id})

    def poll_events(self, timeout: float = 0.0) -> List[RoundEvent]:
        # restarted daemons rejoin through the ordinary poll loop: the
        # probe is backoff-paced per dead node, so a fleet with no
        # deaths pays one attribute check per node here
        self.try_readopt()
        out: List[RoundEvent] = list(self._pending)
        self._pending.clear()
        deadline = time.perf_counter() + timeout
        while True:
            live = self._alive()
            if not live:
                return out
            budget = 0.0 if out else max(0.0, deadline - time.perf_counter())
            try:
                r, _, _ = select.select([n.conn for n in live], [], [],
                                        budget)
            except (OSError, ValueError):
                r = [n.conn for n in live]  # a racing close: probe each
            progressed = False
            for node in live:
                if node.conn not in r:
                    continue
                try:
                    while True:
                        frame = node.conn.recv(timeout=0.0)
                        if frame is None:
                            break
                        progressed = True
                        ev = self._absorb_frame(node, frame)
                        if ev is not None:
                            out.append(ev)
                except PeerDead:
                    out.extend(self._lose_node(node))
                    progressed = True
            if out or not progressed and time.perf_counter() >= deadline:
                return out

    def _absorb_frame(self, node: _Node, frame: Frame
                      ) -> Optional[RoundEvent]:
        if frame.kind == "event":
            ev = from_wire(json.dumps(frame.meta))
            self._note(node, ev)
            return ev
        if frame.kind == "error":
            self._local["refused"] += 1
            agg_id = frame.meta.get("agg_id", "")
            key = frame.meta.get("key", "")
            if frame.meta.get("for") == "deliver" and key:
                # the blob never landed in the node store: forget the
                # residency so any re-delivery re-ships it (the update
                # itself is lost to this subtree — the drain closes it
                # with the folds at hand, like a failed client)
                for n in self._nodes.values():
                    n.delivered.discard(key)
            # a daemon-side SPAWN failure must not hang the round: no
            # aggregator exists, so nothing will ever publish — surface
            # it as a WorkerCrashed so the driver's re-dispatch (or its
            # give-up cap) takes over.  Deliver/drain errors must NOT
            # synthesize a crash: the daemon aggregator is still alive
            # and open, and a respawn+re-deliver would double-fold its
            # already-delivered keys.
            if frame.meta.get("for") == "spawn" and agg_id in self._open:
                rid = self._open.pop(agg_id)
                self._route.pop(agg_id, None)
                self._local["synth_crashes"] += 1
                return WorkerCrashed(round_id=rid, agg_id=agg_id,
                                     worker=-1, exitcode=None)
            # a failed ship (home daemon couldn't read the partial or
            # dial the root) starves the root fold of one input — it
            # will never publish, so surface its crash; the driver
            # re-roots on a survivor
            if frame.meta.get("for") == "ship_partial" \
                    and agg_id in self._open:
                rid = self._open.pop(agg_id)
                self._local["synth_crashes"] += 1
                return WorkerCrashed(round_id=rid, agg_id=agg_id,
                                     worker=-1, exitcode=None)
        return None  # stray pong / late reply: bookkeeping only

    def _note(self, node: _Node, ev: RoundEvent) -> None:
        if isinstance(ev, PartialReady):
            self._partial_home[ev.key] = node.name
            self._open.pop(ev.agg_id, None)

    def quiesce(self, timeout: float = 5.0,
                round_id: Optional[int] = None) -> None:
        """Fleet-wide settle barrier.  With ``round_id`` the barrier is
        scoped: each daemon quiesces only that round's tasks and
        root-fold buffers, so a rolling round can settle while the next
        one keeps dispatching (the driver passes the scope whenever
        another round is in flight)."""
        self._flush_round_scoped_pending()
        # a genuinely dead daemon surfaces as an immediate EOF/reset;
        # the timeout only fires for a connected-but-busy one (a shm
        # node draining model-size accumulators can take a while), so
        # the reply budget is deliberately generous — declaring a slow
        # healthy node dead would remove it from the fleet for good
        reply_timeout = max(timeout, 60.0)
        scope = {} if round_id is None else {"round_id": int(round_id)}
        for node in self._alive():
            if not self._send(node, "quiesce", scope):
                continue
            try:
                stash: List[Frame] = []
                reply = node.conn.recv_expect(("quiesced",), reply_timeout,
                                              stash=stash)
                for f in stash:
                    ev = self._absorb_frame(node, f)
                    if ev is not None:
                        self._pending.append(ev)
                node.stats = dict(reply.meta.get("stats", {}))
                # daemon-level counters (ship_tx_bytes & co) ride along
                # so bench_net can bound inter-node partial shipping
                node.stats.update(reply.meta.get("daemon", {}))
                node.workers = int(reply.meta.get("workers", 0))
                # the LIFL-agent drain: the daemon's MetricsMap rides
                # the quiesced reply (no extra round trip) — merge it
                self._absorb_telemetry(node,
                                       reply.meta.get("telemetry") or {},
                                       reply.meta.get("telemetry_hists"))
            except PeerDead:
                self._pending.extend(self._lose_node(node))
        self._open.clear()
        # a peer death during the barrier queued fresh events: apply
        # the same round-scoped filtering to those too
        self._flush_round_scoped_pending()

    # ------------------------------------------------------------------
    # telemetry (the controller side of the LIFL agent)
    # ------------------------------------------------------------------
    def _absorb_telemetry(self, node: _Node,
                          series: Dict[str, List[float]],
                          hists: Optional[Dict[str, dict]] = None) -> None:
        """One daemon drain landed: accumulate it on the node record
        (for the round trace) and merge it into the controller's
        MetricsMap under node-prefixed owners, counts intact.  Drained
        distribution histograms (if the daemon sent any) merge the same
        way — node-prefixed, bucket counts added."""
        if hists:
            try:
                self.metrics.absorb_hists(hists, prefix=f"{node.name}.")
            except (ValueError, KeyError, TypeError):
                pass   # malformed/mismatched wire hist must not kill a drain
        if not series:
            return
        acc = node.telemetry
        for k, sc in series.items():
            try:
                s, c = float(sc[0]), int(sc[1])
            except (TypeError, ValueError, IndexError):
                continue
            cur = acc.setdefault(k, [0.0, 0])
            cur[0] += s
            cur[1] += c
        self.metrics.absorb_series(series, prefix=f"{node.name}.")

    def take_telemetry(self) -> Dict[str, Dict[str, List[float]]]:
        """Return-and-clear the accumulated per-node telemetry — the
        driver grabs this when it seals a :class:`RoundTrace`, so each
        round's trace carries exactly the samples drained since the
        previous grab."""
        out = {n.name: dict(n.telemetry)
               for n in self._nodes.values() if n.telemetry}
        for n in self._nodes.values():
            n.telemetry = {}
        return out

    def pull_telemetry(self, node: Optional[str] = None,
                       timeout: float = 5.0
                       ) -> Dict[str, Dict[str, List[float]]]:
        """On-demand drain (outside the quiesce barrier): ask each live
        daemon — or just ``node`` — for its MetricsMap via the
        ``telemetry`` frame.  The drained series are merged exactly
        like a quiesce drain and also returned per node."""
        peers = [self._nodes[node]] if node else self._alive()
        pulled: Dict[str, Dict[str, List[float]]] = {}
        for n in peers:
            if not n.alive or not self._send(n, "telemetry", {}):
                continue
            stash: List[Frame] = []
            try:
                reply = n.conn.recv_expect(("telemetry_map",), timeout,
                                           stash=stash)
            except PeerDead:
                self._pending.extend(self._lose_node(n))
                continue
            finally:
                for f in stash:
                    ev = self._absorb_frame(n, f)
                    if ev is not None:
                        self._pending.append(ev)
            series = reply.meta.get("telemetry") or {}
            self._absorb_telemetry(n, series,
                                   reply.meta.get("telemetry_hists"))
            pulled[n.name] = series
        return pulled

    def poll_stats(self, node: Optional[str] = None, timeout: float = 5.0
                   ) -> Dict[str, Dict[str, Any]]:
        """Live scrape (the agent's periodic pull, answerable
        mid-round): ask each live daemon — or just ``node`` — for its
        ``stats`` frame.  NON-destructive, unlike :meth:`pull_telemetry`:
        the reply is a snapshot (series + hist wire dicts + health
        gauges + uptime/epoch), so scraping never steals samples from
        the round-edge drain.  Nothing is merged into the controller
        map — a snapshot absorbed repeatedly would double-count."""
        peers = [self._nodes[node]] if node else self._alive()
        out: Dict[str, Dict[str, Any]] = {}
        for n in peers:
            if not n.alive or not self._send(n, "stats", {}):
                continue
            stash: List[Frame] = []
            t0 = time.perf_counter()
            try:
                reply = n.conn.recv_expect(("stats_reply",), timeout,
                                           stash=stash)
            except PeerDead:
                self._pending.extend(self._lose_node(n))
                continue
            finally:
                for f in stash:
                    ev = self._absorb_frame(n, f)
                    if ev is not None:
                        self._pending.append(ev)
            self.metrics.observe("wire", "stats_rtt_s",
                                 time.perf_counter() - t0)
            out[n.name] = dict(reply.meta)
        return out

    def _flush_round_scoped_pending(self) -> None:
        """Drop queued round-scoped leftovers at the inter-round
        barrier — a queued-but-undelivered PartialReady would strand
        its remote store object (mirror of InProcRuntime.quiesce) and
        a WorkerCrashed for the closed round would spuriously
        re-dispatch next round's identically-named subtree — while
        KEEPING cluster-state events (NodeLost) that the driver's
        handlers must still see."""
        keep: List[RoundEvent] = []
        for ev in self._pending:
            if isinstance(ev, PartialReady):
                self.discard_partial(ev.key)
            elif isinstance(ev, WorkerCrashed):
                pass  # its round is over; nothing left to re-dispatch
            else:
                keep.append(ev)
        self._pending.clear()
        self._pending.extend(keep)

    # ------------------------------------------------------------------
    # payload plumbing
    # ------------------------------------------------------------------
    def put_update(self, flat: np.ndarray) -> str:
        key = new_object_key()
        self._staged[key] = np.ascontiguousarray(flat)
        return key

    def update_alive(self, key: str) -> bool:
        # staging, not the (possibly dead) node's store, answers: this
        # is what lets a subtree re-dispatch to a *different* node
        return key in self._staged

    def get_partial(self, key: str) -> np.ndarray:
        home = self._partial_home.get(key)
        node = self._nodes.get(home) if home else None
        if node is None or not node.alive:
            raise KeyError(f"partial {key!r} unreachable (node lost)")
        # event frames racing the reply (a straggler's PartialReady
        # publishing mid-FOLD) must reach _pending, not the floor —
        # a dropped one would strand its sealed object in the node
        # store (nobody left to discard it)
        stash: List[Frame] = []
        try:
            node.conn.send("fetch", {"key": key})
            while True:
                frame = node.conn.recv_expect(("object", "error"), 30.0,
                                              stash=stash)
                if frame.kind == "error":
                    raise KeyError(
                        f"fetch {key!r} failed: {frame.meta['msg']}")
                if frame.meta.get("key") == key:
                    break
        except PeerDead as e:
            # the node died between publishing and the fetch: run the
            # full teardown (NodeLost reaches the driver's handlers on
            # the next poll) and abort the round's fold — run_round's
            # exception path closes the round retriable
            self._pending.extend(self._lose_node(node))
            raise KeyError(
                f"partial {key!r} lost with its node ({e})") from e
        finally:
            for f in stash:
                ev = self._absorb_frame(node, f)
                if ev is not None:
                    self._pending.append(ev)
        arr = np.frombuffer(
            frame.blob, dtype=resolve_dtype(frame.meta["dtype"]),
        ).reshape(frame.meta["shape"])
        self._net_sidecar.on_recv(arr.nbytes, 0.0)
        return arr

    def release_partial(self, key: str) -> None:
        pass  # the fetched copy is local; the daemon released at fetch

    def discard_partial(self, key: str) -> None:
        home = self._partial_home.pop(key, None)
        node = self._nodes.get(home) if home else None
        if node is not None and node.alive:
            self._send(node, "discard_partial", {"key": key})

    def discard_update(self, key: str) -> None:
        self._staged.pop(key, None)
        for node in self._alive():
            if key in node.delivered:
                node.delivered.discard(key)
                self._send(node, "discard_update", {"key": key})

    # ------------------------------------------------------------------
    def recycle_engines(self) -> None:
        super().recycle_engines()
        for node in self._alive():
            self._send(node, "recycle", {})

    @property
    def stats(self) -> Dict[str, float]:
        """Aggregated monotonic counters: the sum of every node's last
        quiesced totals plus local transport counters."""
        out: Dict[str, float] = dict(self._local)
        for node in self._nodes.values():
            for k, v in node.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def worker_count(self) -> int:
        return sum(n.workers for n in self._alive())

    def wire_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-node transport byte counters (bench_net's raw input)."""
        out = {}
        for node in self._nodes.values():
            out[node.name] = {
                "tx_bytes": node.conn.tx_bytes,
                "rx_bytes": node.conn.rx_bytes,
                "tx_by_kind": dict(node.conn.tx_by_kind),
                "rx_by_kind": dict(node.conn.rx_by_kind),
            }
        return out

    def ping(self, node: Optional[str] = None, timeout: float = 5.0) -> float:
        """RTT to one node (default: the first live one)."""
        peers = [self._nodes[node]] if node else self._alive()
        if not peers:
            raise NoLiveNodeError("all node daemons are unreachable")
        stash: List[Frame] = []
        rtt = peers[0].conn.ping(timeout, stash=stash)
        for f in stash:
            ev = self._absorb_frame(peers[0], f)
            if ev is not None:
                self._pending.append(ev)
        return rtt

    def shutdown_nodes(self, timeout: float = 5.0) -> None:
        """Ask every daemon to exit (bench/test teardown helper)."""
        for node in self._alive():
            if self._send(node, "shutdown", {}):
                try:
                    node.conn.recv_expect(("bye",), timeout)
                except PeerDead:
                    pass
                node.alive = False
                node.conn.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for node in self._nodes.values():
            node.conn.close()
            node.alive = False
        self._staged.clear()
        self._engines.clear()


# ---------------------------------------------------------------------------
# external-client helper (Session.serve's wire counterpart)
# ---------------------------------------------------------------------------

def push_update(addr: str, client_id: str, update: np.ndarray,
                weight: float = 1.0, *, timeout: float = 10.0,
                submission_id: Optional[str] = None,
                round_id: Optional[int] = None,
                job: str = "",
                retries: int = 2,
                busy_retries: int = 64,
                backoff: Optional[Backoff] = None) -> Dict:
    """Submit one externally-computed model update to a serving
    :class:`~repro_torch.api.Session` (``Session.serve(addr)``) or
    :class:`~repro_torch.serve.AggregationService` from any process.
    Returns the server's ack meta; raises on rejection.

    Transport failures (connect refused, the connection dying before
    the ack) are retried up to ``retries`` times on the shared
    jittered-exponential :class:`Backoff` schedule, and every attempt
    carries the same ``submission_id`` (client-chosen, or generated
    once per call) — the serving session dedupes on
    ``(round_id, client_id, submission_id)``, so a retry racing an
    ack that was sent but never read can never double-fold (its ack
    comes back ``duplicate=True`` instead).

    Admission backpressure (a ``busy`` frame carrying
    ``retry_after_s``) is not a failure: the client sleeps the
    *server's* hint via :meth:`Backoff.sleep_hint` — the exponential
    schedule doesn't advance — and resubmits, up to ``busy_retries``
    times or the backoff's ``deadline_s``.  The final ack meta carries
    ``shed``: how many times this submission was pushed back before it
    landed.  An explicit *rejection* (``error`` frame: wrong size,
    stale ``round_id``) raises ``ValueError`` immediately — retrying a
    refusal cannot succeed."""
    flat = np.ascontiguousarray(update)
    if submission_id is None:
        submission_id = new_object_key()
    meta = {"client_id": client_id, "weight": float(weight),
            "submission_id": submission_id,
            "dtype": str(flat.dtype), "shape": list(flat.shape)}
    if round_id is not None:
        meta["round_id"] = int(round_id)
    if job:
        meta["job"] = job     # multi-job service routing (repro_torch.serve)
    bo = backoff if backoff is not None else Backoff(base=0.1, cap=1.0)
    attempt = 0
    sheds = 0
    while True:
        try:
            conn = connect(addr, timeout=timeout)
            try:
                conn.send("hello", {"role": "client"})
                conn.recv_expect(("welcome",), timeout)
                conn.send("submit_update", meta, blob=flat)
                reply = conn.recv_expect(("ack", "error", "busy"),
                                         timeout)
            finally:
                conn.close()
            if reply.kind == "error":
                raise ValueError(
                    f"submit_update rejected: {reply.meta['msg']}")
            if reply.kind == "busy":
                sheds += 1
                hint = reply.meta.get("retry_after_s", 0.05)
                if sheds > busy_retries or not bo.sleep_hint(hint):
                    raise BusyError(
                        f"submit_update shed {sheds} times by {addr} "
                        f"(queued={reply.meta.get('queued')}); giving "
                        f"up", retry_after_s=hint)
                continue
            out = dict(reply.meta)
            out["shed"] = sheds
            return out
        except PeerDead:
            attempt += 1
            if attempt > retries or not bo.sleep():
                raise
