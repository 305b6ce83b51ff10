"""netd — the per-node daemon of the multi-node transport.

One netd process runs on each worker node.  It owns that node's *local*
aggregation runtime — ``InProcRuntime`` or (the real deployment)
``ShmProcRuntime`` with its forked workers and shared-memory rings —
and exposes it over the frame transport (``transport.py``): a
controller's :class:`~repro_torch.runtime.netrt.remote.RemoteRuntime` speaks
the same ``spawn``/``deliver``/``drain``/``quiesce`` verbs the
``RoundDriver`` already uses, and typed round events travel back as
``events.to_wire`` JSON riding ``event`` frames.

Data-plane contract (the reason this layer exists):

  * a leaf update is serialized **once**, at the node boundary — the
    ``deliver`` frame's blob lands in the node's object store under the
    controller-chosen key, and every intra-node hop after that is the
    usual zero-copy shared-memory path;
  * a re-delivery of a key the store already holds (crash re-dispatch
    to the same node) ships **no blob** — just the 16-byte key;
  * only the sealed partial Σ c·u leaves the node, when the controller
    ``fetch``es it for the top fold: one model-size payload per node
    per round.

Run it::

    python -m repro_torch.runtime.netrt.netd --node nodeA \
        --listen 127.0.0.1:0 --runtime shmproc --port-file /tmp/a.addr

The daemon is single-threaded: one loop multiplexes the socket server
and the local runtime's event queue.  SIGTERM/SIGINT drain gracefully
(the local runtime shuts down, shm segments are unlinked).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import weakref
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.engine import EngineConfig
from repro_torch.core.sidecar import MetricsMap, series_flatten
from repro_torch.device import resolve_device
from repro_torch.kernels.fedavg.fedavg import KERNELS as FOLD_KERNELS
from repro_torch.runtime.driver import make_runtime
from repro_torch.runtime.events import (
    PartialReady,
    PartialShipped,
    RoundEvent,
    WorkerCrashed,
    to_wire,
)
from repro_torch.runtime.netrt.faults import FaultPlan
from repro_torch.runtime.netrt.transport import (
    Backoff,
    Frame,
    FrameConn,
    FrameServer,
    PeerDead,
    connect,
    resolve_dtype,
)

PROTO_VERSION = 1

# shmproc aggregator workers are fork()ed while the daemon holds its
# listening socket and every accepted/peer connection.  Without
# intervention the workers inherit those fds: SIGKILL the daemon and
# the orphaned workers keep the port bound (a same-port restart can't
# bind → re-adoption is impossible) and keep the controller's TCP
# connections ESTABLISHED (dead-peer EOF never fires).  Every live
# daemon registers here and an at-fork hook closes its sockets in the
# child, so only the daemon process itself ever owns them.
_LIVE_DAEMONS: "weakref.WeakSet" = weakref.WeakSet()


def _at_fork_close_daemon_sockets() -> None:
    for d in list(_LIVE_DAEMONS):
        try:
            d._close_inherited_sockets()
        except Exception:
            pass


os.register_at_fork(after_in_child=_at_fork_close_daemon_sockets)


class NodeDaemon:
    """One node's frame-server front end over a local runtime."""

    def __init__(self, node: str, listen: str = "127.0.0.1:0", *,
                 runtime: str = "inproc", agg_engine: str = "auto",
                 capacity: float = 20.0, poll_interval: float = 0.02,
                 compress: int = 0, fault_plan: Optional[FaultPlan] = None,
                 device: Optional[str] = None):
        self.node = node
        # the card unless the caller names another device: a daemon on
        # a host without one fails here, at start, never folding on the
        # CPU in its place
        self.device = resolve_device(device)
        self.capacity = float(capacity)
        self.poll_interval = poll_interval
        self.compress = int(compress)
        # the re-adoption epoch: a start stamp unique across restarts
        # of this node name.  The welcome handshake carries it, so a
        # controller re-dialing a known name can tell "same daemon,
        # transient disconnect" from "fresh process, empty store".
        self.epoch = time.time_ns()
        self.t0_mono = time.perf_counter()   # uptime for live scrapes
        self.faults = fault_plan
        # the per-daemon MetricsMap — the paper's in-kernel metric map,
        # now actually living in the remote process: the local runtime's
        # sidecars, every outbound frame's per-kind timing (FrameConn),
        # and the ship/fetch/land samples below all land here, and the
        # controller drains it over the wire (quiesce / telemetry frame)
        self.metrics = MetricsMap()
        self.rt = make_runtime(runtime, agg_engine=EngineConfig(
            name=agg_engine, device=str(self.device)), metrics=self.metrics)
        self.server = FrameServer(listen, faults=fault_plan,
                                  metrics=self.metrics)
        self.addr = self.server.addr
        self._controllers: List[FrameConn] = []
        # node-top state: open root folds buffering their inputs until
        # all `goal` partials arrived (controller `deliver` + peer
        # `partial` frames race — the seq numbers fix the fold order),
        # cached peer connections, and peer-shipped copies to reclaim
        self._tops: Dict[str, Dict] = {}
        self._peers: Dict[str, FrameConn] = {}
        self._peer_landed: Set[str] = set()
        # keys whose lifetime the CONTROLLER owns: landed update blobs
        # and published-but-unfetched partials.  Swept when the last
        # controller disconnects — its delivered-set died with it, so
        # nothing will ever discard them over the wire.
        self._landed: Set[str] = set()
        self._published: Set[str] = set()
        self._stop = False
        self._closed = False
        self.stats = {"frames": 0, "events_pushed": 0, "updates_landed": 0,
                      "redelivered_keys": 0, "partials_served": 0,
                      "partials_shipped": 0, "ship_tx_bytes": 0,
                      "partials_landed": 0, "ship_rx_bytes": 0}
        _LIVE_DAEMONS.add(self)

    # ------------------------------------------------------------------
    def _close_inherited_sockets(self) -> None:
        """Runs in a freshly fork()ed child (shmproc worker): close the
        socket fds the child inherited so the daemon process is their
        sole owner — see the at-fork hook above."""
        try:
            self.server._listener.close()
        except OSError:
            pass
        for c in list(self.server.conns) + list(self._peers.values()):
            try:
                c._sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------------
    def step(self, timeout: Optional[float] = None) -> None:
        """One loop iteration: demux frames, push local runtime events."""
        for conn, frame in self.server.poll(
                self.poll_interval if timeout is None else timeout):
            if frame is None:  # peer went away (recv- or send-side)
                self._drop_controller(conn)
                continue
            self.stats["frames"] += 1
            if (self.faults is not None
                    and self.faults.kill_after is not None
                    and self.stats["frames"] >= self.faults.kill_after):
                # the FaultPlan's deterministic restart trigger: die the
                # way a crashed daemon dies (no drain, no goodbye)
                os.kill(os.getpid(), signal.SIGKILL)
            try:
                self._handle(conn, frame)
            except PeerDead:
                self._drop_controller(conn)
            except Exception as e:
                # a bad frame must not take the node down with it; the
                # agg_id/key (when present) let the controller repair
                # its bookkeeping instead of waiting forever
                try:
                    conn.send("error", {"msg": f"{type(e).__name__}: {e}",
                                        "for": frame.kind,
                                        "agg_id": frame.meta.get(
                                            "agg_id", ""),
                                        "key": frame.meta.get("key", "")})
                except PeerDead:
                    self._drop_controller(conn)
        self._push_events()

    def _drop_controller(self, conn: FrameConn) -> None:
        """A controller is gone: unregister it, and once the last one
        leaves, park the local runtime clean so a reconnecting
        controller can spawn the same agg_ids again."""
        if conn in self._controllers:
            self._controllers.remove(conn)
            if not self._controllers:
                try:
                    self.rt.quiesce()
                except Exception:
                    pass
                self._round_cleanup()
                # controller-owned objects must not outlive the
                # controller: its delivered-set and partial-home maps
                # died with the connection, so no discard frame will
                # ever reclaim these — sweep them now (a re-adopting
                # controller re-ships blobs from its staging dict)
                for key in list(self._landed):
                    try:
                        self.rt.discard_update(key)
                    except Exception:
                        pass
                for key in list(self._published):
                    try:
                        self.rt.discard_partial(key)
                    except Exception:
                        pass
                self._landed.clear()
                self._published.clear()

    def _round_cleanup(self) -> None:
        """Inter-round housekeeping for the node-top path: drop stale
        root-fold buffers and reclaim peer-shipped partial copies (the
        originals are discarded by their home's controller sweep; the
        shipped copies are ours to delete)."""
        self._tops.clear()
        for key in list(self._peer_landed):
            try:
                self.rt.discard_update(key)
            except Exception:
                pass
        self._peer_landed.clear()

    # ------------------------------------------------------------------
    # node-top: daemon→daemon partial shipping + ordered root folds
    # ------------------------------------------------------------------
    def _peer_conn(self, addr: str, timeout: float = 5.0) -> FrameConn:
        conn = self._peers.get(addr)
        if conn is not None and conn.alive:
            return conn
        conn = connect(addr, timeout=timeout, peer=addr,
                       compress=self.compress, faults=self.faults,
                       metrics=self.metrics)
        self._peers[addr] = conn
        return conn

    def _ship_partial(self, m: Dict) -> None:
        """Send our sealed partial Σ c·u to the root node's daemon.
        Raises on failure (translated below so the generic error reply
        reaches the *controller*, never misread as a controller
        death)."""
        key = m["key"]
        t_ship = time.perf_counter()
        view = self.rt.get_partial(key)
        arr = np.ascontiguousarray(view)
        meta = {"agg_id": m["agg_id"], "key": key,
                "weight": float(m["weight"]), "count": int(m["count"]),
                "seq": int(m.get("seq", 0)), "round_id": int(m["round_id"]),
                "dtype": str(arr.dtype), "shape": list(arr.shape),
                "src": self.node}
        addr = m["peer"]
        # redial on the shared backoff schedule: a stale cached conn
        # (root restarted) or a root mid-restart gets a few dense
        # probes, then the deadline surfaces the failure — the
        # controller answers by re-rooting, so a daemon must never
        # block long on a dead peer
        bo = Backoff(base=0.05, cap=0.5, deadline_s=4.0)
        try:
            while True:
                try:
                    self._peer_conn(addr, timeout=2.0).send(
                        "partial", meta, blob=arr)
                    break
                except PeerDead as e:
                    self._peers.pop(addr, None)
                    if not bo.sleep():
                        raise RuntimeError(
                            f"peer {addr} unreachable: {e}") from e
        finally:
            self.rt.release_partial(key)
        # wire_s is the whole daemon-side ship wall (serialize + redial
        # backoff + send): what the src node's uplink was busy for —
        # the sample the controller's RC model prices as ship load
        wire_s = time.perf_counter() - t_ship
        self.metrics.update("netd", "ship_s", wire_s)
        self.metrics.update("netd", "ship_bytes", float(arr.nbytes))
        self.stats["partials_shipped"] += 1
        self.stats["ship_tx_bytes"] += arr.nbytes
        self._push_event_obj(PartialShipped(
            round_id=int(m["round_id"]), agg_id=m["agg_id"], key=key,
            src=self.node, dst=m.get("dst", ""), nbytes=arr.nbytes,
            wire_s=wire_s))

    def _top_in(self, agg_id: str, key: str, weight: float, count: int,
                seq: int, round_id: int) -> None:
        t = self._tops.setdefault(
            agg_id, {"goal": None, "round_id": round_id, "buf": {}})
        t["buf"][int(seq)] = (key, weight, count)
        self._flush_top(agg_id)

    def _flush_top(self, agg_id: str) -> None:
        """All inputs at hand: fold them in seq order — arrival order
        races (controller deliver vs peer ships) never reach the
        engine, so the root fold is bit-identical wherever it runs."""
        t = self._tops.get(agg_id)
        if t is None or t["goal"] is None or len(t["buf"]) < t["goal"]:
            return
        del self._tops[agg_id]
        try:
            for seq in sorted(t["buf"]):
                key, weight, count = t["buf"][seq]
                self.rt.deliver_partial(agg_id, key, weight, count,
                                        round_id=t["round_id"], seq=seq)
        except Exception:
            # the root fold is wedged (an input vanished mid-fold): it
            # will never publish — surface its crash so the driver
            # re-roots instead of waiting forever
            self._push_event_obj(WorkerCrashed(
                round_id=t["round_id"], agg_id=agg_id, worker=-1))
            return
        self._push_events()

    def _push_events(self) -> None:
        for ev in self.rt.poll_events(0.0):
            self._push_event_obj(ev)

    def _push_event_obj(self, ev: RoundEvent) -> None:
        """Push one typed event to every controller (``to_wire`` JSON
        riding an ``event`` frame)."""
        if isinstance(ev, PartialReady):
            # published partials are controller-owned from here on;
            # swept at controller-disconnect if never fetched/discarded
            self._published.add(ev.key)
        self.stats["events_pushed"] += 1
        payload = json.loads(to_wire(ev))
        for conn in list(self._controllers):
            if not conn.alive:
                continue  # server.poll emits (conn, None) next tick
            try:
                conn.send("event", payload)
            except PeerDead:
                pass  # ditto: the park-clean path runs via poll

    # ------------------------------------------------------------------
    def _handle(self, conn: FrameConn, frame: Frame) -> None:
        kind, m = frame.kind, frame.meta
        if kind == "hello":
            if m.get("role", "controller") == "controller":
                if conn not in self._controllers:
                    self._controllers.append(conn)
            # mirror the controller's compression choice on our replies
            conn.compress = int(m.get("compress", 0) or 0)
            conn.send("welcome", {
                "node": self.node, "proto": PROTO_VERSION,
                "capacity": self.capacity, "runtime": self.rt.name,
                "pid": os.getpid(), "epoch": self.epoch,
                # the shm name space this process owns (shmproc only):
                # whoever learns this daemon died can reclaim every
                # segment under it — atexit never runs after SIGKILL
                "store_prefix": getattr(self.rt, "store_prefix", ""),
            })
        elif kind == "spawn":
            agg_id = m["agg_id"]
            if m.get("agg_kind") == "top":
                # a root fold: inputs are buffered until all `goal`
                # partials arrived, then folded in seq order
                t = self._tops.setdefault(
                    agg_id, {"goal": None, "round_id": int(m["round_id"]),
                             "buf": {}})
                t["goal"] = int(m["goal"])
                t["round_id"] = int(m["round_id"])
            self.rt.spawn_aggregator(
                m["agg_id"], goal=int(m["goal"]), n_elems=int(m["n_elems"]),
                round_id=int(m["round_id"]), kind=m.get("agg_kind", "mid"))
            if m.get("agg_kind") == "top":
                self._flush_top(agg_id)  # peer partials may have raced
        elif kind == "deliver":
            if m.get("partial"):
                # a resident sealed partial routed into the root fold
                self._top_in(m["agg_id"], m["key"], float(m["weight"]),
                             int(m.get("count", 0)), int(m.get("seq", 0)),
                             int(m["round_id"]))
                return
            key = m["key"]
            if frame.blob and not self.rt.update_alive(key):
                # serialize-once boundary: the blob becomes a sealed
                # store object; intra-node delivery is the key alone
                arr = np.frombuffer(
                    frame.blob, dtype=resolve_dtype(m["dtype"]),
                ).reshape(m["shape"])
                self.rt.store.put(arr, key=key)
                self._landed.add(key)
                self.stats["updates_landed"] += 1
            elif not frame.blob and not self.rt.update_alive(key):
                raise KeyError(f"deliver without blob for unknown {key!r}")
            else:
                self.stats["redelivered_keys"] += 1
            self.rt.deliver(m["agg_id"], key, float(m["weight"]),
                            round_id=int(m["round_id"]))
            self._push_events()  # eager mids may have published already
        elif kind == "ship_partial":
            # daemon→daemon: send our sealed partial straight to the
            # round's root node — the controller never carries it
            self._ship_partial(m)
        elif kind == "partial":
            # a peer daemon shipped us a partial for our root fold.
            # Failures must reach the CONTROLLER as a root crash — the
            # generic error reply would go back on this write-only peer
            # conn, which the shipper never reads, and a starved root
            # fold would hang a deadline-less round forever.
            key = m["key"]
            try:
                if frame.blob and not self.rt.update_alive(key):
                    arr = np.frombuffer(
                        frame.blob, dtype=resolve_dtype(m["dtype"]),
                    ).reshape(m["shape"])
                    self.rt.store.put(arr, key=key)
                    self._peer_landed.add(key)  # reclaimed at quiesce
                self.stats["partials_landed"] += 1
                self.stats["ship_rx_bytes"] += len(frame.blob)
                self._top_in(m["agg_id"], key, float(m["weight"]),
                             int(m.get("count", 0)), int(m.get("seq", 0)),
                             int(m["round_id"]))
            except Exception:
                self._push_event_obj(WorkerCrashed(
                    round_id=int(m.get("round_id", 0)),
                    agg_id=m.get("agg_id", ""), worker=-1))
        elif kind == "drain":
            self.rt.drain(m["agg_id"])
            self._push_events()
        elif kind == "fetch":
            # the one model-size payload that crosses the wire per node
            # per round: the sealed raw partial Σ c·u
            t_fetch = time.perf_counter()
            view = self.rt.get_partial(m["key"])
            arr = np.ascontiguousarray(view)
            conn.send("object", {
                "key": m["key"], "dtype": str(arr.dtype),
                "shape": list(arr.shape),
            }, blob=arr)
            self.rt.release_partial(m["key"])
            self._published.discard(m["key"])
            self.stats["partials_served"] += 1
            self.metrics.update("netd", "fetch_serve_s",
                                time.perf_counter() - t_fetch)
        elif kind == "discard_partial":
            self._published.discard(m["key"])
            try:
                self.rt.discard_partial(m["key"])
            except Exception:
                pass  # already reclaimed (quiesce raced the discard)
        elif kind == "discard_update":
            self._landed.discard(m["key"])
            try:
                self.rt.discard_update(m["key"])
            except Exception:
                pass
        elif kind == "quiesce":
            self._push_events()  # published partials reach the wire first
            rid = m.get("round_id")
            if rid is None:
                self.rt.quiesce()
                self._round_cleanup()
            else:
                # rolling rounds: a round-scoped barrier must not tear
                # down the OTHER in-flight round's open tasks or its
                # root-fold buffers
                try:
                    self.rt.quiesce(round_id=int(rid))
                except TypeError:
                    self.rt.quiesce()
                for tid in [t for t, st in self._tops.items()
                            if st.get("round_id") == int(rid)]:
                    self._tops.pop(tid, None)
            conn.send("quiesced", {
                "stats": {k: v for k, v in self.rt.stats.items()
                          if isinstance(v, (int, float))},
                "workers": self.rt.worker_count(),
                "daemon": dict(self.stats),
                # the LIFL-agent drain: the whole per-daemon MetricsMap
                # rides the reply the controller already waits for — no
                # extra round trip, and the map resets for next round
                "telemetry": self.metrics.drain_series(),
                "telemetry_hists": self.metrics.drain_hists(),
            })
        elif kind == "telemetry":
            # on-demand drain (the agent's pull outside quiesce):
            # destructive like the quiesce drain, so samples are never
            # double-counted across pulls
            conn.send("telemetry_map", {
                "node": self.node,
                "telemetry": self.metrics.drain_series(),
                "telemetry_hists": self.metrics.drain_hists(),
            })
        elif kind == "stats":
            # the LIVE drain (paper agent, §4.3): answerable at ANY
            # time — mid-round included — and non-destructive, so a
            # scrape never erases what the round-edge drain will
            # collect.  Series + histogram snapshot + health gauges.
            rt_health = getattr(self.rt, "health", None)
            health = {
                "open_conns": len(self.server.conns),
                "controllers": len(self._controllers),
                "open_tops": len(self._tops),
                "landed_keys": len(self._landed),
                "published_keys": len(self._published),
                "shm_bytes": _shm_bytes(
                    getattr(self.rt, "store_prefix", "")),
            }
            if callable(rt_health):
                health.update(rt_health())
            else:
                health["workers"] = self.rt.worker_count()
            conn.send("stats_reply", {
                "node": self.node,
                "epoch": self.epoch,
                "uptime_s": time.perf_counter() - self.t0_mono,
                "series": series_flatten(self.metrics.snapshot()),
                "hists": self.metrics.hists_snapshot(),
                "health": health,
                "daemon": dict(self.stats),
                "workers": self.rt.worker_count(),
                # this process's fold kernel launches: the only witness
                # that the daemon's folds ran on the card
                "device": str(self.device),
                "kernel_launches": {k.name: k.launches
                                    for k in FOLD_KERNELS},
            })
        elif kind == "recycle":
            self.rt.recycle_engines()
        elif kind == "ping":
            conn.send("pong", {"t": m.get("t")})
        elif kind == "shutdown":
            conn.send("bye", {"node": self.node})
            self._stop = True
        else:
            conn.send("error", {"msg": f"unknown frame kind {kind!r}"})

    # ------------------------------------------------------------------
    def run(self) -> None:
        try:
            while not self._stop:
                self.step()
        finally:
            self.close()

    def stop(self, *_sig) -> None:
        self._stop = True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in self._peers.values():
            conn.close()
        self._peers.clear()
        self.server.close()
        self.rt.close()


def _shm_bytes(prefix: str) -> int:
    """Bytes resident in /dev/shm under ``prefix`` — the live-scrape
    gauge for 'how much store does this daemon hold right now'."""
    if not prefix:
        return 0
    total = 0
    try:
        for fn in os.listdir("/dev/shm"):
            if fn.startswith(prefix):
                try:
                    total += os.stat(os.path.join("/dev/shm", fn)).st_size
                except OSError:
                    pass
    except OSError:
        pass
    return total


def spawn_local_daemon(node: str, *, runtime: str = "inproc",
                       agg_engine: str = "auto", capacity: float = 20.0,
                       listen: str = "127.0.0.1:0", timeout: float = 30.0,
                       compress: int = 0, stdout=None,
                       fault_spec: Optional[FaultPlan] = None,
                       device: Optional[str] = None):
    """Spawn a netd as a local child process and wait for its bound
    address (the port-file handshake).  Returns ``(Popen, addr)`` —
    the caller owns the process.  One helper so benches, tests, and
    examples don't each reimplement the spawn.

    The child's stdout/stderr go to a per-daemon log file by default
    (``proc.lifl_log_path``; pass ``stdout=`` to override).  Never
    inherit the caller's pipes: an orphaned/SIGKILLed daemon's forked
    workers would keep them open and hang any harness draining them.
    The log is removed on a clean :func:`reap_local_daemon`; on
    failure the reaper reports its path instead."""
    import shutil
    import subprocess
    import tempfile
    import time

    # a private directory owns the handshake file: no mktemp-style race
    # with other processes guessing the predictable /tmp name
    tmpd = tempfile.mkdtemp(prefix=f"netd-{node}-")
    pf = os.path.join(tmpd, "addr")
    env = dict(os.environ)
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, "-m", "repro_torch.runtime.netrt.netd",
            "--node", node, "--listen", listen, "--runtime", runtime,
            "--agg-engine", agg_engine, "--capacity", str(capacity),
            "--compress", str(int(compress)), "--port-file", pf]
    if fault_spec is not None:
        argv += ["--fault-spec", fault_spec.to_json()]
    if device is not None:
        argv += ["--device", str(device)]
    # own session: reap_local_daemon can killpg the daemon AND its
    # forked shm workers (SIGKILLing just the daemon orphans them)
    log_path = ""
    log_f = None
    if stdout is None:
        log_path = os.path.join(
            tempfile.gettempdir(),
            f"netd-{node}-{os.getpid()}-{time.time_ns()}.log")
        log_f = open(log_path, "ab")
        stdout = log_f
    try:
        proc = subprocess.Popen(argv, env=env, stdout=stdout,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    finally:
        if log_f is not None:
            log_f.close()   # the child owns the fd now
    proc.lifl_log_path = log_path
    deadline = time.perf_counter() + timeout
    try:
        while not os.path.exists(pf):
            if proc.poll() is not None or time.perf_counter() > deadline:
                proc.kill()
                tail = ""
                if log_path and os.path.exists(log_path):
                    with open(log_path, "rb") as lf:
                        tail = lf.read()[-2048:].decode("utf-8", "replace")
                raise RuntimeError(
                    f"netd {node} failed to start"
                    + (f" (log: {log_path}):\n{tail}" if log_path else ""))
            time.sleep(0.02)
        with open(pf) as f:
            lines = f.read().splitlines()
        addr = lines[0].strip()
        # second port-file line: the daemon's shm prefix — kept on the
        # Popen so reap_local_daemon can sweep after a SIGKILL
        proc.lifl_store_prefix = (lines[1].strip()
                                  if len(lines) > 1 else "")
    finally:
        shutil.rmtree(tmpd, ignore_errors=True)
    return proc, addr


def reap_local_daemon(proc, *, timeout: float = 5.0) -> int:
    """Tear down a ``spawn_local_daemon`` child for good: kill its
    whole process group (the daemon plus any forked shm workers —
    plain ``proc.kill()`` orphans them), wait, then sweep whatever its
    shm prefix left in /dev/shm.  Safe after the process already died
    (the FaultPlan kill path); returns the number of segments swept."""
    import signal as _signal
    import subprocess

    from repro_torch.core.objectstore import sweep_dead_segments

    log_path = getattr(proc, "lifl_log_path", "")
    reaped = True
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, _signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        reaped = False
        if log_path:
            print(f"reap_local_daemon: pid {proc.pid} did not exit; "
                  f"daemon log kept at {log_path}", file=sys.stderr)
    else:
        # the group may still hold workers even after the leader died
        try:
            os.killpg(proc.pid, _signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    if reaped and log_path:
        # clean reap: the log served its purpose (kept on failure so
        # the operator can read why the daemon wouldn't die)
        try:
            os.unlink(log_path)
        except OSError:
            pass
    return sweep_dead_segments(getattr(proc, "lifl_store_prefix", ""))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="netd", description="LIFL per-node aggregation daemon")
    ap.add_argument("--node", required=True, help="node name (placement id)")
    ap.add_argument("--listen", default="127.0.0.1:0",
                    help="host:port or unix:/path (port 0 = ephemeral)")
    ap.add_argument("--runtime", default="inproc",
                    choices=("inproc", "shmproc"))
    ap.add_argument("--agg-engine", default="auto")
    ap.add_argument("--capacity", type=float, default=20.0,
                    help="MC_i for the controller's placement model")
    ap.add_argument("--compress", type=int, default=0,
                    help="zlib level for outbound blobs (0 = off)")
    ap.add_argument("--port-file", default="",
                    help="write the bound address here (atomic rename)")
    ap.add_argument("--fault-spec", default="",
                    help="FaultPlan JSON (deterministic fault injection "
                         "for chaos tests; see netrt/faults.py)")
    ap.add_argument("--device", default=None,
                    help="where the aggregation engines run: the card "
                         "unless named (e.g. cpu)")
    args = ap.parse_args(argv)

    daemon = NodeDaemon(
        args.node, args.listen, runtime=args.runtime,
        agg_engine=args.agg_engine, capacity=args.capacity,
        compress=args.compress,
        fault_plan=FaultPlan.from_json(args.fault_spec)
        if args.fault_spec else None, device=args.device)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(daemon.addr + "\n")
            f.write(getattr(daemon.rt, "store_prefix", "") + "\n")
        os.rename(tmp, args.port_file)
    print(f"netd {args.node} ({args.runtime}) listening on {daemon.addr}",
          flush=True)
    signal.signal(signal.SIGTERM, daemon.stop)
    signal.signal(signal.SIGINT, daemon.stop)
    daemon.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
