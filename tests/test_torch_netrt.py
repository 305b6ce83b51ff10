"""The port's multi-node runtime (``runtime/netrt``) and serve mode on the
CPU: two of the port's ``netd`` daemons (``--device cpu``) joined to the
controller by loopback TCP, the port's ``RemoteRuntime`` through the
``RoundDriver``, ``Session.open(nodes=[...])``, ``Session.serve`` and
``admission=``; and the same updates through two of the JAX package's
daemons.

Which comparisons are bit-exact: all of them.  Every mid fold here is
a single eager fold (``Aggregator`` folds each delivered update as it
lands), which the port's ``eager_accumulate`` plain version rounds as
numpy does (``w·u`` rounded, then the add); a root fold is an IEEE fp32
add on any engine.  So the port's daemons (``TorchEngine``) agree bit
for bit with the JAX package's (blocked numpy) and with the port's own
in-process rounds.

The daemon pair is spawned once for the module; a test that kills a
daemon spawns its own victim.
"""
import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro.runtime.driver as jdriver
import repro.runtime.netrt as jnetrt
from repro.core.placement import build_fold_plan as j_build_fold_plan
from repro_torch.api import Session
from repro_torch.configs.resnet import RESNET18
from repro_torch.core import ClientInfo, NodeState, RoundConfig
from repro_torch.core.aggregation import fedavg_oracle
from repro_torch.core.engine import EngineConfig
from repro_torch.core.placement import build_fold_plan
from repro_torch.data import (build_client_datasets, dirichlet_partition,
                              synthetic_femnist)
from repro_torch.models.resnet import build_resnet
from repro_torch.runtime import ClientRuntime
from repro_torch.runtime.driver import InProcRuntime, RoundDriver
from repro_torch.runtime.events import (NodeLost, TopFolded, UpdateArrived,
                                        WorkerCrashed)
from repro_torch.runtime.netrt import (BusyError, FrameConn, RemoteRuntime,
                                       connect, push_update,
                                       reap_local_daemon, spawn_local_daemon)
from repro_torch.serve import AdmissionPolicy
from repro_torch.tree import tree_leaves

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ASSIGNMENT = {"nodeA": [0, 2, 4], "nodeB": [1, 3, 5]}
CPU_ENGINE = EngineConfig(name="auto", device="cpu")


def _spawn(node, **kw):
    # a daemon imports torch before it binds: slow on a loaded host
    return spawn_local_daemon(node, stdout=subprocess.DEVNULL,
                              timeout=120.0, **kw)


@pytest.fixture(scope="module")
def daemons():
    """Two of the port's daemons on the CPU, for the whole module."""
    procs, addrs = [], []
    try:
        for name in ("nodeA", "nodeB"):
            p, a = _spawn(name, device="cpu")
            procs.append(p)
            addrs.append(a)
        yield procs, addrs
    finally:
        for p in procs:
            reap_local_daemon(p)


@pytest.fixture(scope="module")
def jax_daemons():
    """Two of the JAX package's daemons, for the parity cases."""
    procs = []
    try:
        for name in ("nodeA", "nodeB"):
            procs.append(jnetrt.spawn_local_daemon(
                name, stdout=subprocess.DEVNULL, timeout=120.0))
        yield [a for _, a in procs]
    finally:
        for p, _ in procs:
            jnetrt.reap_local_daemon(p)


@pytest.fixture
def _no_onednn():
    # oneDNN's CPU conv backward crashes this torch build at odd batch
    # sizes; the port's CPU tests train with it off
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


def _mk_updates(n_updates=6, n_elems=4096, seed=0):
    rng = np.random.default_rng(seed)
    ups = [rng.normal(size=n_elems).astype(np.float32)
           for _ in range(n_updates)]
    return ups, [float(1 + i % 3) for i in range(n_updates)]


def _drive(drv, ups, ws, n_elems, round_id, plan=None, kill_after=None):
    """One driven round, update i -> nodeA / nodeB alternately;
    ``kill_after=(i, fn)`` calls ``fn`` right after update i."""
    def updates():
        for i, (u, w) in enumerate(zip(ups, ws)):
            yield ("nodeA" if i % 2 == 0 else "nodeB"), f"c{i}", u, w
            if kill_after is not None and i == kill_after[0]:
                kill_after[1]()

    return drv.run_round(round_id=round_id, assignment=ASSIGNMENT,
                         updates=updates(), goal=len(ups), n_elems=n_elems,
                         fold_plan=plan)


def _plan(topology):
    return build_fold_plan(ASSIGNMENT, top_node="nodeA", topology=topology)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [0, 6])
def test_frame_roundtrip_with_blob(compress):
    a, b = (FrameConn(s, peer=p) for s, p in zip(socket.socketpair(), "ab"))
    a.compress = compress
    payload = np.tile(np.arange(256, dtype=np.float32), 8)
    a.send("deliver", {"agg_id": "mid@n0", "weight": 2.5,
                       "dtype": "float32", "shape": [payload.size]},
           blob=payload)
    f = b.recv(timeout=2.0)
    assert f.kind == "deliver" and f.meta["weight"] == 2.5
    assert "_z" not in f.meta
    np.testing.assert_array_equal(np.frombuffer(f.blob, np.float32), payload)
    assert a.tx_bytes == b.rx_bytes
    assert b.rx_raw_by_kind["deliver"] == a.tx_raw_by_kind["deliver"]
    if compress:
        assert a.tx_by_kind["deliver"] < a.tx_raw_by_kind["deliver"] / 2
    else:
        assert a.tx_bytes > payload.nbytes
    a.close(), b.close()


# ---------------------------------------------------------------------------
# driven rounds across the two daemons
# ---------------------------------------------------------------------------

def _inproc_refs(ups, ws, n, rounds):
    rt = InProcRuntime(agg_engine=CPU_ENGINE)
    drv = RoundDriver(rt)
    refs = [_drive(drv, ups, ws, n, r, _plan("controller"))
            for r in range(rounds)]
    rt.close()
    return refs


@pytest.mark.parametrize("topology", ["node", "controller"])
def test_two_node_rounds_bitexact_vs_inproc(daemons, topology):
    """Three rounds across the two daemons, the root fold on nodeA's
    daemon (node-top) or at the controller: each round's delta is bit
    for bit the in-process tree's, and the wire carries partials only."""
    _, addrs = daemons
    n = 4096
    ups, ws = _mk_updates(6, n)
    refs = _inproc_refs(ups, ws, n, 3)
    rt = RemoteRuntime(addrs, agg_engine=CPU_ENGINE)
    try:
        assert list(rt.node_info()) == ["nodeA", "nodeB"]
        drv = RoundDriver(rt)
        folded = []
        drv.on(TopFolded, folded.append)
        for r in range(3):
            out = _drive(drv, ups, ws, n, r, _plan(topology))
            assert out.count == 6 and out.crashes == 0
            assert out.fold_tier == topology
            np.testing.assert_array_equal(out.delta, refs[r].delta)
        wire = rt.wire_stats()
        fetched = sum(w["rx_by_kind"].get("object", 0) for w in wire.values())
        per_round = 1 if topology == "node" else 2
        assert fetched <= 3 * per_round * 4 * n * 1.1
        assert [e.tier for e in folded] == [topology] * 3
        assert not rt._staged and not rt._partial_home
    finally:
        rt.close()


def test_compressed_round_bitexact_vs_uncompressed(daemons):
    """``compress=6`` on the wire: the same delta bit for bit, and the
    update traffic shrank (these updates compress)."""
    _, addrs = daemons
    n = 4096
    ups = [np.tile(np.float32(i + 1), n) for i in range(6)]
    ws = [1.0, 2.0, 1.0, 3.0, 2.0, 1.0]
    out, tx = {}, {}
    for level in (0, 6):
        rt = RemoteRuntime(addrs, agg_engine=CPU_ENGINE, compress=level)
        try:
            out[level] = _drive(RoundDriver(rt), ups, ws, n, 0,
                                _plan("node")).delta
            tx[level] = sum(v["tx_bytes"] for v in rt.wire_stats().values())
        finally:
            rt.close()
    np.testing.assert_array_equal(out[6], out[0])
    assert tx[6] < tx[0] / 2


def test_sigkilled_daemon_mid_round_redispatches_to_survivor(daemons):
    """SIGKILL one daemon mid-round: NodeLost plus one WorkerCrashed,
    the subtree's staged updates go to the survivor, the round reaches
    its full goal, and the next round runs on the survivor alone."""
    _, addrs = daemons
    victim, vaddr = _spawn("nodeB", device="cpu")
    n = 2048
    ups, ws = _mk_updates(6, n, seed=1)
    rt = RemoteRuntime([addrs[0], vaddr], agg_engine=CPU_ENGINE)
    lost, crashed = [], []
    try:
        drv = RoundDriver(rt)
        drv.on(NodeLost, lost.append)
        drv.on(WorkerCrashed, crashed.append)

        def kill():
            os.kill(victim.pid, signal.SIGKILL)
            victim.wait()
            time.sleep(0.05)

        out = _drive(drv, ups, ws, n, 0, kill_after=(4, kill))
        assert out.count == 6 and out.crashes == 1 and out.redispatched == 1
        assert [e.node for e in lost] == ["nodeB"]
        assert [e.agg_id for e in crashed] == ["mid@nodeB"]
        np.testing.assert_allclose(out.delta, fedavg_oracle(ups, ws),
                                   rtol=1e-5, atol=1e-6)
        assert not rt._staged and not rt._partial_home
        out2 = drv.run_round(
            round_id=1, assignment={"nodeA": list(range(6))},
            updates=(("nodeA", f"c{i}", u, w)
                     for i, (u, w) in enumerate(zip(ups, ws))),
            goal=6, n_elems=n)
        assert out2.count == 6 and out2.crashes == 0
    finally:
        rt.close()
        reap_local_daemon(victim)


@pytest.mark.parametrize("topology", ["node", "controller"])
def test_port_daemons_match_the_jax_packages(daemons, jax_daemons,
                                             topology):
    """The same three rounds through two of the JAX package's daemons
    (blocked numpy folds) and through the port's (``TorchEngine`` on
    the CPU): bit-equal deltas."""
    _, addrs = daemons
    n = 4096
    ups, ws = _mk_updates(6, n, seed=2)
    jrt = jnetrt.RemoteRuntime(jax_daemons)
    try:
        jdrv = jdriver.RoundDriver(jrt)
        jplan = j_build_fold_plan(ASSIGNMENT, top_node="nodeA",
                                  topology=topology)
        want = [_drive(jdrv, ups, ws, n, r, jplan).delta for r in range(3)]
    finally:
        jrt.close()
    rt = RemoteRuntime(addrs, agg_engine=CPU_ENGINE)
    try:
        drv = RoundDriver(rt)
        for r in range(3):
            got = _drive(drv, ups, ws, n, r, _plan(topology)).delta
            np.testing.assert_array_equal(got, want[r])
    finally:
        rt.close()


def _words_on_the_wire(rt):
    """A bf16 update crosses the wire as its raw words under the name
    ``bfloat16``: neither package's sender hands an ``ml_dtypes`` array
    to a socket, so the controller's sends are given the words."""
    send = rt._send

    def _send(node, kind, meta, blob=b""):
        if isinstance(blob, np.ndarray) and blob.dtype.name == "bfloat16":
            blob = blob.view(np.uint16)
        return send(node, kind, meta, blob=blob)

    rt._send = _send
    return rt


def test_port_daemons_fold_bf16_updates_like_the_jax_packages(
        daemons, jax_daemons):
    """bf16 updates, the same bytes on the wire, through two of the JAX
    package's daemons (``ml_dtypes``, blocked numpy) and two of the
    port's (no ``ml_dtypes``: raw words staged as bf16 on
    ``TorchEngine``): bit-equal deltas, equal to the widened values'
    fp32 round."""
    import ml_dtypes

    _, addrs = daemons
    n = 4096
    f32, ws = _mk_updates(6, n, seed=5)
    ups = [u.astype(ml_dtypes.bfloat16) for u in f32]
    jrt = _words_on_the_wire(jnetrt.RemoteRuntime(jax_daemons))
    try:
        want = _drive(jdriver.RoundDriver(jrt), ups, ws, n, 0,
                      j_build_fold_plan(ASSIGNMENT, top_node="nodeA",
                                        topology="node")).delta
    finally:
        jrt.close()
    rt = _words_on_the_wire(RemoteRuntime(addrs, agg_engine=CPU_ENGINE))
    try:
        got = _drive(RoundDriver(rt), ups, ws, n, 0, _plan("node")).delta
    finally:
        rt.close()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, fedavg_oracle([u.astype(np.float32) for u in ups], ws),
        rtol=1e-5, atol=1e-6)


def test_stats_reply_names_the_device_and_the_fold_launches(daemons):
    _, addrs = daemons
    conn = connect(addrs[0], timeout=5.0)
    try:
        conn.send("hello", {"role": "client"})
        conn.recv_expect(("welcome",), 5.0)
        conn.send("stats", {})
        meta = conn.recv_expect(("stats_reply",), 5.0).meta
    finally:
        conn.close()
    assert meta["node"] == "nodeA" and meta["device"] == "cpu"
    # on the CPU the folds run the kernels' plain versions: no launch
    assert meta["kernel_launches"] == {"eager_accumulate": 0,
                                       "fedavg_accumulate_k": 0,
                                       "fedavg_reduce": 0}


def test_daemon_without_a_device_fails_on_a_host_without_a_card():
    """A daemon started without ``--device`` runs on the card; with none
    on the host it fails at start, loudly, and never folds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device") as e:
        reap_local_daemon(spawn_local_daemon("nodeZ", timeout=120.0)[0])
    # the failed daemon's log is kept for its reader: this test reads it
    os.unlink(re.search(r"\(log: (.+?)\):", str(e.value)).group(1))


# ---------------------------------------------------------------------------
# Session: multi-node, serve, admission
# ---------------------------------------------------------------------------

def _session_parts():
    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(120, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, 8, alpha=0.5)

    def clients():
        return [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
                for d in build_client_datasets(imgs, labels, shards)]

    return model, model.init(0, device="cpu"), clients


def test_session_multinode_params_match_inproc(daemons, _no_onednn):
    """``Session.open(nodes=[a, b])`` (node-top by default) against an
    in-process session over nodes of the same names and capacities:
    the same cohorts, plan and arithmetic, so bit-equal params."""
    _, addrs = daemons
    model, params, clients = _session_parts()
    rc = RoundConfig(aggregation_goal=4, over_provision=1.5,
                     placement_policy="locality", topology="node")
    with Session.open(model, params, clients(), nodes=list(addrs),
                      round_cfg=rc, device="cpu") as s:
        assert set(s.nodes) == {"nodeA", "nodeB"}
        assert s.metrics()["runtime"] == "net"
        for _ in range(2):
            assert s.run_round(client_lr=0.05)["updates"] == 4.0
        net = [l.clone() for l in tree_leaves(s.params)]
        side = s.metrics()["sidecar"]
        assert side.get("net/tx_bytes", 0) > 0
        assert side.get("net/rx_bytes", 0) > 0
    with Session.open(
            model, params, clients(), device="cpu",
            nodes={n: NodeState(node=n, max_capacity=20.0)
                   for n in ("nodeA", "nodeB")},
            round_cfg=RoundConfig(aggregation_goal=4, over_provision=1.5,
                                  placement_policy="locality")) as s2:
        for _ in range(2):
            s2.run_round(client_lr=0.05)
        ref = tree_leaves(s2.params)
    for a, b in zip(net, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kwargs,match", [
    ({"runtime": "shmproc", "nodes": ["127.0.0.1:1"]}, "netd --runtime"),
    ({"wire_compress": 6}, "requires multi-node mode"),
])
def test_session_open_refuses_what_the_jax_package_refuses(kwargs, match):
    model, params, _ = _session_parts()
    with pytest.raises(ValueError, match=match):
        Session.open(model, params, [], device="cpu", **kwargs)


def test_session_serve_takes_an_update_from_a_client_process(_no_onednn):
    """An external process that imports only the port pushes an update
    over the wire; it takes a cohort slot in the next round."""
    model, params, clients = _session_parts()
    n = sum(l.numel() for l in tree_leaves(params))
    with Session.open(model, params, clients(), device="cpu",
                      round_cfg=RoundConfig(aggregation_goal=3,
                                            over_provision=1.0)) as s:
        addr = s.serve("127.0.0.1:0")
        assert s.serve_addr == addr and s.serve(addr) == addr
        code = (
            "import sys\n"
            "import numpy as np\n"
            "from repro_torch.runtime.netrt import push_update\n"
            f"ack = push_update({addr!r}, 'edge-7', "
            f"np.full({n}, 0.25, np.float32), weight=3.0)\n"
            "assert ack['queued'] == 1, ack\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " for m in sys.modules)\n")
        r = subprocess.run([sys.executable, "-c", code], timeout=120,
                           capture_output=True, text=True,
                           env={**os.environ, "PYTHONPATH": SRC})
        assert r.returncode == 0, r.stderr
        seen = []
        s.on(UpdateArrived, lambda ev: seen.append(ev.client_id))
        s.run_round(client_lr=0.05)
        assert "edge-7" in seen
    assert s.serve_addr is None           # close stopped the server


def test_serve_refuses_a_wrong_size_update():
    model, params, clients = _session_parts()
    n = sum(l.numel() for l in tree_leaves(params))
    with Session.open(model, params, clients(), device="cpu") as s:
        addr = s.serve("127.0.0.1:0")
        with pytest.raises(ValueError, match="rejected"):
            push_update(addr, "edge-bad", np.zeros(3, np.float32))
        conn = connect(addr, timeout=5.0)
        assert conn.ping() < 5.0          # still serving
        conn.close()
        push_update(addr, "edge-2d", np.zeros((1, n), np.float32))
        assert s.trainer._external[-1][1].ndim == 1


def test_admission_returns_a_busy_verdict_with_retry_after():
    """``admission=``: past the budget a submission is pushed back, not
    queued: locally a ``busy`` verdict with ``retry_after_s``, on the
    wire a ``busy`` frame that ``push_update`` gives up on as
    ``BusyError`` when told not to retry."""
    model, params, clients = _session_parts()
    n = sum(l.numel() for l in tree_leaves(params))
    u = np.zeros(n, np.float32)
    with Session.open(model, params, clients(), device="cpu",
                      admission=AdmissionPolicy(max_queue=1,
                                                retry_base_s=0.01)) as s:
        first = s.submit_update("edge-1", u)
        assert first["admitted"] and not first["busy"]
        second = s.submit_update("edge-2", u)
        assert second["busy"] and not second["admitted"]
        assert second["retry_after_s"] > 0
        addr = s.serve("127.0.0.1:0")
        with pytest.raises(BusyError) as e:
            push_update(addr, "edge-3", u, busy_retries=0)
        assert e.value.retry_after_s > 0
        ingress = s.metrics()["ingress"]
        assert ingress["admitted"] == 1 and ingress["shed"] == 2
        assert len(s.trainer._external) == 1
