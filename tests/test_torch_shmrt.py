"""The port's multi-process runtime (``runtime/shmrt``, ``ShmProcRuntime``)
on the CPU: the JAX package's ``tests/test_shmrt.py`` cases run on the
port's copies, a ``FederatedTrainer(runtime="shmproc")`` against
``inproc``, and the port's ``Session(runtime="shmproc")`` against the
JAX package's on the same external updates.

Every runtime comparison here is bit-exact, and why:

* like engines are bit-exact: the forked workers fold with the blocked
  numpy engine in both packages, and so does ``agg_engine="blocked"``
  at the controller;
* across engines, a single fold is bit-exact too: ``eager_accumulate``
  (and its plain version, which runs on the CPU) rounds ``w·u`` and
  then the add, as numpy does, and a top fold is one fp32 add on any
  engine.  An eager in-process round folds every update alone, so
  ``TorchEngine`` rounds match the workers' bit for bit;
* a burst is bit-exact where its accumulator is zero:
  ``fedavg_accumulate_k`` sums its K rows in order before it adds the
  accumulator, where the numpy engine adds them to it row by row; from
  zero the two sums are the same.  A lazy in-process round folds its
  updates as one burst into a fresh accumulator.  (Into a non-zero
  accumulator the two round differently; the kernel tests hold that
  case within rtol 1e-5.)

Every test ends with no segment left under its runtime's ``/dev/shm``
prefix.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
import repro.runtime as jrt
import repro_torch.api as tapi
import repro_torch.core as tcore
import repro_torch.runtime as trt
from repro_torch.api import Session
from repro_torch.configs.resnet import RESNET18
from repro_torch.core import ClientInfo, RoundConfig
from repro_torch.core.aggregation import FedAvgState, fedavg_oracle
from repro_torch.core.engine import make_engine
from repro_torch.data import (build_client_datasets, dirichlet_partition,
                              synthetic_femnist)
from repro_torch.models.resnet import build_resnet
from repro_torch.runtime import ClientRuntime, FederatedTrainer
from repro_torch.runtime.driver import RoundDriver, ShmProcRuntime
from repro_torch.runtime.events import WorkerCrashed
from repro_torch.runtime.shmrt import (Record, RecordKind, ShmRuntime,
                                       SpscRing, WorkerCrash)
from repro_torch.tree import tree_leaves

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/dev/shm"), reason="needs POSIX /dev/shm")


def _leftover(prefix: str):
    return [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]


def _ring_name(tag: str) -> str:
    return f"lifltorch-{os.getpid()}-{tag}"


# ---------------------------------------------------------------------------
# SPSC rings
# ---------------------------------------------------------------------------

def test_ring_roundtrip_and_wraparound():
    name = _ring_name("wrap")
    with SpscRing(name, nslots=4, create=True) as ring:
        for i in range(12):          # 3 laps over a 4-slot ring
            rec = Record(kind=RecordKind.UPDATE, key=f"{i:016x}"[:16],
                         num_samples=float(i))
            assert ring.push(rec.pack())
            got = Record.unpack(ring.pop())
            assert got.key == rec.key and got.num_samples == float(i)
        assert ring.pop() is None
    assert _leftover(name) == []


def test_ring_full_backpressure():
    name = _ring_name("bp")
    with SpscRing(name, nslots=2, create=True) as ring:
        r = Record(kind=RecordKind.UPDATE).pack()
        assert ring.push(r) and ring.push(r)
        assert ring.full()
        assert not ring.push(r)                  # non-blocking: rejected
        assert not ring.push(r, timeout=0.05)    # blocking: times out
        ring.pop()
        assert ring.push(r)
        assert len(ring) == 2
    assert _leftover(name) == []


def test_ring_cross_process_producer():
    """A spawned process that imports only the port attaches the ring
    by name and produces; the parent consumes."""
    name = _ring_name("xproc")
    with SpscRing(name, nslots=128, create=True) as ring:
        code = f"""
        import sys
        from repro_torch.runtime.shmrt import Record, RecordKind, SpscRing
        ring = SpscRing({name!r})
        for i in range(100):
            assert ring.push(Record(kind=RecordKind.UPDATE, a=i).pack(),
                             timeout=5.0)
        ring.close()
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules)
        """
        out = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(code)],
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": SRC})
        assert out.returncode == 0, out.stderr[-2000:]
        got = [Record.unpack(r).a for r in ring.pop_many(128)]
        assert got == list(range(100))
    assert _leftover(name) == []


# ---------------------------------------------------------------------------
# forked workers
# ---------------------------------------------------------------------------

def _hier_blocked(ups, ws, n):
    """The same grouping through the in-process blocked engines."""
    eng = make_engine("blocked")
    top = FedAvgState(engine=eng)
    top._ensure_acc(n)
    for g_ups, g_ws in zip(ups, ws):
        st = FedAvgState(engine=make_engine("blocked"))
        st.fold_many(list(g_ups), list(g_ws))
        top.acc = eng.add_partial(top.acc, np.asarray(st.acc))
        top.weight += st.weight
        top.count += st.count
    return top.result()[0]


def test_two_workers_bitexact_and_warm_reuse():
    n = 1 << 14
    rng = np.random.default_rng(0)
    ups = [[rng.normal(size=(n,)).astype(np.float32) for _ in range(3)]
           for _ in range(2)]
    ws = [[1.0, 2.5, 4.0], [3.0, 0.5, 7.0]]
    ref = _hier_blocked(ups, ws, n)
    with ShmRuntime() as rt:
        for rid in (1, 2):           # round 2 re-tasks the warm workers
            for g in range(2):
                rt.submit_task(f"mid@n{g}", goal=3, n_elems=n, round_id=rid)
            keys = []
            for g in range(2):
                for u, c in zip(ups[g], ws[g]):
                    keys.append(rt.store.put(u))
                    rt.dispatch(f"mid@n{g}", keys[-1], c, round_id=rid)
            parts = sorted(rt.collect(2), key=lambda p: p.agg_id)
            assert [p.count for p in parts] == [3, 3]
            eng = make_engine("blocked")
            top = FedAvgState(engine=eng)
            top._ensure_acc(n)
            for p in parts:          # fold the shm views directly
                top.acc = eng.add_partial(top.acc, rt.store.get(p.key))
                top.weight += p.weight
                top.count += p.count
            got = top.result()[0]
            assert np.array_equal(got, ref)
            np.testing.assert_allclose(
                got, fedavg_oracle([u for g in ups for u in g],
                                   [c for g in ws for c in g]),
                rtol=1e-5, atol=1e-5)
            for p in parts:
                rt.store.destroy(p.key)
            for k in keys:
                rt.store.delete(k)
        assert rt.stats["cold_starts"] == 2 and rt.stats["warm_starts"] == 2
        assert len(rt.worker_pids()) == 2
        assert rt.stats["warm_latency_s"] < rt.stats["cold_latency_s"]
    assert _leftover(rt.prefix) == []


def test_drain_closes_short_task():
    n = 1 << 12
    u = np.ones(n, np.float32)
    with ShmRuntime() as rt:
        rt.submit_task("mid@n0", goal=8, n_elems=n)
        rt.dispatch("mid@n0", rt.store.put(u), 2.0)
        rt.dispatch("mid@n0", rt.store.put(u * 3), 1.0)
        time.sleep(0.2)
        rt.drain("mid@n0")           # 2 of 8 arrived (stragglers)
        p = rt.collect(1)[0]
        assert p.count == 2 and p.weight == 3.0
        np.testing.assert_array_equal(np.asarray(rt.store.get(p.key)),
                                      u * 2.0 + u * 3.0)
        rt.store.destroy(p.key)
    assert _leftover(rt.prefix) == []


def test_sigkill_mid_drain_reclaims_segments():
    """A SIGKILLed worker holding a live accumulator: the crash surfaces,
    its segments are reclaimed, and a fresh worker serves the next task."""
    n = 1 << 14
    u = np.ones(n, np.float32)
    with ShmRuntime() as rt:
        rt.submit_task("mid@n0", goal=8, n_elems=n)
        rt.dispatch("mid@n0", rt.store.put(u), 1.0)
        time.sleep(0.3)              # the worker has folded
        victim = rt._route["mid@n0"]
        wseg = f"{rt.prefix}-w{victim.idx & 0xff:02x}"
        assert _leftover(wseg)
        os.kill(victim.proc.pid, signal.SIGKILL)
        time.sleep(0.2)
        with pytest.raises(WorkerCrash):
            rt.poll()
        assert _leftover(wseg) == [] and rt.stats["crashes"] == 1
        rt.submit_task("mid@n0", goal=1, n_elems=n)
        rt.dispatch("mid@n0", rt.store.put(u * 5), 1.0)
        p = rt.collect(1)[0]
        np.testing.assert_array_equal(np.asarray(rt.store.get(p.key)), u * 5)
        rt.store.destroy(p.key)
    assert _leftover(rt.prefix) == []


def test_driver_redispatch_after_sigkill_reaches_full_goal():
    """A worker SIGKILLed mid-round: its sealed updates go to a fresh
    worker and the round folds all eight.  The controller's top fold is
    the port's default engine (``TorchEngine`` on the CPU)."""
    n = 1 << 14
    rng = np.random.default_rng(3)
    ups = {g: [rng.normal(size=(n,)).astype(np.float32) for _ in range(4)]
           for g in ("n0", "n1")}
    ws = {"n0": [1.0, 2.0, 3.0, 4.0], "n1": [2.0, 2.5, 1.5, 0.5]}
    # n0 plans 5 slots but gets 4 updates: its task is open at the kill
    assignment = {"n0": [0, 1, 2, 3, 4], "n1": [5, 6, 7, 8]}
    crashes = []
    rt = ShmProcRuntime(agg_engine=make_engine("torch", device="cpu"))
    drv = RoundDriver(rt)
    drv.on(WorkerCrashed, crashes.append)

    def updates():
        for u, w in zip(ups["n0"], ws["n0"]):
            yield "n0", "c", u, w
        os.kill(rt._rt._route["mid@n0"].proc.pid, signal.SIGKILL)
        for u, w in zip(ups["n1"], ws["n1"]):
            yield "n1", "c", u, w

    try:
        out = drv.run_round(round_id=1, assignment=assignment,
                            updates=updates(), goal=8, n_elems=n,
                            top_node="n0")
        assert out.accepted == 8 and out.count == 8
        assert out.crashes >= 1 and out.redispatched >= 1
        assert crashes[0].agg_id == "mid@n0"
        np.testing.assert_allclose(
            out.delta, fedavg_oracle(ups["n0"] + ups["n1"],
                                     ws["n0"] + ws["n1"]),
            rtol=1e-5, atol=1e-5)
    finally:
        rt.close()
        rt.close()                   # close after a crash is idempotent
    assert _leftover(rt.store_prefix) == []


# ---------------------------------------------------------------------------
# the trainer and the Session on shmproc
# ---------------------------------------------------------------------------

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


def _trainer(runtime, agg_engine, eager=True):
    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(200, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, 8, alpha=0.5)
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]
    return FederatedTrainer(
        model, model.init(0, device="cpu"), clients,
        round_cfg=RoundConfig(aggregation_goal=4, over_provision=1.5,
                              eager=eager),
        seed=0, runtime=runtime, agg_engine=agg_engine, device="cpu")


@pytest.mark.parametrize("agg_engine,eager", [
    ("blocked", True), ("auto", True), ("auto", False)])
def test_trainer_shmproc_matches_inproc(_no_onednn, agg_engine, eager):
    """Three rounds of reduced ResNet-18 on ``shmproc`` against
    ``inproc``, bit for bit after every round.  ``agg_engine="blocked"``:
    numpy on both sides.  The default engine: ``inproc``'s mids fold on
    ``TorchEngine``, each update alone (eager) or as one burst into a
    fresh accumulator (lazy), the workers with numpy."""
    tr_in, tr_sh = _trainer("inproc", agg_engine, eager), \
        _trainer("shmproc", agg_engine, eager)
    try:
        for _ in range(3):
            ri = tr_in.run_round(client_lr=0.05, client_batch_size=32)
            rs = tr_sh.run_round(client_lr=0.05, client_batch_size=32)
            assert ri["updates"] == rs["updates"] == 4.0
            for a, b in zip(tree_leaves(tr_in.params),
                            tree_leaves(tr_sh.params)):
                assert torch.equal(a, b)
        assert rs["reused"] > 0      # later rounds reused warm workers
        prefix = tr_sh._runtime.store_prefix
    finally:
        tr_sh.close()
        tr_sh.close()                # double close: no raise, no leak
        tr_in.close()
    assert _leftover(prefix) == []


N_EXT = 4096


class _NoTraining:
    """A model whose clients never train: every cohort slot is taken by
    an external update."""

    def loss(self, params, batch):
        raise AssertionError("no client should train")


def _external_rounds(pkg, core, runtime_mod, params, agg_engine, **kw):
    """Two shmproc rounds of four external updates each (numpy, seed 1)
    through ``pkg.Session``; the registered clients only give the cohort
    its slots.  Returns the params and the runtime's shm prefix."""
    clients = [runtime_mod.ClientRuntime(core.ClientInfo(f"c{i}", 10), None)
               for i in range(6)]
    rng = np.random.default_rng(1)
    with pkg.Session.open(
            _NoTraining(), params, clients, runtime="shmproc",
            agg_engine=agg_engine, seed=0,
            round_cfg=core.RoundConfig(aggregation_goal=4,
                                       over_provision=1.5), **kw) as s:
        for r in range(2):
            for i in range(6):       # more than the goal: 2 stay queued
                s.submit_update(f"edge-{r}-{i}",
                                rng.standard_normal(N_EXT)
                                .astype(np.float32),
                                weight=float(1 + i % 3))
            assert s.run_round()["updates"] == 4.0
        prefix = s.trainer._runtime.store_prefix
        return {k: np.asarray(v) for k, v in s.params.items()}, prefix


@pytest.mark.parametrize("port_engine", ["blocked", "auto"])
def test_session_shmproc_matches_the_jax_package(port_engine):
    """The same external updates through the JAX package's and the
    port's ``Session(runtime="shmproc")``: both fold in forked numpy
    workers, and the controller's top fold is an IEEE fp32 add on
    either engine, so the params are bit-equal."""
    w0 = np.random.default_rng(0).standard_normal(N_EXT).astype(np.float32)
    jax_params, jprefix = _external_rounds(
        japi, jcore, jrt, {"w": w0}, "blocked")
    port_params, tprefix = _external_rounds(
        tapi, tcore, trt, {"w": torch.from_numpy(w0.copy())}, port_engine,
        device="cpu")
    assert not np.array_equal(port_params["w"], w0)
    np.testing.assert_array_equal(port_params["w"], jax_params["w"])
    assert _leftover(jprefix) == [] and _leftover(tprefix) == []


def test_session_shmproc_round_reports_its_workers(_no_onednn):
    """``Session.open(runtime="shmproc")``: the round's trace carries the
    workers' spans, and ``metrics`` names the runtime."""
    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(64, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, 4, alpha=0.5)
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]
    with Session.open(model, model.init(0, device="cpu"), clients,
                      runtime="shmproc", device="cpu",
                      round_cfg=RoundConfig(aggregation_goal=3)) as s:
        rec = s.run_round(client_lr=0.05, client_batch_size=16)
        assert rec["updates"] == 3.0 and rec["workers"] >= 1
        assert s.metrics()["runtime"] == "shmproc"
        kinds = {sp.kind for sp in s.trace().spans}
        assert "worker.task" in kinds
        stats = s.trainer._runtime.stats
        assert stats["forked"] >= 1 and stats["cold_starts"] >= 1
        prefix = s.trainer._runtime.store_prefix
    assert _leftover(prefix) == []


def test_shmproc_workers_fold_bf16_words_as_the_widened_values():
    """A bf16 update as the port's wire decodes it (raw words,
    ``BF16_WORDS``) in the shared-memory store: the forked numpy
    workers recognise it through the object header (``"|V2"``) and fold
    it bit-equal to the same values as fp32, never as integers."""
    import ml_dtypes
    from repro_torch.bf16 import BF16_WORDS

    rng = np.random.default_rng(11)
    n = 3000
    f32 = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    words = [np.frombuffer(u.astype(ml_dtypes.bfloat16).tobytes(),
                           dtype=BF16_WORDS) for u in f32]
    wide = [u.astype(ml_dtypes.bfloat16).astype(np.float32) for u in f32]
    ws = [1.0, 2.0, 3.0, 0.5]
    assignment = {"n0": [0, 1, 2, 3]}

    def run(rt, ups):
        try:
            return RoundDriver(rt).run_round(
                round_id=0, assignment=assignment, goal=4, n_elems=n,
                updates=[("n0", f"c{i}", u, w)
                         for i, (u, w) in enumerate(zip(ups, ws))]).delta
        finally:
            rt.close()

    rt = ShmProcRuntime(agg_engine="blocked")
    got = run(rt, words)
    assert _leftover(rt.store_prefix) == []
    want = run(ShmProcRuntime(agg_engine="blocked"), wide)
    np.testing.assert_array_equal(got, want)
