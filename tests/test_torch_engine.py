"""``TorchEngine`` through the port's ``Aggregator`` against the JAX
package's ``fedavg_oracle``, on the CPU (the kernels' plain versions).

The cases are those of ``tests/test_engine.py``: sequential, batched
and merged folds, eager and lazy timing, bursty arrival order, wire
dtypes against the rounded oracle, the staging slab's dtype, and warm
reuse of the accumulator.  Tolerance 1e-5, as there: the fp32 sums run
in another order than the oracle's.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.aggregation import fedavg_oracle
from repro_torch.core import (Aggregator, FedAvgState, InProcObjectStore,
                              TorchEngine, UpdateEnvelope, make_engine)
from repro_torch.core.engine import EngineConfig

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

RNG = np.random.default_rng(7)


def _updates(k=6, n=1000, dtype=np.float32):
    us = [RNG.normal(size=(n,)).astype(dtype) for _ in range(k)]
    ws = [float(w) for w in RNG.uniform(0.5, 8.0, size=k)]
    return us, ws


def _feed(agg, store, us, ws):
    for u, w in zip(us, ws):
        agg.recv(UpdateEnvelope(store.put(u), 0, "c", w, enqueue_ts=0.0))


def _engine():
    return TorchEngine(device="cpu")


def test_make_engine_resolves_to_torch_engine():
    eng = make_engine(EngineConfig(name="auto", device="cpu"))
    assert isinstance(eng, TorchEngine) and eng.device.type == "cpu"
    assert isinstance(make_engine("torch", device="cpu"), TorchEngine)
    with pytest.raises(ValueError):
        make_engine("pallas")


@pytest.mark.parametrize("mode", ["sequential", "batched", "merged"])
def test_fedavg_state_folds_match_oracle(mode):
    us, ws = _updates(k=7)
    st = FedAvgState(engine=_engine())
    if mode == "sequential":
        for u, w in zip(us, ws):
            st.fold(u, w)
    elif mode == "batched":
        st.fold_many(us, ws)
    else:
        other = FedAvgState(engine=_engine())
        for u, w in zip(us[:3], ws[:3]):
            st.fold(u, w)
        other.fold_many(us[3:], ws[3:])
        st.merge(other)
    got, weight = st.result()
    np.testing.assert_allclose(got, fedavg_oracle(us, ws), rtol=1e-5,
                               atol=1e-5)
    assert weight == pytest.approx(sum(ws))


@pytest.mark.parametrize("eager", [True, False])
def test_aggregator_end_to_end_matches_oracle(eager):
    us, ws = _updates(k=9)
    store = InProcObjectStore()
    agg = Aggregator("a", store, goal=len(us), eager=eager,
                     engine=_engine(), batch_k=4)
    _feed(agg, store, us, ws)
    if not eager:
        agg.flush()
    assert agg.done
    got, weight = agg.result
    np.testing.assert_allclose(got, fedavg_oracle(us, ws), rtol=1e-5,
                               atol=1e-5)
    assert weight == pytest.approx(sum(ws))


def test_bursty_arrival_order_invariance():
    us, ws = _updates(k=11)
    perm = RNG.permutation(len(us))
    results = []
    for order, eager, batch_k in ((range(len(us)), True, 1),
                                  (perm, False, 8),
                                  (perm[::-1], False, 3)):
        store = InProcObjectStore()
        agg = Aggregator("a", store, goal=len(us), eager=eager,
                         engine=_engine(), batch_k=batch_k)
        _feed(agg, store, [us[i] for i in order], [ws[i] for i in order])
        agg.flush()
        results.append(agg.result[0])
    for r in results:
        np.testing.assert_allclose(r, fedavg_oracle(us, ws), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
@pytest.mark.parametrize("burst", [False, True])
def test_reduced_dtype_folds_match_rounded_oracle(wire, burst):
    """bf16/f16 wire updates accumulate in fp32: exact to the oracle fed
    the same rounded values, loosely bounded against the fp32 one."""
    dt = np.dtype(np.float16) if wire == "float16" else np.dtype(
        ml_dtypes.bfloat16)
    us32, ws = _updates(k=5, n=64 * 1024 + 17 if burst else 1000)
    wire_us = [u.astype(dt) for u in us32]
    st = FedAvgState(engine=_engine())
    if burst:
        st.fold_many(wire_us, ws)
    else:
        for u, w in zip(wire_us, ws):
            st.fold(u, w)
    assert st.acc.dtype == torch.float32
    got, _ = st.result()
    rounded = fedavg_oracle([u.astype(np.float32) for u in wire_us], ws)
    np.testing.assert_allclose(got, rounded, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, fedavg_oracle(us32, ws), rtol=0.05,
                               atol=0.05)


def test_slab_preserves_wire_dtype():
    """A homogeneous bf16 burst stages through a bf16 slab (half the
    bytes); a mixed burst falls back to the f32 slab."""
    eng = _engine()
    us32, ws = _updates(k=4, n=512)
    wire = [u.astype(ml_dtypes.bfloat16) for u in us32]
    acc = eng.begin(512)
    acc = eng.fold_many(acc, wire, ws)
    assert set(eng._staging) == {"bf16"}
    assert eng._staging["bf16"].host.element_size() == 2
    mixed = [wire[0], wire[1].astype(np.float32), wire[2], wire[3]]
    eng.fold_many(acc, mixed, ws)
    assert "f32" in eng._staging
    np.testing.assert_allclose(
        eng.to_numpy(acc),
        sum(np.float32(w) * u.astype(np.float32) for u, w in zip(wire, ws))
        + sum(np.float32(w) * u.astype(np.float32) for u, w in zip(mixed, ws)),
        rtol=1e-5, atol=1e-5)


def test_recycle_reuses_the_accumulator():
    """recycle() + begin() zeroes the same buffer in place: no new
    allocation, same storage, across rounds."""
    eng = _engine()
    us, ws = _updates(k=3, n=512)
    acc = eng.begin(512)
    ptr = acc.data_ptr()
    for u, w in zip(us, ws):
        acc = eng.fold(acc, u, w)
    allocs = eng.buffer_allocs
    eng.recycle(acc)
    acc2 = eng.begin(512)
    assert eng.buffer_allocs == allocs and acc2.data_ptr() == ptr
    np.testing.assert_array_equal(eng.to_numpy(acc2), 0.0)
    acc2 = eng.fold(acc2, us[0], ws[0])
    np.testing.assert_allclose(eng.to_numpy(acc2), np.float32(ws[0]) * us[0],
                               rtol=1e-6, atol=1e-6)
    busy = eng.begin(512)              # warm buffer handed out: one-off
    assert busy.data_ptr() != ptr and eng.buffer_allocs == allocs + 1


def test_engine_on_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine()


# ---------------------------------------------------------------------------
# the publish's device-to-host copy: once per accumulator state
# ---------------------------------------------------------------------------

def test_to_numpy_copies_once_a_state_into_a_buffer_it_never_reuses():
    us, ws = _updates(k=3)
    eng = _engine()
    acc = eng.fold(eng.begin(us[0].size), us[0], ws[0])
    first = eng.to_numpy(acc)
    assert eng.to_numpy(acc) is first and eng.host_copies == 1
    kept = first.copy()
    # every writer drops the copy: a fold, a burst, a partial, a recycle
    acc = eng.fold(acc, us[1], ws[1])
    second = eng.to_numpy(acc)
    assert second is not first and eng.host_copies == 2
    acc = eng.fold_many(acc, us, ws)
    assert eng.to_numpy(acc) is not second
    acc = eng.add_partial(acc, us[2])
    third = eng.to_numpy(acc)
    np.testing.assert_array_equal(third, acc.numpy())
    eng.recycle(acc)
    acc = eng.fold(eng.begin(us[0].size), us[2], 1.0)
    assert eng.to_numpy(acc) is not third
    # what a caller kept is never written again
    np.testing.assert_array_equal(first, kept)
    assert eng.host_copies == 5


def test_to_numpy_sees_a_fold_that_moves_no_version(monkeypatch):
    """The card's kernels write through the data pointer (``ctypes``),
    which ``tensor._version`` does not see: the fold itself drops the
    cached copy."""
    import repro_torch.core.engine as engine_mod

    def pointer_write(acc, u, w):
        acc.numpy()[:] += np.float32(w) * u.numpy()   # no version bump
        return acc

    monkeypatch.setattr(engine_mod, "eager_accumulate", pointer_write)
    us, ws = _updates(k=2)
    eng = _engine()
    acc = eng.fold(eng.begin(us[0].size), us[0], ws[0])
    before, version = eng.to_numpy(acc).copy(), acc._version
    acc = eng.fold(acc, us[1], ws[1])
    assert acc._version == version
    np.testing.assert_array_equal(
        eng.to_numpy(acc), before + np.float32(ws[1]) * us[1])


def test_a_publish_copies_the_accumulator_to_the_host_once(monkeypatch):
    """A driven round on the in-process runtime: every publish asks for
    the accumulator twice (``FedAvgState.result``, then
    ``InProcRuntime._publish``) and copies it once; the values are the
    accumulator's bits, and a published partial is not changed by the
    next round."""
    from repro_torch.runtime.driver import InProcRuntime, RoundDriver
    from repro_torch.runtime.events import PartialReady

    calls = []
    orig = TorchEngine.to_numpy

    def counted(self, acc):
        calls.append((self, acc.clone()))
        return orig(self, acc)

    monkeypatch.setattr(TorchEngine, "to_numpy", counted)
    rt = InProcRuntime(agg_engine=EngineConfig(name="auto", device="cpu"))
    drv = RoundDriver(rt)
    published = []
    drv.on(PartialReady, lambda ev: published.append(
        (ev.key, rt.store.get(ev.key).copy())))
    us, ws = _updates(k=4, n=512)
    assignment = {"nodeA": [0, 1, 2, 3]}
    out = drv.run_round(round_id=0, assignment=assignment, goal=4,
                        n_elems=512, updates=[("nodeA", f"c{i}", u, w)
                                              for i, (u, w) in
                                              enumerate(zip(us, ws))])
    # the mid aggregator published once: two asks, one copy (the
    # controller's top fold copies its own accumulator once more)
    mid = rt._engines["mid@nodeA"]
    mid_calls = [acc for eng, acc in calls if eng is mid]
    assert len(published) == 1 and len(mid_calls) == 2
    assert mid.host_copies == 1 and rt._engines["top@nodeA"].host_copies == 1
    # the values: the accumulator's bits, as acc.cpu().numpy() gave them
    np.testing.assert_array_equal(published[0][1], mid_calls[0].numpy())
    np.testing.assert_allclose(out.delta, fedavg_oracle(us, ws),
                               rtol=1e-5, atol=1e-5)
    key, kept = published[0]
    drv.run_round(round_id=1, assignment=assignment, goal=4, n_elems=512,
                  updates=[("nodeA", f"d{i}", u * 3, w)
                           for i, (u, w) in enumerate(zip(us, ws))])
    assert mid.host_copies == 2
    if rt.store.contains(key):
        np.testing.assert_array_equal(rt.store.get(key), kept)
    rt.close()


# ---------------------------------------------------------------------------
# bf16 words off the port's wire: never folded as integers
# ---------------------------------------------------------------------------

def _bf16_words(us):
    from repro_torch.bf16 import BF16_WORDS

    return [np.frombuffer(u.astype(ml_dtypes.bfloat16).tobytes(),
                          dtype=BF16_WORDS) for u in us]


@pytest.mark.parametrize("name", ["naive", "blocked", "torch"])
@pytest.mark.parametrize("burst", [False, True])
def test_bf16_words_fold_as_the_widened_values(name, burst):
    """The port's wire decodes bf16 to raw words (``BF16_WORDS``): every
    engine folds them bit-equal to the same values as fp32, in a burst
    of their own and in one mixed with fp32 updates."""
    us, ws = _updates(k=4, n=777)
    words = _bf16_words(us)
    wide = [w.view(np.uint16).astype(np.uint32) << 16 for w in words]
    wide = [w.view(np.float32) for w in wide]
    np.testing.assert_array_equal(wide[0], us[0].astype(ml_dtypes.bfloat16)
                                  .astype(np.float32))
    mixed = [words[0], wide[1], words[2], wide[3]]

    def run(updates):
        eng = make_engine(EngineConfig(name=name, device="cpu"))
        acc = eng.begin(777)
        if burst:
            acc = eng.fold_many(acc, updates, ws)
        else:
            for u, w in zip(updates, ws):
                acc = eng.fold(acc, u, w)
        return np.array(eng.to_numpy(acc))

    want = run(wide)
    np.testing.assert_array_equal(run(words), want)
    np.testing.assert_array_equal(run(mixed), want)


def test_bf16_words_refuse_numpy_arithmetic():
    """Code that does not know the words cannot fold them as numbers."""
    (w,) = _bf16_words([np.ones(4, np.float32)])
    with pytest.raises((TypeError, ValueError)):
        w.astype(np.float32)
    with pytest.raises(TypeError):
        w * np.float32(2)
