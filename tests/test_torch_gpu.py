"""The CUDA kernels (fedavg, the two flash-attention forwards, int8
quantize and dequantize) against their plain PyTorch versions, and the
fused int8 round against the CPU, on the card.  Marked ``gpu``: they skip on a host
without a CUDA device or ``nvcc``.  Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where JAX is not installed.
Tolerances are the JAX package's kernel tests': 1e-6 for one fold,
1e-5 for the K-way burst and the reduce; rtol = atol = 2e-6 (fp32) and
2e-2 (bf16, and fp16) for flash attention; the eager fold and the
quantize kernels bit-equal.
"""
import pytest
import torch

from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels.fedavg import fedavg as cuda_fed
from repro_torch.kernels.fedavg import ref as tref
from repro_torch.kernels.build import nvcc
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    FLASH_SIMT, FLASH_WGMMA, LIBS as FA_LIBS)
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize.quantize import (KERNELS as Q_KERNELS,
                                                   LIB as Q_LIB,
                                                   dequantize_cuda,
                                                   quantize_cuda)
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref

WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        nvcc()
    except RuntimeError as e:      # no nvcc on this host
        pytest.skip(str(e).splitlines()[0])
    cuda_fed.build()               # a failed compile fails the test
    for lib in FA_LIBS:
        lib.build()
    Q_LIB.build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 64 * 128 * 3 + 5])
@pytest.mark.parametrize("wire", list(WIRE))
def test_cuda_kernels_match_plain_versions(card, wire, n):
    g = torch.Generator(device=card).manual_seed(0)
    k = 6
    acc = torch.randn(n, generator=g, device=card)
    U = torch.randn(k, n, generator=g, device=card).to(WIRE[wire])
    w = torch.rand(k, generator=g, device=card) + 0.5
    before = [kern.launches for kern in cuda_fed.KERNELS]
    out = acc.clone()
    ptr = out.data_ptr()
    got = tfed.eager_accumulate(out, U[0], 1.75, impl="cuda")
    assert got.data_ptr() == ptr
    torch.testing.assert_close(got, tref.eager_accumulate_ref(acc, U[0], 1.75),
                               rtol=1e-6, atol=1e-6)
    got = tfed.fedavg_accumulate_k(acc.clone(), U, w, impl="cuda")
    torch.testing.assert_close(got, tref.fedavg_accumulate_k_ref(acc, U, w),
                               rtol=1e-5, atol=1e-5)
    got = tfed.fedavg_reduce(U, w, impl="cuda")
    torch.testing.assert_close(got, tref.fedavg_reduce_ref(U, w / w.sum()),
                               rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in
            zip(cuda_fed.KERNELS, before)] == [1, 1, 1]


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    acc = torch.zeros(8, device=card)
    with pytest.raises(TypeError):
        tfed.eager_accumulate(acc, torch.ones(8, device=card,
                                              dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        tfed.eager_accumulate(acc, torch.ones(9, device=card), 1.0)
    with pytest.raises(ValueError):
        tfed.fedavg_accumulate_k(acc, torch.ones(2, 16, device=card)[:, ::2],
                                 torch.ones(2, device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 8191, 11_199_486])
@pytest.mark.parametrize("wire", list(WIRE))
@pytest.mark.parametrize("acc_off,u_off", [(0, 0), (1, 3), (3, 1), (4, 0),
                                           (2, 2)])
def test_eager_fold_is_bit_equal_on_aligned_and_misaligned_views(
        card, wire, n, acc_off, u_off):
    """The 16-byte eager fold on views that start anywhere: bit-equal to
    its plain version, in place."""
    g = torch.Generator(device=card).manual_seed(n)
    acc_buf = torch.randn(n + acc_off, generator=g, device=card)
    u_buf = torch.randn(n + u_off, generator=g, device=card).to(WIRE[wire])
    acc, u = acc_buf[acc_off:], u_buf[u_off:]
    want = tref.eager_accumulate_ref(acc, u, 1.75)
    ptr = acc.data_ptr()
    before = cuda_fed.EAGER.launches
    got = tfed.eager_accumulate(acc, u, 1.75, impl="cuda")
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr and cuda_fed.EAGER.launches == before + 1
    assert torch.equal(acc, want)


FLASH_SHAPES = [
    (1, 128, 1, 1, 32, -1), (2, 256, 2, 3, 64, -1), (1, 256, 4, 1, 64, 64),
    (2, 192, 2, 2, 32, 16), (1, 333, 2, 2, 120, 100), (1, 200, 1, 2, 256, -1),
    (1, 1, 2, 3, 128, -1), (1, 63, 2, 3, 128, -1), (1, 2000, 2, 3, 128, -1)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,D,window", FLASH_SHAPES)
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "float16"])
def test_flash_kernel_matches_plain_version(card, B, S, K, G, D, window,
                                            wire):
    g = torch.Generator(device=card).manual_seed(S)
    mk = lambda *shape: torch.randn(shape, generator=g,
                                    device=card).to(WIRE[wire])
    q, k, v = mk(B, S, K, G, D), mk(B, S, K, D), mk(B, S, K, D)
    kw = dict(window=window, causal=True, scale=D ** -0.5)
    before = (FLASH_WGMMA.launches, FLASH_SIMT.launches)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    # 16-bit inputs on the tensor cores, fp32 on the CUDA cores
    step = (0, 1) if wire == "float32" else (1, 0)
    assert (FLASH_WGMMA.launches - before[0],
            FLASH_SIMT.launches - before[1]) == step
    tol = 2e-6 if wire == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_wrapper_refuses_head_dims_over_256(card):
    q = torch.zeros(1, 8, 1, 1, 320, device=card)
    k = torch.zeros(1, 8, 1, 320, device=card)
    with pytest.raises(ValueError, match="up to 256"):
        flash_attention(q, k, k, scale=1.0)


@pytest.mark.gpu
def test_lm_prefill_on_the_card_matches_the_cpu(card):
    from repro_torch.configs import ARCHS
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(ARCHS["gemma3-4b"].reduced(dtype="float32"),
                        ModelOptions(attn_impl="pallas", remat=False))
    params = model.init(0, device="cpu")
    toks = torch.randint(0, 256, (2, 150), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    before = (FLASH_SIMT.launches, FLASH_WGMMA.launches)
    got, _ = model.prefill(tree_map(lambda t: t.to(card), params),
                           {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    # one per layer, fp32 on the CUDA-core kernel
    assert (FLASH_SIMT.launches, FLASH_WGMMA.launches) == \
        (before[0] + 2, before[1])
    want, _ = model.prefill(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _equal_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.is_floating_point:
        a, b = a.contiguous().view(torch.int16 if a.element_size() == 2
                                   else torch.int32), \
            b.contiguous().view(torch.int16 if b.element_size() == 2
                                else torch.int32)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["256", "773", "100", "70000", "zeros",
                                  "bf16", "b64", "b200"])
def test_quantize_kernels_match_plain_versions_bit_for_bit(card, case):
    g = torch.Generator(device=card).manual_seed(1)
    n, block, dtype = {"256": (256, 256, "float32"),
                       "773": (773, 256, "float32"),
                       "100": (100, 256, "float32"),
                       "70000": (70000, 256, "float32"),
                       "zeros": (512, 256, "float32"),
                       "bf16": (773, 256, "bfloat16"),
                       "b64": (64 * 37 + 9, 64, "float32"),
                       "b200": (200 * 11, 200, "float32")}[case]
    x = torch.randn(n, generator=g, device=card) * 3
    if case == "zeros":
        x.zero_()
    x = x.to(WIRE[dtype])
    before = [k.launches for k in Q_KERNELS]
    q, s = qops.quantize(x, block=block)
    qr, sr = qops.quantize(x, block=block, impl="torch")
    _equal_bits(q, qr)
    _equal_bits(s, sr)
    for out_dtype in (torch.float32, torch.bfloat16):
        back = qops.dequantize(q, s, n, out_dtype=out_dtype)
        _equal_bits(back, qops.dequantize(q, s, n, out_dtype=out_dtype,
                                          impl="torch"))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(Q_KERNELS, before)] == [1, 2]
    # error bound: |x - deq| <= scale/2 per block
    err = (qops.dequantize(q, s, n) - x.float()).abs()
    assert bool((err <= s.repeat_interleave(block)[:n] / 2 + 1e-7).all())


@pytest.mark.gpu
def test_quantize_wrappers_refuse_what_the_kernels_do_not_take(card):
    with pytest.raises(ValueError, match="1 to 256"):
        quantize_cuda(torch.zeros(2, 300, device=card))
    with pytest.raises(TypeError):
        quantize_cuda(torch.zeros(2, 8, device=card,
                                         dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        quantize_cuda(torch.zeros(8, 4, device=card).t())
    with pytest.raises(ValueError, match="scales"):
        dequantize_cuda(torch.zeros(2, 8, device=card,
                                           dtype=torch.int8),
                               torch.ones(3, device=card))


@pytest.mark.gpu
def test_fused_int8_round_on_the_card_matches_the_cpu(card):
    from repro_torch.configs import ARCHS
    from repro_torch.data.loader import CohortTokenLoader
    from repro_torch.fl.round import AggregationConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import FusedFLTrainer
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["llama3.2-3b"].reduced(dtype="float32")
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    agg = AggregationConfig(compress="int8", num_microbatches=2)
    batch = CohortTokenLoader(cfg.vocab_size, 32, 4).round_batch(8, 0)
    cpu = FusedFLTrainer(cfg, mesh, agg, device="cpu")
    cpu.init(0)
    on_card = FusedFLTrainer(cfg, mesh, agg)
    on_card.params = tree_map(lambda t: t.to(card), cpu.params)
    on_card.server_state = tree_map(lambda t: t.to(card), cpu.server_state)
    before = [k.launches for k in Q_KERNELS]
    got = on_card.train_round(batch)
    torch.cuda.synchronize()
    n_leaves = len(tree_leaves(cpu.params))
    assert [k.launches - b for k, b in zip(Q_KERNELS, before)] == \
        [2 * n_leaves, 2 * n_leaves]
    steps = _pod_steps(cpu, batch)
    want = cpu.train_round(batch)
    assert abs(got["loss"] - want["loss"]) < 1e-5
    # the two-part limit: at most 0.1 % of elements over 1e-5, none over
    # one quantization step of its block (s / n_pods x server_lr)
    diffs = [(a.cpu() - b).abs() for a, b in
             zip(tree_leaves(on_card.params), tree_leaves(cpu.params))]
    over = sum(int((d > 1e-5).sum()) for d in diffs)
    assert over <= 1e-3 * sum(d.numel() for d in diffs)
    assert all(bool((d <= st + 1e-5).all()) for d, st in zip(diffs, steps))


def _pod_steps(trainer, batch):
    """Per element, the largest quantization step of its block over the
    pods' deltas of the round about to run (on the CPU trainer)."""
    from repro_torch.fl import compression
    from repro_torch.fl.round import accumulate_updates
    from repro_torch.tree import tree_leaves

    n_pods, agg = trainer.mesh.shape["pod"], trainer.agg
    steps = None
    for i in range(n_pods):
        b = {k: torch.from_numpy(v[i * len(v) // n_pods:
                                   (i + 1) * len(v) // n_pods])
             for k, v in batch.items()}
        d, _, _ = accumulate_updates(trainer.model, trainer.params, b, agg)
        per = []
        for leaf in tree_leaves(d):
            _, safe, last = compression._quantize_blocks_last_axis(leaf, 256)
            st = safe.repeat_interleave(min(256, last), dim=-1)[..., :last]
            per.append(st.reshape(leaf.shape) / n_pods * agg.server_lr)
        steps = per if steps is None else [torch.maximum(a, c)
                                           for a, c in zip(steps, per)]
    return steps


# ---------------------------------------------------------------------------
# the multi-process and multi-node runtimes on the card
# ---------------------------------------------------------------------------

def _small_fleet(device, n_clients=6):
    from repro_torch.configs.resnet import RESNET18
    from repro_torch.core import ClientInfo
    from repro_torch.data import (build_client_datasets, dirichlet_partition,
                                  synthetic_femnist)
    from repro_torch.models.resnet import build_resnet
    from repro_torch.runtime import ClientRuntime

    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(96, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, n_clients, alpha=0.5)
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]
    return model, model.init(0, device=device), clients


@pytest.mark.gpu
def test_shmproc_round_after_card_training_survives_a_respawn(card):
    """Forked numpy workers after the parent trained clients on the card:
    a cold round, a warm one, then a busy worker SIGKILLed mid-round is
    replaced by a fresh fork and the round still folds its full goal.
    Against an inproc session on the card within 3e-4, both training
    with cuDNN's deterministic algorithms (otherwise two sessions'
    convolutions differ run to run, and three rounds of SGD carry it
    past the limit)."""
    import os

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got, want, prefix = _shmproc_and_inproc_rounds(card)
    finally:
        torch.backends.cudnn.deterministic = was
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) < 3e-4


def _shmproc_and_inproc_rounds(card):
    import os
    import signal

    from repro_torch.api import Session
    from repro_torch.core import RoundConfig
    from repro_torch.runtime.events import UpdateArrived, WorkerCrashed
    from repro_torch.tree import tree_leaves

    model, params, clients = _small_fleet(card)
    cfg = lambda: RoundConfig(aggregation_goal=4)   # noqa: E731
    with Session.open(model, params, clients, round_cfg=cfg(),
                      seed=0) as ref:
        for _ in range(3):
            ref.run_round(client_lr=0.05, client_batch_size=16)
        want = [l.detach().cpu() for l in tree_leaves(ref.params)]
    crashes, seen = [], []
    with Session.open(model, params, clients, runtime="shmproc",
                      round_cfg=cfg(), seed=0) as s:
        for _ in range(2):
            assert s.run_round(client_lr=0.05,
                               client_batch_size=16)["updates"] == 4.0
        shm = s.trainer._runtime._rt

        def kill(ev):
            seen.append(ev)
            if len(seen) == 2:
                busy = [w for w in shm._workers if w.state == "busy"]
                os.kill(busy[0].proc.pid, signal.SIGKILL)

        s.on(UpdateArrived, kill)
        s.on(WorkerCrashed, crashes.append)
        rec = s.run_round(client_lr=0.05, client_batch_size=16)
        assert rec["updates"] == 4.0 and rec["redispatched"] >= 1
        assert crashes and shm.stats["forked"] >= 2
        assert shm.stats["warm_starts"] >= 1
        got = [l.detach().cpu() for l in tree_leaves(s.params)]
        return got, want, shm.prefix


@pytest.mark.gpu
def test_netd_on_the_card_folds_with_the_kernels(card):
    """A daemon started without ``--device`` folds on the card: its
    ``stats_reply`` says ``cuda`` and counts one eager fold launch per
    update, and the round's delta is bit-equal to the blocked numpy
    engine's (the eager kernel rounds where numpy does)."""
    import subprocess

    import numpy as np

    from repro_torch.core.engine import EngineConfig
    from repro_torch.runtime.driver import InProcRuntime, RoundDriver
    from repro_torch.runtime.netrt import (RemoteRuntime, connect,
                                           reap_local_daemon,
                                           spawn_local_daemon)

    n = 1 << 20
    rng = np.random.default_rng(0)
    ups = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    ws = [1.0, 2.0, 3.5, 0.5]

    def drive(rt):
        out = RoundDriver(rt).run_round(
            round_id=0, assignment={"nodeA": [0, 1, 2, 3]},
            updates=(("nodeA", f"c{i}", u, w)
                     for i, (u, w) in enumerate(zip(ups, ws))),
            goal=4, n_elems=n)
        rt.close()
        return out.delta

    want = drive(InProcRuntime(agg_engine="blocked"))
    proc, addr = spawn_local_daemon("nodeA", stdout=subprocess.DEVNULL,
                                    timeout=120.0)
    try:
        got = drive(RemoteRuntime([addr], agg_engine=EngineConfig(
            name="auto", device="cuda")))
        conn = connect(addr, timeout=10.0)
        conn.send("hello", {"role": "client"})
        conn.recv_expect(("welcome",), 10.0)
        conn.send("stats", {})
        meta = conn.recv_expect(("stats_reply",), 10.0).meta
        conn.close()
    finally:
        reap_local_daemon(proc)
    assert meta["device"].startswith("cuda")
    assert meta["kernel_launches"]["eager_accumulate"] == 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_service_on_the_card_folds_with_the_kernels_and_copies_once(
        card, monkeypatch):
    """``AggregationService()`` lands on the card: a two-job round of
    external updates folds through the fedavg kernels, each publish
    copies its accumulator to pinned host memory once, and the deltas
    are the CPU service's within the burst kernel's 1e-5 (a delivery
    that finds several updates queued folds them as one burst)."""
    import numpy as np

    from repro_torch.core import (ClientInfo, NodeState, RoundConfig,
                                  TorchEngine)
    from repro_torch.runtime.events import PartialReady
    from repro_torch.serve import AggregationService, GoalPolicy

    class Model:
        def loss(self, params, batch):
            return (params["w"] ** 2).sum(), {}

    n = 1 << 20
    rng = np.random.default_rng(0)
    ups = {f"{j}-u{k}": rng.standard_normal(n).astype(np.float32)
           for j in ("a", "b") for k in range(4)}

    def run(device):
        nodes = {f"node{i}": NodeState(node=f"node{i}", max_capacity=20.0)
                 for i in range(2)}
        svc = AggregationService(nodes, **({} if device is None
                                           else {"device": device}))
        published = []
        svc.driver.on(PartialReady, published.append)
        try:
            for j, w in (("a", 2.0), ("b", 1.0)):
                svc.add_job(j, Model(), {"w": torch.zeros(n)},
                            [ClientInfo(f"{j}-r{i}", 10) for i in range(8)],
                            weight=w,
                            round_cfg=RoundConfig(aggregation_goal=4))
            for cid, u in ups.items():
                svc.submit(cid[0], cid, u, 1.0 + int(cid[-1]))
            recs = svc.run_rounds({"a": 1, "b": 1}, policy=GoalPolicy())
            mids = [e for k, e in svc.runtime._engines.items()
                    if k.startswith("mid")]
            out = {r["job"]: np.asarray(r["outcome"].delta) for r in recs}
            params = svc.trainer("a").params["w"]
            return out, published, mids, params
        finally:
            svc.close()

    pinned = []
    to_numpy = TorchEngine.to_numpy

    def spy(self, acc):
        arr = to_numpy(self, acc)
        pinned.append(torch.from_numpy(arr).is_pinned())
        return arr

    before = sum(k.launches for k in cuda_fed.KERNELS)
    monkeypatch.setattr(TorchEngine, "to_numpy", spy)
    got, published, mids, params = run(None)
    monkeypatch.undo()
    assert params.device.type == "cuda"
    assert sum(k.launches for k in cuda_fed.KERNELS) - before >= 2
    assert sum(e.elements_folded for e in mids) == 8 * n
    assert sum(e.host_copies for e in mids) == len(published) == 2
    assert pinned and all(pinned)
    want, *_ = run("cpu")
    for job in ("a", "b"):
        np.testing.assert_allclose(got[job], want[job], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A bf16 LM tree on the card: ``AsyncCheckpointer.submit`` copies it
    to pinned host memory before it returns, and a restore onto the card
    or the CPU gives the same bits."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.configs import ARCHS
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.tree import tree_leaves

    cfg = ARCHS["llama3.2-3b"].reduced(dtype="bfloat16")
    params = build_model(cfg, ModelOptions(attn_impl="naive",
                                           remat=False)).init(0)
    want = [t.clone() for t in tree_leaves(params)]
    ck = AsyncCheckpointer(tmp_path)
    ck.submit(1, params)
    for t in tree_leaves(params):
        t.add_(1)
    ck.wait()
    for device in (None, "cpu"):
        got, step = restore_checkpoint(tmp_path, like=params, device=device)
        assert step == 1
        for g, w in zip(tree_leaves(got), want):
            assert g.dtype == w.dtype
            assert g.device.type == (device or "cuda")
            assert torch.equal(g.cpu(), w.cpu())
