#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Drives ``repro_torch`` end to end on the card and fails (non-zero exit)
on any fault; it imports nothing of the JAX package.  Phases:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for convolutions and matmuls, and
   so is the reduced-precision reduction of bf16 matmuls.
2. build: compiles ``csrc/fedavg.cu``, both flash sources
   (``csrc/flash_attention_sm90.cu``, ``csrc/flash_attention.cu``) and
   ``csrc/quantize.cu`` with ``nvcc``, one process each, at once, into
   ``build/repro_torch/`` and times it; measures the card's
   device-to-device copy bandwidth, the practical ceiling of a fold.
3. kernels: each fedavg CUDA kernel against its plain PyTorch version
   at the ResNet-18 update size (N = 11,199,486), one JSON line per
   case: errors, kernel / plain / library times (CUDA events around a
   run of back-to-back calls, median of the runs) and the bound at the
   nominal and the measured bandwidth.  The eager fold must be bit-equal
   to its plain version, also on views that start off 16 bytes
   (``acc[1:]``, ``u[3:]``), and is timed beside its first design
   (``previous_ms``).
4. engine: the port's ``Aggregator`` on ``TorchEngine(cuda)`` folds six
   ResNet-18-sized updates, eager and lazy, against ``fedavg_oracle``.
5. round: ``repro_torch.api.Session`` on full-width ResNet-18 (random
   weights from a seed) and synthetic FEMNIST: two eager rounds, then
   one lazy round; the launch counts are zeroed just before and read
   just after, and both accumulate kernels must have run.  Then the
   same path at reduced width on the card and on the CPU (the kernels'
   plain versions) must give the same params within ``PARITY_ATOL``,
   and a run with one update planted twice must not.
6. flash: the flash-attention kernels against their plain version
   (``attention_ref``): 16-bit inputs go to the wgmma kernel, fp32 to
   the CUDA-core one, and each call must move that kernel's count.  At
   the serve path's shape (B = 4, S = 2000, 24 query heads over 8 KV
   heads, D = 128) in bf16, fp16 and fp32; at gemma3's (K 4, G 2, D 256,
   window 1024) and h2o-danube-3-4b's (K 8,
   G 4, D 120, window 4096) in bf16; and at the four shapes of the JAX
   package's kernel test in all three.  One ``flash_case`` JSON line
   each, with the library call (``scaled_dot_product_attention``) as the
   yardstick, the bound at the bf16 (or fp32) peak and, for 16-bit
   inputs, the CUDA-core kernel on the same inputs (``previous_ms``).
7. serve: full-width llama3.2-3b (random bf16 weights from seed 0)
   through ``repro_torch.models``: prefill of 4 prompts of 2000 tokens
   with ``attn_impl="pallas"``, then 32 greedy decode steps on the ring
   KV cache (``examples/serve_decode.py``'s loop).  The flash counts are
   zeroed just before the prefill and must read 28 (one per layer) for
   the wgmma kernel and 0 for the CUDA-core one just after; the logits
   must be finite; q, k and v of the first and last
   layers are captured and the kernel is held against its plain version
   on them.  Two more prefills give the warm time; one prefill and one
   decode step under ``torch.profiler`` split the device time into the
   attention kernel, matmuls and the rest, and give the device's idle
   share; a decode step is set beside the time to read every weight
   once at the measured copy rate.
8. lm checks (reduced llama3.2-3b, fp32): on the card, prefill of S
   tokens against prefill of S - 1 plus ``decode_step`` (the JAX
   package's 2e-3); then the serve loop on the card (the kernel) against
   the CPU (the plain version): greedy tokens equal and logits within
   ``LM_PARITY_ATOL``, and the same loop with the KV heads rolled by one
   before the kernel in the first layer must land above it.  In fp32
   the loop runs the CUDA-core flash kernel: its counts are zeroed just
   before the card's loop and read just after.
9. summary, printed last: a ``{"kernels": [...]}`` line (phase 3's
   rows at the main path's shapes, the burst timed again at the lazy
   round's K, the wgmma flash row on the serve path's captured
   first-layer inputs, the CUDA-core flash row at the serve shape in
   fp32 with its launches from phase 8, and phase 10's quantize rows at
   the fused round's largest leaf), the device line, and the last line
   ``{"ok": true, "device": {...}}``.
10. quant: the int8 quantize and dequantize CUDA kernels against their
   plain versions, bit for bit (q, scales, dequantized fp32 and bf16)
   and within half a scale of the input, at the JAX package's
   kernel-test sizes, an all-zero input, bf16 input and row widths 64
   and 200; then at the fused round's largest leaf, the (128256, 3072)
   fp32 embedding delta, timed against the plain versions and, for
   dequantize, one ``torch.mul``.
11. fused round: full-width llama3.2-3b (bf16, random params from seed
   0) through ``FusedFLTrainer``: one hierarchical int8 round on a
   2-pod mesh (each pod 4 sequences of 512 tokens in 2 microbatches,
   ``attn_impl="chunked"``, ``remat=True``) with every launch count
   zeroed just before and read just after (quantize and dequantize once
   per leaf and pod), one ``compress="none"`` round from the same params
   (the int8 params within 5 % relative of these), a warm int8 round,
   and one under ``torch.profiler`` for the device split.
12. round parity (reduced llama3.2-3b, fp32): one int8 round on the
   card against the CPU within the two-part limit (at most 0.1 % of
   elements over 1e-5, none over one quantization step of its block),
   and the card with one pod's delta counted twice above it.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.resnet import RESNET18  # noqa: E402
from repro_torch.core import (Aggregator, ClientInfo, InProcObjectStore,  # noqa: E402
                              NodeState, RoundConfig, TorchEngine,
                              UpdateEnvelope, fedavg_oracle)
from repro_torch.data import (ClientShard, build_client_datasets,  # noqa: E402
                              dirichlet_partition, synthetic_femnist)
from repro_torch.data.loader import CohortTokenLoader  # noqa: E402
from repro_torch.data.synthetic import TokenTaskStream  # noqa: E402
from repro_torch.fl import compression  # noqa: E402
from repro_torch.fl.round import (AggregationConfig,  # noqa: E402
                                  accumulate_updates)
from repro_torch.fl.server import init_server_state  # noqa: E402
from repro_torch.kernels.fedavg import fedavg as fed  # noqa: E402
from repro_torch.kernels.fedavg import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    FLASH_SIMT, FLASH_WGMMA, GLOBAL, KERNELS as FA_KERNELS, LIBS as FA_LIBS,
    flash_attention_fwd_cuda)
from repro_torch.kernels.quantize import ops as q_ops  # noqa: E402
from repro_torch.kernels.quantize import ref as q_ref  # noqa: E402
# the package's name ``quantize`` is the op; the wrappers' module by path
from repro_torch.kernels.quantize.quantize import (  # noqa: E402
    DEQUANTIZE, KERNELS as Q_KERNELS, LIB as Q_LIB, QUANTIZE,
    dequantize_cuda, quantize_cuda)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.models.resnet import build_resnet  # noqa: E402
from repro_torch.runtime import (ClientRuntime, FusedFLTrainer,  # noqa: E402
                                 PartialReady)
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,  # noqa: E402
                              tree_unflatten)

N_RESNET18 = 11_199_486      # fp32 parameters of RESNET18
NOMINAL_BPS = 3.35e12        # H100 SXM HBM3, NVIDIA's data sheet
FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12          # H100 SXM bf16 dense tensor cores
RTOL = {"eager_accumulate": 1e-6, "fedavg_accumulate_k": 1e-5,
        "fedavg_reduce": 1e-5}
PARITY_ATOL = 3e-4           # card vs CPU params, phase 5
CLIENT_LR = 0.01             # the paper's client SGD (§6.2: lr 0.01, batch 32)
#: flash kernel vs its plain version, rtol = atol: the JAX package's
#: kernel test (tests/test_kernels.py:134), at every shape
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2,
             torch.float16: 2e-2}
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "llama3.2-3b", 4, 2000, 32
LM_PARITY_ATOL = 2e-3        # card vs CPU logits, phase 8
FUSED_SEQ = 512              # tokens a sequence in the fused round, phase 11


def log(*args) -> None:
    print(*args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3, inner: int = 10) -> float:
    """Device ms a call: CUDA events around ``inner`` back-to-back calls
    (so the host's launch cost hides behind the queue, as on the path),
    median over ``reps`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def copy_bandwidth() -> float:
    """Device-to-device copy rate in bytes/s (read + write counted)."""
    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")  # 1 GiB
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=20)
    return 2 * src.numel() * 4 / (ms * 1e-3)


def errors(got, want):
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d / want.double().abs().clamp_min(1e-30)).max())


def check_close(name, got, want, rtol) -> None:
    """|got - ref| <= rtol + rtol·|ref| elementwise (atol = rtol, as the
    JAX package's kernel tests state)."""
    bad = (got - want).abs() > rtol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"rtol=atol={rtol}")


def kernel_case(name, dtype, k, copy_bps, n=N_RESNET18, view=(0, 0)):
    """One kernel at one dtype and K against its plain version; the
    eager fold on views ``acc_buf[view[0]:]`` and ``u_buf[view[1]:]``,
    bit-equal, and timed beside its first design too."""
    g = torch.Generator(device="cuda").manual_seed(0)
    acc0 = torch.randn(n, generator=g, device="cuda")
    esz = torch.tensor([], dtype=dtype).element_size()
    previous = None
    if name == "eager_accumulate":
        a_off, u_off = view
        u = torch.randn(n + u_off, generator=g,
                        device="cuda").to(dtype)[u_off:]
        w = 1.75
        acc = torch.empty(n + a_off, device="cuda")[a_off:].copy_(acc0)
        ptr = acc.data_ptr()
        want = ref.eager_accumulate_ref(acc0, u, w)
        got = ops.eager_accumulate(acc, u, w, impl="cuda").clone()
        torch.cuda.synchronize()
        if acc.data_ptr() != ptr or not torch.equal(got, want):
            raise AssertionError(f"eager_accumulate[{dtype}, view {view}]: "
                                 "not bit-equal in place")
        run = lambda: ops.eager_accumulate(acc, u, w, impl="cuda")
        previous = lambda: fed.eager_accumulate_cuda(
            acc, u, w, kernel=fed.EAGER_PREVIOUS)
        plain = lambda: ref.eager_accumulate_ref(acc, u, w)
        library = lambda: torch.add(acc, u, alpha=w, out=acc)
        nbytes = (8 + esz) * n
        flops = 2 * n
    else:
        U = torch.randn(k, n, generator=g, device="cuda").to(dtype)
        w = torch.rand(k, generator=g, device="cuda") * 3.5 + 0.5
        if name == "fedavg_accumulate_k":
            got = ops.fedavg_accumulate_k(acc0.clone(), U, w, impl="cuda")
            want = ref.fedavg_accumulate_k_ref(acc0, U, w)
            acc = acc0.clone()
            run = lambda: ops.fedavg_accumulate_k(acc, U, w, impl="cuda")
            plain = lambda: ref.fedavg_accumulate_k_ref(acc, U, w)
            library = (lambda: acc.addmv_(U.t(), w)) \
                if dtype == torch.float32 else None
            nbytes = (8 + k * esz) * n + 4 * k
            flops = (2 * k + 1) * n
        else:
            wn = w / w.sum()
            got = fed.fedavg_reduce_cuda(U, wn)
            want = ref.fedavg_reduce_ref(U, wn)
            run = lambda: fed.fedavg_reduce_cuda(U, wn)
            plain = lambda: ref.fedavg_reduce_ref(U, wn)
            library = (lambda: torch.mv(U.t(), wn)) \
                if dtype == torch.float32 else None
            nbytes = (4 + k * esz) * n + 4 * k
            flops = 2 * k * n
    torch.cuda.synchronize()
    check_close(f"{name}[{dtype}, K={k}]", got, want, RTOL[name])
    max_abs, max_rel = errors(got, want)
    del got, want
    # the eager fold's two designs in turns (new, first, first, new),
    # the better median of each
    ms = time_ms(run)
    prev_ms = None
    if previous:
        prev_ms = min(time_ms(previous), time_ms(previous))
    row = {
        "name": name, "dtype": str(dtype).replace("torch.", ""), "K": k,
        "N": n, "view": list(view), "max_abs_err": max_abs,
        "max_rel_err": max_rel, "ms": min(ms, time_ms(run)),
        "previous_ms": prev_ms, "plain_ms": time_ms(plain),
        "library_ms": time_ms(library) if library else None,
        "bytes": nbytes, "flops": flops,
        # the larger of moving the bytes once and doing the operations
        "bound_ms": max(nbytes / NOMINAL_BPS, flops / FP32_FLOPS) * 1e3,
        "bound_copy_ms": nbytes / copy_bps * 1e3,
        "bound_by": ("bytes" if nbytes / NOMINAL_BPS >= flops / FP32_FLOPS
                     else "operations"),
    }
    return row


def phase_kernels(copy_bps):
    rows = []
    cases = [("eager_accumulate", torch.float32, 1, (0, 0)),
             ("eager_accumulate", torch.float32, 1, (1, 3)),
             ("eager_accumulate", torch.bfloat16, 1, (0, 0)),
             ("eager_accumulate", torch.bfloat16, 1, (1, 3)),
             ("eager_accumulate", torch.float16, 1, (0, 0)),
             ("fedavg_accumulate_k", torch.float32, 8, (0, 0)),
             ("fedavg_accumulate_k", torch.bfloat16, 8, (0, 0)),
             ("fedavg_reduce", torch.float32, 8, (0, 0))]
    for name, dtype, k, view in cases:
        row = kernel_case(name, dtype, k, copy_bps, view=view)
        log("kernel_case " + json.dumps(row))
        rows.append(row)
    return rows


def phase_engine():
    rng = np.random.default_rng(0)
    us = [rng.standard_normal(N_RESNET18).astype(np.float32)
          for _ in range(6)]
    ws = [float(w) for w in rng.uniform(0.5, 8.0, size=6)]
    want = fedavg_oracle(us, ws)
    eng = TorchEngine("cuda")
    for eager in (True, False):
        store = InProcObjectStore()
        agg = Aggregator("smoke", store, goal=len(us), eager=eager,
                         engine=eng, batch_k=8)
        for u, w in zip(us, ws):
            agg.recv(UpdateEnvelope(store.put(u), 0, "c", w,
                                    enqueue_ts=time.perf_counter()))
        if not eager:
            agg.flush()
        if not agg.done:
            raise AssertionError("aggregator did not reach its goal")
        got, weight = agg.result
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        log(f"engine eager={eager}: folded {len(us)} x {N_RESNET18} "
            f"in {agg.agg_exec_s:.4f} s, max_abs_err "
            f"{float(np.abs(got - want).max()):.3e}")
        eng.recycle()
        store.close()
    # one fold's host-side staging: pinned copy plus host-to-device
    st = eng._staging_for("f32", 1, N_RESNET18)
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        st.fill([us[0]])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stage_s = sorted(times)[len(times) // 2]
    log(f"engine staging: {N_RESNET18 * 4 / 1e6:.1f} MB host->device in "
        f"{stage_s * 1e3:.3f} ms (median of 7)")
    return stage_s


def phase_round():
    model = build_resnet(RESNET18)
    params = model.init(seed=0, device="cuda")
    n_params = sum(l.numel() for l in tree_leaves(params))
    if n_params != N_RESNET18:
        raise AssertionError(f"RESNET18 has {n_params} params")
    imgs, labels = synthetic_femnist(512, num_classes=62, seed=0)
    shards = dirichlet_partition(labels, 8, alpha=0.5)
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]
    test = {"images": imgs[:256], "labels": labels[:256]}
    nodes = lambda: {f"node{i}": NodeState(node=f"node{i}", max_capacity=20)
                     for i in range(3)}
    before = [l.clone() for l in tree_leaves(params)]
    lazy_counts = []

    def agg_exec(s) -> float:
        return sum(v for k, v in s.metrics()["sidecar"].items()
                   if k.endswith("/agg_exec_s"))

    def one_round(s, label):
        e0 = agg_exec(s)
        torch.cuda.synchronize()
        rec = s.run_round(client_lr=CLIENT_LR, client_batch_size=32)
        torch.cuda.synchronize()
        bd = s.trace().breakdown()
        row = {"round": label, "updates": rec["updates"],
               "nodes_used": rec["nodes_used"], "wall_s": rec["wall_s"],
               "agg_exec_s": agg_exec(s) - e0,
               "eval_loss": s.evaluate(test)["loss"]}
        row.update({f"trace_{k}": v for k, v in bd.items()})
        log("round " + json.dumps(row))
        return row

    for k in fed.KERNELS:
        k.launches = 0
    rows = []
    with Session.open(model, params, clients, nodes=nodes(),
                      round_cfg=RoundConfig(aggregation_goal=6),
                      seed=0) as s:
        log(f"round: before eval_loss {s.evaluate(test)['loss']:.6f}")
        rows.append(one_round(s, "eager-0"))
        rows.append(one_round(s, "eager-1"))
        params = s.params
    with Session.open(model, params, clients, nodes=nodes(),
                      round_cfg=RoundConfig(aggregation_goal=6, eager=False),
                      seed=1) as s:
        s.on(PartialReady, lambda ev: lazy_counts.append(ev.count))
        rows.append(one_round(s, "lazy-2"))
        params = s.params
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in fed.KERNELS}
    log("round launches " + json.dumps(launches))
    after = tree_leaves(params)
    if not all(bool(torch.isfinite(l).all()) for l in after):
        raise AssertionError("non-finite params after the rounds")
    if not any(bool((a != b).any()) for a, b in zip(after, before)):
        raise AssertionError("params did not change")
    for name in ("eager_accumulate", "fedavg_accumulate_k"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by the rounds")
    return rows, launches, max(lazy_counts)


@contextlib.contextmanager
def planted_fault():
    """A misweighted update, planted for the parity check to catch: the
    first single fold counts its update twice (w -> 2w) while the
    aggregator's weight sum keeps w."""
    orig = TorchEngine.fold
    left = [1]

    def fold(self, acc, update, w):
        if left[0]:
            left[0] -= 1
            w = 2.0 * w
        return orig(self, acc, update, w)

    TorchEngine.fold = fold
    try:
        yield
    finally:
        TorchEngine.fold = orig
    if left[0]:
        raise AssertionError("the planted fault never fired")


def small_rounds(device):
    """Reduced ResNet-18, six clients of eight samples: one eager and one
    lazy round from params made from seed 0; the leaves on the host."""
    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(48, num_classes=62, seed=0)
    shards = [ClientShard(f"client{i}", np.arange(8 * i, 8 * i + 8))
              for i in range(6)]
    params = model.init(seed=0, device=device)
    for eager, seed in ((True, 0), (False, 1)):
        clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
                   for d in build_client_datasets(imgs, labels, shards)]
        with Session.open(
                model, params, clients, device=device, seed=seed,
                nodes={f"node{i}": NodeState(node=f"node{i}", max_capacity=3)
                       for i in range(2)},
                round_cfg=RoundConfig(aggregation_goal=4, eager=eager)) as s:
            s.run_round(client_lr=0.05, client_batch_size=8)
            params = s.params
    return [l.detach().cpu() for l in tree_leaves(params)]


def phase_parity():
    """The main path on the card against the same path on the CPU (the
    kernels' plain versions), on a small input.  cuDNN and the CPU sum
    convolutions and GroupNorm statistics in different orders (cuDNN
    not the same way on every run), and two rounds of SGD carry those
    fp32 differences into the params, so the two agree within
    ``PARITY_ATOL`` and not bit for bit.  The same path with one update
    counted twice (``planted_fault``) must land outside it: the check
    has a reading on each side of its limit in every run."""
    # oneDNN's CPU conv backward has crashed at odd batch sizes; the
    # CPU side of this check does not need it
    torch.backends.mkldnn.enabled = False
    cpu = small_rounds("cpu")
    torch.backends.mkldnn.enabled = True
    card = small_rounds("cuda")
    with planted_fault():
        faulted = small_rounds("cuda")
    diff = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b))
    sound, planted = diff(card, cpu), diff(faulted, cpu)
    log("parity " + json.dumps({"max_abs_diff": sound,
                                "planted_fault_max_abs_diff": planted,
                                "atol": PARITY_ATOL}))
    if not sound <= PARITY_ATOL:
        raise AssertionError(f"card vs CPU: {sound:.3e} > {PARITY_ATOL}")
    if not planted > PARITY_ATOL:
        raise AssertionError(f"a misweighted update moved the params by "
                             f"{planted:.3e}, inside {PARITY_ATOL}")


def visible_pairs(S: int, window: int) -> int:
    """(i, j) pairs a causal attention of length S computes: what the
    kernel must do, whatever tiles it visits."""
    if window == GLOBAL:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_row(label, q, k, v, window):
    """The flash kernel that takes (q, k, v) against its plain version,
    timed beside the library's attention on the same inputs and, for
    16-bit inputs, beside the CUDA-core kernel (``previous_ms``)."""
    B, S, K, G, D = q.shape
    Dv = v.shape[-1]
    H = K * G
    scale = D ** -0.5
    kw = dict(window=window, causal=True, scale=scale)
    run = lambda: fa_ops.flash_attention(q, k, v, impl="cuda", **kw)
    plain = lambda: fa_ops.flash_attention(q, k, v, impl="torch", **kw)
    simt = lambda: flash_attention_fwd_cuda(q, k, v, variant="simt", **kw)
    kern = FLASH_SIMT if q.dtype == torch.float32 else FLASH_WGMMA
    n0 = [kn.launches for kn in FA_KERNELS]
    got, want = run(), plain()
    torch.cuda.synchronize()
    moved = [kn.launches - c for kn, c in zip(FA_KERNELS, n0)]
    if moved != [int(kn is kern) for kn in FA_KERNELS]:
        raise AssertionError(f"flash[{label}]: launches {moved}, not one of "
                             f"{kern.name}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash[{label}]: non-finite output")
    tol = FLASH_TOL[q.dtype]
    check_close(f"flash[{label}]", got.float(), want.float(), tol)
    max_abs, max_rel = errors(got.float(), want.float())
    del got, want
    qh = q.reshape(B, S, H, D).transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    if window == GLOBAL:
        library = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True, scale=scale)
    else:
        i = torch.arange(S, device=q.device)
        band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        library = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=band, enable_gqa=True, scale=scale)
    esz = q.element_size()
    nbytes = esz * (q.numel() + k.numel() + v.numel() + B * S * H * Dv)
    flops = 2 * B * H * visible_pairs(S, window) * (D + Dv)
    peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    reps = 25 if S <= 256 else 10
    # the two designs in turns (wgmma, CUDA cores, CUDA cores, wgmma)
    ms = time_ms(run, reps=reps)
    prev_ms = None
    if kern is FLASH_WGMMA:
        prev_ms = min(time_ms(simt, reps=reps), time_ms(simt, reps=reps))
    return {
        "case": label, "dtype": str(q.dtype).replace("torch.", ""),
        "kernel": kern.name,
        "shape": [B, S, K, G, D, Dv], "window": window, "tol": tol,
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": min(ms, time_ms(run, reps=reps)), "previous_ms": prev_ms,
        "plain_ms": time_ms(plain, reps=reps),
        "library_ms": time_ms(library, reps=reps),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(nbytes / NOMINAL_BPS, flops / peak) * 1e3,
        "bound_by": ("bytes" if nbytes / NOMINAL_BPS >= flops / peak
                     else "operations"),
    }


def phase_flash():
    """The flash kernels on random inputs: the serve path's shape,
    gemma3's and h2o-danube-3-4b's, and the JAX package's four
    kernel-test shapes.  -> the rows by (case, dtype)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    every = (torch.bfloat16, torch.float16, torch.float32)
    cases = [("path", 4, 2000, 8, 3, 128, GLOBAL, every),
             ("gemma3", 4, 2000, 4, 2, 256, 1024, (torch.bfloat16,)),
             ("h2o_danube3", 4, 2000, 8, 4, 120, 4096, (torch.bfloat16,)),
             ("test0", 1, 128, 1, 1, 32, GLOBAL, every),
             ("test1", 2, 256, 2, 3, 64, GLOBAL, every),
             ("test2", 1, 256, 4, 1, 64, 64, every),
             ("test3", 2, 192, 2, 2, 32, 16, every)]
    rows = {}
    for label, B, S, K, G, D, window, dtypes in cases:
        for dtype in dtypes:
            mk = lambda *shape: torch.randn(shape, generator=g,
                                            device="cuda").to(dtype)
            row = flash_row(label, mk(B, S, K, G, D), mk(B, S, K, D),
                            mk(B, S, K, D), window)
            log("flash_case " + json.dumps(row))
            rows[label, row["dtype"]] = row
    return rows


@contextlib.contextmanager
def flash_calls(fn):
    """Route the model's calls of ``ops.flash_attention`` through
    ``fn(i, q, k, v, **kw)`` (i counts the calls from 0)."""
    orig = fa_ops.flash_attention
    n = [0]

    def wrapped(q, k, v, *args, **kw):
        i = n[0]
        n[0] += 1
        return fn(i, orig, q, k, v, *args, **kw)

    fa_ops.flash_attention = wrapped
    try:
        yield n
    finally:
        fa_ops.flash_attention = orig


def serve(model, params, prompts, steps, device):
    """``examples/serve_decode.py``'s loop: prefill, then greedy decode
    on the ring cache.  -> (logits of every step (B, 1 + steps, V),
    tokens (B, 1 + steps), prefill s, per-step s, caches)."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    S = prompts.shape[1]
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": prompts})
    sync()
    prefill_s = time.perf_counter() - t0
    out, toks, lat = [logits], [logits[:, -1].argmax(-1)[:, None]], []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, toks[-1], caches, S + i)
        sync()
        lat.append(time.perf_counter() - t0)
        out.append(logits)
        toks.append(logits[:, -1].argmax(-1)[:, None])
    return torch.cat(out, 1), torch.cat(toks, 1), prefill_s, lat, caches


def device_time_split(fn):
    """``fn()`` once under torch.profiler: device time (ms) of the flash
    kernel, of matrix products and of everything else, the kernel count,
    the wall time and the device's idle share of it."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"flash_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    top, kernels = [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "flash_fwd" in name:        # either flash kernel
            split["flash_ms"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            split["matmul_ms"] += ms
        else:
            split["other_ms"] += ms
        kernels += e.count
        top.append((ms, e.key[:80], e.count))
    busy = sum(split.values())
    split.update(kernels=kernels, wall_ms=wall * 1e3, busy_ms=busy,
                 idle_share=1.0 - busy / (wall * 1e3),
                 top=sorted(top, reverse=True)[:6])
    return split


def phase_serve(copy_bps):
    """Full-width llama3.2-3b: prefill 4 x 2000 tokens through the flash
    kernel, then 32 greedy decode steps on the ring cache."""
    cfg = ARCHS[LM_ARCH]
    model = build_model(cfg, ModelOptions(
        attn_impl="pallas", remat=False,
        prefill_cache_capacity=LM_PROMPT + LM_STEPS + 8))
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(l.numel() for l in tree_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{LM_ARCH} has {n_params} params, the config "
                             f"counts {cfg.param_count()}")
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, LM_PROMPT, seed=1).batch(LM_BATCH)["tokens"]).cuda()
    last = cfg.num_layers - 1
    captured = {}

    def capture(i, orig, q, k, v, *args, **kw):
        if i in (0, last):
            captured[i] = (q.clone(), k.clone(), v.clone())
        return orig(q, k, v, *args, **kw)

    torch.cuda.reset_peak_memory_stats()
    with flash_calls(capture):
        for kern in FA_KERNELS:
            kern.launches = 0
        logits, toks, prefill_s, lat, caches = serve(
            model, params, prompts, LM_STEPS, torch.device("cuda"))
        launches = FLASH_WGMMA.launches
        simt_launches = FLASH_SIMT.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers or simt_launches != 0:
        raise AssertionError(f"the bf16 prefill launched the wgmma kernel "
                             f"{launches} times (not {cfg.num_layers}) and "
                             f"the CUDA-core one {simt_launches} (not 0)")
    if tuple(logits.shape) != (LM_BATCH, 1 + LM_STEPS, cfg.vocab_size):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    lat_ms = sorted(x * 1e3 for x in lat)
    warm_s = min(serve(model, params, prompts, 0, torch.device("cuda"))[2]
                 for _ in range(2))
    row = {
        "arch": LM_ARCH, "params": n_params, "dtype": cfg.dtype,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "steps": LM_STEPS,
        "init_s": init_s, "prefill_cold_ms": prefill_s * 1e3,
        "prefill_ms": warm_s * 1e3,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / warm_s,
        "decode_first_ms": lat[0] * 1e3,
        "decode_p50_ms": float(np.percentile(lat_ms, 50)),
        "decode_p99_ms": float(np.percentile(lat_ms, 99)),
        "decode_tok_s": LM_BATCH * LM_STEPS / sum(lat),
        "peak_mem_gb": peak / 1e9, "flash_wgmma_launches": launches,
        "flash_simt_launches": simt_launches,
        "tokens_0": toks[0, :8].tolist()}
    log("serve " + json.dumps(row))
    log("serve_prefill_device " + json.dumps(device_time_split(
        lambda: model.prefill(params, {"tokens": prompts}))))
    tok = toks[:, -1:]
    split = device_time_split(lambda: model.decode_step(
        params, tok, caches, LM_PROMPT + LM_STEPS))
    # the least a decode step can take: every weight read once
    split["weight_read_ms"] = 2 * n_params / copy_bps * 1e3
    log("serve_decode_device " + json.dumps(split))
    rows = [flash_row(f"serve_layer{i}", q, k, v, GLOBAL)
            for i, (q, k, v) in sorted(captured.items())]
    for r in rows:
        log("flash_case " + json.dumps(r))
    del params, logits, caches
    torch.cuda.empty_cache()
    return row, launches, rows[0]


def small_lm(steps):
    cfg = ARCHS[LM_ARCH].reduced(dtype="float32")
    model = build_model(cfg, ModelOptions(
        attn_impl="pallas", remat=False,
        prefill_cache_capacity=150 + steps + 8))
    prompts = torch.from_numpy(TokenTaskStream(
        cfg.vocab_size, 150, seed=1).batch(LM_BATCH)["tokens"])
    return model, model.init(seed=0, device="cpu"), prompts


def phase_lm_checks():
    """Reduced llama3.2-3b in fp32 (150-token prompts: three query tiles,
    the last one ragged).  Decode against the full forward on the card,
    then the serve loop on the card against the CPU, and against the
    card with a planted GQA fault."""
    steps = 8
    model, params, prompts = small_lm(steps)
    cuda = torch.device("cuda")
    p_card = tree_map(lambda t: t.to(cuda), params)
    full, _ = model.prefill(p_card, {"tokens": prompts.to(cuda)})
    _, caches = model.prefill(p_card, {"tokens": prompts[:, :-1].to(cuda)})
    dec, _ = model.decode_step(p_card, prompts[:, -1:].to(cuda), caches,
                               prompts.shape[1] - 1)
    torch.cuda.synchronize()
    check_close("decode_step vs prefill", dec, full, 2e-3)
    dec_err = float((dec - full).abs().max())

    cpu_logits, cpu_toks, *_ = serve(model, params, prompts, steps,
                                     torch.device("cpu"))
    for kern in FA_KERNELS:
        kern.launches = 0
    card_logits, card_toks, *_ = serve(model, p_card, prompts.to(cuda),
                                       steps, cuda)
    simt_launches = FLASH_SIMT.launches
    if simt_launches != model.cfg.num_layers or FLASH_WGMMA.launches:
        raise AssertionError(f"the fp32 serve loop launched the CUDA-core "
                             f"flash kernel {simt_launches} times and the "
                             f"wgmma one {FLASH_WGMMA.launches}")

    def roll_first(i, orig, q, k, v, *args, **kw):
        if i == 0:      # the KV heads of the first layer, one head off
            k, v = k.roll(1, dims=2), v.roll(1, dims=2)
        return orig(q, k, v, *args, **kw)

    with flash_calls(roll_first) as n:
        bad_logits, bad_toks, *_ = serve(model, p_card, prompts.to(cuda),
                                         steps, cuda)
    if n[0] == 0:
        raise AssertionError("the planted fault never fired")
    with flash_calls(roll_first):     # the same fault in the plain version
        bad_cpu, bad_cpu_toks, *_ = serve(model, params, prompts, steps,
                                          torch.device("cpu"))
    sound = float((card_logits.cpu() - cpu_logits).abs().max())
    planted = float((bad_logits.cpu() - cpu_logits).abs().max())
    both_planted = float((bad_logits.cpu() - bad_cpu).abs().max())
    same_tokens = bool((card_toks.cpu() == cpu_toks).all())
    log("lm_parity " + json.dumps({
        "decode_vs_prefill_max_abs": dec_err, "max_abs_diff": sound,
        "planted_fault_max_abs_diff": planted,
        "planted_card_vs_planted_cpu": both_planted,
        "planted_same_tokens": bool((bad_toks.cpu() == bad_cpu_toks).all()),
        "atol": LM_PARITY_ATOL, "same_greedy_tokens": same_tokens,
        "steps": steps, "flash_simt_launches": simt_launches}))
    if not both_planted <= LM_PARITY_ATOL:
        raise AssertionError(f"with the planted fault, card vs CPU logits: "
                             f"{both_planted:.3e} > {LM_PARITY_ATOL}")
    if not same_tokens:
        raise AssertionError("card and CPU chose different greedy tokens")
    if not sound <= LM_PARITY_ATOL:
        raise AssertionError(f"card vs CPU logits: {sound:.3e} > "
                             f"{LM_PARITY_ATOL}")
    if not planted > LM_PARITY_ATOL:
        raise AssertionError(f"rolled KV heads moved the logits by "
                             f"{planted:.3e}, inside {LM_PARITY_ATOL}")
    return simt_launches


# ---------------------------------------------------------------------------
# phases 10-12: the int8 quantize kernels and the fused round
# ---------------------------------------------------------------------------


def bits_equal(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool(torch.equal(a, b))


def quant_case(label, x, block):
    """The quantize and dequantize kernels on ``x`` (flat) against their
    plain versions: q, scales and the dequantized values (fp32 and bf16)
    bit-equal, and |x - deq| <= s/2."""
    n = x.numel()
    n0 = (QUANTIZE.launches, DEQUANTIZE.launches)
    q, s = q_ops.quantize(x, block=block, impl="cuda")
    qr, sr = q_ops.quantize(x, block=block, impl="torch")
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        outs[dt] = (q_ops.dequantize(q, s, n, out_dtype=dt, impl="cuda"),
                    q_ops.dequantize(q, s, n, out_dtype=dt, impl="torch"))
    torch.cuda.synchronize()
    if (QUANTIZE.launches, DEQUANTIZE.launches) != (n0[0] + 1, n0[1] + 2):
        raise AssertionError(f"quant[{label}]: the kernels did not launch")
    err = (outs[torch.float32][0] - x.float()).abs()
    bound = s.repeat_interleave(block)[:n] / 2
    row = {"case": label, "N": n, "block": block,
           "dtype": str(x.dtype).replace("torch.", ""),
           "q_equal": bits_equal(q, qr), "scales_equal": bits_equal(s, sr),
           "deq_f32_equal": bits_equal(*outs[torch.float32]),
           "deq_bf16_equal": bits_equal(*outs[torch.bfloat16]),
           "max_err_over_half_scale": float((err - bound).max()),
           "zero_rows": int((s == 1.0).sum())}
    if not (row["q_equal"] and row["scales_equal"] and row["deq_f32_equal"]
            and row["deq_bf16_equal"]):
        raise AssertionError(f"quant[{label}]: kernel and plain version "
                             f"differ: {row}")
    if not row["max_err_over_half_scale"] <= 1e-7:
        raise AssertionError(f"quant[{label}]: |x - deq| > s/2: {row}")
    return row


def phase_quant():
    """The quantize kernels at the JAX package's kernel-test sizes, an
    all-zero input, bf16 input and row widths 64 and 200; then at the
    fused round's largest delta leaf, the (128256, 3072) fp32 embedding
    (1,539,072 rows of 256), timed against the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda n: torch.randn(n, generator=g, device="cuda") * 3
    cases = [("n256", rnd(256), 256), ("n773", rnd(3 * 256 + 5), 256),
             ("n100", rnd(100), 256), ("n70000", rnd(70000), 256),
             ("zeros", torch.zeros(512, device="cuda"), 256),
             ("bf16", rnd(3 * 256 + 5).to(torch.bfloat16), 256),
             ("b64", rnd(64 * 37 + 9), 64), ("b200", rnd(200 * 11), 200)]
    for label, x, block in cases:
        log("quant_case " + json.dumps(quant_case(label, x, block)))

    cfg = ARCHS[LM_ARCH]
    x = torch.randn(cfg.vocab_size, cfg.d_model, generator=g,
                    device="cuda") * 1e-3
    row = quant_case("path_embedding", x.reshape(-1), 256)
    blocks = x.view(-1, 256)
    rows, n = blocks.shape[0], x.numel()
    q, s = quantize_cuda(blocks)
    deq = dequantize_cuda(q, s)
    torch.cuda.synchronize()
    deq_err = float((deq - q_ref.dequantize_ref(q, s)).abs().max())
    q_err = float((q.float() - q_ref.quantize_ref(blocks)[0].float())
                  .abs().max())
    nbytes = 5 * n + 4 * rows          # fp32 in, int8 + scales out (or back)
    out = {}
    for name, run, plain, library, ops_n, err in (
            ("quantize", lambda: quantize_cuda(blocks),
             lambda: q_ref.quantize_ref(blocks), None, 5 * n, q_err),
            ("dequantize", lambda: dequantize_cuda(q, s),
             lambda: q_ref.dequantize_ref(q, s),
             lambda: torch.mul(q, s[:, None]), n, deq_err)):
        b_s, o_s = nbytes / NOMINAL_BPS, ops_n / FP32_FLOPS
        out[name] = {
            "shape": [cfg.vocab_size, cfg.d_model], "rows": rows,
            "block": 256, "max_abs_err": err,
            "ms": time_ms(run, reps=15), "plain_ms": time_ms(plain, reps=5),
            "library_ms": time_ms(library, reps=15) if library else None,
            "bytes": nbytes, "ops": ops_n,
            "bound_ms": max(b_s, o_s) * 1e3,
            "bound_by": "bytes" if b_s >= o_s else "operations"}
        log(f"quant_path_{name} " + json.dumps(out[name]))
    del x, blocks, q, s, deq
    torch.cuda.empty_cache()
    return row, out


def all_kernels():
    return (*fed.KERNELS, *FA_KERNELS, *Q_KERNELS)


def fused_split(fn):
    """``fn()`` once under torch.profiler: device ms of the quantize and
    dequantize kernels, of matrix products and of the rest (by kernel
    name, each kernel counted once); the flash VJP's device ms (the
    ``flash_vjp.*`` ranges, whose kernels are also among the matmuls and
    the rest); the kernel count, the wall time and the idle share."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"quantize_ms": 0.0, "dequantize_ms": 0.0, "matmul_ms": 0.0,
             "other_ms": 0.0}
    flash_vjp, kernels, top = 0.0, 0, []
    for e in prof.key_averages():
        if e.key.startswith("flash_vjp."):
            if e.device_type == DeviceType.CPU:
                flash_vjp += e.device_time_total / 1e3
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "dequantize_kernel" in name:
            split["dequantize_ms"] += ms
        elif "quantize_kernel" in name:
            split["quantize_ms"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            split["matmul_ms"] += ms
        else:
            split["other_ms"] += ms
        kernels += e.count
        top.append((ms, e.key[:80], e.count))
    busy = sum(split.values())
    split.update(flash_vjp_ms=flash_vjp, kernels=kernels, wall_ms=wall * 1e3,
                 busy_ms=busy, idle_share=1.0 - busy / (wall * 1e3),
                 top=sorted(top, reverse=True)[:8])
    return split


def round_setup(cfg, seq_len, device, compress="int8", opts=None):
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    agg = AggregationConfig(hierarchy="hierarchical", timing="eager",
                            compress=compress, num_microbatches=2,
                            server_opt="fedavg")
    trainer = FusedFLTrainer(cfg, mesh, agg, opts=opts, device=device)
    batch = CohortTokenLoader(cfg.vocab_size, seq_len=seq_len,
                              n_cohorts=4).round_batch(8, 0)
    return trainer, batch


def timed_round(trainer, params, batch):
    """One round from ``params``: -> (metrics record, wall s)."""
    trainer.params = params
    trainer.server_state = init_server_state("fedavg", params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = trainer.train_round(batch)
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t0


def phase_fused_round():
    """Full-width llama3.2-3b (bf16, random params from seed 0): one
    hierarchical int8 round on a 2-pod mesh, each pod 4 sequences of 512
    tokens in 2 microbatches, then one ``compress="none"`` round from the
    same params; the int8 params must lie within 5 % (relative) of the
    uncompressed ones.  A second int8 round gives the warm time and a
    third the device split."""
    cfg = ARCHS[LM_ARCH]
    opts = ModelOptions(attn_impl="chunked", remat=True)
    t8, batch = round_setup(cfg, FUSED_SEQ, None, "int8", opts)
    tn, _ = round_setup(cfg, FUSED_SEQ, None, "none", opts)
    t0 = time.perf_counter()
    t8.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p0 = t8.params
    leaves = tree_leaves(p0)
    if sum(l.numel() for l in leaves) != cfg.param_count():
        raise AssertionError(f"{LM_ARCH}: {sum(l.numel() for l in leaves)} "
                             f"params, the config counts {cfg.param_count()}")

    def driven(trainer):
        for k in all_kernels():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rec, wall = timed_round(trainer, p0, batch)
        launches = {k.name: k.launches for k in all_kernels()}
        return rec, wall, launches, torch.cuda.max_memory_allocated()

    rec8, cold_s, launches8, peak8 = driven(t8)
    p8 = t8.params
    recn, none_s, launchesn, peakn = driven(tn)
    pn = tn.params
    want = 2 * len(leaves)
    for name in (QUANTIZE.name, DEQUANTIZE.name):
        if launches8[name] != want:
            raise AssertionError(f"the int8 round launched {name} "
                                 f"{launches8[name]} times, not {want} "
                                 f"({len(leaves)} leaves x 2 pods)")
        if launchesn[name] != 0:
            raise AssertionError(f"the uncompressed round launched {name}")
    rel = max(float((a.float() - b.float()).abs().max()
                    / (b.float().abs().max() + 1e-9))
              for a, b in zip(tree_leaves(p8), tree_leaves(pn)))
    moved = any(bool((a != b).any()) for a, b in zip(tree_leaves(p8), leaves))
    finite = all(bool(torch.isfinite(l).all()) for l in tree_leaves(p8))
    del p8, pn
    tn.params = None
    recs = {"int8": rec8, "none": recn}
    for tag, rec in recs.items():
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{tag} round: non-finite metrics {rec}")
    if not (finite and moved):
        raise AssertionError("the int8 round left non-finite or unchanged "
                             "params")
    if not rel < 0.05:
        raise AssertionError(f"int8 vs none params: relative {rel:.3e} "
                             ">= 0.05")
    warm8, warm_s, _, _ = driven(t8)
    t8.params = p0
    split = fused_split(lambda: timed_round(t8, p0, batch))
    row = {
        "arch": LM_ARCH, "params": sum(l.numel() for l in leaves),
        "leaves": len(leaves), "dtype": cfg.dtype, "pods": 2,
        "microbatches_per_pod": 2, "seqs_per_pod": 4, "seq_len": FUSED_SEQ,
        "init_s": init_s, "int8_cold_s": cold_s, "int8_warm_s": warm_s,
        "none_s": none_s, "peak_mem_gb_int8": peak8 / 1e9,
        "peak_mem_gb_none": peakn / 1e9,
        "int8": rec8, "none": recn, "int8_warm": warm8,
        "int8_vs_none_rel": rel, "launches_int8": launches8,
        "launches_none": launchesn}
    log("fused_round " + json.dumps(row))
    log("fused_round_device " + json.dumps(split))
    del p0, leaves
    t8.params = t8.server_state = None
    torch.cuda.empty_cache()
    return row, split


def pod_steps(trainer, batch):
    """Per element, the largest quantization step of its block over the
    pods' deltas of the round about to run: ``s / n_pods × server_lr``."""
    n_pods, agg = trainer.mesh.shape["pod"], trainer.agg
    steps = None
    for i in range(n_pods):
        b = {k: torch.as_tensor(v[i * len(v) // n_pods:
                                  (i + 1) * len(v) // n_pods],
                                device=trainer.device)
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


def int8_limit(got, want, steps):
    """The two-part limit of an int8 round: (a) at most 0.1 % of
    elements differ by more than 1e-5; (b) none by more than one
    quantization step of its block (plus the 1e-5 of part a).  -> (share
    over 1e-5, largest difference in steps, whether both hold)."""
    d = torch.cat([(g.cpu().double() - w.cpu().double()).abs().reshape(-1)
                   for g, w in zip(got, want)])
    st = torch.cat([s.cpu().double().reshape(-1) for s in steps])
    share = float((d > 1e-5).double().mean())
    worst = float(((d - 1e-5) / st).max())
    return share, worst, share <= 1e-3 and worst <= 1.0


@contextlib.contextmanager
def pod_counted_twice():
    """A planted fault for the round check: the second pod's delta is
    counted twice in the cross-pod sum."""
    orig = compression.fake_quantize_tree
    calls = [0]

    def faulted(delta):
        calls[0] += 1
        leaves, treedef = tree_flatten(orig(delta))
        k = 2 if calls[0] == 2 else 1
        return tree_unflatten(treedef, [k * t for t in leaves])

    compression.fake_quantize_tree = faulted
    try:
        yield
    finally:
        compression.fake_quantize_tree = orig
    if calls[0] < 2:
        raise AssertionError("the planted fault never fired")


def phase_round_parity():
    """Reduced llama3.2-3b in fp32: one hierarchical int8 round on the
    card (the kernels) against the same round on the CPU (the plain
    versions), from the same params; and on the card with one pod's
    delta counted twice, which must land above the limit."""
    cfg = ARCHS[LM_ARCH].reduced(dtype="float32")
    cpu, batch = round_setup(cfg, 64, "cpu")
    cpu.init(seed=0)
    p_cpu = cpu.params
    steps = pod_steps(cpu, batch)
    card, _ = round_setup(cfg, 64, "cuda")
    p_card = tree_map(lambda t: t.to("cuda"), p_cpu)
    n0 = QUANTIZE.launches
    card_rec = timed_round(card, p_card, batch)[0]
    if QUANTIZE.launches == n0:
        raise AssertionError("the card's round did not launch the kernel")
    sound_params = tree_leaves(card.params)
    with pod_counted_twice():
        timed_round(card, p_card, batch)
    faulted_params = tree_leaves(card.params)
    cpu_rec = cpu.train_round(batch)
    want = tree_leaves(cpu.params)
    share, worst, ok = int8_limit(sound_params, want, steps)
    f_share, f_worst, f_ok = int8_limit(faulted_params, want, steps)
    row = {"loss_card": card_rec["loss"], "loss_cpu": cpu_rec["loss"],
           "share_over_1e-5": share, "worst_in_steps": worst,
           "planted_share_over_1e-5": f_share,
           "planted_worst_in_steps": f_worst,
           "limit": "share <= 1e-3 and worst <= 1 step"}
    log("round_parity " + json.dumps(row))
    if not ok:
        raise AssertionError(f"card vs CPU int8 round outside its limit: "
                             f"{row}")
    if f_ok:
        raise AssertionError(f"a pod counted twice stayed inside the "
                             f"limit: {row}")
    if not abs(card_rec["loss"] - cpu_rec["loss"]) < 1e-5:
        raise AssertionError(f"card vs CPU loss: {row}")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # phase 1: device
    card = device_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the JAX reference accumulates bf16 products in fp32
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = False
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={matmul.allow_tf32} "
        f"allow_bf16_reduced_precision_reduction="
        f"{matmul.allow_bf16_reduced_precision_reduction}")

    # phase 2: build (one nvcc per source, all at once) + copy bandwidth
    t0 = time.perf_counter()
    sources = (fed.LIB, *FA_LIBS, Q_LIB)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(lambda lib: lib.build(), sources))
    log(f"build: {', '.join(str(l.relative_to(ROOT)) for l in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    copy_bps = copy_bandwidth()
    log(f"copy bandwidth: {copy_bps / 1e9:.1f} GB/s device-to-device "
        f"(nominal {NOMINAL_BPS / 1e9:.0f})")

    # phase 3: kernels against their plain versions
    cases = phase_kernels(copy_bps)

    # phase 4: engine
    stage_s = phase_engine()

    # phase 5: the main path
    rounds, launches, k_main = phase_round()
    phase_parity()

    # phases 6-8: the flash kernels, the serve path, the LM checks
    flash_rows = phase_flash()
    serve_row, flash_launches, flash_main = phase_serve(copy_bps)
    simt_launches = phase_lm_checks()

    # phases 10-12: the quantize kernels, the fused round, its parity
    _, quant_rows = phase_quant()
    fused_row, fused_dev = phase_fused_round()
    phase_round_parity()

    # phase 9: summary at the main paths' shapes (f32 wire; the lazy
    # round's largest burst for fedavg_accumulate_k): the phase-3 rows
    # where they are those shapes
    main_k = {"eager_accumulate": 1, "fedavg_accumulate_k": max(k_main, 2),
              "fedavg_reduce": 8}
    measured = {(r["name"], r["K"]): r for r in cases
                if r["dtype"] == "float32" and r["view"] == [0, 0]}
    out = []
    for kern in fed.KERNELS:
        k = main_k[kern.name]
        row = measured.get((kern.name, k)) or kernel_case(
            kern.name, torch.float32, k, copy_bps)
        out.append({
            "name": kern.name, "route": "cuda",
            "source": "src/repro_torch/kernels/fedavg/csrc/fedavg.cu",
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            **({"previous_ms": row["previous_ms"]}
               if kern is fed.EAGER else {}),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "K": row["K"], "N": row["N"],
            "bound_copy_ms": row["bound_copy_ms"]})
    kernel_ms = sum(launches[o["name"]] * o["ms"] for o in out) / 1e3
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/"
    out.append({
        "name": FLASH_WGMMA.name, "route": "cuda",
        "source": flash_src + "flash_attention_sm90.cu",
        "replaces": FLASH_WGMMA.replaces, "launches": flash_launches,
        "launches_fused_round": fused_row["launches_int8"][FLASH_WGMMA.name],
        **{k: flash_main[k] for k in (
            "max_abs_err", "ms", "previous_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape", "dtype")}})
    simt_row = flash_rows["path", "float32"]
    out.append({
        "name": FLASH_SIMT.name, "route": "cuda",
        "source": flash_src + "flash_attention.cu",
        "replaces": FLASH_SIMT.replaces, "launches": simt_launches,
        "launches_path": "phase 8: the fp32 serve loop on the card",
        "launches_fused_round": fused_row["launches_int8"][FLASH_SIMT.name],
        **{k: simt_row[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "dtype")}})
    for kern in Q_KERNELS:
        r = quant_rows[kern.name]
        out.append({
            "name": kern.name, "route": "cuda",
            "source": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
            "replaces": kern.replaces,
            "launches": fused_row["launches_int8"][kern.name],
            **{k: r[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "rows")}})
    log("summary " + json.dumps({
        "rounds": len(rounds),
        "client_train_s": sum(r["trace_client_train_s"] for r in rounds),
        "agg_exec_s": sum(r["agg_exec_s"] for r in rounds),
        "kernel_s_est": kernel_ms,
        "staging_s_per_fold": stage_s,
        "wall_s": sum(r["wall_s"] for r in rounds),
        "serve_prefill_ms": serve_row["prefill_ms"],
        "serve_decode_p50_ms": serve_row["decode_p50_ms"],
        "flash_ms_est": flash_launches * flash_main["ms"],
        "fused_round_warm_s": fused_row["int8_warm_s"],
        "fused_round_quant_ms": fused_dev["quantize_ms"]
        + fused_dev["dequantize_ms"]}))
    log(json.dumps({"kernels": out}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
