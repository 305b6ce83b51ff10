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
13. shmproc: phase 5's workload through ``Session.open(...,
   runtime="shmproc")``: forked numpy workers fold the mids on the host
   (as in the JAX package), the card trains the clients and folds the
   top.  ``df -h /dev/shm``; a cold and two warm rounds, then a busy
   worker SIGKILLed mid-round (``WorkerCrashed``, a fresh fork after the
   parent's CUDA work, the full goal folded); every round's params
   against phase 5's inproc session from the same seed within
   ``PARITY_ATOL``; worker stats (forks, cold / warm dispatch latency),
   each round's trace breakdown; no segment left in ``/dev/shm``.
   Phases 13 and 14 train with cuDNN's deterministic algorithms, so
   what separates two sessions is the runtime's arithmetic alone.
14. multi-node: two ``netd`` daemons on the card (``spawn_local_daemon``,
   each its own CUDA context; the kernels were built in phase 2), then
   ``Session.open(..., nodes=[a, b])`` node-top with locality placement:
   three rounds and one with ``wire_compress=6``, params against an
   inproc session over nodes of the same names within ``PARITY_ATOL``,
   the controller's bytes on the wire each round (raw and compressed);
   a driven round of six model-size updates across both daemons
   (daemon-to-daemon ship, root on nodeA) bit-equal to the blocked
   numpy engine; each daemon's ``stats_reply``: its device (must be
   ``cuda``) and its own fold kernel launches (eager folds above 0 on
   every daemon that took updates).
15. serve: ``Session.serve()`` behind ``admission=AdmissionPolicy(
   max_queue=2)``; a client process (the port alone) pushes three
   full-size updates with ``push_update``: two queued, one ``busy``
   with ``retry_after_s``; the round that follows folds the two on the
   card (eager launches above 0).
16. service: one ``AggregationService`` on the card with two jobs of
   phase 5's full-width ResNet-18 (seed-0 params, fair-share weights
   2:1) over phase 5's fleet.  Each job is sent its clients' real
   deltas (phase 5's eight clients, one local epoch from the seed-0
   params) through admission, one of them pushed over the wire as bf16
   (raw words named ``bfloat16``; the port decodes them without
   ``ml_dtypes``); three rolling rounds a job (``MinCohortIdleGap``),
   fold launch counts zeroed just before and read just after.  Each
   job's params against its recorded cohorts replayed in order through
   a sequential ``RoundDriver`` on the card (bit-exact, or within
   ``PARITY_ATOL``: the line says which), and the same replay with one
   update folded twice above the limit; ``pipeline_overlap()``, each
   job's round walls, the publishes' device-to-host copies (one a
   publish) and their ms, ``health()`` through ``summary_line``.  Then
   the engines' fold speedup over the naive engine (``engine_speedup``:
   ``DataPlaneCosts.agg_engine_speedup["torch"]``).
17. checkpoint: job a's trainer checkpoints its params through
   ``AsyncCheckpointer`` at its last round's end (in ``build/``,
   removed after); restored and held against the params bit for bit;
   the submit's ms (what the round pays: the snapshot into pinned host
   memory), the write's ms on its thread, the restore's ms and the
   file's size.
The ``kernels`` line gives each fedavg kernel its launches by path:
phase 5, phase 13's controller (0: the workers fold with numpy),
phase 14 in netd and at the controller, phase 15, phase 16.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
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
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    restore_checkpoint)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.resnet import RESNET18  # noqa: E402
from repro_torch.convert import (flatten_jax_layout,  # noqa: E402
                               unflatten_jax_layout)
from repro_torch.core import (Aggregator, ClientInfo, EngineConfig,  # noqa: E402
                              InProcObjectStore, NodeState, RoundConfig,
                              TorchEngine, UpdateEnvelope, fedavg_oracle)
from repro_torch.core.engine import make_engine  # noqa: E402
from repro_torch.core.placement import build_fold_plan  # noqa: E402
from repro_torch.data import (ClientShard, build_client_datasets,  # noqa: E402
                              dirichlet_partition, synthetic_femnist)
from repro_torch.data.loader import CohortTokenLoader  # noqa: E402
from repro_torch.data.synthetic import TokenTaskStream  # noqa: E402
from repro_torch.fl import compression  # noqa: E402
from repro_torch.fl.round import (AggregationConfig,  # noqa: E402
                                  accumulate_updates)
from repro_torch.fl.server import (apply_server_opt,  # noqa: E402
                                  init_server_state)
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
                                 PartialReady, UpdateArrived, WorkerCrashed)
from repro_torch.runtime.driver import InProcRuntime, RoundDriver  # noqa: E402
from repro_torch.runtime.netrt import (RemoteRuntime, connect,  # noqa: E402
                                       reap_local_daemon, spawn_local_daemon)
from repro_torch.obs import summary_line  # noqa: E402
from repro_torch.serve import (AdmissionPolicy, AggregationService,  # noqa: E402
                               MinCohortIdleGap)
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


def engine_speedup(n=N_RESNET18, reps=15):
    """Fold throughput of the engines against the naive one's: one
    ResNet-18-sized fp32 update folded from the host, each fold timed
    to its end (the torch engine's pinned staging, host-to-device copy
    and eager kernel, synchronised); the engines take turns, ``reps``
    folds each after a warm one, median.  The ``torch`` ratio is
    ``DataPlaneCosts.agg_engine_speedup``'s entry
    (``core/simulation.py``)."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n).astype(np.float32)
    names = ("naive", "blocked", "torch")
    engs = {k: make_engine(EngineConfig(name=k, device="cuda"))
            for k in names}
    accs = {k: e.begin(n) for k, e in engs.items()}
    times = {k: [] for k in names}
    for r in range(reps + 1):
        for k, eng in engs.items():
            t0 = time.perf_counter()
            accs[k] = eng.fold(accs[k], u, 1.5)
            eng.sync(accs[k])
            if r:                       # the first fold warms the buffers
                times[k].append(time.perf_counter() - t0)
    s = {k: sorted(t)[reps // 2] for k, t in times.items()}
    return {"fold_s": s, "speedup": {k: s["naive"] / v for k, v in s.items()}}


def fold_launches():
    return {k.name: k.launches for k in fed.KERNELS}


def zero_fold_launches() -> None:
    for k in fed.KERNELS:
        k.launches = 0


def check_fold_launches(label, launches, names) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by {label}")


def resnet_fleet(cfg=RESNET18, n_images=512, classes=62, device="cuda"):
    """Phase 5's workload: ResNet-18 (random weights from seed 0),
    ``synthetic_femnist(512, 62)``, 8 clients (Dirichlet α 0.5), 3 nodes
    of capacity 20.  ``clients()`` and ``nodes()`` make a fresh fleet
    for each session."""
    model = build_resnet(cfg)
    params = model.init(seed=0, device=device)
    imgs, labels = synthetic_femnist(n_images, num_classes=classes, seed=0)
    shards = dirichlet_partition(labels, 8, alpha=0.5)
    clients = lambda: [  # noqa: E731
        ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
        for d in build_client_datasets(imgs, labels, shards)]
    nodes = lambda: {f"node{i}": NodeState(node=f"node{i}",  # noqa: E731
                                           max_capacity=20)
                     for i in range(3)}
    test = {"images": imgs[:256], "labels": labels[:256]}
    return model, params, clients, nodes, test


def phase_round():
    model, params, clients, nodes, test = resnet_fleet()
    clients = clients()
    n_params = sum(l.numel() for l in tree_leaves(params))
    if n_params != N_RESNET18:
        raise AssertionError(f"RESNET18 has {n_params} params")
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

    zero_fold_launches()
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
    launches = fold_launches()
    log("round launches " + json.dumps(launches))
    after = tree_leaves(params)
    if not all(bool(torch.isfinite(l).all()) for l in after):
        raise AssertionError("non-finite params after the rounds")
    if not any(bool((a != b).any()) for a, b in zip(after, before)):
        raise AssertionError("params did not change")
    check_fold_launches("the rounds", launches,
                        ("eager_accumulate", "fedavg_accumulate_k"))
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


# ---------------------------------------------------------------------------
# phases 13-15: the multi-process and multi-node runtimes, serve mode
# ---------------------------------------------------------------------------

RT_GOAL = 6                  # phase 5's aggregation goal
ROUND_KEYS = ("updates", "nodes_used", "cold_starts", "reused", "workers",
              "crashes", "redispatched", "wall_s")


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms for a runtime comparison: two
    sessions then train their clients to the same bits, and what is
    left between them is the runtime's own arithmetic."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def synced(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def leaves_cpu(params):
    return [l.detach().float().cpu() for l in tree_leaves(params)]


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def logged_round(s, label, device):
    """One round of phase 5's client step: its record and its trace
    breakdown."""
    synced(device)
    rec = s.run_round(client_lr=CLIENT_LR, client_batch_size=32)
    synced(device)
    row = {"round": label, **{k: rec[k] for k in ROUND_KEYS}}
    row.update({f"trace_{k}": v for k, v in s.trace().breakdown().items()})
    return row


def inproc_reference(fleet, rounds, device, round_cfg, nodes=None):
    """Phase 5's in-process session from the same seed: the params after
    each round, and each round's row."""
    model, params, clients, mk_nodes, _ = fleet
    snaps, rows = [], []
    with Session.open(model, params, clients(), seed=0, device=device,
                      nodes=nodes if nodes is not None else mk_nodes(),
                      round_cfg=round_cfg) as s:
        for r in range(rounds):
            rows.append(logged_round(s, f"inproc-{r}", device))
            snaps.append(leaves_cpu(s.params))
    return snaps, rows


def phase_shmproc(fleet, device="cuda"):
    """Phase 5's rounds on ``runtime="shmproc"``: forked numpy workers
    fold the mids on the host, the controller folds the top on the
    card.  A cold round, two warm ones, then a busy worker SIGKILLed
    after the round's third update: the crash must surface as
    ``WorkerCrashed``, a fresh fork (after the parent's CUDA work) must
    take the subtree's updates, and the round must fold its full goal.
    Every round's params against phase 5's in-process session from the
    same seed within ``PARITY_ATOL``; no segment left under the
    runtime's ``/dev/shm`` prefix."""
    shm_df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                            text=True, timeout=30).stdout.strip()
    log("shm_df " + json.dumps(shm_df.splitlines()[-1]))
    model, params, clients, nodes, _ = fleet
    cfg = lambda: RoundConfig(aggregation_goal=RT_GOAL)  # noqa: E731
    ref, ref_rows = inproc_reference(fleet, 4, device, cfg())
    for row in ref_rows:
        log("shm_ref_round " + json.dumps(row))
    zero_fold_launches()
    rows, diffs, crashes, arrived = [], [], [], []
    with Session.open(model, params, clients(), runtime="shmproc",
                      nodes=nodes(), round_cfg=cfg(), seed=0,
                      device=device) as s:
        shm = s.trainer._ensure_runtime()._rt     # attaches lazily
        for r, label in enumerate(("cold", "warm-1", "warm-2")):
            rows.append(logged_round(s, f"shmproc-{label}", device))
            diffs.append(max_diff(leaves_cpu(s.params), ref[r]))
            log("shm_round " + json.dumps(
                {**rows[-1], "max_abs_diff_vs_inproc": diffs[-1]}))
        stats = {k: shm.stats[k] for k in (
            "forked", "cold_starts", "warm_starts", "cold_latency_s",
            "warm_latency_s")}

        def kill(ev):
            arrived.append(ev)
            if len(arrived) == 3:
                busy = [w for w in shm._workers if w.state == "busy"]
                os.kill(busy[0].proc.pid, signal.SIGKILL)

        s.on(UpdateArrived, kill)
        s.on(WorkerCrashed, crashes.append)
        rows.append(logged_round(s, "shmproc-sigkill", device))
        diffs.append(max_diff(leaves_cpu(s.params), ref[3]))
        log("shm_round " + json.dumps(
            {**rows[-1], "max_abs_diff_vs_inproc": diffs[-1]}))
        respawn = {k: shm.stats[k] for k in ("forked", "crashes",
                                             "cold_latency_s")}
        prefix = shm.prefix
    synced(device)
    left = [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
    row = {"rounds": len(rows), "stats": stats, "after_sigkill": respawn,
           "worker_crashed_events": len(crashes),
           "max_abs_diff_vs_inproc": diffs, "atol": PARITY_ATOL,
           # how far one round moves the params: the scale the check sees
           "round_step_max_abs": max_diff(ref[3], ref[2]),
           "shm_left": left, "launches": fold_launches(),
           "warm_wall_s": min(r["wall_s"] for r in rows[1:3]),
           "inproc_warm_wall_s": min(r["wall_s"] for r in ref_rows[1:3]),
           "warm_trace": min(rows[1:3], key=lambda r: r["wall_s"]),
           "inproc_warm_trace": min(ref_rows[1:3],
                                    key=lambda r: r["wall_s"])}
    log("shmproc " + json.dumps(row))
    if any(r["updates"] != RT_GOAL for r in rows):
        raise AssertionError("a shmproc round fell short of its goal")
    if not crashes or rows[-1]["crashes"] < 1 \
            or rows[-1]["redispatched"] < 1:
        raise AssertionError("the SIGKILL did not surface as WorkerCrashed "
                             "and a re-dispatch")
    if respawn["forked"] <= stats["forked"] or stats["warm_starts"] < 1:
        raise AssertionError(f"no warm start or no respawn: {row}")
    if not max(diffs) <= PARITY_ATOL:
        raise AssertionError(f"shmproc vs inproc {max(diffs):.3e} > "
                             f"{PARITY_ATOL}")
    if left:
        raise AssertionError(f"segments left in /dev/shm: {left}")
    return row


def daemon_stats(addr):
    """A daemon's ``stats_reply``: its engines' device and its own fold
    kernel launches, counted in its process."""
    conn = connect(addr, timeout=30.0)
    try:
        conn.send("hello", {"role": "client"})
        conn.recv_expect(("welcome",), 30.0)
        conn.send("stats", {})
        return conn.recv_expect(("stats_reply",), 30.0).meta
    finally:
        conn.close()


def wire_totals(remote):
    """The controller's bytes on the wire, compressed and raw."""
    t = {"tx": 0, "tx_raw": 0, "rx": 0, "rx_raw": 0}
    for node in remote._nodes.values():
        c = node.conn
        t["tx"] += c.tx_bytes
        t["rx"] += c.rx_bytes
        t["tx_raw"] += sum(c.tx_raw_by_kind.values())
        t["rx_raw"] += sum(c.rx_raw_by_kind.values())
    return t


def two_node_round(addrs, n, device):
    """One driven round across both daemons at the model's size: six
    updates (numpy, seed 3), three a node, the root fold on nodeA's
    daemon (node-top), nodeB's partial shipped daemon to daemon.  Its
    delta against the blocked numpy engine's in-process tree, bit for
    bit: every mid fold is one eager fold, which the kernel rounds as
    numpy does, and the root fold is an fp32 add."""
    rng = np.random.default_rng(3)
    ups = [(rng.standard_normal(n) * 1e-3).astype(np.float32)
           for _ in range(6)]
    ws = [float(1 + i % 3) for i in range(6)]
    assignment = {"nodeA": [0, 2, 4], "nodeB": [1, 3, 5]}
    plan = build_fold_plan(assignment, top_node="nodeA", topology="node")

    def drive(rt):
        out = RoundDriver(rt).run_round(
            round_id=0, assignment=assignment, goal=6, n_elems=n,
            fold_plan=plan,
            updates=((("nodeA", "nodeB")[i % 2], f"c{i}", u, w)
                     for i, (u, w) in enumerate(zip(ups, ws))))
        return out

    want = drive(InProcRuntime(agg_engine="blocked")).delta
    rt = RemoteRuntime(addrs, agg_engine=EngineConfig(name="auto",
                                                      device=device))
    try:
        w0 = wire_totals(rt)
        t0 = time.perf_counter()
        out = drive(rt)
        wall = time.perf_counter() - t0
        w1 = wire_totals(rt)
    finally:
        rt.close()
    row = {"wall_s": wall, "updates": out.count, "fold_tier": out.fold_tier,
           "root_node": out.root_node, "exec_s": out.exec_s,
           "bitexact_vs_blocked": bool(np.array_equal(out.delta, want)),
           **{f"wire_{k}": w1[k] - w0[k] for k in w0}}
    if out.count != 6 or not row["bitexact_vs_blocked"]:
        raise AssertionError(f"two-node round: {row}")
    return row


def phase_multinode(fleet, device="cuda", daemon_device=None):
    """Phase 5's rounds across two ``netd`` daemons on the card (each its
    own process and CUDA context, ``runtime="inproc"``), node-top with
    locality placement: three rounds, then one with ``wire_compress=6``,
    the params against an in-process session over two nodes of the same
    names and capacities within ``PARITY_ATOL``.  Locality packs the
    8-client cohort onto one node, as in the JAX package's session
    tests (a fixed plan keeps the clients' order, and so their updates,
    the same in both sessions); a driven round then spreads six
    model-size updates over both daemons.  The daemons' devices and
    fold kernel launches come from their ``stats_reply``; bytes on the
    wire from the controller's connections; a publish's device-to-host
    copy is timed on the same card."""
    model, params, clients, _, _ = fleet
    rc = lambda topology: RoundConfig(  # noqa: E731
        aggregation_goal=RT_GOAL, placement_policy="locality",
        topology=topology)
    same = {n: NodeState(node=n, max_capacity=20.0) for n in ("nodeA",
                                                              "nodeB")}
    ref, ref_rows = inproc_reference(fleet, 3, device, rc("controller"),
                                     nodes=same)
    for row in ref_rows:
        log("net_ref_round " + json.dumps(row))
    n = sum(l.numel() for l in tree_leaves(params))
    procs = []
    t0 = time.perf_counter()
    try:
        for name in ("nodeA", "nodeB"):
            procs.append(spawn_local_daemon(name, runtime="inproc",
                                            timeout=300.0,
                                            device=daemon_device))
        spawn_s = time.perf_counter() - t0
        addrs = [a for _, a in procs]
        zero_fold_launches()
        rows, diffs = [], []
        for compress, rounds in ((0, 3), (6, 1)):
            with Session.open(model, params, clients(), nodes=addrs,
                              round_cfg=rc("node"), wire_compress=compress,
                              seed=0, device=device) as s:
                remote = s.trainer._runtime
                for r in range(rounds):
                    w0 = wire_totals(remote)
                    row = logged_round(
                        s, f"net{'-z' if compress else ''}-{r}", device)
                    w1 = wire_totals(remote)
                    row.update({f"wire_{k}": w1[k] - w0[k] for k in w0})
                    row["compress"] = compress
                    row["daemon_agg_exec_s"] = {
                        node: sum(v[0] for k, v in per.items()
                                  if k.endswith("/agg_exec_s"))
                        for node, per in s.trace().telemetry.items()}
                    row["max_abs_diff_vs_inproc"] = max_diff(
                        leaves_cpu(s.params), ref[r])
                    diffs.append(row["max_abs_diff_vs_inproc"])
                    rows.append(row)
                    log("net_round " + json.dumps(row))
        launches = fold_launches()
        spread = two_node_round(addrs, n, device)
        log("net_two_node_round " + json.dumps(spread))
        daemons = [daemon_stats(a) for a in addrs]
    finally:
        for p, _ in procs:
            reap_local_daemon(p)
    # a daemon's publish: its accumulator to the host (TorchEngine.
    # to_numpy, as the daemon calls it), timed here on the same card
    eng = TorchEngine(device)
    acc = eng.begin(n)
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        eng.to_numpy(acc)
        times.append(time.perf_counter() - t1)
    del acc, eng
    z = rows[-1]
    row = {"spawn_s": spawn_s, "rounds": len(rows),
           "max_abs_diff_vs_inproc": diffs, "atol": PARITY_ATOL,
           "daemons": [{k: d[k] for k in ("node", "device",
                                          "kernel_launches", "daemon")}
                       for d in daemons],
           "launches": launches, "two_node_round": spread,
           "publish_copy_s": sorted(times)[2],
           "warm_wall_s": min(r["wall_s"] for r in rows[1:3]),
           "inproc_warm_wall_s": min(r["wall_s"] for r in ref_rows[1:3]),
           "warm_trace": min(rows[1:3], key=lambda r: r["wall_s"]),
           "inproc_warm_trace": min(ref_rows[1:3],
                                    key=lambda r: r["wall_s"]),
           "compressed_ratio": z["wire_tx"] / max(1, z["wire_tx_raw"])}
    log("multinode " + json.dumps(row))
    if any(r["updates"] != RT_GOAL for r in rows):
        raise AssertionError("a multi-node round fell short of its goal")
    if not max(diffs) <= PARITY_ATOL:
        raise AssertionError(f"multi-node vs inproc {max(diffs):.3e} > "
                             f"{PARITY_ATOL}")
    return row


#: the serve phase's external client: it imports the port alone and
#: pushes three updates of the model's size, not retrying a busy verdict
SERVE_CLIENT = """
import json, sys
import numpy as np
from repro_torch.runtime.netrt import BusyError, push_update
addr, n = sys.argv[1], int(sys.argv[2])
rng = np.random.default_rng(7)
out = []
for i in range(3):
    u = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    try:
        ack = push_update(addr, f"edge-{i}", u, weight=4.0, busy_retries=0)
        out.append({"client": f"edge-{i}", "queued": ack["queued"]})
    except BusyError as e:
        out.append({"client": f"edge-{i}", "busy": True,
                    "retry_after_s": e.retry_after_s})
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules)
print(json.dumps(out))
"""


def phase_serve_ingest(fleet, device="cuda"):
    """``Session.serve()`` behind ``admission=AdmissionPolicy(max_queue=
    2)``: a client process pushes three full-size updates, two are
    queued and the third comes back ``busy`` with ``retry_after_s``; the
    round that follows folds the two in place of two clients."""
    model, params, clients, nodes, _ = fleet
    n = sum(l.numel() for l in tree_leaves(params))
    zero_fold_launches()
    arrived = []
    with Session.open(model, params, clients(), nodes=nodes(),
                      round_cfg=RoundConfig(aggregation_goal=RT_GOAL),
                      seed=0, device=device,
                      admission=AdmissionPolicy(max_queue=2,
                                                retry_base_s=0.05)) as s:
        addr = s.serve("127.0.0.1:0")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", SERVE_CLIENT, addr, str(n)],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        push_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"serve client failed:\n{r.stderr[-3000:]}")
        pushed = json.loads(r.stdout.strip().splitlines()[-1])
        s.on(UpdateArrived, lambda ev: arrived.append(ev.client_id))
        row = logged_round(s, "serve", device)
        ingress = s.metrics()["ingress"]
        finite = all(bool(torch.isfinite(l).all())
                     for l in tree_leaves(s.params))
    row.update({"pushed": pushed, "client_process_s": push_s,
                "externals_folded": sorted(c for c in arrived
                                           if c.startswith("edge-")),
                "ingress": ingress, "launches": fold_launches()})
    log("serve_ingest " + json.dumps(row))
    if sum(1 for p in pushed if p.get("busy")) < 1:
        raise AssertionError("admission never pushed back")
    if row["externals_folded"] != ["edge-0", "edge-1"] \
            or row["updates"] != RT_GOAL or not finite:
        raise AssertionError(f"the served updates were not folded: {row}")
    return row


# ---------------------------------------------------------------------------
# phases 16-17: the always-on service, checkpoints
# ---------------------------------------------------------------------------

#: phase 16's jobs: fair-share weight; both share phase 5's fleet
SVC_JOBS = {"femnist-a": 2.0, "femnist-b": 1.0}
SVC_GOAL, SVC_ROUNDS = 4, 3


def client_deltas(fleet):
    """Phase 5's eight clients' local updates from the seed-0 params (one
    epoch of SGD at the paper's lr and batch) as the wire's fp32
    vectors, with their sample counts: what the service's jobs are
    sent."""
    model, params, clients, _, _ = fleet
    rng = np.random.default_rng(0)
    out = []
    for c in clients():
        delta, w = c.local_update(model, params, lr=CLIENT_LR, batch_size=32,
                                  epochs=1, rng=rng)
        out.append((flatten_jax_layout(delta)[0], w))
    return out


def push_bf16(addr, job, cid, flat, weight):
    """One ``submit_update`` frame carrying ``flat`` rounded to bf16 (its
    raw words under the name ``bfloat16``, as the JAX package's wire
    names it): the port's push_update takes numpy arrays, and numpy has
    no bf16."""
    words = torch.from_numpy(flat).to(torch.bfloat16).view(torch.int16)
    conn = connect(addr, timeout=30.0)
    try:
        conn.send("hello", {"role": "client"})
        conn.recv_expect(("welcome",), 30.0)
        conn.send("submit_update", {
            "client_id": cid, "weight": weight, "submission_id": cid,
            "job": job, "dtype": "bfloat16", "shape": [flat.size]},
            blob=words.numpy())
        reply = conn.recv_expect(("ack", "error", "busy"), 60.0)
    finally:
        conn.close()
    if reply.kind != "ack":
        raise AssertionError(f"bf16 push refused: {reply.meta}")
    return words.view(torch.bfloat16).float().numpy()


def replay_job(recs, params, updates, twice=False, device="cuda"):
    """A job's closed rounds replayed in order on the card, each cohort
    through a fresh sequential ``RoundDriver`` (the library path) and
    the server step the trainer takes; ``twice`` folds the first
    round's first update twice, in place of its second (the planted
    fault).  -> the params after the last round."""
    rt = InProcRuntime(agg_engine=EngineConfig(name="auto", device=device))
    drv = RoundDriver(rt)
    state = init_server_state("fedavg", params)
    n = sum(l.numel() for l in tree_leaves(params))
    try:
        for i, rec in enumerate(recs):
            cohort = [(n, cid, updates[cid], w) for n, cid, w in rec["cohort"]]
            if twice and i == 0:
                cohort[1] = cohort[0]
            out = drv.run_round(round_id=rec["ticket"],
                                assignment=rec["assignment"],
                                updates=cohort, goal=len(cohort),
                                n_elems=n, top_node=rec["top_node"])
            params, state = apply_server_opt(
                "fedavg", params, state,
                unflatten_jax_layout(out.delta, params), lr=-1.0)
    finally:
        rt.close()
    return params


def phase_service(fleet, ckpt_dir, device="cuda"):
    """One ``AggregationService`` on the card with two jobs of phase 5's
    full-width ResNet-18 (seed-0 params, weights 2:1) over phase 5's
    fleet: the jobs' updates are the clients' real deltas, queued
    through admission, one of them pushed over the wire as bf16; three
    rolling rounds a job closed by ``MinCohortIdleGap``; job a
    checkpoints its params after its last round (phase 17).  Each job's
    params against its cohorts replayed in order on the card, and one
    update folded twice above ``PARITY_ATOL``."""
    model, params, clients, nodes, _ = fleet
    deltas = client_deltas(fleet)
    jobs = list(SVC_JOBS)
    svc = AggregationService(nodes(), admission=AdmissionPolicy(max_queue=64),
                             device=device)
    updates, published = {}, []
    try:
        for job, weight in SVC_JOBS.items():
            tr = svc.add_job(job, model, params, clients(), weight=weight,
                             round_cfg=RoundConfig(aggregation_goal=SVC_GOAL))
            if not isinstance(svc.runtime.engine_for(f"mid:{job}@probe"),
                              TorchEngine):
                raise AssertionError("the service took a numpy engine")
        # phase 17: job a's trainer checkpoints at its last round's end
        tr_a = svc.trainer(jobs[0])
        tr_a.ckpt, tr_a.checkpoint_every = \
            AsyncCheckpointer(ckpt_dir), SVC_ROUNDS
        addr = svc.serve("127.0.0.1:0")
        t0 = time.perf_counter()
        cid = f"{jobs[0]}-u0"
        updates[cid] = push_bf16(addr, jobs[0], cid, deltas[0][0],
                                 deltas[0][1])
        push_s = time.perf_counter() - t0
        for job in jobs:
            for k in range(SVC_GOAL * SVC_ROUNDS):
                cid = f"{job}-u{k}"
                if cid in updates:
                    continue
                flat, w = deltas[(k + 3 * jobs.index(job)) % len(deltas)]
                v = svc.submit(job, cid, flat, w, submission_id=cid)
                if not v["admitted"]:
                    raise AssertionError(f"{cid} not admitted: {v}")
                updates[cid] = flat
        svc.driver.on(PartialReady, published.append)
        zero_fold_launches()
        t0 = time.perf_counter()
        recs = svc.run_rounds(
            {job: SVC_ROUNDS for job in jobs},
            policy=MinCohortIdleGap(min_cohort=SVC_GOAL, idle_gap_s=0.05))
        synced(device)
        wall = time.perf_counter() - t0
        launches = fold_launches()
        tr_a.ckpt.wait()
        health = svc.health()
        traces = {job: svc.trainer(job).trace() for job in jobs}
        engines = dict(svc.runtime._engines)
        final = {job: svc.trainer(job).params for job in jobs}
        overlap = svc.pipeline_overlap()
    finally:
        svc.close()
    mids = [e for k, e in engines.items() if k.startswith("mid")]
    tops = [e for k, e in engines.items() if k.startswith("top")]
    copies = sum(e.host_copies for e in mids)
    by_job = {job: [r for r in recs if r["job"] == job] for job in jobs}
    rows = {}
    for job in jobs:
        rs = by_job[job]
        walls = [r["t_close"] - r["t_open"] for r in rs]
        want = replay_job(rs, params, updates, device=device)
        diff = max_diff(leaves_cpu(final[job]), leaves_cpu(want))
        rows[job] = {"rounds": len(rs), "weight": SVC_JOBS[job],
                     "cohorts": [len(r["cohort"]) for r in rs],
                     "round_wall_s": walls, "warm_round_wall_s":
                     min(walls[1:]), "max_abs_diff_vs_sequential": diff,
                     "bitexact_vs_sequential": diff == 0.0,
                     # the job's last round, split by its trace
                     "last_round_trace": traces[job].breakdown()}
    fault = max_diff(leaves_cpu(final[jobs[0]]), leaves_cpu(
        replay_job(by_job[jobs[0]], params, updates, twice=True,
                   device=device)))
    row = {"jobs": rows, "wall_s": wall, "pipeline_overlap": overlap,
           "bf16_push_s": push_s,
           "bf16_in_cohort": any(c == f"{jobs[0]}-u0"
                                 for r in recs for _, c, _ in r["cohort"]),
           "launches": launches, "publishes": len(published),
           "publish_host_copies": copies,
           "host_copies_per_publish": copies / max(len(published), 1),
           "publish_copy_ms": (sum(e.host_copy_s for e in mids)
                               / max(copies, 1) * 1e3),
           "top_fold_host_copies": sum(e.host_copies for e in tops),
           "fault_max_abs_diff": fault, "atol": PARITY_ATOL}
    log("service " + json.dumps(row))
    log("service_health " + summary_line(health))
    if any(r["rounds"] != SVC_ROUNDS or min(r["cohorts"]) != SVC_GOAL
           for r in rows.values()) or not row["bf16_in_cohort"]:
        raise AssertionError(f"the service rounds fell short: {row}")
    if any(r["max_abs_diff_vs_sequential"] > PARITY_ATOL
           for r in rows.values()):
        raise AssertionError(f"service vs sequential above {PARITY_ATOL}")
    if not fault > PARITY_ATOL:
        raise AssertionError(f"the update folded twice went unseen: {fault}")
    if row["host_copies_per_publish"] != 1.0:
        raise AssertionError(f"{copies} host copies for "
                             f"{len(published)} publishes")
    if device == "cuda":
        check_fold_launches("the service rounds", launches,
                            ("eager_accumulate",))
    return row, final[jobs[0]], tr_a.ckpt


def phase_checkpoint(params, ckpt, ckpt_dir):
    """Phase 16's job-a checkpoint (``AsyncCheckpointer`` at its last
    round's end) restored and held against the job's params bit for
    bit; the submit's time in the round (the snapshot to pinned host
    memory) and the write's on its thread, for that first submit (it
    allocates the pinned buffers) and a second one (it reuses them)."""
    t0 = time.perf_counter()
    got, step = restore_checkpoint(ckpt_dir, like=params)
    synced(tree_leaves(got)[0].device)
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(params)))
    nbytes = sum(f.stat().st_size for f in Path(ckpt_dir).glob("*.npz"))
    first = (ckpt.submit_s, ckpt.write_s)
    ckpt.submit(step + 1, params)
    ckpt.wait()
    row = {"step": step, "bitexact": same, "submit_ms": first[0] * 1e3,
           "write_ms": first[1] * 1e3, "warm_submit_ms": ckpt.submit_s * 1e3,
           "warm_write_ms": ckpt.write_s * 1e3, "restore_ms": restore_s * 1e3,
           "npz_bytes": nbytes, "completed": ckpt.completed}
    log("checkpoint " + json.dumps(row))
    if not same or step != SVC_ROUNDS or ckpt.completed != 2:
        raise AssertionError(f"checkpoint round trip failed: {row}")
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

    # phases 13-15: phase 5's workload on the shmproc and multi-node
    # runtimes and through serve mode (the kernels were built in phase
    # 2, before any daemon starts)
    fleet = resnet_fleet()
    with deterministic_convs():
        shm_row = phase_shmproc(fleet)
        net_row = phase_multinode(fleet)
    landed = [d for d in net_row["daemons"]
              if d["daemon"]["updates_landed"] > 0]
    if not landed or any(not d["device"].startswith("cuda")
                         for d in net_row["daemons"]):
        raise AssertionError(f"the daemons did not fold on the card: "
                             f"{net_row['daemons']}")
    for d in landed:
        check_fold_launches(f"netd {d['node']}", d["kernel_launches"],
                            ("eager_accumulate",))
    ingest_row = phase_serve_ingest(fleet)
    check_fold_launches("the serve round", ingest_row["launches"],
                        ("eager_accumulate",))

    # phases 16-17: the always-on service over phase 5's fleet, and job
    # a's checkpoint; the engines' fold speedup for the simulator
    ckpt_dir = ROOT / "build" / "phase17_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    svc_row, svc_params, ckpt = phase_service(fleet, ckpt_dir)
    ckpt_row = phase_checkpoint(svc_params, ckpt, ckpt_dir)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    speedup = engine_speedup()
    log("engine_speedup " + json.dumps(speedup))
    del fleet, svc_params

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
            "bound_copy_ms": row["bound_copy_ms"],
            "launches_by_path": {
                "phase 5: ResNet rounds, inproc": launches[kern.name],
                "phase 13: shmproc, controller (workers fold with numpy)":
                    shm_row["launches"][kern.name],
                "phase 14: multi-node, in netd": sum(
                    d["kernel_launches"][kern.name]
                    for d in net_row["daemons"]),
                "phase 14: multi-node, controller":
                    net_row["launches"][kern.name],
                "phase 15: serve round, inproc":
                    ingest_row["launches"][kern.name],
                "phase 16: service, two jobs, inproc":
                    svc_row["launches"][kern.name]}})
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
        + fused_dev["dequantize_ms"],
        "shmproc_warm_wall_s": shm_row["warm_wall_s"],
        "shmproc_fork_cold_s": shm_row["stats"]["cold_latency_s"],
        "shmproc_fork_warm_s": shm_row["stats"]["warm_latency_s"],
        "multinode_warm_wall_s": net_row["warm_wall_s"],
        "multinode_compressed_ratio": net_row["compressed_ratio"],
        "service_wall_s": svc_row["wall_s"],
        "service_warm_round_wall_s": {
            j: r["warm_round_wall_s"] for j, r in svc_row["jobs"].items()},
        "service_pipeline_overlap": svc_row["pipeline_overlap"],
        "publish_host_copies_per_publish": svc_row["host_copies_per_publish"],
        "publish_copy_ms": svc_row["publish_copy_ms"],
        "checkpoint_submit_ms": ckpt_row["submit_ms"],
        "checkpoint_write_ms": ckpt_row["write_ms"],
        "torch_engine_speedup": speedup["speedup"]["torch"]}))
    log(json.dumps({"kernels": out}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
