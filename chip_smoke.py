#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Drives ``repro_torch`` end to end on the card and fails (non-zero exit)
on any fault; it imports nothing of the JAX package.  Phases:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for convolutions and matmuls.
2. build: compiles ``csrc/fedavg.cu`` with ``nvcc`` into
   ``build/repro_torch/`` and times it; measures the card's
   device-to-device copy bandwidth, the practical ceiling of a fold.
3. kernels: each fedavg CUDA kernel against its plain PyTorch version
   at the ResNet-18 update size (N = 11,199,486), one JSON line per
   case: errors, kernel / plain / library times (median of CUDA-event
   timings) and the bound at the nominal and the measured bandwidth.
4. engine: the port's ``Aggregator`` on ``TorchEngine(cuda)`` folds six
   ResNet-18-sized updates, eager and lazy, against ``fedavg_oracle``.
5. round: ``repro_torch.api.Session`` on full-width ResNet-18 (random
   weights from a seed) and synthetic FEMNIST: two eager rounds, then
   one lazy round; the launch counts are zeroed just before and read
   just after, and both accumulate kernels must have run.  Then the
   same path at reduced width on the card and on the CPU (the kernels'
   plain versions) must give the same params within ``PARITY_ATOL``,
   and a run with one update planted twice must not.
6. summary: a ``{"kernels": [...]}`` line (phase 3's rows at the main
   path's shapes; the burst timed again at the lazy round's K), the device line, and the
   last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.resnet import RESNET18  # noqa: E402
from repro_torch.core import (Aggregator, ClientInfo, InProcObjectStore,  # noqa: E402
                              NodeState, RoundConfig, TorchEngine,
                              UpdateEnvelope, fedavg_oracle)
from repro_torch.data import (ClientShard, build_client_datasets,  # noqa: E402
                              dirichlet_partition, synthetic_femnist)
from repro_torch.kernels.fedavg import fedavg as fed  # noqa: E402
from repro_torch.kernels.fedavg import ops, ref  # noqa: E402
from repro_torch.models.resnet import build_resnet  # noqa: E402
from repro_torch.runtime import ClientRuntime, PartialReady  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N_RESNET18 = 11_199_486      # fp32 parameters of RESNET18
NOMINAL_BPS = 3.35e12        # H100 SXM HBM3, NVIDIA's data sheet
FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores
RTOL = {"eager_accumulate": 1e-6, "fedavg_accumulate_k": 1e-5,
        "fedavg_reduce": 1e-5}
PARITY_ATOL = 3e-4           # card vs CPU params, phase 5
CLIENT_LR = 0.01             # the paper's client SGD (§6.2: lr 0.01, batch 32)


def log(*args) -> None:
    print(*args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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


def kernel_case(name, dtype, k, copy_bps, n=N_RESNET18):
    """One kernel at one dtype and K against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(0)
    acc0 = torch.randn(n, generator=g, device="cuda")
    esz = torch.tensor([], dtype=dtype).element_size()
    if name == "eager_accumulate":
        u = torch.randn(n, generator=g, device="cuda").to(dtype)
        w = 1.75
        got = ops.eager_accumulate(acc0.clone(), u, w, impl="cuda")
        want = ref.eager_accumulate_ref(acc0, u, w)
        acc = acc0.clone()
        run = lambda: ops.eager_accumulate(acc, u, w, impl="cuda")
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
    row = {
        "name": name, "dtype": str(dtype).replace("torch.", ""), "K": k,
        "N": n, "max_abs_err": max_abs, "max_rel_err": max_rel,
        "ms": time_ms(run), "plain_ms": time_ms(plain),
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
    cases = [("eager_accumulate", torch.float32, 1),
             ("eager_accumulate", torch.bfloat16, 1),
             ("eager_accumulate", torch.float16, 1),
             ("fedavg_accumulate_k", torch.float32, 8),
             ("fedavg_accumulate_k", torch.bfloat16, 8),
             ("fedavg_reduce", torch.float32, 8)]
    for name, dtype, k in cases:
        row = kernel_case(name, dtype, k, copy_bps)
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
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # phase 2: build + copy bandwidth
    t0 = time.perf_counter()
    lib = fed.build()
    log(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
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

    # phase 6: summary at the main path's shapes (f32 wire; the lazy
    # round's largest burst for fedavg_accumulate_k): the phase-3 rows
    # where they are those shapes
    main_k = {"eager_accumulate": 1, "fedavg_accumulate_k": max(k_main, 2),
              "fedavg_reduce": 8}
    measured = {(r["name"], r["K"]): r for r in cases
                if r["dtype"] == "float32"}
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
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "K": row["K"], "N": row["N"],
            "bound_copy_ms": row["bound_copy_ms"]})
    kernel_ms = sum(launches[o["name"]] * o["ms"] for o in out) / 1e3
    log("summary " + json.dumps({
        "rounds": len(rounds),
        "client_train_s": sum(r["trace_client_train_s"] for r in rounds),
        "agg_exec_s": sum(r["agg_exec_s"] for r in rounds),
        "kernel_s_est": kernel_ms,
        "staging_s_per_fold": stage_s,
        "wall_s": sum(r["wall_s"] for r in rounds)}))
    log(json.dumps({"kernels": out}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
