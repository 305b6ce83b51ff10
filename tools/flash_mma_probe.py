#!/usr/bin/env python3
"""Where the 16-bit mma.sync flash kernel's time goes, on one NVIDIA GPU.

    python3 tools/flash_mma_probe.py

Builds ``csrc/flash_attention_mma.cu`` as it is and in variants made by
editing its text (each edit must apply), and prints one JSON line each:
its registers and spills (``nvcc -Xptxas -v``), its largest error
against the plain version as a share of the 16-bit limit
(``|got - ref| <= 2e-2 + 2e-2 |ref|``; above 1 is outside) on views off
16 bytes and odd head dims, and its time (CUDA events around
back-to-back calls, median) at h2o-danube-3-4b's shape off 16 bytes,
seamless-m4t-large-v2's encoder off 16 bytes (non-causal) and the serve
path's shape on aligned bf16 (where the wgmma kernel runs too).  Beside
them: the CUDA-core kernel, the wgmma kernel, ``scaled_dot_product_
attention``, and the 3xTF32 kernel's 16- and 4-byte copies at the serve
path's shape in fp32.  For the shipped kernel, the wgmma kernel and the
library call, also the device time alone (``torch.profiler``, the sum of
the call's kernels), which the host's launch cost hides at small shapes.  The variants:

- ``one_mtile``: one 16-row m tile a warp and 64-key tiles, so that
  each K or V fragment serves one m tile, not two;
- ``four_warps``: two blocks of 4 warps an SM (128 query rows each), out
  of step with each other, not one of 8;
- ``bn64``: 64-key tiles, not 32 (twice the scores and staged loads in
  registers);
- ``realign_early``: each piece shifted into place as soon as its words
  are loaded, so the thread waits for them before the products;
- ``no_loads``, ``no_qk``, ``no_pv``, ``no_sync``: the time without the
  next tiles' loads and stores, the Q.K^T products, the P.V products, or
  the barrier a tile (wrong outputs, for the breakdown only).

Then the ceiling of ``mma.sync`` m16n8k16 bf16 on the card: a kernel of
eight independent accumulator chains a warp, at 1, 2 and 4 blocks of 4
warps an SM.  Exits non-zero without a card.  Not part of the port: its
numbers go into PERF.md with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.build import (  # noqa: E402
    BUILD_DIR, DTYPE_CODES, NVCC_FLAGS, nvcc)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    LIB_MMA, LIBS, flash_attention_fwd_cuda, load_width)

TOL = 2e-2
OUT = BUILD_DIR / "probe_mma"
#: (label, B, S, K, G, D, Dv, window, causal, dtype, element offset)
CHECKS = [("h2o_off1", 4, 2000, 8, 4, 120, 120, 4096, True, "bf16", 1),
          ("seamless_off1", 4, 512, 16, 1, 64, 64, -1, False, "bf16", 1),
          ("seamless_aligned", 4, 512, 16, 1, 64, 64, -1, False, "bf16", 0),
          ("path_aligned", 4, 2000, 8, 3, 128, 128, -1, True, "bf16", 0),
          ("odd15", 1, 300, 2, 3, 15, 15, -1, True, "fp16", 0),
          ("d256_off3", 1, 700, 2, 2, 256, 256, 300, True, "bf16", 3),
          ("dv36_off1", 1, 333, 2, 2, 120, 36, 100, True, "fp16", 1),
          ("width8", 2, 150, 1, 3, 36, 36, 40, True, "bf16", 0)]
TIMED = ("h2o_off1", "seamless_off1", "seamless_aligned", "path_aligned")
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}

ONE_MTILE = (("constexpr int kMT = 2;", "constexpr int kMT = 1;"),
             ("constexpr int kBN = 32;", "constexpr int kBN = 64;"))
FOUR_WARPS = ("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")
BN64 = ("constexpr int kBN = 32;", "constexpr int kBN = 64;")
LOADS = """    if (more) {
      tk.load(kb, k_rs, kv0 + kBN, S, D, DP);
      tv.load(vb, v_rs, kv0 + kBN, S, vw, DVC);
    }
"""
STORES = """    if (more) {
      tk.store(Ks + (cur ^ 1) * kBN * QS, QS, DP);
      tv.store(Vs + (cur ^ 1) * kBN * VS, VS, DVC);
    }
"""
QK = """            Ops<T>::mma(s[mt][2 * jj], a[mt], bk[jj][0], bk[jj][1]);
            Ops<T>::mma(s[mt][2 * jj + 1], a[mt], bk[jj][2], bk[jj][3]);"""
PV = """          Ops<T>::mma(acc[mt][2 * n], pa[kk][mt], bv[i % 2][0], bv[i % 2][1]);
          Ops<T>::mma(acc[mt][2 * n + 1], pa[kk][mt], bv[i % 2][2],
                      bv[i % 2][3]);"""
SYNC = "    __syncthreads();        // the next tile stored, this one read by all"

LATE_FINISH = """    finish_piece<W, SPAN>(pc);
    const int len = cols / kTPR;"""
EARLY_LOAD = """                        s < S ? n : 0);
  }"""
EARLY_FINISH = """                        s < S ? n : 0);
    finish_piece<W, SPAN>(pc);
  }"""

MMA_BENCH = r"""
#include <stdint.h>
extern "C" __global__ void hmma_bench(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 7, b1 = threadIdx.x * 11;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c)
    for (int i = 0; i < 4; ++i) s += acc[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""


def edited(src: str, *edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"edit does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name: str, text: str):
    """-> (ctypes entry, build s, the ptxas lines on registers and spills)."""
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    build_s = time.perf_counter() - t0
    fn = getattr(ctypes.CDLL(str(lib)), "flash_attention_fwd_mma")
    fn.argtypes = LIB_MMA.signatures["flash_attention_fwd_mma"]
    fn.restype = ctypes.c_int
    kernels = re.findall(r"flash_fwd_mma_kernelI(\w+?)EEv", proc.stderr)
    regs = re.findall(r"Used (\d+) registers", proc.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    return fn, {"build_s": build_s,
                "registers": dict(zip(kernels, map(int, regs))),
                "spill_store_bytes": dict(zip(kernels, map(int, spills)))}


def time_ms(fn, reps=10, inner=10) -> float:
    for _ in range(3):
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
    return sorted(times)[len(times) // 2]


def launch(fn, q, k, v, window, causal):
    B, S, K, G, D = q.shape
    Dv = v.shape[-1]
    o = torch.empty((B, S, K, G, Dv), dtype=q.dtype, device="cuda")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    rc = fn(*ptrs, o.data_ptr(), B, S, K * G, K, D, Dv, float(D ** -0.5),
            window, int(causal), DTYPE_CODES[q.dtype],
            load_width(ptrs, 2, K * G, K, D, Dv),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return o


def limit_share(got, want) -> float:
    return float(((got.double() - want.double()).abs()
                  / (TOL + TOL * want.double().abs())).max())


def inputs(g, B, S, K, G, D, Dv, dtype, off):
    def mk(*shape):
        n = 1
        for x in shape:
            n *= x
        buf = torch.randn(n + off, generator=g, device="cuda").to(dtype)
        return buf[off:].view(shape)

    return mk(B, S, K, G, D), mk(B, S, K, D), mk(B, S, K, Dv)


def library(q, k, v, window, causal):
    B, S, K, G, D = q.shape
    qh = q.reshape(B, S, K * G, D).transpose(1, 2).contiguous()
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    if window < 0:
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True, scale=D ** -0.5)
    i = torch.arange(S, device="cuda")
    band = (i[:, None] - i[None, :] < window) & (i[:, None] >= i[None, :])
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=band, enable_gqa=True, scale=D ** -0.5)


def device_ms(fn, n=20) -> float:
    """Device ms a call: the sum of its kernels' device time under
    torch.profiler, over n calls."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / n / 1e3


def mma_ceiling():
    """TFLOP/s of mma.sync m16n8k16 bf16 at 1, 2 and 4 blocks an SM."""
    cu, cubin = OUT / "hmma_bench.cu", OUT / "hmma_bench.cubin"
    cu.write_text(MMA_BENCH)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-cubin", "-o", str(cubin), str(cu)], check=True)
    cuda = ctypes.CDLL("libcuda.so.1")
    mod, fn = ctypes.c_void_p(), ctypes.c_void_p()
    if cuda.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()) or \
            cuda.cuModuleGetFunction(ctypes.byref(fn), mod, b"hmma_bench"):
        raise RuntimeError("cannot load the mma benchmark")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, iters, threads = [], 4000, 128
    for per_sm in (1, 2, 4):
        blocks = sms * per_sm
        buf = torch.empty(blocks * threads, device="cuda")
        p_out, p_it = ctypes.c_void_p(buf.data_ptr()), ctypes.c_int(iters)
        args = (ctypes.c_void_p * 2)(ctypes.addressof(p_out),
                                     ctypes.addressof(p_it))

        def run():
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            if cuda.cuLaunchKernel(fn, blocks, 1, 1, threads, 1, 1, 0,
                                   stream, args, None):
                raise RuntimeError("mma benchmark launch failed")

        ms = time_ms(run, reps=5, inner=2)
        flops = 2.0 * 16 * 8 * 16 * 8 * iters * (threads // 32) * blocks
        rows.append({"blocks_per_sm": per_sm, "warps_per_sm": 4 * per_sm,
                     "ms": ms, "tflops": flops / ms / 1e9})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_mma_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    src = LIB_MMA.src.read_text()
    variants = {
        "shipped": src,
        "one_mtile": edited(src, *ONE_MTILE),
        "four_warps": edited(src, FOUR_WARPS),
        "bn64": edited(src, BN64),
        "realign_early": edited(src, (LATE_FINISH, "    const int len = "
                                      "cols / kTPR;"),
                                (EARLY_LOAD, EARLY_FINISH)),
        "no_loads": edited(src, (LOADS, ""), (STORES, "")),
        "no_qk": edited(src, (QK, "")),
        "no_pv": edited(src, (PV, "")),
        "no_sync": edited(src, (SYNC, "")),
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants) + len(LIBS)) as pool:
        libs = [pool.submit(lib.build) for lib in LIBS]
        built = dict(zip(variants, pool.map(lambda kv: build(*kv),
                                            variants.items())))
        for f in libs:
            f.result()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    shares = {name: {} for name in variants}
    times = {name: {} for name in (*variants, "cuda_cores", "wgmma", "sdpa")}
    device = {name: {} for name in ("shipped", "wgmma", "sdpa")}
    for label, B, S, K, G, D, Dv, window, causal, dt, off in CHECKS:
        q, k, v = inputs(g, B, S, K, G, D, Dv, DTYPES[dt], off)
        kw = dict(window=window, causal=causal, scale=D ** -0.5)
        want = fa_ops.flash_attention(q, k, v, impl="torch", **kw)
        for name, (fn, _) in built.items():
            try:
                shares[name][label] = limit_share(
                    launch(fn, q, k, v, window, causal), want)
            except RuntimeError as e:    # a variant that does not fit
                shares[name][label] = str(e)
        if label in TIMED:
            # in turns: variants, the others, shipped again
            for name, (fn, _) in built.items():
                if isinstance(shares[name][label], float):
                    times[name][label] = time_ms(
                        lambda: launch(fn, q, k, v, window, causal))
            times["cuda_cores"][label] = time_ms(
                lambda: flash_attention_fwd_cuda(q, k, v, variant="simt",
                                                 **kw), reps=3)
            if off == 0:
                times["wgmma"][label] = time_ms(
                    lambda: flash_attention_fwd_cuda(q, k, v, **kw))
            times["sdpa"][label] = time_ms(library(q, k, v, window, causal))
            device["shipped"][label] = device_ms(lambda: launch(
                built["shipped"][0], q, k, v, window, causal))
            device["sdpa"][label] = device_ms(library(q, k, v, window,
                                                      causal))
            if off == 0:
                device["wgmma"][label] = device_ms(
                    lambda: flash_attention_fwd_cuda(q, k, v, **kw))
            times["shipped"][label] = min(times["shipped"][label], time_ms(
                lambda: launch(built["shipped"][0], q, k, v, window,
                               causal)))
        del q, k, v, want
    for name, (_, info) in built.items():
        print(json.dumps({"variant": name, "ms": times[name],
                          "limit_share": shares[name], **info}), flush=True)
    for name in ("cuda_cores", "wgmma", "sdpa"):
        print(json.dumps({"variant": name, "ms": times[name]}), flush=True)
    print(json.dumps({"device_ms": device}), flush=True)

    # the 3xTF32 kernel's 16- and 4-byte copies at the serve path's shape
    fp32 = {}
    for off in (0, 1, 0, 1):
        q, k, v = inputs(g, 4, 2000, 8, 3, 128, 128, torch.float32, off)
        run = lambda: flash_attention_fwd_cuda(q, k, v, scale=128 ** -0.5)
        ms = time_ms(run)
        key = f"tf32x3_off{off}_ms"
        fp32[key] = min(ms, fp32.get(key, ms))
        del q, k, v
    print(json.dumps(fp32), flush=True)
    print(json.dumps({"mma_sync_bf16_ceiling": mma_ceiling()}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
