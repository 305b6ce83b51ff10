#!/usr/bin/env python3
"""Where the fp32 flash kernel's time and error go, on one NVIDIA GPU.

    python3 tools/flash_tf32x3_probe.py

Builds ``csrc/flash_attention_tf32x3.cu`` as it is and in variants made
by editing its text (each edit must apply), and prints one JSON line
each: its registers and spills (``nvcc -Xptxas -v``), its largest error
against the plain version as a share of the fp32 limit
(``|got - ref| <= 2e-6 + 2e-6 |ref|``; above 1 is outside) at phase 6's
fp32 shapes of ``chip_smoke.py``, and its time at the serve path's
shape (CUDA events around back-to-back calls, median), beside the
CUDA-core kernel's.  The variants:

- ``chained_qk``: Q.K^T's three products accumulate in the running sum
  (the tensor cores' truncating adds on the running sum);
- ``lo_truncated``: lo = x - hi goes to the tensor cores unrounded;
- ``one_pass``: one TF32 product a step (hi.hi), not fp32-accurate;
- ``no_pv``: Q.K^T and the softmax alone (the output is wrong);
- ``three_blocks``: one K/V stage and at most 168 registers a thread
  (and the contraction loop not unrolled), so that three blocks, not
  two, share an SM.

Then the ceiling of ``mma.sync`` m16n8k8 tf32 on the card: a kernel of
eight independent accumulator chains a warp, at 1 to 4 blocks of 4
warps an SM.  Exits non-zero without a card.  Not part of the port:
its numbers go into PERF.md with the card's name and power limit.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    _ARGS, LIB, LIB_TF32X3, flash_attention_fwd_cuda)

TOL = 2e-6
OUT = BUILD_DIR / "probe"
#: phase 6's fp32 shapes (B, S, K, G, D, window), the path shape first
SHAPES = [("path", 4, 2000, 8, 3, 128, -1), ("test0", 1, 128, 1, 1, 32, -1),
          ("test1", 2, 256, 2, 3, 64, -1), ("test2", 1, 256, 4, 1, 64, 64),
          ("test3", 2, 192, 2, 2, 32, 16)]

QK = """          mma_3xtf32(s[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);"""
QK_CHAINED = """          mma_tf32(s[j], al[0], bh[0], bh[1], s[j]);
          mma_tf32(s[j], ah[0], bl[0], bl[1], s[j]);
          mma_tf32(s[j], ah[0], bh[0], bh[1], s[j]);
          mma_tf32(s[j], al[1], bh[2], bh[3], s[j]);
          mma_tf32(s[j], ah[1], bl[2], bl[3], s[j]);
          mma_tf32(s[j], ah[1], bh[2], bh[3], s[j]);"""
QK_ONE = """          mma_tf32(s[j], ah[0], bh[0], bh[1], s[j]);
          mma_tf32(s[j], ah[1], bh[2], bh[3], s[j]);"""
PV = "            mma_3xtf32(acc[a][m], ph, pl, bh0, bh1, bl0, bl1);"
PV_ONE = "            mma_tf32(acc[a][m], ph, bh0, bh1, acc[a][m]);"
LO = "lo = tf32_rna(x - __uint_as_float(hi));"
LO_TRUNC = "lo = __float_as_uint(x - __uint_as_float(hi));"
ONE_STAGE = ("constexpr int kStages = 2;", "constexpr int kStages = 1;")
THREE_BLOCKS = ("__launch_bounds__(kThreads, 2)",
                "__launch_bounds__(kThreads, 3)")
NO_UNROLL = ("#pragma unroll 2\n", "")

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
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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
    """-> (ctypes entry, the ptxas lines on registers and spills)."""
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), "flash_attention_fwd_tf32x3")
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    regs = re.findall(r"Used (\d+) registers", proc.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    return fn, {"registers": [int(r) for r in regs],
                "spill_store_bytes": [int(b) for b in spills]}


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


def launch(fn, q, k, v, window):
    B, S, K, G, D = q.shape
    o = torch.empty((B, S, K, G, v.shape[-1]), device="cuda")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
            K * G, K, D, v.shape[-1], float(D ** -0.5), window, 1, 0,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return o


def limit_share(got, want) -> float:
    return float(((got.double() - want.double()).abs()
                  / (TOL + TOL * want.double().abs())).max())


def mma_ceiling():
    """TFLOP/s of mma.sync m16n8k8 tf32 at 1, 2 and 4 blocks an SM."""
    cu, cubin = OUT / "mma_bench.cu", OUT / "mma_bench.cubin"
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
        flops = 2.0 * 16 * 8 * 8 * 8 * iters * (threads // 32) * blocks
        rows.append({"blocks_per_sm": per_sm, "warps_per_sm": 4 * per_sm,
                     "ms": ms, "tflops": flops / ms / 1e9})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tf32x3_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    src = LIB_TF32X3.src.read_text()
    variants = {
        "shipped": src,
        "chained_qk": edited(src, (QK, QK_CHAINED)),
        "lo_truncated": edited(src, (LO, LO_TRUNC)),
        "one_pass": edited(src, (QK, QK_ONE), (PV, PV_ONE)),
        "no_pv": edited(src, (PV, "")),
        "three_blocks": edited(src, ONE_STAGE, THREE_BLOCKS, NO_UNROLL),
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(lambda kv: build(*kv),
                                            variants.items())))
    LIB.build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    shares = {name: {} for name in variants}
    times = {}
    for label, B, S, K, G, D, window in SHAPES:
        mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")
        q, k, v = mk(B, S, K, G, D), mk(B, S, K, D), mk(B, S, K, D)
        want = fa_ops.flash_attention(q, k, v, impl="torch", window=window,
                                      causal=True, scale=D ** -0.5)
        for name, (fn, _) in built.items():
            shares[name][label] = limit_share(
                launch(fn, q, k, v, window), want)
        if label == "path":
            simt = lambda: flash_attention_fwd_cuda(
                q, k, v, scale=D ** -0.5, window=window, variant="simt")
            shares.setdefault("cuda_cores", {})[label] = limit_share(
                simt(), want)
            # in turns: shipped, variants, CUDA cores, CUDA cores, shipped
            for name, (fn, _) in built.items():
                times[name] = time_ms(lambda: launch(fn, q, k, v, window))
            times["cuda_cores"] = min(time_ms(simt), time_ms(simt))
            times["shipped"] = min(times["shipped"], time_ms(
                lambda: launch(built["shipped"][0], q, k, v, window)))
        del q, k, v, want
    for name, (_, info) in built.items():
        print(json.dumps({"variant": name, "ms_path": times[name],
                          "limit_share": shares[name], **info}), flush=True)
    print(json.dumps({"variant": "cuda_cores",
                      "ms_path": times["cuda_cores"],
                      "limit_share": shares["cuda_cores"]}), flush=True)
    print(json.dumps({"mma_sync_tf32_ceiling": mma_ceiling()}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
