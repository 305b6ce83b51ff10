"""Launch the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``), the port of ``flash_attention_fwd_pallas``.

The source is built at first use and loaded with ``ctypes`` by
``kernels/build.py``; nothing here runs at import.  The wrapper checks
device, dtype, shapes and contiguity, raises on what the kernel does not
take, allocates the output, launches on PyTorch's current stream
without synchronising, and counts the launch in ``FLASH.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES, CudaKernel, CudaLibrary
from repro_torch.kernels.flash_attention.ref import GLOBAL

#: the largest head dim the kernel takes (q/k and v alike)
MAX_HEAD_DIM = 256

_p, _i32 = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary(
    Path(__file__).with_name("csrc") / "flash_attention.cu",
    "flash_attention", {
        "flash_attention_fwd": [_p, _p, _p, _p, _i32, _i32, _i32, _i32,
                                _i32, _i32, ctypes.c_float, _i32, _i32,
                                _i32, _p],
    })
build = LIB.build

FLASH = CudaKernel(
    "flash_attention_fwd", LIB, "flash_attention_fwd",
    "src/repro/kernels/flash_attention/flash_attention.py:89")


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float,
                             window: int = GLOBAL,
                             causal: bool = True) -> torch.Tensor:
    """q (B,S,K,G,D), k (B,S,K,D), v (B,S,K,Dv) -> (B,S,K,G,Dv) in v's
    dtype: self-attention over positions ``arange(S)``."""
    for name, t, nd in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    code = DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"the kernel takes fp32, bf16 or fp16, got {q.dtype}")
    B, S, K, G, D = q.shape
    Dv = v.shape[-1]
    if tuple(k.shape) != (B, S, K, D) or tuple(v.shape[:3]) != (B, S, K):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")
    if min(B, S, K, G, D, Dv) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {D}, {Dv}: the kernel takes up to "
                         f"{MAX_HEAD_DIM}")
    if window != GLOBAL and window < 0:
        raise ValueError(f"window {window}: GLOBAL ({GLOBAL}) or >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got one on "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    out = torch.empty((B, S, K, G, Dv), dtype=v.dtype, device=q.device)
    FLASH.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, K * G, K, D, Dv, float(np.float32(scale)),
                 int(window), int(bool(causal)), code,
                 torch.cuda.current_stream(q.device).cuda_stream)
    return out
