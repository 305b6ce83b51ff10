"""Launch the flash-attention forward CUDA kernels, the ports of
``flash_attention_fwd_pallas``: ``csrc/flash_attention_sm90.cu`` (wgmma
on the tensor cores, TMA-fed K/V ring) for bf16 and fp16,
``csrc/flash_attention_tf32x3.cu`` (mma.sync on the tensor cores in
3xTF32, cp.async-fed K/V ring) for fp32, and ``csrc/flash_attention.cu``
(fp32 FMA on the CUDA cores) for what neither takes: head dims that are
not multiples of 8, or a pointer off 16 bytes.

``flash_variant`` makes the choice from dtype, head dims and alignment
before launch; it is not a fallback: on a CUDA tensor the chosen kernel
runs or the wrapper raises.  The sources are built at first use and
loaded with ``ctypes`` by ``kernels/build.py``; nothing here runs at
import.  The wrapper checks device, dtype, shapes and contiguity,
raises on what the kernels do not take, allocates the output, launches
on PyTorch's current stream without synchronising, and counts the
launch in ``FLASH_WGMMA.launches``, ``FLASH_TF32X3.launches`` or
``FLASH_SIMT.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES, CudaKernel, CudaLibrary
from repro_torch.kernels.flash_attention.ref import GLOBAL

#: the largest head dim the kernels take (q/k and v alike)
MAX_HEAD_DIM = 256
VARIANTS = ("wgmma", "tf32x3", "simt")

_p, _i32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32, ctypes.c_float,
         _i32, _i32, _i32, _p]
_CSRC = Path(__file__).with_name("csrc")
LIB = CudaLibrary(_CSRC / "flash_attention.cu", "flash_attention",
                  {"flash_attention_fwd": _ARGS})
# the tensor maps are encoded with libcuda's cuTensorMapEncodeTiled
LIB_SM90 = CudaLibrary(_CSRC / "flash_attention_sm90.cu",
                       "flash_attention_sm90",
                       {"flash_attention_fwd_sm90": _ARGS},
                       extra_flags=("-lcuda",))
LIB_TF32X3 = CudaLibrary(_CSRC / "flash_attention_tf32x3.cu",
                         "flash_attention_tf32x3",
                         {"flash_attention_fwd_tf32x3": _ARGS})
LIBS = (LIB_SM90, LIB_TF32X3, LIB)

_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:89"
FLASH_WGMMA = CudaKernel("flash_attention_fwd_wgmma", LIB_SM90,
                         "flash_attention_fwd_sm90", _REPLACES)
FLASH_TF32X3 = CudaKernel("flash_attention_fwd_tf32x3", LIB_TF32X3,
                          "flash_attention_fwd_tf32x3", _REPLACES)
FLASH_SIMT = CudaKernel("flash_attention_fwd_simt", LIB,
                        "flash_attention_fwd", _REPLACES)
KERNELS = (FLASH_WGMMA, FLASH_TF32X3, FLASH_SIMT)
#: the kernel that launches for each of ``VARIANTS``
BY_VARIANT = dict(zip(VARIANTS, KERNELS))


def flash_variant(dtype: torch.dtype, d: int, dv: int,
                  aligned: bool = True) -> str:
    """The kernel that takes q/k head dim ``d`` and v head dim ``dv`` in
    ``dtype``.  With both dims multiples of 8 and every pointer 16-byte
    ``aligned`` (the rules of TMA and of 16-byte ``cp.async`` copies):
    "wgmma" for bf16 and fp16, "tf32x3" for fp32.  Anything else goes
    to the CUDA-core kernel, "simt"."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the kernels take fp32, bf16 or fp16, got {dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}, {dv}: the kernels take up to "
                         f"{MAX_HEAD_DIM}")
    if d % 8 or dv % 8 or not aligned:
        return "simt"
    return "tf32x3" if dtype == torch.float32 else "wgmma"


def check_one_length(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> None:
    """Raise unless q (B,Sq,...) and k, v (B,Skv,...) share one length:
    the kernels (and the TPU kernel they replace) compute self-attention
    over positions ``arange(S)``.  A cross-attention memory of another
    length than the queries takes ``attn_impl`` "naive" or "chunked";
    the JAX package's kernel would read only its first Sq rows."""
    if k.shape[1] != q.shape[1] or v.shape[1] != q.shape[1]:
        raise ValueError(
            f"q, k and v lengths do not match: flash attention computes "
            f"self-attention over one length, and q has {q.shape[1]} rows, "
            f"k {k.shape[1]} and v {v.shape[1]}; cross-attention over a "
            f'memory of another length takes attn_impl "naive" or "chunked"')


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float,
                             window: int = GLOBAL, causal: bool = True,
                             variant: Optional[str] = None) -> torch.Tensor:
    """q (B,S,K,G,D), k (B,S,K,D), v (B,S,K,Dv) -> (B,S,K,G,Dv) in v's
    dtype: self-attention over positions ``arange(S)``.  ``variant``
    names the kernel (``flash_variant``'s choice by default); "simt"
    takes every input, "wgmma" and "tf32x3" only what ``flash_variant``
    gives them."""
    for name, t, nd in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_one_length(q, k, v)
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    chosen = flash_variant(q.dtype, D, Dv, aligned)
    variant = variant or chosen
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    if variant != "simt" and variant != chosen:
        raise ValueError(f"the {variant} kernel does not take {q.dtype} at "
                         f"D={D}, Dv={Dv}, aligned={aligned}")
    if window != GLOBAL and window < 0:
        raise ValueError(f"window {window}: GLOBAL ({GLOBAL}) or >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got one on "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    kernel = BY_VARIANT[variant]
    out = torch.empty((B, S, K, G, Dv), dtype=v.dtype, device=q.device)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, S, K * G, K, D, Dv, float(np.float32(scale)),
                  int(window), int(bool(causal)), code,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
