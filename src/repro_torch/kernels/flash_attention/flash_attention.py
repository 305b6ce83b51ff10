"""Launch the flash-attention forward CUDA kernels, the ports of
``flash_attention_fwd_pallas``, all on the tensor cores:
``csrc/flash_attention_sm90.cu`` (wgmma, TMA-fed K/V ring) for bf16 and
fp16 with head dims that are multiples of 8 on 16-byte-aligned pointers,
``csrc/flash_attention_mma.cu`` (mma.sync, loads staged through
registers and realigned there) for every other bf16 and fp16 input, and
``csrc/flash_attention_tf32x3.cu`` (mma.sync in 3xTF32, cp.async-fed
K/V ring of 16- or 4-byte copies) for every fp32 input.  The first
design, ``csrc/flash_attention.cu`` (fp32 FMA on the CUDA cores), is on
no route: it runs only when named, ``variant="simt"``.

``flash_variant`` makes the choice from dtype, head dims and alignment
before launch; it is not a fallback: on a CUDA tensor the chosen kernel
runs or the wrapper raises.  The sources are built at first use and
loaded with ``ctypes`` by ``kernels/build.py``; nothing here runs at
import.  The wrapper checks device, dtype, shapes and contiguity,
raises on what the kernels do not take, allocates the output, launches
on PyTorch's current stream without synchronising, and counts the
launch in the kernel's ``launches`` (``FLASH_WGMMA``, ``FLASH_MMA``,
``FLASH_TF32X3``, ``FLASH_SIMT``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES, CudaKernel, CudaLibrary
from repro_torch.kernels.flash_attention.ref import GLOBAL

#: the largest head dim the kernels take (q/k and v alike)
MAX_HEAD_DIM = 256
VARIANTS = ("wgmma", "tf32x3", "mma", "simt")

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
# + the load width (``load_width``) before the stream
LIB_MMA = CudaLibrary(_CSRC / "flash_attention_mma.cu", "flash_attention_mma",
                      {"flash_attention_fwd_mma": [*_ARGS[:-1], _i32, _p]})
LIBS = (LIB_SM90, LIB_TF32X3, LIB_MMA, LIB)

_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:89"
FLASH_WGMMA = CudaKernel("flash_attention_fwd_wgmma", LIB_SM90,
                         "flash_attention_fwd_sm90", _REPLACES)
FLASH_TF32X3 = CudaKernel("flash_attention_fwd_tf32x3", LIB_TF32X3,
                          "flash_attention_fwd_tf32x3", _REPLACES)
FLASH_MMA = CudaKernel("flash_attention_fwd_mma", LIB_MMA,
                       "flash_attention_fwd_mma", _REPLACES)
FLASH_SIMT = CudaKernel("flash_attention_fwd_simt", LIB,
                        "flash_attention_fwd", _REPLACES)
KERNELS = (FLASH_WGMMA, FLASH_TF32X3, FLASH_MMA, FLASH_SIMT)
#: the kernel that launches for each of ``VARIANTS``
BY_VARIANT = dict(zip(VARIANTS, KERNELS))


def flash_variant(dtype: torch.dtype, d: int, dv: int,
                  aligned: bool = True) -> str:
    """The kernel that takes q/k head dim ``d`` and v head dim ``dv`` in
    ``dtype``: "tf32x3" for every fp32 input; for bf16 and fp16 "wgmma"
    with both dims multiples of 8 and every pointer 16-byte ``aligned``
    (TMA's rules), "mma" for the rest.  The CUDA-core kernel, "simt",
    is on no route."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the kernels take fp32, bf16 or fp16, got {dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}, {dv}: the kernels take up to "
                         f"{MAX_HEAD_DIM}")
    if dtype == torch.float32:
        return "tf32x3"
    if d % 8 or dv % 8 or not aligned:
        return "mma"
    return "wgmma"


def load_width(addresses: Sequence[int], esz: int, h: int, kh: int, d: int,
               dv: int) -> int:
    """The widest load, in bytes, that the "mma" kernel can make of every
    row of q, k and v (``addresses``: their data pointers; ``esz``
    bytes an element; ``h`` query and ``kh`` KV heads).  16 where every
    row stride (h·d, kh·d and kh·dv elements) is a multiple of 16 bytes:
    the rows one block reads then start at one offset mod 16, and the
    kernel reads the aligned 16-byte words over a row and shifts them
    into place.  Else the widest of 8, 4 and 2 that divides every
    pointer and the bytes of both head dims, so that every row start is
    aligned to it."""
    if all(n * esz % 16 == 0 for n in (h * d, kh * d, kh * dv)):
        return 16
    for w in (8, 4):
        if all(a % w == 0 for a in addresses) and (d * esz) % w == 0 \
                and (dv * esz) % w == 0:
            return w
    return 2


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
    takes every input, "mma" every bf16 and fp16 input, "tf32x3" every
    fp32 input, "wgmma" only what ``flash_variant`` gives it."""
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
    takes = (variant in (chosen, "simt")
             or (variant == "mma" and q.dtype != torch.float32))
    if not takes:
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    width = ((load_width(ptrs, q.element_size(), K * G, K, D, Dv),)
             if variant == "mma" else ())
    kernel.launch(*ptrs, out.data_ptr(), B, S, K * G, K, D, Dv,
                  float(np.float32(scale)), int(window), int(bool(causal)),
                  code, *width,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
