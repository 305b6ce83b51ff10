"""Launch the fedavg CUDA kernels (``csrc/fedavg.cu``).

The source is built at first use and loaded with ``ctypes`` by
``kernels/build.py``.  Nothing here runs at import: a host without
``nvcc`` or a card imports the module and uses the plain versions in
``ref.py``.

Each launch wrapper checks device, dtype, shape and contiguity, raises
on what the kernel does not take, launches on PyTorch's current stream
without synchronising, and counts its launches in ``launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES, CudaKernel, CudaLibrary

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIB = CudaLibrary(
    Path(__file__).with_name("csrc") / "fedavg.cu", "fedavg", {
        "fedavg_eager_accumulate": [_p, _p, _i64, _i32, ctypes.c_float, _p],
        "fedavg_eager_accumulate_previous": [_p, _p, _i64, _i32,
                                             ctypes.c_float, _p],
        "fedavg_accumulate_k": [_p, _p, _p, _i64, _i64, _i32, _p],
        "fedavg_reduce": [_p, _p, _p, _i64, _i64, _i32, _p],
    })
build = LIB.build

EAGER = CudaKernel("eager_accumulate", LIB, "fedavg_eager_accumulate",
                   "src/repro/kernels/fedavg/fedavg.py:112")
ACCUMULATE_K = CudaKernel("fedavg_accumulate_k", LIB, "fedavg_accumulate_k",
                          "src/repro/kernels/fedavg/fedavg.py:82")
REDUCE = CudaKernel("fedavg_reduce", LIB, "fedavg_reduce",
                    "src/repro/kernels/fedavg/fedavg.py:40")
KERNELS = (EAGER, ACCUMULATE_K, REDUCE)
#: the eager fold's first design, on no path: timed beside EAGER
EAGER_PREVIOUS = CudaKernel(
    "eager_accumulate_previous", LIB, "fedavg_eager_accumulate_previous",
    EAGER.replaces)


def _check(t: torch.Tensor, what: str, device: torch.device,
           ndim: int) -> None:
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _wire_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: the kernel takes fp32, bf16 or fp16, "
                        f"got {t.dtype}")
    return code


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def eager_accumulate_cuda(acc: torch.Tensor, update: torch.Tensor,
                          weight: float, *,
                          kernel: CudaKernel = EAGER) -> torch.Tensor:
    """acc += w·u in place (fp32 acc, any wire dtype); returns ``acc``.
    Either may be a contiguous view at any offset.  ``kernel`` is EAGER,
    or EAGER_PREVIOUS to time the first design."""
    _check(acc, "acc", acc.device, 1)
    _check(update, "update", acc.device, 1)
    if acc.dtype != torch.float32:
        raise TypeError(f"acc must be fp32, got {acc.dtype}")
    if update.shape != acc.shape:
        raise ValueError(f"update {tuple(update.shape)} != acc "
                         f"{tuple(acc.shape)}")
    code = _wire_code(update, "update")
    kernel.launch(acc.data_ptr(), update.data_ptr(), acc.numel(), code,
                  float(np.float32(weight)), _stream(acc.device))
    return acc


def fedavg_accumulate_k_cuda(acc: torch.Tensor, updates: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """acc += Σ_k w[k]·U[k] in place (raw fp32 weights on the device)."""
    _check(acc, "acc", acc.device, 1)
    _check(updates, "updates", acc.device, 2)
    _check(weights, "weights", acc.device, 1)
    if acc.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("acc and weights must be fp32")
    k, n = updates.shape
    if n != acc.numel() or weights.numel() != k or k == 0:
        raise ValueError(f"updates {tuple(updates.shape)}, weights "
                         f"{tuple(weights.shape)}, acc {tuple(acc.shape)}")
    code = _wire_code(updates, "updates")
    ACCUMULATE_K.launch(acc.data_ptr(), updates.data_ptr(),
                        weights.data_ptr(), k, n, code, _stream(acc.device))
    return acc


def fedavg_reduce_cuda(updates: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Σ_k wn[k]·U[k] into a fresh fp32 (N,) (weights pre-normalized)."""
    _check(updates, "updates", updates.device, 2)
    _check(weights, "weights", updates.device, 1)
    if weights.dtype != torch.float32:
        raise TypeError("weights must be fp32")
    k, n = updates.shape
    if weights.numel() != k or k == 0 or n == 0:
        raise ValueError(f"updates {tuple(updates.shape)}, weights "
                         f"{tuple(weights.shape)}")
    code = _wire_code(updates, "updates")
    out = torch.empty((n,), dtype=torch.float32, device=updates.device)
    REDUCE.launch(out.data_ptr(), updates.data_ptr(), weights.data_ptr(),
                  k, n, code, _stream(updates.device))
    return out
