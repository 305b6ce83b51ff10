"""Build, load and launch the fedavg CUDA kernels (``csrc/fedavg.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.  The
library's name carries a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.  Nothing
here runs at import: a host without ``nvcc`` or a card imports the
module and uses the plain versions in ``ref.py``.

Each launch wrapper checks device, dtype, shape and contiguity, raises
on what the kernel does not take, launches on PyTorch's current stream
without synchronising, and counts its launches in ``launches``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_SRC = Path(__file__).with_name("csrc") / "fedavg.cu"
#: the checkout's root (src/repro_torch/kernels/fedavg/ -> 4 up)
_ROOT = Path(__file__).resolve().parents[4]
BUILD_DIR = _ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: wire dtype -> the kernel's dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib: Optional[Any] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the fedavg CUDA kernels are "
                           "built from source at first use")
    return path


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfedavg-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/fedavg.cu`` unless this source is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent build wins whole
    return out


def _load() -> Any:
    global _lib
    with _lib_lock:
        if _lib is None:
            import ctypes

            lib = ctypes.CDLL(str(build()))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.fedavg_eager_accumulate.argtypes = [p, p, i64, i32,
                                                    ctypes.c_float, p]
            lib.fedavg_accumulate_k.argtypes = [p, p, p, i64, i64, i32, p]
            lib.fedavg_reduce.argtypes = [p, p, p, i64, i64, i32, p]
            for fn in (lib.fedavg_eager_accumulate, lib.fedavg_accumulate_k,
                       lib.fedavg_reduce):
                fn.restype = i32
            _lib = lib
        return _lib


class CudaKernel:
    """One C entry of the library plus its launch count."""

    def __init__(self, name: str, symbol: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces      # the TPU kernel, file:line
        self.launches = 0

    def launch(self, *args) -> None:
        rc = getattr(_load(), self.symbol)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1


EAGER = CudaKernel("eager_accumulate", "fedavg_eager_accumulate",
                   "src/repro/kernels/fedavg/fedavg.py:112")
ACCUMULATE_K = CudaKernel("fedavg_accumulate_k", "fedavg_accumulate_k",
                          "src/repro/kernels/fedavg/fedavg.py:82")
REDUCE = CudaKernel("fedavg_reduce", "fedavg_reduce",
                    "src/repro/kernels/fedavg/fedavg.py:40")
KERNELS = (EAGER, ACCUMULATE_K, REDUCE)


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
                          weight: float) -> torch.Tensor:
    """acc += w·u in place (fp32 acc, any wire dtype); returns ``acc``."""
    _check(acc, "acc", acc.device, 1)
    _check(update, "update", acc.device, 1)
    if acc.dtype != torch.float32:
        raise TypeError(f"acc must be fp32, got {acc.dtype}")
    if update.shape != acc.shape:
        raise ValueError(f"update {tuple(update.shape)} != acc "
                         f"{tuple(acc.shape)}")
    code = _wire_code(update, "update")
    EAGER.launch(acc.data_ptr(), update.data_ptr(), acc.numel(), code,
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
