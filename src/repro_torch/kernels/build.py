"""Build, load and count the port's CUDA kernels.

Each kernel source (``csrc/*.cu``) is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``.  The library's name carries a hash of the
source and the flags, so an edited kernel is rebuilt and an unchanged
one is loaded as it is.  Nothing here runs at import: a host without
``nvcc`` or a card imports the kernel modules and uses their plain
versions.

Every C entry takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a
non-zero code and counts the launch.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

#: the checkout's root (src/repro_torch/kernels/ -> 3 up)
_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: torch dtype -> the dtype code every kernel source takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: a kernel op's ``impl``: "auto" launches the kernel for a CUDA tensor
#: and runs the plain version for a CPU tensor, "cuda" always launches
#: (and raises for a CPU tensor), "torch" always runs the plain version
IMPLS = ("auto", "cuda", "torch")


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """Whether an op given ``t`` launches its kernel.  On a CUDA tensor
    the kernel runs or raises: nothing falls back to the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    return impl == "cuda" or (impl == "auto" and t.device.type == "cuda")


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use")
    return path


class CudaLibrary:
    """One ``.cu`` source, built once and loaded once per process.

    ``signatures`` maps each C entry to its ``ctypes`` argument types;
    every entry returns ``int``.  ``extra_flags`` are this library's own
    ``nvcc`` flags after ``NVCC_FLAGS`` (e.g. ``-lcuda``), hashed into
    its name as they are."""

    def __init__(self, src: Path, name: str,
                 signatures: Dict[str, Sequence[Any]],
                 extra_flags: Sequence[str] = ()):
        self.src = src
        self.name = name
        self.signatures = signatures
        self.extra_flags = tuple(extra_flags)
        self._lib: Optional[Any] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the built library for the current source and flags lives."""
        h = hashlib.sha256(self.src.read_bytes())
        h.update(" ".join((*NVCC_FLAGS, *self.extra_flags)).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless this source is already built."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.src),
               *self.extra_flags]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)      # atomic: a concurrent build wins whole
        return out

    def load(self) -> Any:
        with self._lock:
            if self._lib is None:
                import ctypes

                lib = ctypes.CDLL(str(self.build()))
                for symbol, argtypes in self.signatures.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


class CudaKernel:
    """One C entry of a library plus its launch count."""

    def __init__(self, name: str, lib: CudaLibrary, symbol: str,
                 replaces: str):
        self.name = name
        self.lib = lib
        self.symbol = symbol
        self.replaces = replaces      # the TPU kernel, file:line
        self.launches = 0
        self._fn: Optional[Any] = None

    def launch(self, *args) -> None:
        if self._fn is None:          # looked up once: launches are hot
            self._fn = getattr(self.lib.load(), self.symbol)
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1
