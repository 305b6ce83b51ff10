"""Launch the int8 quantize and dequantize CUDA kernels
(``csrc/quantize.cu``), the port of ``quantize_pallas`` and
``dequantize_pallas``.

The source is built at first use and loaded with ``ctypes`` by
``kernels/build.py``; nothing here runs at import.  Each wrapper checks
device, dtype, shape and contiguity, raises on what its kernel does not
take, allocates its outputs, launches on PyTorch's current stream
without synchronising, and counts the launch.  A row of the kernels is
one quantization block of 1 to ``MAX_BLOCK`` elements.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaKernel, CudaLibrary

#: elements per scale of the flat quantizer (the TPU kernel's block)
QBLOCK = 256
#: the widest row the kernels take
MAX_BLOCK = 256
#: the dtypes a kernel reads (quantize) or writes (dequantize)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIB = CudaLibrary(
    Path(__file__).with_name("csrc") / "quantize.cu", "quantize", {
        "quantize_rows": [_p, _p, _p, _i64, _i32, _i32, _p],
        "dequantize_rows": [_p, _p, _p, _i64, _i32, _i32, _p],
    })
build = LIB.build

QUANTIZE = CudaKernel("quantize", LIB, "quantize_rows",
                      "src/repro/kernels/quantize/quantize.py:36")
DEQUANTIZE = CudaKernel("dequantize", LIB, "dequantize_rows",
                        "src/repro/kernels/quantize/quantize.py:57")
KERNELS = (QUANTIZE, DEQUANTIZE)


def _check(t: torch.Tensor, what: str, device: torch.device,
           ndim: int) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{what} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _rows(t: torch.Tensor, what: str):
    nb, b = t.shape
    if not 1 <= b <= MAX_BLOCK:
        raise ValueError(f"{what}: rows of {b} elements; the kernel takes "
                         f"1 to {MAX_BLOCK}")
    return nb, b


def _code(dtype: torch.dtype, what: str) -> int:
    code = FLOAT_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{what}: the kernel takes fp32 or bf16, got {dtype}")
    return code


def quantize_cuda(blocks: torch.Tensor):
    """(nb, b) fp32 or bf16 -> (q (nb, b) int8, scales (nb,) fp32)."""
    _check(blocks, "blocks", blocks.device, 2)
    nb, b = _rows(blocks, "blocks")
    code = _code(blocks.dtype, "blocks")
    q = torch.empty((nb, b), dtype=torch.int8, device=blocks.device)
    s = torch.empty((nb,), dtype=torch.float32, device=blocks.device)
    QUANTIZE.launch(blocks.data_ptr(), q.data_ptr(), s.data_ptr(), nb, b,
                    code, torch.cuda.current_stream(blocks.device).cuda_stream)
    return q, s


def dequantize_cuda(q: torch.Tensor, scales: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(nb, b) int8 + (nb,) fp32 -> (nb, b) ``out_dtype`` (fp32 or bf16)."""
    _check(q, "q", q.device, 2)
    _check(scales, "scales", q.device, 1)
    nb, b = _rows(q, "q")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scales fp32, got {q.dtype} "
                        f"and {scales.dtype}")
    if scales.shape[0] != nb:
        raise ValueError(f"{scales.shape[0]} scales for {nb} rows")
    code = _code(out_dtype, "out_dtype")
    out = torch.empty((nb, b), dtype=out_dtype, device=q.device)
    DEQUANTIZE.launch(q.data_ptr(), scales.data_ptr(), out.data_ptr(), nb, b,
                      code, torch.cuda.current_stream(q.device).cuda_stream)
    return out
