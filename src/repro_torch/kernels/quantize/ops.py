"""Flat-array int8 compress and decompress: the JAX package's
``kernels/quantize/ops.py``.

``impl="auto"`` launches the CUDA kernel for a CUDA tensor and runs the
plain PyTorch version (``ref.py``) for a CPU tensor; ``impl="cuda"``
always launches (and raises for a CPU tensor); ``impl="torch"`` always
runs the plain version.  On a CUDA tensor the kernel either runs or
raises: nothing falls back to the plain version.

``block`` is the number of elements per scale: the JAX package's
``QBLOCK`` (256) by default; ``fl/compression.py`` passes the width of
its last-axis blocks.  The input is zero-padded to whole blocks; an
fp32 or bf16 input reaches the kernel as it is (the kernel upcasts), any
other float dtype is upcast to fp32 first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import use_kernel
from repro_torch.kernels.quantize.quantize import (FLOAT_CODES, QBLOCK,
                                                   dequantize_cuda,
                                                   quantize_cuda)
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref


def quantize(x: torch.Tensor, *, block: int = QBLOCK, impl: str = "auto"):
    """flat (N,) -> (q (nb, block) int8, scales (nb,) fp32)."""
    flat = x.reshape(-1)
    if flat.dtype not in FLOAT_CODES:
        flat = flat.float()
    n = flat.shape[0]
    nb = -(-n // block)
    if nb * block != n:
        flat = F.pad(flat, (0, nb * block - n))
    blocks = flat.reshape(nb, block)
    if use_kernel(impl, blocks):
        return quantize_cuda(blocks.contiguous())
    return quantize_ref(blocks)


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int, *,
               out_dtype: torch.dtype = torch.float32,
               impl: str = "auto") -> torch.Tensor:
    """(nb, block) int8 + (nb,) fp32 -> flat (n,) ``out_dtype``."""
    if use_kernel(impl, q):
        out = dequantize_cuda(q, scales, out_dtype)
    else:
        out = dequantize_ref(q, scales, out_dtype)
    return out.reshape(-1)[:n]
