"""Plain PyTorch version of the int8 block quantizer: the CPU path of
``ops.py`` and the oracle the CUDA kernels are held against.

The JAX package's ``kernels/quantize/ref.py`` line for line: the input
upcast to fp32, ``scale = where(amax > 0, amax / 127, 1)`` per row,
``torch.round`` (half to even, as ``jnp.round``), a clip to
[-127, 127], and dequantize as ``f32(q) · scale`` cast to the output
dtype.  ``amax / 127`` is taken as XLA compiles it under ``jit``: the
product with the fp32 reciprocal of 127, rounded once (XLA rewrites a
division by a constant so; an IEEE division differs by one ulp in some
rows, and so does every dequantized value of those rows).
"""
from __future__ import annotations

import torch


def quantize_ref(blocks: torch.Tensor):
    """(nb, b) float -> (q (nb, b) int8, scales (nb,) fp32)."""
    x = blocks.float()
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * amax.new_tensor(1.0 / 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scales[:, None]).to(out_dtype)
