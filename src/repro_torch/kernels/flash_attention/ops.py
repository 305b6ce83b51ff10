"""The flash-attention forward through the model's attention interface:
the (B, S, K, G, D) layout of ``models/attention.py``.

``impl="auto"`` launches a CUDA kernel for a CUDA tensor (the wgmma one
for bf16 and fp16 that TMA takes, the mma.sync one for every other bf16
and fp16 input, the 3xTF32 one for fp32: ``flash_variant``) and runs the
plain PyTorch version (``ref.py``) for a CPU tensor; ``impl="cuda"``
always launches (and raises for a CPU tensor); ``impl="torch"`` always
runs the plain version.  On a CUDA tensor the kernel either runs or
raises: nothing falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import use_kernel
from repro_torch.kernels.flash_attention.flash_attention import (
    check_one_length, flash_attention_fwd_cuda)
from repro_torch.kernels.flash_attention.ref import GLOBAL, attention_ref


def flash_attention(
    q: torch.Tensor,      # (B, S, K, G, D)
    k: torch.Tensor,      # (B, S, K, D)
    v: torch.Tensor,      # (B, S, K, Dv)
    qpos=None,
    kpos=None,
    *,
    window: int = GLOBAL,
    causal: bool = True,
    scale: float = 1.0,
    impl: str = "auto",
) -> torch.Tensor:
    """-> (B, S, K, G, Dv).  qpos/kpos are accepted for interface parity
    with the JAX package; the kernel assumes self-attention (arange), and
    k and v of another length than q are refused on either path."""
    check_one_length(q, k, v)
    if use_kernel(impl, q):
        return flash_attention_fwd_cuda(q, k, v, scale=scale, window=window,
                                        causal=causal)
    B, S, K, G, D = q.shape
    Dv = v.shape[-1]
    qh = q.reshape(B, S, K * G, D).transpose(1, 2)      # (B,H,S,D)
    kh = k.transpose(1, 2)                               # (B,K,S,D)
    vh = v.transpose(1, 2)
    out = attention_ref(qh, kh, vh, scale=scale, window=window, causal=causal)
    return out.transpose(1, 2).reshape(B, S, K, G, Dv)
