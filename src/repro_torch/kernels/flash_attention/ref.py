"""Plain PyTorch version of the flash-attention forward: the CPU path of
``ops.py`` and the oracle the CUDA kernel is held against.

The JAX package's ``attention_ref`` (``kernels/flash_attention/ref.py``)
line for line: fp32 scores on upcast inputs, the KV heads repeated for
their query groups, ``-1e30`` as the masked value, a softmax, and the
output cast to ``v``'s dtype.
"""
from __future__ import annotations

import torch

GLOBAL = -1
_NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,   # (B, H, S, D)
    k: torch.Tensor,   # (B, K, S, D)
    v: torch.Tensor,   # (B, K, S, Dv)
    *,
    scale: float,
    window: int = GLOBAL,
    causal: bool = True,
) -> torch.Tensor:
    B, H, S, D = q.shape
    K = k.shape[1]
    g = H // K
    kr = torch.repeat_interleave(k, g, dim=1)
    vr = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window != GLOBAL:
        mask &= (rows - cols) < window
    s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(v.dtype)
