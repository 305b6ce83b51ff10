"""Core layers of the LM stack on torch tensors: norms, RoPE, SwiGLU,
embeddings, init helpers.

The JAX package's ``models/layers.py`` function for function: params
are nested dicts of tensors, matrices are ``(in, out)`` so ``x @ W``
reads as there, and every norm and rotation is taken in fp32 and cast
back to the input's dtype.  Inits draw from a ``torch.Generator`` on the
target device; they cannot give ``jax.random``'s numbers, so parity
tests carry JAX params across with ``convert.lm_params_from_jax``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in fp32 and cast."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not w.is_meta:           # a meta tensor (abstract params) holds none
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_headwise(scale: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the trailing dim in fp32 (also QK-norm over head_dim)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_headwise(params["scale"], x, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated by halves; positions broadcast to (..., S)."""
    head_dim = x.shape[-1]
    if head_dim % 2:  # odd head dims skip the tail lane
        body = apply_rope(x[..., :-1], positions, theta)
        return torch.cat([body, x[..., -1:]], dim=-1)
    freqs = rope_frequencies(head_dim, theta, x.device)         # (D/2,)
    angles = positions[..., None].float() * freqs               # (..., S, D/2)
    sin = torch.sin(angles)[..., None, :]                       # (..., S, 1, D/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    return {
        "gate": dense_init(gen, (d_model, d_ff), dtype),
        "up": dense_init(gen, (d_model, d_ff), dtype),
        "down": dense_init(gen, (d_ff, d_model), dtype),
    }


def ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype) -> torch.Tensor:
    # σ = 1/√d pairs with the √d embedding multiplier
    return dense_init(gen, (vocab, d_model), dtype, scale=d_model ** -0.5)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table_or_head: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """Project hidden states to vocab logits (fp32)."""
    w = table_or_head.float()
    xf = x.float()
    return xf @ w.t() if tied else xf @ w


# ---------------------------------------------------------------------------
# Chunked (sequence-blocked) cross-entropy
# ---------------------------------------------------------------------------


def _chunk_loss(unembed_w, h_c, y_c, tied: bool):
    logits = unembed(unembed_w, h_c, tied)              # (B, c, V) fp32
    logz = torch.logsumexp(logits, dim=-1)
    tok = logits.gather(-1, y_c.clamp_min(0).long()[..., None])[..., 0]
    valid = (y_c >= 0).float()
    return ((logz - tok) * valid).sum(), valid.sum()


def chunked_lm_loss(hidden: torch.Tensor, unembed_w: torch.Tensor,
                    labels: torch.Tensor, tied: bool,
                    chunk: int = 256, chunk_loss=_chunk_loss) -> torch.Tensor:
    """Cross-entropy without materialising the full (B, S, V) logits:
    a loop over sequence chunks, each under ``torch.utils.checkpoint``
    (the JAX package's ``jax.checkpoint``), so the backward keeps one
    chunk's logits at a time.  Labels of -1 are ignored.  ``chunk_loss(w,
    h, y, tied) -> (the chunk's CE sum, its valid count)``: the vocab-
    sharded loss passes its own."""
    from torch.utils.checkpoint import checkpoint

    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    n = S // chunk
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if S > n * chunk:
        bounds.append((n * chunk, S))
    for lo, hi in bounds:
        l, c = checkpoint(chunk_loss, unembed_w, hidden[:, lo:hi],
                          labels[:, lo:hi], tied, use_reentrant=False)
        total, count = total + l, count + c
    return total / torch.clamp_min(count, 1.0)
