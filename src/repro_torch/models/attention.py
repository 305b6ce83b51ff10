"""Attention: GQA with RoPE and sliding windows, three interchangeable
impls.

* ``naive``   — full (S, S) score matrix; the oracle for tests.
* ``chunked`` / ``chunked_sp`` — the flash-style custom backward of
  ``models/flash.py`` (blockwise forward, probabilities recomputed in
  the backward): the training path.  ``chunked_sp`` is the
  context-parallel form, which on a model axis of size 1 is the same
  function; a larger axis is refused (ROADMAP A.8).
* ``pallas``  — the flash-attention forward kernel
  (``kernels/flash_attention``): the CUDA kernel on the card, its plain
  version on the CPU.  The name is the JAX package's option name.

Cross-attention is not ported yet and is refused by name.

Decode uses a ring-buffer KV cache (slot ``pos % capacity`` is
overwritten) and one einsum over the cache.  Unlike the JAX package,
whose arrays are immutable, ``attention_decode`` writes the new K/V
into the cache tensors in place and returns them: the counterpart of
a donated buffer, and it saves copying the cache every step.

Window convention: ``window == GLOBAL (-1)`` is full causal attention;
otherwise query i attends keys j with ``i - window < j <= i``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import GLOBAL, ArchConfig
from repro_torch.models.flash import (flash_self_attention,
                                      flash_self_attention_sp)
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm_headwise

_NEG_INF = -1e30


def _refuse_cross() -> None:
    raise NotImplementedError("cross-attention (enc-dec) is not ported yet "
                              "(ROADMAP A.6)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                   cross: bool = False) -> dict:
    if cross:
        _refuse_cross()
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype),
        "wk": dense_init(gen, (d, kvh * hd), dtype),
        "wv": dense_init(gen, (d, kvh * hd), dtype),
        "wo": dense_init(gen, (h * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(cfg: ArchConfig, params, xq, xkv, positions_q, positions_kv,
                 rope: bool):
    """-> q (B,Sq,K,G,D), k (B,Skv,K,D), v (B,Skv,K,D)."""
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    q = (xq @ params["wq"]).reshape(B, Sq, h, hd)
    k = (xkv @ params["wk"]).reshape(B, Skv, kvh, hd)
    v = (xkv @ params["wv"]).reshape(B, Skv, kvh, hd)
    if "q_norm" in params:
        q = rmsnorm_headwise(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_headwise(params["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions_q, cfg.rope_theta)
        k = apply_rope(k, positions_kv, cfg.rope_theta)
    q = q.reshape(B, Sq, kvh, g, hd)
    return q, k, v


def _band_mask(qpos, kpos, window: int, causal: bool):
    """(…, Sq, Skv) bool mask: True = attend."""
    diff = qpos[..., :, None] - kpos[..., None, :]
    m = (diff >= 0) if causal else torch.ones_like(diff, dtype=torch.bool)
    if window != GLOBAL:
        m = m & (diff < window)
    return m


# ---------------------------------------------------------------------------
# naive impl (oracle)
# ---------------------------------------------------------------------------


def _attend_naive(q, k, v, qpos, kpos, window, causal, scale):
    # q: (B,Sq,K,G,D)  k,v: (B,Skv,K,D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    mask = _band_mask(qpos, kpos, window, causal)  # (Sq,Skv)
    scores = torch.where(mask[None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# public: training / prefill attention
# ---------------------------------------------------------------------------


def attention(
    cfg: ArchConfig,
    params: dict,
    x: torch.Tensor,                      # (B, S, D)
    positions: torch.Tensor,              # (S,)
    *,
    window: int = GLOBAL,
    causal: bool = True,
    memory=None,
    impl: str = "chunked",
    block_kv: int = 512,
    model_axis: str = "model",
    mesh=None,
) -> torch.Tensor:
    """Self-attention of the block; ``memory`` (cross-attention) is
    refused."""
    if memory is not None:
        _refuse_cross()
    if impl not in ("naive", "chunked", "chunked_sp", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    q, k, v = _project_qkv(cfg, params, x, x, positions, positions, rope=True)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if impl == "naive":
        out = _attend_naive(q, k, v, positions, positions, window, causal,
                            scale)
    elif impl == "chunked":
        out = flash_self_attention(q, k, v, window, causal, scale,
                                   min(block_kv, k.shape[1]))
    elif impl == "chunked_sp":
        out = flash_self_attention_sp(q, k, v, window, causal, scale,
                                      min(block_kv, k.shape[1]),
                                      model_axis=model_axis, mesh=mesh)
    else:
        from repro_torch.kernels.flash_attention import ops as fa_ops

        out = fa_ops.flash_attention(
            q, k, v, positions, positions, window=window, causal=causal,
            scale=scale)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# decode with ring-buffer KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, capacity: int, window: int,
                  dtype: torch.dtype, device) -> dict:
    """Ring cache; local layers only keep ``window`` slots."""
    cap = capacity if window == GLOBAL else min(window, capacity)
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attention_decode(
    cfg: ArchConfig,
    params: dict,
    x: torch.Tensor,       # (B, 1, D) current token hidden
    cache: dict,           # ring cache, written in place
    pos: int,              # absolute position of the current token
    *,
    window: int = GLOBAL,
):
    B = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    cap = cache["k"].shape[1]
    pos = int(pos)

    q = (x @ params["wq"]).reshape(B, 1, h, hd)
    k_new = (x @ params["wk"]).reshape(B, 1, kvh, hd)
    v_new = (x @ params["wv"]).reshape(B, 1, kvh, hd)
    if "q_norm" in params:
        q = rmsnorm_headwise(params["q_norm"], q, cfg.norm_eps)
        k_new = rmsnorm_headwise(params["k_norm"], k_new, cfg.norm_eps)
    # a fill on the device: a host tensor copied over would wait on the stream
    posv = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)

    # slot s holds absolute position p with p ≡ s (mod cap) and p in
    # (pos - cap, pos]; the current token goes into slot pos % cap first
    slot = pos % cap
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
    slots = torch.arange(cap, device=x.device)
    abs_pos = pos - torch.remainder(slot - slots, cap)

    qg = q.reshape(B, kvh, g, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_cache.float()) / math.sqrt(hd)
    visible = abs_pos >= 0
    if window != GLOBAL:
        visible = visible & (pos - abs_pos < window)
    scores = torch.where(visible[None, None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    out = out.reshape(B, 1, h * hd).to(x.dtype)
    return out @ params["wo"], {"k": k_cache, "v": v_cache}
