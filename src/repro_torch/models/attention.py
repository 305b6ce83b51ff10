"""Attention: GQA with RoPE and sliding windows, three interchangeable
impls.

* ``naive``   — full (S, S) score matrix; the oracle for tests.
* ``chunked`` / ``chunked_sp`` — the flash-style custom backward of
  ``models/flash.py`` (blockwise forward, probabilities recomputed in
  the backward): the training path.  ``chunked_sp`` is the
  context-parallel form over the mesh's model axis
  (``flash_self_attention_sp``), which on an axis of size 1 is the
  same function.
* ``pallas``  — the flash-attention forward kernel
  (``kernels/flash_attention``): the CUDA kernel on the card, its plain
  version on the CPU.  The name is the JAX package's option name.

Cross-attention (``memory=``, an encoder–decoder's decoder layers)
projects K/V from the memory without RoPE, attends without a causal
mask over keys at ``arange(Sm)``, and takes ``_attend_chunked`` (the
plain blockwise scan) under ``chunked``; under ``pallas`` a memory of
another length than the queries is refused, since the kernel computes
self-attention over one length (the JAX package's kernel silently
reads only the first ``Sq`` memory rows).  At decode the cross K/V are
a static cache from the prefill (``init_cross_cache``), never written.

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
import torch.nn.functional as F

from repro_torch.configs.base import GLOBAL, ArchConfig
from repro_torch.models.flash import (flash_self_attention,
                                      flash_self_attention_sp)
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm_headwise

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                   cross: bool = False) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype),
        "wk": dense_init(gen, (d, kvh * hd), dtype),
        "wv": dense_init(gen, (d, kvh * hd), dtype),
        "wo": dense_init(gen, (h * hd, d), dtype),
    }
    if cfg.qk_norm and not cross:
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
# chunked impl for cross-attention (online softmax over KV blocks)
# ---------------------------------------------------------------------------


def _attend_chunked(q, k, v, qpos, kpos, window, causal, scale,
                    block_kv: int):
    """Online softmax over KV blocks of ``block_kv`` keys, the JAX
    package's ``lax.scan`` a Python loop.  As there, the padded keys of
    a ragged last block take position -1e9 and only a window masks
    them: a non-causal call attends over them (zero keys and values)."""
    B, Sq, K, G, D = q.shape
    Skv = k.shape[1]
    bk = min(block_kv, Skv)
    nkv = -(-Skv // bk)
    pad = nkv * bk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-(10 ** 9))
    qf = q.float()
    acc = torch.zeros((B, K, G, Sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, K, G, Sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    for j in range(nkv):
        blk = slice(j * bk, (j + 1) * bk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, k[:, blk].float()) * scale
        mask = _band_mask(qpos, kpos[blk], window, causal)   # (Sq, bk)
        s = torch.where(mask[None, None, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p, v[:, blk].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # (B,K,G,Sq,Dv) -> (B,Sq,K,G,Dv)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


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
    memory=None,                          # cross-attention memory (B, Sm, D)
    impl: str = "chunked",
    block_kv: int = 512,
    model_axis: str = "model",
    mesh=None,
    return_kv: bool = False,
):
    """The block's self-attention, or with ``memory`` its
    cross-attention over the memory (no RoPE, no causal mask).
    ``return_kv``: -> (out, (k, v)), the keys (roped in self-attention)
    and the values it attended over: the prefill's decode cache, which
    for cross-attention is ``init_cross_cache``'s."""
    if impl not in ("naive", "chunked", "chunked_sp", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    cross = memory is not None
    xkv = memory if cross else x
    kpos = torch.arange(xkv.shape[1], device=x.device) if cross \
        else positions
    q, k, v = _project_qkv(cfg, params, x, xkv, positions, kpos,
                           rope=not cross)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    causal = causal and not cross
    if impl == "naive":
        out = _attend_naive(q, k, v, positions, kpos, window, causal, scale)
    elif cross and impl in ("chunked", "chunked_sp"):
        out = _attend_chunked(q, k, v, positions, kpos, window, causal,
                              scale, block_kv)
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
            q, k, v, positions, kpos, window=window, causal=causal,
            scale=scale)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return (out, (k, v)) if return_kv else out


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


# ---------------------------------------------------------------------------
# cross-attention decode (enc-dec): static memory K/V, never written
# ---------------------------------------------------------------------------


def init_cross_cache(cfg: ArchConfig, params: dict,
                     memory: torch.Tensor) -> dict:
    """The memory's K/V (B, Sm, K, D), projected once, without RoPE."""
    B, Sm, _ = memory.shape
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": (memory @ params["wk"]).reshape(B, Sm, kvh, hd),
        "v": (memory @ params["wv"]).reshape(B, Sm, kvh, hd),
    }


def cross_attention_decode(cfg: ArchConfig, params: dict, x: torch.Tensor,
                           cross_cache: dict) -> torch.Tensor:
    """One token's cross-attention over the whole static memory cache."""
    B = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    q = (x @ params["wq"]).reshape(B, kvh, g, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(),
                          cross_cache["k"].float()) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cross_cache["v"].float())
    out = out.reshape(B, 1, h * hd).to(x.dtype)
    return out @ params["wo"]
