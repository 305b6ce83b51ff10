"""Multi-head latent attention (DeepSeek-V2), the JAX package's
``models/mla.py``.

Prefill decompresses the latent per KV position and runs the blockwise
attention of ``models/flash.py`` over (nope | rope) heads concatenated,
so one contraction gives q_nope·k_nope + q_rope·k_rope.  Every impl
but ``naive`` goes there, ``pallas`` included, as in the JAX package:
its flash kernel is not called for MLA.  ``chunked_sp`` is the
context-parallel form over the mesh's model axis, the same function
with Dk ≠ Dv.

Decode uses the *absorption* trick (W_UK folded into the query, W_UV
into the output), so a step reads the compressed cache: the latent c
(kv_lora_rank) and the shared rope key (qk_rope_head_dim) a token.  The
ring slot is written in place, as ``attention.attention_decode`` does.
Cast points are the JAX package's: the absorbed query in the params'
dtype, scores, softmax and the latent output in fp32, that output cast
to the input's dtype before W_UV.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import _attend_naive
from repro_torch.models.flash import (flash_self_attention,
                                      flash_self_attention_sp)
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm

_NEG_INF = -1e30


def init_mla(gen: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_init(gen, (d, m.q_lora_rank), dtype)
        p["q_a_norm"] = torch.ones((m.q_lora_rank,), dtype=dtype,
                                   device=gen.device)
        p["wq_b"] = dense_init(gen, (m.q_lora_rank, h * qk_head), dtype)
    else:
        p["wq"] = dense_init(gen, (d, h * qk_head), dtype)
    # down-projection to the compressed latent + the decoupled rope key
    p["wkv_a"] = dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype)
    p["kv_a_norm"] = torch.ones((m.kv_lora_rank,), dtype=dtype,
                                device=gen.device)
    # up-projection (decompression): latent -> per-head (k_nope | v)
    p["wkv_b"] = dense_init(
        gen, (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)), dtype)
    p["wo"] = dense_init(gen, (h * m.v_head_dim, d), dtype)
    return p


def _queries(cfg: ArchConfig, params, x, positions):
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        qa = rmsnorm({"scale": params["q_a_norm"]}, x @ params["wq_a"],
                     cfg.norm_eps)
        q = (qa @ params["wq_b"]).reshape(B, S, h, qk_head)
    else:
        q = (x @ params["wq"]).reshape(B, S, h, qk_head)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent(cfg: ArchConfig, params, x, positions):
    """Compressed latent c (B,S,R) and shared rope key (B,S,Dr)."""
    m = cfg.mla
    kv = x @ params["wkv_a"]
    c = rmsnorm({"scale": params["kv_a_norm"]}, kv[..., :m.kv_lora_rank],
                cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]           # (B,S,1,Dr)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c, k_rope


def _split_wkv_b(cfg: ArchConfig, params):
    """wkv_b -> W_UK (R,h,Dn), W_UV (R,h,Dv)."""
    m = cfg.mla
    wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, cfg.num_heads,
                                    m.qk_nope_head_dim + m.v_head_dim)
    return wkv_b[..., :m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim:]


def mla_attention(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  impl: str = "naive", block_kv: int = 512,
                  model_axis: str = "model", mesh=None,
                  return_latent: bool = False):
    """Prefill: decompress the latent, then attention over the
    concatenated (nope | rope) heads.  ``return_latent``: -> (out,
    (c, k_rope)), the latent and roped key the decode cache holds."""
    if impl not in ("naive", "chunked", "chunked_sp", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _queries(cfg, params, x, positions)
    c, k_rope = _latent(cfg, params, x, positions)
    w_uk, w_uv = _split_wkv_b(cfg, params)
    k_nope = torch.einsum("bsr,rhd->bshd", c, w_uk)
    v = torch.einsum("bsr,rhd->bshd", c, w_uv)

    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]  # K=h, G=1
    k_cat = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(B, S, h, m.qk_rope_head_dim)],
        dim=-1)
    if impl == "naive":
        out = _attend_naive(q_cat, k_cat, v, positions, positions, -1, causal,
                            scale)
    elif impl == "chunked_sp":
        out = flash_self_attention_sp(q_cat, k_cat, v, -1, causal, scale,
                                      min(block_kv, S), model_axis=model_axis,
                                      mesh=mesh)
    else:
        out = flash_self_attention(q_cat, k_cat, v, -1, causal, scale,
                                   min(block_kv, S))
    out = out.reshape(B, S, h * m.v_head_dim) @ params["wo"]
    return (out, (c, k_rope)) if return_latent else out


# ---------------------------------------------------------------------------
# decode with the compressed-latent ring cache + absorption
# ---------------------------------------------------------------------------


def init_mla_cache(cfg: ArchConfig, batch: int, capacity: int,
                   dtype: torch.dtype, device) -> dict:
    m = cfg.mla
    return {
        "c": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((batch, capacity, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(cfg: ArchConfig, params: dict, x: torch.Tensor,
               cache: dict, pos: int):
    """x (B,1,D) at absolute position ``pos`` -> (out (B,1,D), cache
    written in place)."""
    m = cfg.mla
    B = x.shape[0]
    h = cfg.num_heads
    pos = int(pos)
    c, kr = cache["c"], cache["k_rope"]
    # a fill on the device: a host tensor copied over would wait on the stream
    posv = torch.full((1,), pos, device=x.device)

    q_nope, q_rope = _queries(cfg, params, x, posv)            # (B,1,h,·)
    c_new, kr_new = _latent(cfg, params, x, posv)              # (B,1,R), (B,1,Dr)
    slot = pos % c.shape[1]
    c[:, slot] = c_new[:, 0]
    kr[:, slot] = kr_new[:, 0]

    w_uk, w_uv = _split_wkv_b(cfg, params)
    # W_UK absorbed into the query: q_c (B,h,R) scores the latent directly
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    o_c = _attend_latent(q_c, q_rope[:, 0], c, kr, pos, scale)
    out = torch.einsum("bhr,rhd->bhd", o_c.to(x.dtype), w_uv)  # W_UV absorbed
    out = out.reshape(B, 1, h * m.v_head_dim)
    return out @ params["wo"], {"c": c, "k_rope": kr}


def _attend_latent(q_c, q_rope, c, kr, pos: int, scale: float):
    """The absorbed attention over the ring: q_c (B,h,R) and q_rope
    (B,h,Dr) against the cached latent c (B,cap,R) and rope keys kr
    (B,cap,Dr) -> the latent-space output (B,h,R), fp32."""
    cap = c.shape[1]
    cf = c.float()
    s = torch.einsum("bhr,bsr->bhs", q_c.float(), cf)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr.float())
    s = s * scale
    # ring-slot validity: slot j holds absolute position pos - ((slot-j) mod cap)
    slots = torch.arange(cap, device=c.device)
    abs_pos = pos - torch.remainder(pos % cap - slots, cap)
    s = torch.where((abs_pos >= 0)[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, cf)
