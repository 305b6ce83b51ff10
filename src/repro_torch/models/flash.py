"""Blockwise self-attention with a flash-style backward, the JAX
package's ``models/flash.py``.

The forward is the online-softmax scan over KV blocks and saves only
``(q, k, v, out, lse)``; the backward recomputes each block's
probabilities from ``lse`` instead of keeping them, so the residual is
O(S) per query row.  Everything runs in fp32 on upcast inputs, with
``-1e30`` as the masked value, as the JAX code does; the output and the
gradients are cast back to the inputs' dtypes.  The JAX package has no
Pallas kernel for this backward: it is plain JAX there and plain
PyTorch here (a ``torch.autograd.Function`` in place of
``jax.custom_vjp``, the ``lax.scan`` over KV blocks a Python loop).

The forward and backward are labelled ``flash_vjp.forward`` /
``flash_vjp.backward`` for ``torch.profiler``, which attributes device
time to them.

Positions are explicit, as in the JAX package: ``sq0``, the position
of the first q row (a shard's first row under context parallelism), and
``kpos``, the positions of the kv rows (a ring's working set is not
contiguous); padded kv rows take position 2**30, in the future of every
query, so causality masks them.

:func:`flash_self_attention_sp` is the JAX package's context-parallel
region over a model axis across ranks: each rank takes its shard of the
q rows, and its kv working set comes over the model group
(``launch/dist.py``'s differentiable collectives).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import GLOBAL
from repro_torch.launch import dist
from repro_torch.launch.mesh import model_shards

_NEG_INF = -1e30


def _mask(sq0: int, Sq: int, kposb: torch.Tensor, window: int,
          causal: bool) -> torch.Tensor:
    """(Sq, bk) mask for q rows [sq0, sq0 + Sq) vs kv rows at ``kposb``."""
    qpos = sq0 + torch.arange(Sq, device=kposb.device)
    diff = qpos[:, None] - kposb[None, :]
    m = (diff >= 0) if causal else torch.ones_like(diff, dtype=torch.bool)
    if window != GLOBAL:
        m = m & (diff < window)
    return m


def _kv_blocks(k: torch.Tensor, v: torch.Tensor, kpos: torch.Tensor,
               bk: int):
    """k/v (B,Skv,K,D) at positions ``kpos`` (Skv,) -> (B,nkv,bk,K,D)
    each, kv positions (nkv, bk)."""
    B, Skv, K, _ = k.shape
    nkv = -(-Skv // bk)
    pad = nkv * bk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.cat([kpos, torch.full((pad,), 2 ** 30,
                                           device=k.device)])
    return (k.reshape(B, nkv, bk, K, k.shape[-1]),
            v.reshape(B, nkv, bk, K, v.shape[-1]), kpos.reshape(nkv, bk))


def _scores(qf, kc, sq0, pc, window, causal, scale):
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
    msk = _mask(sq0, qf.shape[1], pc, window, causal)
    return torch.where(msk[None, None, None], s, _NEG_INF)


def _fwd_scan(q, k, v, sq0, kpos, window, causal, scale, bk):
    """q (B,Sq,K,G,D), k/v (B,Skv,K,D) -> out (B,K,G,Sq,Dv) fp32, lse."""
    B, Sq, K, G, _ = q.shape
    Dv = v.shape[-1]
    kb, vb, pb = _kv_blocks(k, v, kpos, bk)
    qf = q.float()
    acc = torch.zeros((B, K, G, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, K, G, Sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    for j in range(pb.shape[0]):
        s = _scores(qf, kb[:, j].float(), sq0, pb[j], window, causal,
                    scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p, vb[:, j].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


class _FlashCore(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, sq0: int, kpos, window: int, causal: bool,
                scale: float, bk: int):
        with record_function("flash_vjp.forward"):
            out, lse = _fwd_scan(q, k, v, sq0, kpos, window, causal, scale,
                                 bk)
        ctx.save_for_backward(q, k, v, kpos, out, lse)
        ctx.args = (sq0, window, causal, scale, bk)
        # (B,K,G,Sq,Dv) -> (B,Sq,K,G,Dv)
        return out.permute(0, 3, 1, 2, 4).contiguous().to(v.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kpos, out, lse = ctx.saved_tensors
        with record_function("flash_vjp.backward"):
            dq, dk, dv = _flash_bwd(q, k, v, kpos, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _flash_bwd(q, k, v, kpos, out, lse, do, sq0, window, causal, scale, bk):
    Skv = k.shape[1]
    kb, vb, pb = _kv_blocks(k, v, kpos, bk)
    qf = q.float()
    dof = do.permute(0, 2, 3, 1, 4).float()          # (B,K,G,Sq,Dv)
    delta = (dof * out).sum(dim=-1)                  # (B,K,G,Sq)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(pb.shape[0]):
        kcf, vcf = kb[:, j].float(), vb[:, j].float()
        s = _scores(qf, kcf, sq0, pb[j], window, causal, scale)
        p = torch.exp(s - lse[..., None])            # (B,K,G,Sq,bk)
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p, dof))
        dp = torch.einsum("bkgqd,bskd->bkgqs", dof, vcf)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds, kcf)
        dks.append(torch.einsum("bkgqs,bqkgd->bskd", ds, qf))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_self_attention(q, k, v, window: int, causal: bool, scale: float,
                         bk: int):
    """q (B,S,K,G,D), k/v (B,S,K,D) -> (B,S,K,G,Dv) in v's dtype; the q
    rows start at position 0."""
    kpos = torch.arange(k.shape[1], device=k.device)
    return _FlashCore.apply(q, k, v, 0, kpos, window, causal, float(scale),
                            bk)


def flash_self_attention_sp(q, k, v, window: int, causal: bool,
                            scale: float, bk: int, model_axis: str,
                            mesh=None):
    """Context-parallel flash over ``model_axis``: the q sequence split
    over the axis's ranks, the JAX package's ``shard_map`` region.

    q, k and v are the whole sequence on every rank (the computation
    around the region is replicated over the model axis); rank i takes
    rows ``[i·L, (i+1)·L)``, ``L = S / shards``.  A global layer
    all-gathers K/V over the axis.  A causal sliding-window layer whose
    window spans ``hops = ceil(window / L) < shards - 1`` shards fetches
    only those older shards, over a ring of ``ppermute``s, older shards
    first; a shard before the first (a source below 0) takes position
    2**30, in every query's future.  The output's shards are gathered
    back into the whole sequence.  On an axis of size 1 this is
    :func:`flash_self_attention`."""
    shards = model_shards(mesh, model_axis, "attn_impl='chunked_sp'")
    if shards == 1:
        return flash_self_attention(q, k, v, window, causal, scale,
                                    min(bk, k.shape[1]))
    S = q.shape[1]
    if S % shards:
        raise ValueError(f"attn_impl='chunked_sp': a sequence of {S} does "
                         f"not split evenly over {shards} {model_axis!r} "
                         "ranks")
    L = S // shards
    idx = mesh.coord(model_axis)
    sq0 = idx * L
    qc, kc, vc = (t[:, sq0:sq0 + L] for t in (q, k, v))
    ar = torch.arange(L, device=k.device)
    hops = -(-window // L) if (window != GLOBAL and causal) else None
    if hops is not None and hops < shards - 1:
        blocks, kh, vh = [], kc, vc
        for h in range(1, hops + 1):
            kh = dist.ppermute(kh, mesh, model_axis, 1)
            vh = dist.ppermute(vh, mesh, model_axis, 1)
            src = idx - h
            pos = src * L + ar if src >= 0 else torch.full_like(ar, 2 ** 30)
            blocks.append((kh, vh, pos))
        blocks = [*reversed(blocks), (kc, vc, sq0 + ar)]
        kf = torch.cat([b[0] for b in blocks], dim=1)
        vf = torch.cat([b[1] for b in blocks], dim=1)
        kpos = torch.cat([b[2] for b in blocks])
    else:
        kf = dist.all_gather(kc, mesh, model_axis, dim=1)
        vf = dist.all_gather(vc, mesh, model_axis, dim=1)
        kpos = torch.arange(S, device=k.device)
    out = _FlashCore.apply(qc, kf, vf, sq0, kpos, window, causal,
                           float(scale), min(bk, kf.shape[1]))
    return dist.all_gather(out, mesh, model_axis, dim=1)
