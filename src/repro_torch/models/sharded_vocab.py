"""Embedding lookup, chunked cross-entropy and decode logits over the
padded vocab table, the JAX package's ``models/sharded_vocab.py``.

The vocab is padded to a multiple of 256, and the padded rows are
stripped before the logits and the loss.  ``vocab_axis`` names an axis
of the model's mesh (``ModelOptions.mesh``); a named axis without a
mesh cannot be resolved and is refused (ROADMAP A.8).  At size 1 the
table is whole: the unsharded branch.  Above size 1, across ranks,
rank r holds rows ``[r·Vp/m, (r+1)·Vp/m)`` of the table (or those
columns of an untied head), as the JAX package's ``shard_map`` regions
hand them over, and the regions' collectives are ``launch/dist.py``'s:

* ``embed_lookup``: a masked local take, summed over the axis in fp32
  (one rank holds each token's row);
* ``chunked_lm_loss_sharded``: per chunk, logits over the local
  columns, padded columns at -1e30, a ``pmax`` without gradient as the
  softmax's shift, and sums over the axis of the exp sums and of the
  label's logit (``_ce_chunk_local``), each chunk checkpointed;
* ``decode_logits``: local logits gathered over the vocab.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from repro_torch.launch import dist
from repro_torch.launch.mesh import model_shards
from repro_torch.models.layers import chunked_lm_loss

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def _shards(vocab_axis: Optional[str], mesh, vp: int) -> int:
    """The vocab axis's size (1 without an axis); the padded vocab must
    split evenly over it."""
    if vocab_axis is None:
        return 1
    m = model_shards(mesh, vocab_axis, f"vocab_axis={vocab_axis!r}")
    if vp % m:
        raise ValueError(f"vocab_axis={vocab_axis!r}: a padded vocab of "
                         f"{vp} does not split over {m} ranks")
    return m


def _local(w: torch.Tensor, tied: bool, mesh, axis: str, m: int):
    """This rank's rows of a tied table (columns of a head) -> (them,
    the first vocab id they hold)."""
    v_loc = (w.shape[0] if tied else w.shape[1]) // m
    lo = mesh.coord(axis) * v_loc
    return (w[lo:lo + v_loc] if tied else w[:, lo:lo + v_loc]), lo


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 model_axis: Optional[str], mesh=None) -> torch.Tensor:
    """tokens (B,S) -> (B,S,D)."""
    m = _shards(model_axis, mesh, table.shape[0])
    if m == 1:
        return table[tokens]
    tbl, lo = _local(table, True, mesh, model_axis, m)
    idx = tokens - lo
    ok = (idx >= 0) & (idx < tbl.shape[0])
    rows = tbl[idx.clamp(0, tbl.shape[0] - 1)]
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return dist.psum(rows.float(), mesh, model_axis).to(table.dtype)


def _ce_chunk_local(w, h, y, tied: bool, *, vocab: int, mesh, axis: str,
                    m: int):
    """One chunk's (CE sum, valid count) from this rank's vocab shard."""
    wc, lo = _local(w, tied, mesh, axis, m)
    v_loc = wc.shape[0] if tied else wc.shape[1]
    hf, wf = h.float(), wc.float()
    logits = hf @ (wf.t() if tied else wf)                  # (B, c, v_loc)
    col = lo + torch.arange(v_loc, device=logits.device)
    logits = torch.where((col < vocab)[None, None, :], logits, -1e30)
    # the softmax is shift-invariant: the max takes no gradient
    mx = dist.pmax(logits.amax(dim=-1), mesh, axis)
    z = dist.psum(torch.exp(logits - mx[..., None]).sum(dim=-1), mesh, axis)
    logz = mx + torch.log(z)
    idx = y.long() - lo
    ok = (idx >= 0) & (idx < v_loc)
    tok = logits.gather(-1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
    tok = dist.psum(torch.where(ok, tok, 0.0), mesh, axis)
    valid = (y >= 0).float()
    return ((logz - tok) * valid).sum(), valid.sum()


def chunked_lm_loss_sharded(hidden: torch.Tensor, w: torch.Tensor,
                            labels: torch.Tensor, *, vocab: int, tied: bool,
                            model_axis: Optional[str], chunk: int = 256,
                            mesh=None) -> torch.Tensor:
    """Mean cross-entropy of (B, S, D) hidden states; labels of -1 are
    ignored.  The chunk shrinks until it divides S, as in the JAX
    package."""
    m = _shards(model_axis, mesh, w.shape[0] if tied else w.shape[1])
    S = hidden.shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    if m == 1:
        wt = w[:vocab] if tied else w[:, :vocab]
        return chunked_lm_loss(hidden, wt, labels, tied, chunk=chunk)
    return chunked_lm_loss(hidden, w, labels, tied, chunk=chunk,
                           chunk_loss=partial(_ce_chunk_local, vocab=vocab,
                                              mesh=mesh, axis=model_axis,
                                              m=m))


def decode_logits(hidden: torch.Tensor, w: torch.Tensor, *, vocab: int,
                  tied: bool, model_axis: Optional[str],
                  mesh=None) -> torch.Tensor:
    """(B, 1, D) -> (B, 1, vocab) fp32."""
    m = _shards(model_axis, mesh, w.shape[0] if tied else w.shape[1])
    if m == 1:
        wt = w[:vocab] if tied else w[:, :vocab]
        return hidden.float() @ (wt.t().float() if tied else wt.float())
    wc, _ = _local(w, tied, mesh, model_axis, m)
    local = hidden.float() @ (wc.t().float() if tied else wc.float())
    return dist.all_gather(local, mesh, model_axis, dim=2)[..., :vocab]
