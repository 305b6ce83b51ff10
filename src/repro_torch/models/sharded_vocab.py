"""Embedding lookup, chunked cross-entropy and decode logits over the
padded vocab table.

The JAX package's ``models/sharded_vocab.py`` on one device: the vocab
is padded to a multiple of 256, and the padded rows are stripped before
the logits and the loss.  A ``vocab_axis`` of size 1 on the model's mesh
(``ModelOptions.mesh``) holds the whole table: the unsharded branch.  A
table split over a larger axis waits for the port's distribution work,
and a named axis without a mesh cannot be resolved: both are refused
by name (ROADMAP A.8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch.mesh import require_one_device
from repro_torch.models.layers import chunked_lm_loss

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def _refuse_sharded(vocab_axis: Optional[str], mesh) -> None:
    if vocab_axis is not None:
        require_one_device(mesh, vocab_axis, f"vocab_axis={vocab_axis!r}")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 model_axis: Optional[str], mesh=None) -> torch.Tensor:
    """tokens (B,S) -> (B,S,D)."""
    _refuse_sharded(model_axis, mesh)
    return table[tokens]


def chunked_lm_loss_sharded(hidden: torch.Tensor, w: torch.Tensor,
                            labels: torch.Tensor, *, vocab: int, tied: bool,
                            model_axis: Optional[str], chunk: int = 256,
                            mesh=None) -> torch.Tensor:
    """Mean cross-entropy of (B, S, D) hidden states; labels of -1 are
    ignored.  The chunk shrinks until it divides S, as in the JAX
    package."""
    _refuse_sharded(model_axis, mesh)
    S = hidden.shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    wt = w[:vocab] if tied else w[:, :vocab]
    return chunked_lm_loss(hidden, wt, labels, tied, chunk=chunk)


def decode_logits(hidden: torch.Tensor, w: torch.Tensor, *, vocab: int,
                  tied: bool, model_axis: Optional[str],
                  mesh=None) -> torch.Tensor:
    """(B, 1, D) -> (B, 1, vocab) fp32."""
    _refuse_sharded(model_axis, mesh)
    wt = w[:vocab] if tied else w[:, :vocab]
    return hidden.float() @ (wt.t().float() if tied else wt.float())
