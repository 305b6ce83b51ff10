"""Embedding lookup and decode logits over the padded vocab table.

The JAX package's ``models/sharded_vocab.py`` on one device: the vocab
is padded to a multiple of 256 and the padded logits are stripped.  Its
vocab-sharded branches (a table split over a mesh axis) wait for the
port's distribution work and are refused by name.
"""
from __future__ import annotations

from typing import Optional

import torch

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def _refuse_sharded(vocab_axis: Optional[str]) -> None:
    if vocab_axis is not None:
        raise NotImplementedError(
            f"vocab_axis={vocab_axis!r}: the vocab-sharded table is not "
            "ported yet (ROADMAP A.8)")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 model_axis: Optional[str]) -> torch.Tensor:
    """tokens (B,S) -> (B,S,D)."""
    _refuse_sharded(model_axis)
    return table[tokens]


def decode_logits(hidden: torch.Tensor, w: torch.Tensor, *, vocab: int,
                  tied: bool, model_axis: Optional[str]) -> torch.Tensor:
    """(B, 1, D) -> (B, 1, vocab) fp32."""
    _refuse_sharded(model_axis)
    wt = w[:vocab] if tied else w[:, :vocab]
    return hidden.float() @ (wt.t().float() if tied else wt.float())
