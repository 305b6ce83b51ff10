"""Federated data pipeline: per-client loaders + cohort batching.

For the fused LM rounds, a cohort loader packs per-client token batches
into the (global_batch, seq) array consumed by the jitted round step;
client boundaries align with microbatches so each microbatch is one
arriving "model update" worth of data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.data.partition import ClientShard
from repro_torch.data.synthetic import TokenTaskStream


@dataclass
class ClientDataset:
    client_id: str
    images: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        return 0 if self.labels is None else len(self.labels)

    def batches(self, batch_size: int, epochs: int = 1, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        n = self.num_samples
        if n == 0:
            return
        rng = np.random.default_rng((hash(self.client_id) & 0xFFFF, seed))
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n, batch_size):
                sel = order[i : i + batch_size]
                yield {"images": self.images[sel], "labels": self.labels[sel]}


def build_client_datasets(
    images: np.ndarray, labels: np.ndarray, shards: Sequence[ClientShard]
) -> List[ClientDataset]:
    return [
        ClientDataset(s.client_id, images[s.indices], labels[s.indices])
        for s in shards
    ]


class CohortTokenLoader:
    """LM cohorts: ``round_batch`` returns {tokens, labels} of shape
    (global_batch, seq) where each contiguous microbatch slice holds one
    cohort's data (cohort i ⇔ arriving update i)."""

    def __init__(self, vocab_size: int, seq_len: int, n_cohorts: int,
                 seed: int = 0):
        self.streams = [
            TokenTaskStream(vocab_size, seq_len, seed=seed * 1000 + i)
            for i in range(n_cohorts)
        ]
        self.n_cohorts = n_cohorts

    def round_batch(self, global_batch: int, round_id: int) -> Dict[str, np.ndarray]:
        assert global_batch % self.n_cohorts == 0
        per = global_batch // self.n_cohorts
        parts = [s.batch(per, round_id) for s in self.streams]
        return {
            k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]
        }
