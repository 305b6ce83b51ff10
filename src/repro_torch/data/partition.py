"""Non-IID federated partitioning (paper §6.2 uses FedScale's real
client-data mapping; we reproduce the statistical shape with Dirichlet
label-skew partitioning, the standard FL benchmark protocol)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class ClientShard:
    client_id: str
    indices: np.ndarray

    @property
    def num_samples(self) -> int:
        return len(self.indices)


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float = 0.3,
    seed: int = 0,
    min_samples: int = 2,
) -> List[ClientShard]:
    """Label-skew Dirichlet split: each client's class mix ~ Dir(α)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idxs in by_class:
        rng.shuffle(idxs)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c, idxs in enumerate(by_class):
        if len(idxs) == 0:
            continue
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idxs)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idxs, cuts)):
            client_idx[cid].extend(part.tolist())
    shards = []
    spare = []
    for cid, idxs in enumerate(client_idx):
        if len(idxs) < min_samples:
            spare.extend(idxs)
            idxs = []
        shards.append(ClientShard(f"client{cid}", np.asarray(idxs, np.int64)))
    # round-robin spare samples into starved clients
    starved = [s for s in shards if s.num_samples < min_samples]
    for i, idx in enumerate(spare):
        if not starved:
            break
        tgt = starved[i % len(starved)]
        tgt.indices = np.append(tgt.indices, idx)
    return shards


def client_sample_counts(shards: List[ClientShard]) -> Dict[str, int]:
    return {s.client_id: s.num_samples for s in shards}
