"""Client-side optimizers on trees of tensors.  The paper's clients run
plain SGD (lr 0.01, batch 32, one local epoch — §6.2)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_map


def sgd_init(params: Any) -> Dict:
    return {}


def sgd_apply(params: Any, grads: Any, state: Dict, *, lr: float
              ) -> Tuple[Any, Dict]:
    new = tree_map(
        lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params, grads)
    return new, state


def momentum_init(params: Any) -> Dict:
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params)}


def momentum_apply(params: Any, grads: Any, state: Dict, *, lr: float,
                   beta: float = 0.9) -> Tuple[Any, Dict]:
    m = tree_map(lambda mm, g: beta * mm + g.float(), state["m"], grads)
    new = tree_map(lambda p, mm: (p.float() - lr * mm).to(p.dtype), params, m)
    return new, {"m": m}
