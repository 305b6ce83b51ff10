"""Adam / AdamW on trees of tensors, the JAX package's ``optim/adam.py``.

Arithmetic in fp32 in the JAX package's order; the bias corrections
``1 - beta ** t`` are taken in fp32 from an fp32 step count, as ``jnp``
takes them, not in Python's double."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def adam_init(params: Any) -> Dict:
    zeros = lambda: tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": zeros(), "v": zeros()}


def adam_apply(
    params: Any,
    grads: Any,
    state: Dict,
    *,
    lr: float,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Tuple[Any, Dict]:
    step = state["step"] + 1
    t = step.float()
    m = tree_map(
        lambda mm, g: beta1 * mm + (1 - beta1) * g.float(),
        state["m"], grads,
    )
    v = tree_map(
        lambda vv, g: beta2 * vv + (1 - beta2) * torch.square(g.float()),
        state["v"], grads,
    )
    bc1 = 1 - torch.pow(torch.tensor(beta1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(beta2, dtype=torch.float32,
                                     device=t.device), t)

    def upd(p, mm, vv):
        u = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    new = tree_map(upd, params, m, v)
    return new, {"step": step, "m": m, "v": v}


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
