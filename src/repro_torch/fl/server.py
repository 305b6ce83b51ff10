"""Server-side optimizers (FedOpt family) on trees of tensors.

The server consumes the *aggregated* model update Δ (weighted mean of
client updates) and produces new global params:

  fedavg  :  w ← w − η·Δ                  (McMahan et al., 2017)
  fedavgm :  m ← β·m + Δ;  w ← w − η·m    (server momentum)
  fedadam :  Adam on Δ                    (Reddi et al., 2020)

Arithmetic in fp32, in the order of the JAX package's ``fl/server.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def _zeros(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _step0(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def init_server_state(name: str, params: Any) -> Dict[str, Any]:
    if name == "fedavg":
        return {"step": _step0(params)}
    if name == "fedavgm":
        return {"step": _step0(params), "momentum": _zeros(params)}
    if name == "fedadam":
        return {"step": _step0(params), "m": _zeros(params),
                "v": _zeros(params)}
    raise ValueError(f"unknown server optimizer {name!r}")


def apply_server_opt(
    name: str,
    params: Any,
    state: Dict[str, Any],
    delta: Any,
    *,
    lr: float = 1.0,
    beta: float = 0.9,
    beta2: float = 0.99,
    eps: float = 1e-8,
) -> Tuple[Any, Dict[str, Any]]:
    step = state["step"] + 1
    if name == "fedavg":
        new = tree_map(lambda p, d: (p.float() - lr * d.float()).to(p.dtype),
                       params, delta)
        return new, {"step": step}
    if name == "fedavgm":
        m = tree_map(lambda mm, d: beta * mm + d.float(),
                     state["momentum"], delta)
        new = tree_map(lambda p, mm: (p.float() - lr * mm).to(p.dtype),
                       params, m)
        return new, {"step": step, "momentum": m}
    if name == "fedadam":
        m = tree_map(lambda mm, d: beta * mm + (1 - beta) * d.float(),
                     state["m"], delta)
        v = tree_map(
            lambda vv, d: beta2 * vv + (1 - beta2) * torch.square(d.float()),
            state["v"], delta)
        t = step.float()
        bc1 = 1 - beta ** t
        bc2 = 1 - beta2 ** t
        new = tree_map(
            lambda p, mm, vv: (
                p.float() - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            ).to(p.dtype),
            params, m, v)
        return new, {"step": step, "m": m, "v": v}
    raise ValueError(f"unknown server optimizer {name!r}")
