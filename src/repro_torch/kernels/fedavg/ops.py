"""Public wrappers for the fedavg kernels.

``impl="auto"`` launches the CUDA kernel for a CUDA tensor and runs the
plain PyTorch version (``ref.py``) for a CPU tensor; ``impl="cuda"``
always launches (and raises for a CPU tensor); ``impl="torch"`` always
runs the plain version.  On a CUDA tensor the kernel either runs or
raises: nothing falls back to the plain version.

The two accumulate functions update ``acc`` in place and return it —
the counterpart of the JAX package's donated, aliased accumulator.
Pytree helpers flatten an update tree into the (K, N) layout the
kernels stream, leaves in ``jax.tree.flatten`` order.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.kernels.fedavg import fedavg as _cuda
from repro_torch.kernels.fedavg.ref import (
    eager_accumulate_ref,
    fedavg_accumulate_k_ref,
    fedavg_reduce_ref,
)
from repro_torch.tree import tree_flatten, tree_unflatten

IMPLS = ("auto", "cuda", "torch")


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl == "auto":
        return t.device.type == "cuda"
    if impl == "cuda":
        return True
    if impl == "torch":
        return False
    raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor,
                  *, impl: str = "auto") -> torch.Tensor:
    """Weighted mean of K stacked flat updates: (K,N) × (K,) -> (N,)."""
    wn = weights.to(device=updates.device, dtype=torch.float32)
    wn = wn / torch.clamp(wn.sum(), min=1e-30)
    if _use_kernel(impl, updates):
        return _cuda.fedavg_reduce_cuda(updates, wn)
    return fedavg_reduce_ref(updates, wn)


def eager_accumulate(acc: torch.Tensor, update: torch.Tensor, weight,
                     *, impl: str = "auto") -> torch.Tensor:
    """acc += w·u in place; returns ``acc``."""
    if _use_kernel(impl, acc):
        return _cuda.eager_accumulate_cuda(acc, update, float(weight))
    return acc.copy_(eager_accumulate_ref(acc, update, float(weight)))


def fedavg_accumulate_k(acc: torch.Tensor, updates: torch.Tensor,
                        weights: torch.Tensor, *,
                        impl: str = "auto") -> torch.Tensor:
    """K-way burst fold acc += Σ_k w[k]·u[k] in place; returns ``acc``.

    Weights are raw (not normalized): this extends the running weighted
    *sum*; the caller divides by Σ w at the end (cumulative averaging),
    so eager bursts and lazy batches stay numerically aligned."""
    if _use_kernel(impl, acc):
        return _cuda.fedavg_accumulate_k_cuda(acc, updates, weights)
    return acc.copy_(fedavg_accumulate_k_ref(acc, updates, weights))


# ---------------------------------------------------------------------------
# pytree adapters (model updates are parameter trees)
# ---------------------------------------------------------------------------


def flatten_update(tree: Any) -> Tuple[torch.Tensor, Any, List]:
    """-> (flat fp32 vector, treedef, [(shape, dtype)] per leaf)."""
    leaves, treedef = tree_flatten(tree)
    meta = [(tuple(l.shape), l.dtype) for l in leaves]
    flat = torch.cat([l.reshape(-1).float() for l in leaves])
    return flat, treedef, meta


def unflatten_update(flat: torch.Tensor, treedef, meta) -> Any:
    out = []
    off = 0
    for shape, dtype in meta:
        n = 1
        for d in shape:
            n *= d
        out.append(flat[off: off + n].reshape(shape).to(dtype))
        off += n
    return tree_unflatten(treedef, out)


def fedavg_reduce_tree(updates: Sequence[Any], weights: Sequence[float],
                       *, impl: str = "auto") -> Any:
    """Weighted mean of update trees through the flat reduce: the (K, N)
    slab is allocated once on the trees' device and each tree's leaves
    are written straight into its row."""
    leaves0, treedef = tree_flatten(updates[0])
    meta = [(tuple(l.shape), l.dtype) for l in leaves0]
    n = sum(l.numel() for l in leaves0)
    device = leaves0[0].device
    stacked = torch.empty((len(updates), n), dtype=torch.float32,
                          device=device)
    for k, u in enumerate(updates):
        off = 0
        for l in tree_flatten(u)[0]:
            stacked[k, off: off + l.numel()] = l.reshape(-1)
            off += l.numel()
    w = torch.tensor([float(x) for x in weights], dtype=torch.float32,
                     device=device)
    flat = fedavg_reduce(stacked, w, impl=impl)
    return unflatten_update(flat, treedef, meta)
