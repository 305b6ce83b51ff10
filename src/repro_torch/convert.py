"""Weights and updates carried between the JAX package and the port.

The two packages share one parameter-tree structure and one leaf
order; they differ in one layout: the JAX package keeps conv kernels
HWIO, the port OIHW.  Every 4-D leaf of a tree is a conv kernel (the
ResNets have no other), so the mapping is per leaf.  Flat vectors keep
the JAX layout on the wire (``flatten_jax_layout``), so an update from
either package folds into the other.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def leaf_to_jax(t: torch.Tensor) -> torch.Tensor:
    """OIHW -> HWIO for a conv kernel; any other leaf as it is."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def leaf_from_jax(t: torch.Tensor) -> torch.Tensor:
    """HWIO -> OIHW for a conv kernel; any other leaf as it is."""
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def params_from_jax(tree: Any, device: Any = None) -> Any:
    """A tree of numpy arrays in the JAX layout -> the port's tree of
    contiguous tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: leaf_from_jax(torch.from_numpy(np.array(a))).contiguous()
        .to(dev), tree)


def params_to_jax(tree: Any) -> Any:
    """The port's tree of tensors -> a tree of numpy arrays in the JAX
    layout."""
    return tree_map(
        lambda t: leaf_to_jax(t.detach()).cpu().contiguous().numpy(), tree)


def flatten_jax_layout(tree: Any) -> Tuple[np.ndarray, Any, list]:
    """One fp32 numpy vector in the JAX package's leaf order and layout,
    gathered on the tree's device and copied to the host once."""
    leaves, treedef = tree_flatten(tree)
    meta = [(tuple(leaf_to_jax(l).shape), l.dtype) for l in leaves]
    flat = torch.cat([leaf_to_jax(l.detach()).reshape(-1).float()
                      for l in leaves])
    return flat.cpu().numpy(), treedef, meta


def unflatten_jax_layout(flat: np.ndarray, like: Any) -> Any:
    """A flat JAX-layout vector -> a tree shaped, typed and placed like
    ``like`` (the port's layout)."""
    leaves, treedef = tree_flatten(like)
    dev = torch.from_numpy(np.ascontiguousarray(flat, np.float32)).to(
        leaves[0].device)
    out = []
    off = 0
    for l in leaves:
        n = l.numel()
        hwio = leaf_to_jax(l).shape
        out.append(leaf_from_jax(dev[off: off + n].reshape(hwio))
                   .contiguous().to(l.dtype))
        off += n
    return tree_unflatten(treedef, out)
