"""Weights and updates carried between the JAX package and the port.

The two packages share one parameter-tree structure and one leaf order.
ResNet trees differ in one layout: the JAX package keeps conv kernels
HWIO, the port OIHW.  A 4-D leaf is permuted only under a conv
kernel's key (``CONV_KEYS``); any other 4-D leaf is refused, so a tree
of another model is never permuted by accident.  LM trees keep every
leaf's layout and dtype and go through ``lm_params_from_jax`` /
``lm_params_to_jax``.  Flat vectors keep the JAX layout on the wire
(``flatten_jax_layout``), so an update from either package folds into
the other.

bf16 leaves: the JAX side hands them over as ``ml_dtypes.bfloat16``
numpy arrays, which ``torch.from_numpy`` refuses and the port does not
import.  They are recognised by ``dtype.name`` and moved as 16-bit
words.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import (named_leaves, tree_flatten, tree_map,
                              tree_unflatten)

#: the ResNet tree's conv-kernel keys: its only leaves laid out otherwise
CONV_KEYS = frozenset({"stem", "conv1", "conv2", "conv3", "proj"})


def conv_flags(tree: Any) -> List[bool]:
    """Per leaf, in JAX order: is it a conv kernel (HWIO <-> OIHW)?"""
    flags = []
    for path, leaf in named_leaves(tree):
        conv = len(leaf.shape) == 4
        if conv and path.rsplit(".", 1)[-1] not in CONV_KEYS:
            raise ValueError(
                f"{path}: a 4-D leaf that is not a ResNet conv kernel; LM "
                "trees go through lm_params_from_jax / lm_params_to_jax")
        flags.append(conv)
    return flags


def _map_leaves(fn, tree: Any) -> Any:
    """``fn(leaf, conv)`` over the leaves of a ResNet tree."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(
        treedef, [fn(l, c) for l, c in zip(leaves, conv_flags(tree))])


def leaf_to_jax(t: torch.Tensor, conv: bool) -> torch.Tensor:
    """OIHW -> HWIO for a conv kernel; any other leaf as it is."""
    return t.permute(2, 3, 1, 0) if conv else t


def leaf_from_jax(t: torch.Tensor, conv: bool) -> torch.Tensor:
    """HWIO -> OIHW for a conv kernel; any other leaf as it is."""
    return t.permute(3, 2, 0, 1) if conv else t


def tensor_from_numpy(a: Any) -> torch.Tensor:
    """A numpy (or JAX) array -> a CPU tensor of the same dtype; bf16
    moves as 16-bit words."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array of the same dtype.  A bf16 tensor
    becomes ``ml_dtypes.bfloat16`` words, a dtype numpy knows once the
    JAX side (which imports ``ml_dtypes``) is loaded in the process."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def params_from_jax(tree: Any, device: Any = None) -> Any:
    """A ResNet tree of numpy arrays in the JAX layout -> the port's tree
    of contiguous tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return _map_leaves(
        lambda a, conv: leaf_from_jax(tensor_from_numpy(a), conv)
        .contiguous().to(dev), tree)


def params_to_jax(tree: Any) -> Any:
    """The port's ResNet tree of tensors -> numpy arrays in the JAX
    layout."""
    return _map_leaves(
        lambda t, conv: tensor_to_numpy(leaf_to_jax(t.detach(), conv)), tree)


def tree_from_jax(tree: Any, device: Any = None) -> Any:
    """A tree of numpy (or JAX) arrays -> the same tree of tensors on
    ``device`` (None: the card), every leaf in its layout and dtype: a
    fused round's server state (``{"step", moments...}``) and the like."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a).to(dev), tree)


def lm_params_from_jax(tree: Any, device: Any = None) -> Any:
    """An LM tree ``{"embed", "segments": [stacked dicts], "final_norm",
    "lm_head"?}`` of numpy arrays -> the same tree of tensors on
    ``device`` (None: the card), every leaf in its layout and dtype."""
    return tree_from_jax(tree, device)


def metrics_from_jax(metrics: Any) -> Dict[str, float]:
    """A JAX fused round's metrics (numpy or JAX scalars) -> floats, as
    ``FusedFLTrainer.train_round`` records the port's."""
    return {k: float(np.asarray(v)) for k, v in metrics.items()}


def lm_params_to_jax(tree: Any) -> Any:
    """The port's LM tree -> numpy arrays, every leaf in its layout and
    dtype."""
    return tree_map(tensor_to_numpy, tree)


def flatten_jax_layout(tree: Any) -> Tuple[np.ndarray, Any, list]:
    """One fp32 numpy vector in the JAX package's leaf order and layout,
    gathered on the tree's device and copied to the host once."""
    leaves, treedef = tree_flatten(tree)
    flags = conv_flags(tree)
    meta = [(tuple(leaf_to_jax(l, c).shape), l.dtype)
            for l, c in zip(leaves, flags)]
    flat = torch.cat([leaf_to_jax(l.detach(), c).reshape(-1).float()
                      for l, c in zip(leaves, flags)])
    return flat.cpu().numpy(), treedef, meta


def unflatten_jax_layout(flat: np.ndarray, like: Any) -> Any:
    """A flat JAX-layout vector -> a tree shaped, typed and placed like
    ``like`` (the port's layout)."""
    leaves, treedef = tree_flatten(like)
    dev = torch.from_numpy(np.ascontiguousarray(flat, np.float32)).to(
        leaves[0].device)
    out = []
    off = 0
    for l, conv in zip(leaves, conv_flags(like)):
        n = l.numel()
        hwio = leaf_to_jax(l, conv).shape
        out.append(leaf_from_jax(dev[off: off + n].reshape(hwio), conv)
                   .contiguous().to(l.dtype))
        off += n
    return tree_unflatten(treedef, out)
