"""Logical sharding rules: param / batch / cache trees -> PartitionSpecs,
the JAX package's ``sharding/rules.py``, and the storage they name.

Policy (as in the JAX package):
  * TP over ``model``: attention heads, FFN hidden, vocab, d_inner (SSM),
    MoE expert axis (EP).
  * FSDP over ``fsdp`` axes (default ``('data',)``; the flat multi-pod
    policy may add ``'pod'``): the d_model axis of every large matrix.
  * Extra leading axes (layer-stack inside scanned segments) are
    unsharded.
  * Small vectors (norm scales, biases) are replicated.

Rules are name-keyed on the *last* path components (dict keys, list
indices), so they read the port's param trees, which equal the JAX
package's, exactly as they read the JAX ones.

torch has no ``PartitionSpec``: :class:`PartitionSpec` (``P``) is the
port's, one entry a dim, each ``None``, an axis name or a tuple of
names.  It is a leaf of the port's trees (``repro_torch.tree``), not a
tuple.  In place of the JAX package's ``to_named`` (which hands the
specs to GSPMD), the specs name storage across the ranks of a mesh:
:func:`shard_tree` gives this rank's block of each leaf, and
:func:`gather_tree` the whole leaf back, through the differentiable
``launch/dist.py::all_gather``, whose adjoint sums the cotangent over
the gathered ranks and keeps this rank's block.  A dim that names
several axes is split row-major over them, in the mesh's axis order.
"""
from __future__ import annotations

from math import prod
from typing import Any, Tuple

import torch

from repro_torch.launch import dist
from repro_torch.tree import tree_map

Fsdp = Tuple[str, ...]


class PartitionSpec:
    """One entry a dim: ``None`` (unsharded), an axis name, or a tuple of
    names (the dim split row-major over them)."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.dims == other.dims
        return NotImplemented

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"P{self.dims!r}"


P = PartitionSpec


def _base_spec(path: Tuple[str, ...], ndim_base_hint: int, fsdp, model: str):
    """Return (base_rank, spec tuple) for a param identified by path."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""

    F = fsdp if fsdp else None
    # --- embeddings / heads -------------------------------------------------
    if name == "embed":
        return 2, (model, None)  # vocab-sharded; lookup is mask+psum
    if name == "lm_head":
        return 2, (None, model)
    if name == "frontend_proj":
        return 2, (F, model)
    # --- attention -----------------------------------------------------------
    if name in ("wq", "wk", "wv", "wq_a", "wq_b", "wkv_a"):
        return 2, (F, model)
    if name == "wkv_b":  # (R, h*(dn+dv)) — latent small, heads sharded
        return 2, (None, model)
    if name == "wo":
        return 2, (model, F)
    if name in ("q_norm", "k_norm"):
        return 1, (None,)
    # --- MoE -----------------------------------------------------------------
    if parent == "experts" and name in ("gate", "up"):
        return 3, (model, F, None)
    if parent == "experts" and name == "down":
        return 3, (model, None, F)
    if name == "router":
        return 2, (F, None)
    # --- dense FFN (incl. shared experts) -----------------------------------
    if name in ("gate", "up"):
        return 2, (F, model)
    if name == "down":
        return 2, (model, F)
    # --- SSM -----------------------------------------------------------------
    if name == "in_proj":
        return 2, (F, model)
    if name == "conv_w":
        return 2, (None, model)
    if name == "x_proj":
        return 2, (model, None)
    if name == "dt_proj":
        return 2, (None, model)
    if name in ("dt_bias", "D"):
        return 1, (model,)
    if name == "A_log":
        return 2, (model, None)
    if name == "out_proj":
        return 2, (model, F)
    # --- norms / scalars ------------------------------------------------------
    if name == "scale" or name.startswith("ln") or "norm" in name:
        return 1, (None,)
    # ResNet leaves (small) and anything unknown: replicate.
    return 0, ()


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path names, leaf)`` over a tree of dicts and lists (the
    JAX package's ``tree_map_with_path`` with its key names)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def param_specs(params: Any, *, fsdp: Fsdp = ("data",),
                model: str = "model") -> Any:
    """PartitionSpec tree matching ``params`` (works on meta tensors)."""

    def leaf_spec(names, leaf):
        ndim = len(leaf.shape)
        base_rank, base = _base_spec(names, ndim, fsdp, model)
        extra = ndim - base_rank
        if extra < 0:  # rule expects more dims than present (reduced configs)
            base = base[-ndim:] if ndim else ()
            extra = 0
        return P(*((None,) * extra + tuple(base)))

    return _map_with_path(leaf_spec, params)


def divisibility_fix(specs: Any, shapes: Any, mesh) -> Any:
    """Replace any axis assignment that doesn't divide evenly with None
    (reduced smoke configs and odd dims like danube's head_dim=120 shard
    only where legal)."""
    sizes = mesh.shape

    def fix(spec: P, leaf):
        out = []
        for i, ax in enumerate(tuple(spec)
                               + (None,) * (len(leaf.shape) - len(spec))):
            if ax is None:
                out.append(None)
                continue
            total = prod(sizes[a] for a in _names(ax))
            out.append(ax if leaf.shape[i] % total == 0 else None)
        return P(*out)

    return tree_map(fix, specs, shapes)


def batch_specs(batch: Any, dp: Tuple[str, ...]) -> Any:
    """Shard the leading (batch) dim of every batch leaf over dp axes."""

    def leaf(x):
        if x.dim() == 0:
            return P()
        return P(dp, *([None] * (x.dim() - 1)))

    return tree_map(leaf, batch)


def cache_specs(caches: Any, dp: Tuple[str, ...], model: str = "model") -> Any:
    """Decode-cache sharding: batch over dp, sequence/capacity over model
    (sequence parallelism for long contexts); SSM state d_inner over model.

    Cache leaves (per segment, layer-stacked):
      k/v      (L, B, cap, KVh, hd)   -> (None, dp, model, None, None)
      c        (L, B, cap, R)         -> (None, dp, model, None)
      k_rope   (L, B, cap, Dr)        -> (None, dp, model, None)
      h (ssm)  (L, B, d_in, N)        -> (None, dp, model, None)
      conv     (L, B, K-1, d_in)      -> (None, dp, None, model)
      cross k/v(L, B, M, KVh, hd)     -> (None, dp, None, None, None)
    """

    def leaf(names, x):
        name = names[-1]
        parent = names[-2] if len(names) >= 2 else ""
        if name == "conv":
            return P(None, dp, None, model)
        if name == "h":
            return P(None, dp, model, None)
        if parent == "cross":
            return P(None, dp, *([None] * (x.dim() - 3)))
        # k/v/c/k_rope ring caches: capacity dim sharded over model
        return P(None, dp, model, *([None] * (x.dim() - 3)))

    return _map_with_path(leaf, caches)


# ---------------------------------------------------------------------------
# storage: this rank's blocks, and the whole leaves back
# ---------------------------------------------------------------------------


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split(entry, mesh) -> Tuple[Tuple[str, ...], int, int]:
    """-> (the entry's axes, the number of blocks, this rank's block: the
    gather's order, ``launch/dist.py``)."""
    axes = _names(entry)
    order = [mesh.axis_names.index(a) for a in axes]
    if order != sorted(order):
        raise ValueError(f"a dim split over {axes} must name the axes in "
                         f"the mesh's order {mesh.axis_names}")
    return (axes, *dist.group_place(mesh, axes))


def block_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = _split(entry, mesh)[1]
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"into {n} blocks ({spec}): apply "
                             "divisibility_fix")
        out[i] //= n
    return tuple(out)


def block_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes of one rank's blocks of every leaf of ``tree``."""
    total = []
    tree_map(lambda x, s: total.append(
        prod(block_shape(x.shape, s, mesh)) * x.element_size()), tree, specs)
    return sum(total)


def shard_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``x``: a copy of its own (so the whole leaf
    can be freed), or ``x`` itself where the spec splits nothing."""
    block = x
    for i, entry in enumerate(spec):
        _, n, at = _split(entry, mesh)
        if n > 1:
            size = block_shape(x.shape, spec, mesh)[i]
            block = block.narrow(i, at * size, size)
    return block if block is x else block.clone()


def gather_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block of it: one all-gather a
    split dim, over the ranks of that dim's axes (differentiable)."""
    for i, entry in enumerate(spec):
        axes, n, _ = _split(entry, mesh)
        if n > 1:
            x = dist.all_gather(x, mesh, axes, i)
    return x


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's block of each leaf of ``tree`` (the port's ``to_named``:
    the storage the specs name)."""
    return tree_map(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf whole again from the ranks' blocks, for a checkpoint, a
    comparison or a serve."""
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), tree, specs)


def layer_specs(specs: Any) -> Any:
    """The specs of one layer of a stacked segment: each leaf's spec
    without its leading (layer) dim, which is never split."""
    return tree_map(lambda s: P(*s.dims[1:]), specs)


def split_over(spec: P, mesh) -> Tuple[str, ...]:
    """The mesh axes of size above 1 that ``spec`` splits a dim over, in
    the mesh's order."""
    named = {a for entry in spec for a in _names(entry)
             if mesh.shape[a] > 1}
    return tuple(a for a in mesh.axis_names if a in named)
