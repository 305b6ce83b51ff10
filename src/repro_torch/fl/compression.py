"""Update compression for the slow (inter-pod) tier: per-block int8
quantization with fp32 scales, the JAX package's ``fl/compression.py``.

Every quantization here goes through ``kernels/quantize/ops.py``: on the
card the hand-written quantize and dequantize kernels, on the CPU their
plain versions.  The results are the JAX module's under ``jit``, bit for
bit (a CPU test holds them so; see ``kernels/quantize/ref.py`` for the
scale's rounding):

* ``quantize_leaf`` returns scale 0 for an all-zero block, where the
  kernel writes 1.  A block's amax is 0 exactly when all its ``q`` are
  0 (any other block holds an element at ±127), so the leaf's scale is
  the kernel's where some ``q`` is not 0, and 0 elsewhere.
* ``_quantize_blocks_last_axis`` blocks along the last axis with width
  ``min(256, last)``, zero-pads the last axis to whole blocks, and hands
  the kernel one row per block.

``pod_mean`` and ``pod_mean_compressed`` are collectives across pods
(inside a manual-``pod`` region of the JAX package); on one card the
fused round runs the pods in turn and calls :func:`fake_quantize_tree`
instead.  They are refused by name (ROADMAP A.8).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import ops as qops
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

BLOCK = 256


def quantize_leaf(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """-> (q int8 (n_blocks, block), scales fp32 (n_blocks,), orig_size)."""
    n = x.numel()
    q, safe = qops.quantize(x.reshape(-1), block=block)
    scale = torch.where((q != 0).any(dim=1), safe, 0.0)
    return q, scale, n


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, n: int, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    flat = qops.dequantize(q, scale, n)
    return flat.reshape(shape).to(dtype)


def quantize_tree(tree: Any, block: int = BLOCK):
    leaves, treedef = tree_flatten(tree)
    qs = [quantize_leaf(l, block) for l in leaves]
    meta = [(tuple(l.shape), l.dtype) for l in leaves]
    return ([(q, s) for q, s, _ in qs],
            [(n, m) for (_, _, n), m in zip(qs, meta)], treedef)


def dequantize_tree(qs, meta, treedef, block: int = BLOCK):
    leaves = [dequantize_leaf(q, s, n, shape, dtype)
              for (q, s), (n, (shape, dtype)) in zip(qs, meta)]
    return tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# the cross-pod hop's wire precision (the LIFL "top aggregator" hop)
# ---------------------------------------------------------------------------


def _quantize_blocks_last_axis(x: torch.Tensor, block: int):
    """Shape-preserving int8 block quantization along the last axis.
    Returns (q int8 (..., nb, b), safe fp32 scales (..., nb), original
    last-axis length); the kernel sees the blocks as (rows · nb, b)."""
    xf = x if x.dim() else x[None]
    last = xf.shape[-1]
    b = min(block, last)
    nb = -(-last // b)
    if nb * b != last:
        xf = F.pad(xf, (0, nb * b - last))
    lead = tuple(xf.shape[:-1])
    q, safe = qops.quantize(xf.reshape(-1), block=b)
    return q.reshape(*lead, nb, b), safe.reshape(*lead, nb), last


def fake_quantize_tree(delta: Any, block: int = BLOCK) -> Any:
    """Local int8 quantize -> dequantize roundtrip per leaf: the wire
    precision of the cross-pod hop without its collectives, blocks along
    the last axis as on the wire."""

    def leaf(x):
        q, safe, last = _quantize_blocks_last_axis(x, block)
        deq = qops.dequantize(q.reshape(-1, q.shape[-1]), safe.reshape(-1),
                              q.numel(), out_dtype=_wire_dtype(x.dtype))
        deq = deq.reshape(*q.shape[:-2], q.shape[-2] * q.shape[-1])
        return deq[..., :last].reshape(x.shape).to(x.dtype)

    return tree_map(leaf, delta)


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dequantize kernel writes fp32 or bf16 itself (the product
    rounded once, as the JAX package's cast of it); any other dtype is
    cast from fp32."""
    return dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32


def pod_mean(delta: Any, pod_axis: str) -> Any:
    raise NotImplementedError(
        "pod_mean: a collective across pods; on one card the fused round "
        "runs the pods in turn (ROADMAP A.8)")


def pod_mean_compressed(delta: Any, pod_axis: str, block: int = BLOCK) -> Any:
    raise NotImplementedError(
        "pod_mean_compressed: a collective across pods; on one card the "
        "fused round runs the pods in turn with fake_quantize_tree "
        "(ROADMAP A.8)")
