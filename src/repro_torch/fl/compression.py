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

``pod_mean`` and ``pod_mean_compressed`` are the collectives of the
pod tier (inside a manual-``pod`` region of the JAX package).  The port
has no ambient axis: they take the mesh (``mesh=``), a mesh over ranks
(``launch/mesh.py``), and move their tensors through its
:class:`~repro_torch.launch.dist.Wire`.  A fused round in one process
runs the pods in turn and calls :func:`fake_quantize_tree` instead.
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


def pod_mean(delta: Any, pod_axis: str, *, mesh) -> Any:
    """Uncompressed cross-pod mean (the paper-faithful baseline): an
    all-reduce sum over the pod group, divided by P (the JAX package's
    ``pmean``), in place on ``delta``'s leaves."""
    n_pods = _pod_count(mesh, pod_axis)
    leaves, treedef = tree_flatten(delta)
    if n_pods > 1:
        mesh.wire.all_reduce(leaves, mesh.group(pod_axis), "pod_all_reduce")
    return tree_unflatten(treedef, [l.div_(n_pods) for l in leaves])


def pod_mean_compressed(delta: Any, pod_axis: str, block: int = BLOCK, *,
                        mesh) -> Any:
    """Mean over the pod axis moving int8 on the wire: the JAX package's
    ring of P − 1 hops of the local int8 blocks and fp32 scales.

    Each leaf is quantized along its last axis (the quantize kernel on
    the card), its blocks go round the ring (:func:`_ring_gather`), and
    every pod's blocks are dequantized into fp32 (the dequantize kernel)
    and summed.  The JAX ring sums in another order on each pod, and the
    host reads pod 0's copy, ``d0 + d[P-1] + d[P-2] + ... + d1``; here
    every rank sums in that order, so all ranks hold the same bits and
    the replicated params never drift apart.  Then divide by P, crop the
    padding and cast, as the JAX package does."""
    n_pods = _pod_count(mesh, pod_axis)

    def leaf(x):
        q, safe, last = _quantize_blocks_last_axis(x, block)
        padded_shape = q.shape[:-2] + (q.shape[-2] * q.shape[-1],)
        pods = _ring_gather(q, safe, mesh, pod_axis, hops=n_pods - 1)
        acc = None
        for qp, sp in (pods[0], *pods[:0:-1]):
            deq = qops.dequantize(qp.reshape(-1, qp.shape[-1]),
                                  sp.reshape(-1), qp.numel())
            acc = deq if acc is None else acc.add_(deq)
        out = acc.div_(n_pods).reshape(padded_shape)[..., :last]
        return out.reshape(x.shape).to(x.dtype)

    return tree_map(leaf, delta)


def _pod_count(mesh, pod_axis: str) -> int:
    n_pods = mesh.shape[pod_axis]
    if n_pods > 1 and not mesh.distributed:
        raise ValueError(
            f"a collective over the {pod_axis!r} axis needs a mesh over "
            "ranks (launch.dist.spawn_ranks, then make_debug_mesh); in one "
            "process the fused round runs the pods in turn")
    return n_pods


def _ring_gather(q: torch.Tensor, scales: torch.Tensor, mesh,
                 pod_axis: str, hops: int):
    """Every pod's (q, scales) on every rank, by pod: ``hops`` hops of a
    ring, each sending to pod + 1 what arrived from pod − 1 at the hop
    before (this rank's own blocks at the first).  A pod that no hop
    reached stays all zeros."""
    n_pods, me = mesh.shape[pod_axis], mesh.coord(pod_axis)
    pods = [(torch.zeros_like(q), torch.zeros_like(scales))
            for _ in range(n_pods)]
    pods[me] = (q, scales)
    dst, src = mesh.rank_at(**{pod_axis: me + 1}), \
        mesh.rank_at(**{pod_axis: me - 1})
    for k in range(1, hops + 1):
        mesh.wire.exchange(pods[(me - k + 1) % n_pods],
                           pods[(me - k) % n_pods], dst, src,
                           mesh.group(pod_axis), "pod_hop")
    return pods
