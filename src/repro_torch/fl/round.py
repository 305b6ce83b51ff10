"""The fused FL round, the JAX package's ``fl/round.py`` (train steps).

One fused round:

  1. cohort updates — each microbatch of client data gives one model
     update u_i = ∇loss (``torch.autograd.grad``).
  2. timing — "eager": u_i folded into a running fp32 accumulator, in
     place, the moment it exists (O(1) update memory); "lazy": all u_i
     stacked, reduced once with the weights (O(n) queue memory).
  3. hierarchy — "hierarchical": one delta per pod crosses the top
     aggregator hop, int8 on the wire when ``compress="int8"``; "flat":
     one mean over the whole batch (the no-hierarchy baseline).
  4. the server optimizer applies the aggregated delta.

The step runs in one process or with one process a mesh coordinate
(``launch/dist.py``, ``launch/mesh.py``):

* In one process the pod axis runs pod after pod, as the JAX package's
  ``hier_step_legacy`` does (contiguous batch slices, each pod's delta
  passed through ``fake_quantize_tree``, the quantize and dequantize
  kernels, when compressing), but folded into a running fp32 sum in the
  order of the JAX ring's pod-0 copy, ``d0 + d[P-1] + ... + d1``
  (``pod_mean_compressed``): only one pod's delta is alive beside the
  sum, and the int8 round has the ring's bits.
* Across ranks each rank takes its pod's slice and, within each
  microbatch of it, its data coordinate's block of rows (the JAX
  package splits the pod batch into microbatches first, and the
  ``data`` axis shards each microbatch).  Each data rank is a cohort
  weighted by its valid-token count; one all-reduce over the data group
  (the intra-pod leaf tier) gives the pod's Σw·u and Σw, then the pod
  tier's ``pod_mean`` or ``pod_mean_compressed`` crosses the pods (the
  top aggregator, the only hop between pods) and every rank applies the
  server optimizer to the same bits.  Flat is one all-reduce over
  (pod, data) and no pod hop.
* A ``model`` axis above 1 shards the model's regions (context-parallel
  flash, the vocab-sharded embedding and loss, expert-parallel MoE)
  over the ranks of one (pod, data) coordinate, which take the same
  rows.  Each rank's gradient is then its *part* (``launch/dist.py``):
  the model group's first rank seeds the loss's cotangent, the others
  seed 0, and the regions' collectives carry the rest, so the parts sum
  to the one-device gradient.  The data tier's one all-reduce runs over
  (data, model), and so sums the parts too; the weights and CE sums
  enter it from the model group's first rank only.  Every rank of the
  group gets the same bits from it.
* An MoE microbatch split over data ranks takes its load-balance loss
  over the whole microbatch (``models/moe.py``): its gradient reaches
  each rank through the sum in the forward, so each rank seeds its
  loss's cotangent with its weight w instead of multiplying its
  gradient by w after (``_Part``), and the ranks' terms add up to the
  weight of the whole microbatch.

Sidecar metrics (loss, update norm, aggregate weight, updates folded)
are computed in the step.

The serving steps (``build_prefill_step``, ``build_decode_step``) take
the JAX package's options on the same mesh: across ranks a rank serves
its (pod, data) coordinate's rows, and the ranks of a model group split
the regions as the train step does and return the same bits.

Sharded storage (FSDP over the batch axes, TP storage over ``model``):
the builders take ``in_specs``, the specs of :func:`train_shardings` or
:func:`serve_shardings`, as ``jax.jit`` takes ``in_shardings``.  Each
rank then holds and is called with only its block of each param and
server-state leaf (``sharding.shard_tree``) and returns its blocks.  The
model gathers each leaf whole where it is used (a layer's inside the
layer's checkpoint, so remat gathers it again in the backward; the
top-level leaves at the start of the forward), and the gather's adjoint
sums the gradient over the ranks of the gathered axes and keeps this
rank's block.  So in the train step:

* the gradient of a leaf gathered over a batch axis is summed over the
  data ranks *before* the fold weights it, so every microbatch seeds
  its loss's cotangent with its weight w (``_Part(weighted=True)``);
* the leaf tier's all-reduce sums each leaf only over the tier's axes
  its spec does not split (none for a leaf split over all of them);
  the weights and CE sums take the whole tier as before;
* the pod tier and the server optimizer run on the blocks (the int8
  hop's blocks are the whole leaf's where a shard's last axis is
  unsplit or a multiple of 256), and the update norm sums its squares
  over the ranks of each leaf's split axes;
* a bf16 leaf's gradient summed over the data ranks is rounded to bf16
  once by the adjoint, where the replicated round sums in fp32.

Without ``in_specs`` every step is the replicated one.  The dry-run
helpers (:func:`abstract_params`, :func:`input_specs`,
:func:`abstract_caches`) build meta tensors: shapes and dtypes, no
allocation.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from itertools import zip_longest
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.fl import compression
from repro_torch.fl.server import apply_server_opt, init_server_state
from repro_torch.launch.mesh import dp_axes as mesh_dp_axes
from repro_torch.launch.mesh import pod_axis as mesh_pod_axis
from repro_torch.models import build_model
from repro_torch.models.transformer import ModelOptions
from repro_torch.sharding.rules import (divisibility_fix, param_specs,
                                        split_over)
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


@dataclass(frozen=True)
class AggregationConfig:
    """LIFL aggregation knobs (the paper's C1/C9 + beyond-paper compress)."""

    hierarchy: str = "hierarchical"  # 'hierarchical' | 'flat'
    timing: str = "eager"            # 'eager' | 'lazy'
    compress: str = "none"           # 'none' | 'int8'
    num_microbatches: int = 4        # model updates arriving per pod per round
    server_opt: str = "fedavg"
    server_lr: float = 1.0
    acc_dtype: str = "float32"       # eager-accumulator dtype


# ---------------------------------------------------------------------------
# microbatch update accumulation (eager vs lazy)
# ---------------------------------------------------------------------------


def _split_micro(batch: Dict[str, torch.Tensor],
                 n: int) -> Dict[str, torch.Tensor]:
    def f(x):
        b = x.shape[0]
        assert b % n == 0, (f"global batch {b} not divisible by {n} "
                            "microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    return {k: f(v) for k, v in batch.items()}


@dataclass(frozen=True)
class _Part:
    """A rank's share of each microbatch's gradient (module docstring).
    ``own``: the rank seeds the loss's cotangent (else 0: a model rank
    after the first); ``weighted``: the seed is the microbatch's weight
    w, and the gradient comes out already weighted (else the seed is 1
    and the gradient is multiplied by w)."""

    own: bool = True
    weighted: bool = False


_WHOLE = _Part()


def _cohort_update(model, params, mb, part: _Part = _WHOLE):
    """One arriving model update: (grads in the params' leaf order and
    dtypes, weight, loss); with ``part.weighted`` the grads are w times
    the update."""
    leaves, treedef = tree_flatten(params)
    weight = (mb["labels"] >= 0).float().sum()
    with torch.enable_grad():
        live = [l.detach().requires_grad_() for l in leaves]
        loss, _ = model.loss(tree_unflatten(treedef, live), mb)
        seed = None
        if part != _WHOLE:
            seed = (weight if part.weighted else torch.ones_like(loss)) \
                * float(part.own)
        grads = torch.autograd.grad(loss, live, grad_outputs=seed)
    return list(grads), weight, loss.detach()


def _accumulate(model, params, batch, agg: AggregationConfig,
                part: _Part = _WHOLE):
    """-> (the accumulator Σ w_i·u_i as fp32 leaves, the params' treedef,
    each microbatch's weight w_i and loss, the sums of both)."""
    micro = _split_micro(batch, agg.num_microbatches)
    leaves, treedef = tree_flatten(params)
    n = agg.num_microbatches
    mbs = [{k: v[i] for k, v in micro.items()} for i in range(n)]
    ws, losses = [], []

    if agg.timing == "eager":
        # fold each arriving update into the accumulator in place
        acc = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
               for l in leaves]
        wsum = loss_sum = torch.zeros((), device=leaves[0].device)
        for mb in mbs:
            g, w, loss = _cohort_update(model, params, mb, part)
            for a, gg in zip(acc, g):
                a.add_(gg.float() if part.weighted else gg.float().mul_(w))
            del g
            wsum, loss_sum = wsum + w, loss_sum + loss
            ws.append(w)
            losses.append(loss)
    else:
        # lazy: queue every update, reduce at the aggregation goal
        gs = []
        for mb in mbs:
            g, w, loss = _cohort_update(model, params, mb, part)
            gs.append([gg.float() for gg in g])
            ws.append(w)
            losses.append(loss)
        w_vec = torch.stack(ws)
        mult = torch.ones_like(w_vec) if part.weighted else w_vec
        acc = [torch.tensordot(mult, torch.stack(col), dims=1)
               for col in zip(*gs)]
        del gs
        wsum, loss_sum = w_vec.sum(), torch.stack(losses).sum()
    return acc, treedef, ws, losses, wsum, loss_sum


def accumulate_updates(model, params, batch, agg: AggregationConfig):
    """-> (delta = weighted-mean update (fp32 tree), total_weight, loss)."""
    acc, treedef, _, _, wsum, loss_sum = _accumulate(model, params, batch,
                                                     agg)
    # in place: the accumulator becomes the delta
    denom = torch.clamp_min(wsum, 1.0)
    delta = [a.div_(denom) for a in acc]
    return (tree_unflatten(treedef, delta), wsum,
            loss_sum / agg.num_microbatches)


# ---------------------------------------------------------------------------
# train step builders
# ---------------------------------------------------------------------------


def _metrics(sq, wsum, loss, n_updates):
    """The sidecar's metrics, computed with the aggregation event
    (``sq``: the update's squared norm, :func:`_block_sq`)."""
    return {
        "loss": loss,
        "update_norm": torch.sqrt(sq),
        "aggregate_weight": wsum,
        "updates_aggregated": n_updates,
    }


def train_options(cfg: ArchConfig, mesh, agg: AggregationConfig
                  ) -> ModelOptions:
    """The options ``build_train_step`` trains with when it is given
    none: the JAX package's (``chunked_sp`` flash, ep for an MoE config,
    the sharded SSM scan, vocab over the model axis) on ``mesh``."""
    dp = mesh_dp_axes(mesh)
    pod = mesh_pod_axis(mesh)
    return ModelOptions(
        attn_impl="chunked_sp",
        moe_impl="ep" if cfg.moe is not None else "dense",
        ssm_impl="sharded",
        dp_axes=dp if (agg.hierarchy == "flat" or pod is None) else ("data",),
        model_axis="model",
        vocab_axis="model",
        mesh=mesh,
    )


def build_train_step(cfg: ArchConfig, mesh, agg: AggregationConfig,
                     opts: Optional[ModelOptions] = None, in_specs=None):
    """-> (train_step(params, server_state, batch) -> (params', state',
    metrics), model).  ``mesh`` is the port's logical mesh
    (``launch/mesh.py``): in one process, or over ranks, where every
    rank calls the step with the same params and the whole batch and
    takes its own rows.  ``opts`` default to :func:`train_options`.  An
    MoE config trains with ``moe_impl="ep"`` by default, its capacity
    taken per microbatch as the JAX package's per-pod body takes it.  A
    batch may carry a frontend config's ``"frontend"`` (B, F, d_model);
    every key is split by pod and microbatch with the tokens.
    ``in_specs``: (param specs, server-state specs), as
    :func:`train_shardings` gives them, for a mesh over ranks: each rank
    is called with its blocks of the params and the state and returns
    its blocks (module docstring); the batch stays whole."""
    pod = mesh_pod_axis(mesh)
    opts = _hold_blocks(opts or train_options(cfg, mesh, agg), mesh,
                        in_specs and in_specs[0])
    model = build_model(cfg, opts)
    if mesh.distributed:
        return _rank_step(model, mesh, agg), model

    def flat_step(params, server_state, batch):
        delta, wsum, loss = accumulate_updates(model, params, batch, agg)
        new_params, new_state = apply_server_opt(
            agg.server_opt, params, server_state, delta, lr=agg.server_lr)
        return new_params, new_state, _metrics(
            _block_sq(delta), wsum, loss, agg.num_microbatches)

    if pod is None or agg.hierarchy == "flat":
        return flat_step, model

    def hier_step(params, server_state, batch):
        n_pods = mesh.shape[pod]
        pod_sum = wsum = loss = None
        # the ring's pod-0 order: pod 0, then P - 1 down to 1
        for i in (0, *range(n_pods - 1, 0, -1)):
            b_i = {k: _pod_slice(v, i, n_pods) for k, v in batch.items()}
            d, w, l = accumulate_updates(model, params, b_i, agg)
            if agg.compress == "int8":
                d = compression.fake_quantize_tree(d)  # wire precision
            if pod_sum is None:
                pod_sum, wsum, loss = tree_leaves(d), w, l
            else:
                for s, x in zip(pod_sum, tree_leaves(d)):
                    s.add_(x)
                wsum, loss = wsum + w, loss + l
            del d
        _, treedef = tree_flatten(params)
        delta = tree_unflatten(treedef, [s.div_(n_pods) for s in pod_sum])
        new_params, new_state = apply_server_opt(
            agg.server_opt, params, server_state, delta, lr=agg.server_lr)
        return new_params, new_state, _metrics(
            _block_sq(delta), wsum, loss / n_pods,
            agg.num_microbatches * n_pods)

    return hier_step, model


def _hold_blocks(opts: ModelOptions, mesh, specs) -> ModelOptions:
    """``opts`` for a model whose params arrive as this rank's blocks of
    ``specs``."""
    if specs is None:
        return opts
    if not mesh.distributed:
        raise ValueError("in_specs name storage across ranks: build the "
                         "mesh with make_debug_mesh in ranks started by "
                         "launch.dist.spawn_ranks")
    return dataclasses.replace(opts, param_specs=specs)


def _rank_step(model, mesh, agg: AggregationConfig):
    """The step of one rank of a mesh over ranks (module docstring)."""
    pod = mesh_pod_axis(mesh)
    hier = pod is not None and agg.hierarchy != "flat"
    n = agg.num_microbatches
    split = mesh.shape.get("data", 1) if hier else \
        mesh.shape.get("data", 1) * mesh.shape.get(pod, 1)
    own = mesh.coord("model") == 0
    tier_axes = tuple(a for a in mesh.axis_names if a in (
        ("data",) if hier else mesh_dp_axes(mesh)) + ("model",))
    # the axes each leaf is split over (none without sharded storage)
    splits = [split_over(s, mesh)
              for s in tree_leaves(model.opts.param_specs or {})]
    if hier and any(pod in s for s in splits):
        raise ValueError("a hierarchical round's pod tier averages whole "
                         "leaves across pods: no leaf may be split over "
                         f"{pod!r} (fsdp=('data',))")
    over_batch = any(a in s for s in splits for a in mesh_dp_axes(mesh))
    part = _Part(own=own, weighted=over_batch or (
        model.cfg.moe is not None and split > 1))

    def rank_step(params, server_state, batch):
        rows = {k: _rank_rows(v, mesh, n, hier) for k, v in batch.items()}
        acc, treedef, ws, losses, _, _ = _accumulate(model, params, rows,
                                                     agg, part)
        # the leaf tier: one all-reduce of Σw·u (the model group's parts
        # with it), the weights and the CE sums of each microbatch over
        # the ranks that share it, counted once a model group
        stats = torch.stack([*ws, *(w * l for w, l in zip(ws, losses))])
        if not own:
            stats.zero_()
        # each leaf over the tier's axes its blocks are not split over
        # (the gathers' adjoints summed the rest); the stats over all
        buckets = {}
        for a, s in zip_longest(acc, splits, fillvalue=()):
            buckets.setdefault(tuple(x for x in tier_axes if x not in s),
                               []).append(a)
        buckets.setdefault(tier_axes, []).append(stats)
        for axes, ts in buckets.items():
            mesh.wire.all_reduce(ts, mesh.group(*axes),
                                 "data_all_reduce" if hier else "all_reduce")
        counts, ce = stats[:n], stats[n:]
        wsum = counts.sum()
        loss = (ce / torch.clamp_min(counts, 1.0)).sum() / n
        denom = torch.clamp_min(wsum, 1.0)
        delta = tree_unflatten(treedef, [a.div_(denom) for a in acc])
        n_updates = n
        if hier:
            # the top aggregator: the only hop between pods
            if agg.compress == "int8":
                delta = compression.pod_mean_compressed(delta, pod,
                                                        mesh=mesh)
            else:
                delta = compression.pod_mean(delta, pod, mesh=mesh)
            n_pods = mesh.shape[pod]
            pair = torch.stack([wsum, loss])
            mesh.wire.all_reduce([pair], mesh.group(pod), "pod_all_reduce")
            wsum, loss = pair[0], pair[1] / n_pods
            n_updates = n * n_pods
        new_params, new_state = apply_server_opt(
            agg.server_opt, params, server_state, delta, lr=agg.server_lr)
        return new_params, new_state, _metrics(
            _block_sq(delta, splits, mesh), wsum, loss, n_updates)

    return rank_step


def _block_sq(delta, splits=(), mesh=None) -> torch.Tensor:
    """The update's squared norm from this rank's blocks: each leaf's
    squares summed over the ranks of its split axes (one all-reduce a
    set of axes; ``splits`` shorter than the leaves: the rest unsplit)."""
    sums = {}
    for leaf, s in zip_longest(tree_leaves(delta), splits, fillvalue=()):
        sums[s] = sums.get(s, 0) + torch.sum(torch.square(leaf.float()))
    total = 0
    for s, sq in sums.items():
        if s:
            mesh.wire.all_reduce([sq], mesh.group(*s),
                                 "_".join(s) + "_norm")
        total = total + sq
    return total


def _rank_rows(x: torch.Tensor, mesh, n: int, hier: bool) -> torch.Tensor:
    """This rank's rows of a global batch tensor, microbatch by
    microbatch: hierarchical, its pod's contiguous slice, split into
    ``n`` microbatches, and of each the block of its data coordinate;
    flat, of each microbatch of the whole batch the block of its
    (pod, data) coordinate.  The batch must split into P·n·D blocks."""
    n_pods, n_data = mesh.shape.get("pod", 1), mesh.shape.get("data", 1)
    if x.shape[0] % (n_pods * n * n_data):
        raise ValueError(f"global batch {x.shape[0]} does not split into "
                         f"{n_pods} pods x {n} microbatches x {n_data} "
                         "data ranks")
    if hier:
        x = _pod_slice(x, mesh.coord("pod"), n_pods)
        blocks, at = n_data, mesh.coord("data")
    else:
        blocks = n_pods * n_data
        at = mesh.coord("pod") * n_data + mesh.coord("data")
    micro = x.reshape(n, -1, *x.shape[1:])
    k = micro.shape[1] // blocks
    return micro[:, at * k:(at + 1) * k].reshape(n * k, *x.shape[1:])


def _pod_slice(x: torch.Tensor, i: int, n_pods: int) -> torch.Tensor:
    """Pod ``i``'s contiguous slice of the batch; the batch must split
    evenly across pods."""
    assert x.shape[0] % n_pods == 0, (
        f"global batch {x.shape[0]} not divisible by {n_pods} pods")
    b = x.shape[0] // n_pods
    return x[i * b:(i + 1) * b]


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def serve_options(cfg: ArchConfig, mesh, prefill: bool = True
                  ) -> ModelOptions:
    """The options the serving steps take when given none: the JAX
    package's on ``mesh``.  The prefill's are ``chunked_sp`` attention
    and the sharded SSM scan; the decode's leave both at their defaults
    (a decode step reads neither).  Both take ep for an MoE config and
    the vocab over the model axis, with the batch over the (pod, data)
    axes."""
    over = dict(attn_impl="chunked_sp", ssm_impl="sharded") if prefill \
        else {}
    return ModelOptions(
        moe_impl="ep" if cfg.moe is not None else "dense",
        dp_axes=mesh_dp_axes(mesh), model_axis="model", vocab_axis="model",
        mesh=mesh, **over)


def serve_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rows of a whole serving batch that this rank serves: the
    block of its (pod, data) coordinate, row-major, among P·D equal
    blocks (the whole batch in one process)."""
    if not mesh.distributed:
        return x
    blocks = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    if x.shape[0] % blocks:
        raise ValueError(f"a serving batch of {x.shape[0]} does not split "
                         f"into {blocks} (pod, data) blocks")
    at = mesh.coord("pod") * mesh.shape.get("data", 1) + mesh.coord("data")
    k = x.shape[0] // blocks
    return x[at * k:(at + 1) * k]


def build_prefill_step(cfg: ArchConfig, mesh,
                       opts: Optional[ModelOptions] = None, in_specs=None):
    """-> (prefill_step(params, batch) -> (logits (B_r, 1, V) fp32 of the
    last position, caches), model); ``opts`` default to
    :func:`serve_options`.  ``batch`` is the whole ``{"tokens",
    "frontend"?}``, the same on every rank; a rank serves its (pod,
    data) rows (:func:`serve_rows`) and returns their logits and decode
    caches.  On a model axis the prefill's attention, SSM scan, experts
    and logits are split over the model group, whose ranks return the
    same bits; each SSM layer's cache holds the whole gathered state.
    ``in_specs``: :func:`serve_shardings`' param specs, for a mesh over
    ranks: each rank is called with its blocks of the params."""
    model = build_model(cfg, _hold_blocks(
        opts or serve_options(cfg, mesh, prefill=True), mesh, in_specs))

    def prefill_step(params, batch):
        return model.prefill(params, {k: serve_rows(v, mesh)
                                      for k, v in batch.items()})

    return prefill_step, model


def build_decode_step(cfg: ArchConfig, mesh,
                      opts: Optional[ModelOptions] = None, in_specs=None):
    """-> (decode_step(params, tokens, caches, pos) -> (logits (B_r, 1, V)
    fp32, caches written in place), model); ``opts`` default to
    :func:`serve_options`.  ``tokens`` (B_r, 1) are this rank's rows, as
    its prefill's logits pick them, and ``caches`` its prefill's.  On a
    model axis attention and the SSM step run replicated, ep splits the
    experts over the model group at the reference's capacity (drops
    included), and the logits are gathered over the vocab shards
    (``sharded_vocab.decode_logits``): every rank of the group returns
    the same bits.  ``in_specs``: as :func:`build_prefill_step`'s; the
    caches stay whole over the model axis (the JAX dry run's cache
    specs split their capacity over it, which the port's decode
    attention does not)."""
    model = build_model(cfg, _hold_blocks(
        opts or serve_options(cfg, mesh, prefill=False), mesh, in_specs))
    return model.decode_step, model


# ---------------------------------------------------------------------------
# abstract inputs + shardings (dry-run contract)
# ---------------------------------------------------------------------------


def abstract_params(model) -> Any:
    """The param tree on the meta device: shapes and dtypes, no
    allocation (full-size kimi-k2-1t-a32b in well under a second)."""
    return model.init(0, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta stand-ins for every model input of a cell.

    train:   {"tokens","labels"[,"frontend"]}   (global_batch, seq)
    prefill: {"tokens"[,"frontend"]}
    decode:  {"tokens": (B,1), "pos": scalar}  (+ caches built separately)
    """
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["tokens"] = meta((B, S))
        out["labels"] = meta((B, S))
    elif shape.kind == "prefill":
        out["tokens"] = meta((B, S))
    else:  # decode
        out["tokens"] = meta((B, 1))
        out["pos"] = meta(())
    if cfg.frontend and shape.kind in ("train", "prefill"):
        out["frontend"] = meta((B, cfg.frontend_tokens, cfg.d_model),
                               getattr(torch, cfg.dtype))
    return out


def abstract_caches(model, shape: ShapeConfig):
    """The decode caches of a cell on the meta device."""
    return model.init_decode(shape.global_batch, shape.seq_len,
                             device="meta")


def train_shardings(model, mesh, agg: AggregationConfig, fsdp=None):
    """-> (param specs, server-state specs) of a train step: TP over
    ``model`` and FSDP over ``fsdp`` (default: the batch axes of a flat
    round, ``("data",)`` of a hierarchical one), each dim that does not
    divide left unsplit."""
    dp = mesh_dp_axes(mesh)
    if fsdp is None:
        fsdp = dp if agg.hierarchy == "flat" else ("data",)
    aparams = abstract_params(model)
    pspecs = divisibility_fix(param_specs(aparams, fsdp=fsdp), aparams, mesh)
    state = init_server_state(agg.server_opt, aparams)
    sspecs = divisibility_fix(param_specs(state, fsdp=fsdp), state, mesh)
    return pspecs, sspecs


def serve_shardings(model, mesh, fsdp=("data",)):
    aparams = abstract_params(model)
    return divisibility_fix(param_specs(aparams, fsdp=fsdp), aparams, mesh)
