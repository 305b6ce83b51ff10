"""Decoder and encoder stacks: dense, GQA and MLA attention with a dense
or MoE feed-forward, Mamba SSM blocks, hybrid attention + SSM blocks,
and the encoder–decoder's blocks.

The JAX package's ``models/transformer.py``.  Layers are grouped into *segments*: maximal
runs of layers with one static :class:`LayerSpec`.  A segment's params
keep the JAX layout — each leaf stacked on a leading layer axis, as
``jax.vmap`` builds it — and the JAX package's ``lax.scan`` over that
axis is a Python loop here, over one ``torch.unbind`` of each stacked
leaf per segment (its backward stacks the layers' gradients once; taking
``a[i]`` per layer would allocate a zero tensor the size of the whole
stack in every layer's backward).  ``remat=True`` runs each layer under
``torch.utils.checkpoint``, as the JAX package wraps the scan body in
``jax.checkpoint``; an MoE layer's recompute there routes each token
to the experts its forward chose.  MLA configs (``cfg.mla``) take
``models/mla.py``'s attention and latent ring cache; MoE layers
``models/moe.py``'s block, whose load-balance loss ``apply_stack`` sums
over the layers; the leading dense layers of an MoE config take an FFN
of ``dense_d_ff``.  An SSM layer (``cfg.attention_free``) is
``x + ssm_block(ln1(x))`` with no FFN; a hybrid layer
(``cfg.hybrid_parallel_ssm``) runs attention and ``models/ssm.py``'s
block on the same normed input and adds the mean of the two
RMS-normed branches before its FFN.  Their decode state, ``{"h",
"conv"}``, comes from the prefill's own scan, the sharded one under
``ssm_impl="sharded"`` (the JAX package scans a second time).  An
encoder layer (``encoder_specs``) is a self-attention block without a
causal mask; a decoder layer of an encoder–decoder
(``spec.cross``) adds cross-attention over the encoder's output between
its attention and its FFN, and its decode cache holds the memory's K/V
(``"cross"``), made once by the prefill and never written at decode.

Param tree:
  {"embed": (V,D), "segments": [stacked dict], "final_norm": {...},
   "lm_head": (D,V)?, "encoder": {"segments", "final_norm"}?,
   "frontend_proj": (D,D)?}
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import GLOBAL, ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import ffn, init_ffn, init_rmsnorm, rmsnorm
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


class LayerSpec(NamedTuple):
    kind: str      # 'attn' | 'ssm' | 'hybrid'
    window: int    # GLOBAL or static window size (attn/hybrid only)
    moe: bool
    cross: bool    # decoder layer with cross-attention (enc-dec)
    causal: bool   # False for encoder self-attention


@dataclass(frozen=True)
class ModelOptions:
    """Execution options — orthogonal to the architecture config.  The
    JAX package's fields and defaults.  ``mesh`` is the port's logical
    mesh (``launch/mesh.py``): a named axis (``vocab_axis``, the model
    axis of ``chunked_sp``) is resolved on it and runs unsharded at
    size 1."""

    attn_impl: str = "chunked"          # naive | chunked | pallas
    moe_impl: str = "dense"             # dense | ep
    mesh: Any = None                     # required for moe_impl='ep'
    dp_axes: Tuple[str, ...] = ()        # mesh axes tokens are sharded over
    model_axis: str = "model"
    vocab_axis: Any = None  # mesh axis for vocab sharding ('model') or None
    ssm_impl: str = "chunked"  # chunked | sharded
    ssm_chunk: int = 256
    loss_chunk: int = 256
    block_kv: int = 512
    remat: bool = True
    decode_capacity_factor: float = 4.0
    # ring-cache capacity built by prefill; 0 -> prefill length
    prefill_cache_capacity: int = 0
    # the params' specs when each rank holds only its blocks (port only:
    # set by ``fl/round.py``'s builders from their ``in_specs``)
    param_specs: Any = None


def layer_specs(cfg: ArchConfig, *, decoder: bool = True) -> List[LayerSpec]:
    windows = cfg.layer_windows()
    moe_flags = cfg.moe_layer_flags()
    cross = decoder and cfg.encoder_layers > 0
    out = []
    for i in range(cfg.num_layers):
        if cfg.attention_free:
            out.append(LayerSpec("ssm", GLOBAL, False, False, True))
        elif cfg.hybrid_parallel_ssm:
            out.append(LayerSpec("hybrid", windows[i], moe_flags[i], cross, True))
        else:
            out.append(LayerSpec("attn", windows[i], moe_flags[i], cross, True))
    return out


def encoder_specs(cfg: ArchConfig) -> List[LayerSpec]:
    """The encoder's layers: global self-attention without a causal mask."""
    return [LayerSpec("attn", GLOBAL, False, False, False)
            for _ in range(cfg.encoder_layers)]


def segment_specs(specs: List[LayerSpec]) -> List[Tuple[int, LayerSpec]]:
    """Run-length encode consecutive identical specs."""
    segs: List[Tuple[int, LayerSpec]] = []
    for s in specs:
        if segs and segs[-1][1] == s:
            segs[-1] = (segs[-1][0] + 1, s)
        else:
            segs.append((1, s))
    return segs


def _stack(trees: List[Any]) -> Any:
    """Per-layer trees -> one tree whose leaves stack on a leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def _layer(tree: Any, i: int) -> Any:
    return tree_map(lambda a: a[i], tree)


def _layers(tree: Any) -> List[Any]:
    """A stacked tree -> one tree per layer, by one ``unbind`` a leaf."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, list(layer))
            for layer in zip(*per_leaf)]


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec,
                dtype: torch.dtype) -> dict:
    d = cfg.d_model
    p = {"ln1": init_rmsnorm(d, dtype, gen.device)}
    if spec.kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, d, dtype)
        return p
    if cfg.mla is not None:
        p["attn"] = mla_mod.init_mla(gen, cfg, dtype)
    else:
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype)
    if spec.kind == "hybrid":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, d, dtype)
        p["branch_norm_attn"] = init_rmsnorm(d, dtype, gen.device)
        p["branch_norm_ssm"] = init_rmsnorm(d, dtype, gen.device)
    if spec.cross:
        p["ln_cross"] = init_rmsnorm(d, dtype, gen.device)
        p["cross"] = attn_mod.init_attention(gen, cfg, dtype, cross=True)
    p["ln2"] = init_rmsnorm(d, dtype, gen.device)
    if spec.moe:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        d_ff = cfg.moe.dense_d_ff if cfg.moe is not None else cfg.d_ff
        p["ffn"] = init_ffn(gen, d, d_ff, dtype)
    return p


def _init_stacked(count: int, draw) -> Any:
    """``count`` trees from ``draw()``, stacked on a leading axis.  Each
    layer is copied into its slot as it is drawn and freed before the
    next, so the peak is the stack and one layer (an MoE layer of
    deepseek-v2-lite-16b holds 1.1 GB of experts)."""
    stacked = None
    for i in range(count):
        leaves, treedef = tree_flatten(draw())
        if stacked is None:
            stacked = [l.new_empty((count,) + tuple(l.shape)) for l in leaves]
        for s, l in zip(stacked, leaves):
            s[i] = l
        del leaves, l       # the layer dies here, before the next is drawn
    return tree_unflatten(treedef, stacked)


def init_stack(gen: torch.Generator, cfg: ArchConfig, specs: List[LayerSpec],
               dtype: torch.dtype) -> List[Any]:
    """-> list of stacked per-segment param trees."""
    seg_params = []
    for count, spec in segment_specs(specs):
        seg_params.append(_init_stacked(
            count, lambda: _init_block(gen, cfg, spec, dtype)))
    return seg_params


# ---------------------------------------------------------------------------
# Block apply (prefill)
# ---------------------------------------------------------------------------


def _feed_forward(cfg: ArchConfig, spec: LayerSpec, opts: ModelOptions,
                  params: dict, h2: torch.Tensor, route=None):
    """-> (y, aux): the layer's MoE block, or its dense FFN (aux None)."""
    if spec.moe:
        return moe_mod.moe_block(cfg, params["moe"], h2, impl=opts.moe_impl,
                                 mesh=opts.mesh, dp_axes=opts.dp_axes,
                                 model_axis=opts.model_axis, route=route)
    return ffn(params["ffn"], h2), None


def _apply_block(cfg: ArchConfig, spec: LayerSpec, opts: ModelOptions,
                 params: dict, x: torch.Tensor, positions: torch.Tensor,
                 memory: Optional[torch.Tensor], collect_cache: bool,
                 route=None):
    """-> (x, aux or None, cache_or_None).  ``memory``: the encoder's
    output, for a layer with cross-attention; ``route``: an MoE layer's
    ``moe.Route`` under remat."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if spec.kind == "ssm":
        y = _ssm_branch(cfg, opts, params, h, collect_cache)
        y, cache_out = y if collect_cache else (y, None)
        return x + y, None, cache_out
    if cfg.mla is not None:
        a = mla_mod.mla_attention(cfg, params["attn"], h, positions,
                                  causal=spec.causal, impl=opts.attn_impl,
                                  block_kv=opts.block_kv,
                                  model_axis=opts.model_axis, mesh=opts.mesh,
                                  return_latent=collect_cache)
    else:
        a = attn_mod.attention(cfg, params["attn"], h, positions,
                               window=spec.window, causal=spec.causal,
                               impl=opts.attn_impl, block_kv=opts.block_kv,
                               model_axis=opts.model_axis, mesh=opts.mesh,
                               return_kv=collect_cache)
    cache_out = None
    if collect_cache:
        # the cache takes what the attention just projected: the roped k
        # and v, or MLA's latent and roped key (the JAX package projects
        # them again, and XLA merges the two)
        a, kv = a
        cap = opts.prefill_cache_capacity or h.shape[1]
        cache_out = _attn_cache_from_prefill(cfg, spec, kv, cap)
    if spec.kind == "hybrid":
        s = _ssm_branch(cfg, opts, params, h, collect_cache)
        if collect_cache:
            s, cache_out["ssm"] = s
        a = _merge_branches(cfg, params, a, s)
    x = x + a
    if spec.cross:
        # plain attention over a short memory, as the JAX package
        hc = rmsnorm(params["ln_cross"], x, cfg.norm_eps)
        c = attn_mod.attention(
            cfg, params["cross"], hc, positions, memory=memory,
            impl="naive" if memory.shape[1] <= 1024 else opts.attn_impl,
            return_kv=collect_cache)
        if collect_cache:
            # the memory's K/V as the attention projected them: the
            # static cross cache (init_cross_cache's)
            c, (ck, cv) = c
            cache_out["cross"] = {"k": ck, "v": cv}
        x = x + c
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    y, aux = _feed_forward(cfg, spec, opts, params, h2, route)
    return x + y, aux, cache_out


def _ssm_branch(cfg: ArchConfig, opts: ModelOptions, params: dict,
                h: torch.Tensor, collect_cache: bool):
    """The layer's SSM block on the normed input, with the scan that
    ``opts.ssm_impl`` names; with ``collect_cache`` also its decode
    state (under ``"sharded"`` the sharded scan's final state)."""
    return ssm_mod.ssm_block(
        cfg, params["ssm"], h, chunk=opts.ssm_chunk,
        return_state=collect_cache, sharded=opts.ssm_impl == "sharded",
        dp_axes=opts.dp_axes, model_axis=opts.model_axis, mesh=opts.mesh)


def _merge_branches(cfg: ArchConfig, params: dict, a: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """A hybrid layer's mix: the mean of the RMS-normed attention and SSM
    branches."""
    return 0.5 * (rmsnorm(params["branch_norm_attn"], a, cfg.norm_eps)
                  + rmsnorm(params["branch_norm_ssm"], s, cfg.norm_eps))


def _ring_place(t: torch.Tensor, cap: int) -> torch.Tensor:
    """Scatter a (B, S, ...) sequence into a ring cache of ``cap`` slots.

    Position p lands in slot p % cap; when S > cap only the trailing
    ``cap`` positions survive (ring eviction, matching decode)."""
    B, S = t.shape[:2]
    keep = min(S, cap)
    pos_tail = torch.arange(S - keep, S, device=t.device)
    out = torch.zeros((B, cap) + tuple(t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    out[:, pos_tail % cap] = t[:, S - keep:]
    return out


def _attn_cache_from_prefill(cfg, spec, kv, cap):
    """The decode cache from the prefill's roped K/V or MLA latent."""
    if cfg.mla is not None:
        c, k_rope = kv
        return {"c": _ring_place(c, cap), "k_rope": _ring_place(k_rope, cap)}
    k, v = kv
    cap_w = cap if spec.window == GLOBAL else min(spec.window, cap)
    return {"k": _ring_place(k, cap_w), "v": _ring_place(v, cap_w)}


# ---------------------------------------------------------------------------
# Block decode
# ---------------------------------------------------------------------------


def _decode_block(cfg: ArchConfig, spec: LayerSpec, opts: ModelOptions,
                  params: dict, x: torch.Tensor, cache: dict,
                  pos: int) -> torch.Tensor:
    """One layer's decode step; writes the layer's cache in place (its
    cross cache, if any, is only read)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if spec.kind == "ssm":
        return x + ssm_mod.ssm_decode(cfg, params["ssm"], h, cache)[0]
    if cfg.mla is not None:
        a, _ = mla_mod.mla_decode(cfg, params["attn"], h, cache, pos)
    else:
        a, _ = attn_mod.attention_decode(cfg, params["attn"], h, cache, pos,
                                         window=spec.window)
    if spec.kind == "hybrid":
        s, _ = ssm_mod.ssm_decode(cfg, params["ssm"], h, cache["ssm"])
        a = _merge_branches(cfg, params, a, s)
    x = x + a
    if spec.cross:
        hc = rmsnorm(params["ln_cross"], x, cfg.norm_eps)
        x = x + attn_mod.cross_attention_decode(cfg, params["cross"], hc,
                                                cache["cross"])
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + _feed_forward(cfg, spec, opts, params, h2)[0]


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     capacity: int, dtype: torch.dtype, device,
                     memory_len: int = 0) -> dict:
    if spec.kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, cfg.d_model, batch, dtype, device)
    if cfg.mla is not None:
        c = mla_mod.init_mla_cache(cfg, batch, capacity, dtype, device)
    else:
        c = attn_mod.init_kv_cache(cfg, batch, capacity, spec.window, dtype,
                                   device)
    if spec.kind == "hybrid":
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, cfg.d_model, batch, dtype,
                                          device)
    if spec.cross:
        shape = (batch, memory_len, cfg.num_kv_heads, cfg.head_dim)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


# ---------------------------------------------------------------------------
# Stack apply
# ---------------------------------------------------------------------------


def apply_stack(cfg: ArchConfig, seg_params: List[Any],
                specs: List[LayerSpec], opts: ModelOptions, x: torch.Tensor,
                positions: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                collect_cache: bool = False, gather=None):
    """-> (x, aux (the MoE layers' load-balance losses summed; 0 without
    MoE), caches_per_segment | None).  ``memory``: the encoder's output,
    for the cross-attention layers of an encoder–decoder; ``gather``:
    one function a segment that makes a layer's leaves whole from this
    rank's blocks (``sharding/rules.py``), run inside the layer's
    checkpoint, so remat gathers again in the backward."""
    from torch.utils.checkpoint import checkpoint

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [] if collect_cache else None
    gathers = gather or [None] * len(seg_params)
    for sp, (count, spec), whole in zip(seg_params, segment_specs(specs),
                                        gathers):

        def body(layer_params, xx, route=None, spec=spec, whole=whole):
            if whole is not None:
                layer_params = whole(layer_params)
            return _apply_block(cfg, spec, opts, layer_params, xx, positions,
                                memory, collect_cache, route)

        seg_cache = []
        for layer_params in _layers(sp):
            if opts.remat:
                # the recompute in the backward takes the experts that
                # the forward chose (moe.Route)
                route = moe_mod.Route() if spec.moe else None
                x, aux, cache = checkpoint(body, layer_params, x, route,
                                           use_reentrant=False)
            else:
                x, aux, cache = body(layer_params, x)
            if aux is not None:
                aux_total = aux_total + aux
            seg_cache.append(cache)
        if collect_cache:
            caches.append(_stack(seg_cache))
    return x, aux_total, caches


def decode_stack(cfg: ArchConfig, seg_params: List[Any],
                 specs: List[LayerSpec], opts: ModelOptions,
                 x: torch.Tensor, caches: List[Any], pos: int, gather=None):
    """-> (x, caches): every segment's cache is written in place.
    ``gather``: as :func:`apply_stack`'s."""
    gathers = gather or [None] * len(seg_params)
    for sp, cache, (count, spec), whole in zip(
            seg_params, caches, segment_specs(specs), gathers):
        for i in range(count):
            layer = _layer(sp, i)
            if whole is not None:
                layer = whole(layer)
            x = _decode_block(cfg, spec, opts, layer, x, _layer(cache, i),
                              pos)
    return x, caches


def init_stack_cache(cfg: ArchConfig, specs: List[LayerSpec], batch: int,
                     capacity: int, dtype: torch.dtype, device,
                     memory_len: int = 0) -> List[Any]:
    """Empty decode caches; a cross-attention layer's holds ``memory_len``
    rows of the memory's K/V."""
    caches = []
    for count, spec in segment_specs(specs):
        one = init_block_cache(cfg, spec, batch, capacity, dtype, device,
                               memory_len)
        caches.append(tree_map(
            lambda a: a.expand((count,) + tuple(a.shape)).clone(), one))
    return caches
