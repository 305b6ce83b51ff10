"""Decoder stack for the dense attention-only archs.

The JAX package's ``models/transformer.py`` for ``kind="attn"`` blocks
without MoE or cross-attention.  Layers are grouped into *segments*:
maximal runs of layers with one static :class:`LayerSpec`.  A segment's
params keep the JAX layout — each leaf stacked on a leading layer axis,
as ``jax.vmap`` builds it — and the JAX package's ``lax.scan`` over that
axis is a Python loop here, over one ``torch.unbind`` of each stacked
leaf per segment (its backward stacks the layers' gradients once; taking
``a[i]`` per layer would allocate a zero tensor the size of the whole
stack in every layer's backward).  ``remat=True`` runs each layer under
``torch.utils.checkpoint``, as the JAX package wraps the scan body in
``jax.checkpoint``.  SSM, MLA, MoE and hybrid blocks are refused by
name.

Param tree:
  {"embed": (V,D), "segments": [stacked dict], "final_norm": {...},
   "lm_head": (D,V)?}
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import GLOBAL, ArchConfig
from repro_torch.models import attention as attn_mod
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


def layer_specs(cfg: ArchConfig) -> List[LayerSpec]:
    windows = cfg.layer_windows()
    moe_flags = cfg.moe_layer_flags()
    cross = cfg.encoder_layers > 0
    out = []
    for i in range(cfg.num_layers):
        if cfg.attention_free:
            out.append(LayerSpec("ssm", GLOBAL, False, False, True))
        elif cfg.hybrid_parallel_ssm:
            out.append(LayerSpec("hybrid", windows[i], moe_flags[i], cross, True))
        else:
            out.append(LayerSpec("attn", windows[i], moe_flags[i], cross, True))
    return out


def segment_specs(specs: List[LayerSpec]) -> List[Tuple[int, LayerSpec]]:
    """Run-length encode consecutive identical specs."""
    segs: List[Tuple[int, LayerSpec]] = []
    for s in specs:
        if segs and segs[-1][1] == s:
            segs[-1] = (segs[-1][0] + 1, s)
        else:
            segs.append((1, s))
    return segs


def check_block(cfg: ArchConfig, spec: LayerSpec) -> None:
    """Refuse, naming its ROADMAP item, a block the port does not run."""
    what = None
    if spec.kind == "ssm":
        what = "SSM (Mamba) blocks"
    elif spec.kind == "hybrid":
        what = "hybrid attention + SSM blocks"
    elif cfg.mla is not None:
        what = "MLA attention"
    elif spec.moe:
        what = "MoE blocks"
    elif spec.cross:
        what = "cross-attention (enc-dec) blocks"
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} are not ported yet "
                                  "(ROADMAP A.6)")


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
    d_ff = cfg.moe.dense_d_ff if cfg.moe is not None else cfg.d_ff
    return {
        "ln1": init_rmsnorm(d, dtype, gen.device),
        "attn": attn_mod.init_attention(gen, cfg, dtype),
        "ln2": init_rmsnorm(d, dtype, gen.device),
        "ffn": init_ffn(gen, d, d_ff, dtype),
    }


def init_stack(gen: torch.Generator, cfg: ArchConfig, specs: List[LayerSpec],
               dtype: torch.dtype) -> List[Any]:
    """-> list of stacked per-segment param trees."""
    seg_params = []
    for count, spec in segment_specs(specs):
        check_block(cfg, spec)
        seg_params.append(
            _stack([_init_block(gen, cfg, spec, dtype) for _ in range(count)]))
    return seg_params


# ---------------------------------------------------------------------------
# Block apply (prefill)
# ---------------------------------------------------------------------------


def _apply_block(cfg: ArchConfig, spec: LayerSpec, opts: ModelOptions,
                 params: dict, x: torch.Tensor, positions: torch.Tensor,
                 collect_cache: bool):
    """-> (x, cache_or_None)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a = attn_mod.attention(cfg, params["attn"], h, positions,
                           window=spec.window, causal=spec.causal,
                           impl=opts.attn_impl, block_kv=opts.block_kv,
                           model_axis=opts.model_axis, mesh=opts.mesh,
                           return_kv=collect_cache)
    cache_out = None
    if collect_cache:
        # the roped k and v the attention just projected go to the cache
        # (the JAX package projects them again, and XLA merges the two)
        a, (k, v) = a
        cap = opts.prefill_cache_capacity or h.shape[1]
        cache_out = _attn_cache_from_prefill(spec, k, v, cap)
    x = x + a
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    x = x + ffn(params["ffn"], h2)
    return x, cache_out


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


def _attn_cache_from_prefill(spec, k, v, cap):
    """The decode cache from the prefill's roped K/V."""
    cap_w = cap if spec.window == GLOBAL else min(spec.window, cap)
    return {"k": _ring_place(k, cap_w), "v": _ring_place(v, cap_w)}


# ---------------------------------------------------------------------------
# Block decode
# ---------------------------------------------------------------------------


def _decode_block(cfg: ArchConfig, spec: LayerSpec, params: dict,
                  x: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
    """One layer's decode step; writes the layer's cache in place."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, _ = attn_mod.attention_decode(cfg, params["attn"], h, cache, pos,
                                     window=spec.window)
    x = x + a
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + ffn(params["ffn"], h2)


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     capacity: int, dtype: torch.dtype, device) -> dict:
    check_block(cfg, spec)
    return attn_mod.init_kv_cache(cfg, batch, capacity, spec.window, dtype,
                                  device)


# ---------------------------------------------------------------------------
# Stack apply
# ---------------------------------------------------------------------------


def apply_stack(cfg: ArchConfig, seg_params: List[Any],
                specs: List[LayerSpec], opts: ModelOptions, x: torch.Tensor,
                positions: torch.Tensor, collect_cache: bool = False):
    """-> (x, aux (0: no MoE), caches_per_segment | None)."""
    from torch.utils.checkpoint import checkpoint

    caches = [] if collect_cache else None
    for sp, (count, spec) in zip(seg_params, segment_specs(specs)):

        def body(layer_params, xx, spec=spec):
            return _apply_block(cfg, spec, opts, layer_params, xx, positions,
                                collect_cache)

        seg_cache = []
        for layer_params in _layers(sp):
            if opts.remat:
                x, cache = checkpoint(body, layer_params, x,
                                      use_reentrant=False)
            else:
                x, cache = body(layer_params, x)
            seg_cache.append(cache)
        if collect_cache:
            caches.append(_stack(seg_cache))
    return x, 0.0, caches


def decode_stack(cfg: ArchConfig, seg_params: List[Any],
                 specs: List[LayerSpec], opts: ModelOptions,
                 x: torch.Tensor, caches: List[Any], pos: int):
    """-> (x, caches): every segment's cache is written in place."""
    for sp, cache, (count, spec) in zip(seg_params, caches,
                                        segment_specs(specs)):
        for i in range(count):
            x = _decode_block(cfg, spec, _layer(sp, i), x,
                              _layer(cache, i), pos)
    return x, caches


def init_stack_cache(cfg: ArchConfig, specs: List[LayerSpec], batch: int,
                     capacity: int, dtype: torch.dtype, device) -> List[Any]:
    caches = []
    for count, spec in segment_specs(specs):
        one = init_block_cache(cfg, spec, batch, capacity, dtype, device)
        caches.append(tree_map(
            lambda a: a.expand((count,) + tuple(a.shape)).clone(), one))
    return caches
