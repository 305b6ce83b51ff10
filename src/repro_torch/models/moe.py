"""Mixture-of-Experts: the router and two dispatch implementations, the
JAX package's ``models/moe.py``.

* ``dense`` — every expert computes every token, outputs weighted by
  the top-k gates; nothing is dropped.  The oracle for tests.
* ``ep`` — the JAX package's expert-parallel dispatch, its
  ``shard_map`` region's per-shard body ``_ep_local``.  On a model axis
  of size 1 every expert is local (``E_loc = E``, shard 0); across
  ``m`` model ranks rank r holds experts ``[r·E/m, (r+1)·E/m)`` (E must
  divide by m), its tokens are the whole microbatch block of its data
  coordinate (replicated over the model axis), and the experts' outputs
  are summed over the axis in fp32 (``launch/dist.py``'s ``psum``).
  ``cap`` comes from the tokens this rank holds, as ``_ep_local`` takes
  it from its data shard.  Each expert takes up to ``cap`` of its routed tokens,
  the lowest token indices first as ``jax.lax.top_k`` picks them over a
  0/1 score, runs its FFN on them as one batched product, and the
  weighted outputs are scattered back.  Assignments past an expert's
  capacity are dropped (standard capacity-factor MoE); at decode, where
  ``cap`` is 1, that drops most of them, as in the JAX package.

Both dispatches run the experts through one ``torch.bmm`` over the
stacked ``(E, n, D)`` tokens, which reads the stacked weights in place,
and combine alike: each gate product rounded to the model's dtype (the
JAX package's cast of the gates), the products of a token summed in
fp32 in ascending expert order, one cast at the end.  The sum is the
JAX package's scatter-add in its update order, without ``index_add_``'s
atomics on the card: two runs are bit-equal, and dense and ep without
drops agree bit for bit where the experts' rows do.

Training takes autograd's gradients of these forwards, which are the
JAX package's ``jax.grad`` of ``_ep_local``: the router's through the
stable sort reach the same probabilities as through ``jax.lax.top_k``;
the load-balance loss's only through ``probs.mean`` (the counts are
integers, as the JAX ``.at[].add(1.0)`` counts take no gradient); a
capacity slot that holds no routed token, and an assignment past
capacity, carry gate 0 or no row, so they give exactly zero gradient
to the experts and the gates, as the JAX ``sel_valid`` mask does.  The
backwards of the gather and of the combine accumulate through
``index_put_``, which the card runs as a sort and ordered sums, not
atomics: two backward passes there are bit-equal
(``tests/test_torch_gpu.py``).  Under ``remat`` a layer is recomputed in the backward; its
:class:`Route` hands the recompute the experts its forward chose.

The load-balance loss is over the whole microbatch, as the JAX package
takes it outside the region: where the microbatch is split over data
ranks (``dp_axes`` of a mesh over ranks), the expert counts and the
probabilities' sums are summed over those ranks in the forward, the
latter through the differentiable ``psum``.

Shared experts (DeepSeek / Kimi) are dense FFNs applied to every token.
"""
from __future__ import annotations

from math import prod
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.launch import dist
from repro_torch.launch.mesh import model_shards
from repro_torch.models.layers import dense_init, ffn, init_ffn


def init_moe(gen: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype) -> dict:
    moe = cfg.moe
    d, E, f = cfg.d_model, moe.num_experts, moe.expert_d_ff
    p = {
        # the router stays fp32 in a 16-bit model, as in the JAX package
        "router": dense_init(gen, (d, E), torch.float32),
        # experts stacked on a leading E axis; dense_init's fan-in is
        # shape[0], so they draw with σ = 1/√E (the JAX package's init)
        "experts": {
            "gate": dense_init(gen, (E, d, f), dtype),
            "up": dense_init(gen, (E, d, f), dtype),
            "down": dense_init(gen, (E, f, d), dtype),
        },
    }
    if moe.num_shared_experts:
        p["shared"] = init_ffn(gen, d, moe.num_shared_experts * moe.shared_d_ff,
                               dtype)
    return p


def router_probs(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """-> (gates (T,k) fp32 renormalised, idx (T,k) int64, probs (T,E))."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    # top-k as a stable descending sort: equal probabilities in ascending
    # expert order, as jax.lax.top_k gives them (torch.topk keeps no order)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return _renormalised(gates[:, :top_k]), idx[:, :top_k], probs


def _renormalised(gates: torch.Tensor) -> torch.Tensor:
    return gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)


class Route:
    """The experts one MoE layer's forward chose, for its recompute
    under ``remat``: the first pass keeps the router's choice, and every
    pass takes the kept experts with the gates gathered from its own
    probabilities (the same values as the router's, and the same ops in
    both passes, as the checkpoint requires), so the backward
    differentiates the routing the forward ran even where a recomputed
    probability would tie at the top-k boundary."""

    def __init__(self):
        self.idx = None

    def choose(self, idx, probs):
        """-> (gates, idx) for this pass of the layer."""
        if self.idx is None:
            self.idx = idx
        return _renormalised(probs.gather(1, self.idx)), self.idx


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      num_experts: int, mesh=None,
                      dp_axes=()) -> torch.Tensor:
    """Switch-style aux loss: E * Σ_e f_e · p_e, over the tokens of the
    ranks of ``mesh`` that differ on ``dp_axes`` (this rank's alone in
    one process or where they are one rank)."""
    T = probs.shape[0]
    # a fixed-shape count (bincount's shape depends on the values)
    counts = torch.zeros(num_experts, device=idx.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=idx.device))
    group = mesh.group(*dp_axes) if mesh is not None and dp_axes else None
    if group is None:
        f = counts / max(T * idx.shape[-1], 1)
        return num_experts * torch.sum(f * probs.mean(dim=0))
    T = T * prod(mesh.shape[a] for a in dp_axes)
    counts = dist.psum(counts, mesh, dp_axes)
    p = dist.psum(probs.sum(dim=0), mesh, dp_axes) / T
    return num_experts * torch.sum(counts / max(T * idx.shape[-1], 1) * p)


def _experts(experts: dict, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert on its tokens: xe (E, n, D) -> (E, n, D)."""
    h = torch.bmm(xe, experts["gate"])
    u = torch.bmm(xe, experts["up"])
    return torch.bmm(F.silu(h) * u, experts["down"])


def _gated(y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """An expert's output times its gate, in the output's dtype."""
    return y * gate.to(y.dtype)[..., None]


# ---------------------------------------------------------------------------
# dense dispatch (oracle)
# ---------------------------------------------------------------------------


def _moe_dense(moe: MoEConfig, experts: dict, x2: torch.Tensor, gates,
               idx) -> torch.Tensor:
    T, D = x2.shape
    y = _experts(experts, x2.expand(moe.num_experts, T, D))     # (E,T,D)
    w = torch.zeros((T, moe.num_experts), dtype=gates.dtype,
                    device=gates.device).scatter_add_(1, idx, gates)
    out = torch.zeros((T, D), dtype=torch.float32, device=x2.device)
    for e in range(moe.num_experts):        # an unrouted expert adds 0
        out += _gated(y[e], w[:, e]).float()
    return out.to(x2.dtype)


# ---------------------------------------------------------------------------
# expert-parallel dispatch, one card
# ---------------------------------------------------------------------------


def ep_capacity(moe: MoEConfig, T: int) -> int:
    """Tokens an expert takes: the JAX package's expression, float floor
    division included."""
    return int(min(T, max(1, -(-T * moe.top_k * moe.capacity_factor
                               // moe.num_experts))))


def ep_route(moe: MoEConfig, gates: torch.Tensor, idx: torch.Tensor,
             e_lo: int = 0, e_n: Optional[int] = None):
    """Capacity-based selection of ``_ep_local`` for the ``e_n`` local
    experts from ``e_lo`` (default: every expert).

    -> (sel (e_n, cap) token ids, sel_gate (e_n, cap) fp32, 0 where the
    slot holds no routed token, rows (T, k) each token's kept rows of
    the flattened (e_n·cap) outputs in ascending expert order, -1 where
    it was dropped or its expert is not local).  An expert takes its
    routed tokens lowest index first, then fills its capacity with
    unrouted ones (gate 0), which is the order ``jax.lax.top_k`` gives
    equal scores."""
    T, k = idx.shape
    E = moe.num_experts if e_n is None else e_n
    cap = ep_capacity(moe, T)
    local = idx - e_lo
    mine = (local >= 0) & (local < E)
    g_local = torch.zeros((T, E), dtype=gates.dtype,
                          device=gates.device).scatter_add_(
        1, local.clamp(0, E - 1), torch.where(mine, gates, 0.0))
    chosen = (g_local > 0).to(torch.int8).t()                   # (E, T)
    sel = torch.sort(chosen, dim=1, descending=True,
                     stable=True).indices[:, :cap]              # (E, cap)
    sel_gate = torch.gather(g_local.t(), 1, sel)
    # where[e, t]: the flat output row of token t at expert e, or -1
    # (an expert's slots hold distinct tokens: no index is written twice)
    flat = torch.arange(E * cap, device=idx.device).reshape(E, cap)
    where = torch.full((E, T), -1, dtype=torch.long, device=idx.device)
    where.scatter_(1, sel, torch.where(sel_gate > 0, flat, -1))
    srt = idx.sort(dim=1).values - e_lo
    rows = torch.where((srt >= 0) & (srt < E),
                       torch.gather(where.t(), 1, srt.clamp(0, E - 1)), -1)
    return sel, sel_gate, rows


def _moe_ep(moe: MoEConfig, experts: dict, x2: torch.Tensor, gates,
            idx, mesh=None, model_axis: str = "model") -> torch.Tensor:
    """``_ep_local`` over this rank's experts, summed over the model
    axis (module docstring)."""
    T, D = x2.shape
    m = model_shards(mesh, model_axis, "moe_impl='ep'")
    if m == 1:
        sel, sel_gate, rows = ep_route(moe, gates, idx)
    else:
        if moe.num_experts % m:
            raise ValueError(f"moe_impl='ep': {moe.num_experts} experts do "
                             f"not split over {m} {model_axis!r} ranks")
        e_n = moe.num_experts // m
        e_lo = mesh.coord(model_axis) * e_n
        experts = {k: w[e_lo:e_lo + e_n] for k, w in experts.items()}
        sel, sel_gate, rows = ep_route(moe, gates, idx, e_lo, e_n)
    E, cap = sel.shape
    y = _experts(experts, x2[sel.reshape(-1)].reshape(E, cap, D))
    y = _gated(y, sel_gate).reshape(E * cap, D)
    out = torch.zeros((T, D), dtype=torch.float32, device=x2.device)
    for j in range(rows.shape[1]):      # a token's kept rows, by expert
        r = rows[:, j]
        out += torch.where((r >= 0)[:, None], y[r.clamp_min(0)].float(), 0.0)
    if m > 1:
        out = dist.psum(out, mesh, model_axis)
    return out.to(x2.dtype)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def moe_block(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
              impl: str = "dense", mesh=None, dp_axes=(),
              model_axis: str = "model", route: Optional[Route] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux load-balance loss scalar).
    ``dp_axes``: the mesh axes the microbatch is split over, whose ranks
    share the load-balance loss; ``route``: the layer's :class:`Route`
    when it runs under remat."""
    moe = cfg.moe
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    gates, idx, probs = router_probs(params["router"], x2, moe.top_k)
    if route is not None:
        gates, idx = route.choose(idx, probs)
    aux = load_balance_loss(probs, idx, moe.num_experts, mesh, dp_axes)
    if impl == "dense":
        y = _moe_dense(moe, params["experts"], x2, gates, idx)
    elif impl == "ep":
        y = _moe_ep(moe, params["experts"], x2, gates, idx, mesh,
                    model_axis)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    if "shared" in params:
        y = y + ffn(params["shared"], x2)
    return y.reshape(B, S, D).to(x.dtype), aux
