"""Mixture-of-Experts: the router and two dispatch implementations, the
JAX package's ``models/moe.py``.

* ``dense`` — every expert computes every token, outputs weighted by
  the top-k gates; nothing is dropped.  The oracle for tests.
* ``ep`` — the JAX package's expert-parallel dispatch, a ``shard_map``
  there, on one card: its per-shard body with every expert local
  (``E_loc = E``, shard 0), so the model axis must be of size 1
  (ROADMAP A.8).  Each expert takes up to ``cap`` of its routed tokens,
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

Shared experts (DeepSeek / Kimi) are dense FFNs applied to every token.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.launch.mesh import require_one_device
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
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * Σ_e f_e · p_e."""
    T = probs.shape[0]
    counts = torch.bincount(idx.reshape(-1), minlength=num_experts).float()
    f = counts / max(T * idx.shape[-1], 1)
    return num_experts * torch.sum(f * probs.mean(dim=0))


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


def ep_route(moe: MoEConfig, gates: torch.Tensor, idx: torch.Tensor):
    """Capacity-based selection of ``_ep_local`` with every expert local.

    -> (sel (E, cap) token ids, sel_gate (E, cap) fp32, 0 where the slot
    holds no routed token, rows (T, k) each token's kept rows of the
    flattened (E·cap) outputs in ascending expert order, -1 where it was
    dropped).  An expert takes its routed tokens lowest index first,
    then fills its capacity with unrouted ones (gate 0), which is the
    order ``jax.lax.top_k`` gives equal scores."""
    T, k = idx.shape
    E = moe.num_experts
    cap = ep_capacity(moe, T)
    g_local = torch.zeros((T, E), dtype=gates.dtype,
                          device=gates.device).scatter_add_(1, idx, gates)
    chosen = (g_local > 0).to(torch.int8).t()                   # (E, T)
    sel = torch.sort(chosen, dim=1, descending=True,
                     stable=True).indices[:, :cap]              # (E, cap)
    sel_gate = torch.gather(g_local.t(), 1, sel)
    # where[e, t]: the flat output row of token t at expert e, or -1
    # (an expert's slots hold distinct tokens: no index is written twice)
    flat = torch.arange(E * cap, device=idx.device).reshape(E, cap)
    where = torch.full((E, T), -1, dtype=torch.long, device=idx.device)
    where.scatter_(1, sel, torch.where(sel_gate > 0, flat, -1))
    rows = torch.gather(where.t(), 1, idx.sort(dim=1).values)
    return sel, sel_gate, rows


def _moe_ep(moe: MoEConfig, experts: dict, x2: torch.Tensor, gates,
            idx) -> torch.Tensor:
    T, D = x2.shape
    sel, sel_gate, rows = ep_route(moe, gates, idx)
    E, cap = sel.shape
    y = _experts(experts, x2[sel.reshape(-1)].reshape(E, cap, D))
    y = _gated(y, sel_gate).reshape(E * cap, D)
    out = torch.zeros((T, D), dtype=torch.float32, device=x2.device)
    for j in range(rows.shape[1]):      # a token's kept rows, by expert
        r = rows[:, j]
        out += torch.where((r >= 0)[:, None], y[r.clamp_min(0)].float(), 0.0)
    return out.to(x2.dtype)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def moe_block(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
              impl: str = "dense", mesh=None, model_axis: str = "model",
              route: Optional[Route] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux load-balance loss scalar).
    ``route``: the layer's :class:`Route` when it runs under remat."""
    moe = cfg.moe
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    gates, idx, probs = router_probs(params["router"], x2, moe.top_k)
    if route is not None:
        gates, idx = route.choose(idx, probs)
    aux = load_balance_loss(probs, idx, moe.num_experts)
    if impl == "dense":
        y = _moe_dense(moe, params["experts"], x2, gates, idx)
    elif impl == "ep":
        require_one_device(mesh, model_axis, "moe_impl='ep'")
        y = _moe_ep(moe, params["experts"], x2, gates, idx)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    if "shared" in params:
        y = y + ffn(params["shared"], x2)
    return y.reshape(B, S, D).to(x.dtype), aux
