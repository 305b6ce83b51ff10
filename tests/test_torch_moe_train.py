"""The port's MoE / MLA training path and fused round against the JAX
package's, and MoE trees through checkpoints and the flat wire.

Reduced configs in fp32 (2 layers, d_model 64, vocab 256; the second
layer MoE: 8 experts top-2 + 1 shared): deepseek-v2-lite-16b (MLA:
latent 32, nope 16, rope 8, v 16), the same with a q LoRA of rank 16
and ep capacity factor 0.5 (``q_lora``: MLA's ``wq_a`` / ``q_a_norm`` /
``wq_b`` and dropped assignments), and kimi-k2-1t-a32b (GQA 4 over 2
heads).  The JAX model makes the params, which ``lm_params_from_jax``
carries across; batches are drawn with numpy from a seed.  The JAX side
runs its own code: ep as its ``shard_map`` on a (1, 1) (data, model)
mesh of the CPU, the hierarchical step in a subprocess with two forced
host devices.

Tolerances, each with its reason (those of ``test_torch_fused_round.py``):

* ``LM.loss`` and its gradients, ep and dense, remat on and off: loss
  atol 1e-5, gradients rtol 1e-4 and atol 1e-5 (fp32 sums in another
  order); the smallest router top-k margin must exceed 1e-5, so no
  token sits where the two frameworks could route it apart;
* the flash VJP at MLA's head dims (Dk 192, Dv 128): atol 1e-5;
* ``accumulate_updates``: rtol 5e-5, atol 1e-6, the JAX package's own
  eager-vs-lazy tolerance;
* ``FusedFLTrainer`` losses over three rounds: 1e-5;
* the hierarchical int8 step on two pods: the two-part limit of
  ``int8_round_limit``; without compression params within 5e-5;
* checkpoints and the flat wire: bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.compat import use_mesh
from repro.configs import ARCHS
from repro.data.loader import CohortTokenLoader
from repro.fl.round import AggregationConfig as JaxAgg
from repro.fl.round import accumulate_updates as jax_accumulate
from repro.fl.server import init_server_state as jax_server_state
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.models.flash import flash_self_attention as jax_flash
from repro.runtime.trainer import FusedFLTrainer as JaxTrainer
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.convert import (flatten_jax_layout, lm_params_from_jax,
                                 lm_params_to_jax, metrics_from_jax,
                                 tree_from_jax, unflatten_jax_layout)
from repro_torch.fl.round import AggregationConfig, accumulate_updates
from repro_torch.fl.round import build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.models.flash import flash_self_attention
from repro_torch.runtime import FusedFLTrainer
from repro_torch.tree import (named_leaves, tree_flatten, tree_leaves,
                              tree_unflatten)
from test_torch_fused_round import _pod_steps, int8_round_limit, run_forced

torch.set_num_threads(2)

JAX_MESH = jax_debug_mesh((1, 1), ("data", "model"))
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
#: variant -> (arch, MLA overrides, MoE overrides)
VARIANTS = {
    "deepseek": ("deepseek-v2-lite-16b", {}, {}),
    "q_lora": ("deepseek-v2-lite-16b", {"q_lora_rank": 16},
               {"capacity_factor": 0.5}),
    "kimi": ("kimi-k2-1t-a32b", {}, {}),
}


def _cfg(variant, dtype="float32", package=ARCHS):
    arch, mla, moe = VARIANTS[variant]
    cfg = package[arch].reduced(dtype=dtype)
    if mla:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla,
                                                               **mla))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _opts(cls, **over):
    base = dict(attn_impl="chunked", moe_impl="ep", loss_chunk=16,
                block_kv=8, remat=False)
    base.update(over)
    if cls is JaxOptions:
        return cls(dp_axes=("data",), **base)
    return cls(mesh=make_host_mesh(), **base)


def _batch(vocab, B=2, S=20, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S))
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1                      # an ignored label per row
    return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_params(variant, dtype="float32"):
    model = jax_build(_cfg(variant, dtype), _opts(JaxOptions))
    with use_mesh(JAX_MESH):
        return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(variant, impl):
    """JAX's loss, aux and gradients (remat changes no value there)."""
    model = jax_build(_cfg(variant), _opts(JaxOptions, moe_impl=impl))
    jb = {k: jnp.asarray(v) for k, v in _batch(256).items()}
    with use_mesh(JAX_MESH):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: model.loss(p, jb), has_aux=True)(_jax_params(variant))
    return (float(loss), float(aux["moe_aux"]),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_grads(model, params, batch, of=None):
    """(loss, aux, grads of ``of(loss, aux)`` or of the loss)."""
    leaves, treedef = tree_flatten(params)
    live = [l.detach().clone().requires_grad_() for l in leaves]
    loss, aux = model.loss(tree_unflatten(treedef, live), batch)
    target = loss if of is None else of(loss, aux)
    return loss.detach(), aux, torch.autograd.grad(target, live,
                                                   materialize_grads=True)


@pytest.fixture
def watch(monkeypatch):
    """Each MoE block's smallest router top-k margin and, under ep, its
    dropped assignments."""
    rec = {"margin": [], "dropped": []}
    router, route = tmoe.router_probs, tmoe.ep_route

    def watched_router(w, x, k):
        gates, idx, probs = router(w, x, k)
        top = torch.topk(probs.detach(), k + 1, dim=-1).values
        rec["margin"].append(float((top[:, k - 1] - top[:, k]).min()))
        return gates, idx, probs

    def watched_route(moe, gates, idx):
        out = route(moe, gates, idx)
        rec["dropped"].append(int((out[2] < 0).sum()))
        return out

    monkeypatch.setattr(tmoe, "router_probs", watched_router)
    monkeypatch.setattr(tmoe, "ep_route", watched_route)
    return rec


# ---------------------------------------------------------------------------
# LM.loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["ep", "dense"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lm_loss_and_grads_match_jax(variant, impl, remat, watch):
    jloss, jaux, jgrads = _jax_loss_and_grads(variant, impl)
    model = build_model(_cfg(variant, package=TORCH_ARCHS),
                        _opts(ModelOptions, moe_impl=impl, remat=remat))
    params = lm_params_from_jax(_jax_params(variant), device="cpu")
    loss, aux, grads = _port_grads(model, params, _tb(_batch(256)))
    assert abs(float(loss) - jloss) < 1e-5
    assert abs(float(aux["moe_aux"].detach()) - jaux) < 1e-5
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert min(watch["margin"]) > GRAD_ATOL
    reached = {k.rsplit(".", 1)[-1] for (k, _), g in
               zip(named_leaves(params), grads)
               if ".attn." in k and bool(g.any())}
    if variant != "kimi":      # MLA: every projection and norm is reached
        want = {"wkv_a", "kv_a_norm", "wkv_b", "wo"} | (
            {"wq_a", "q_a_norm", "wq_b"} if variant == "q_lora" else {"wq"})
        assert reached == want
    if impl == "ep" and variant == "q_lora":
        assert sum(watch["dropped"]) > 0     # capacity 0.5 drops


def test_moe_aux_enters_the_gradient():
    """The load-balance loss reaches the gradient with its weight, above
    the gradient tolerance at the router."""
    cfg = _cfg("deepseek", package=TORCH_ARCHS)
    model = build_model(cfg, _opts(ModelOptions))
    params = lm_params_from_jax(_jax_params("deepseek"), device="cpu")
    batch = _tb(_batch(256))
    total = _port_grads(model, params, batch)[2]
    ce = _port_grads(model, params, batch, of=lambda l, a: a["ce"])[2]
    aux = _port_grads(model, params, batch, of=lambda l, a: a["moe_aux"])[2]
    for t, c, a in zip(total, ce, aux):
        torch.testing.assert_close(t, c + registry.MOE_AUX_WEIGHT * a,
                                   rtol=1e-5, atol=1e-7)
    names = [k for k, _ in named_leaves(params)]
    router = [a for k, a in zip(names, aux) if k.endswith("moe.router")]
    assert len(router) == 1
    assert float(router[0].abs().max()) * registry.MOE_AUX_WEIGHT > GRAD_ATOL


def test_remat_recompute_routes_as_the_forward_did(monkeypatch):
    """Under remat the backward recomputes the MoE layer; a recompute
    whose router would choose other experts still differentiates the
    forward's routing (``moe.Route``).  Without the route's memory the
    same recompute moves the gradients."""
    cfg = _cfg("deepseek", package=TORCH_ARCHS)
    params = lm_params_from_jax(_jax_params("deepseek"), device="cpu")
    batch = _tb(_batch(256))
    want = _port_grads(build_model(cfg, _opts(ModelOptions)), params,
                       batch)[2]
    router, calls = tmoe.router_probs, []

    def recompute_flips(w, x, k):
        gates, idx, probs = router(w, x, k)
        calls.append(1)
        if len(calls) % 2 == 0:        # the recompute in the backward
            idx = (idx + 1) % cfg.moe.num_experts
        return gates, idx, probs

    monkeypatch.setattr(tmoe, "router_probs", recompute_flips)
    remat = build_model(cfg, _opts(ModelOptions, remat=True))
    got = _port_grads(remat, params, batch)[2]
    assert len(calls) == 2             # one MoE layer: forward, recompute
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    monkeypatch.setattr(tmoe.Route, "choose", lambda self, idx, probs: (
        tmoe._renormalised(probs.gather(1, idx)), idx))
    forgetful = _port_grads(remat, params, batch)[2]
    assert max(float((g - w).abs().max())
               for g, w in zip(forgetful, want)) > 1e-3


def test_ep_filler_and_drops_match_jax_and_idle_experts_get_zero():
    """The ep block at capacity factor 0.5 on 3 tokens: each expert keeps
    one slot, so routed tokens are dropped and unrouted experts fill
    their slot with a token of gate 0.  Gradients of the output and the
    load-balance loss, for the params and the input, against
    ``jax.grad`` of the JAX package's ``shard_map`` ep; an expert no
    token was routed to gets exactly zero gradient."""
    cfg, tcfg = _cfg("q_lora"), _cfg("q_lora", package=TORCH_ARCHS)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), cfg,
                                                jnp.float32))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_block(cfg, p, xx, impl="ep", dp_axes=("data",))
        return jnp.sum(y * ct) + aux

    with use_mesh(JAX_MESH):
        jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    leaves, treedef = tree_flatten(lm_params_from_jax(jp, device="cpu"))
    live = [l.requires_grad_() for l in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_block(tcfg, tree_unflatten(treedef, live), tx,
                            impl="ep", mesh=make_host_mesh())
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + aux,
                                live + [tx])
    for g, w in zip(grads, jax.tree.leaves(jg_p) + [jg_x]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    p = tree_unflatten(treedef, leaves)
    gates, idx, _ = tmoe.router_probs(p["router"], tx.detach()[0], 2)
    sel, sel_gate, rows = tmoe.ep_route(tcfg.moe, gates, idx)
    assert int((rows < 0).sum()) > 0 and int((sel_gate == 0).sum()) > 0
    idle = sorted(set(range(cfg.moe.num_experts))
                  - set(idx.reshape(-1).tolist()))
    assert idle
    g = tree_unflatten(treedef, list(grads[:-1]))
    for name in ("gate", "up", "down"):
        assert not bool(g["experts"][name][idle].any()), name


# ---------------------------------------------------------------------------
# flash attention's custom backward at MLA's head dims
# ---------------------------------------------------------------------------


def test_flash_vjp_at_mla_head_dims_matches_jax():
    """Dk 192 (nope 128 | rope 64) and Dv 128, deepseek-v2-lite-16b's
    heads: values and dq / dk / dv against the JAX custom VJP."""
    B, S, K, G, Dk, Dv, bk = 1, 37, 2, 1, 192, 128, 16   # S ragged on bk
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, S, K, G, Dk)).astype(np.float32)
    k = rng.normal(size=(B, S, K, Dk)).astype(np.float32)
    v = rng.normal(size=(B, S, K, Dv)).astype(np.float32)
    do = rng.normal(size=(B, S, K, G, Dv)).astype(np.float32)
    scale = Dk ** -0.5
    out, vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, -1, True, scale, bk),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = flash_self_attention(tq, tk, tv, -1, True, scale, bk)
    got.backward(torch.from_numpy(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (got, tq.grad, tk.grad, tv.grad), want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the fused round
# ---------------------------------------------------------------------------


def test_stacked_expert_leaves_are_unbound_once_a_segment():
    """Each stacked leaf of the MoE segment, the 4-D experts included,
    reaches the layers through one ``unbind`` (whose backward stacks the
    layers' gradients once), not one ``select`` a layer."""
    cfg = dataclasses.replace(_cfg("deepseek", package=TORCH_ARCHS),
                              num_layers=3)
    model = build_model(cfg, _opts(ModelOptions, remat=True))
    params = model.init(0, device="cpu")
    leaves, treedef = tree_flatten(params)
    live = [l.requires_grad_() for l in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, live), _tb(_batch(256)))
    consumers = {}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None:
                consumers.setdefault(id(var), []).append(node.name())
            todo.append(nxt)
    experts = tree_unflatten(treedef, live)["segments"][1]["moe"]["experts"]
    for name, leaf in experts.items():
        assert leaf.dim() == 4 and leaf.shape[0] == 2
        assert consumers[id(leaf)] == ["UnbindBackward0"], name


@pytest.mark.parametrize("variant", ["deepseek", "kimi"])
def test_accumulate_updates_eager_lazy_and_jax(variant):
    cfg = _cfg(variant)
    jmodel = jax_build(cfg, _opts(JaxOptions))
    jparams = _jax_params(variant)
    batch = _batch(cfg.vocab_size, B=8, S=16)
    model = build_model(_cfg(variant, package=TORCH_ARCHS),
                        _opts(ModelOptions))
    params = lm_params_from_jax(jparams, device="cpu")
    out = {}
    for timing in ("eager", "lazy"):
        with use_mesh(JAX_MESH):
            jd, jw, jl = jax_accumulate(
                jmodel, jax.tree.map(jnp.asarray, jparams),
                {k: jnp.asarray(v) for k, v in batch.items()},
                JaxAgg(timing=timing, num_microbatches=4))
        d, w, l = accumulate_updates(model, params, _tb(batch),
                                     AggregationConfig(timing=timing,
                                                       num_microbatches=4))
        assert float(w) == float(jw) == 8 * 15
        assert abs(float(l) - float(jl)) < 1e-5
        for g, want in zip(tree_leaves(d), jax.tree.leaves(jd)):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=5e-5, atol=1e-6)
        out[timing] = d
    for e, l in zip(tree_leaves(out["eager"]), tree_leaves(out["lazy"])):
        torch.testing.assert_close(e, l, rtol=5e-5, atol=1e-6)


def test_fused_trainer_matches_jax_over_three_rounds():
    cfg = _cfg("deepseek")
    agg_kw = dict(hierarchy="flat", timing="eager", num_microbatches=4)
    jt = JaxTrainer(cfg, JAX_MESH, JaxAgg(**agg_kw), opts=_opts(JaxOptions))
    jt.params = jax.tree.map(jnp.asarray, _jax_params("deepseek"))
    jt.server_state = jax_server_state("fedavg", jt.params)
    t = FusedFLTrainer(_cfg("deepseek", package=TORCH_ARCHS),
                       make_host_mesh(), AggregationConfig(**agg_kw),
                       opts=_opts(ModelOptions), device="cpu")
    t.params = lm_params_from_jax(_jax_params("deepseek"), device="cpu")
    t.server_state = tree_from_jax(jax.tree.map(np.asarray, jt.server_state),
                                   device="cpu")
    loader = CohortTokenLoader(cfg.vocab_size, seq_len=32, n_cohorts=4)
    for r in range(3):
        batch = loader.round_batch(16, r)
        want, got = jt.train_round(batch), t.train_round(batch)
        assert abs(got["loss"] - want["loss"]) < 1e-5, (r, got, want)
        assert got["updates_aggregated"] == want["updates_aggregated"] == 4
        assert got["aggregate_weight"] == want["aggregate_weight"]
        assert abs(got["update_norm"] / want["update_norm"] - 1) < 1e-4
    assert int(t.server_state["step"]) == 3
    for g, w in zip(tree_leaves(t.params), jax.tree.leaves(jt.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


JAX_HIER = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import use_mesh
    from repro.configs import ARCHS
    from repro.fl.round import AggregationConfig, build_train_step
    from repro.fl.server import init_server_state
    from repro.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh((2, 1, 1), ('pod', 'data', 'model'))
    cfg = ARCHS['deepseek-v2-lite-16b'].reduced(dtype='float32')
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(8, 16))
    batch = {'tokens': jnp.asarray(toks, jnp.int32),
             'labels': jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}
    out = {'tokens': toks}
    with use_mesh(mesh):
        for comp in ('none', 'int8'):
            agg = AggregationConfig(hierarchy='hierarchical',
                                    compress=comp, num_microbatches=2)
            step, model = build_train_step(cfg, mesh, agg)
            assert model.opts.moe_impl == 'ep'
            params = model.init(jax.random.PRNGKey(0))
            for i, l in enumerate(jax.tree.leaves(params)):
                out[f'init/{i}'] = np.asarray(l)
            state = init_server_state('fedavg', params)
            p2, _, m = jax.jit(step)(params, state, batch)
            for i, l in enumerate(jax.tree.leaves(p2)):
                out[f'{comp}/{i}'] = np.asarray(l)
            for k, v in m.items():
                out[f'{comp}/m/{k}'] = np.asarray(v)
    np.savez(PATH, **out)
    print('OK')
"""


def test_hierarchical_step_matches_jax_on_two_pods(tmp_path):
    """One hierarchical round of reduced deepseek-v2-lite-16b on a 2-pod
    mesh, ``build_train_step``'s default options (ep, ``chunked_sp``,
    remat), with and without the int8 hop, against the JAX package's
    nested ``shard_map`` step; ep's capacity is each microbatch's (T =
    32, cap 10)."""
    path = tmp_path / "jax_hier.npz"
    assert "OK" in run_forced(JAX_HIER.replace("PATH", repr(str(path))))
    ref = np.load(path)
    cfg = TORCH_ARCHS["deepseek-v2-lite-16b"].reduced(dtype="float32")
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    toks = ref["tokens"]
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)),
             "labels": torch.from_numpy(np.roll(toks, -1, 1).astype(np.int32))}
    readings = {}
    for comp in ("none", "int8"):
        agg = AggregationConfig(hierarchy="hierarchical", compress=comp,
                                num_microbatches=2)
        step, model = build_train_step(cfg, mesh, agg)
        assert model.opts.moe_impl == "ep" and model.opts.remat
        assert tmoe.ep_capacity(cfg.moe, 2 * 16) == 10
        leaves, treedef = tree_flatten(model.init(0, device="cpu"))
        n = len(leaves)
        assert any(l.dim() == 4 for l in leaves)
        params = tree_unflatten(treedef, [torch.from_numpy(ref[f"init/{i}"])
                                          for i in range(n)])
        new, state, m = step(params, init_server_state("fedavg", params),
                             batch)
        want = [ref[f"{comp}/{i}"] for i in range(n)]
        got = [t.numpy() for t in tree_leaves(new)]
        jm = metrics_from_jax({k: ref[f"{comp}/m/{k}"] for k in m})
        assert abs(float(m["loss"]) - jm["loss"]) < 1e-5
        assert float(m["aggregate_weight"]) == jm["aggregate_weight"]
        assert m["updates_aggregated"] == jm["updates_aggregated"] == 4
        assert abs(float(m["update_norm"]) / jm["update_norm"] - 1) < 1e-4
        if comp == "none":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
        else:
            steps = _pod_steps(model, params, batch, agg, 2)
            share, worst, ok = int8_round_limit(got, want, steps)
            assert ok, (share, worst)
        readings[comp] = got
    rel = max(float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))
              for a, b in zip(readings["none"], readings["int8"]))
    assert 0 < rel < 0.05


def test_two_part_limit_sees_rolled_expert_indices(monkeypatch):
    """The planted fault of the card's MoE round check, on the CPU: the
    same int8 step with every token's experts rolled by one in the first
    MoE layer's forward lands above the two-part limit."""
    cfg = dataclasses.replace(
        TORCH_ARCHS["deepseek-v2-lite-16b"].reduced(dtype="float32"),
        num_layers=3)
    n_moe = sum(cfg.moe_layer_flags())
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    agg = AggregationConfig(hierarchy="hierarchical", compress="int8",
                            num_microbatches=2)
    step, model = build_train_step(cfg, mesh, agg)
    params = model.init(0, device="cpu")
    batch = _tb(_batch(cfg.vocab_size, B=8, S=16))
    run = lambda: [t.numpy() for t in tree_leaves(step(
        params, init_server_state("fedavg", params), batch)[0])]
    sound = run()
    steps = _pod_steps(model, params, batch, agg, 2)
    assert int8_round_limit(sound, run(), steps)[2]
    choose, forwards = tmoe.Route.choose, []

    def rolled(self, idx, probs):
        if self.idx is None:
            if len(forwards) % n_moe == 0:
                idx = (idx + 1) % cfg.moe.num_experts
            forwards.append(1)
        return choose(self, idx, probs)

    monkeypatch.setattr(tmoe.Route, "choose", rolled)
    faulted = run()
    assert len(forwards) == 2 * 2 * n_moe      # pods x microbatches x layers
    share, worst, ok = int8_round_limit(faulted, sound, steps)
    assert not ok and worst > 1.0, (share, worst)


# ---------------------------------------------------------------------------
# MoE trees through checkpoints and the flat wire (ROADMAP C.6)
# ---------------------------------------------------------------------------


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _port_moe(seed, dtype="bfloat16"):
    return build_model(_cfg("deepseek", dtype, TORCH_ARCHS),
                       _opts(ModelOptions)).init(seed, device="cpu")


def test_a_jax_moe_checkpoint_restores_into_the_port(tmp_path):
    want = _jax_params("deepseek", "bfloat16")
    j_save(tmp_path, 3, want)
    got, step = restore_checkpoint(tmp_path, like=_port_moe(1))
    assert step == 3
    experts = got["segments"][1]["moe"]["experts"]["gate"]
    assert experts.dim() == 4 and experts.dtype == torch.bfloat16
    _assert_bit_equal(tree_leaves(got),
                      tree_leaves(lm_params_from_jax(want, device="cpu")))


def test_a_port_moe_checkpoint_restores_into_the_jax_package(tmp_path):
    params = _port_moe(1)
    save_checkpoint(tmp_path, 4, params)
    with np.load(tmp_path / "ckpt_00000004.npz") as data:
        assert all(data[k].dtype == np.float32 for k in data.files)
        assert data["segments/1/moe/experts/down"].shape == \
            tuple(params["segments"][1]["moe"]["experts"]["down"].shape)
    got, step = j_restore(tmp_path, _jax_params("deepseek", "bfloat16"))
    assert step == 4
    _assert_bit_equal(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                      tree_leaves(lm_params_to_jax(params)))


def test_flat_wire_round_trips_an_moe_tree():
    """The flat vector is the JAX package's (``_flatten_tree``'s leaf
    order and layout), and it comes back into the tree exactly."""
    from repro.runtime.trainer import _flatten_tree as jax_flatten

    params = _port_moe(2)
    flat, _, meta = flatten_jax_layout(params)
    jflat = jax_flatten(jax.tree.map(jnp.asarray,
                                     lm_params_to_jax(params)))[0]
    np.testing.assert_array_equal(flat, jflat)
    assert any(len(shape) == 4 for shape, _ in meta)
    _assert_bit_equal(tree_leaves(unflatten_jax_layout(flat, params)),
                      tree_leaves(params))


def test_fused_trainer_checkpoints_an_moe_model_and_restores(tmp_path):
    """A flat bf16 round of reduced deepseek-v2-lite-16b checkpoints
    after round 1; a new trainer resumes from it bit for bit, and so
    does the JAX package's restore."""
    cfg = _cfg("deepseek", "bfloat16", TORCH_ARCHS)
    agg = AggregationConfig(hierarchy="flat", num_microbatches=2)
    t = FusedFLTrainer(cfg, make_host_mesh(), agg, opts=_opts(ModelOptions),
                       device="cpu", checkpoint_dir=str(tmp_path),
                       checkpoint_every=1)
    t.init(0)
    t.train_round(_batch(cfg.vocab_size, B=4, S=16))
    t.ckpt.wait()
    r = FusedFLTrainer(cfg, make_host_mesh(), agg, opts=_opts(ModelOptions),
                       device="cpu", checkpoint_dir=str(tmp_path))
    assert r.maybe_restore() and r.round_id == 1
    _assert_bit_equal(tree_leaves(r.params), tree_leaves(t.params))
    got, _ = j_restore(tmp_path, _jax_params("deepseek", "bfloat16"))
    _assert_bit_equal(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                      tree_leaves(lm_params_to_jax(t.params)))
