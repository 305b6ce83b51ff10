"""The port's MoE and MLA blocks, and the LMs built of them, against the
JAX package's.

Reduced same-family configs: deepseek-v2-lite-16b (MLA: latent 32, nope
16, rope 8, v 16; MoE 8 experts top-2 + 1 shared, first layer dense)
and kimi-k2-1t-a32b (GQA 4 over 2 heads; the same MoE), 2 layers,
d_model 64, vocab 256.  Inputs are drawn with numpy from a seed; the
JAX package makes the params, which ``lm_params_from_jax`` carries
across.  The JAX side runs its own code: dense dispatch, and the ep
``shard_map`` under ``use_mesh`` on a (1, 1) (data, model) mesh of the
one CPU device; its MLA runs its plain blockwise attention (every impl
but ``naive``).

Tolerances, rtol = atol: fp32 1e-4 (fp32 sums in another order), the
router's gates and the load-balance loss 1e-6; bf16 logits 6e-2 and
caches 2e-2, as ``tests/test_torch_lm.py`` (activations round to bf16
at other places in the two frameworks), and a bf16 MoE block within
1e-2 of its largest output in absolute terms (a token's expert outputs
sum in fp32 in the port and round at each add of the JAX scatter-add;
where they cancel, the error is that of the terms, up to 30 here, not
of the small sum: 1e-2 of 30 is about two bf16 ulps of it).  Router indices,
the ep selection (which tokens each expert takes, the dropped
assignments with them) and greedy tokens are equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import use_mesh
from repro.configs import ARCHS
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

B, S, STEPS = 2, 37, 3
ARCH_NAMES = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 2e-2)}   # logits, caches
MOE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
JAX_MESH = jax_debug_mesh((1, 1), ("data", "model"))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfg(arch, dtype="float32", **moe_over):
    cfg = ARCHS[arch].reduced(dtype=dtype)
    if moe_over:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


def _normal(shape, seed, dtype="float32", shared=0.0):
    """Standard normal draws, plus ``shared`` times one direction common
    to every token (a skew the router follows)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) + shared * rng.normal(size=shape[-1])
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


def _moe_params(cfg, dtype):
    jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.dtype(dtype))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_moe(cfg, jp, x, impl):
    with use_mesh(JAX_MESH):
        return jmoe.moe_block(cfg, jp, x, impl=impl, dp_axes=("data",))


def _jax_selection(cfg, gates, idx):
    """``_ep_local``'s choice of tokens on the one model shard: per
    expert, ``jax.lax.top_k`` of the 0/1 routed score over the tokens."""
    moe = cfg.moe
    local = idx[..., None] == jnp.arange(moe.num_experts)[None, None, :]
    g_local = jnp.sum(jnp.where(local, gates[..., None], 0.0), axis=1)
    cap = tmoe.ep_capacity(moe, idx.shape[0])
    _, sel = jax.lax.top_k((g_local > 0).astype(jnp.float32).T, cap)
    return np.asarray(sel), int(jnp.sum(g_local > 0))


@pytest.mark.parametrize("tied", [False, True])
def test_router_probs_and_load_balance_loss_match_jax(tied):
    """``tied``: experts 1-3 share one router column, so a token that
    ranks them first has equal probabilities across the top-k boundary;
    both packages keep the lower expert indices."""
    cfg = _cfg("deepseek-v2-lite-16b")
    jp, tp = _moe_params(cfg, "float32")
    if tied:
        router = np.asarray(jp["router"]).copy()
        router[:, 1:4] = router[:, 1:2]
        jp = {**jp, "router": jnp.asarray(router)}
        tp = {**tp, "router": torch.from_numpy(router)}
    jx, tx = _normal((B * S, cfg.d_model), 1)
    jg, ji, jprobs = jmoe.router_probs(jp["router"], jx, cfg.moe.top_k)
    tg, ti, tprobs = tmoe.router_probs(tp["router"], tx, cfg.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if tied:        # some token has its top-2 among the tied experts
        assert bool(((ti == 1) & (ti[:, 1:2] == 2)).any())
    _close(tg, jg, 1e-6)
    _close(tprobs, jprobs, 1e-6)
    _close(tmoe.load_balance_loss(tprobs, ti, cfg.moe.num_experts),
           jmoe.load_balance_loss(jprobs, ji, cfg.moe.num_experts), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("ep", 8.0),
                                     ("ep", 1.25)])
def test_moe_block_matches_jax(impl, cf, dtype):
    """The tokens share a component, so the router sends more of them to
    some experts than others: ep at capacity factor 8 drops nothing, at
    the default 1.25 it drops, and takes the same tokens as the JAX
    package."""
    cfg = _cfg("deepseek-v2-lite-16b", dtype, capacity_factor=cf)
    jp, tp = _moe_params(cfg, dtype)
    jx, tx = _normal((B, S, cfg.d_model), 2, dtype, shared=1.0)
    jy, jaux = _jax_moe(cfg, jp, jx, impl)
    ty, taux = tmoe.moe_block(cfg, tp, tx, impl=impl, mesh=make_host_mesh())
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (B, S, 64)
    scale = 1.0 if dtype == "float32" else float(np.abs(_np(jy)).max())
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=MOE_TOL[dtype],
                               atol=MOE_TOL[dtype] * scale)
    _close(taux, jaux, 1e-6)
    if impl == "ep":
        x2 = tx.reshape(B * S, -1)
        gates, idx, _ = tmoe.router_probs(tp["router"], x2, cfg.moe.top_k)
        sel, sel_gate, rows = tmoe.ep_route(cfg.moe, gates, idx)
        want_sel, routed = _jax_selection(
            cfg, *jmoe.router_probs(jp["router"], jx.reshape(B * S, -1),
                                    cfg.moe.top_k)[:2])
        np.testing.assert_array_equal(sel.numpy(), want_sel)
        dropped = routed - int((sel_gate > 0).sum())
        assert dropped == int((rows < 0).sum())
        assert (dropped > 0) == (cf == 1.25), dropped


def test_ep_drops_at_decode_as_jax_does():
    """At decode (B = 4, one token each) with deepseek's 64 experts
    top-6 and the default capacity factor, an expert takes one token:
    ep drops assignments, the same ones in both packages."""
    cfg = _cfg("deepseek-v2-lite-16b", num_experts=64, top_k=6)
    jp, tp = _moe_params(cfg, "float32")
    jx, tx = _normal((4, 1, cfg.d_model), 3)
    assert tmoe.ep_capacity(cfg.moe, 4) == 1
    jy, _ = _jax_moe(cfg, jp, jx, "ep")
    ty, _ = tmoe.moe_block(cfg, tp, tx, impl="ep", mesh=make_host_mesh())
    _close(ty, jy, 1e-4)
    gates, idx, _ = tmoe.router_probs(tp["router"], tx.reshape(4, -1), 6)
    sel, sel_gate, rows = tmoe.ep_route(cfg.moe, gates, idx)
    want_sel, _ = _jax_selection(cfg, *jmoe.router_probs(
        jp["router"], jx.reshape(4, -1), 6)[:2])
    np.testing.assert_array_equal(sel.numpy(), want_sel)
    assert int((rows < 0).sum()) > 0
    dense, _ = tmoe.moe_block(cfg, tp, tx, impl="dense")
    assert float((dense - ty).abs().max()) > 1e-2


def test_moe_ep_is_refused_without_a_mesh():
    cfg = _cfg("deepseek-v2-lite-16b")
    _, tp = _moe_params(cfg, "float32")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        tmoe.moe_block(cfg, tp, torch.zeros(1, 2, 64), impl="ep")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla(q_lora_rank, dtype="float32"):
    cfg = _cfg("deepseek-v2-lite-16b", dtype)
    cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, q_lora_rank=q_lora_rank))
    jp = jmla.init_mla(jax.random.PRNGKey(4), cfg, jnp.dtype(dtype))
    return cfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.mark.parametrize("q_lora_rank", [0, 24])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_mla_attention_matches_jax(impl, q_lora_rank):
    cfg, jp, tp = _mla(q_lora_rank)
    assert sorted(tp) == sorted(jp)
    jx, tx = _normal((B, S, cfg.d_model), 5)
    pos = np.arange(S)
    want = jmla.mla_attention(cfg, jp, jx, jnp.asarray(pos), impl=impl,
                              block_kv=16)
    got, (c, k_rope) = tmla.mla_attention(cfg, tp, tx, torch.from_numpy(pos),
                                          impl=impl, block_kv=16,
                                          return_latent=True)
    _close(got, want, 1e-4)
    wc, wk = jmla._latent(cfg, jp, jx, jnp.asarray(pos))
    _close(c, wc, 1e-5)
    _close(k_rope, wk, 1e-5)


@pytest.mark.parametrize("q_lora_rank", [0, 24])
def test_mla_decode_on_a_ring_that_wraps_matches_jax(q_lora_rank):
    """Capacity 8 under 13 steps: the ring wraps once and evicts."""
    cfg, jp, tp = _mla(q_lora_rank)
    cap, steps = 8, 13
    jcache = jmla.init_mla_cache(cfg, B, cap, jnp.float32)
    tcache = tmla.init_mla_cache(cfg, B, cap, torch.float32, "cpu")
    xs = np.random.default_rng(6).normal(
        size=(steps, B, 1, cfg.d_model)).astype(np.float32)
    for pos in range(steps):
        want, jcache = jmla.mla_decode(cfg, jp, jnp.asarray(xs[pos]), jcache,
                                       jnp.int32(pos))
        got, tcache = tmla.mla_decode(cfg, tp, torch.from_numpy(xs[pos]),
                                      tcache, pos)
        _close(got, want, 1e-4)
    for key in ("c", "k_rope"):
        _close(tcache[key], jcache[key], 1e-5)


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------


def _opts(cls, impl="ep"):
    mesh = JAX_MESH if cls is JaxOptions else make_host_mesh()
    extra = {"dp_axes": ("data",)} if cls is JaxOptions else {}
    return cls(attn_impl="pallas", moe_impl=impl, mesh=mesh, remat=False,
               prefill_cache_capacity=S + STEPS + 8, **extra)


def _tokens(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S),
                                                dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    """The JAX package's prefill, greedy decode steps and loss, ep
    dispatch, as numpy."""
    cfg = ARCHS[arch].reduced(dtype=dtype)
    model = jax_build(cfg, _opts(JaxOptions))
    toks = _tokens(cfg.vocab_size)
    labels = _tokens(cfg.vocab_size, seed=4)
    with use_mesh(JAX_MESH):
        params = model.init(jax.random.PRNGKey(0))
        logits, caches = model.prefill(params, {"tokens": jnp.asarray(toks)})
        pre_caches = jax.tree.map(np.asarray, caches)
        steps, fed = [np.asarray(logits)], []
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
            fed.append(tok.astype(np.int32))
            logits, caches = model.decode_step(
                params, jnp.asarray(fed[-1]), caches, jnp.int32(S + i))
            steps.append(np.asarray(logits))
        loss, aux = model.loss(params, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)})
    return (jax.tree.map(np.asarray, params), toks, labels, steps, fed,
            pre_caches, jax.tree.map(np.asarray, caches),
            (float(loss), float(aux["ce"]), float(aux["moe_aux"])))


def _port(arch, dtype, impl="ep"):
    params, toks, *_ = _jax_run(arch, dtype)
    model = build_model(TORCH_ARCHS[arch].reduced(dtype=dtype),
                        _opts(ModelOptions, impl))
    return model, lm_params_from_jax(params, device="cpu"), toks


LM_CASES = [(a, d) for a in ARCH_NAMES for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", LM_CASES)
def test_prefill_logits_and_ring_caches_match_jax(arch, dtype):
    model, params, toks = _port(arch, dtype)
    _, _, _, steps, _, want_caches, _, _ = _jax_run(arch, dtype)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.float32 and logits.shape == (B, 1, 256)
    ltol, ctol = TOL[dtype]
    _close(logits, steps[0], ltol)
    assert len(caches) == len(want_caches)
    for got, want in zip(caches, want_caches):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape
            assert got[key].dtype == getattr(torch, dtype)
            _close(got[key], want[key], ctol)


@pytest.mark.parametrize("arch,dtype", LM_CASES)
def test_decode_steps_and_serve_loop_match_jax(arch, dtype):
    """``decode_step`` fed the JAX package's greedy tokens, then the
    port's own greedy loop: the same tokens."""
    model, params, toks = _port(arch, dtype)
    _, _, _, steps, fed, _, want_caches, _ = _jax_run(arch, dtype)
    ltol, ctol = TOL[dtype]
    _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    for i, tok in enumerate(fed):
        logits, caches = model.decode_step(params, torch.from_numpy(tok),
                                           caches, S + i)
        _close(logits, steps[i + 1], ltol)
    for got, want in zip(caches, want_caches):
        for key in want:
            _close(got[key], want[key], ctol)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    mine = []
    for i in range(STEPS):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        mine.append(tok.numpy())
        logits, caches = model.decode_step(params, tok, caches, S + i)
    np.testing.assert_array_equal(np.concatenate(mine, 1),
                                  np.concatenate(fed, 1))


@pytest.mark.parametrize("arch,dtype", LM_CASES)
def test_loss_and_moe_aux_match_jax(arch, dtype):
    model, params, toks = _port(arch, dtype)
    _, _, labels, _, _, _, _, (loss, ce, aux) = _jax_run(arch, dtype)
    got, parts = model.loss(params, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)})
    tol = TOL[dtype][0]
    assert float(parts["moe_aux"]) > 0
    _close(parts["moe_aux"], aux, 1e-5 if dtype == "float32" else tol)
    _close(parts["ce"], ce, tol)
    _close(got, loss, tol)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dense_and_ep_agree_and_decode_matches_the_full_forward(arch):
    """Prefill of S tokens == prefill of S - 1 plus one decode step under
    dense dispatch, at the JAX package's 2e-3 (its
    tests/test_smoke_archs.py); ep at capacity factor E/k drops nothing
    and gives dense's logits."""
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    model = build_model(cfg, _opts(ModelOptions, "dense"))
    params = model.init(0, device="cpu")
    t = torch.from_numpy(_tokens(cfg.vocab_size))
    full, _ = model.prefill(params, {"tokens": t})
    _, caches = model.prefill(params, {"tokens": t[:, :-1]})
    dec, _ = model.decode_step(params, t[:, -1:], caches, S - 1)
    _close(dec, full, 2e-3)
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    ep, _ = build_model(no_drop, _opts(ModelOptions, "ep")).prefill(
        params, {"tokens": t})
    _close(ep, full, 1e-5)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_keep_the_jax_tree_and_layout(arch):
    """bf16 model: every leaf's shape and dtype as the JAX package's,
    the router fp32; leaves and param counts equal."""
    cfg = ARCHS[arch].reduced()
    jax_shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    mine = build_model(TORCH_ARCHS[arch].reduced()).init(0, device="cpu")
    back = lm_params_to_jax(mine)
    assert jax.tree.structure(back) == jax.tree.structure(jax_shapes)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype
    moe = mine["segments"][-1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["experts"]["gate"].dtype == torch.bfloat16
    assert moe["experts"]["gate"].shape == (1, 8, 64, 64)


def test_experts_draw_with_sigma_one_over_sqrt_e_as_jax_does():
    """``dense_init`` takes fan_in = shape[0]: a stacked (E, d, f) expert
    draws with σ = 1/√E (8 experts: 0.354), not 1/√d (d 64: 0.125), in
    both packages (a normal truncated at ±2σ has 0.880σ of spread)."""
    cfg = ARCHS["deepseek-v2-lite-16b"].reduced(dtype="float32", d_model=256)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    want = 0.8796 / np.sqrt(cfg.moe.num_experts)
    for name in ("gate", "up", "down"):
        assert abs(float(jnp.std(jp["experts"][name])) - want) < 0.01 * want
        assert abs(float(tp["experts"][name].std()) - want) < 0.01 * want


def test_stacked_init_frees_each_layer_before_the_next():
    """Init holds the stack and one layer: a drawn layer's tensors die by
    reference count (the cyclic collector off) once copied into the
    stack, so deepseek-v2-lite-16b's 26 MoE layers of 1.1 GB each never
    live twice."""
    import gc
    import weakref

    from repro_torch.models import transformer as tfm

    drawn = []

    def draw():
        assert all(r() is None for r in drawn)
        layer = {"w": torch.randn(3, 4), "b": [torch.zeros(2)]}
        drawn.extend(weakref.ref(t) for t in (layer["w"], layer["b"][0]))
        return layer

    gc.disable()
    try:
        out = tfm._init_stacked(4, draw)
    finally:
        gc.enable()
    assert out["w"].shape == (4, 3, 4) and out["b"][0].shape == (4, 2)
    assert all(r() is None for r in drawn)
