"""The port's LM serving path against the JAX package's.

Reduced same-family configs (2 layers, d_model 64, 4 query heads over
2 KV heads, head_dim 16, vocab 256).  The JAX model makes its params
from a PRNG key; ``lm_params_from_jax`` carries them across, so both
packages run the same weights.  The JAX side runs its Pallas flash
kernel in interpret mode (``attn_impl="pallas"``), the port its plain
version.  Checked: prefill logits, the ring caches prefill builds,
``decode_step`` logits over a few steps (both fed the JAX package's
greedy tokens), and the greedy tokens of the serve loop
(``examples/serve_decode.py``).

Tolerances, rtol = atol: fp32 1e-4 (fp32 sums in another order through
the stack); bf16 logits 6e-2 and caches 2e-2 (activations round to
bf16 at other places in the two frameworks: about one bf16 ulp of a
logit near 6, 0.03).
"""
import functools
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import (lm_params_from_jax, lm_params_to_jax,
                                 params_from_jax)
from repro_torch.fl.round import AggregationConfig, build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models import attention as tattn
from repro_torch.models import sharded_vocab
from repro_torch.tree import tree_leaves

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

B, S, STEPS = 2, 37, 3
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 2e-2)}   # logits, caches
CASES = [("llama3.2-3b", "float32"), ("llama3.2-3b", "bfloat16"),
         ("gemma3-4b", "float32"), ("h2o-danube-3-4b", "float32")]


def _opts(cls, impl="pallas", **over):
    return cls(attn_impl=impl, remat=False,
               prefill_cache_capacity=S + STEPS + 8, **over)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, size=(B, S),
                                             dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    """The JAX package's prefill and decode steps, as numpy."""
    cfg = ARCHS[arch].reduced(dtype=dtype)
    model = jax_build(cfg, _opts(JaxOptions))
    params = model.init(jax.random.PRNGKey(0))
    toks = _tokens(cfg.vocab_size)
    logits, caches = model.prefill(params, {"tokens": jnp.asarray(toks)})
    pre_caches = jax.tree.map(np.asarray, caches)
    steps = [np.asarray(logits)]
    fed = []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        fed.append(tok.astype(np.int32))
        logits, caches = model.decode_step(params, jnp.asarray(fed[-1]),
                                           caches, jnp.int32(S + i))
        steps.append(np.asarray(logits))
    return (jax.tree.map(np.asarray, params), toks, steps, fed, pre_caches,
            jax.tree.map(np.asarray, caches))


def _port(arch, dtype, impl="pallas"):
    params, toks, *_ = _jax_run(arch, dtype)
    model = build_model(TORCH_ARCHS[arch].reduced(dtype=dtype),
                        _opts(ModelOptions, impl))
    return model, lm_params_from_jax(params, device="cpu"), toks


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_logits_and_ring_caches_match_jax(arch, dtype):
    model, params, toks = _port(arch, dtype)
    _, _, steps, _, want_caches, _ = _jax_run(arch, dtype)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.float32
    assert logits.shape == (B, 1, ARCHS[arch].reduced().vocab_size)
    ltol, ctol = TOL[dtype]
    _close(logits, steps[0], ltol)
    assert len(caches) == len(want_caches)
    for got, want in zip(caches, want_caches):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape
            assert got[key].dtype == getattr(torch, dtype)
            _close(got[key], want[key], ctol)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_projects_qkv_once_a_layer(arch, dtype, monkeypatch):
    """The decode cache takes the roped k and v the attention projected:
    ``_project_qkv`` runs once a layer in a prefill (the JAX package
    projects twice and XLA merges the two), and the caches stay the JAX
    package's."""
    calls = []
    orig = tattn._project_qkv

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tattn, "_project_qkv", counted)
    model, params, toks = _port(arch, dtype)
    _, _, _, _, want_caches, _ = _jax_run(arch, dtype)
    _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert len(calls) == ARCHS[arch].reduced().num_layers
    for got, want in zip(caches, want_caches):
        for key in want:
            _close(got[key], want[key], TOL[dtype][1])


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_steps_and_caches_match_jax(arch, dtype):
    model, params, toks = _port(arch, dtype)
    _, _, steps, fed, _, want_caches = _jax_run(arch, dtype)
    _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    ltol, ctol = TOL[dtype]
    for i, tok in enumerate(fed):
        logits, caches = model.decode_step(params, torch.from_numpy(tok),
                                           caches, S + i)
        _close(logits, steps[i + 1], ltol)
    for got, want in zip(caches, want_caches):
        for key in want:
            _close(got[key], want[key], ctol)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_serve_loop_greedy_tokens_match_jax(arch, dtype):
    model, params, toks = _port(arch, dtype)
    _, _, steps, fed, _, _ = _jax_run(arch, dtype)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    got = []
    for i in range(STEPS):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        got.append(tok.numpy())
        logits, caches = model.decode_step(params, tok, caches, S + i)
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(fed, 1))
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(),
                                  steps[-1][:, -1].argmax(-1))


@pytest.mark.parametrize("arch,dtype", CASES[:3])
def test_naive_and_pallas_impls_agree(arch, dtype):
    model, params, toks = _port(arch, dtype)
    naive, _, _ = _port(arch, dtype, impl="naive")
    batch = {"tokens": torch.from_numpy(toks)}
    tol = TOL[dtype][0]
    _close(model.prefill(params, batch)[0], naive.prefill(params, batch)[0],
           tol)


def test_decode_step_matches_the_full_forward():
    """Prefill of S tokens == prefill of S - 1 plus one decode step (the
    JAX package's own check, tests/test_smoke_archs.py, at its 2e-3)."""
    model, params, toks = _port("gemma3-4b", "float32")
    t = torch.from_numpy(toks)
    full, _ = model.prefill(params, {"tokens": t})
    _, caches = model.prefill(params, {"tokens": t[:, :-1]})
    dec, _ = model.decode_step(params, t[:, -1:], caches, S - 1)
    _close(dec, full, 2e-3)


def test_embedding_multiplier_rounds_like_jax():
    """The JAX package scales a bf16 embedding by √d as a weakly typed
    scalar, rounded to bf16 first (55.5, not 55.4256, at d = 3072)."""
    table = np.random.default_rng(7).normal(size=(256, 3072)).astype(
        ml_dtypes.bfloat16)
    toks = np.arange(0, 256, 5, dtype=np.int32)[None]
    want = jnp.take(jnp.asarray(table), jnp.asarray(toks), axis=0) \
        * math.sqrt(3072)
    model = build_model(TORCH_ARCHS["llama3.2-3b"].reduced(
        d_model=3072, num_heads=24, head_dim=128))
    got = model._embed(lm_params_from_jax({"embed": table}, device="cpu"),
                       torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_params_keep_the_jax_tree_and_layout():
    cfg = ARCHS["h2o-danube-3-4b"].reduced()
    jax_shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    mine = build_model(TORCH_ARCHS["h2o-danube-3-4b"].reduced()).init(
        0, device="cpu")
    back = lm_params_to_jax(mine)
    assert jax.tree.structure(back) == jax.tree.structure(jax_shapes)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype
    n = sum(x.size for x in jax.tree.leaves(back))
    assert n == cfg.param_count()


def test_lm_params_round_trip_keeps_bf16_bits_and_layout():
    params, *_ = _jax_run("llama3.2-3b", "bfloat16")
    tp = lm_params_from_jax(params, device="cpu")
    wq = tp["segments"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 64)
    for a, b in zip(jax.tree.leaves(lm_params_to_jax(tp)),
                    jax.tree.leaves(params)):
        assert a.dtype == b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(a.view(np.int16), b.view(np.int16))


def test_a_4d_leaf_that_is_not_a_conv_kernel_is_never_permuted():
    experts = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    got = lm_params_from_jax({"moe": {"experts": experts}}, device="cpu")
    np.testing.assert_array_equal(got["moe"]["experts"].numpy(), experts)
    with pytest.raises(ValueError, match="not a ResNet conv kernel"):
        params_from_jax({"moe": {"experts": experts}}, device="cpu")
    conv = params_from_jax({"conv1": experts}, device="cpu")["conv1"]
    assert conv.shape == (5, 4, 2, 3)       # HWIO -> OIHW


# ---------------------------------------------------------------------------
# what is not ported is refused by name
# ---------------------------------------------------------------------------

#: MLA and MoE archs, the SSM and hybrid ones, and the frontend and
#: encoder-decoder ones, refused until their blocks were ported: their
#: cases now check that they build and prefill
PORTED_SINCE = {"deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
                "falcon-mamba-7b", "hymba-1.5b", "seamless-m4t-large-v2",
                "internvl2-26b"}


def _builds_and_prefills(cfg, **over):
    model = build_model(cfg, _opts(ModelOptions, mesh=make_host_mesh(),
                                   **over))
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    if cfg.frontend:
        batch["frontend"] = torch.zeros(1, cfg.frontend_tokens, cfg.d_model)
    logits, caches = model.prefill(model.init(0, device="cpu"), batch)
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert len(caches) == len(model.init_decode(1, 8, device="cpu"))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b",
                                  "deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
                                  "seamless-m4t-large-v2", "internvl2-26b"])
def test_unported_archs_are_refused(arch):
    cfg = TORCH_ARCHS[arch].reduced()
    if arch in PORTED_SINCE:
        for impl in ("dense", "ep"):
            _builds_and_prefills(cfg, moe_impl=impl)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        build_model(cfg, _opts(ModelOptions))


def test_moe_ep_needs_a_model_axis_of_size_1():
    """ep in one process is the expert-parallel body with every expert
    local: without a mesh it is refused, and a model axis above 1 is
    refused in one process (it runs across ranks,
    ``tests/test_torch_model_axis.py``)."""
    cfg = TORCH_ARCHS["deepseek-v2-lite-16b"].reduced(dtype="float32")
    model = build_model(cfg, _opts(ModelOptions, moe_impl="ep"))
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        model.prefill(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
    with pytest.raises(ValueError, match="spawn_ranks"):
        make_debug_mesh((1, 2), ("data", "model"))


@pytest.mark.parametrize("over,item", [
    ({"attn_impl": "chunked_sp"}, "A.8"),
    ({"attn_impl": "chunked", "vocab_axis": "model"}, "A.8"),
    ({"attn_impl": "chunked_sp", "remat": True}, "A.8"),
    ({"vocab_axis": "model"}, "A.8"),
])
def test_unported_options_are_refused(over, item):
    opts = dict(attn_impl="pallas", remat=False, prefill_cache_capacity=16)
    opts.update(over)
    model = build_model(TORCH_ARCHS["llama3.2-3b"].reduced(dtype="float32"),
                        ModelOptions(**opts))
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        model.prefill(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})


def test_training_moe_and_cross_attention_are_refused():
    """A frontend handed to a config without one is ignored by prefill
    and loss, as in the JAX package.  Training a frontend or
    encoder-decoder config was refused until its fused round was ported
    (ROADMAP A.6); now its loss is finite and ``frontend_proj`` (and an
    encoder) get a gradient (``tests/test_torch_front_train.py`` holds
    them against the JAX package)."""
    cfg = TORCH_ARCHS["llama3.2-3b"].reduced(dtype="float32")
    model = build_model(cfg, _opts(ModelOptions))
    params = model.init(0, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    front = torch.ones(1, 2, 64)
    loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
    assert torch.equal(model.loss(params, {"tokens": toks, "labels": toks,
                                           "frontend": front})[0], loss)
    logits, _ = model.prefill(params, {"tokens": toks})
    assert torch.equal(model.prefill(params, {"tokens": toks,
                                              "frontend": front})[0], logits)
    for arch in ("internvl2-26b", "seamless-m4t-large-v2"):
        fcfg = TORCH_ARCHS[arch].reduced(dtype="float32")
        fmodel = build_model(fcfg, _opts(ModelOptions))
        fparams = fmodel.init(0, device="cpu")
        front = [fparams["frontend_proj"].requires_grad_()] + [
            l.requires_grad_() for l in tree_leaves(
                fparams.get("encoder", {}))]
        floss, _ = fmodel.loss(fparams, {
            "tokens": toks, "labels": toks,
            "frontend": torch.ones(1, fcfg.frontend_tokens, 64)})
        assert bool(torch.isfinite(floss))
        assert all(bool(g.any()) for g in torch.autograd.grad(floss, front))
    # MoE blocks serve and, since the MoE fused round is ported, train:
    # a dense arch given an MoE config builds, prefills and takes a step
    moe = cfg.__class__(**{**cfg.__dict__, "moe": MoEConfig(
        num_experts=4, top_k=2, expert_d_ff=32)})
    _builds_and_prefills(moe)
    step, moe_model = build_train_step(
        moe, make_debug_mesh((1, 1), ("data", "model")),
        AggregationConfig(num_microbatches=1))
    assert moe_model.opts.moe_impl == "ep"
    moe_params = moe_model.init(0, device="cpu")
    _, _, metrics = step(moe_params, init_server_state("fedavg", moe_params),
                         {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(metrics["loss"]))
    # cross-attention builds and runs (tests/test_torch_frontend.py holds
    # it against the JAX package): no q/k norm on a cross layer
    gemma = TORCH_ARCHS["gemma3-4b"].reduced(dtype="float32")
    layer = tattn.init_attention(torch.Generator().manual_seed(0), gemma,
                                 torch.float32, cross=True)
    assert "q_norm" not in layer and "q_norm" in tattn.init_attention(
        torch.Generator().manual_seed(0), gemma, torch.float32)
    x = torch.zeros(1, 4, 64)
    out = tattn.attention(gemma, layer, x, torch.arange(4),
                          memory=torch.zeros(1, 6, 64), impl="naive")
    assert out.shape == (1, 4, 64)
    assert sharded_vocab.padded_vocab(cfg.vocab_size) == 256
