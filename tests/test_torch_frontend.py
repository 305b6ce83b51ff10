"""The port's modality frontends and encoder–decoder against the JAX
package's: internvl2-26b (a decoder-only model whose stub vision patches
are projected and put in front of the text) and seamless-m4t-large-v2
(an encoder over stub audio frames, cross-attention in every decoder
layer, a static cross cache at decode).

Reduced configs (2 layers, and seamless 2 encoder layers; d_model 64, 4
query heads over 2 KV heads, head dim 16, vocab 256, 4 frontend
tokens).  The JAX model makes its params from a PRNG key and
``lm_params_from_jax`` carries them across.  The JAX side runs its
attention under ``"pallas"`` (the Pallas kernel in interpret mode) and
under ``"chunked"``; the port runs the same option, whose plain
versions run on the CPU.  Frontend embeddings are drawn with numpy,
``normal(0, 0.02)``, as the JAX package's ``tests/test_smoke_archs.py``
draws them.

Tolerances, rtol = atol (those of ``tests/test_torch_lm.py``): fp32
1e-4 for logits and caches (fp32 sums in another order through the
stack); bf16 logits 6e-2 and caches 2e-2 (activations round to bf16 at
other places in the two frameworks).  Attention alone in fp32: 1e-5 (a
softmax over up to 1536 keys, summed in another order).  Prefill of
S - 1 tokens plus one decode step against prefill of S: the JAX
package's 2e-3, at internvl's position offset of its patches
(``tests/test_smoke_archs.py:76``).  Trees: keys, shapes, dtypes and
leaf order equal, values bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import ModelOptions as JaxOptions
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import ModelOptions, build_model
from repro_torch.models import attention as tattn
from repro_torch.tree import tree_leaves

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

ARCH_NAMES = ("internvl2-26b", "seamless-m4t-large-v2")
B, S, STEPS = 2, 13, 3
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 2e-2)}   # logits, caches
ATTN_TOL = 1e-5
CASES = [(a, impl, "float32") for a in ARCH_NAMES
         for impl in ("pallas", "chunked")] + \
        [(a, "pallas", "bfloat16") for a in ARCH_NAMES]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _offset(cfg) -> int:
    """Where a decode step's positions start past the prompt: after a
    decoder-only model's patches; an encoder's frames take none."""
    return cfg.frontend_tokens if cfg.frontend and not cfg.encoder_layers \
        else 0


def _opts(cls, cfg, impl="pallas", **over):
    return cls(attn_impl=impl, remat=False, prefill_cache_capacity=(
        _offset(cfg) + S + STEPS + 8), **over)


def _inputs(cfg, seq=S):
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(B, seq), dtype=np.int32)
    front = np.random.default_rng(4).normal(
        0, 0.02, size=(B, cfg.frontend_tokens, cfg.d_model)).astype(
            np.float32)
    return toks, front


@functools.lru_cache(maxsize=None)
def _jax_run(arch, impl, dtype):
    """The JAX package's prefill and greedy decode steps, as numpy."""
    cfg = ARCHS[arch].reduced(dtype=dtype)
    model = jax_build(cfg, _opts(JaxOptions, cfg, impl))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    toks, front = _inputs(cfg)
    logits, caches = jax.jit(model.prefill)(
        params, {"tokens": jnp.asarray(toks), "frontend": jnp.asarray(front)})
    pre_caches = jax.tree.map(np.asarray, caches)
    steps, fed = [np.asarray(logits)], []
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        fed.append(tok.astype(np.int32))
        logits, caches = decode(params, jnp.asarray(fed[-1]), caches,
                                jnp.int32(_offset(cfg) + S + i))
        steps.append(np.asarray(logits))
    return (jax.tree.map(np.asarray, params), steps, fed, pre_caches,
            jax.tree.map(np.asarray, caches))


def _port(arch, impl, dtype):
    params = _jax_run(arch, impl, dtype)[0]
    cfg = TORCH_ARCHS[arch].reduced(dtype=dtype)
    model = build_model(cfg, _opts(ModelOptions, cfg, impl))
    toks, front = _inputs(cfg)
    batch = {"tokens": torch.from_numpy(toks),
             "frontend": torch.from_numpy(front)}
    return model, lm_params_from_jax(params, device="cpu"), batch


def _caches_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
    g_leaves, w_leaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).replace("torch.", "") == w.dtype.name
        _close(g, w, tol)


# ---------------------------------------------------------------------------
# the param trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_keep_the_jax_tree_and_layout(arch):
    """bf16: every leaf's key, shape and dtype as the JAX package's, in
    its order; the count is ``param_count()`` plus the encoder's final
    norm, which it leaves out in both packages."""
    cfg = ARCHS[arch].reduced()
    jax_shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    mine = build_model(TORCH_ARCHS[arch].reduced()).init(0, device="cpu")
    back = lm_params_to_jax(mine)
    assert jax.tree.structure(back) == jax.tree.structure(jax_shapes)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(jax_shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert ("encoder" in mine) == bool(cfg.encoder_layers)
    assert mine["frontend_proj"].shape == (cfg.d_model, cfg.d_model)
    layer = mine["segments"][0]
    assert ("cross" in layer) == bool(cfg.encoder_layers)
    if cfg.encoder_layers:
        # no q/k norm on a cross layer; the encoder's layers have none
        assert sorted(layer["cross"]) == ["wk", "wo", "wq", "wv"]
        assert "cross" not in mine["encoder"]["segments"][0]
    n = sum(x.size for x in jax.tree.leaves(back))
    final_norm = cfg.d_model if cfg.encoder_layers else 0
    assert n == cfg.param_count() + final_norm


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_params_from_jax_carries_the_trees_unchanged(arch):
    """``lm_params_from_jax`` and back: the JAX tree, bit for bit."""
    params = _jax_run(arch, "pallas", "bfloat16")[0]
    back = lm_params_to_jax(lm_params_from_jax(params, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int16), b.view(np.int16))


# ---------------------------------------------------------------------------
# the LMs against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,impl,dtype", CASES)
def test_prefill_logits_and_every_cache_leaf_match_jax(arch, impl, dtype):
    """Caches hold internvl's patches in its ring ahead of the text and
    seamless's cross K/V of the encoded frames."""
    model, params, batch = _port(arch, impl, dtype)
    _, steps, _, want_caches, _ = _jax_run(arch, impl, dtype)
    logits, caches = model.prefill(params, batch)
    assert logits.dtype == torch.float32 and logits.shape == (B, 1, 256)
    _close(logits, steps[0], TOL[dtype][0])
    _caches_close(caches, want_caches, TOL[dtype][1])
    cfg = model.cfg
    keys = ["cross", "k", "v"] if cfg.encoder_layers else ["k", "v"]
    assert [sorted(c) for c in caches] == [keys]
    if cfg.encoder_layers:
        # every decoder layer's cross cache: the frames' K/V
        assert caches[0]["cross"]["k"].shape == (
            cfg.num_layers, B, cfg.frontend_tokens, cfg.num_kv_heads,
            cfg.head_dim)


@pytest.mark.parametrize("arch,impl,dtype", CASES)
def test_decode_steps_and_serve_loop_match_jax(arch, impl, dtype):
    """Three ``decode_step`` calls fed the JAX package's greedy tokens at
    its positions, then the port's own greedy loop: the same tokens.
    The cross cache is never written."""
    model, params, batch = _port(arch, impl, dtype)
    _, steps, fed, _, want_caches = _jax_run(arch, impl, dtype)
    off = _offset(model.cfg)
    _, caches = model.prefill(params, batch)
    cross = [c["cross"]["k"].clone() for c in caches if "cross" in c]
    for i, tok in enumerate(fed):
        logits, caches = model.decode_step(params, torch.from_numpy(tok),
                                           caches, off + S + i)
        _close(logits, steps[i + 1], TOL[dtype][0])
    _caches_close(caches, want_caches, TOL[dtype][1])
    assert all(torch.equal(c["cross"]["k"], k)
               for c, k in zip([c for c in caches if "cross" in c], cross))
    logits, caches = model.prefill(params, batch)
    mine = []
    for i in range(STEPS):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        mine.append(tok.numpy())
        logits, caches = model.decode_step(params, tok, caches, off + S + i)
    np.testing.assert_array_equal(np.concatenate(mine, 1),
                                  np.concatenate(fed, 1))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_step_matches_the_full_forward_at_the_offset(arch):
    """Prefill of S tokens == prefill of S - 1 plus one decode step at
    ``pos = F + S - 1`` for internvl (its patches come first) and
    ``S - 1`` for seamless (its frames are the encoder's), at the JAX
    package's 2e-3.  internvl decoded without the offset lands above
    it."""
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    model = build_model(cfg, _opts(ModelOptions, cfg))
    params = model.init(0, device="cpu")
    toks, front = _inputs(cfg)
    t, fe = torch.from_numpy(toks), torch.from_numpy(front)
    full, _ = model.prefill(params, {"tokens": t, "frontend": fe})

    def decoded(pos):
        _, caches = model.prefill(params, {"tokens": t[:, :-1],
                                           "frontend": fe})
        return model.decode_step(params, t[:, -1:], caches, pos)[0]

    _close(decoded(_offset(cfg) + S - 1), full, 2e-3)
    if _offset(cfg):
        assert float((decoded(S - 1) - full).abs().max()) > 2e-3


def test_an_encoder_decoders_cache_holds_the_memory_rows():
    cfg = TORCH_ARCHS["seamless-m4t-large-v2"].reduced(dtype="float32")
    caches = build_model(cfg).init_decode(3, 16, device="cpu")
    assert caches[0]["cross"]["v"].shape == (
        cfg.num_layers, 3, cfg.frontend_tokens, cfg.num_kv_heads,
        cfg.head_dim)
    assert caches[0]["k"].shape[2] == 16
    llama = TORCH_ARCHS["llama3.2-3b"].reduced(dtype="float32")
    assert "cross" not in build_model(llama).init_decode(3, 16,
                                                         device="cpu")[0]


# ---------------------------------------------------------------------------
# cross-attention against the JAX package
# ---------------------------------------------------------------------------


def _cross_inputs(sm, seed=0):
    cfg = ARCHS["seamless-m4t-large-v2"].reduced(dtype="float32")
    jp = jattn.init_attention(jax.random.PRNGKey(seed), cfg, jnp.float32,
                              cross=True)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, sm, cfg.d_model)).astype(np.float32)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp, x, mem


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("sm", [1100, 1536])
def test_cross_attention_matches_jax(impl, sm):
    """A memory over 1024 rows, as the model hands to ``attn_impl``, and
    over ``block_kv`` (512): ``_attend_chunked`` scans three blocks.  At
    1100 rows the last block is ragged, and in both packages its padded
    keys are attended (zero scores and values): the chunked result is
    not the naive one there, as in the JAX package; at 1536 it is."""
    cfg, jp, tp, x, mem = _cross_inputs(sm)
    pos = np.arange(7)
    want = jattn.attention(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                           memory=jnp.asarray(mem), impl=impl)
    got, (k, v) = tattn.attention(cfg, tp, torch.from_numpy(x),
                                  torch.from_numpy(pos),
                                  memory=torch.from_numpy(mem), impl=impl,
                                  return_kv=True)
    _close(got, want, ATTN_TOL)
    # the K/V it attended over are the static cross cache
    cache = jattn.init_cross_cache(cfg, jp, jnp.asarray(mem))
    _close(k, cache["k"], ATTN_TOL)
    _close(v, cache["v"], ATTN_TOL)
    naive = tattn.attention(cfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos),
                            memory=torch.from_numpy(mem), impl="naive")
    padded = impl == "chunked" and sm % 512
    assert (float((got - naive).abs().max()) > 1e-3) == bool(padded)


def test_cross_cache_and_cross_decode_match_jax():
    cfg, jp, tp, x, mem = _cross_inputs(24, seed=1)
    want = jattn.init_cross_cache(cfg, jp, jnp.asarray(mem))
    got = tattn.init_cross_cache(cfg, tp, torch.from_numpy(mem))
    for key in ("k", "v"):
        assert tuple(got[key].shape) == want[key].shape
        _close(got[key], want[key], ATTN_TOL)
    one = x[:, :1]
    _close(tattn.cross_attention_decode(cfg, tp, torch.from_numpy(one), got),
           jattn.cross_attention_decode(cfg, jp, jnp.asarray(one), want),
           ATTN_TOL)


def test_pallas_refuses_a_cross_memory_of_another_length():
    """The flash kernel computes self-attention over one length.  The
    JAX package's kernel, handed a memory of 1100 rows for 7 queries,
    reads only the first 7 (its ``ops.py`` says it assumes
    ``arange``); the port refuses, on the CPU path as on the card's
    wrapper, and so does a model whose memory is over 1024 under
    ``"pallas"``."""
    cfg, jp, tp, x, mem = _cross_inputs(1100)
    jq, jk, jv = jattn._project_qkv(cfg, jp, jnp.asarray(x), jnp.asarray(mem),
                                    None, None, rope=False)
    first = jattn._attend_naive(jq, jk[:, :7], jv[:, :7], np.arange(7),
                                np.arange(7), -1, False, 0.25)
    silent = jfa_ops.flash_attention(jq, jk, jv, window=-1, causal=False,
                                     scale=0.25, impl="pallas_interpret")
    _close(silent, first, ATTN_TOL)
    with pytest.raises(ValueError, match="self-attention over one length"):
        tattn.attention(cfg, tp, torch.from_numpy(x), torch.arange(7),
                        memory=torch.from_numpy(mem), impl="pallas")
    q = torch.zeros(1, 7, 2, 2, 16)
    kv = torch.zeros(1, 1100, 2, 16)
    for impl in ("auto", "torch"):
        with pytest.raises(ValueError, match="one length"):
            fa_ops.flash_attention(q, kv, kv, impl=impl)
    long = dataclasses.replace(TORCH_ARCHS["seamless-m4t-large-v2"].reduced(
        dtype="float32"), frontend_tokens=1100)
    model = build_model(long, _opts(ModelOptions, long))
    params = model.init(0, device="cpu")
    toks, _ = _inputs(long, seq=5)
    front = torch.zeros(1, 1100, long.d_model)
    with pytest.raises(ValueError, match="self-attention over one length"):
        model.prefill(params, {"tokens": torch.from_numpy(toks[:1]),
                               "frontend": front})
    # the same model under "chunked" takes the blockwise scan
    chunked = build_model(long, _opts(ModelOptions, long, impl="chunked"))
    logits, _ = chunked.prefill(params, {"tokens": torch.from_numpy(toks[:1]),
                                         "frontend": front})
    assert bool(torch.isfinite(logits).all())


def test_a_frontend_config_needs_its_frontend():
    cfg = TORCH_ARCHS["internvl2-26b"].reduced(dtype="float32")
    model = build_model(cfg, _opts(ModelOptions, cfg))
    with pytest.raises(ValueError, match="'frontend'"):
        model.prefill(model.init(0, device="cpu"),
                      {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
