"""The port's Mamba SSM block and the SSM and hybrid LMs built of it
against the JAX package's.

Block-level inputs are drawn with numpy from a seed; the JAX package's
``init_ssm`` makes the block's params, which ``lm_params_from_jax``
carries across.  The JAX side runs its functions under ``jax.jit``.  The LM level runs reduced falcon-mamba-7b (2 SSM
layers) and hymba-1.5b (2 hybrid layers: layer 0 global, layer 1 a
window of 8; 4 query heads over 2 KV heads, head dim 16), d_model 64,
d_inner 128, N 8, dt_rank 8, vocab 256, with ``ssm_chunk=16`` (S = 40:
four chunks of 10; 39: three of 13), and ``attn_impl="pallas"`` on both
sides, as ``tests/test_torch_lm.py``: the plain version of the flash
kernel in the port, the Pallas kernel in interpret mode in JAX.  The
hymba prompt (40 tokens) is longer than its window, so layer 1's ring of
8 slots has wrapped before the decode steps.

Tolerances, rtol = atol:
* the causal conv: fp32 1e-6; bf16 8e-3 (its four products and adds
  round to bf16 at each step in the port, where XLA may keep a fused
  sum wider: one bf16 ulp of an output near 1);
* the associative scan, the chunked scan, the block and its decode:
  fp32 1e-5 (products and sums in another order over up to 250 steps);
  bf16 2e-2 for the scan on bf16 operands and 3e-2 for the block, whose
  projections round to bf16 (about two bf16 ulps of an output near 1);
* the LMs: fp32 1e-4, bf16 logits 6e-2 and caches 2e-2, those of
  ``tests/test_torch_lm.py``.  The decode state ``h`` that the port
  takes from the block's own scan is held to the same cache tolerance
  against the JAX package's, which scans a second time;
* softplus: the port's ``logaddexp(x, 0)`` within 1e-7 of
  ``jax.nn.softplus``; ``F.softplus``, which is the identity above 20,
  stays within one fp32 ulp of it (below every tolerance here);
* prefill of S - 1 plus a decode step against prefill of S: the JAX
  package's 2e-3;
* checkpoints and the flat wire: bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import ARCHS
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
from repro.models.transformer import _ssm_cache_from_prefill
from repro.runtime.trainer import _flatten_tree as jax_flatten
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.convert import (flatten_jax_layout, lm_params_from_jax,
                                 lm_params_to_jax, unflatten_jax_layout)
from repro_torch.fl.round import AggregationConfig, build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models import ssm as tssm
from repro_torch.tree import named_leaves, tree_leaves

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

DTYPES = ("float32", "bfloat16")
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
CONV_TOL = {"float32": 1e-6, "bfloat16": 8e-3}
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 2e-2)}   # logits, caches
ARCH_NAMES = ("falcon-mamba-7b", "hymba-1.5b")
B, S, STEPS, CHUNK = 2, 40, 3, 16


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _both(x: np.ndarray, dtype: str):
    """The same rounded values in both packages."""
    if dtype == "bfloat16":
        xn = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xn), torch.from_numpy(xn.view(np.int16)).view(
            torch.bfloat16)
    xn = x.astype(np.float32)
    return jnp.asarray(xn), torch.from_numpy(xn)


def _normal(shape, seed, dtype="float32", scale=1.0):
    return _both(np.random.default_rng(seed).normal(size=shape) * scale,
                 dtype)


def _block_params(dtype):
    cfg = ARCHS["falcon-mamba-7b"].reduced(dtype=dtype)
    jp = jssm.init_ssm(jax.random.PRNGKey(0), cfg, cfg.d_model,
                       jnp.dtype(dtype))
    return cfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


# ---------------------------------------------------------------------------
# the block's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(dtype, with_state):
    xj, xt = _normal((2, 9, 24), 0, dtype)
    wj, wt = _normal((4, 24), 1, dtype, scale=0.5)
    state = None
    if with_state:
        state = _normal((2, 3, 24), 2, dtype)
    got = tssm._causal_conv(xt, wt, state[1] if state else None)
    want = jssm._causal_conv(xj, wj, state[0] if state else None)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, CONV_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 7, 8, 250])
def test_associative_scan_matches_jax(n, dtype):
    """On the affine combine, as the chunked scan calls it: a in (0, 1),
    b of either sign, over the chunk axis."""
    rng = np.random.default_rng(n)
    aj, at = _both(rng.uniform(0.5, 1.0, size=(2, n, 6, 4)), dtype)
    bj, bt = _both(rng.normal(size=(2, n, 6, 4)) * 0.1, dtype)
    want = jax.jit(functools.partial(jax.lax.associative_scan,
                                     jssm._affine_combine, axis=1))((aj, bj))
    got = tssm.associative_scan(tssm._affine_combine, (at, bt), dim=1)
    for g, w in zip(got, want):
        assert g.dtype == at.dtype and g.shape == at.shape
        _close(g, w, SCAN_TOL[dtype])


def test_associative_scan_keeps_a_state_a_cumprod_would_lose():
    """Over 250 steps with a ≈ 0.85 the running product of a falls to
    about 1e-18, and the state is carried by b: the recursion keeps it."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.8, 0.9, size=(1, 250, 3)).astype(np.float32)
    b = rng.normal(size=(1, 250, 3)).astype(np.float32)
    a_cum, h = tssm.associative_scan(
        tssm._affine_combine, (torch.from_numpy(a), torch.from_numpy(b)),
        dim=1)
    want = np.zeros((1, 3))
    for t in range(250):
        want = a[:, t].astype(np.float64) * want + b[:, t]
    assert float(a_cum[0, -1].max()) < 1e-15
    np.testing.assert_allclose(h[:, -1].numpy(), want, rtol=1e-5, atol=1e-5)


def test_softplus_is_jax_softplus():
    x = np.linspace(-60, 60, 4001).astype(np.float32)
    mine = tssm.softplus(torch.from_numpy(x))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(mine.numpy(), want, rtol=1e-7, atol=1e-7)
    # F.softplus switches to the identity above 20 (off by log1p(e^-20),
    # 2e-9) and rounds another form below it: at most one fp32 ulp apart
    np.testing.assert_array_max_ulp(F.softplus(torch.from_numpy(x)).numpy(),
                                    mine.numpy(), maxulp=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq,chunk", [(30, 8), (37, 8), (250, 256)])
def test_scan_chunked_from_a_nonzero_state_matches_jax(seq, chunk, dtype):
    """S = 30 at chunk 8 scans 5 chunks of 6; S = 37 (prime) 37 chunks
    of 1; S = 250 one chunk of 250."""
    cfg, jp, tp = _block_params(dtype)
    d_in = tp["dt_proj"].shape[1]
    uj, ut = _normal((2, seq, d_in), 3, dtype)
    hj, ht = _normal((2, d_in, cfg.ssm.d_state), 4, "float32", scale=0.1)
    y, h = tssm.ssm_scan_chunked(cfg, tp, ut, ht, chunk=chunk)
    wy, wh = jax.jit(functools.partial(jssm.ssm_scan_chunked, cfg,
                                       chunk=chunk))(jp, uj, hj)
    assert y.dtype == h.dtype == torch.float32
    _close(y, wy, SCAN_TOL["float32"])
    _close(h, wh, SCAN_TOL["float32"])
    assert tssm.scan_chunk(seq, chunk) == {30: 6, 37: 1, 250: 250}[seq]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_and_its_state_match_jax(dtype):
    cfg, jp, tp = _block_params(dtype)
    xj, xt = _normal((2, 30, cfg.d_model), 5, dtype)
    got, state = tssm.ssm_block(cfg, tp, xt, chunk=8, return_state=True)
    want = jax.jit(functools.partial(jssm.ssm_block, cfg, chunk=8))(jp, xj)
    assert got.dtype == xt.dtype
    _close(got, want, BLOCK_TOL[dtype])
    assert torch.equal(tssm.ssm_block(cfg, tp, xt, chunk=8), got)
    # the JAX package's decode state from its second scan
    jstate = _ssm_cache_from_prefill(cfg, jp, xj)
    assert state["h"].dtype == torch.float32
    assert state["conv"].dtype == xt.dtype
    for key in ("h", "conv"):
        assert state[key].shape == jstate[key].shape
        _close(state[key], jstate[key], TOL[dtype][1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_steps_match_jax(dtype):
    """Five steps from a non-zero state; the port writes the cache in
    place and the JAX package returns a new one."""
    cfg, jp, tp = _block_params(dtype)
    d_in = tp["dt_proj"].shape[1]
    hj, ht = _normal((2, d_in, cfg.ssm.d_state), 6, "float32", scale=0.1)
    cj, ct = _normal((2, cfg.ssm.d_conv - 1, d_in), 7, dtype)
    jcache = {"h": hj, "conv": cj}
    tcache = {"h": ht.clone(), "conv": ct.clone()}
    ptrs = [t.data_ptr() for t in tcache.values()]
    decode = jax.jit(functools.partial(jssm.ssm_decode, cfg))
    for i in range(5):
        xj, xt = _normal((2, 1, cfg.d_model), 10 + i, dtype)
        want, jcache = decode(jp, xj, jcache)
        got, tcache = tssm.ssm_decode(cfg, tp, xt, tcache)
        _close(got, want, BLOCK_TOL[dtype])
        _close(tcache["h"], jcache["h"], BLOCK_TOL[dtype])
        _close(tcache["conv"], jcache["conv"], BLOCK_TOL[dtype])
    assert [t.data_ptr() for t in tcache.values()] == ptrs


# ---------------------------------------------------------------------------
# the SSM and hybrid LMs
# ---------------------------------------------------------------------------


def _opts(cls, **over):
    return cls(attn_impl="pallas", remat=False, ssm_chunk=CHUNK,
               prefill_cache_capacity=S + STEPS + 8, **over)


def _tokens(vocab, seq=S):
    return np.random.default_rng(3).integers(0, vocab, size=(B, seq),
                                             dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype, vocab=0):
    """The JAX package's prefill and decode steps, as numpy (each
    compiled once with ``jax.jit``)."""
    over = {"vocab_size": vocab} if vocab else {}
    cfg = ARCHS[arch].reduced(dtype=dtype, **over)
    model = jax_build(cfg, _opts(JaxOptions))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    toks = _tokens(cfg.vocab_size)
    logits, caches = jax.jit(model.prefill)(params,
                                            {"tokens": jnp.asarray(toks)})
    pre_caches = jax.tree.map(np.asarray, caches)
    steps, fed = [np.asarray(logits)], []
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        fed.append(tok.astype(np.int32))
        logits, caches = decode(params, jnp.asarray(fed[-1]), caches,
                                jnp.int32(S + i))
        steps.append(np.asarray(logits))
    return (jax.tree.map(np.asarray, params), toks, steps, fed, pre_caches,
            jax.tree.map(np.asarray, caches))


def _port(arch, dtype, vocab=0):
    params, toks, *_ = _jax_run(arch, dtype, vocab)
    over = {"vocab_size": vocab} if vocab else {}
    model = build_model(TORCH_ARCHS[arch].reduced(dtype=dtype, **over),
                        _opts(ModelOptions))
    return model, lm_params_from_jax(params, device="cpu"), toks


def _caches_close(got, want, dtype):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
    g_leaves, w_leaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).replace("torch.", "") == w.dtype.name
        _close(g, w, TOL[dtype][1])


LM_CASES = [(a, d) for a in ARCH_NAMES for d in DTYPES]


@pytest.mark.parametrize("arch,dtype", LM_CASES)
def test_prefill_logits_and_every_cache_leaf_match_jax(arch, dtype):
    model, params, toks = _port(arch, dtype)
    _, _, steps, _, want_caches, _ = _jax_run(arch, dtype)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.float32 and logits.shape == (B, 1, 256)
    _close(logits, steps[0], TOL[dtype][0])
    _caches_close(caches, want_caches, dtype)
    keys = {"falcon-mamba-7b": [["conv", "h"]],
            "hymba-1.5b": [["k", "ssm", "v"]] * 2}[arch]
    assert [sorted(c) for c in caches] == keys


@pytest.mark.parametrize("arch,dtype", LM_CASES)
def test_decode_steps_and_serve_loop_match_jax(arch, dtype):
    """``decode_step`` fed the JAX package's greedy tokens (hymba's window
    ring has wrapped), then the port's own greedy loop: the same
    tokens."""
    model, params, toks = _port(arch, dtype)
    _, _, steps, fed, _, want_caches = _jax_run(arch, dtype)
    _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    for i, tok in enumerate(fed):
        logits, caches = model.decode_step(params, torch.from_numpy(tok),
                                           caches, S + i)
        _close(logits, steps[i + 1], TOL[dtype][0])
    _caches_close(caches, want_caches, dtype)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    mine = []
    for i in range(STEPS):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        mine.append(tok.numpy())
        logits, caches = model.decode_step(params, tok, caches, S + i)
    np.testing.assert_array_equal(np.concatenate(mine, 1),
                                  np.concatenate(fed, 1))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_step_matches_the_full_forward(arch):
    """Prefill of S tokens == prefill of S - 1 plus one decode step (the
    JAX package's tests/test_smoke_archs.py, at its 2e-3)."""
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    model = build_model(cfg, _opts(ModelOptions))
    params = model.init(0, device="cpu")
    t = torch.from_numpy(_tokens(cfg.vocab_size))
    full, _ = model.prefill(params, {"tokens": t})
    _, caches = model.prefill(params, {"tokens": t[:, :-1]})
    dec, _ = model.decode_step(params, t[:, -1:], caches, S - 1)
    _close(dec, full, 2e-3)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_scans_once_a_layer(arch, monkeypatch):
    """The decode state comes from the block's own scan: one
    ``ssm_scan_chunked`` a layer in a prefill (the JAX package runs a
    second scan for the cache)."""
    calls = []
    orig = tssm.ssm_scan_chunked

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tssm, "ssm_scan_chunked", counted)
    model, params, toks = _port(arch, "float32")
    model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert len(calls) == ARCHS[arch].reduced().num_layers


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_keep_the_jax_tree_and_layout(arch):
    """bf16 model: every leaf's key, shape and dtype as the JAX
    package's, ``A_log``, ``D`` and ``dt_bias`` fp32; the count is
    ``param_count()``, plus hymba's branch norms, which it leaves out in
    both packages."""
    cfg = ARCHS[arch].reduced()
    jax_shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    mine = build_model(TORCH_ARCHS[arch].reduced()).init(0, device="cpu")
    back = lm_params_to_jax(mine)
    assert jax.tree.structure(back) == jax.tree.structure(jax_shapes)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(jax_shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    ssm = mine["segments"][0]["ssm"]
    for key in ("A_log", "D", "dt_bias"):
        assert ssm[key].dtype == torch.float32
    assert ssm["in_proj"].dtype == ssm["conv_w"].dtype == torch.bfloat16
    n = sum(x.size for x in jax.tree.leaves(back))
    branch_norms = 2 * cfg.d_model * cfg.num_layers \
        if cfg.hybrid_parallel_ssm else 0
    assert n == cfg.param_count() + branch_norms


def test_conv_kernel_draws_with_sigma_one_half_as_jax_does():
    cfg = ARCHS["falcon-mamba-7b"].reduced(dtype="float32", d_model=512)
    jp = jssm.init_ssm(jax.random.PRNGKey(0), cfg, cfg.d_model, jnp.float32)
    tp = tssm.init_ssm(torch.Generator().manual_seed(0), cfg, cfg.d_model,
                       torch.float32)
    want = 0.8796 * 0.5          # a normal cut at ±2σ keeps 0.8796 of σ
    assert abs(float(jnp.std(jp["conv_w"])) - want) < 0.02 * want
    assert abs(float(tp["conv_w"].std()) - want) < 0.02 * want
    for key in ("dt_bias", "A_log", "D"):
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   rtol=1e-7, atol=0)


def test_hymba_strips_its_padded_vocab():
    """vocab 32001 pads to a table of 32256 rows; the logits are the
    first 32001 columns, as the JAX package's (bf16, the config's
    dtype)."""
    dtype = "bfloat16"
    model, params, toks = _port("hymba-1.5b", dtype, vocab=32001)
    _, _, steps, fed, _, _ = _jax_run("hymba-1.5b", dtype, 32001)
    assert params["embed"].shape == (32256, 64) and "lm_head" not in params
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.shape == (B, 1, 32001)
    _close(logits, steps[0], TOL[dtype][0])
    logits, _ = model.decode_step(params, torch.from_numpy(fed[0]), caches, S)
    assert logits.shape == (B, 1, 32001)
    _close(logits, steps[1], TOL[dtype][0])


# ---------------------------------------------------------------------------
# SSM trees through the flat wire and checkpoints
# ---------------------------------------------------------------------------


def _bits(a):
    if isinstance(a, torch.Tensor):
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


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_flat_wire_round_trips_an_ssm_tree(arch):
    """``conv_w`` is not a ResNet conv key and keeps its layout: the flat
    vector is the JAX package's, and it comes back bit for bit."""
    params = build_model(TORCH_ARCHS[arch].reduced()).init(2, device="cpu")
    flat, _, _ = flatten_jax_layout(params)
    jflat = jax_flatten(jax.tree.map(jnp.asarray,
                                     lm_params_to_jax(params)))[0]
    np.testing.assert_array_equal(flat, jflat)
    _assert_bit_equal(tree_leaves(unflatten_jax_layout(flat, params)),
                      tree_leaves(params))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_ssm_checkpoints_restore_both_ways(arch, tmp_path):
    jparams = _jax_run(arch, "bfloat16")[0]
    like = build_model(TORCH_ARCHS[arch].reduced()).init(1, device="cpu")
    j_save(tmp_path / "jax", 3, jparams)
    got, step = restore_checkpoint(tmp_path / "jax", like=like)
    assert step == 3
    _assert_bit_equal(tree_leaves(got),
                      tree_leaves(lm_params_from_jax(jparams, device="cpu")))
    save_checkpoint(tmp_path / "port", 4, like)
    back, step = j_restore(tmp_path / "port", jparams)
    assert step == 4
    _assert_bit_equal(jax.tree.leaves(jax.tree.map(np.asarray, back)),
                      tree_leaves(lm_params_to_jax(like)))


# ---------------------------------------------------------------------------
# they train, with the sharded scan (tests/test_torch_ssm_train.py holds
# that path against the JAX package)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_training_ssm_and_hybrid_blocks_is_refused(arch):
    """Refused until the SSM fused round was ported (ROADMAP A.6); now
    only the sharded scan without a mesh is refused (A.8): ``LM.loss``
    and ``build_train_step`` train SSM and hybrid blocks, and every leaf
    of the SSM branch gets a gradient."""
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 12))
    batch = {"tokens": toks, "labels": toks}
    unmeshed = build_model(cfg, _opts(ModelOptions, ssm_impl="sharded"))
    params = unmeshed.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        unmeshed.loss(params, batch)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    step, model = build_train_step(cfg, mesh,
                                   AggregationConfig(num_microbatches=1))
    assert model.opts.ssm_impl == "sharded"
    leaves = [l.requires_grad_() for l in tree_leaves(params)]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    reached = [bool(g.any()) for (k, _), g in zip(named_leaves(params), grads)
               if ".ssm." in k]
    assert len(reached) == 8 * len(params["segments"]) and all(reached)
    _, _, metrics = step(params, init_server_state("fedavg", params), batch)
    assert bool(torch.isfinite(metrics["loss"]))
    # a dense config keeps training with the fused round's options
    dense = TORCH_ARCHS["llama3.2-3b"].reduced(dtype="float32")
    build_train_step(dense, make_debug_mesh((1, 1), ("data", "model")),
                     AggregationConfig(num_microbatches=1))
