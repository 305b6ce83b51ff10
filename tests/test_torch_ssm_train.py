"""The port's SSM and hybrid training path against the JAX package's:
``ssm_scan_sharded`` (the fused round's scan), ``LM.loss`` and its
gradients, ``accumulate_updates``, ``FusedFLTrainer`` and the
hierarchical int8 step of falcon-mamba-7b and hymba-1.5b.

Reduced configs (2 layers, d_model 64, d_inner 128, N 8, dt_rank 8,
vocab 256; hymba's layer 0 global and layer 1 a window of 8, 4 query
heads over 2 KV heads) with the fused round's options (``chunked_sp``,
``ssm_impl="sharded"``, vocab over the model axis) and ``ssm_chunk=8``,
so a sequence of 20 tokens scans 4 chunks of 5 and one of 24 3 chunks
of 8.  The JAX model makes the params, which ``lm_params_from_jax``
carries across; batches are drawn with numpy from a seed.  The JAX side
runs its own code under ``jax.jit``: the ``shard_map`` scan on a (1, 1)
(data, model) mesh of the CPU, the hierarchical step in a subprocess
with two forced host devices.

Tolerances, each with its reason:

* ``ssm_scan_sharded`` in fp32, y, the final state and the gradients of
  u, h0 and the scan's five params: rtol = atol 1e-5 (products and sums
  in another order over up to 37 steps, ``tests/test_torch_ssm.py``'s
  scan tolerance); with bf16 u, 2e-2 for y and u's gradient (u and y
  round to bf16: one bf16 ulp of a value near 2) and 1e-5 for the rest;
* ``LM.loss`` and its gradients, remat on and off, fp32: loss atol 1e-5,
  gradients rtol 1e-4 and atol 1e-5 (``tests/test_torch_moe_train.py``'s);
  bf16: loss atol 2e-3 and gradients rtol 2e-2, atol 4e-3, about four
  bf16 ulps of the largest gradient (0.21): activations and gradients
  round to bf16 at other places in the two frameworks (the JAX loss
  itself moves by 1e-3 between remat on and off);
* the decode state from the sharded scan against the JAX package's
  prefill under ``ssm_impl="sharded"`` (which takes it from a second,
  chunked scan): the cache tolerance of ``tests/test_torch_ssm.py``,
  fp32 1e-4;
* ``accumulate_updates``: rtol 5e-5, atol 1e-6, the JAX package's own
  eager-vs-lazy tolerance;
* ``FusedFLTrainer`` losses over three rounds: 1e-5;
* the hierarchical int8 step on two pods: the two-part limit of
  ``int8_round_limit``; without compression params within 5e-5;
* ``fake_quantize_tree`` of a hymba delta: bit for bit.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.compat import use_mesh
from repro.configs import ARCHS
from repro.data.loader import CohortTokenLoader
from repro.fl import compression as jcomp
from repro.fl.round import AggregationConfig as JaxAgg
from repro.fl.round import accumulate_updates as jax_accumulate
from repro.fl.server import init_server_state as jax_server_state
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
from repro.runtime.trainer import FusedFLTrainer as JaxTrainer
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.convert import (lm_params_from_jax, metrics_from_jax,
                                 tree_from_jax)
from repro_torch.fl import compression as tcomp
from repro_torch.fl.round import AggregationConfig, accumulate_updates
from repro_torch.fl.round import build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models import ssm as tssm
from repro_torch.runtime import FusedFLTrainer
from repro_torch.tree import (named_leaves, tree_flatten, tree_leaves,
                              tree_unflatten)
from test_torch_fused_round import ForcedRun, _pod_steps, int8_round_limit

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

JAX_MESH = jax_debug_mesh((1, 1), ("data", "model"))
ARCH_NAMES = ("falcon-mamba-7b", "hymba-1.5b")
CHUNK = 8
#: dtype -> (loss atol, gradient rtol, gradient atol)
GRAD_TOL = {"float32": (1e-5, 1e-4, 1e-5), "bfloat16": (2e-3, 2e-2, 4e-3)}
SCAN_KEYS = ("x_proj", "dt_proj", "dt_bias", "A_log", "D")


def _opts(cls, **over):
    base = dict(attn_impl="chunked_sp", ssm_impl="sharded",
                model_axis="model", vocab_axis="model", loss_chunk=16,
                block_kv=8, ssm_chunk=CHUNK, remat=False)
    base.update(over)
    if cls is JaxOptions:
        return cls(dp_axes=("data",), **base)
    return cls(dp_axes=("data",), mesh=make_host_mesh(), **base)


def _batch(vocab, B=2, S=20, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S))
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1                      # an ignored label per row
    return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32"):
    model = jax_build(ARCHS[arch].reduced(dtype=dtype), _opts(JaxOptions))
    with use_mesh(JAX_MESH):
        return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, dtype):
    """JAX's loss and gradients, without remat (the port's remat on and
    off are held to them)."""
    model = jax_build(ARCHS[arch].reduced(dtype=dtype), _opts(JaxOptions))
    with use_mesh(JAX_MESH):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b)[0]))(_jax_params(arch, dtype),
                                               _jb(_batch(256)))
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port_grads(model, params, batch):
    leaves, treedef = tree_flatten(params)
    live = [l.detach().clone().requires_grad_() for l in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, live), batch)
    return loss.detach(), torch.autograd.grad(loss, live,
                                              materialize_grads=True)


# ---------------------------------------------------------------------------
# ssm_scan_sharded
# ---------------------------------------------------------------------------


def _scan_inputs(dtype, seq):
    cfg = ARCHS["falcon-mamba-7b"].reduced(dtype="float32")
    jp = jax.tree.map(np.asarray, jssm.init_ssm(
        jax.random.PRNGKey(0), cfg, cfg.d_model, jnp.dtype(dtype)))
    jp = {k: jp[k] for k in SCAN_KEYS}
    d_in = jp["dt_proj"].shape[1]
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, seq, d_in)).astype(np.float32)
    if dtype == "bfloat16":
        u = u.astype(ml_dtypes.bfloat16)
    h0 = (rng.normal(size=(2, d_in, cfg.ssm.d_state)) * 0.1).astype(
        np.float32)
    cy = rng.normal(size=(2, seq, d_in)).astype(np.float32)
    ch = rng.normal(size=h0.shape).astype(np.float32)
    return cfg, jp, u, h0, cy, ch


def _torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("intra", ["seq", "assoc"])
@pytest.mark.parametrize("seq,chunk,dtype", [
    (30, 8, "float32"), (37, 8, "float32"), (16, 16, "float32"),
    (30, 8, "bfloat16")])
def test_ssm_scan_sharded_matches_jax(seq, chunk, dtype, intra):
    """S = 30 at chunk 8 scans 5 chunks of 6; S = 37 (prime) 37 chunks of
    1; S = 16 one chunk of 16; every case from a non-zero h0.  y and the
    final state, and the gradients of ``Σ y·cy + Σ h·ch`` for u, h0 and
    the scan's params."""
    cfg, jp, u, h0, cy, ch = _scan_inputs(dtype, seq)

    def jloss(p, uu, hh):
        y, h = jssm.ssm_scan_sharded(cfg, p, uu, hh, chunk=chunk,
                                     dp_axes=("data",), model_axis="model",
                                     intra_chunk=intra)
        return jnp.sum(y * cy) + jnp.sum(h * ch), (y, h)

    with use_mesh(JAX_MESH):
        (_, (wy, wh)), wg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
                jp, jnp.asarray(u), jnp.asarray(h0))
    tp = {k: _torch(v).requires_grad_() for k, v in jp.items()}
    tu = _torch(u).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    y, h = tssm.ssm_scan_sharded(cfg, tp, tu, th, chunk=chunk,
                                 dp_axes=("data",), model_axis="model",
                                 intra_chunk=intra, mesh=make_host_mesh())
    assert y.dtype == h.dtype == torch.float32
    assert tssm.scan_chunk(seq, chunk) == {30: 6, 37: 1, 16: 16}[seq]
    grads = torch.autograd.grad(
        (y * torch.from_numpy(cy)).sum() + (h * torch.from_numpy(ch)).sum(),
        [tp[k] for k in sorted(tp)] + [tu, th])
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    got = {"y": y, "h": h, "u": grads[-2], "h0": grads[-1],
           **{k: g for k, g in zip(sorted(tp), grads)}}
    want = {"y": wy, "h": wh, "u": wg[1], "h0": wg[2], **wg[0]}
    for name, g in got.items():
        assert g.dtype == (tu.dtype if name == "u" else
                           tp[name].dtype if name in tp else torch.float32)
        np.testing.assert_allclose(
            g.detach().float().numpy(), np.asarray(want[name], np.float32),
            rtol=tol, atol=tol, err_msg=name)


def test_ssm_scan_sharded_needs_a_model_axis_of_size_1():
    """Without a mesh the model axis cannot be resolved (ROADMAP A.8);
    above size 1 it shards d_inner over the model ranks, and a d_inner
    that does not split over them is refused by name before any
    collective."""
    cfg, jp, u, h0, _, _ = _scan_inputs("float32", 8)
    tp = {k: _torch(v) for k, v in jp.items()}
    for mesh, error, text in (
            (None, NotImplementedError, "ROADMAP A.8"),
            (types.SimpleNamespace(shape={"data": 1, "model": 3}),
             ValueError, "a d_inner of 128 does not split over 3 'model'")):
        with pytest.raises(error, match=text):
            tssm.ssm_scan_sharded(cfg, tp, torch.from_numpy(u),
                                  torch.from_numpy(h0), chunk=4,
                                  dp_axes=("data",), model_axis="model",
                                  mesh=mesh)


def test_the_seq_form_holds_no_level_tensor(monkeypatch):
    """The seq chunk body never builds a (B, c, d_in, N) tensor: the
    largest tensor any of its steps makes is one state (B, d_in, N)."""
    cfg, jp, u, h0, _, _ = _scan_inputs("float32", 24)
    tp = {k: _torch(v) for k, v in jp.items()}
    sizes = []
    exp = torch.exp

    def watched(x, *a, **kw):
        sizes.append(x.numel())
        return exp(x, *a, **kw)

    monkeypatch.setattr(torch, "exp", watched)
    tssm.ssm_scan_sharded(cfg, tp, torch.from_numpy(u), torch.from_numpy(h0),
                          chunk=8, dp_axes=("data",), model_axis="model",
                          mesh=make_host_mesh())
    # softplus's and A's, then one a step
    assert len(sizes) == 2 + 24
    assert max(sizes[2:]) == h0.size


# ---------------------------------------------------------------------------
# LM.loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_loss_and_grads_match_jax(arch, dtype, remat):
    loss_tol, rtol, atol = GRAD_TOL[dtype]
    jloss, jgrads = _jax_loss_and_grads(arch, dtype)
    model = build_model(TORCH_ARCHS[arch].reduced(dtype=dtype),
                        _opts(ModelOptions, remat=remat))
    params = lm_params_from_jax(_jax_params(arch, dtype), device="cpu")
    loss, grads = _port_grads(model, params, _tb(_batch(256)))
    assert abs(float(loss) - jloss) < loss_tol
    assert len(grads) == len(jgrads)
    for (name, leaf), g, w in zip(named_leaves(params), grads, jgrads):
        assert g.dtype == leaf.dtype
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=name)
    # every SSM leaf of every layer is reached
    for (name, _), g in zip(named_leaves(params), grads):
        if ".ssm." in name:
            assert all(bool(layer.any()) for layer in g), name


def test_nested_chunk_recompute_gives_jax_gradients(monkeypatch):
    """Under remat each chunk body runs three times: in the forward, in
    the layer's recompute, and in its own recompute inside the layer's
    backward; the gradients are JAX's (its ``jax.checkpoint`` chunk body
    nested in the layer's)."""
    arch = "falcon-mamba-7b"
    runs = []
    body = tssm._chunk_seq

    def counted(*args):
        runs.append(1)
        return body(*args)

    monkeypatch.setattr(tssm, "_chunk_seq", counted)
    model = build_model(TORCH_ARCHS[arch].reduced(dtype="float32"),
                        _opts(ModelOptions, remat=True))
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    _, grads = _port_grads(model, params, _tb(_batch(256)))
    layers, chunks = 2, 20 // tssm.scan_chunk(20, CHUNK)
    assert len(runs) == 3 * layers * chunks
    _, jgrads = _jax_loss_and_grads(arch, "float32")
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_state_of_the_sharded_scan_matches_jax_prefill(arch):
    """With ``ssm_impl="sharded"`` the decode state is the sharded scan's
    final state (one scan a layer); the JAX package's prefill under the
    same option scans a second time, chunked."""
    over = dict(attn_impl="chunked", vocab_axis=None,
                prefill_cache_capacity=32)
    jmodel = jax_build(ARCHS[arch].reduced(dtype="float32"),
                       _opts(JaxOptions, **over))
    toks = _batch(256)["tokens"]
    with use_mesh(JAX_MESH):
        wl, wc = jax.jit(jmodel.prefill)(_jax_params(arch),
                                         {"tokens": jnp.asarray(toks)})
    model = build_model(TORCH_ARCHS[arch].reduced(dtype="float32"),
                        _opts(ModelOptions, **over))
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(wl), rtol=1e-4,
                               atol=1e-4)
    got, want = tree_leaves(caches), jax.tree.leaves(wc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the fused round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_accumulate_updates_eager_lazy_and_jax(arch):
    cfg = ARCHS[arch].reduced(dtype="float32")
    jmodel = jax_build(cfg, _opts(JaxOptions))
    batch = _batch(cfg.vocab_size, B=4, S=16)
    model = build_model(TORCH_ARCHS[arch].reduced(dtype="float32"),
                        _opts(ModelOptions))
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    out = {}
    for timing in ("eager", "lazy"):
        agg = dict(timing=timing, num_microbatches=2)
        with use_mesh(JAX_MESH):
            jd, jw, jl = jax.jit(functools.partial(
                jax_accumulate, jmodel, agg=JaxAgg(**agg)))(
                    _jax_params(arch), _jb(batch))
        d, w, l = accumulate_updates(model, params, _tb(batch),
                                     AggregationConfig(**agg))
        assert float(w) == float(jw) == 4 * 15
        assert abs(float(l) - float(jl)) < 1e-5
        for g, want in zip(tree_leaves(d), jax.tree.leaves(jd)):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=5e-5, atol=1e-6)
        out[timing] = d
    for e, l in zip(tree_leaves(out["eager"]), tree_leaves(out["lazy"])):
        torch.testing.assert_close(e, l, rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_fused_trainer_matches_jax_over_three_rounds(arch):
    cfg = ARCHS[arch].reduced(dtype="float32")
    agg_kw = dict(hierarchy="flat", timing="eager", num_microbatches=2)
    jt = JaxTrainer(cfg, JAX_MESH, JaxAgg(**agg_kw), opts=_opts(JaxOptions))
    jt.params = jax.tree.map(jnp.asarray, _jax_params(arch))
    jt.server_state = jax_server_state("fedavg", jt.params)
    t = FusedFLTrainer(TORCH_ARCHS[arch].reduced(dtype="float32"),
                       make_host_mesh(), AggregationConfig(**agg_kw),
                       opts=_opts(ModelOptions), device="cpu")
    t.params = lm_params_from_jax(_jax_params(arch), device="cpu")
    t.server_state = tree_from_jax(jax.tree.map(np.asarray, jt.server_state),
                                   device="cpu")
    loader = CohortTokenLoader(cfg.vocab_size, seq_len=16, n_cohorts=2)
    for r in range(3):
        batch = loader.round_batch(4, r)
        want, got = jt.train_round(batch), t.train_round(batch)
        assert abs(got["loss"] - want["loss"]) < 1e-5, (r, got, want)
        assert got["updates_aggregated"] == want["updates_aggregated"] == 2
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
    from repro.models import ModelOptions

    mesh = make_debug_mesh((2, 1, 1), ('pod', 'data', 'model'))
    out = {}
    for arch in ARCHS_RUN:
        cfg = ARCHS[arch].reduced(dtype='float32')
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, size=(8, 24))
        batch = {'tokens': jnp.asarray(toks, jnp.int32),
                 'labels': jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}
        out[f'{arch}/tokens'] = toks
        # build_train_step's options, with chunks of 8 (3 a sequence)
        opts = ModelOptions(attn_impl='chunked_sp', ssm_impl='sharded',
                            dp_axes=('data',), model_axis='model',
                            vocab_axis='model', ssm_chunk=8)
        with use_mesh(mesh):
            for comp in ('none', 'int8'):
                agg = AggregationConfig(hierarchy='hierarchical',
                                        compress=comp, num_microbatches=2)
                step, model = build_train_step(cfg, mesh, agg, opts)
                params = model.init(jax.random.PRNGKey(0))
                for i, l in enumerate(jax.tree.leaves(params)):
                    out[f'{arch}/init/{i}'] = np.asarray(l)
                state = init_server_state('fedavg', params)
                p2, _, m = jax.jit(step)(params, state, batch)
                for i, l in enumerate(jax.tree.leaves(p2)):
                    out[f'{arch}/{comp}/{i}'] = np.asarray(l)
                for k, v in m.items():
                    out[f'{arch}/{comp}/m/{k}'] = np.asarray(v)
    np.savez(PATH, **out)
    print('OK')
"""


def _train_opts(**over):
    """``build_train_step``'s options on the 2-pod mesh, with chunks of 8."""
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    return mesh, ModelOptions(attn_impl="chunked_sp", ssm_impl="sharded",
                              dp_axes=("data",), model_axis="model",
                              vocab_axis="model", ssm_chunk=8, mesh=mesh,
                              **over)


@pytest.fixture(scope="module", autouse=True)
def jax_hier(tmp_path_factory):
    """The JAX package's steps for both archs, from a subprocess started
    with the file's first test -> a function that waits for them."""
    path = tmp_path_factory.mktemp("ssm_hier") / "jax_hier.npz"
    run = ForcedRun(JAX_HIER.replace("PATH", repr(str(path))).replace(
        "ARCHS_RUN", repr(ARCH_NAMES)))

    def wait():
        assert "OK" in run.stdout()
        return np.load(path)

    yield wait
    run.close()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_hierarchical_step_matches_jax_on_two_pods(arch, jax_hier):
    """One hierarchical round on a 2-pod mesh (2 microbatches a pod, 2
    sequences of 24 tokens each, 3 chunks a sequence), with and without
    the int8 hop, against the JAX package's step; the int8 params within
    5 % (relative) of the uncompressed ones."""
    ref = jax_hier()
    ref = {k[len(arch) + 1:]: ref[k] for k in ref.files
           if k.startswith(arch + "/")}
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    mesh, opts = _train_opts()
    toks = ref["tokens"]
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)),
             "labels": torch.from_numpy(np.roll(toks, -1, 1).astype(np.int32))}
    readings = {}
    for comp in ("none", "int8"):
        agg = AggregationConfig(hierarchy="hierarchical", compress=comp,
                                num_microbatches=2)
        step, model = build_train_step(cfg, mesh, agg, opts)
        leaves, treedef = tree_flatten(model.init(0, device="cpu"))
        n = len(leaves)
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


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_two_part_limit_sees_a_chunk_carry_reset(arch, monkeypatch):
    """The planted fault of the card's SSM round check, on the CPU: the
    same int8 step with the scan's state reset to zero at every chunk
    boundary lands above the two-part limit."""
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    mesh, opts = _train_opts()
    agg = AggregationConfig(hierarchy="hierarchical", compress="int8",
                            num_microbatches=2)
    step, model = build_train_step(cfg, mesh, agg, opts)
    params = model.init(0, device="cpu")
    batch = _tb(_batch(cfg.vocab_size, B=8, S=24))
    run = lambda: [t.numpy() for t in tree_leaves(step(
        params, init_server_state("fedavg", params), batch)[0])]
    sound = run()
    steps = _pod_steps(model, params, batch, agg, 2)
    assert int8_round_limit(sound, run(), steps)[2]
    body, resets = tssm._chunk_seq, []

    def carry_reset(h, *args):
        resets.append(1)
        return body(torch.zeros_like(h), *args)

    monkeypatch.setattr(tssm, "_chunk_seq", carry_reset)
    faulted = run()
    assert resets
    share, worst, ok = int8_round_limit(faulted, sound, steps)
    assert not ok and worst > 1.0, (share, worst)


def test_fake_quantize_tree_of_a_hymba_delta_matches_jax():
    """The int8 hop on a reduced hymba-1.5b round's delta: ``A_log``'s
    rows of N = 8 take blocks of 8, ``D`` and ``dt_bias`` (L, 128) rows of
    128, the rest blocks of up to 256; the roundtrip is the JAX
    package's bit for bit."""
    arch = "hymba-1.5b"
    model = build_model(TORCH_ARCHS[arch].reduced(dtype="float32"),
                        _opts(ModelOptions))
    params = lm_params_from_jax(_jax_params(arch), device="cpu")
    delta, _, _ = accumulate_updates(model, params, _tb(_batch(256, B=4)),
                                     AggregationConfig(num_microbatches=2))
    names = dict(named_leaves(delta))
    assert names["segments.0.ssm.A_log"].shape[-1] == 8
    got = tree_leaves(tcomp.fake_quantize_tree(delta))
    want = jax.tree.leaves(jax.jit(jcomp.fake_quantize_tree)(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), delta)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    moved = [bool((g != t).any()) for g, t in zip(got, tree_leaves(delta))]
    assert any(moved)
