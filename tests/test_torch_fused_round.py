"""The port's training path and fused round against the JAX package's.

The reduced llama3.2-3b config in fp32 (2 layers, d_model 64, 4 query
heads over 2 KV heads, head_dim 16, vocab 256).  The JAX model makes its
params from a PRNG key and ``lm_params_from_jax`` carries them across,
so both packages train the same weights on the same numpy batches.

Tolerances, each with its reason:

* flash attention values and dq/dk/dv, ``LM.loss`` and its gradients:
  atol 1e-5 (rtol 1e-4 for gradients): fp32 sums taken in another order;
* ``accumulate_updates``: rtol 5e-5, atol 1e-6, the JAX package's own
  eager-vs-lazy tolerance (``tests/test_fl_round.py:40``);
* ``FusedFLTrainer`` losses over three rounds: 1e-5;
* the hierarchical step on a 2-pod mesh: params within 5e-5 without
  compression (``tests/test_multidevice.py``'s flat-vs-hierarchical
  limit); with int8 the two-part limit of :func:`int8_round_limit`.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import use_mesh
from repro.configs import ARCHS
from repro.data.loader import CohortTokenLoader
from repro.fl.round import AggregationConfig as JaxAgg
from repro.fl.round import accumulate_updates as jax_accumulate
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro.models.flash import flash_self_attention as jax_flash
from repro.runtime.trainer import FusedFLTrainer as JaxTrainer
from repro_torch.convert import (lm_params_from_jax, metrics_from_jax,
                                 tree_from_jax)
from repro_torch.fl import compression as tcomp
from repro_torch.fl.round import AggregationConfig, accumulate_updates
from repro_torch.fl.round import build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models.flash import flash_self_attention
from repro_torch.runtime import FusedFLTrainer
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCH = "llama3.2-3b"
GLOBAL = -1


def _cfg():
    return ARCHS[ARCH].reduced(dtype="float32")


def _tiny(cls, **over):
    """quickstart part 2's options (examples/quickstart.py:78)."""
    base = dict(attn_impl="chunked", moe_impl="dense", ssm_chunk=8,
                loss_chunk=16, block_kv=8, remat=False)
    base.update(over)
    return cls(**base)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, B=8, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S))
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1                      # an ignored label per row
    return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}


def _close(got, want, rtol, atol):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# flash attention's custom backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [GLOBAL, 8])
def test_flash_vjp_matches_jax(window):
    B, S, K, G, D, bk = 2, 37, 2, 2, 16, 8      # S ragged against bk
    rng = np.random.default_rng(window + 2)
    q = rng.normal(size=(B, S, K, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    do = rng.normal(size=(B, S, K, G, D)).astype(np.float32)
    scale = D ** -0.5
    out, vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, window, True, scale, bk),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = flash_self_attention(tq, tk, tv, window, True, scale, bk)
    got.backward(torch.from_numpy(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (got, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# LM.loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_jax(remat):
    cfg = _cfg()
    jmodel = jax_build(cfg, _tiny(JaxOptions, remat=remat))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg.vocab_size, B=2, S=20)   # loss chunk 16 -> 10
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True)(jparams)

    model = build_model(cfg, _tiny(ModelOptions, remat=remat))
    leaves, treedef = tree_flatten(
        lm_params_from_jax(_np_tree(jparams), device="cpu"))
    live = [l.requires_grad_() for l in leaves]
    loss, aux = model.loss(tree_unflatten(treedef, live),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert abs(float(aux["ce"].detach()) - float(jaux["ce"])) < 1e-5
    assert float(aux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    _close(grads, jgrads, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# accumulate_updates: eager == lazy, both == the JAX package's
# ---------------------------------------------------------------------------


def test_accumulate_updates_eager_lazy_and_jax():
    cfg = _cfg()
    jmodel = jax_build(cfg, _tiny(JaxOptions))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg.vocab_size)
    model = build_model(cfg, _tiny(ModelOptions))
    params = lm_params_from_jax(_np_tree(jparams), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for timing in ("eager", "lazy"):
        agg = AggregationConfig(timing=timing, num_microbatches=4)
        with use_mesh(jax_host_mesh()):
            jd, jw, jl = jax_accumulate(
                jmodel, jparams, {k: jnp.asarray(v) for k, v in
                                  batch.items()},
                JaxAgg(timing=timing, num_microbatches=4))
        d, w, l = accumulate_updates(model, params, tb, agg)
        assert float(w) == float(jw) == 8 * 15
        assert abs(float(l) - float(jl)) < 1e-5
        _close(d, jd, rtol=5e-5, atol=1e-6)
        assert all(x.dtype == torch.float32 for x in tree_leaves(d))
        out[timing] = d
    for e, l in zip(tree_leaves(out["eager"]), tree_leaves(out["lazy"])):
        torch.testing.assert_close(e, l, rtol=5e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# FusedFLTrainer: quickstart part 2 (flat, eager), three rounds
# ---------------------------------------------------------------------------


def test_fused_trainer_matches_jax_over_three_rounds():
    cfg = _cfg()
    agg_kw = dict(hierarchy="flat", timing="eager", num_microbatches=4)
    jt = JaxTrainer(cfg, jax_host_mesh(), JaxAgg(**agg_kw),
                    opts=_tiny(JaxOptions))
    jt.init(seed=0)
    t = FusedFLTrainer(cfg, make_host_mesh(), AggregationConfig(**agg_kw),
                       opts=_tiny(ModelOptions), device="cpu")
    t.params = lm_params_from_jax(_np_tree(jt.params), device="cpu")
    t.server_state = tree_from_jax(_np_tree(jt.server_state), device="cpu")
    assert set(t.server_state) == {"step"}
    loader = CohortTokenLoader(cfg.vocab_size, seq_len=32, n_cohorts=4)
    for r in range(3):
        batch = loader.round_batch(16, r)
        want, got = jt.train_round(batch), t.train_round(batch)
        assert abs(got["loss"] - want["loss"]) < 1e-5, (r, got, want)
        assert got["updates_aggregated"] == want["updates_aggregated"] == 4
        assert got["aggregate_weight"] == want["aggregate_weight"]
        assert abs(got["update_norm"] / want["update_norm"] - 1) < 1e-4
    assert [h["round"] for h in t.history] == [1, 2, 3]
    assert int(t.server_state["step"]) == 3
    _close(t.params, jt.params, rtol=1e-4, atol=1e-5)
    assert t._cache.misses == 1 and len(t._cache) == 1


@pytest.mark.parametrize("opt,lr", [("fedadam", 3e-3), ("fedavgm", 0.7)])
def test_server_opt_rounds_and_restart_match_jax(opt, lr, tmp_path):
    """FedAdam (``examples/train_fl_lm.py``'s default, lr 3e-3) and
    FedAvgM (lr 0.7) over three rounds, with params and server state
    carried across from the JAX trainer, at the fedavg test's limits.
    Then each package restores its round-2 checkpoint into a new trainer
    and takes one more round: ``maybe_restore`` rebuilds the server
    optimizer's state from scratch in both (moments zero, ``step`` 0),
    so the resumed round starts Adam's bias correction again.  Its loss
    and update norm are held at the same limits; its params are not: a
    first Adam step moves each element by ``lr · d / (|d| + eps)``, which
    turns fp32 rounding of a near-zero ``d`` into a step of up to lr."""
    cfg = _cfg()
    agg_kw = dict(hierarchy="flat", timing="eager", num_microbatches=4,
                  server_opt=opt, server_lr=lr)
    moments = {"fedadam": ("m", "v"), "fedavgm": ("momentum",)}[opt]

    def trainers():
        jt = JaxTrainer(cfg, jax_host_mesh(), JaxAgg(**agg_kw),
                        opts=_tiny(JaxOptions),
                        checkpoint_dir=str(tmp_path / "jax"),
                        checkpoint_every=2)
        t = FusedFLTrainer(cfg, make_host_mesh(), AggregationConfig(**agg_kw),
                           opts=_tiny(ModelOptions), device="cpu",
                           checkpoint_dir=str(tmp_path / "torch"),
                           checkpoint_every=2)
        return jt, t

    jt, t = trainers()
    jt.init(seed=0)
    t.params = lm_params_from_jax(_np_tree(jt.params), device="cpu")
    t.server_state = tree_from_jax(_np_tree(jt.server_state), device="cpu")
    assert set(t.server_state) == {"step", *moments}
    loader = CohortTokenLoader(cfg.vocab_size, seq_len=32, n_cohorts=4)
    for r in range(3):
        batch = loader.round_batch(16, r)
        want, got = jt.train_round(batch), t.train_round(batch)
        assert abs(got["loss"] - want["loss"]) < 1e-5, (r, got, want)
        assert abs(got["update_norm"] / want["update_norm"] - 1) < 1e-4
    _close(t.params, jt.params, rtol=1e-4, atol=1e-5)
    for key in moments:
        _close(t.server_state[key], jt.server_state[key], rtol=1e-4,
               atol=1e-5)
    assert int(t.server_state["step"]) == int(jt.server_state["step"]) == 3
    jt.ckpt.wait()
    t.ckpt.wait()

    jt2, t2 = trainers()
    assert jt2.maybe_restore() and t2.maybe_restore()
    assert jt2.round_id == t2.round_id == 2
    assert int(jt2.server_state["step"]) == int(t2.server_state["step"]) == 0
    for key in moments:
        assert not any(np.asarray(l).any()
                       for l in jax.tree.leaves(jt2.server_state[key]))
        assert not any(bool(l.any()) for l in tree_leaves(t2.server_state[key]))
    _close(t2.params, jt2.params, rtol=1e-4, atol=1e-5)
    batch = loader.round_batch(16, 2)
    want, got = jt2.train_round(batch), t2.train_round(batch)
    assert abs(got["loss"] - want["loss"]) < 1e-5, (got, want)
    assert abs(got["update_norm"] / want["update_norm"] - 1) < 1e-4
    assert int(t2.server_state["step"]) == int(jt2.server_state["step"]) == 1


def test_fused_trainer_defaults_to_the_card_and_refuses_checkpoints(
        tmp_path):
    """On the card unless told; ``checkpoint_dir=`` is taken (checkpoints
    are ported), and a directory with no checkpoint is refused as a
    restore point: ``maybe_restore`` leaves the trainer as it was."""
    cfg = _cfg()
    agg = AggregationConfig(hierarchy="flat")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FusedFLTrainer(cfg, make_host_mesh(), agg)
    t = FusedFLTrainer(cfg, make_host_mesh(), agg, device="cpu",
                       checkpoint_dir=str(tmp_path / "ckpt"))
    assert t.ckpt is not None and t.checkpoint_every == 20
    assert not t.maybe_restore()
    assert t.params is None and t.round_id == 0


@pytest.mark.parametrize("shape,axes", [((1, 2, 1), ("pod", "data", "model")),
                                        ((1, 2), ("data", "model")),
                                        ((2, 1, 2), ("pod", "data", "model"))])
def test_meshes_that_shard_the_model_are_refused(shape, axes):
    """In one process: a model axis above 1 is a ValueError, a data axis
    above 1 not ported in one process; both point to spawn_ranks."""
    model = dict(zip(axes, shape)).get("model", 1) > 1
    with pytest.raises(ValueError if model else NotImplementedError,
                       match="spawn_ranks"):
        make_debug_mesh(shape, axes)


def test_named_axes_without_a_mesh_are_refused():
    cfg = _cfg()
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg.vocab_size, B=1, S=8).items()}
    for over in ({"attn_impl": "chunked_sp"}, {"vocab_axis": "model"}):
        model = build_model(cfg, _tiny(ModelOptions, **over))
        params = model.init(0, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            model.loss(params, batch)
        ok = build_model(cfg, _tiny(ModelOptions, mesh=make_host_mesh(),
                                    **over))
        assert torch.isfinite(ok.loss(params, batch)[0])


# ---------------------------------------------------------------------------
# the hierarchical step on a 2-pod mesh, against the JAX package's
# ---------------------------------------------------------------------------


def int8_round_limit(got, want, steps):
    """The two-part limit of an int8 round (per element, over all
    leaves): (a) at most 0.1 % of elements differ by more than 1e-5; (b)
    none differs by more than one quantization step of its block, ``s /
    n_pods × server_lr`` (plus the 1e-5 of part (a)): a ``q`` flipped at
    a .5 boundary is the one difference the int8 hop allows.  -> (share
    over 1e-5, largest difference in steps, whether both parts hold)."""
    d = np.concatenate([np.abs(np.asarray(g, np.float64) -
                               np.asarray(w, np.float64)).ravel()
                        for g, w in zip(got, want)])
    step = np.concatenate([np.asarray(s, np.float64).ravel() for s in steps])
    share = float((d > 1e-5).mean())
    worst = float(((d - 1e-5) / step).max())
    return share, worst, share <= 1e-3 and worst <= 1.0


def _pod_steps(model, params, batch, agg, n_pods):
    """Per element: the largest quantization step of its block over the
    pods' deltas, ``s / n_pods × server_lr``."""
    steps = None
    for i in range(n_pods):
        b = {k: v[i * v.shape[0] // n_pods:(i + 1) * v.shape[0] // n_pods]
             for k, v in batch.items()}
        d, _, _ = accumulate_updates(model, params, b, agg)
        per = []
        for leaf in tree_leaves(d):
            _, safe, last = tcomp._quantize_blocks_last_axis(leaf, 256)
            s = safe.repeat_interleave(min(256, last), dim=-1)[..., :last]
            per.append(s.reshape(leaf.shape) / n_pods * agg.server_lr)
        steps = per if steps is None else [torch.maximum(a, b)
                                           for a, b in zip(steps, per)]
    return [s.numpy() for s in steps]


JAX_HIER = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import use_mesh
    from repro.configs import ARCHS
    from repro.fl.round import AggregationConfig, build_train_step
    from repro.fl.server import init_server_state
    from repro.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh((2, 1, 1), ('pod', 'data', 'model'))
    cfg = ARCHS['llama3.2-3b'].reduced(dtype='float32')
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


def _forced_env(ndev: int):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
    env["PYTHONPATH"] = SRC
    return env


def run_forced(code: str, ndev: int = 2, timeout: int = 560) -> str:
    """tests/test_multidevice.py:13's helper: a subprocess whose XLA
    sees ``ndev`` host devices."""
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout,
        env=_forced_env(ndev),
    )
    assert out.returncode == 0, f"stderr:\n{out.stderr[-3000:]}"
    return out.stdout


class ForcedRun:
    """:func:`run_forced` started now and read later: the subprocess runs
    beside the tests that come before the first one that needs it."""

    def __init__(self, code: str, ndev: int = 2, timeout: int = 560):
        self.timeout = timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_forced_env(ndev))
        self.out = None

    def stdout(self) -> str:
        if self.out is None:
            out, err = self.proc.communicate(timeout=self.timeout)
            assert self.proc.returncode == 0, f"stderr:\n{err[-3000:]}"
            self.out = out
        return self.out

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def test_hierarchical_step_matches_jax_on_two_pods(tmp_path):
    path = tmp_path / "jax_hier.npz"
    assert "OK" in run_forced(JAX_HIER.replace("PATH", repr(str(path))))
    ref = np.load(path)
    cfg = _cfg()
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    toks = ref["tokens"]
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)),
             "labels": torch.from_numpy(np.roll(toks, -1, 1).astype(np.int32))}
    readings = {}
    for comp in ("none", "int8"):
        agg = AggregationConfig(hierarchy="hierarchical", compress=comp,
                                num_microbatches=2)
        step, model = build_train_step(cfg, mesh, agg)
        assert model.opts.attn_impl == "chunked_sp" and model.opts.remat
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
        assert int(state["step"]) == 1
        if comp == "none":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
        else:
            steps = _pod_steps(model, params, batch, agg, 2)
            share, worst, ok = int8_round_limit(got, want, steps)
            readings[comp] = (share, worst)
            assert ok, (share, worst)
            print(f"int8 vs JAX: {share:.2e} of elements over 1e-5, "
                  f"largest {worst:.3f} of a step")
        readings[f"{comp}/params"] = got
    # the int8 hop moved the params, but within 5 % of the uncompressed
    rel = max(float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))
              for a, b in zip(readings["none/params"],
                              readings["int8/params"]))
    assert 0 < rel < 0.05


def test_two_part_limit_sees_a_pod_counted_twice(monkeypatch):
    """The int8 limit has a reading on each side: the same step with one
    pod's delta counted twice lands above it."""
    cfg = _cfg()
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    agg = AggregationConfig(hierarchy="hierarchical", compress="int8",
                            num_microbatches=2)
    step, model = build_train_step(cfg, mesh, agg)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    run = lambda: [t.numpy() for t in tree_leaves(step(
        params, init_server_state("fedavg", params), batch)[0])]
    sound = run()
    steps = _pod_steps(model, params, batch, agg, 2)
    assert int8_round_limit(sound, run(), steps)[2]

    orig, calls = tcomp.fake_quantize_tree, []

    def second_pod_twice(delta):
        calls.append(1)
        leaves, treedef = tree_flatten(orig(delta))
        k = 2 if len(calls) == 2 else 1
        return tree_unflatten(treedef, [k * t for t in leaves])

    monkeypatch.setattr(tcomp, "fake_quantize_tree", second_pod_twice)
    faulted = run()
    assert len(calls) == 2
    share, worst, ok = int8_round_limit(faulted, sound, steps)
    assert not ok and worst > 1.0, (share, worst)
