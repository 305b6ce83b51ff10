"""The port's frontend and encoder–decoder training path against the JAX
package's: ``LM.loss`` and its gradients, ``accumulate_updates``,
``FusedFLTrainer`` and the hierarchical int8 step of internvl2-26b (stub
vision patches in front of the text, dropped before the cross-entropy)
and seamless-m4t-large-v2 (an encoder over stub audio frames, whose
gradient arrives through every decoder layer's cross-attention).

Reduced configs (2 layers, and seamless 2 encoder layers; d_model 64, 4
query heads over 2 KV heads, head dim 16, vocab 256, 4 frontend tokens)
with the fused round's options (``chunked_sp``: the plain flash VJP,
non-causal in the encoder; cross-attention over 4 memory rows
``"naive"``; vocab over the model axis).  The JAX model makes the
params, which ``lm_params_from_jax`` carries across; tokens and the
stub's embeddings, ``normal(0, 0.02)`` as the JAX package's
``tests/test_smoke_archs.py`` draws them, come from numpy with a seed.
The JAX side runs its own code under ``jax.jit`` on a (1, 1) (data,
model) mesh of the CPU, the hierarchical step in a subprocess with two
forced host devices.

Tolerances, each with its reason (those of ``tests/test_torch_ssm_train.py``):

* ``LM.loss`` and its gradients, remat on and off, fp32: loss atol 1e-5,
  gradients rtol 1e-4 and atol 1e-5 (fp32 sums in another order); bf16:
  loss atol 2e-3 and gradients rtol 2e-2, atol 4e-3, about four bf16
  ulps of the largest gradient (0.14): activations and gradients round
  to bf16 at other places in the two frameworks;
* ``accumulate_updates``: rtol 5e-5, atol 1e-6, the JAX package's own
  eager-vs-lazy tolerance;
* ``FusedFLTrainer`` losses over three rounds: 1e-5;
* the hierarchical int8 step on two pods: the two-part limit of
  ``int8_round_limit``; without compression params within 5e-5.
"""
import functools

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
from repro.fl.server import init_server_state as jax_server_state
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build
from repro.runtime.trainer import FusedFLTrainer as JaxTrainer
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.convert import (lm_params_from_jax, metrics_from_jax,
                                 tree_from_jax)
from repro_torch.fl import round as tround
from repro_torch.fl.round import AggregationConfig, accumulate_updates
from repro_torch.fl.round import build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models.registry import LM
from repro_torch.runtime import FusedFLTrainer
from repro_torch.tree import (named_leaves, tree_flatten, tree_leaves,
                              tree_unflatten)
from test_torch_fused_round import ForcedRun, _pod_steps, int8_round_limit

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

JAX_MESH = jax_debug_mesh((1, 1), ("data", "model"))
ARCH_NAMES = ("internvl2-26b", "seamless-m4t-large-v2")
#: dtype -> (loss atol, gradient rtol, gradient atol)
GRAD_TOL = {"float32": (1e-5, 1e-4, 1e-5), "bfloat16": (2e-3, 2e-2, 4e-3)}


def _opts(cls, **over):
    base = dict(attn_impl="chunked_sp", model_axis="model",
                vocab_axis="model", loss_chunk=16, block_kv=8, remat=False)
    base.update(over)
    if cls is JaxOptions:
        return cls(dp_axes=("data",), **base)
    return cls(dp_axes=("data",), mesh=make_host_mesh(), **base)


def _frontend(cfg, B, seed):
    """The stub's embeddings (B, F, d_model), ``normal(0, 0.02)``."""
    return np.random.default_rng(seed).normal(
        0, 0.02, size=(B, cfg.frontend_tokens, cfg.d_model)).astype(
            np.float32)


def _batch(cfg, B=2, S=12, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(B, S))
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1                      # an ignored label per row
    return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32),
            "frontend": _frontend(cfg, B, seed + 1)}


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
    cfg = ARCHS[arch].reduced(dtype=dtype)
    model = jax_build(cfg, _opts(JaxOptions))
    with use_mesh(JAX_MESH):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b)[0]))(_jax_params(arch, dtype),
                                               _jb(_batch(cfg)))
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port(arch, dtype="float32", **over):
    cfg = TORCH_ARCHS[arch].reduced(dtype=dtype)
    model = build_model(cfg, _opts(ModelOptions, **over))
    return cfg, model, lm_params_from_jax(_jax_params(arch, dtype),
                                          device="cpu")


def _port_grads(model, params, batch):
    leaves, treedef = tree_flatten(params)
    live = [l.detach().clone().requires_grad_() for l in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, live), batch)
    return loss.detach(), torch.autograd.grad(loss, live,
                                              materialize_grads=True)


# ---------------------------------------------------------------------------
# LM.loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_loss_and_grads_match_jax(arch, dtype, remat):
    """The loss over the text and every gradient; ``frontend_proj`` and,
    for seamless, every encoder leaf of every layer get a non-zero
    gradient (the encoder's through the decoder's cross-attention,
    captured by each layer's checkpointed body under remat)."""
    loss_tol, rtol, atol = GRAD_TOL[dtype]
    jloss, jgrads = _jax_loss_and_grads(arch, dtype)
    cfg, model, params = _port(arch, dtype, remat=remat)
    loss, grads = _port_grads(model, params, _tb(_batch(cfg)))
    assert abs(float(loss) - jloss) < loss_tol
    assert len(grads) == len(jgrads)
    reached = set()
    for (name, leaf), g, w in zip(named_leaves(params), grads, jgrads):
        assert g.dtype == leaf.dtype
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=name)
        if name == "frontend_proj" or name.startswith("encoder."):
            layers = g if name.startswith("encoder.segments") else [g]
            assert all(bool(layer.any()) for layer in layers), name
            reached.add(name.split(".")[0])
    assert reached == ({"frontend_proj", "encoder"} if cfg.encoder_layers
                       else {"frontend_proj"})


def test_patch_positions_carry_no_loss(monkeypatch):
    """internvl's loss is the mean CE over the text: moving the patches'
    hidden states does not reach it, and the batch's weight is its
    labels >= 0 alone."""
    cfg, model, params = _port("internvl2-26b")
    batch = _tb(_batch(cfg))
    forward = LM._forward
    seen = {}

    def patched(self, *a, **kw):
        hidden, aux, caches, n_front = forward(self, *a, **kw)
        seen["shape"] = tuple(hidden.shape)
        hidden = torch.cat([hidden[:, :n_front] * 3.0, hidden[:, n_front:]],
                           dim=1)
        return hidden, aux, caches, n_front

    want = model.loss(params, batch)[0]
    monkeypatch.setattr(LM, "_forward", patched)
    got = model.loss(params, batch)[0]
    assert seen["shape"][1] == cfg.frontend_tokens + batch["tokens"].shape[1]
    assert torch.equal(got, want)
    _, w, _ = tround._cohort_update(model, params, batch)
    assert float(w) == float((batch["labels"] >= 0).sum())


def test_every_batch_key_is_split_with_its_tokens(monkeypatch):
    """``_pod_slice`` and ``_split_micro`` hand each microbatch the
    frontend rows of its own sequences, through ``FusedFLTrainer``."""
    cfg = TORCH_ARCHS["internvl2-26b"].reduced(dtype="float32")
    batch = _batch(cfg, B=8)
    rows = {int(t[0]): i for i, t in enumerate(batch["tokens"])}
    assert len(rows) == 8
    seen = []
    loss = LM.loss

    def watched(self, params, mb):
        seen.append({k: v.clone() for k, v in mb.items()})
        return loss(self, params, mb)

    monkeypatch.setattr(LM, "loss", watched)
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    t = FusedFLTrainer(cfg, mesh, AggregationConfig(
        hierarchy="hierarchical", num_microbatches=2), device="cpu")
    t.init(0)
    t.train_round(batch)
    assert len(seen) == 4                     # 2 pods x 2 microbatches
    order = []
    for mb in seen:
        assert sorted(mb) == ["frontend", "labels", "tokens"]
        for tok, front in zip(mb["tokens"], mb["frontend"]):
            i = rows[int(tok[0])]
            order.append(i)
            assert torch.equal(front, torch.from_numpy(batch["frontend"][i]))
    assert order == list(range(8))


# ---------------------------------------------------------------------------
# the fused round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_accumulate_updates_eager_lazy_and_jax(arch):
    cfg = ARCHS[arch].reduced(dtype="float32")
    jmodel = jax_build(cfg, _opts(JaxOptions))
    batch = _batch(cfg, B=4)
    _, model, params = _port(arch)
    out = {}
    for timing in ("eager", "lazy"):
        agg = dict(timing=timing, num_microbatches=2)
        with use_mesh(JAX_MESH):
            jd, jw, jl = jax.jit(functools.partial(
                jax_accumulate, jmodel, agg=JaxAgg(**agg)))(
                    _jax_params(arch), _jb(batch))
        d, w, l = accumulate_updates(model, params, _tb(batch),
                                     AggregationConfig(**agg))
        assert float(w) == float(jw) == 4 * 11
        assert abs(float(l) - float(jl)) < 1e-5
        for g, want in zip(tree_leaves(d), jax.tree.leaves(jd)):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=5e-5, atol=1e-6)
        out[timing] = d
    for e, l in zip(tree_leaves(out["eager"]), tree_leaves(out["lazy"])):
        torch.testing.assert_close(e, l, rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_fused_trainer_matches_jax_over_three_rounds(arch):
    """Three flat rounds of ``CohortTokenLoader`` batches, each with the
    stub's embeddings added by the caller under ``"frontend"``."""
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
    loader = CohortTokenLoader(cfg.vocab_size, seq_len=12, n_cohorts=2)
    for r in range(3):
        batch = dict(loader.round_batch(4, r), frontend=_frontend(cfg, 4, r))
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

    mesh = make_debug_mesh((2, 1, 1), ('pod', 'data', 'model'))
    out = {}
    for arch in ARCHS_RUN:
        cfg = ARCHS[arch].reduced(dtype='float32')
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, size=(8, 16))
        front = rng.normal(0, 0.02, size=(8, cfg.frontend_tokens,
                                          cfg.d_model)).astype(np.float32)
        batch = {'tokens': jnp.asarray(toks, jnp.int32),
                 'labels': jnp.asarray(np.roll(toks, -1, 1), jnp.int32),
                 'frontend': jnp.asarray(front)}
        out[f'{arch}/tokens'] = toks
        out[f'{arch}/frontend'] = front
        with use_mesh(mesh):
            for comp in ('none', 'int8'):
                agg = AggregationConfig(hierarchy='hierarchical',
                                        compress=comp, num_microbatches=2)
                step, model = build_train_step(cfg, mesh, agg)
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


@pytest.fixture(scope="module", autouse=True)
def jax_hier(tmp_path_factory):
    """The JAX package's steps for both archs, from a subprocess started
    with the file's first test -> a function that waits for them."""
    path = tmp_path_factory.mktemp("front_hier") / "jax_hier.npz"
    run = ForcedRun(JAX_HIER.replace("PATH", repr(str(path))).replace(
        "ARCHS_RUN", repr(ARCH_NAMES)))

    def wait():
        assert "OK" in run.stdout()
        return np.load(path)

    yield wait
    run.close()


def _mesh():
    return make_debug_mesh((2, 1, 1), ("pod", "data", "model"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_hierarchical_step_matches_jax_on_two_pods(arch, jax_hier):
    """One hierarchical round on a 2-pod mesh (2 microbatches a pod, 2
    sequences of 4 stub tokens and 16 text tokens each) with
    ``build_train_step``'s default options, with and without the int8
    hop, against the JAX package's step; the int8 params within 5 %
    (relative) of the uncompressed ones."""
    ref = jax_hier()
    ref = {k[len(arch) + 1:]: ref[k] for k in ref.files
           if k.startswith(arch + "/")}
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    toks = ref["tokens"]
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)),
             "labels": torch.from_numpy(np.roll(toks, -1, 1).astype(np.int32)),
             "frontend": torch.from_numpy(ref["frontend"])}
    readings = {}
    for comp in ("none", "int8"):
        agg = AggregationConfig(hierarchy="hierarchical", compress=comp,
                                num_microbatches=2)
        step, model = build_train_step(cfg, _mesh(), agg)
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


def _ce_one_position_early(forward):
    """internvl's CE taken one position early: on the last patch and the
    text but its last token."""
    def faulted(self, *a, **kw):
        hidden, aux, caches, n_front = forward(self, *a, **kw)
        return hidden[:, :-1], aux, caches, n_front - 1
    return "_forward", faulted


def _memory_detached(encode):
    """seamless's memory cut from the encoder's gradient: the same values,
    and zero reaches the encoder (it stays in the graph, as
    ``autograd.grad`` wants every leaf used)."""
    def faulted(self, *a, **kw):
        memory = encode(self, *a, **kw)
        return memory.detach() + 0.0 * memory
    return "_encode", faulted


FAULTS = {"internvl2-26b": (LM._forward, _ce_one_position_early),
          "seamless-m4t-large-v2": (LM._encode, _memory_detached)}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_two_part_limit_sees_the_planted_fault(arch, monkeypatch):
    """The planted faults of the card's round check, on the CPU: the same
    int8 step with internvl's CE one position early, or with seamless's
    memory detached from the encoder, lands above the two-part limit."""
    cfg = TORCH_ARCHS[arch].reduced(dtype="float32")
    agg = AggregationConfig(hierarchy="hierarchical", compress="int8",
                            num_microbatches=2)
    step, model = build_train_step(cfg, _mesh(), agg)
    params = model.init(0, device="cpu")
    batch = _tb(_batch(cfg, B=8))
    run = lambda: [t.numpy() for t in tree_leaves(step(
        params, init_server_state("fedavg", params), batch)[0])]
    sound = run()
    steps = _pod_steps(model, params, batch, agg, 2)
    assert int8_round_limit(sound, run(), steps)[2]
    orig, make = FAULTS[arch]
    name, faulted = make(orig)
    monkeypatch.setattr(LM, name, faulted)
    share, worst, ok = int8_round_limit(run(), sound, steps)
    assert not ok and worst > 1.0, (share, worst)
