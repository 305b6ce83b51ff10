"""The model axis across ranks: one gloo rank a coordinate of a
``(pod, data, model)`` mesh whose ``model`` axis is 2 or 4, held against
the JAX package's ``build_train_step`` on a mesh of as many forced host
devices, and its three regions (``flash_self_attention_sp``, the
``sharded_vocab`` functions, ep) against the JAX functions under
``shard_map``.

The JAX side runs in one subprocess (8 forced host devices), started
with the file's first test: reduced fp32 llama3.2-3b and
deepseek-v2-lite-16b on batches of 8 sequences of 16 tokens, gemma3-4b
of 32 (so that its window of 8 on 4 model ranks takes the ring: a shard
of 8 rows, one hop < 3), some rows with extra ignored labels, in 2
microbatches.  The port's ranks run on the CPU, one spawn a world size
(2, 4 and 8).

The full steps are the meshes on which the JAX step compiles under jax
0.9.0.  It does not compile (XLA's SPMD partitioner: "Cross-partition
allreduce must be in (partial) manual partitioning mode") hierarchical
on (1,2,2) for llama3.2-3b, on (1,1,2) and (1,1,4) for gemma3-4b, on
(1,1,2) for deepseek-v2-lite-16b, nor flat on (1,2,1) for
deepseek-v2-lite-16b: the manual ``pod`` region around a model region
whose operands GSPMD left partly sharded.  Those meshes are covered by
the module references below and by the port's own one-process round
(the model axis computes the one-device math).

Tolerances, each with its reason (those of
``tests/test_torch_dist_round.py``):

* without compression, params within atol 5e-5: the sums over model
  ranks run in another order than XLA's;
* with int8, the two-part limit of
  ``test_torch_fused_round.int8_round_limit``;
* the loss within 1e-5, the update norm within 1e-4 (relative), the
  weight and the update count equal;
* every rank's params bit-identical (after one step, and after two
  trainer rounds);
* module level, forward and gradients within 1e-5 of each tensor's
  largest magnitude (fp32; ep's x gradient reaches 30): the regions'
  sums run in another order.
"""
import textwrap
import time

import numpy as np
import pytest
import torch

import _torch_model_ranks as ranks
from repro_torch.configs import ARCHS
from repro_torch.fl.round import AggregationConfig, build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.dist import spawn_ranks
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from test_torch_fused_round import ForcedRun, _pod_steps, int8_round_limit

torch.set_num_threads(2)

AXES = ("pod", "data", "model")
SEQ = {"llama3.2-3b": 16, "gemma3-4b": 32, "deepseek-v2-lite-16b": 16}
#: (case, arch, mesh, hierarchy, compress)
STEPS = [
    ("llama_112_int8", "llama3.2-3b", (1, 1, 2), "hierarchical", "int8"),
    ("llama_112_flat", "llama3.2-3b", (1, 1, 2), "flat", "none"),
    ("llama_212_none", "llama3.2-3b", (2, 1, 2), "hierarchical", "none"),
    ("llama_212_int8", "llama3.2-3b", (2, 1, 2), "hierarchical", "int8"),
    ("llama_122_flat", "llama3.2-3b", (1, 2, 2), "flat", "none"),
    ("gemma_212_int8", "gemma3-4b", (2, 1, 2), "hierarchical", "int8"),
    ("gemma_114_flat", "gemma3-4b", (1, 1, 4), "flat", "none"),
    ("deepseek_212_int8", "deepseek-v2-lite-16b", (2, 1, 2), "hierarchical",
     "int8"),
    ("deepseek_112_flat", "deepseek-v2-lite-16b", (1, 1, 2), "flat", "none"),
    ("deepseek_122_flat", "deepseek-v2-lite-16b", (1, 2, 2), "flat", "none"),
]
#: (case, (data, model), window): causal; the (1,4) and (2,4) windowed
#: cases take the ring (L 8, one hop), the rest the all-gather
FLASH = [("f12_global", (1, 2), -1), ("f12_window", (1, 2), 8),
         ("f12_dv", (1, 2), -1), ("f14_global", (1, 4), -1),
         ("f14_window", (1, 4), 8), ("f24_window", (2, 4), 8),
         ("f24_global", (2, 4), -1)]
#: (case, m, tied)
VOCAB = [("v2_tied", 2, True), ("v2_head", 2, False), ("v4_tied", 4, True),
         ("v4_head", 4, False)]
#: (case, (data, model), capacity factor): 8 drops nothing, the default
#: 1.25 drops
EP = [("ep22_cf8", (2, 2), 8.0), ("ep22_default", (2, 2), 1.25)]
TIMEOUT_S = 300

JAX_MODEL_AXIS = """
    import dataclasses, os
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import use_mesh
    from repro.configs import ARCHS
    from repro.fl.round import AggregationConfig, build_train_step
    from repro.fl.server import init_server_state
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe as jmoe
    from repro.models.flash import flash_self_attention_sp
    from repro.models.sharded_vocab import (chunked_lm_loss_sharded,
                                            decode_logits, embed_lookup)

    rng = np.random.default_rng(0)
    early, out, inits = {}, {}, {}
    for arch, S in SEQ.items():
        cfg = ARCHS[arch].reduced(dtype='float32')
        toks = rng.integers(0, cfg.vocab_size, size=(8, S))
        labels = np.roll(toks, -1, 1)
        labels[:, -1] = -1
        labels[1, :5] = -1
        labels[6, :9] = -1
        early[f'{arch}/tokens'], early[f'{arch}/labels'] = toks, labels
    # module inputs
    for case, (D, M), window in FLASH:
        dv = 8 if case.endswith('_dv') else 16
        shp = (4, 32, 2, 2)
        early[f'{case}/q'] = rng.normal(size=shp + (16,)).astype(np.float32)
        early[f'{case}/k'] = rng.normal(size=(4, 32, 2, 16)).astype(np.float32)
        early[f'{case}/v'] = rng.normal(size=(4, 32, 2, dv)).astype(np.float32)
        early[f'{case}/g'] = rng.normal(size=shp + (dv,)).astype(np.float32)
    for case, m, tied in VOCAB:
        V, D = 250, 16
        early[f'{case}/table'] = (rng.normal(size=(256, D)) * 0.05).astype(np.float32)
        early[f'{case}/w'] = early[f'{case}/table'] if tied else \\
            (rng.normal(size=(D, 256)) * 0.05).astype(np.float32)
        early[f'{case}/tokens'] = rng.integers(0, V, size=(4, 16))
        early[f'{case}/hidden'] = rng.normal(size=(4, 16, D)).astype(np.float32)
        lab = rng.integers(0, V, size=(4, 16))
        lab[0, :3] = -1
        early[f'{case}/labels'] = lab
        early[f'{case}/g'] = rng.normal(size=(4, 16, D)).astype(np.float32)
    dcfg = ARCHS['deepseek-v2-lite-16b'].reduced(dtype='float32')
    moe_params = jmoe.init_moe(jax.random.PRNGKey(3), dcfg, jnp.float32)
    for i, l in enumerate(jax.tree.leaves(moe_params)):
        early[f'moe/init/{i}'] = np.asarray(l)
    early['moe/x'] = rng.normal(size=(4, 8, dcfg.d_model)).astype(np.float32)
    early['moe/g'] = rng.normal(size=(4, 8, dcfg.d_model)).astype(np.float32)
    for arch in SEQ:
        cfg = ARCHS[arch].reduced(dtype='float32')
        mesh = make_debug_mesh((1, 1, 1), ('pod', 'data', 'model'))
        with use_mesh(mesh):
            _, model = build_train_step(cfg, mesh, AggregationConfig())
            inits[arch] = jax.tree.map(np.asarray,
                                       model.init(jax.random.PRNGKey(0)))
        for i, l in enumerate(jax.tree.leaves(inits[arch])):
            early[f'{arch}/init/{i}'] = np.asarray(l)
    np.savez(EARLY + '.tmp.npz', **early)
    os.replace(EARLY + '.tmp.npz', EARLY)

    for case, arch, shape, hier, comp in STEPS:
        cfg = ARCHS[arch].reduced(dtype='float32')
        mesh = make_debug_mesh(shape, ('pod', 'data', 'model'))
        batch = {k: jnp.asarray(early[f'{arch}/{k}'], jnp.int32)
                 for k in ('tokens', 'labels')}
        with use_mesh(mesh):
            agg = AggregationConfig(hierarchy=hier, compress=comp,
                                    num_microbatches=2)
            step, model = build_train_step(cfg, mesh, agg)
            params = inits[arch]
            p2, _, m = jax.jit(step)(params, init_server_state('fedavg', params),
                                     batch)
        for i, l in enumerate(jax.tree.leaves(p2)):
            out[f'{case}/{i}'] = np.asarray(l)
        for k, v in m.items():
            out[f'{case}/m/{k}'] = np.asarray(v)

    for case, (D, M), window in FLASH:
        mesh = make_debug_mesh((D, M), ('data', 'model'))
        q, k, v, g = (jnp.asarray(early[f'{case}/{n}']) for n in 'qkvg')
        f = lambda q, k, v: flash_self_attention_sp(
            q, k, v, window, True, 16 ** -0.5, 8, ('data',), 'model')
        with use_mesh(mesh):
            o = jax.jit(f)(q, k, v)
            grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * g),
                                     argnums=(0, 1, 2)))(q, k, v)
        for n, x in zip(('out', 'dq', 'dk', 'dv'), (o, *grads)):
            out[f'{case}/{n}'] = np.asarray(x)

    for case, m, tied in VOCAB:
        mesh = make_debug_mesh((1, m), ('data', 'model'))
        tbl, w, toks, hid, lab, g = (jnp.asarray(early[f'{case}/{n}']) for n in
                                     ('table', 'w', 'tokens', 'hidden',
                                      'labels', 'g'))
        ce = lambda h, w: chunked_lm_loss_sharded(
            h, w, lab, vocab=250, tied=tied, model_axis='model', chunk=8)
        with use_mesh(mesh):
            e = jax.jit(lambda t: embed_lookup(t, toks, 'model'))(tbl)
            ge = jax.jit(jax.grad(lambda t: jnp.sum(
                embed_lookup(t, toks, 'model') * g)))(tbl)
            l = jax.jit(ce)(hid, w)
            gh, gw = jax.jit(jax.grad(ce, argnums=(0, 1)))(hid, w)
            lg = jax.jit(lambda h, w: decode_logits(
                h, w, vocab=250, tied=tied, model_axis='model'))(hid[:, :1], w)
        for n, x in (('embed', e), ('g_table', ge), ('ce', l), ('g_w', gw),
                     ('g_hidden', gh), ('logits', lg)):
            out[f'{case}/{n}'] = np.asarray(x)

    x, g = jnp.asarray(early['moe/x']), jnp.asarray(early['moe/g'])
    for case, (D, M), cf in EP:
        cfg = dataclasses.replace(dcfg, moe=dataclasses.replace(
            dcfg.moe, capacity_factor=cf))
        mesh = make_debug_mesh((D, M), ('data', 'model'))

        def f(p, x):
            return jmoe.moe_block(cfg, p, x, impl='ep', dp_axes=('data',),
                                  model_axis='model')

        def loss(p, x):
            y, aux = f(p, x)
            return jnp.sum(y * g) + aux

        with use_mesh(mesh):
            y, aux = jax.jit(f)(moe_params, x)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(moe_params, x)
        out[f'{case}/y'], out[f'{case}/aux'] = np.asarray(y), np.asarray(aux)
        out[f'{case}/gx'] = np.asarray(gx)
        for i, l in enumerate(jax.tree.leaves(gp)):
            out[f'{case}/gp/{i}'] = np.asarray(l)
    np.savez(PATH, **out)
    print('OK')
"""


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    """The JAX package's steps and regions, from a subprocess started
    with the file's first test -> (a function that returns its inputs
    once written, a function that waits for its results)."""
    tmp = tmp_path_factory.mktemp("model_axis")
    path, early = tmp / "jax_model_axis.npz", tmp / "jax_inputs.npz"
    names = {"PATH": str(path), "EARLY": str(early), "STEPS": STEPS,
             "FLASH": FLASH, "VOCAB": VOCAB, "EP": EP, "SEQ": SEQ}
    code = "".join(f"{k} = {v!r}\n" for k, v in names.items()) \
        + textwrap.dedent(JAX_MODEL_AXIS)
    run = ForcedRun(code, ndev=8)

    def inputs():
        deadline = time.monotonic() + TIMEOUT_S
        while not early.exists():
            assert run.proc.poll() is None, run.stdout()
            assert time.monotonic() < deadline, "no JAX inputs"
            time.sleep(0.2)
        return np.load(early)

    def results():
        assert "OK" in run.stdout()
        return np.load(path)

    yield inputs, results
    run.close()


def _leaves(inputs, prefix):
    n = sum(k.startswith(prefix) for k in inputs.files)
    return [inputs[f"{prefix}{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def worlds(jax_ref):
    """One spawn a world size (2, 4 and 8 ranks on the CPU), started as
    soon as the JAX side has written its inputs -> {world: [per rank]},
    with the inputs under "inputs"."""
    inputs = jax_ref[0]()
    inits = {a: _leaves(inputs, f"{a}/init/") for a in SEQ}
    batches = {a: {k: inputs[f"{a}/{k}"].astype(np.int64)
                   for k in ("tokens", "labels")} for a in SEQ}
    flash = {c: [inputs[f"{c}/{n}"] for n in "qkvg"] for c, _, _ in FLASH}
    vocab = {c: [inputs[f"{c}/{n}"] for n in ("table", "w", "tokens",
                                              "hidden", "labels", "g")]
             + [250] for c, _, _ in VOCAB}
    moe = [_leaves(inputs, "moe/init/"), inputs["moe/x"], inputs["moe/g"]]
    ep = {c: moe for c, _, _ in EP}

    def plan(world):
        return {
            "steps": ([s for s in STEPS if int(np.prod(s[2])) == world],
                      inits, batches),
            "flash": ([f for f in FLASH if int(np.prod(f[1])) == world],
                      flash),
            "vocab": ([v for v in VOCAB if v[1] == world], vocab),
            "ep": ([e for e in EP if int(np.prod(e[1])) == world], ep)}

    plans = {w: plan(w) for w in (2, 4, 8)}
    plans[2]["refusals"] = True
    plans[4]["trainer"] = ("llama3.2-3b", (2, 1, 2), inits["llama3.2-3b"],
                           [batches["llama3.2-3b"]] * 2)
    out = {w: spawn_ranks(ranks.run_plan, w, p, device="cpu",
                          timeout_s=TIMEOUT_S)
           for w, p in plans.items()}
    out["inits"], out["batches"] = inits, batches
    return out


def _bits_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _one_process(arch, inits, batches, pods=1, hier="flat", comp="none"):
    """The port's one-process step -> (model, params, batch, new params,
    metrics)."""
    cfg = ARCHS[arch].reduced(dtype="float32")
    agg = AggregationConfig(hierarchy=hier, compress=comp,
                            num_microbatches=2)
    step, model = build_train_step(cfg, make_debug_mesh((pods, 1, 1), AXES),
                                   agg)
    _, treedef = tree_flatten(model.init(0, device="cpu"))
    params = tree_unflatten(treedef, [torch.from_numpy(a)
                                      for a in inits[arch]])
    batch = {k: torch.from_numpy(v) for k, v in batches[arch].items()}
    new, _, m = step(params, init_server_state("fedavg", params), batch)
    return model, params, batch, agg, [t.numpy() for t in tree_leaves(new)], m


@pytest.mark.parametrize("case,arch,shape,hier,comp", STEPS,
                         ids=[s[0] for s in STEPS])
def test_ranks_match_the_jax_step(case, arch, shape, hier, comp, worlds,
                                  jax_ref):
    ref = jax_ref[1]()
    world = int(np.prod(shape))
    per_rank = [r["steps"][case] for r in worlds[world]]
    got = per_rank[0]["params"]
    for r, other in enumerate(per_rank[1:], 1):
        assert _bits_equal(got, other["params"]), f"rank {r} differs"
        assert other["metrics"] == per_rank[0]["metrics"]
    want = [ref[f"{case}/{i}"] for i in range(len(got))]
    m = per_rank[0]["metrics"]
    jm = {k: float(ref[f"{case}/m/{k}"]) for k in m}
    assert abs(m["loss"] - jm["loss"]) < 1e-5, (m, jm)
    assert m["aggregate_weight"] == jm["aggregate_weight"]
    assert m["updates_aggregated"] == jm["updates_aggregated"]
    assert abs(m["update_norm"] / jm["update_norm"] - 1) < 1e-4
    assert per_rank[0]["step"] == 1
    if comp == "none":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
    else:
        model, params, batch, agg, _, _ = _one_process(
            arch, worlds["inits"], worlds["batches"], shape[0], hier, comp)
        share, worst, ok = int8_round_limit(got, want, _pod_steps(
            model, params, batch, agg, shape[0]))
        assert ok, (share, worst)
    wire = per_rank[0]["wire"]
    assert wire["model_all_gather"]["calls"] > 0
    if arch == "deepseek-v2-lite-16b":
        assert wire["model_psum"]["calls"] > 0
    if case == "gemma_114_flat":        # the ring, both directions
        assert wire["model_ppermute"]["calls"] > 0


@pytest.mark.parametrize("case", ["llama_112_flat", "gemma_114_flat",
                                  "deepseek_112_flat"])
def test_model_axis_is_the_ports_one_process_step(case, worlds):
    """On a model axis alone the ranks compute the port's one-process
    step (the one-device math): params within atol 5e-5 and the metrics
    within the JAX limits."""
    _, arch, shape, _, _ = next(s for s in STEPS if s[0] == case)
    _, _, _, _, want, wm = _one_process(arch, worlds["inits"],
                                        worlds["batches"])
    got = worlds[int(np.prod(shape))][0]["steps"][case]
    for g, w in zip(got["params"], want):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
    assert abs(got["metrics"]["loss"] - float(wm["loss"])) < 1e-5
    assert abs(got["metrics"]["update_norm"]
               / float(wm["update_norm"]) - 1) < 1e-4


def test_trainer_ranks_agree_after_two_rounds(worlds):
    """Two int8 rounds of ``FusedFLTrainer`` on (2,1,2): every rank's
    params and history bit-identical."""
    runs = [res["trainer"] for res in worlds[4]]
    for r, (params, hist) in enumerate(runs[1:], 1):
        assert _bits_equal(runs[0][0], params), r
        assert hist == runs[0][1]
    assert [h["round"] for h in runs[0][1]] == [1, 2]


def _close(got, want, what):
    """Within 1e-5 of the tensor's largest magnitude (1e-5 absolute where
    that is below 1): fp32 rounding in another summation order."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _data_rows(x, shape, rank):
    D, M = shape
    d = rank // M
    return x[d * x.shape[0] // D:(d + 1) * x.shape[0] // D]


@pytest.mark.parametrize("case,shape,window", FLASH,
                         ids=[f[0] for f in FLASH])
def test_flash_sp_matches_the_jax_region(case, shape, window, worlds,
                                         jax_ref):
    ref = jax_ref[1]()
    for rank, res in enumerate(worlds[int(np.prod(shape))]):
        for n, got in zip(("out", "dq", "dk", "dv"), res["flash"][case]):
            _close(got, _data_rows(ref[f"{case}/{n}"], shape, rank),
                   f"{case} {n} rank {rank}")


@pytest.mark.parametrize("case,m,tied", VOCAB, ids=[v[0] for v in VOCAB])
def test_sharded_vocab_matches_the_jax_regions(case, m, tied, worlds,
                                               jax_ref):
    ref = jax_ref[1]()
    names = ("embed", "g_table", "ce", "g_w", "g_hidden", "logits")
    for rank, res in enumerate(worlds[m]):
        for n, got in zip(names, res["vocab"][case]):
            _close(got, ref[f"{case}/{n}"], f"{case} {n} rank {rank}")


@pytest.mark.parametrize("case,shape,cf", EP, ids=[e[0] for e in EP])
def test_ep_matches_the_jax_region(case, shape, cf, worlds, jax_ref):
    """Capacity from each data shard's tokens, the default capacity
    factor dropping assignments; the load-balance loss over all of the
    call's tokens."""
    ref = jax_ref[1]()
    for rank, res in enumerate(worlds[int(np.prod(shape))]):
        y, aux, gx, gp = res["ep"][case]
        _close(y, _data_rows(ref[f"{case}/y"], shape, rank), f"{case} y")
        assert abs(aux - float(ref[f"{case}/aux"])) < 1e-6
        _close(gx, _data_rows(ref[f"{case}/gx"], shape, rank), f"{case} gx")
        for i, g in enumerate(gp):
            _close(g, ref[f"{case}/gp/{i}"], f"{case} param {i}")


@pytest.mark.parametrize("case,error,text", [
    ("ssm", "ValueError",
     "ssm_scan_sharded: a d_inner of 63 does not split over 2 'model'"),
    ("hybrid", "ValueError",
     "ssm_scan_sharded: a d_inner of 63 does not split over 2 'model'"),
    ("frontend", "ValueError",
     "internvl2-26b: F + S = 4 patches + 15 tokens do not split over 2"),
    ("encoder", "ValueError",
     "seamless-m4t-large-v2: 5 frames do not split over 2 'model' ranks"),
    ("ragged", "ValueError", "does not split evenly"),
    ("experts", "ValueError", "7 experts do not split")])
def test_what_a_model_axis_refuses(case, error, text, worlds):
    """Every family runs on a model axis; what it refuses is a shape
    that does not split over the model ranks, by name."""
    for res in worlds[2]:
        got = res["refusals"][case]
        assert got.startswith(error) and text in got, got
        assert "ROADMAP A.8, part 2" not in got


def test_one_process_refuses_a_model_axis():
    with pytest.raises(ValueError, match="spawn_ranks"):
        make_debug_mesh((1, 1, 2), AXES)
