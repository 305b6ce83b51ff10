"""The model axis across ranks for the SSM, hybrid, frontend and encoder
configs, and the serving steps across ranks: one gloo rank a
coordinate of a mesh whose ``model`` axis is 2 or 4, held against the
JAX package on as many forced host devices.

* ``models/ssm.py::ssm_scan_sharded`` against the JAX ``shard_map``
  region on (data, model) meshes (1,2), (1,4) and (2,2), in both
  in-chunk forms: y, h_final and the gradients of u, h0 and the five
  scan params (reduced falcon-mamba-7b, d_inner 128, 4 sequences of 12
  steps in chunks of 4, from a non-zero h0).
* ``build_train_step`` of reduced fp32 falcon-mamba-7b (16 tokens),
  hymba-1.5b (32 tokens: on 4 model ranks a shard of 8 rows, so its
  window of 8 takes the ring), internvl2-26b (4 stub patches + 16
  tokens) and seamless-m4t-large-v2 (4 stub frames, 16 tokens) on
  (1,1,2), (2,1,2) and (1,1,4), 8 sequences in 2 microbatches, against
  the JAX step.  Under jax 0.9.0 the JAX step compiles on every one of
  these meshes, hierarchical and flat, so no case falls back to the
  port's own one-process step.
* ``fl/round.py``'s ``build_prefill_step`` and ``build_decode_step`` on
  a (data, model) mesh of (1,2) against the JAX package's (hymba-1.5b,
  internvl2-26b, seamless-m4t-large-v2), and on (1,4) and (2,2) against
  the port's one-process serve (hymba-1.5b's ring, falcon-mamba-7b's
  rows over two data ranks): a prefill of 4 sequences, then 3 decode
  steps of fixed tokens.
* Two int8 ``FusedFLTrainer`` rounds of hymba-1.5b on (1,1,4).

The JAX side runs in two subprocesses with 8 forced host devices each,
started with the file's first test (the scans, the serve runs and the
falcon-mamba-7b and internvl2-26b steps in one; the hymba-1.5b and
seamless-m4t-large-v2 steps in the other); the port's ranks run on the
CPU, one spawn a world size (2 and 4).

Tolerances, each with its reason:

* steps without compression, params within atol 5e-5: the sums over
  model ranks run in another order than XLA's
  (``tests/test_torch_model_axis.py``);
* steps with int8, the two-part limit of
  ``test_torch_fused_round.int8_round_limit``;
* the loss within 1e-5, the update norm within 1e-4 (relative), the
  weight and the update count equal;
* every rank's params bit-identical (after one step, and after two
  trainer rounds); every model rank's serve outputs bit-identical;
* the scan region, values and gradients within 1e-5 of each tensor's
  largest magnitude (fp32; the psum's parts and the gathered
  cotangents are summed in another order);
* serving, logits and caches within 1e-4 (rtol = atol), the fp32 cache
  tolerance of ``tests/test_torch_ssm.py``: the port's SSM decode state
  is the sharded scan's own, gathered, where the JAX prefill scans a
  second time, and a rank's rows go through the products in another
  blocking than the whole batch's.
"""
import textwrap
import time

import numpy as np
import pytest
import torch

import _torch_model_ranks_ssm_front as ranks
from repro_torch.configs import ARCHS
from repro_torch.fl.round import (AggregationConfig, build_decode_step,
                                  build_prefill_step, build_train_step)
from repro_torch.launch.dist import spawn_ranks
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from test_torch_fused_round import ForcedRun, _pod_steps, int8_round_limit
from test_torch_model_axis import _bits_equal, _close, _data_rows

torch.set_num_threads(2)

AXES = ("pod", "data", "model")
SEQ = {"falcon-mamba-7b": 16, "hymba-1.5b": 32, "internvl2-26b": 16,
       "seamless-m4t-large-v2": 16}
#: (case, arch, mesh, hierarchy, compress)
STEPS = [
    ("falcon_112_int8", "falcon-mamba-7b", (1, 1, 2), "hierarchical",
     "int8"),
    ("falcon_212_flat", "falcon-mamba-7b", (2, 1, 2), "flat", "none"),
    ("falcon_114_flat", "falcon-mamba-7b", (1, 1, 4), "flat", "none"),
    ("hymba_112_flat", "hymba-1.5b", (1, 1, 2), "flat", "none"),
    ("hymba_212_flat", "hymba-1.5b", (2, 1, 2), "flat", "none"),
    ("hymba_114_flat", "hymba-1.5b", (1, 1, 4), "flat", "none"),
    ("internvl_112_flat", "internvl2-26b", (1, 1, 2), "flat", "none"),
    ("internvl_212_int8", "internvl2-26b", (2, 1, 2), "hierarchical",
     "int8"),
    ("internvl_114_flat", "internvl2-26b", (1, 1, 4), "flat", "none"),
    ("seamless_112_int8", "seamless-m4t-large-v2", (1, 1, 2),
     "hierarchical", "int8"),
    ("seamless_212_flat", "seamless-m4t-large-v2", (2, 1, 2), "flat",
     "none"),
    ("seamless_114_flat", "seamless-m4t-large-v2", (1, 1, 4), "flat",
     "none"),
]
#: the JAX subprocess each arch's steps run in
SIDE = {"falcon-mamba-7b": 0, "internvl2-26b": 0, "hymba-1.5b": 1,
        "seamless-m4t-large-v2": 1}
#: (case, (data, model), intra_chunk)
SCANS = [(f"s{d}{m}_{intra}", (d, m), intra)
         for d, m in ((1, 2), (1, 4), (2, 2)) for intra in ("seq", "assoc")]
#: (case, arch, (data, model)); the (1, 2) cases against the JAX package's
SERVE = [("hymba_12", "hymba-1.5b", (1, 2)),
         ("internvl_12", "internvl2-26b", (1, 2)),
         ("seamless_12", "seamless-m4t-large-v2", (1, 2)),
         ("hymba_14", "hymba-1.5b", (1, 4)),
         ("falcon_22", "falcon-mamba-7b", (2, 2))]
SERVE_TOL = 1e-4
DECODE_STEPS = 3
TIMEOUT_S = 300

JAX_SIDE = """
    import os
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import use_mesh
    from repro.configs import ARCHS
    from repro.fl.round import (AggregationConfig, build_decode_step,
                                build_prefill_step, build_train_step)
    from repro.fl.server import init_server_state
    from repro.launch.mesh import make_debug_mesh
    from repro.models import ssm as jssm

    inp = np.load(INPUTS)
    inits, out = {}, {}
    for arch in SEQ:
        cfg = ARCHS[arch].reduced(dtype='float32')
        mesh = make_debug_mesh((1, 1, 1), ('pod', 'data', 'model'))
        with use_mesh(mesh):
            _, model = build_train_step(cfg, mesh, AggregationConfig())
            inits[arch] = jax.tree.map(np.asarray,
                                       model.init(jax.random.PRNGKey(0)))
    if SIDE == 0:
        early = {f'{a}/init/{i}': l for a in SEQ
                 for i, l in enumerate(jax.tree.leaves(inits[a]))}
        np.savez(EARLY + '.tmp.npz', **early)
        os.replace(EARLY + '.tmp.npz', EARLY)

        cfg = ARCHS['falcon-mamba-7b'].reduced(dtype='float32')
        p = {k: jnp.asarray(inp[f'scan/{k}']) for k in SCAN_KEYS}
        u, h0, cy, ch = (jnp.asarray(inp[f'scan/{n}'])
                         for n in ('u', 'h0', 'cy', 'ch'))
        for case, shape, intra in SCANS:
            mesh = make_debug_mesh(shape, ('data', 'model'))
            f = lambda p, u, h0: jssm.ssm_scan_sharded(
                cfg, p, u, h0, chunk=4, dp_axes=('data',),
                model_axis='model', intra_chunk=intra)

            def loss(p, u, h0):
                y, h = f(p, u, h0)
                return jnp.sum(y * cy) + jnp.sum(h * ch)

            with use_mesh(mesh):
                y, h = jax.jit(f)(p, u, h0)
                gp, gu, gh = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
                    p, u, h0)
            got = [y, h, gu, gh] + [gp[k] for k in SCAN_KEYS]
            for i, x in enumerate(got):
                out[f'{case}/{i}'] = np.asarray(x)

        for case, arch, shape in SERVE:
            if shape != (1, 2):
                continue
            cfg = ARCHS[arch].reduced(dtype='float32')
            mesh = make_debug_mesh(shape, ('data', 'model'))
            batch = {k: jnp.asarray(inp[f'serve/{arch}/{k}'])
                     for k in ('tokens', 'frontend')
                     if f'serve/{arch}/{k}' in inp.files}
            batch['tokens'] = batch['tokens'].astype(jnp.int32)
            dec_toks = inp[f'serve/{arch}/decode'].astype(np.int32)
            with use_mesh(mesh):
                prefill, _ = build_prefill_step(cfg, mesh)
                decode, _ = build_decode_step(cfg, mesh)
                logits, caches = jax.jit(prefill)(inits[arch], batch)
                out[f'{case}/logits/0'] = np.asarray(logits)
                for i, c in enumerate(jax.tree.leaves(caches)):
                    out[f'{case}/caches/{i}'] = np.asarray(c)
                pos = batch['tokens'].shape[1] + (
                    cfg.frontend_tokens
                    if cfg.frontend and not cfg.encoder_layers else 0)
                step = jax.jit(decode)
                for i in range(dec_toks.shape[1]):
                    logits, caches = step(inits[arch],
                                          jnp.asarray(dec_toks[:, i:i + 1]),
                                          caches, jnp.int32(pos + i))
                    out[f'{case}/logits/{i + 1}'] = np.asarray(logits)

    for case, arch, shape, hier, comp in STEPS:
        if SIDES[arch] != SIDE:
            continue
        cfg = ARCHS[arch].reduced(dtype='float32')
        mesh = make_debug_mesh(shape, ('pod', 'data', 'model'))
        batch = {k: jnp.asarray(inp[f'{arch}/{k}'])
                 for k in ('tokens', 'labels', 'frontend')
                 if f'{arch}/{k}' in inp.files}
        for k in ('tokens', 'labels'):
            batch[k] = batch[k].astype(jnp.int32)
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
    np.savez(PATH, **out)
    print('OK')
"""


def _inputs():
    """Every input, drawn with numpy from seed 0: each arch's batch (8
    sequences, some rows with extra ignored labels, the stub's
    embeddings), the scan's params and tensors, and each serve arch's
    prompt (4 sequences) and decode tokens."""
    rng = np.random.default_rng(0)
    out = {}
    for arch, S in SEQ.items():
        cfg = ARCHS[arch].reduced(dtype="float32")
        toks = rng.integers(0, cfg.vocab_size, size=(8, S))
        labels = np.roll(toks, -1, 1)
        labels[:, -1] = -1
        labels[1, :5] = -1
        labels[6, :9] = -1
        out[f"{arch}/tokens"], out[f"{arch}/labels"] = toks, labels
        serve = {"tokens": toks[:4], "decode": rng.integers(
            0, cfg.vocab_size, size=(4, DECODE_STEPS))}
        if cfg.frontend:
            out[f"{arch}/frontend"] = rng.normal(
                size=(8, cfg.frontend_tokens, cfg.d_model)).astype(
                    np.float32)
            serve["frontend"] = out[f"{arch}/frontend"][:4]
        for k, v in serve.items():
            out[f"serve/{arch}/{k}"] = v
    cfg = ARCHS["falcon-mamba-7b"].reduced(dtype="float32")
    d_in, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    dt_rank = cfg.ssm.resolved_dt_rank(cfg.d_model)
    scan = {
        "x_proj": rng.normal(size=(d_in, dt_rank + 2 * N)) * 0.1,
        "dt_proj": rng.normal(size=(dt_rank, d_in)) * 0.1,
        "dt_bias": rng.normal(size=(d_in,)) * 0.5 - 4.6,
        "A_log": np.log(np.tile(np.arange(1, N + 1), (d_in, 1))),
        "D": rng.normal(size=(d_in,)),
        "u": rng.normal(size=(4, 12, d_in)),
        "h0": rng.normal(size=(4, d_in, N)) * 0.1,
        "cy": rng.normal(size=(4, 12, d_in)),
        "ch": rng.normal(size=(4, d_in, N))}
    for k, v in scan.items():
        out[f"scan/{k}"] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    """The JAX package's regions, steps and serving, from two
    subprocesses started with the file's first test -> (the inputs, a
    function that returns the JAX init leaves once written, a function
    that waits for the results)."""
    tmp = tmp_path_factory.mktemp("model_axis_ssm_front")
    inputs, early = _inputs(), tmp / "jax_inits.npz"
    np.savez(tmp / "inputs.npz", **inputs)
    paths = [tmp / f"jax_side{i}.npz" for i in (0, 1)]
    runs = []
    for side, path in enumerate(paths):
        names = {"PATH": str(path), "EARLY": str(early),
                 "INPUTS": str(tmp / "inputs.npz"), "SIDE": side,
                 "SIDES": SIDE, "STEPS": STEPS, "SCANS": SCANS,
                 "SERVE": SERVE, "SEQ": SEQ,
                 "SCAN_KEYS": ranks.SCAN_KEYS}
        code = "".join(f"{k} = {v!r}\n" for k, v in names.items()) \
            + textwrap.dedent(JAX_SIDE)
        runs.append(ForcedRun(code, ndev=8))

    def inits():
        deadline = time.monotonic() + TIMEOUT_S
        while not early.exists():
            assert runs[0].proc.poll() is None, runs[0].stdout()
            assert time.monotonic() < deadline, "no JAX inits"
            time.sleep(0.2)
        got = np.load(early)
        return {a: [got[f"{a}/init/{i}"] for i in range(sum(
            k.startswith(f"{a}/init/") for k in got.files))] for a in SEQ}

    def results():
        out = {}
        for run, path in zip(runs, paths):
            assert "OK" in run.stdout()
            got = np.load(path)
            out.update({k: got[k] for k in got.files})
        return out

    yield inputs, inits, results
    for run in runs:
        run.close()


@pytest.fixture(scope="module")
def worlds(jax_ref):
    """One spawn a world size (2 and 4 ranks on the CPU), started as soon
    as the JAX side has written its init leaves -> {world: [per rank]},
    with the inputs and inits."""
    inputs, get_inits, _ = jax_ref
    inits = get_inits()
    batches = {a: {k: inputs[f"{a}/{k}"] for k in ("tokens", "labels",
                                                    "frontend")
                   if f"{a}/{k}" in inputs} for a in SEQ}
    scan = [{k: inputs[f"scan/{k}"] for k in ranks.SCAN_KEYS}] + [
        inputs[f"scan/{n}"] for n in ("u", "h0", "cy", "ch")]
    serve = {a: {k: inputs[f"serve/{a}/{k}"] for k in
                 ("tokens", "frontend", "decode")
                 if f"serve/{a}/{k}" in inputs} for a in SEQ}

    def plan(world):
        return {
            "steps": ([s for s in STEPS if int(np.prod(s[2])) == world],
                      inits, batches),
            "scans": ([s for s in SCANS if int(np.prod(s[1])) == world],
                      scan),
            "serve": ([s for s in SERVE if int(np.prod(s[2])) == world],
                      inits, serve)}

    plans = {w: plan(w) for w in (2, 4)}
    plans[4]["trainer"] = ("hymba-1.5b", (1, 1, 4), inits["hymba-1.5b"],
                           [batches["hymba-1.5b"]] * 2)
    out = {w: spawn_ranks(ranks.run_plan, w, p, device="cpu",
                          timeout_s=TIMEOUT_S)
           for w, p in plans.items()}
    out["inits"], out["batches"], out["serve"] = inits, batches, serve
    return out


def _params(model, leaves):
    _, treedef = tree_flatten(model.init(0, device="cpu"))
    return tree_unflatten(treedef, [torch.from_numpy(a) for a in leaves])


@pytest.mark.parametrize("case,arch,shape,hier,comp", STEPS,
                         ids=[s[0] for s in STEPS])
def test_ranks_match_the_jax_step(case, arch, shape, hier, comp, worlds,
                                  jax_ref):
    ref = jax_ref[2]()
    per_rank = [r["steps"][case] for r in worlds[int(np.prod(shape))]]
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
    if comp == "none":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
    else:
        cfg = ARCHS[arch].reduced(dtype="float32")
        agg = AggregationConfig(hierarchy=hier, compress=comp,
                                num_microbatches=2)
        _, model = build_train_step(
            cfg, make_debug_mesh((shape[0], 1, 1), AXES), agg)
        params = _params(model, worlds["inits"][arch])
        batch = {k: torch.from_numpy(v)
                 for k, v in worlds["batches"][arch].items()}
        share, worst, ok = int8_round_limit(got, want, _pod_steps(
            model, params, batch, agg, shape[0]))
        assert ok, (share, worst)
    wire = per_rank[0]["wire"]
    if arch in ("falcon-mamba-7b", "hymba-1.5b"):
        assert wire["model_psum"]["calls"] > 0      # the x_proj contraction
    if arch != "falcon-mamba-7b":
        assert wire["model_all_gather"]["calls"] > 0
    if case == "hymba_114_flat":        # the window of 8 takes the ring
        assert wire["model_ppermute"]["calls"] > 0


@pytest.mark.parametrize("case,shape,intra", SCANS,
                         ids=[s[0] for s in SCANS])
def test_ssm_scan_sharded_matches_the_jax_region(case, shape, intra, worlds,
                                                 jax_ref):
    """y, h_final, the u and h0 gradients on a rank's data rows; the five
    params' gradients summed over the mesh."""
    ref = jax_ref[2]()
    names = ["y", "h", "du", "dh0"] + [f"d{k}" for k in ranks.SCAN_KEYS]
    for rank, res in enumerate(worlds[int(np.prod(shape))]):
        for i, (n, got) in enumerate(zip(names, res["scans"][case])):
            want = ref[f"{case}/{i}"]
            if i < 4:
                want = _data_rows(want, shape, rank)
            _close(got, want, f"{case} {n} rank {rank}")


def _one_process_serve(arch, worlds):
    """The port's serve in one process on a (1,1) mesh, from the same
    params, prompt and decode tokens -> (logits, cache leaves)."""
    cfg = ARCHS[arch].reduced(dtype="float32")
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    prefill, model = build_prefill_step(cfg, mesh)
    decode, _ = build_decode_step(cfg, mesh)
    params = _params(model, worlds["inits"][arch])
    inp = worlds["serve"][arch]
    batch = {k: torch.from_numpy(v) for k, v in inp.items()
             if k != "decode"}
    logits, caches = prefill(params, batch)
    out = [logits.numpy()]
    leaves = [t.clone().numpy() for t in tree_leaves(caches)]
    pos = batch["tokens"].shape[1] + (
        cfg.frontend_tokens if cfg.frontend and not cfg.encoder_layers else 0)
    toks = torch.from_numpy(inp["decode"])
    for i in range(toks.shape[1]):
        logits, caches = decode(params, toks[:, i:i + 1], caches, pos + i)
        out.append(logits.numpy())
    return out, leaves


def _serve_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL,
                               err_msg=what)


@pytest.mark.parametrize("case,arch,shape", SERVE, ids=[s[0] for s in SERVE])
def test_serving_steps_across_ranks(case, arch, shape, worlds, jax_ref):
    """Every model rank's prefill logits, caches and decode logits
    bit-identical; against the JAX package's on (1, 2), else against the
    port's one-process serve of the same rows."""
    per_rank = worlds[int(np.prod(shape))]
    M = shape[1]
    for rank, res in enumerate(per_rank):
        mine, first = res["serve"][case], per_rank[rank - rank % M]["serve"][
            case]
        assert _bits_equal(mine["logits"], first["logits"]), rank
        assert _bits_equal(mine["caches"], first["caches"]), rank
    one_logits, one_caches = _one_process_serve(arch, worlds)
    if shape == (1, 2):
        ref = jax_ref[2]()
        want_logits = [ref[f"{case}/logits/{i}"]
                       for i in range(DECODE_STEPS + 1)]
        want_caches = [ref[f"{case}/caches/{i}"]
                       for i in range(len(one_caches))]
    else:
        want_logits, want_caches = one_logits, one_caches
    for rank, res in enumerate(per_rank):
        got = res["serve"][case]
        assert len(got["caches"]) == len(want_caches)
        for i, (g, w) in enumerate(zip(got["logits"], want_logits)):
            _serve_close(g, _data_rows(w, shape, rank),
                         f"{case} logits {i} rank {rank}")
        for i, (g, w) in enumerate(zip(got["caches"], want_caches)):
            # a segment's cache stacks its layers ahead of the batch
            _serve_close(g, _data_rows(w.swapaxes(0, 1), shape,
                                       rank).swapaxes(0, 1),
                         f"{case} cache leaf {i} rank {rank}")


def test_trainer_ranks_agree_after_two_rounds(worlds):
    """Two int8 rounds of ``FusedFLTrainer`` of hymba-1.5b on (1,1,4):
    every rank's params and history bit-identical."""
    runs = [res["trainer"] for res in worlds[4]]
    for r, (params, hist) in enumerate(runs[1:], 1):
        assert _bits_equal(runs[0][0], params), r
        assert hist == runs[0][1]
    assert [h["round"] for h in runs[0][1]] == [1, 2]


@pytest.mark.parametrize("arch", list(SEQ) + ["deepseek-v2-lite-16b"])
def test_serving_steps_in_one_process_are_the_lm(arch):
    """On a one-process (1, 1) mesh the serving steps are ``LM.prefill`` and
    ``LM.decode_step`` of a model with their options (bit for
    bit), and within the fp32 cache tolerance of the default options'
    model (plain attention and the chunked scan in place of
    ``chunked_sp`` and the sharded scan; dense MoE is ep's model only
    without drops, so deepseek-v2-lite-16b is held to the first)."""
    from repro_torch.fl.round import serve_options
    from repro_torch.models import ModelOptions, build_model

    cfg = ARCHS[arch].reduced(dtype="float32")
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    prefill, model = build_prefill_step(cfg, mesh)
    decode, _ = build_decode_step(cfg, mesh)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(2, 12)))}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    pos = 12 + (cfg.frontend_tokens if cfg.frontend and not cfg.encoder_layers
                else 0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)))
    same = build_model(cfg, serve_options(cfg, mesh))
    runs = [(prefill, decode), (same.prefill, same.decode_step)]
    if cfg.moe is None:
        plain = build_model(cfg, ModelOptions(mesh=mesh))
        runs.append((plain.prefill, plain.decode_step))
    out = []
    for pf, dec in runs:
        logits, caches = pf(params, batch)
        leaves = [t.clone() for t in tree_leaves(caches)]
        step, _ = dec(params, toks, caches, pos)
        out.append([logits, *leaves, step])
    assert all(torch.equal(a, b) for a, b in zip(out[0], out[1]))
    for a, b in zip(out[0], out[-1]):
        _serve_close(a.numpy(), b.numpy(), arch)
