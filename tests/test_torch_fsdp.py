"""Sharded storage in the fused round and the serving steps: each rank
holds only its block of each param and server-state leaf, by the JAX
package's sharding rules (``fl/round.py::train_shardings`` /
``serve_shardings``, ``sharding/rules.py``), on 2- and 4-rank gloo
worlds on the CPU (one spawn a world), reduced fp32 llama3.2-3b,
deepseek-v2-lite-16b and seamless-m4t-large-v2.

Each round is held against the replicated rank round of the same
params and batch on the same ranks, and the 4-rank rounds against the
JAX package's step jitted with ``train_shardings``' ``in_shardings`` on
8 forced host devices (one subprocess, started with the file's first
test, on meshes that compile under jax 0.9.0: (1,2,1) does not).

Tolerances, each with its reason:

* ``none`` within 1e-6 of the largest element of the reference: the
  gathers' adjoints sum each microbatch's gradient over the data ranks
  before the fold adds the microbatches (the replicated round folds
  first, then sums), and each microbatch seeds its loss with its weight
  (the replicated round multiplies after) — the same sums in another
  order; against the JAX step 5e-5, as ``tests/test_torch_dist_round.py``
  holds the replicated round;
* int8, on leaves whose shards keep the whole leaf's blocks (the last
  axis unsplit, or split into multiples of 256): the two-part limit of
  ``test_torch_fused_round.int8_round_limit`` (a ``q`` may flip at a .5
  boundary where the two deltas differ by rounding);
* int8, on the other leaves: a shard blocks its own last axis, so its
  scales differ from the whole leaf's; each pod's error is at most half
  its block's scale on either side, so the means over P pods differ by
  at most Σ_p (s_p + s'_p) / 2P (s whole-leaf, s' shard blocks; plus
  1e-5);
* the pod tier alone on the same deltas: bit-equal where the blocks
  align, within P steps of the leaf's largest scale elsewhere;
* the loss within 1e-5, the update norm within 1e-5 (relative; 1e-4
  with int8, where a flipped ``q`` moves it, and against the JAX step),
  the weight equal;
* ranks that hold the same block: bit-identical;
* a serve's logits within 1e-5 of the replicated serve on the same
  ranks, and within 1e-4 of the one-process serve (the rows of the
  rank, fp32) for a config without MoE: ep takes each expert's capacity
  from the tokens of the rank's rows, as the JAX package's per-shard
  region does, so a one-process serve of every row drops others.
"""
import numpy as np
import pytest
import torch

import _torch_fsdp_ranks as ranks
from repro_torch.configs import ARCHS
from repro_torch.fl.round import (AggregationConfig, build_decode_step,
                                  build_prefill_step, build_train_step,
                                  train_shardings)
from repro_torch.fl.server import init_server_state
from repro_torch.launch.dist import spawn_ranks
from repro_torch.launch.mesh import make_debug_mesh, stand_in_mesh
from repro_torch.sharding.rules import block_bytes, split_over
from repro_torch.tree import tree_leaves
from test_torch_fused_round import ForcedRun, int8_round_limit

torch.set_num_threads(2)

ARCHS3 = ("llama3.2-3b", "deepseek-v2-lite-16b", "seamless-m4t-large-v2")
SHORT = {"llama3.2-3b": "llama", "deepseek-v2-lite-16b": "deepseek",
         "seamless-m4t-large-v2": "seamless"}
#: (case, arch, mesh, hierarchy, compress); ``jax``: the JAX step
#: compiles on the mesh and is held beside the replicated round
ROUNDS = {
    2: [(f"{SHORT[a]}_h121_{c}", a, (1, 2, 1), "hierarchical", c)
        for a in ARCHS3 for c in ("none", "int8")]
    + [(f"{SHORT[a]}_f112_none", a, (1, 1, 2), "flat", "none")
       for a in ARCHS3],
    4: [(f"{SHORT[a]}_h221_{c}", a, (2, 2, 1), "hierarchical", c)
        for a in ARCHS3 for c in ("none", "int8")]
    + [(f"{SHORT[a]}_f122_none", a, (1, 2, 2), "flat", "none")
       for a in ARCHS3],
}
JAX_ROUNDS = [r for r in ROUNDS[4]]
SERVES = {2: [("llama_serve_121", "llama3.2-3b", (1, 2, 1)),
              ("seamless_serve_112", "seamless-m4t-large-v2", (1, 1, 2))],
          4: [("deepseek_serve_122", "deepseek-v2-lite-16b", (1, 2, 2)),
              ("seamless_serve_221", "seamless-m4t-large-v2", (2, 2, 1))]}
FAULT = ("llama_h121_fault", "llama3.2-3b", (1, 2, 1), "hierarchical",
         "none")
TIMEOUT_S = 300

JAX_FSDP = """
    import numpy as np, jax, jax.numpy as jnp
    from repro.compat import use_mesh
    from repro.configs import ARCHS
    from repro.fl.round import (AggregationConfig, build_train_step,
                                train_shardings)
    from repro.fl.server import init_server_state
    from repro.launch.mesh import dp_axes, make_debug_mesh
    from repro.sharding import batch_specs, to_named

    inp = np.load(INPUTS)
    out = {}
    for case, arch, shape, hier, comp in JAX_ROUNDS:
        cfg = ARCHS[arch].reduced(dtype='float32')
        mesh = make_debug_mesh(shape, ('pod', 'data', 'model'))
        with use_mesh(mesh):
            agg = AggregationConfig(hierarchy=hier, compress=comp,
                                    num_microbatches=2)
            step, model = build_train_step(cfg, mesh, agg)
            pspecs, sspecs = train_shardings(model, mesh, agg)
            treedef = jax.tree.structure(
                jax.eval_shape(model.init, jax.random.PRNGKey(0)))
            params = jax.tree.unflatten(treedef, [
                jnp.asarray(inp[f'{arch}/init/{i}'])
                for i in range(treedef.num_leaves)])
            state = init_server_state('fedavg', params)
            batch = {k.split('/')[-1]: jnp.asarray(inp[k])
                     for k in inp.files if k.startswith(f'{arch}/batch/')}
            bspecs = batch_specs(batch, dp_axes(mesh))
            put = lambda x, s: jax.device_put(x, to_named(s, mesh))
            fn = jax.jit(step, in_shardings=(
                to_named(pspecs, mesh), to_named(sspecs, mesh),
                to_named(bspecs, mesh)))
            p2, _, m = fn(put(params, pspecs), put(state, sspecs),
                          put(batch, bspecs))
            for i, l in enumerate(jax.tree.leaves(p2)):
                out[f'{case}/{i}'] = np.asarray(l)
            for k, v in m.items():
                out[f'{case}/m/{k}'] = np.asarray(v)
    np.savez(PATH, **out)
    print('OK')
"""


def _init(arch):
    _, model = build_train_step(ranks.cfg_of(arch),
                                make_debug_mesh((1, 1, 1), ranks.AXES),
                                AggregationConfig())
    return [l.numpy() for l in tree_leaves(model.init(0, device="cpu"))]


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    """The JAX package's sharded steps from a subprocess started with
    the file's first test, on the port's seed-0 params -> a function
    that waits for its results."""
    tmp = tmp_path_factory.mktemp("fsdp")
    inputs, path = tmp / "inputs.npz", tmp / "jax_fsdp.npz"
    arrays = {}
    for arch in ARCHS3:
        for i, l in enumerate(_init(arch)):
            arrays[f"{arch}/init/{i}"] = l
        for k, v in ranks.batch_of(ranks.cfg_of(arch)).items():
            arrays[f"{arch}/batch/{k}"] = v
    np.savez(inputs, **arrays)
    code = JAX_FSDP.replace("INPUTS", repr(str(inputs))).replace(
        "PATH", repr(str(path))).replace("JAX_ROUNDS", repr(JAX_ROUNDS))
    run = ForcedRun(code, ndev=8)

    def results():
        assert "OK" in run.stdout()
        return np.load(path)

    yield results
    run.close()


@pytest.fixture(scope="module")
def worlds():
    """One spawn a world: its rounds (the planted fault in world 2),
    serves, a shard / gather round trip and the pod tier on blocks ->
    {world: [per rank]}."""
    plans = {}
    for w in (2, 4):
        plan = [(name, "train", dict(arch=a, shape=s, hierarchy=h,
                                     compress=c))
                for name, a, s, h, c in ROUNDS[w]]
        plan += [(name, "serve", dict(arch=a, shape=s))
                 for name, a, s in SERVES[w]]
        plans[w] = plan
    name, a, s, h, c = FAULT
    plans[2].append((name, "train", dict(arch=a, shape=s, hierarchy=h,
                                         compress=c,
                                         fault="data_counted_twice")))
    plans[2].append(("roundtrip", "roundtrip",
                     dict(arch="seamless-m4t-large-v2", shape=(1, 1, 2))))
    plans[4] += [("roundtrip", "roundtrip",
                  dict(arch="deepseek-v2-lite-16b", shape=(1, 2, 2))),
                 ("ring", "ring", {})]
    return {w: spawn_ranks(ranks.run_plan, w, plan, device="cpu",
                           timeout_s=TIMEOUT_S)
            for w, plan in plans.items()}


def _round(name):
    for w, rows in ROUNDS.items():
        for row in rows:
            if row[0] == name:
                return w, row
    return 2, FAULT


def _held(got, want, name, comp, rows, atol_none):
    """``none``: within ``atol_none(the largest reference element)``;
    int8: the int8 limit on the leaves whose shards keep the whole
    leaf's blocks, P steps on the others (module docstring)."""
    if comp == "none":
        scale = max(float(np.abs(w).max()) for w in want)
        worst = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        assert worst <= atol_none(scale), (name, worst, scale)
        return
    keep = ranks.aligned(rows[0])
    steps, bounds = ranks.int8_limits(rows)
    pick = lambda xs, want: [x for x, a in zip(xs, keep) if a == want]
    share, worst, ok = int8_round_limit(pick(got, True), pick(want, True),
                                        pick(steps, True))
    assert ok, (name, share, worst)
    over = [float((np.abs(g.astype(np.float64) - w) - 1e-5 - b).max())
            for g, w, b in zip(pick(got, False), pick(want, False),
                               pick(bounds, False))]
    assert max(over, default=-1.0) <= 0, (name, over)


@pytest.mark.parametrize("name", [r[0] for w in (2, 4) for r in ROUNDS[w]])
def test_sharded_round_matches_the_replicated_round(name, worlds):
    w, (_, arch, shape, hier, comp) = _round(name)
    rows = [r[name] for r in worlds[w]]
    rank0 = rows[0]
    _held(rank0["whole"], rank0["rep"], name, comp, rows,
          lambda scale: 1e-6 * scale)
    for r in rows:
        m, rm = r["metrics"], r["rep_metrics"]
        assert m["aggregate_weight"] == rm["aggregate_weight"]
        assert m["updates_aggregated"] == rm["updates_aggregated"]
        assert abs(m["loss"] - rm["loss"]) <= 1e-5, (m, rm)
        assert abs(m["update_norm"] - rm["update_norm"]) <= \
            (1e-5 if comp == "none" else 1e-4) * rm["update_norm"], (m, rm)
        assert r["step"] == 1


@pytest.mark.parametrize("name", [r[0] for r in JAX_ROUNDS])
def test_sharded_round_matches_the_jax_sharded_step(name, worlds, jax_ref):
    ref = jax_ref()
    w, (_, arch, shape, hier, comp) = _round(name)
    rows = [r[name] for r in worlds[w]]
    rank0 = rows[0]
    want = [ref[f"{name}/{i}"] for i in range(len(rank0["whole"]))]
    _held(rank0["whole"], want, name, comp, rows,
          lambda scale: 5e-5)
    m = rank0["metrics"]
    assert abs(m["loss"] - float(ref[f"{name}/m/loss"])) <= 1e-5
    assert abs(m["update_norm"] - float(ref[f"{name}/m/update_norm"])) \
        <= 1e-4 * m["update_norm"]
    assert m["aggregate_weight"] == float(ref[f"{name}/m/aggregate_weight"])


@pytest.mark.parametrize("name", [r[0] for w in (2, 4) for r in ROUNDS[w]])
def test_ranks_holding_the_same_block_are_bit_identical(name, worlds):
    """Ranks that differ only on axes a leaf is not split over hold the
    same block of it, to the bit; and every block differs in shape from
    the whole leaf exactly where its spec splits it."""
    w, (_, arch, shape, hier, comp) = _round(name)
    rows = [r[name] for r in worlds[w]]
    mesh = stand_in_mesh(shape, ranks.AXES)
    cfg = ranks.cfg_of(arch)
    _, model = build_train_step(cfg, mesh, ranks.agg_of(hier, comp))
    specs = tree_leaves(train_shardings(model, mesh,
                                        ranks.agg_of(hier, comp))[0])
    split_leaves = 0
    for i, spec in enumerate(specs):
        axes = split_over(spec, mesh)
        split_leaves += bool(axes)
        holders = {}
        for r in rows:
            key = tuple(c for a, c in zip(ranks.AXES, r["coords"])
                        if a in axes)
            holders.setdefault(key, set()).add(r["digests"][i])
        assert all(len(d) == 1 for d in holders.values()), (name, i, spec)
        whole = rows[0]["whole"][i].shape
        assert (tuple(rows[0]["block_shapes"][i]) != whole) == bool(axes)
    assert split_leaves > 0


@pytest.mark.parametrize("name", [r[0] for w in (2, 4) for r in ROUNDS[w]])
def test_resident_bytes_are_the_specs_blocks(name, worlds):
    """Each rank holds the bytes the specs reckon, below a replica's."""
    w, (_, arch, shape, hier, comp) = _round(name)
    cfg = ranks.cfg_of(arch)
    agg = ranks.agg_of(hier, comp)
    for rank, r in enumerate(worlds[w]):
        mesh = stand_in_mesh(shape, ranks.AXES, rank)
        _, model = build_train_step(cfg, mesh, agg)
        pspecs, sspecs = train_shardings(model, mesh, agg)
        params = model.init(0, device="meta")
        state = init_server_state("fedavg", params)
        reckoned = block_bytes(params, pspecs, mesh) + \
            block_bytes(state, sspecs, mesh)
        replica = sum(l.numel() * l.element_size()
                      for l in tree_leaves([params, state]))
        assert r[name]["resident"] == reckoned < replica


def test_a_shard_counted_twice_fails_the_limit(worlds):
    """Data rank 1's part of every data-gathered gradient counted twice
    moves the round far above the ``none`` limit."""
    name = FAULT[0]
    rank0 = worlds[2][0][name]
    scale = max(float(np.abs(w).max()) for w in rank0["rep"])
    worst = max(float(np.abs(g - w).max())
                for g, w in zip(rank0["whole"], rank0["rep"]))
    assert worst > 100 * 1e-6 * scale, (worst, scale)


@pytest.mark.parametrize("world", [2, 4])
def test_gather_of_shard_is_the_tree_bit_for_bit(world, worlds):
    assert all(all(r["roundtrip"]) for r in worlds[world])


def test_pod_tier_on_blocks_is_the_whole_leafs_where_blocks_align(worlds):
    """The int8 ring on this rank's blocks against the ring on whole
    leaves, from the same deltas: bit-equal where a shard keeps the
    whole leaf's blocks; within P steps of the pods' largest scale
    elsewhere."""
    rank0 = worlds[4][0]["ring"]
    n_pods = 2
    aligned = [True, True, False, False, True]
    for whole, blocks, ok in zip(rank0["whole"], rank0["blocks"], aligned):
        if ok:
            assert np.array_equal(whole, blocks)
        else:
            assert not np.array_equal(whole, blocks)
    # a step: the largest scale of any block of the pods' leaves over P
    step = np.max([[np.abs(x).max() / 127 / n_pods
                    for x in r["ring"]["inputs"]] for r in worlds[4]],
                  axis=0)
    for whole, blocks, ok, s in zip(rank0["whole"], rank0["blocks"],
                                    aligned, step):
        assert float(np.abs(whole - blocks).max()) <= n_pods * s + 1e-7


def _one_process_serve(arch, steps=2):
    cfg = ranks.cfg_of(arch)
    mesh = make_debug_mesh((1, 1, 1), ranks.AXES)
    full = ranks.batch_of(cfg)
    prefill, model = build_prefill_step(cfg, mesh)
    decode, _ = build_decode_step(cfg, mesh)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in full.items()
             if k != "labels"}
    logits, caches = prefill(params, batch)
    out = [logits.numpy()]
    offset = cfg.frontend_tokens if cfg.frontend and not \
        cfg.encoder_layers else 0
    for i in range(steps):
        tok = torch.from_numpy(full["labels"][:, i:i + 1].clip(0))
        logits, caches = decode(params, tok, caches, offset + ranks.S + i)
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("name,arch,shape",
                         [s for w in (2, 4) for s in SERVES[w]])
def test_sharded_serve_matches_the_one_process_serve(name, arch, shape,
                                                     worlds):
    want = _one_process_serve(arch)
    rows = [r[name] for r in worlds[int(np.prod(shape))]]
    n_data = shape[1]
    for r in rows:
        at = r["coords"][0] * n_data + r["coords"][1]
        for got, rep, ref in zip(r["logits"], r["rep_logits"], want):
            k = got.shape[0]
            assert float(np.abs(got - rep).max()) <= 1e-5, name
            if ARCHS[arch].moe is None:
                assert float(np.abs(got - ref[at * k:(at + 1) * k]).max()) \
                    <= 1e-4, (name, r["coords"])


def test_pod_specs_of_a_hierarchical_round_are_refused():
    """The pod tier averages whole leaves across pods: a hierarchical
    round whose specs split a leaf over 'pod' is refused when built."""
    mesh = stand_in_mesh((2, 2, 1), ranks.AXES)
    cfg = ranks.cfg_of("llama3.2-3b")
    agg = ranks.agg_of("hierarchical", "none")
    _, model = build_train_step(cfg, mesh, agg)
    specs = train_shardings(model, mesh, agg, fsdp=("pod", "data"))
    with pytest.raises(ValueError, match="'pod'"):
        build_train_step(cfg, mesh, agg, in_specs=specs)


def test_specs_need_a_mesh_over_ranks():
    mesh = make_debug_mesh((2, 1, 1), ranks.AXES)
    cfg = ranks.cfg_of("llama3.2-3b")
    agg = ranks.agg_of("hierarchical", "none")
    _, model = build_train_step(cfg, mesh, agg)
    specs = train_shardings(model, mesh, agg)
    with pytest.raises(ValueError, match="across ranks"):
        build_train_step(cfg, mesh, agg, in_specs=specs)
