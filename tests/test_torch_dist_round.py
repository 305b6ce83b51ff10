"""The fused round across processes: one gloo rank a coordinate of a
``(pod, data, model=1)`` mesh (``launch/dist.py``), held against the JAX
package's ``build_train_step`` on a mesh of as many forced host devices.

The JAX side runs in one subprocess (8 forced host devices), started
with the file's first test: reduced fp32 llama3.2-3b, a batch of 8
sequences of 16 tokens (some rows with extra ignored labels, so the
data ranks weigh differently) in 2 microbatches, hierarchical with and
without the int8 hop on (2,1,1), (4,1,1) and (2,2,1); flat; and
``pod_mean_compressed`` over 3 and 4 pods on random leaves.  The port's
ranks run on the CPU (``device="cpu"``), one spawn a world size.  The
port's flat round runs on (2,2,1); the JAX package's flat step does not
compile on that mesh under jax 0.9.0 (XLA's SPMD partitioner: "Cross-
partition allreduce must be in (partial) manual partitioning mode"), so
its reference is the same step on a (1,1,1) mesh: the same mean over
the whole batch, which GSPMD only splits.

Tolerances, each with its reason:

* without compression, params within atol 5e-5
  (``tests/test_multidevice.py``'s flat-vs-hierarchical limit): the
  sums over pods and data ranks run in another order than XLA's;
* with int8, the two-part limit of
  ``test_torch_fused_round.int8_round_limit``: a ``q`` may flip at a .5
  boundary;
* the loss within 1e-5, the update norm within 1e-4 (relative), the
  weight and the update count equal, as the one-process test holds
  them;
* every rank's params bit-identical: the replicated params must not
  drift apart;
* ``pod_mean_compressed`` over 3 and 4 pods bit-equal, on every rank, to
  the JAX ring's pod-0 copy as the JAX code reads (each product and sum
  rounded to fp32); the JAX run's own bits within one ulp of the
  largest term for each rounding XLA's CPU backend fuses or reorders
  (``test_ring_is_the_jax_rings_pod0_copy_on_every_rank``).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro.fl.compression import _quantize_blocks_last_axis as jax_blocks
from repro_torch.configs import ARCHS
from repro_torch.fl.round import AggregationConfig, build_train_step
from repro_torch.launch.dist import spawn_ranks
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.tree import tree_flatten, tree_unflatten
from test_torch_fused_round import ForcedRun, _pod_steps, int8_round_limit

torch.set_num_threads(2)

AXES = ("pod", "data", "model")
#: (case, mesh, hierarchy, compress)
ROUNDS = [("h211_none", (2, 1, 1), "hierarchical", "none"),
          ("h211_int8", (2, 1, 1), "hierarchical", "int8"),
          ("h411_none", (4, 1, 1), "hierarchical", "none"),
          ("h411_int8", (4, 1, 1), "hierarchical", "int8"),
          ("h221_none", (2, 2, 1), "hierarchical", "none"),
          ("h221_int8", (2, 2, 1), "hierarchical", "int8"),
          ("f221_none", (2, 2, 1), "flat", "none")]
RINGS = (3, 4)
TIMEOUT_S = 240

JAX_DIST = """
    import os
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map, use_mesh
    from repro.configs import ARCHS
    from repro.fl.compression import pod_mean_compressed
    from repro.fl.round import AggregationConfig, build_train_step
    from repro.fl.server import init_server_state
    from repro.launch.mesh import make_debug_mesh

    cfg = ARCHS['llama3.2-3b'].reduced(dtype='float32')
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(8, 16))
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    labels[1, :5] = -1
    labels[6, :9] = -1
    batch = {'tokens': jnp.asarray(toks, jnp.int32),
             'labels': jnp.asarray(labels, jnp.int32)}
    out = {}
    early = {'tokens': toks, 'labels': labels}
    rings = {}
    for n in RINGS:
        rings[n] = [rng.normal(size=(n, 5, 300)).astype(np.float32) * 1e-2,
                    rng.normal(size=(n, 7)).astype(np.float32),
                    rng.normal(size=(n, 1000)).astype(np.float32) * 3,
                    rng.normal(size=(n,)).astype(np.float32)]
        for i, x in enumerate(rings[n]):
            early[f'ring{n}/in/{i}'] = x
    for case, shape, hier, comp in ROUNDS:
        if hier == 'flat':
            shape = (1, 1, 1)
        mesh = make_debug_mesh(shape, ('pod', 'data', 'model'))
        with use_mesh(mesh):
            agg = AggregationConfig(hierarchy=hier, compress=comp,
                                    num_microbatches=2)
            step, model = build_train_step(cfg, mesh, agg)
            params = model.init(jax.random.PRNGKey(0))
            if early:
                # the inputs, for the port's ranks to start on
                for i, l in enumerate(jax.tree.leaves(params)):
                    early[f'init/{i}'] = np.asarray(l)
                np.savez(EARLY + '.tmp.npz', **early)
                os.replace(EARLY + '.tmp.npz', EARLY)
                early = None
            state = init_server_state('fedavg', params)
            p2, _, m = jax.jit(step)(params, state, batch)
            for i, l in enumerate(jax.tree.leaves(p2)):
                out[f'{case}/{i}'] = np.asarray(l)
            for k, v in m.items():
                out[f'{case}/m/{k}'] = np.asarray(v)
    for n in RINGS:
        mesh = make_debug_mesh((n,), ('pod',))
        ring = jax.jit(shard_map(lambda xs: pod_mean_compressed(xs, 'pod'),
                                 mesh=mesh, in_specs=(P('pod'),),
                                 out_specs=P('pod'), check_vma=False))
        for i, g in enumerate(ring(rings[n])):
            out[f'ring{n}/out/{i}'] = np.asarray(g)
    np.savez(PATH, **out)
    print('OK')
"""


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    """The JAX package's rounds and rings, from a subprocess started with
    the file's first test -> (a function that returns its inputs once
    written, a function that waits for its results)."""
    tmp = tmp_path_factory.mktemp("dist")
    path, early = tmp / "jax_dist.npz", tmp / "jax_inputs.npz"
    code = JAX_DIST.replace("PATH", repr(str(path))).replace(
        "EARLY", repr(str(early))).replace("ROUNDS", repr(ROUNDS)).replace(
        "RINGS", repr(RINGS))
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


@pytest.fixture(scope="module")
def worlds(jax_ref, tmp_path_factory):
    """One spawn a world size (2, 3 and 4 ranks on the CPU), each running
    its rounds, rings, refusals and trainer runs, started as soon as the
    JAX side has written its inputs -> {world: [per rank]}."""
    inputs = jax_ref[0]()
    ckpt = tmp_path_factory.mktemp("dist_ckpt") / "ckpt"
    batch = {k: inputs[k].astype(np.int32) for k in ("tokens", "labels")}
    init = [inputs[f"init/{i}"] for i in range(sum(
        k.startswith("init/") for k in inputs.files))]
    rings = {n: [(f"ring{n}", [inputs[f"ring{n}/in/{i}"]
                               for i in range(4)])] for n in RINGS}
    train = {w: [(name, shape, dict(hierarchy=h, compress=c), None)
                 for name, shape, h, c in ROUNDS
                 if int(np.prod(shape)) == w] for w in (2, 4)}
    train[4] += [("h411_skip", (4, 1, 1),
                  dict(hierarchy="hierarchical", compress="int8"),
                  "hop_skipped"),
                 ("h221_int8_lazy", (2, 2, 1),
                  dict(hierarchy="hierarchical", compress="int8",
                       timing="lazy"), None)]
    # worlds 2 and 3 cut the wire's pieces to 4 kB, so that every
    # tensor crosses in several pieces, some in flight at once
    plans = {
        2: {"train": (train[2], init, batch), "refusals": True,
            "trainer": [((2, 1, 1), [], None, True)], "stage_bytes": 4096},
        3: {"ring": rings[3], "stage_bytes": 4096},
        4: {"train": (train[4], init, batch), "ring": rings[4],
            "refusals": True,
            "trainer": [((2, 2, 1), [batch, batch], str(ckpt), False)]}}
    out = {w: spawn_ranks(ranks.run_plan, w, plan, device="cpu",
                          timeout_s=TIMEOUT_S)
           for w, plan in plans.items()}
    out["init"], out["batch"], out["ckpt"] = init, batch, ckpt
    out["ring_inputs"] = {n: rings[n][0][1] for n in RINGS}
    return out


def _bits_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _steps(case, worlds):
    """Per element, the largest quantization step of its block over the
    pods' deltas of ``case`` (the port, in one process)."""
    _, shape, hier, comp = next(r for r in ROUNDS if r[0] == case)
    cfg = ARCHS["llama3.2-3b"].reduced(dtype="float32")
    mesh = make_debug_mesh((shape[0], 1, 1), AXES)
    agg = AggregationConfig(hierarchy=hier, compress=comp,
                            num_microbatches=2)
    _, model = build_train_step(cfg, mesh, agg)
    _, treedef = tree_flatten(model.init(0, device="cpu"))
    params = tree_unflatten(treedef, [torch.from_numpy(a)
                                      for a in worlds["init"]])
    batch = {k: torch.from_numpy(v) for k, v in worlds["batch"].items()}
    return _pod_steps(model, params, batch, agg, shape[0])


@pytest.mark.parametrize("case,shape,hier,comp", ROUNDS,
                         ids=[r[0] for r in ROUNDS])
def test_ranks_match_the_jax_round(case, shape, hier, comp, worlds,
                                   jax_ref):
    ref = jax_ref[1]()
    world = int(np.prod(shape))
    per_rank = [r["train"][case] for r in worlds[world]]
    got = per_rank[0]["params"]
    for r, other in enumerate(per_rank[1:], 1):
        assert _bits_equal(got, other["params"]), f"rank {r} differs"
        assert other["metrics"] == per_rank[0]["metrics"]
    want = [ref[f"{case}/{i}"] for i in range(len(got))]
    m = per_rank[0]["metrics"]
    jm = {k: float(ref[f"{case}/m/{k}"]) for k in m}
    assert abs(m["loss"] - jm["loss"]) < 1e-5
    assert m["aggregate_weight"] == jm["aggregate_weight"] == 8 * 15 - 14
    n_updates = 2 * (shape[0] if hier == "hierarchical" else 1)
    assert m["updates_aggregated"] == jm["updates_aggregated"] == n_updates
    assert abs(m["update_norm"] / jm["update_norm"] - 1) < 1e-4
    assert per_rank[0]["step"] == 1
    if comp == "none":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
    else:
        share, worst, ok = int8_round_limit(got, want, _steps(case, worlds))
        assert ok, (share, worst)
        print(f"{case} vs JAX: {share:.2e} of elements over 1e-5, largest "
              f"{worst:.3f} of a step")
    wire = per_rank[0]["wire"]
    if hier == "hierarchical" and shape[1] > 1:
        assert wire["data_all_reduce"]["calls"] == 1
    if comp == "int8":
        assert wire["pod_hop"]["calls"] == len(got) * (shape[0] - 1)


def test_lazy_timing_across_ranks_matches_the_jax_round(worlds, jax_ref):
    """``timing="lazy"`` (every update queued, reduced at the goal) on
    (2,2,1) with the int8 hop: every rank bit-identical, and within the
    two-part limit of the JAX package's eager round (its eager and lazy
    deltas differ by rounding only, ``tests/test_fl_round.py:40``)."""
    ref = jax_ref[1]()
    per_rank = [r["train"]["h221_int8_lazy"] for r in worlds[4]]
    got = per_rank[0]["params"]
    for other in per_rank[1:]:
        assert _bits_equal(got, other["params"])
    want = [ref[f"h221_int8/{i}"] for i in range(len(got))]
    share, worst, ok = int8_round_limit(got, want, _steps("h221_int8",
                                                          worlds))
    assert ok, (share, worst)
    assert abs(per_rank[0]["metrics"]["loss"]
               - float(ref["h221_int8/m/loss"])) < 1e-5


def test_skipped_hop_reads_above_the_limit(worlds, jax_ref):
    """A ring one hop short leaves a pod out of the sum: above the
    int8 limit, and the ranks no longer agree."""
    ref = jax_ref[1]()
    per_rank = [r["train"]["h411_skip"]["params"] for r in worlds[4]]
    want = [ref[f"h411_int8/{i}"] for i in range(len(per_rank[0]))]
    share, worst, ok = int8_round_limit(per_rank[0], want,
                                        _steps("h411_int8", worlds))
    assert not ok and worst > 10, (share, worst)
    assert not _bits_equal(per_rank[0], per_rank[1])


def _ring_as_written(x):
    """The JAX ring's pod-0 value as its code reads, in IEEE fp32 with
    numpy: the JAX package's quantizer, jitted as in the ring (its scale
    is ``amax · fp32(1/127)`` under ``jit``), on each pod's block, each
    product ``q·s`` rounded, summed in the order ``d0 + d[P-1] + ... +
    d1``, divided by P, cropped."""
    n = x.shape[0]
    deq, last = [], x.shape[-1]
    quantize = jax.jit(jax_blocks, static_argnums=1)
    for p in range(n):
        q, safe, _ = quantize(jnp.asarray(x[p:p + 1]), 256)
        deq.append(np.asarray(q).astype(np.float32)
                   * np.asarray(safe)[..., None])
    acc = deq[0]
    for d in deq[:0:-1]:
        acc = acc + d
    acc = acc / np.float32(n)
    return acc.reshape(*acc.shape[:-2], -1)[..., :last]


@pytest.mark.parametrize("n_pods", RINGS)
def test_ring_is_the_jax_rings_pod0_copy_on_every_rank(n_pods, worlds,
                                                       jax_ref):
    """Every rank holds the bits of the JAX ring's pod-0 copy
    (``d0 + d[P-1] + ... + d1``) as the JAX code reads.  XLA's CPU
    backend computes it otherwise: it contracts ``acc + q·s`` into a
    fused multiply-add and divides by 3 as a product with the rounded
    reciprocal, so the JAX run's own bits lie within one ulp of the
    largest term for each of those P roundings (measured: 2 ulps at
    P = 3, 1 at P = 4)."""
    ref = jax_ref[1]()
    for i, x in enumerate(worlds["ring_inputs"][n_pods]):
        want = _ring_as_written(x)
        run = ref[f"ring{n_pods}/out/{i}"][:1]
        terms = np.abs(x).max(axis=0, keepdims=True).astype(np.float32)
        ulps = np.abs(run.astype(np.float64) - want) / np.spacing(terms)
        assert ulps.max() <= n_pods, (i, ulps.max())
        for r, res in enumerate(worlds[n_pods]):
            got = res["ring"][f"ring{n_pods}"][i]
            assert got.shape == want.shape
            assert np.array_equal(got, want), (r, i,
                                               np.abs(got - want).max())


def test_ring_differs_from_a_one_process_mean_only_by_the_int8_step(
        worlds):
    """The ring's mean lies within half a quantization step of each
    pod's leaf from the plain mean."""
    got = worlds[4][0]["ring"]["ring4"]
    for i, g in enumerate(got):
        x = worlds["ring_inputs"][4][i].astype(np.float64)
        amax = np.abs(x).max(axis=-1, keepdims=True)
        assert np.all(np.abs(g - x.mean(0, keepdims=True))
                      <= (amax / 127).max(0) / 2 + 1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case,error,text", [
    ("world", "ValueError", "one rank a coordinate"),
    ("model", "ValueError", "a d_inner of 63 does not split over 2"),
    ("moe", "ValueError", "4 patches + 15 tokens do not split over 2")])
def test_refusals_across_ranks(world, case, error, text, worlds):
    for res in worlds[world]:
        got = res["refusals"][case]
        assert got.startswith(error) and text in got, got


def test_trainer_ranks_agree_over_rounds_and_rank0_checkpoints(worlds):
    """Two rounds of ``FusedFLTrainer`` on (2,2,1): every rank's params
    and history bit-identical; only rank 0 writes checkpoints."""
    runs = [res["trainer"][0] for res in worlds[4]]
    for r, run in enumerate(runs[1:], 1):
        assert _bits_equal(runs[0]["params"], run["params"]), r
        assert run["history"] == runs[0]["history"]
    assert [run["writes_checkpoints"] for run in runs] == [True] + [False] * 3
    assert [h["round"] for h in runs[0]["history"]] == [1, 2]
    assert sorted(p.name for p in worlds["ckpt"].iterdir())


def test_trainer_refuses_ranks_that_drew_different_params(worlds):
    for res in worlds[2]:
        assert "different params" in res["trainer"][0]["refused"]


def test_a_failing_rank_fails_spawn_ranks():
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        spawn_ranks(ranks.fail_on, 2, 1, device="cpu", timeout_s=60)
