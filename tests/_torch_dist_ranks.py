"""What each rank runs in the port's distributed tests
(``tests/test_torch_dist_round.py``, ``tests/test_torch_gpu.py``).

The ranks are started with ``repro_torch.launch.dist.spawn_ranks``,
which pickles these functions by their import path, so they live in a
module that imports neither JAX nor the JAX package: every rank imports
it.  Each returns host data (numpy arrays, floats, strings).
"""
import contextlib

import torch

from _torch_model_ranks import ragged_ssm_cfg, step_on
from repro_torch.configs import ARCHS
from repro_torch.fl import compression
from repro_torch.fl.round import AggregationConfig, build_train_step
from repro_torch.fl.server import init_server_state
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.runtime import FusedFLTrainer
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

AXES = ("pod", "data", "model")
ARCH = "llama3.2-3b"


def _cfg():
    return ARCHS[ARCH].reduced(dtype="float32")


@contextlib.contextmanager
def hop_skipped():
    """A planted fault: the ring runs one hop short, so the pod that the
    last hop would bring never reaches the sum."""
    orig = compression._ring_gather

    def short(q, scales, mesh, pod_axis, hops):
        return orig(q, scales, mesh, pod_axis, hops=hops - 1)

    compression._ring_gather = short
    try:
        yield
    finally:
        compression._ring_gather = orig


FAULTS = {None: contextlib.nullcontext, "hop_skipped": hop_skipped}


def train_cases(rank, device, cases, init, batch):
    """One step of reduced fp32 llama3.2-3b from the params ``init`` (the
    leaves in JAX order, numpy) on ``batch`` for each case ``(name,
    shape, aggregation kwargs, fault)``; -> {name: {"params", "metrics",
    "wire"}}."""
    cfg = _cfg()
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out = {}
    for name, shape, agg_kw, fault in cases:
        mesh = make_debug_mesh(shape, AXES)
        agg = AggregationConfig(num_microbatches=2, **agg_kw)
        step, model = build_train_step(cfg, mesh, agg)
        _, treedef = tree_flatten(model.init(0, device=device))
        params = tree_unflatten(treedef, [torch.from_numpy(a).to(device)
                                          for a in init])
        with FAULTS[fault]():
            new, state, m = step(params, init_server_state("fedavg", params),
                                 tb)
        out[name] = {
            "params": [t.cpu().numpy() for t in tree_leaves(new)],
            "metrics": {k: float(v) for k, v in m.items()},
            "step": int(state["step"]),
            "wire": {k: dict(v) for k, v in mesh.wire.stats.items()}}
    return out


def ring_cases(rank, device, cases):
    """``pod_mean_compressed`` over a ``(P,)`` pod mesh for each case
    ``(name, leaves)``, every leaf with a leading axis of P: this rank
    takes its pod's block (leading axis 1, as a ``shard_map`` over the
    pod axis hands it over); -> {name: the mean's leaves, numpy}."""
    out = {}
    for name, leaves in cases:
        mesh = make_debug_mesh((leaves[0].shape[0],), ("pod",))
        p = mesh.coord("pod")
        mine = {f"l{i}": torch.from_numpy(x[p:p + 1]).to(device)
                for i, x in enumerate(leaves)}
        got = compression.pod_mean_compressed(mine, "pod", mesh=mesh)
        out[name] = [got[f"l{i}"].cpu().numpy() for i in range(len(leaves))]
    return out


def refusals(rank, device):
    """What a mesh over ranks refuses; -> {case: the error's text}:
    "model" is an SSM config whose d_inner does not split over a model
    axis of 2, "moe" a frontend config whose patches and tokens do not
    split there."""
    world = torch.distributed.get_world_size()
    out = {}
    for case, make in {
            "world": lambda: make_debug_mesh((world * 2, 1, 1), AXES),
            "model": lambda: step_on(
                ragged_ssm_cfg("falcon-mamba-7b"),
                make_debug_mesh((world // 2, 1, 2), AXES)),
            "moe": lambda: step_on(
                ARCHS["internvl2-26b"].reduced(dtype="float32"),
                make_debug_mesh((world // 2, 1, 2), AXES),
                tokens=15)}.items():
        try:
            make()
        except (ValueError, NotImplementedError) as e:
            out[case] = f"{type(e).__name__}: {e}"
    return out


def trainer_rounds(rank, device, shape, batches, ckpt_dir, seed_by_rank):
    """``FusedFLTrainer`` on a mesh over ranks: ``init`` (each rank from
    seed ``rank`` when ``seed_by_rank``, which must be refused), then a
    round for each batch, checkpointing every round into ``ckpt_dir``;
    -> {"refused": the refusal, or "history", "params" and
    "writes_checkpoints"}."""
    t = FusedFLTrainer(_cfg(), make_debug_mesh(shape, AXES),
                       AggregationConfig(compress="int8",
                                         num_microbatches=2),
                       device=device, checkpoint_dir=ckpt_dir,
                       checkpoint_every=1)
    try:
        t.init(seed=rank if seed_by_rank else 0)
    except RuntimeError as e:
        return {"refused": str(e)}
    for b in batches:
        t.train_round(b)
    if t.ckpt is not None:
        t.ckpt.wait()
    return {"history": t.history,
            "params": [p.cpu().numpy() for p in tree_leaves(t.params)],
            "writes_checkpoints": t.ckpt is not None}


def fail_on(rank, device, bad):
    """Raise on rank ``bad``; the others wait at a barrier that the
    failing rank never reaches."""
    if rank == bad:
        raise ValueError(f"planted failure on rank {rank}")
    torch.distributed.barrier()


def run_plan(rank, device, plan):
    """Each part of ``plan`` in turn, in one process group: "train"
    (``train_cases``' cases, init, batch), "ring" (``ring_cases``'
    cases), "refusals" (True) and "trainer" (``trainer_rounds``'
    arguments after the device, as a list of runs), the wire's pieces
    cut to "stage_bytes" where given; -> {part: result}."""
    if "stage_bytes" in plan:
        dist.STAGE_BYTES = plan["stage_bytes"]
    out = {}
    if "train" in plan:
        out["train"] = train_cases(rank, device, *plan["train"])
    if "ring" in plan:
        out["ring"] = ring_cases(rank, device, plan["ring"])
    if plan.get("refusals"):
        out["refusals"] = refusals(rank, device)
    if "trainer" in plan:
        out["trainer"] = [trainer_rounds(rank, device, *a)
                          for a in plan["trainer"]]
    return out


def ring_on_card(rank, device, n):
    """Two ranks on the card: ``pod_mean_compressed`` of a leaf of ``n``
    random values a pod (seed = pod) and ``pod_mean`` of the same; ->
    (both results, numpy, and the launches of the quantize kernels)."""
    from repro_torch.kernels.quantize.quantize import DEQUANTIZE, QUANTIZE

    mesh = make_debug_mesh((2,), ("pod",))
    g = torch.Generator(device=device).manual_seed(mesh.coord("pod"))
    x = torch.randn(3, n, generator=g, device=device)
    n0 = (QUANTIZE.launches, DEQUANTIZE.launches)
    got = compression.pod_mean_compressed({"x": x}, "pod", mesh=mesh)["x"]
    launches = (QUANTIZE.launches - n0[0], DEQUANTIZE.launches - n0[1])
    mean = compression.pod_mean({"x": x.clone()}, "pod", mesh=mesh)["x"]
    return got.cpu().numpy(), mean.cpu().numpy(), launches, str(got.device)
