"""What each rank runs in the port's sharded-storage tests
(``tests/test_torch_fsdp.py``, ``tests/test_torch_dryrun.py``,
``tests/test_torch_gpu.py``).

The ranks are started with ``repro_torch.launch.dist.spawn_ranks``,
which pickles these functions by their import path, so they live in a
module that imports neither JAX nor the JAX package.  Each case runs
the replicated rank step and the step built with
``train_shardings``' specs from the same seed-0 params on the same
batch, and returns host data: the sharded round's whole params (rank
0), each rank's block digests, metrics, wire statistics and resident
bytes.
"""
import contextlib
import hashlib

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS
from repro_torch.fl import compression
from repro_torch.fl.compression import pod_mean_compressed
from repro_torch.fl.round import (AggregationConfig, build_decode_step,
                                  build_prefill_step, build_train_step,
                                  serve_shardings, train_shardings)
from repro_torch.fl.server import init_server_state
from repro_torch.kernels.quantize.quantize import KERNELS as Q_KERNELS
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.sharding.rules import P, gather_tree, shard_tree
from repro_torch.tree import tree_leaves

AXES = ("pod", "data", "model")
B, S = 8, 16


def cfg_of(arch):
    return ARCHS[arch].reduced(dtype="float32")


def batch_of(cfg, seed=0):
    """8 sequences of 16 tokens, some rows with extra ignored labels (the
    data ranks weigh differently); a frontend config's stub embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    labels[1, :5] = -1
    labels[6, :9] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.frontend:
        out["frontend"] = (0.02 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


def agg_of(hierarchy, compress):
    return AggregationConfig(hierarchy=hierarchy, compress=compress,
                             num_microbatches=2)


@contextlib.contextmanager
def data_counted_twice(mesh):
    """A planted fault: data rank 1's part of every gradient gathered over
    the data axis enters the sum twice (its block of the summed gradient
    then counts that shard's rows twice)."""
    wire, orig = mesh.wire, mesh.wire.all_reduce

    def faulted(tensors, group, kind, **kw):
        if kind == "data_psum" and mesh.coord("data") == 1:
            for t in tensors:
                t.mul_(2)
        return orig(tensors, group, kind, **kw)

    wire.all_reduce = faulted
    try:
        yield
    finally:
        del wire.all_reduce


@contextlib.contextmanager
def pod_deltas(mesh):
    """The replicated round's delta as it enters the pod tier's int8 hop
    (this pod's, whole), kept on the pod's first rank: the list it
    yields is filled when the hop runs."""
    kept, orig = [], compression.pod_mean_compressed

    def keep(delta, pod, *args, **kw):
        if mesh.coord("data") == 0 and mesh.coord("model") == 0:
            kept.extend(_numpy(delta))
        return orig(delta, pod, *args, **kw)

    compression.pod_mean_compressed = keep
    try:
        yield kept
    finally:
        compression.pod_mean_compressed = orig


FAULTS = {None: lambda mesh: contextlib.nullcontext(),
          "data_counted_twice": data_counted_twice}


def _numpy(tree):
    return [t.detach().cpu().float().numpy() for t in tree_leaves(tree)]


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8)
                          .cpu().numpy()).hexdigest()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def train_case(device, arch, shape, hierarchy, compress, fault=None,
               flops=False, replicated=True):
    """One sharded round of reduced fp32 ``arch`` on ``shape`` from seed-0
    params (and, with ``replicated``, the replicated round beside it)."""
    cfg = cfg_of(arch)
    mesh = make_debug_mesh(shape, AXES)
    agg = agg_of(hierarchy, compress)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_of(cfg).items()}
    step, model = build_train_step(cfg, mesh, agg)
    params = model.init(0, device=device)
    state = init_server_state("fedavg", params)
    out = {"coords": mesh.coords}
    if replicated:
        with pod_deltas(mesh) as out["pod_delta"]:
            rep, _, rep_m = step(params, state, batch)
        out["rep_metrics"] = {k: float(v) for k, v in rep_m.items()}
        if mesh.rank == 0:
            out["rep"] = _numpy(rep)
        del rep
    specs = train_shardings(model, mesh, agg)
    sstep, _ = build_train_step(cfg, mesh, agg, in_specs=specs)
    blocks = shard_tree(params, specs[0], mesh)
    sblocks = shard_tree(state, specs[1], mesh)
    out["resident"] = _nbytes(blocks) + _nbytes(sblocks)
    del params
    mesh.wire.stats.clear()
    for k in Q_KERNELS:
        k.launches = 0
    with FAULTS[fault](mesh):
        if flops:
            with FlopCounterMode(display=False) as fc:
                new, new_state, m = sstep(blocks, sblocks, batch)
            out["flops"] = float(fc.get_total_flops())
        else:
            new, new_state, m = sstep(blocks, sblocks, batch)
    out["wire"] = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                   for k, v in mesh.wire.stats.items()}
    out["launches"] = {k.name: k.launches for k in Q_KERNELS}
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["step"] = int(new_state["step"])
    out["digests"] = [_digest(t) for t in tree_leaves(new)]
    out["block_shapes"] = [tuple(t.shape) for t in tree_leaves(new)]
    whole = gather_tree(new, specs[0], mesh)
    if mesh.rank == 0:
        out["whole"] = _numpy(whole)
    return out


def serve_case(device, arch, shape, steps=2):
    """A prefill of the batch's tokens (and frontend) and ``steps``
    decode steps, fed the batch's next tokens, with the params held as
    this rank's blocks of ``serve_shardings``' specs: -> this rank's rows'
    logits."""
    cfg = cfg_of(arch)
    mesh = make_debug_mesh(shape, AXES)
    full = batch_of(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in full.items()
             if k != "labels"}
    at = mesh.coord("pod") * mesh.shape["data"] + mesh.coord("data")
    offset = cfg.frontend_tokens if cfg.frontend and not \
        cfg.encoder_layers else 0

    def serve(params, specs=None):
        prefill, _ = build_prefill_step(cfg, mesh, in_specs=specs)
        decode, _ = build_decode_step(cfg, mesh, in_specs=specs)
        logits, caches = prefill(params, batch)
        out, rows = [logits.cpu().numpy()], logits.shape[0]
        for i in range(steps):
            tok = torch.from_numpy(full["labels"][at * rows:(at + 1) * rows,
                                                  i:i + 1].clip(0))
            logits, caches = decode(params, tok.to(device), caches,
                                    offset + S + i)
            out.append(logits.cpu().numpy())
        return out

    _, model = build_prefill_step(cfg, mesh)
    params = model.init(0, device=device)
    specs = serve_shardings(model, mesh)
    return {"coords": mesh.coords, "rep_logits": serve(params),
            "logits": serve(shard_tree(params, specs, mesh), specs)}


def roundtrip_case(device, arch, shape):
    """``gather_tree(shard_tree(params))`` against ``params``, leaf by
    leaf, bit for bit -> [equal a leaf]."""
    cfg = cfg_of(arch)
    mesh = make_debug_mesh(shape, AXES)
    agg = agg_of("hierarchical" if shape[0] > 1 else "flat", "none")
    _, model = build_train_step(cfg, mesh, agg)
    params = model.init(0, device=device)
    specs = train_shardings(model, mesh, agg)[0]
    back = gather_tree(shard_tree(params, specs, mesh), specs, mesh)
    return [bool(torch.equal(a, b)) for a, b in
            zip(tree_leaves(back), tree_leaves(params))]


#: (shape, spec) of the ring case's leaves on a (2, 2, 1) mesh: rows
#: split (the blocks of every row as the whole leaf's), the last axis
#: split into a multiple of 256 (aligned), and into 150 and 500 (not)
RING_LEAVES = [((8, 512), P("data", None)), ((8, 512), P(None, "data")),
               ((6, 300), P(None, "data")), ((4, 1000), P(None, "data")),
               ((4, 1000), P("data", None))]


def ring_case(device, shape=(2, 2, 1)):
    """The pod tier on whole leaves and on this rank's blocks of the same
    leaves (each pod's its own draw) -> (the whole-leaf mean, the
    blocks' mean gathered), numpy."""
    mesh = make_debug_mesh(shape, AXES)
    g = torch.Generator().manual_seed(100 + mesh.coord("pod"))
    leaves = [1e-2 * torch.randn(s, generator=g) for s, _ in RING_LEAVES]
    specs = [spec for _, spec in RING_LEAVES]
    whole = pod_mean_compressed([l.clone() for l in leaves], "pod",
                                mesh=mesh)
    blocks = pod_mean_compressed(shard_tree(leaves, specs, mesh), "pod",
                                 mesh=mesh)
    return {"whole": _numpy(whole),
            "blocks": _numpy(gather_tree(blocks, specs, mesh)),
            "inputs": _numpy(leaves)}


def _scales(x, pieces):
    """Per element, the int8 scale of its block when ``x``'s last axis is
    cut into ``pieces`` shards, each blocked on its own."""
    out = []
    for c in torch.from_numpy(x).chunk(pieces, dim=-1):
        _, safe, last = compression._quantize_blocks_last_axis(c, 256)
        out.append(safe.repeat_interleave(min(256, last), dim=-1)
                   [..., :last].reshape(c.shape))
    return torch.cat(out, dim=-1).double().numpy()


def int8_limits(rows):
    """From a case's rows: per leaf and element, (the largest step of its
    whole-leaf block over the pods, ``s / P``; the most an int8 mean on
    this round's shard blocks can differ from one on whole-leaf blocks,
    Σ_p (s_p + s'_p) / 2P, each pod's error at most half its block's
    scale on either side), from each pod's delta as it entered the
    replicated round's int8 hop."""
    deltas = [r["pod_delta"] for r in rows if r["coords"][1:] == (0, 0)]
    rank0, n_pods = rows[0], len(deltas)
    steps, bounds = [], []
    for i, (whole, block) in enumerate(zip(rank0["whole"],
                                           rank0["block_shapes"])):
        pieces = whole.shape[-1] // block[-1] if block else 1
        per = [d[i].reshape(whole.shape) for d in deltas]
        s = [_scales(x, 1) for x in per]
        steps.append(np.max(s, axis=0) / n_pods)
        bounds.append(sum(a + _scales(x, pieces) for a, x in zip(s, per))
                      / (2 * n_pods))
    return steps, bounds


def aligned(rank0):
    """Per leaf: whether a shard keeps the whole leaf's int8 blocks (its
    last axis unsplit, or split into multiples of 256)."""
    out = []
    for whole, block in zip(rank0["whole"], rank0["block_shapes"]):
        last = whole.shape[-1] if whole.ndim else 1
        b = block[-1] if block else 1
        out.append(b == last or b % 256 == 0)
    return out


CASES = {"train": train_case, "serve": serve_case,
         "roundtrip": roundtrip_case, "ring": ring_case}


def run_plan(rank, device, plan):
    """Each ``(name, kind, kwargs)`` of ``plan`` in order -> {name:
    result}."""
    out = {}
    for name, kind, kw in plan:
        out[name] = CASES[kind](device, **kw)
    return out
