"""Dry run of one (arch × shape × mesh) cell: the counterpart of the JAX
package's ``launch/dryrun.py``.

The JAX package lowers and compiles the cell's step against abstract
inputs on 512 placeholder devices and reads XLA's memory and cost
analyses.  The port has no compiler to ask; it runs rank 0's step of
the cell's mesh on the CPU under ``FakeTensorMode``, so nothing is
computed or allocated:

* the mesh is ``launch/mesh.py::make_production_mesh`` (or any
  ``stand_in_mesh``): rank 0's coordinates, stand-in groups and a
  recording wire (``analysis/collectives.py``) that counts each
  collective as ``Wire`` does and moves nothing; no process group, no
  card and no pinned staging is touched, and no ``XLA_FLAGS`` is set;
* the params and server state are rank 0's blocks of the cell's specs
  (``fl/round.py::train_shardings`` / ``serve_shardings``), fed to the
  step built with them as ``in_specs``, exactly as a real rank holds
  them; the kernels take their plain versions (the tensors are on the
  CPU);
* ``analysis/op_cost.py`` counts the step's FLOPs
  (``FlopCounterMode``), the bytes its aten ops move, and the bytes its
  storages hold while they live.

The record keeps the JAX keys.  ``memory``: ``argument_size_in_bytes``
is what the JAX compile reports, every input's block under its spec
(the batch and, at decode, the caches included); ``resident_bytes``
the params and server state a rank holds between steps;
``output_size_in_bytes`` the bytes the step returns that it made;
``temp_size_in_bytes`` the rest of its allocations at their peak; and
``peak_bytes_per_device`` what the rank is fed (blocks, the whole
batch, at decode its caches) plus that peak.  ``cost`` and ``roofline``
are per rank, with the H100's ceilings (``analysis/roofline.py``);
``collectives`` the recorded traffic by kind, by axes and by tier, and
``wire`` as ``Wire.stats`` would read.  ``compile_s`` is the trace's
wall (the column ``analysis/report.py`` reads).  The port's decode
holds its caches whole over the model axis (``fl/round.py``), so there
the fed bytes exceed the JAX argument's cache blocks.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch llama3.2-3b --shape train_4k --mesh multi \\
      [--hierarchy hierarchical|flat] [--timing eager|lazy]
      [--compress none|int8] [--micro 4] [--fsdp auto|data|pod,data|]
      [--out results/dryrun_torch]
"""
import argparse
import dataclasses
import json
import time
from math import prod
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.collectives import recorded_stats
from repro_torch.analysis.op_cost import step_cost
from repro_torch.analysis.roofline import from_counts
from repro_torch.configs import get_arch, get_shape, shape_applicable
from repro_torch.fl.round import (AggregationConfig, abstract_caches,
                                  abstract_params, build_decode_step,
                                  build_prefill_step, build_train_step,
                                  input_specs, serve_options, serve_rows,
                                  serve_shardings, train_options,
                                  train_shardings)
from repro_torch.fl.server import init_server_state
from repro_torch.launch.mesh import dp_axes as mesh_dp_axes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding.rules import (P, batch_specs, block_bytes,
                                        cache_specs, divisibility_fix,
                                        shard_tree)
from repro_torch.tree import tree_leaves, tree_map

#: ``--fsdp auto`` shards params over the batch axes only when TP-only
#: residency (bf16 params + bf16 grads + the fp32 accumulator, about 8
#: bytes a param over the model axis) would pass this: the JAX rule's
#: 6e9 of a 16 GB TPU, the same 37.5 % share of the H100's 80 GB, which
#: leaves the rest for activations, the remat recompute and the int8 hop
FSDP_AUTO_BYTES = 0.375 * 80e9


def auto_fsdp(cfg, mesh, hierarchy: str):
    """The axes ``--fsdp auto`` shards params over (the JAX rule)."""
    tp_only_bytes = cfg.param_count() * 8 / mesh.shape["model"]
    if tp_only_bytes <= FSDP_AUTO_BYTES:
        return ()
    return mesh_dp_axes(mesh) if hierarchy == "flat" else ("data",)


def _fake(tree):
    """CPU tensors of the tree's shapes and dtypes: fake ones under the
    mode."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def dry_run_cell(cfg, shape, mesh, agg=None, *, fsdp=(), opts=None):
    """Rank ``mesh``'s step of one cell under fake tensors (module
    docstring).  ``mesh``: a stand-in mesh; ``agg``: the train step's
    aggregation; ``fsdp``: the axes params are split over besides
    ``model``.  -> {"memory", "cost", "collectives", "wire",
    "roofline", "trace_s"}."""
    dp = mesh_dp_axes(mesh)
    t0 = time.perf_counter()
    abatch = input_specs(cfg, shape)
    if shape.kind == "train":
        model = build_model(cfg, opts or train_options(cfg, mesh, agg))
        pspecs, sspecs = train_shardings(model, mesh, agg, fsdp=fsdp)
        step, model = build_train_step(cfg, mesh, agg, opts,
                                       in_specs=(pspecs, sspecs))
        aparams = abstract_params(model)
        astate = init_server_state(agg.server_opt, aparams)
        bspecs = divisibility_fix(batch_specs(abatch, dp), abatch, mesh)
        args, specs = (aparams, astate, abatch), (pspecs, sspecs, bspecs)
        resident = [(aparams, pspecs), (astate, sspecs)]
        fed = (shard_tree(aparams, pspecs, mesh),
               shard_tree(astate, sspecs, mesh), abatch)
    elif shape.kind == "prefill":
        model = build_model(cfg, opts or serve_options(cfg, mesh))
        pspecs = serve_shardings(model, mesh, fsdp=fsdp)
        step, model = build_prefill_step(cfg, mesh, opts, in_specs=pspecs)
        aparams = abstract_params(model)
        bspecs = divisibility_fix(batch_specs(abatch, dp), abatch, mesh)
        args, specs = (aparams, abatch), (pspecs, bspecs)
        resident = [(aparams, pspecs)]
        fed = (shard_tree(aparams, pspecs, mesh), abatch)
    else:  # decode
        model = build_model(cfg, opts or serve_options(cfg, mesh, False))
        pspecs = serve_shardings(model, mesh, fsdp=fsdp)
        step, model = build_decode_step(cfg, mesh, opts, in_specs=pspecs)
        aparams = abstract_params(model)
        acaches = abstract_caches(model, shape)
        cspecs = divisibility_fix(cache_specs(acaches, dp), acaches, mesh)
        B = shape.global_batch
        split = B % prod(mesh.shape[a] for a in dp) == 0
        tok_spec = P(dp, None) if split else P()
        args = (aparams, abatch["tokens"], acaches, abatch["pos"])
        specs = (pspecs, tok_spec, cspecs, P())
        tokens = serve_rows(abatch["tokens"], mesh) if split \
            else abatch["tokens"]
        rank_caches = model.init_decode(tokens.shape[0], shape.seq_len,
                                        device="meta")
        resident = [(aparams, pspecs)]
        fed = (shard_tree(aparams, pspecs, mesh), tokens, rank_caches)

    argument = sum(block_bytes(a, s, mesh) for a, s in zip(args, specs))
    fed_bytes = _nbytes(fed)
    tail = (shape.seq_len - 1,) if shape.kind == "decode" else ()
    with FakeTensorMode():
        _, cost = step_cost(step, *_fake(fed), *tail)
    coll = recorded_stats(mesh.wire)
    peak = fed_bytes + cost.peak_bytes
    memory = {
        "argument_size_in_bytes": argument,
        "output_size_in_bytes": cost.output_bytes,
        "temp_size_in_bytes": cost.peak_bytes - cost.output_bytes,
        "resident_bytes": sum(block_bytes(a, s, mesh) for a, s in resident),
        "fed_bytes": fed_bytes,
        "peak_bytes_per_device": peak,
    }
    roof = from_counts(cost, coll, prod(mesh.sizes), cfg, shape)
    return {
        "memory": memory,
        "cost": {**cost.to_dict(), "coll_total": coll.total_bytes,
                 "coll_dcn": coll.dcn_bytes, "coll_by_kind": coll.by_kind,
                 "coll_count": coll.by_kind_count},
        "collectives": coll.to_dict(),
        "wire": {k: {"calls": v["calls"], "bytes": v["bytes"]}
                 for k, v in mesh.wire.stats.items()},
        "roofline": roof.to_dict(),
        "trace_s": time.perf_counter() - t0,
    }


def run_cell(
    arch_name: str,
    shape_name: str,
    mesh_kind: str,
    *,
    hierarchy: str = "hierarchical",
    timing: str = "eager",
    compress: str = "none",
    micro: int = 4,
    fsdp: str = "auto",
    acc_dtype: str = "float32",
    opts_override: dict | None = None,
    verbose: bool = True,
):
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    record = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
        "hierarchy": hierarchy, "timing": timing, "compress": compress,
        "micro": micro,
    }
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        return record

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    agg = AggregationConfig(
        hierarchy=hierarchy, timing=timing, compress=compress,
        num_microbatches=micro, acc_dtype=acc_dtype,
    )
    if fsdp == "auto":
        fsdp_axes = auto_fsdp(cfg, mesh, hierarchy)
    else:
        fsdp_axes = tuple(a for a in fsdp.split(",") if a)

    opts = None
    if opts_override:
        base = (train_options(cfg, mesh, agg) if shape.kind == "train"
                else serve_options(cfg, mesh, shape.kind == "prefill"))
        opts = dataclasses.replace(base, **opts_override)

    cell = dry_run_cell(cfg, shape, mesh, agg, fsdp=fsdp_axes, opts=opts)
    record.update(
        status="ok",
        chips=prod(mesh.sizes),
        fsdp=list(fsdp_axes),
        acc_dtype=acc_dtype,
        opts_override=opts_override or {},
        compile_s=round(cell["trace_s"], 2),
        memory=cell["memory"],
        cost=cell["cost"],
        collectives=cell["collectives"],
        wire=cell["wire"],
        roofline=cell["roofline"],
    )
    if verbose:
        mem, c, r = cell["memory"], cell["cost"], cell["roofline"]
        print(f"== {arch_name} × {shape_name} × {mesh_kind} "
              f"({hierarchy}/{timing}/{compress}) ==")
        print(f"memory_analysis: {mem}")
        print(f"cost(per-rank, op by op): flops={c['flops']:.3e} "
              f"bytes={c['bytes']:.3e} coll={c['coll_total']:.3e} "
              f"dcn={c['coll_dcn']:.3e}")
        print(f"trace: {cell['trace_s']:.2f} s, {c['aten_ops']} aten ops")
        print(f"roofline: compute={r['compute_s']:.4f}s "
              f"memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s dominant={r['dominant']} "
              f"useful={r['useful_ratio']:.3f} "
              f"frac={r['roofline_fraction']:.3f}")
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--hierarchy", choices=("hierarchical", "flat"),
                    default="hierarchical")
    ap.add_argument("--timing", choices=("eager", "lazy"), default="eager")
    ap.add_argument("--compress", choices=("none", "int8"), default="none")
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--fsdp", default="auto")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    rec = run_cell(
        args.arch, args.shape, args.mesh,
        hierarchy=args.hierarchy, timing=args.timing,
        compress=args.compress, micro=args.micro, fsdp=args.fsdp,
    )
    if args.out:
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        tag = (f"{args.arch}_{args.shape}_{args.mesh}_{args.hierarchy}"
               f"_{args.timing}_{args.compress}")
        (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        print(f"wrote {outdir / (tag + '.json')}")


if __name__ == "__main__":
    main()
