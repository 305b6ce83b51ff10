"""The port's dry run (``launch/dryrun.py``): rank 0's step of a cell
under fake tensors on a stand-in mesh, held against

* the JAX package's compile of the same cells: its
  ``memory_analysis().argument_size_in_bytes`` on 8 forced host devices
  (one subprocess, started with the file's first test) — the mini cell
  of ``tests/test_multidevice.py`` (reduced gemma3-4b, 8 × 64 tokens, 2
  microbatches, (2,2,2); 55044 bytes under jax 0.9.0), and a reduced
  prefill and decode cell, caches included — exactly;
* real 2- and 4-rank gloo runs of the same cells on the CPU: every
  rank's wire bytes and calls by kind, its resident bytes, exactly, and
  its FLOPs against ``FlopCounterMode`` over the real rank's step,
  exactly;

and the roofline's terms with the H100's ceilings, ``report.py`` on
port records, the sweep's resumability and the stand-in groups.
"""
import json

import pytest
import torch

import _torch_fsdp_ranks as ranks
from repro_torch.analysis import report
from repro_torch.analysis.collectives import NODE_RANKS
from repro_torch.analysis.roofline import (HBM_BW, NIC_BW, NVLINK_BW,
                                           PEAK_FLOPS, Roofline, model_flops)
from repro_torch.configs import ARCHS, ShapeConfig, get_arch, get_shape
from repro_torch.fl.round import AggregationConfig
from repro_torch.launch import dryrun, sweep
from repro_torch.launch.dist import spawn_ranks
from repro_torch.launch.mesh import make_production_mesh, stand_in_mesh
from test_torch_fused_round import ForcedRun

torch.set_num_threads(2)

AXES = ("pod", "data", "model")
MINI = ("gemma3-4b", (2, 2, 2))
MINI_CELLS = {"train": ShapeConfig("t", 64, 8, "train"),
              "prefill": ShapeConfig("p", 64, 8, "prefill"),
              "decode": ShapeConfig("d", 64, 8, "decode")}
#: (case, arch, mesh, hierarchy, compress) run for real and dry
REAL = {2: [("llama_h121_none", "llama3.2-3b", (1, 2, 1), "hierarchical",
             "none")],
        4: [("llama_h221_int8", "llama3.2-3b", (2, 2, 1), "hierarchical",
             "int8"),
            ("deepseek_f122_none", "deepseek-v2-lite-16b", (1, 2, 2),
             "flat", "none")]}

JAX_ARGS = """
    import json
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import use_mesh
    from repro.configs import ARCHS, ShapeConfig
    from repro.fl.round import (AggregationConfig, abstract_caches,
        abstract_params, build_decode_step, build_prefill_step,
        build_train_step, input_specs, serve_shardings, train_shardings)
    from repro.fl.server import init_server_state
    from repro.launch.mesh import make_debug_mesh, dp_axes
    from repro.sharding import (batch_specs, cache_specs, divisibility_fix,
                                to_named)

    mesh = make_debug_mesh(MINI_MESH, ('pod', 'data', 'model'))
    cfg = ARCHS[MINI_ARCH].reduced()
    dp = dp_axes(mesh)
    out = {}
    with use_mesh(mesh):
        agg = AggregationConfig(num_microbatches=2)
        step, model = build_train_step(cfg, mesh, agg)
        ap = abstract_params(model)
        ps, ss = train_shardings(model, mesh, agg)
        ast = init_server_state('fedavg', ap)
        ab = input_specs(cfg, ShapeConfig('t', 64, 8, 'train'))
        bs = divisibility_fix(batch_specs(ab, dp), ab, mesh)
        fn = jax.jit(step, in_shardings=(to_named(ps, mesh),
                     to_named(ss, mesh), to_named(bs, mesh)),
                     out_shardings=(to_named(ps, mesh), to_named(ss, mesh),
                                    None), donate_argnums=(0, 1))
        c = fn.lower(ap, ast, ab).compile()
        out['train'] = c.memory_analysis().argument_size_in_bytes

        shape = ShapeConfig('p', 64, 8, 'prefill')
        step, model = build_prefill_step(cfg, mesh)
        ps = serve_shardings(model, mesh, fsdp=('data',))
        ab = input_specs(cfg, shape)
        bs = divisibility_fix(batch_specs(ab, dp), ab, mesh)
        ac = abstract_caches(model, shape)
        cs = divisibility_fix(cache_specs(ac, dp), ac, mesh)
        fn = jax.jit(step, in_shardings=(to_named(ps, mesh),
                     to_named(bs, mesh)), out_shardings=(None,
                     to_named(cs, mesh)))
        c = fn.lower(ap, ab).compile()
        out['prefill'] = c.memory_analysis().argument_size_in_bytes

        shape = ShapeConfig('d', 64, 8, 'decode')
        step, model = build_decode_step(cfg, mesh)
        inp = input_specs(cfg, shape)
        ac = abstract_caches(model, shape)
        cs = divisibility_fix(cache_specs(ac, dp), ac, mesh)
        fn = jax.jit(step, in_shardings=(to_named(ps, mesh),
                     NamedSharding(mesh, P(dp, None)), to_named(cs, mesh),
                     NamedSharding(mesh, P())),
                     out_shardings=(None, to_named(cs, mesh)),
                     donate_argnums=(2,))
        c = fn.lower(ap, inp['tokens'], ac, inp['pos']).compile()
        out['decode'] = c.memory_analysis().argument_size_in_bytes
    print('ARGS', json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_args():
    """The JAX compile's argument bytes of the mini cells, from a
    subprocess started with the file's first test."""
    run = ForcedRun(JAX_ARGS.replace("MINI_MESH", repr(MINI[1])).replace(
        "MINI_ARCH", repr(MINI[0])), ndev=8)

    def results():
        line = [l for l in run.stdout().splitlines()
                if l.startswith("ARGS ")][0]
        return json.loads(line[5:])

    yield results
    run.close()


@pytest.fixture(scope="module")
def real():
    """The REAL cells on gloo CPU ranks, each rank's step under
    ``FlopCounterMode`` -> {case: [per rank]}."""
    out = {}
    for w, cases in REAL.items():
        plan = [(name, "train", dict(arch=a, shape=s, hierarchy=h,
                                     compress=c, flops=True,
                                     replicated=False))
                for name, a, s, h, c in cases]
        for rank, rows in enumerate(spawn_ranks(ranks.run_plan, w, plan,
                                                device="cpu",
                                                timeout_s=300)):
            for name, row in rows.items():
                out.setdefault(name, []).append(row)
    return out


@pytest.mark.parametrize("kind", list(MINI_CELLS))
def test_argument_bytes_equal_the_jax_compiles(kind, jax_args):
    arch, shape = MINI
    cell = dryrun.dry_run_cell(
        ARCHS[arch].reduced(), MINI_CELLS[kind], stand_in_mesh(shape, AXES),
        AggregationConfig(num_microbatches=2), fsdp=("data",))
    got = cell["memory"]["argument_size_in_bytes"]
    assert got == jax_args()[kind]
    if kind == "train":
        assert got == 55044     # the JAX compile under jax 0.9.0


def _dry(name, rank):
    for cases in REAL.values():
        for case, arch, shape, hier, comp in cases:
            if case == name:
                fsdp = ("data",) if hier == "hierarchical" else \
                    ("pod", "data")
                return dryrun.dry_run_cell(
                    ranks.cfg_of(arch), ShapeConfig("t", ranks.S, ranks.B,
                                                    "train"),
                    stand_in_mesh(shape, AXES, rank),
                    ranks.agg_of(hier, comp), fsdp=fsdp)


@pytest.mark.parametrize("name,rank", [(c[0], r) for w, cases in REAL.items()
                                       for c in cases for r in range(w)])
def test_dry_run_predicts_a_real_ranks_wire_memory_and_flops(name, rank,
                                                             real):
    cell, row = _dry(name, rank), real[name][rank]
    assert cell["wire"] == row["wire"]
    assert cell["memory"]["resident_bytes"] == row["resident"]
    assert cell["cost"]["flops"] == row["flops"] > 0
    assert cell["collectives"]["total_bytes"] == sum(
        v["bytes"] for v in row["wire"].values())


def test_roofline_terms_and_dominance():
    r = Roofline(flops=PEAK_FLOPS, hbm_bytes=HBM_BW * 2,
                 coll_bytes=NVLINK_BW * 0.5, dcn_bytes=0, chips=256,
                 model_flops_=PEAK_FLOPS * 256 * 0.5)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.dominant == "memory"
    assert r.roofline_fraction == pytest.approx(0.25)
    # a NIC part is charged at the NIC rate, the rest at NVLink's
    n = Roofline(flops=0, hbm_bytes=0, coll_bytes=NVLINK_BW + NIC_BW,
                 dcn_bytes=NIC_BW, chips=1, model_flops_=0,
                 nic_bytes=NIC_BW)
    assert n.collective_s == pytest.approx(2.0)
    assert n.dcn_s == pytest.approx(1.0)
    assert n.dominant == "collective"


def test_model_flops_conventions():
    llama = get_arch("llama3.2-3b")
    t = get_shape("train_4k")
    assert model_flops(llama, t) == pytest.approx(
        6.0 * llama.active_param_count() * t.global_batch * t.seq_len)
    kimi = get_arch("kimi-k2-1t-a32b")
    # MoE uses ACTIVE params
    assert model_flops(kimi, t) < \
        6.0 * kimi.param_count() * t.global_batch * t.seq_len / 10
    d = get_shape("decode_32k")
    assert model_flops(llama, d) == pytest.approx(
        2.0 * llama.active_param_count() * d.global_batch)


def test_stand_in_groups_are_none_where_a_real_meshs_are():
    """A group for every set of axes of more than one rank, with the
    members a process group of a real mesh would hold; None for a set of
    one rank; the node tier by 8 consecutive ranks."""
    mesh = make_production_mesh(multi_pod=True, rank=300)
    assert mesh.coords == (1, 2, 12) and mesh.distributed
    assert mesh.group("model").members == tuple(range(288, 304))
    assert mesh.group("pod").members == (44, 300)
    assert mesh.group("pod").crosses_pods
    assert not mesh.group("model").crosses_pods
    assert mesh.group("data").size == 16 and mesh.group("data").leaves_node
    assert len(mesh.groups) == 7
    small = stand_in_mesh((1, 2, 2), AXES, 3)
    assert small.group("pod") is None
    assert small.group("pod", "data").members == \
        small.group("data").members == (1, 3)
    assert not small.group("data", "model").leaves_node
    assert NODE_RANKS == 8


def _record(tmp, arch, shape_name, kind, monkeypatch):
    """One run_cell record of a reduced config on the (16,16) production
    mesh, the cell cut to 64 sequences of 32 tokens."""
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda n: ARCHS[n].reduced())
    monkeypatch.setattr(dryrun, "get_shape",
                        lambda n: ShapeConfig(n, 32, 64, kind))
    rec = dryrun.run_cell(arch, shape_name, "single", verbose=False)
    (tmp / f"{arch}_{shape_name}.json").write_text(json.dumps(rec))
    return rec


def test_report_renders_port_records(tmp_path, monkeypatch):
    rec = _record(tmp_path, "llama3.2-3b", "train_4k", "train", monkeypatch)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["roofline"]["ceilings"]["hbm_bw"] == HBM_BW
    _record(tmp_path, "llama3.2-3b", "decode_32k", "decode", monkeypatch)
    recs = report.load(tmp_path)
    table = "\n".join(report.dryrun_table(recs, "single"))
    assert "| llama3.2-3b | train_4k | ok |" in table
    assert "| llama3.2-3b | decode_32k | ok |" in table
    roof = "\n".join(report.roofline_table(recs, "single"))
    assert roof.count("| llama3.2-3b |") == 4 and "**" in roof
    assert "2 cells ok on single" in report.summary(recs, "single")[0]


def test_sweep_skips_a_cell_whose_record_reads_ok(tmp_path, monkeypatch,
                                                  capsys):
    ran = []

    def fake_run_cell(arch, shape, mesh, **kw):
        ran.append((arch, shape, mesh))
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "skipped", "reason": "test"}

    monkeypatch.setattr(sweep, "run_cell", fake_run_cell)
    tag = sweep.tag_for("llama3.2-3b", "train_4k", "single",
                        "hierarchical", "eager", "none")
    (tmp_path / f"{tag}.json").write_text(json.dumps({"status": "ok"}))
    err = sweep.tag_for("llama3.2-3b", "decode_32k", "single",
                        "hierarchical", "eager", "none")
    (tmp_path / f"{err}.json").write_text(json.dumps({"status": "error"}))
    sweep.main(["--arch", "llama3.2-3b", "--shape", "train_4k,decode_32k",
                "--mesh", "single", "--out", str(tmp_path)])
    assert ran == [("llama3.2-3b", "decode_32k", "single")]
    assert "ok=0 skipped/cached=1 err=0" in capsys.readouterr().out
    assert json.loads((tmp_path / f"{err}.json").read_text())["status"] \
        == "skipped"


def test_auto_fsdp_keeps_the_jax_rule_at_80_gb():
    """FSDP over the batch axes only where TP-only residency (8 bytes a
    param over the model axis) passes 37.5 % of the H100's 80 GB."""
    single, multi = make_production_mesh(), \
        make_production_mesh(multi_pod=True)
    assert dryrun.FSDP_AUTO_BYTES == 30e9
    assert dryrun.auto_fsdp(get_arch("llama3.2-3b"), single,
                            "hierarchical") == ()
    kimi = get_arch("kimi-k2-1t-a32b")
    assert dryrun.auto_fsdp(kimi, single, "hierarchical") == ("data",)
    assert dryrun.auto_fsdp(kimi, multi, "flat") == ("pod", "data")


def test_production_cell_traces_at_full_width(monkeypatch):
    """llama3.2-3b × train_4k × multi, rank 0 of 512, at full width cut
    to 2 layers (the whole cell is ``python -m repro_torch.launch.dryrun
    --arch llama3.2-3b --shape train_4k --mesh multi``): the record's
    keys, the batch block beside the resident blocks, TP storage over
    the model axis of 16, the pod hop as the only pod-crossing bytes,
    and a roofline of the record's own counts."""
    import dataclasses
    monkeypatch.setattr(dryrun, "get_arch", lambda n: dataclasses.replace(
        ARCHS[n], num_layers=2))
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", "multi", verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["fsdp"] == []                   # 8 bytes a param fit 30 GB
    mem = rec["memory"]
    # a rank's rows of tokens and labels: 256 / (2 pods x 16) x 4096 int32
    assert mem["argument_size_in_bytes"] - mem["resident_bytes"] == \
        2 * 8 * 4096 * 4
    replica = 2 * dataclasses.replace(ARCHS["llama3.2-3b"],
                                      num_layers=2).param_count()
    assert replica / 16 < mem["resident_bytes"] < replica / 16 * 1.001
    assert mem["peak_bytes_per_device"] > mem["argument_size_in_bytes"]
    coll = rec["collectives"]
    assert coll["dcn_bytes"] == coll["by_kind"]["pod_all_reduce"] > 0
    # a model group of 16 spans two nodes of 8: every byte at the NIC rate
    assert coll["nvlink_bytes"] == 0
    assert coll["nic_bytes"] == coll["total_bytes"] == rec["cost"][
        "coll_total"]
    roof = rec["roofline"]
    assert roof["flops"] == rec["cost"]["flops"] > 0
    assert roof["compute_s"] == pytest.approx(roof["flops"] / PEAK_FLOPS)
    assert roof["memory_s"] == pytest.approx(roof["hbm_bytes"] / HBM_BW)
    assert roof["step_time_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])
