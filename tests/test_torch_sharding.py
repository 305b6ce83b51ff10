"""The port's sharding rules (``sharding/rules.py``) against the JAX
package's, spec for spec: ``param_specs`` with ``divisibility_fix``,
``batch_specs`` and ``cache_specs``, for every config in ``configs/``,
reduced and at full width (the port's abstract params on the meta
device against ``jax.eval_shape``; kimi-k2-1t-a32b included), on the
meshes (16,16), (2,16,16), (2,2,2) and (1,2,2).  An entry is compared as
its set of axis names in order (JAX writes a one-name tuple as the
name).  And the storage the specs name: every rank's block from
``shard_tree`` tiles the leaf exactly.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.fl import round as jround
from repro.models import build_model as jbuild_model
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS, ShapeConfig, get_shape
from repro_torch.fl import round as tround
from repro_torch.launch.mesh import stand_in_mesh
from repro_torch.models import build_model
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
SIZES = ("reduced", "full")
#: the cells whose inputs and caches are compared, by size
SHAPES = {"reduced": [ShapeConfig("t", 64, 8, "train"),
                      ShapeConfig("p", 64, 8, "prefill"),
                      ShapeConfig("d", 64, 8, "decode")],
          "full": [get_shape("train_4k"), get_shape("prefill_32k"),
                   get_shape("decode_32k")]}


def _cfgs(arch, size):
    if size == "full":
        return JARCHS[arch], ARCHS[arch]
    return JARCHS[arch].reduced(), ARCHS[arch].reduced()


@functools.lru_cache(maxsize=None)
def _models(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    return jm, tm, jround.abstract_params(jm), tround.abstract_params(tm)


def _entry(e):
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _jax_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {jrules._path_names(p): tuple(_entry(e) for e in s)
            for p, s in flat}


def _port_flat(specs, path=()):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_flat(v, path + (str(k),)))
        return out
    if isinstance(specs, (list, tuple)):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_flat(v, path + (str(i),)))
        return out
    return {path: tuple(_entry(e) for e in specs)}


def _meshes(name):
    shape, axes = MESHES[name]
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return jmesh, stand_in_mesh(shape, axes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_jax_packages(arch, size, mesh_name):
    jm, tm, jparams, tparams = _models(arch, size)
    jmesh, tmesh = _meshes(mesh_name)
    dp = tuple(a for a in MESHES[mesh_name][1] if a in ("pod", "data"))
    for fsdp in {("data",), dp}:
        want = _jax_flat(jrules.divisibility_fix(
            jrules.param_specs(jparams, fsdp=fsdp), jparams, jmesh))
        got = _port_flat(rules.divisibility_fix(
            rules.param_specs(tparams, fsdp=fsdp), tparams, tmesh))
        assert got == want
        assert len(want) == len(tree_leaves(tparams))
    jcfg, tcfg = _cfgs(arch, size)
    for shape in SHAPES[size]:
        jb, tb = jround.input_specs(jcfg, shape), \
            tround.input_specs(tcfg, shape)
        assert _port_flat(rules.divisibility_fix(
            rules.batch_specs(tb, dp), tb, tmesh)) == _jax_flat(
            jrules.divisibility_fix(jrules.batch_specs(jb, dp), jb, jmesh))
        if shape.kind == "decode":
            jc = jround.abstract_caches(jm, shape)
            tc = tround.abstract_caches(tm, shape)
            assert _port_flat(rules.divisibility_fix(
                rules.cache_specs(tc, dp), tc, tmesh)) == _jax_flat(
                jrules.divisibility_fix(jrules.cache_specs(jc, dp), jc,
                                        jmesh))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_have_the_jax_shapes_and_dtypes(arch):
    _, _, jparams, tparams = _models(arch, "full")
    jl = jax.tree.leaves(jparams)
    tl = tree_leaves(tparams)
    assert [tuple(j.shape) for j in jl] == [tuple(t.shape) for t in tl]
    assert [str(j.dtype) for j in jl] == \
        [str(t.dtype).removeprefix("torch.") for t in tl]
    assert all(t.is_meta for t in tl)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_ranks_block_tiles_the_leaf(arch):
    """On (2,2,2), the blocks ``shard_tree`` gives each of the 8 ranks,
    put at their offsets, rebuild every leaf bit for bit."""
    shape, axes = MESHES["2x2x2"]
    cfg = ARCHS[arch].reduced(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    mesh0 = stand_in_mesh(shape, axes)
    specs = rules.divisibility_fix(rules.param_specs(
        tround.abstract_params(model), fsdp=("pod", "data")), params, mesh0)
    rebuilt = [torch.full_like(l, float("nan")) for l in tree_leaves(params)]
    for rank in range(8):
        mesh = stand_in_mesh(shape, axes, rank)
        for out, block, spec in zip(rebuilt, tree_leaves(
                rules.shard_tree(params, specs, mesh)), tree_leaves(specs)):
            idx = []
            for dim, entry in enumerate(spec):
                _, n, at = rules._split(entry, mesh)
                size = block.shape[dim]
                idx.append(slice(at * size, (at + 1) * size))
            out[tuple(idx)] = block
    assert all(torch.equal(a, b) for a, b in
               zip(rebuilt, tree_leaves(params)))
