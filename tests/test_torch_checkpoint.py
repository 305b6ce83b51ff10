"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

One format for both packages: ``ckpt_%08d.npz`` keyed by JAX path keys
(``/``-joined), each leaf in the JAX layout (conv kernels HWIO), bf16
stored as fp32; a JSON manifest; the ``LATEST`` marker.  Checked both
ways, bit for bit: a checkpoint the JAX package writes restores into
the port, and one the port writes restores into the JAX package, for
full-width ResNet-18 and for a reduced llama3.2-3b with bf16 leaves.
Then ``AsyncCheckpointer`` (the snapshot is taken before ``submit``
returns) and ``checkpoint_dir=`` through ``Session``,
``FederatedTrainer`` and ``FusedFLTrainer.maybe_restore``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import ARCHS as J_ARCHS
from repro.configs.resnet import RESNET18 as J_RESNET18
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as j_build_model
from repro.models.resnet import build_resnet as j_build_resnet
from repro_torch.api import Session
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import ARCHS
from repro_torch.configs.resnet import RESNET18
from repro_torch.convert import (lm_params_from_jax, lm_params_to_jax,
                                 params_from_jax, params_to_jax)
from repro_torch.core import ClientInfo, NodeState, RoundConfig
from repro_torch.data import (ClientShard, build_client_datasets,
                              synthetic_femnist)
from repro_torch.fl.round import AggregationConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models.resnet import build_resnet
from repro_torch.runtime import ClientRuntime, FederatedTrainer, FusedFLTrainer
from repro_torch.tree import tree_leaves

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

LM_ARCH = "llama3.2-3b"


def _bits(a):
    """A leaf's bits, whichever package holds it."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _jax_resnet():
    """Full-width ResNet-18 in the JAX package's structure and layout,
    drawn with numpy."""
    shapes = jax.eval_shape(j_build_resnet(J_RESNET18).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


def _jax_lm():
    cfg = J_ARCHS[LM_ARCH].reduced(dtype="bfloat16")
    model = j_build_model(cfg, JaxOptions(attn_impl="naive", remat=False))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _port_lm(seed):
    cfg = ARCHS[LM_ARCH].reduced(dtype="bfloat16")
    return build_model(cfg, ModelOptions(attn_impl="naive",
                                         remat=False)).init(seed, device="cpu")


#: model -> (JAX tree, the port's tree of other values, JAX -> port,
#: port -> JAX)
MODELS = {
    "resnet18": (_jax_resnet,
                 lambda: build_resnet(RESNET18).init(seed=1, device="cpu"),
                 lambda t: params_from_jax(t, device="cpu"), params_to_jax),
    "llama3.2-3b-reduced-bf16": (
        _jax_lm, lambda: _port_lm(1),
        lambda t: lm_params_from_jax(t, device="cpu"), lm_params_to_jax),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_jax_checkpoint_restores_into_the_port(model, tmp_path):
    jax_tree, port_tree, from_jax, _ = MODELS[model]
    want = jax_tree()
    j_save(tmp_path, 3, want)
    got, step = restore_checkpoint(tmp_path, like=port_tree())
    assert step == 3
    _assert_bit_equal(got, from_jax(want))
    if model != "resnet18":
        assert got["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_port_checkpoint_restores_into_the_jax_package(model, tmp_path):
    jax_tree, port_tree, _, to_jax = MODELS[model]
    params = port_tree()
    save_checkpoint(tmp_path, 4, params, extra={"who": "port"})
    got, step = j_restore(tmp_path, jax_tree())
    assert step == 4 and latest_step(tmp_path) == 4
    _assert_bit_equal(tree_leaves(jax.tree.map(np.asarray, got)),
                      to_jax(params))
    # the same files the JAX package writes: npz keys and manifest
    j_dir = tmp_path / "jax"
    j_save(j_dir, 4, jax.tree.map(np.asarray, got), extra={"who": "port"})
    ours = json.loads((tmp_path / "ckpt_00000004.json").read_text())
    theirs = json.loads((j_dir / "ckpt_00000004.json").read_text())
    assert ours["keys"] == theirs["keys"] and ours["extra"] == theirs["extra"]
    with np.load(tmp_path / "ckpt_00000004.npz") as a, \
            np.load(j_dir / "ckpt_00000004.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_async_checkpointer_snapshots_before_submit_returns(tmp_path):
    params = _port_lm(2)
    before = [t.clone() for t in tree_leaves(params)]
    ck = AsyncCheckpointer(tmp_path)
    ck.submit(5, params)
    for t in tree_leaves(params):          # the next step overwrites
        t.add_(1)
    ck.wait()
    assert ck.completed == 1 and latest_step(tmp_path) == 5
    assert ck.submit_s > 0 and ck.write_s > 0
    got, _ = restore_checkpoint(tmp_path, like=params)
    _assert_bit_equal(got, before)
    ck.submit(6, params)                   # reuses the snapshot buffers
    ck.wait()
    got, step = restore_checkpoint(tmp_path, like=params)
    assert step == 6
    _assert_bit_equal(got, tree_leaves(params))
    assert not list(tmp_path.glob("*.tmp"))


def test_restore_refuses_a_leaf_of_another_shape(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, like={"w": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", like={"w": torch.zeros(3)})


# ---------------------------------------------------------------------------
# checkpoint_dir= through the trainers
# ---------------------------------------------------------------------------

@pytest.fixture
def _no_onednn():
    # oneDNN's CPU conv backward crashes this torch build at odd batch
    # sizes; the port's CPU tests train with it off
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


def _resnet_parts():
    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(16, num_classes=62, seed=0)
    shards = [ClientShard(f"client{i}", np.arange(8 * i, 8 * i + 8))
              for i in range(2)]
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]
    return model, model.init(0, device="cpu"), clients


def _nodes():
    return {"node0": NodeState(node="node0", max_capacity=4)}


@pytest.mark.parametrize("entry", ["session", "federated_trainer"])
def test_checkpoint_dir_round_trips(entry, tmp_path, _no_onednn):
    """``checkpoint_dir=`` writes the global params every
    ``checkpoint_every`` versions; what it wrote restores into both
    packages bit for bit."""
    model, params, clients = _resnet_parts()
    kw = dict(nodes=_nodes(), round_cfg=RoundConfig(aggregation_goal=2),
              device="cpu", checkpoint_dir=str(tmp_path),
              checkpoint_every=2)
    if entry == "session":
        with Session.open(model, params, clients, **kw) as s:
            for _ in range(2):
                s.run_round(client_lr=0.05, client_batch_size=8)
            final = s.params
    else:
        n = sum(t.numel() for t in tree_leaves(params))
        rng = np.random.default_rng(1)
        with FederatedTrainer(model, params, clients, **kw) as tr:
            for r in range(2):
                for c in ("edge-0", "edge-1"):
                    tr.submit_update(c, rng.normal(size=n).astype(
                        np.float32) * 1e-3)
                tr.run_round()
            final = tr.params
    # closing waited for the write in flight
    assert latest_step(tmp_path) == 2
    got, step = restore_checkpoint(tmp_path, like=final)
    assert step == 2
    _assert_bit_equal(got, final)
    want = params_to_jax(final)
    jgot, _ = j_restore(tmp_path, want)
    _assert_bit_equal(tree_leaves(jax.tree.map(np.asarray, jgot)),
                      tree_leaves(want))


def test_fused_trainer_checkpoints_and_restores(tmp_path):
    """A reduced llama3.2-3b round with bf16 params checkpoints after
    round 1; a new trainer resumes from it (``maybe_restore``) with
    the same params, bit for bit, and the round count."""
    cfg = ARCHS[LM_ARCH].reduced(dtype="bfloat16")
    opts = ModelOptions(attn_impl="chunked", remat=False, block_kv=8,
                        loss_chunk=16)
    agg = AggregationConfig(hierarchy="flat", timing="eager",
                            num_microbatches=2)
    t = FusedFLTrainer(cfg, make_host_mesh(), agg, opts=opts, device="cpu",
                       checkpoint_dir=str(tmp_path), checkpoint_every=1)
    t.init(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    t.train_round({"tokens": toks.astype(np.int32),
                   "labels": np.roll(toks, -1, 1).astype(np.int32)})
    t.ckpt.wait()
    assert latest_step(tmp_path) == 1
    r = FusedFLTrainer(cfg, make_host_mesh(), agg, opts=opts, device="cpu",
                       checkpoint_dir=str(tmp_path))
    assert r.maybe_restore() and r.round_id == 1
    _assert_bit_equal(r.params, tree_leaves(t.params))
    assert r.params["embed"].dtype == torch.bfloat16
    assert not FusedFLTrainer(cfg, make_host_mesh(), agg, opts=opts,
                              device="cpu").maybe_restore()
