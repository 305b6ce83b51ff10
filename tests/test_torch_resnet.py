"""The port's ResNet against the JAX package's, on converted weights.

Params in the JAX package's structure and layout, drawn with numpy, are
carried across with ``params_from_jax``; the same numpy batch goes
through both models.  Tolerance rtol 1e-4, atol 1e-5: the two
frameworks' CPU convolutions sum each output's k·k·cin products in
different orders, and the fp32 rounding differences compound through
every conv and GroupNorm of the network.

oneDNN's CPU conv backward crashes this torch build at odd batch sizes,
so these tests run with it off; the card runs cuDNN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet import RESNET18 as J_RESNET18
from repro.models.resnet import build_resnet as j_build
from repro.runtime.trainer import _flatten_tree as j_flatten
from repro_torch.configs.resnet import RESNET18
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models.resnet import build_resnet
from repro_torch.runtime.trainer import _flatten_tree, _unflatten_like
from repro_torch.tree import tree_flatten, tree_unflatten

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _no_onednn():
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


def _jax_params(cfg, seed=0):
    """A parameter tree in the JAX package's structure and layout, drawn
    with numpy: He-normal convs, a cin^-1/2 normal head, GroupNorm
    scale and bias jittered around 1 and 0 so that they matter."""
    shapes = jax.eval_shape(j_build(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape)
        if len(s.shape) == 4:
            k, _, cin, _ = s.shape
            z = z * (2.0 / (k * k * cin)) ** 0.5
        elif name.endswith("['head']"):
            z = z * s.shape[0] ** -0.5
        elif name.endswith("['scale']"):
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            "labels": rng.integers(0, 62, size=(n,)).astype(np.int32)}


def test_full_width_resnet18_logits_match_jax():
    jp = _jax_params(J_RESNET18)
    b = _batch(2)
    want = np.asarray(jax.jit(j_build(J_RESNET18).apply)(
        jp, jnp.asarray(b["images"])))
    got = build_resnet(RESNET18).apply(params_from_jax(jp, device="cpu"),
                                       torch.from_numpy(b["images"]))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("batch", [4, 5])
def test_reduced_resnet18_loss_and_grads_match_jax(batch):
    cfg = RESNET18.reduced()
    jm, jp = j_build(J_RESNET18.reduced()), _jax_params(J_RESNET18.reduced())
    b = _batch(batch, seed=batch)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tm = build_resnet(cfg)
    tp = params_from_jax(jp, device="cpu")
    leaves, treedef = tree_flatten(tp)
    leaves = [l.requires_grad_(True) for l in leaves]
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tl, taux = tm.loss(tree_unflatten(treedef, leaves), tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL, atol=ATOL)
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    np.testing.assert_allclose(
        tm.apply(tp, tb["images"]).detach().numpy(),
        np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(b["images"]))),
        rtol=RTOL, atol=ATOL)
    grads = tree_unflatten(treedef, list(torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(_flatten_tree(grads)[0], j_flatten(jg)[0],
                               rtol=RTOL, atol=ATOL)


def test_flat_layout_is_bit_equal_to_jax():
    """62 leaves, 11,199,486 elements, the JAX order and HWIO layout."""
    jp = _jax_params(J_RESNET18)
    want, _, jmeta = j_flatten(jp)
    tp = params_from_jax(jp, device="cpu")
    got, _, meta = _flatten_tree(tp)
    assert got.dtype == np.float32 and got.shape == (11_199_486,)
    np.testing.assert_array_equal(got, want)
    assert [m[0] for m in meta] == [tuple(m[0]) for m in jmeta]
    assert len(meta) == 62
    back = _unflatten_like(want, tp)
    for a, b in zip(jax.tree.leaves(params_to_jax(back)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_init_has_the_jax_structure():
    """The port's own init builds the same tree (names, shapes) as the
    JAX package's, so its updates fold into the JAX layout."""
    jp = _jax_params(J_RESNET18.reduced())
    tp = build_resnet(RESNET18.reduced()).init(seed=0, device="cpu")
    assert (jax.tree.structure(jp)
            == jax.tree.structure(params_to_jax(tp)))
    for a, b in zip(jax.tree.leaves(params_to_jax(tp)), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
