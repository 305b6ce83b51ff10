"""The port's int8 quantizer against the JAX package's.

The kernels' entry point (``kernels/quantize/ops.py``, plain versions on
the CPU) against ``repro.kernels.quantize`` with both its ``jnp`` path
and its Pallas kernel in interpret mode, and the port's
``fl/compression.py`` against the JAX module, on the same numpy inputs.
What is compared: ``q`` bit-equal; scales at rtol 1e-6 (they are equal:
both are amax times the fp32 reciprocal of 127, which is what XLA
compiles ``amax / 127.0`` to under ``jit``); dequantized values
bit-equal; and the roundtrip within half a scale of the input (the JAX
package's kernel test, ``tests/test_kernels.py:87``).  The JAX
compression functions run under ``jax.jit``, as the fused round runs
them.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # no optional dep in the image: use the shim
    from _hypothesis_stub import given, settings, strategies as st

from repro.fl import compression as jcomp
from repro.kernels.quantize import QBLOCK, dequantize, quantize
from repro_torch.convert import tensor_from_numpy
from repro_torch.fl import compression as tcomp
from repro_torch.kernels.quantize import QBLOCK as TQBLOCK
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
from repro_torch.tree import tree_leaves

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

SIZES = [QBLOCK, QBLOCK * 3 + 5, 100, 70000]   # tests/test_kernels.py:87


def _x(n, seed=0):
    return (np.random.default_rng(seed).normal(size=(n,)) * 3).astype(
        np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a):
    """An array's bits, for bit-equality of float arrays (NaN-safe)."""
    a = np.ascontiguousarray(_np(a) if not isinstance(a, torch.Tensor)
                             else a.float().numpy())
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _check_against_jax(x_np, jx, impl):
    n = x_np.shape[0]
    jq, js = quantize(jx, impl=impl)
    q, s = qops.quantize(tensor_from_numpy(x_np), impl="torch")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    back = qops.dequantize(q, s, n, impl="torch")
    jback = dequantize(jq, js, n, impl=impl)
    np.testing.assert_array_equal(_bits(back), _bits(jback))
    # error bound: |x - deq| <= scale/2 per block
    xf = np.asarray(jx, np.float32)
    err = np.abs(back.numpy() - xf)
    scales = np.repeat(s.numpy(), QBLOCK)[:n]
    assert np.all(err <= scales / 2 + 1e-7)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_ops_match_jax(n, impl):
    x = _x(n)
    _check_against_jax(x, jnp.asarray(x), impl)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_quantize_ops_zero_input_matches_jax(impl):
    x = np.zeros((QBLOCK * 2,), np.float32)
    _check_against_jax(x, jnp.asarray(x), impl)
    q, s = qops.quantize(torch.zeros(QBLOCK * 2), impl="torch")
    assert not q.any() and bool((s == 1.0).all())    # the kernel's scale
    back = qops.dequantize(q, s, QBLOCK * 2, impl="torch")
    assert not back.any()


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_quantize_ops_bf16_input_matches_jax(impl):
    x = _x(QBLOCK * 3 + 5, seed=1).astype(ml_dtypes.bfloat16)
    _check_against_jax(x, jnp.asarray(x), impl)


def test_quantize_ops_default_block_and_bf16_output():
    assert TQBLOCK == QBLOCK == 256
    x = torch.from_numpy(_x(1000, seed=2))
    q, s = qops.quantize(x)
    assert q.shape == (4, 256) and q.dtype == torch.int8
    assert s.shape == (4,) and s.dtype == torch.float32
    out = qops.dequantize(q, s, 1000, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (1000,)
    want = (q.float() * s[:, None]).reshape(-1)[:1000].to(torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.parametrize("b", [1, 64, 200, 256])
def test_plain_versions_take_any_row_width(b):
    x = torch.from_numpy(_x(7 * b, seed=b)).reshape(7, b)
    q, s = quantize_ref(x)
    qj, sj, _ = _jit_blocks(jnp.asarray(x.numpy()), b)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj)[:, 0])
    np.testing.assert_array_equal(_bits(s), _bits(np.asarray(sj)[:, 0]))
    back = dequantize_ref(q, s)
    assert bool(((back - x).abs() <= s[:, None] / 2 + 1e-7).all())


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False, width=32),
                min_size=1, max_size=600))
def test_quantize_roundtrip_error_bound(vals):
    """tests/test_properties.py:170 on the port's ops."""
    x = torch.tensor(np.asarray(vals, np.float32))
    q, s = qops.quantize(x)
    back = qops.dequantize(q, s, len(vals))
    scales = np.repeat(s.numpy(), QBLOCK)[: len(vals)]
    err = np.abs(back.numpy() - x.numpy())
    assert np.all(err <= scales / 2 * 1.001 + 1e-6)


# ---------------------------------------------------------------------------
# fl/compression.py
# ---------------------------------------------------------------------------

_jit_blocks = jax.jit(jcomp._quantize_blocks_last_axis, static_argnums=1)
_jit_leaf = jax.jit(jcomp.quantize_leaf, static_argnums=1)


def _tree():
    """Last axes 7, 256 and 300 (a ragged block), an all-zero block, a
    bf16 leaf and a scalar leaf."""
    rng = np.random.default_rng(5)
    f = lambda *shape: (rng.normal(size=shape) * 0.02).astype(np.float32)
    zeros_in = f(3, 300)
    zeros_in[1, :256] = 0.0                   # block 0 of row 1 is all zero
    return {
        "a": f(5, 7),
        "b": [f(2, 3, 256), zeros_in],
        "c": f(4, 64).astype(ml_dtypes.bfloat16),
        "s": np.float32(0.3125),
        "z": np.zeros((2, 9), np.float32),
    }


def _port_tree(tree):
    return {k: ([tensor_from_numpy(x) for x in v] if isinstance(v, list)
                else tensor_from_numpy(v)) for k, v in tree.items()}


def _jax_tree(tree):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
                else jnp.asarray(v)) for k, v in tree.items()}


def _leaf_bits(x):
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t.view(torch.int32) if t.dtype == torch.float32
                else t).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else \
        a.view(np.int32) if a.dtype == np.float32 else a


def test_fake_quantize_tree_matches_jax():
    tree = _tree()
    got = tree_leaves(tcomp.fake_quantize_tree(_port_tree(tree)))
    want = tree_leaves(jax.jit(jcomp.fake_quantize_tree)(_jax_tree(tree)))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(_leaf_bits(g), _leaf_bits(w))


def test_quantize_blocks_last_axis_matches_jax():
    for leaf in tree_leaves(_tree()):
        q, safe, last = tcomp._quantize_blocks_last_axis(
            tensor_from_numpy(leaf), 256)
        jq, jsafe, jlast = _jit_blocks(jnp.asarray(leaf), 256)
        assert last == int(jlast)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_leaf_bits(safe),
                                      _leaf_bits(np.asarray(jsafe)))


def test_quantize_tree_and_leaf_match_jax():
    tree = _tree()
    qs, meta, treedef = tcomp.quantize_tree(_port_tree(tree))
    jqs, jmeta, jtreedef = jcomp.quantize_tree(_jax_tree(tree))
    assert [n for n, _ in meta] == [n for n, _ in jmeta]
    for (q, s), leaf in zip(qs, tree_leaves(_jax_tree(tree))):
        jq, js, _ = _jit_leaf(leaf, 256)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_leaf_bits(s), _leaf_bits(
            np.asarray(js)))
    # an all-zero block's scale is 0 here (the kernel writes 1)
    zero_leaf = tree["z"]
    q, s, n = tcomp.quantize_leaf(tensor_from_numpy(zero_leaf))
    assert n == 18 and not q.any() and float(s.abs().max()) == 0.0
    row1 = tcomp.quantize_leaf(tensor_from_numpy(tree["b"][1][1, :256]))
    assert float(row1[1][0]) == 0.0
    got = tree_leaves(tcomp.dequantize_tree(qs, meta, treedef))
    want = tree_leaves(jcomp.dequantize_tree(jqs, jmeta, jtreedef))
    for g, w in zip(got, want):
        assert g.dtype == tensor_from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(_leaf_bits(g), _leaf_bits(w))


def test_fake_quantize_tree_goes_through_the_kernel_ops(monkeypatch):
    """The compression path reaches the quantize kernels' entry point:
    one quantize and one dequantize call per leaf."""
    calls = {"quantize": 0, "dequantize": 0}
    for name in calls:
        orig = getattr(qops, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(qops, name, counted)
    out = tcomp.fake_quantize_tree(_port_tree(_tree()))
    assert calls == {"quantize": 6, "dequantize": 6}
    assert len(tree_leaves(out)) == 6


def test_pod_collectives_are_refused():
    """The pod collectives run across ranks (``launch/dist.py``); on a
    mesh in one process, which runs the pods in turn, they are
    refused."""
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh over ranks"):
        tcomp.pod_mean({}, "pod", mesh=mesh)
    with pytest.raises(ValueError, match="mesh over ranks"):
        tcomp.pod_mean_compressed({}, "pod", mesh=mesh)
