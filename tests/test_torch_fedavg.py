"""The port's fedavg functions against the JAX package's.

Inputs are made from a seed with numpy and go through both packages:
the JAX side as its own kernel tests run it (the Pallas kernel in
interpret mode, and its jnp reference), the port through its plain
PyTorch versions.  Shapes, dtypes and tolerances are those of
``tests/test_kernels.py``: 1e-6 for one fold and for the reduce
against the reference (fp32 sums taken in another order), 1e-5 for the
K-way burst.  The CUDA kernels themselves are held against these plain
versions on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.aggregation import fedavg_oracle
from repro.kernels import fedavg as jfed
from repro_torch.kernels import fedavg as tfed

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

JAX_IMPLS = ("pallas_interpret", "jnp")
WIRE = {"float32": (jnp.float32, np.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, ml_dtypes.bfloat16, torch.bfloat16),
        "float16": (jnp.float16, np.float16, torch.float16)}


def _both(x: np.ndarray, wire: str):
    """The same rounded values in both packages (numpy rounds to the
    wire dtype once; torch views the bits)."""
    jdt, ndt, tdt = WIRE[wire]
    xn = x.astype(ndt)
    if wire == "bfloat16":
        t = torch.from_numpy(xn.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(xn)
    return jnp.asarray(xn), t


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("K,N", [(2, 64), (4, 1000), (8, 8192 + 17),
                                 (3, 64 * 128 * 2)])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_fedavg_reduce_matches_jax(K, N, wire, impl):
    rng = np.random.default_rng(K * 7 + N)
    Uj, Ut = _both(rng.normal(size=(K, N)), wire)
    w = rng.uniform(0.5, 4.0, size=(K,)).astype(np.float32)
    want = np.asarray(jfed.fedavg_reduce(Uj, jnp.asarray(w), impl=impl))
    got = tfed.fedavg_reduce(Ut, torch.from_numpy(w), impl="torch")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    oracle = fedavg_oracle([np.asarray(u, np.float32) for u in np.asarray(Uj)],
                           [float(x) for x in w])
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("N", [64, 999, 64 * 128 + 1])
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "float16"])
def test_eager_accumulate_matches_jax_in_place(N, wire, impl):
    rng = np.random.default_rng(N)
    acc = rng.normal(size=(N,)).astype(np.float32)
    uj, ut = _both(rng.normal(size=(N,)), wire)
    want = np.asarray(jfed.eager_accumulate(jnp.asarray(acc), uj, 1.75,
                                            impl=impl))
    tacc = torch.from_numpy(acc.copy())
    ptr = tacc.data_ptr()
    out = tfed.eager_accumulate(tacc, ut, 1.75, impl="torch")
    assert out is tacc and tacc.data_ptr() == ptr       # folded in place
    np.testing.assert_allclose(tacc.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("K,N", [(2, 64), (5, 999), (8, 64 * 128 + 1)])
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "float16"])
def test_fedavg_accumulate_k_matches_jax_in_place(K, N, wire, impl):
    rng = np.random.default_rng(K + N)
    acc = rng.normal(size=(N,)).astype(np.float32)
    Uj, Ut = _both(rng.normal(size=(K, N)), wire)
    w = rng.uniform(0.5, 4.0, size=(K,)).astype(np.float32)
    want = np.asarray(jfed.fedavg_accumulate_k(
        jnp.asarray(acc), Uj, jnp.asarray(w), impl=impl))
    tacc = torch.from_numpy(acc.copy())
    ptr = tacc.data_ptr()
    tfed.fedavg_accumulate_k(tacc, Ut, torch.from_numpy(w), impl="auto")
    assert tacc.data_ptr() == ptr
    np.testing.assert_allclose(tacc.numpy(), want, rtol=1e-5, atol=1e-5)


def test_burst_equals_sequential_folds():
    """A K-way burst == K single folds, within the burst tolerance."""
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.normal(size=(999,)).astype(np.float32))
    U = torch.from_numpy(rng.normal(size=(5, 999)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 4.0, size=(5,)).astype(np.float32))
    burst = tfed.fedavg_accumulate_k(acc.clone(), U, w)
    seq = acc.clone()
    for k in range(5):
        tfed.eager_accumulate(seq, U[k], float(w[k]))
    np.testing.assert_allclose(burst.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fedavg_reduce_tree_matches_jax():
    rng = np.random.default_rng(5)
    trees = [{"a": rng.normal(size=(7, 3)).astype(np.float32),
              "b": [rng.normal(size=(11,)).astype(np.float32)]}
             for _ in range(5)]
    ws = [1.0, 2.0, 0.5, 3.0, 1.5]
    want = jfed.fedavg_reduce_tree(
        [{"a": jnp.asarray(t["a"]), "b": [jnp.asarray(t["b"][0])]}
         for t in trees], ws, impl="jnp")
    got = tfed.fedavg_reduce_tree(
        [{"a": torch.from_numpy(t["a"]), "b": [torch.from_numpy(t["b"][0])]}
         for t in trees], ws)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]),
                               rtol=1e-6, atol=1e-6)


def test_flatten_update_round_trip_and_order():
    tree = {"z": torch.arange(3.0), "a": [torch.ones(2, 2), None],
            "m": (torch.zeros(1),)}
    flat, treedef, meta = tfed.flatten_update(tree)
    # jax.tree.flatten order: keys sorted, containers in order
    np.testing.assert_array_equal(flat.numpy(), [1, 1, 1, 1, 0, 0, 1, 2])
    back = tfed.unflatten_update(flat, treedef, meta)
    assert back["a"][1] is None and isinstance(back["m"], tuple)
    np.testing.assert_array_equal(back["z"].numpy(), [0, 1, 2])


def test_cuda_impl_refuses_cpu_tensors():
    acc = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfed.eager_accumulate(acc, torch.ones(8), 1.0, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tfed.eager_accumulate(acc, torch.ones(8), 1.0, impl="pallas")
