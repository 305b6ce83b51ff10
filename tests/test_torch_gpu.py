"""The fedavg CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: they skip on a host without a CUDA device or
``nvcc``.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where JAX is not installed.
Tolerances are the JAX package's kernel tests': 1e-6 for one fold,
1e-5 for the K-way burst and the reduce.
"""
import pytest
import torch

from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels.fedavg import fedavg as cuda_fed
from repro_torch.kernels.fedavg import ref as tref

WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        cuda_fed._nvcc()
    except RuntimeError as e:      # no nvcc on this host
        pytest.skip(str(e).splitlines()[0])
    cuda_fed.build()               # a failed compile fails the test
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 64 * 128 * 3 + 5])
@pytest.mark.parametrize("wire", list(WIRE))
def test_cuda_kernels_match_plain_versions(card, wire, n):
    g = torch.Generator(device=card).manual_seed(0)
    k = 6
    acc = torch.randn(n, generator=g, device=card)
    U = torch.randn(k, n, generator=g, device=card).to(WIRE[wire])
    w = torch.rand(k, generator=g, device=card) + 0.5
    before = [kern.launches for kern in cuda_fed.KERNELS]
    out = acc.clone()
    ptr = out.data_ptr()
    got = tfed.eager_accumulate(out, U[0], 1.75, impl="cuda")
    assert got.data_ptr() == ptr
    torch.testing.assert_close(got, tref.eager_accumulate_ref(acc, U[0], 1.75),
                               rtol=1e-6, atol=1e-6)
    got = tfed.fedavg_accumulate_k(acc.clone(), U, w, impl="cuda")
    torch.testing.assert_close(got, tref.fedavg_accumulate_k_ref(acc, U, w),
                               rtol=1e-5, atol=1e-5)
    got = tfed.fedavg_reduce(U, w, impl="cuda")
    torch.testing.assert_close(got, tref.fedavg_reduce_ref(U, w / w.sum()),
                               rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in
            zip(cuda_fed.KERNELS, before)] == [1, 1, 1]


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    acc = torch.zeros(8, device=card)
    with pytest.raises(TypeError):
        tfed.eager_accumulate(acc, torch.ones(8, device=card,
                                              dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        tfed.eager_accumulate(acc, torch.ones(9, device=card), 1.0)
    with pytest.raises(ValueError):
        tfed.fedavg_accumulate_k(acc, torch.ones(2, 16, device=card)[:, ::2],
                                 torch.ones(2, device=card))
