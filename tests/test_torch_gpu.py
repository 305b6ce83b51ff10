"""The CUDA kernels (fedavg, flash attention) against their plain
PyTorch versions, on the card.  Marked ``gpu``: they skip on a host without a CUDA device or
``nvcc``.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where JAX is not installed.
Tolerances are the JAX package's kernel tests': 1e-6 for one fold,
1e-5 for the K-way burst and the reduce; rtol = atol = 2e-6 (fp32) and
2e-2 (bf16) for flash attention.
"""
import pytest
import torch

from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels.fedavg import fedavg as cuda_fed
from repro_torch.kernels.fedavg import ref as tref
from repro_torch.kernels.build import nvcc
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import FLASH
from repro_torch.kernels.flash_attention.flash_attention import LIB as FA_LIB

WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        nvcc()
    except RuntimeError as e:      # no nvcc on this host
        pytest.skip(str(e).splitlines()[0])
    cuda_fed.build()               # a failed compile fails the test
    FA_LIB.build()
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


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,D,window", [
    (1, 128, 1, 1, 32, -1), (2, 256, 2, 3, 64, -1), (1, 256, 4, 1, 64, 64),
    (2, 192, 2, 2, 32, 16), (1, 333, 2, 2, 120, 100), (1, 200, 1, 2, 256, -1)])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(card, B, S, K, G, D, window,
                                            wire):
    g = torch.Generator(device=card).manual_seed(S)
    mk = lambda *shape: torch.randn(shape, generator=g,
                                    device=card).to(WIRE[wire])
    q, k, v = mk(B, S, K, G, D), mk(B, S, K, D), mk(B, S, K, D)
    kw = dict(window=window, causal=True, scale=D ** -0.5)
    before = FLASH.launches
    got = flash_attention(q, k, v, **kw)
    want = flash_attention(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    tol = 2e-6 if wire == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_wrapper_refuses_head_dims_over_256(card):
    q = torch.zeros(1, 8, 1, 1, 320, device=card)
    k = torch.zeros(1, 8, 1, 320, device=card)
    with pytest.raises(ValueError, match="up to 256"):
        flash_attention(q, k, k, scale=1.0)


@pytest.mark.gpu
def test_lm_prefill_on_the_card_matches_the_cpu(card):
    from repro_torch.configs import ARCHS
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(ARCHS["gemma3-4b"].reduced(dtype="float32"),
                        ModelOptions(attn_impl="pallas", remat=False))
    params = model.init(0, device="cpu")
    toks = torch.randint(0, 256, (2, 150), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    before = FLASH.launches
    got, _ = model.prefill(tree_map(lambda t: t.to(card), params),
                           {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    assert FLASH.launches == before + 2        # one per layer
    want, _ = model.prefill(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
