"""The CUDA kernels (fedavg, the four flash-attention forwards, causal
and not, on aligned and misaligned views and odd head dims, int8
quantize and dequantize) against their plain PyTorch
versions, the encoder-decoder and frontend LMs against the CPU, the MoE
ep block forward and backward, the Mamba block and its decode, the
sharded SSM scan forward and backward, and the fused int8 round of each
family against the CPU, on the card.  Marked ``gpu``: they
skip on a host without a CUDA device or ``nvcc``.  Run them on the card
with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where JAX is not installed.
Tolerances are the JAX package's kernel tests': 1e-6 for one fold,
1e-5 for the K-way burst and the reduce; rtol = atol = 2e-6 (fp32) and
2e-2 (bf16, and fp16) for flash attention; the eager fold and the
quantize kernels bit-equal.
"""
import pytest
import torch

from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels.fedavg import fedavg as cuda_fed
from repro_torch.kernels.fedavg import ref as tref
from repro_torch.kernels.build import nvcc
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    FLASH_MMA, FLASH_SIMT, FLASH_TF32X3, FLASH_WGMMA, KERNELS as FA_KERNELS,
    LIBS as FA_LIBS, flash_attention_fwd_cuda, load_width)
from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize.quantize import (KERNELS as Q_KERNELS,
                                                   LIB as Q_LIB,
                                                   dequantize_cuda,
                                                   quantize_cuda)
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref

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
    for lib in FA_LIBS:
        lib.build()
    Q_LIB.build()
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
@pytest.mark.parametrize("n", [1, 7, 8191, 11_199_486])
@pytest.mark.parametrize("wire", list(WIRE))
@pytest.mark.parametrize("acc_off,u_off", [(0, 0), (1, 3), (3, 1), (4, 0),
                                           (2, 2)])
def test_eager_fold_is_bit_equal_on_aligned_and_misaligned_views(
        card, wire, n, acc_off, u_off):
    """The 16-byte eager fold on views that start anywhere: bit-equal to
    its plain version, in place."""
    g = torch.Generator(device=card).manual_seed(n)
    acc_buf = torch.randn(n + acc_off, generator=g, device=card)
    u_buf = torch.randn(n + u_off, generator=g, device=card).to(WIRE[wire])
    acc, u = acc_buf[acc_off:], u_buf[u_off:]
    want = tref.eager_accumulate_ref(acc, u, 1.75)
    ptr = acc.data_ptr()
    before = cuda_fed.EAGER.launches
    got = tfed.eager_accumulate(acc, u, 1.75, impl="cuda")
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr and cuda_fed.EAGER.launches == before + 1
    assert torch.equal(acc, want)


FLASH_SHAPES = [
    (1, 128, 1, 1, 32, -1), (2, 256, 2, 3, 64, -1), (1, 256, 4, 1, 64, 64),
    (2, 192, 2, 2, 32, 16), (1, 333, 2, 2, 120, 100), (1, 200, 1, 2, 256, -1),
    (1, 1, 2, 3, 128, -1), (1, 63, 2, 3, 128, -1), (1, 2000, 2, 3, 128, -1),
    # hymba-1.5b: 25 query heads over 5 KV heads, D 64, window 1024
    (1, 2000, 5, 5, 64, 1024)]


#: seamless-m4t-large-v2's encoder self-attention: 16 heads, MHA, D 64
#: over its 512 frames, without a causal mask
SEAMLESS_ENCODER = (4, 512, 16, 1, 64, -1)
#: (kernel, dtype, element offset, variant named): an offset of 1 puts
#: a 16-bit tensor off 16 bytes, which the mma.sync kernel takes; the
#: CUDA-core kernel runs only when named
VARIANT_INPUTS = [(FLASH_WGMMA, "bfloat16", 0, None),
                  (FLASH_WGMMA, "float16", 0, None),
                  (FLASH_TF32X3, "float32", 0, None),
                  (FLASH_MMA, "bfloat16", 1, None),
                  (FLASH_SIMT, "bfloat16", 1, "simt")]


def _flash_inputs(card, wire, B, S, K, G, D, offset=0, Dv=None):
    g = torch.Generator(device=card).manual_seed(S)

    def mk(*shape):
        n = 1
        for x in shape:
            n *= x
        buf = torch.randn(n + offset, generator=g, device=card)
        return buf.to(WIRE[wire])[offset:].view(shape)

    return mk(B, S, K, G, D), mk(B, S, K, D), mk(B, S, K, Dv or D)


def _held(q, k, v, kern, variant=None, **kw):
    """One launch of ``kern`` (``flash_variant``'s choice, or ``variant``
    named) against the plain version at the dtype's tolerance."""
    before = [kn.launches for kn in FA_KERNELS]
    got = (flash_attention_fwd_cuda(q, k, v, variant=variant, **kw)
           if variant else flash_attention(q, k, v, **kw))
    want = flash_attention(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    assert [kn.launches - b for kn, b in zip(FA_KERNELS, before)] == \
        [int(kn is kern) for kn in FA_KERNELS]
    assert bool(torch.isfinite(got).all())
    tol = 2e-6 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,D,window", FLASH_SHAPES)
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "float16"])
def test_flash_kernel_matches_plain_version(card, B, S, K, G, D, window,
                                            wire):
    q, k, v = _flash_inputs(card, wire, B, S, K, G, D)
    kw = dict(window=window, causal=True, scale=D ** -0.5)
    before = [kern.launches for kern in FA_KERNELS]
    got = flash_attention(q, k, v, **kw)
    want = flash_attention(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    # 16-bit inputs on wgmma, fp32 on mma.sync in 3xTF32
    kern = FLASH_TF32X3 if wire == "float32" else FLASH_WGMMA
    assert [kn.launches - b for kn, b in zip(FA_KERNELS, before)] == \
        [int(kn is kern) for kn in FA_KERNELS]
    tol = 2e-6 if wire == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,D,window", FLASH_SHAPES)
def test_cuda_core_flash_kernel_matches_plain_version_in_fp32(card, B, S, K,
                                                              G, D, window):
    """The CUDA-core kernel, named: the first design stays held against
    the plain version in fp32."""
    q, k, v = _flash_inputs(card, "float32", B, S, K, G, D)
    kw = dict(window=window, causal=True, scale=D ** -0.5)
    before = [kern.launches for kern in FA_KERNELS]
    got = flash_attention_fwd_cuda(q, k, v, variant="simt", **kw)
    want = flash_attention(q, k, v, impl="torch", **kw)
    torch.cuda.synchronize()
    assert [kn.launches - b for kn, b in zip(FA_KERNELS, before)] == \
        [int(kn is FLASH_SIMT) for kn in FA_KERNELS]
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,D,window", [SEAMLESS_ENCODER]
                         + FLASH_SHAPES)
@pytest.mark.parametrize("kern,wire,offset,variant", VARIANT_INPUTS,
                         ids=["wgmma-bf16", "wgmma-fp16", "tf32x3-fp32",
                              "mma-bf16-off16", "simt-bf16-off16-named"])
def test_noncausal_flash_kernel_matches_plain_version(card, B, S, K, G, D,
                                                      window, kern, wire,
                                                      offset, variant):
    """``causal=False`` (an encoder's self-attention) on each of the
    three routed kernels, chosen by ``flash_variant``, and on the
    CUDA-core kernel named, at seamless's encoder shape and the causal
    cases' shapes."""
    q, k, v = _flash_inputs(card, wire, B, S, K, G, D, offset)
    _held(q, k, v, kern, variant, window=window, causal=False,
          scale=D ** -0.5)


#: (D, Dv): odd and misaligned head dims, Dv unlike D, and the widest
MMA_DIMS = [(15, 15), (36, 36), (120, 120), (256, 256), (120, 36),
            (36, 120)]
#: (window, causal): causal, windowed, non-causal
MMA_MASKS = [(-1, True), (100, True), (-1, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
def test_mma_flash_kernel_matches_plain_version_at_every_offset(card, wire,
                                                                offset):
    """16-bit views 1-7 elements into their buffers: off 16 bytes, so
    ``flash_variant`` sends them to the mma.sync kernel, which realigns
    each row in registers."""
    q, k, v = _flash_inputs(card, wire, 2, 333, 2, 2, 120, offset)
    _held(q, k, v, FLASH_MMA, window=100, causal=True, scale=120 ** -0.5)
    # the same views' rows at D = 64: every element offset mod 16 bytes
    q, k, v = _flash_inputs(card, wire, 1, 200, 3, 2, 64, offset)
    _held(q, k, v, FLASH_MMA, causal=False, scale=0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 63, 2000])
@pytest.mark.parametrize("window,causal", MMA_MASKS,
                         ids=["causal", "windowed", "noncausal"])
@pytest.mark.parametrize("D,Dv", MMA_DIMS)
def test_mma_flash_kernel_matches_plain_version_at_any_head_dims(
        card, D, Dv, window, causal, S):
    """Head dims that are not multiples of 8 (any offset: "mma"), and
    multiples of 8 off 16 bytes, with Dv unlike D, causal, windowed and
    not, at one row, a ragged tile and the serve path's length."""
    offset = 1 if D % 8 == 0 and Dv % 8 == 0 else 0
    q, k, v = _flash_inputs(card, "bfloat16", 1, S, 2, 2, D, offset, Dv)
    _held(q, k, v, FLASH_MMA, window=window, causal=causal,
          scale=D ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv,G,offset,width", [
    (120, 120, 2, 1, 16), (36, 36, 3, 0, 8), (36, 36, 3, 2, 4),
    (18, 18, 3, 0, 4), (15, 15, 3, 0, 2), (36, 15, 3, 0, 2)])
def test_mma_flash_kernel_at_every_load_width(card, D, Dv, G, offset, width):
    """Each load width of the mma.sync kernel: row strides that are
    multiples of 16 bytes are realigned (16); else the widest of 8, 4
    and 2 that every row start allows."""
    q, k, v = _flash_inputs(card, "float16", 2, 150, 1, G, D, offset, Dv)
    assert load_width([t.data_ptr() for t in (q, k, v)], 2, G, 1, D,
                      Dv) == width
    _held(q, k, v, FLASH_MMA, window=40, causal=True, scale=D ** -0.5)


@pytest.mark.gpu
def test_mma_flash_kernel_named_on_aligned_inputs(card):
    """Named, the mma.sync kernel takes what the wgmma kernel takes too
    (phase 7's prefill names it so); fp32 it refuses."""
    q, k, v = _flash_inputs(card, "bfloat16", 2, 700, 2, 3, 128)
    _held(q, k, v, FLASH_MMA, variant="mma", causal=True, scale=128 ** -0.5)
    q, k, v = _flash_inputs(card, "float32", 1, 8, 1, 1, 16)
    with pytest.raises(ValueError, match="mma kernel does not take"):
        flash_attention_fwd_cuda(q, k, v, scale=0.25, variant="mma")


#: (D, Dv, element offset) of fp32 inputs the 16-byte copies cannot take
TF32X3_NARROW = [(D, Dv, off) for D, Dv in [(120, 120), (256, 256), (15, 15),
                                            (36, 120), (120, 36), (36, 36)]
                 for off in range(4) if off or D % 8 or Dv % 8]


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv,offset", TF32X3_NARROW)
def test_tf32x3_flash_kernel_takes_any_fp32_input(card, D, Dv, offset):
    """fp32 views off 16 bytes and head dims that are not multiples of
    8: the 3xTF32 kernel's 4-byte copies, held at fp32's 2e-6."""
    q, k, v = _flash_inputs(card, "float32", 1, 333, 2, 2, D, offset, Dv)
    _held(q, k, v, FLASH_TF32X3, window=100, causal=True, scale=D ** -0.5)
    _held(q, k, v, FLASH_TF32X3, causal=False, scale=D ** -0.5)


@pytest.mark.gpu
def test_flash_wrapper_refuses_a_memory_of_another_length(card):
    """Cross-attention over a memory longer than the queries: the
    kernels compute self-attention over one length."""
    q = torch.zeros(1, 7, 2, 2, 64, device=card, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1100, 2, 64, device=card, dtype=torch.bfloat16)
    before = [kn.launches for kn in FA_KERNELS]
    with pytest.raises(ValueError, match="self-attention over one length"):
        flash_attention(q, kv, kv, causal=False, scale=0.125)
    assert [kn.launches for kn in FA_KERNELS] == before


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
    before = [kern.launches for kern in FA_KERNELS]
    got, _ = model.prefill(tree_map(lambda t: t.to(card), params),
                           {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    # one per layer, fp32 (head dim 16) on the 3xTF32 kernel
    assert [kn.launches - b for kn, b in zip(FA_KERNELS, before)] == \
        [2 * int(kn is FLASH_TF32X3) for kn in FA_KERNELS]
    want, _ = model.prefill(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2"])
def test_frontend_lm_serve_on_the_card_matches_the_cpu(card, arch):
    """Reduced fp32: prefill with the stub's embeddings, then two decode
    steps (internvl's positions after its patches; seamless's cross
    cache read), the card against the CPU.  Flash launches: one a
    decoder layer, and one an encoder layer (non-causal)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[arch].reduced(dtype="float32")
    off = 0 if cfg.encoder_layers else cfg.frontend_tokens
    model = build_model(cfg, ModelOptions(
        attn_impl="pallas", remat=False,
        prefill_cache_capacity=off + 150 + 2 + 8))
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 256, (2, 150), generator=gen,
                                     dtype=torch.int32),
             "frontend": 0.02 * torch.randn(2, cfg.frontend_tokens,
                                            cfg.d_model, generator=gen)}

    def loop(p, b):
        logits, caches = model.prefill(p, b)
        out = [logits]
        for i in range(2):
            tok = out[-1][:, -1].argmax(-1)[:, None]
            out.append(model.decode_step(p, tok, caches, off + 150 + i)[0])
        return torch.cat(out, 1)

    before = [kern.launches for kern in FA_KERNELS]
    got = loop(tree_map(lambda t: t.to(card), params),
               {k: t.to(card) for k, t in batch.items()})
    torch.cuda.synchronize()
    n = cfg.num_layers + cfg.encoder_layers
    assert [kn.launches - b for kn, b in zip(FA_KERNELS, before)] == \
        [n * int(kn is FLASH_TF32X3) for kn in FA_KERNELS]
    torch.testing.assert_close(got.cpu(), loop(params, batch), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ep_on_the_card_is_bit_equal_twice_and_matches_the_cpu(card,
                                                                   dtype):
    """Reduced deepseek-v2-lite-16b's MoE block, ep at the default
    capacity factor on 4 x 256 tokens that share a component (so experts
    overflow and drop): two runs on the card bit-equal, and against the
    CPU within ``tests/test_torch_moe_mla.py``'s block tolerance (fp32
    1e-4; bf16 1e-2 of the largest output)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    wire = WIRE[dtype]
    cfg = ARCHS["deepseek-v2-lite-16b"].reduced(dtype=dtype)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, wire)
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4, 256, cfg.d_model, generator=g)
         + torch.randn(cfg.d_model, generator=g)).to(wire)
    on_card = tree_map(lambda t: t.to(card), params)
    mesh = make_host_mesh()
    runs = [moe.moe_block(cfg, on_card, x.to(card), impl="ep", mesh=mesh)[0]
            for _ in range(2)]
    _equal_bits(runs[0], runs[1])
    want, _ = moe.moe_block(cfg, params, x, impl="ep", mesh=mesh)
    gates, idx, _ = moe.router_probs(params["router"], x.reshape(-1, 64), 2)
    assert int((moe.ep_route(cfg.moe, gates, idx)[2] < 0).sum()) > 0
    tol = 1e-4 if dtype == "float32" else 1e-2
    scale = 1.0 if dtype == "float32" else float(want.float().abs().max())
    torch.testing.assert_close(runs[0].cpu().float(), want.float(), rtol=tol,
                               atol=tol * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ep_backward_on_the_card_is_bit_equal_twice_and_matches_the_cpu(
        card, dtype):
    """The ep block's backward (the forward test's block and tokens, so
    experts overflow and drop): the gradients of the output and of the
    load-balance loss for the params and the input, two passes on the
    card bit-equal, and against the CPU: rtol 1e-4 (fp32) or 2e-2 (bf16,
    where gradients round at other places on the two devices), with an
    absolute part of 1e-5 (fp32) or 2e-2 (bf16) of each gradient's
    largest value.  A weight's gradient sums up to 320 capacity rows of
    terms that cancel, so its error is that of the terms, not of the
    small sum (fp32: up to 2.3e-5 on sums about 1e-3)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.tree import tree_flatten, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    wire = WIRE[dtype]
    cfg = ARCHS["deepseek-v2-lite-16b"].reduced(dtype=dtype)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, wire)
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4, 256, cfg.d_model, generator=g)
         + torch.randn(cfg.d_model, generator=g)).to(wire)
    ct = torch.randn(x.shape, generator=g).to(wire)
    mesh = make_host_mesh()

    def grads(device):
        leaves, treedef = tree_flatten(params)
        live = [l.to(device).requires_grad_() for l in leaves]
        xx = x.to(device).requires_grad_()
        y, aux = moe.moe_block(cfg, tree_unflatten(treedef, live), xx,
                               impl="ep", mesh=mesh)
        out = torch.autograd.grad((y * ct.to(device)).float().sum() + aux,
                                  live + [xx])
        return [t.detach() for t in out]

    runs = [grads(card) for _ in range(2)]
    for a, b in zip(*runs):
        _equal_bits(a, b)
    for got, want in zip(runs[0], grads(torch.device("cpu"))):
        got, want = got.cpu().float(), want.float()
        tol = 1e-4 if dtype == "float32" else 2e-2
        part = 1e-5 if dtype == "float32" else 2e-2
        torch.testing.assert_close(got, want, rtol=tol,
                                   atol=part * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_and_decode_on_the_card_match_the_cpu(card, dtype):
    """Reduced falcon-mamba-7b's Mamba block (d_inner 128, N 8) over 2 x
    300 tokens at chunk 256 (the largest divisor of 300 below it: 150),
    then eight decode steps from its state, on the card against the
    CPU: fp32 rtol = atol 1e-5 (sums in another order), bf16 3e-2
    (activations round to bf16 at other places), the tolerances of
    ``tests/test_torch_ssm.py``; the card's cache written in place."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import ssm
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    wire = WIRE[dtype]
    cfg = ARCHS["falcon-mamba-7b"].reduced(dtype=dtype)
    params = ssm.init_ssm(torch.Generator().manual_seed(0), cfg,
                          cfg.d_model, wire)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 300, cfg.d_model, generator=g).to(wire)
    steps = torch.randn(8, 2, 1, cfg.d_model, generator=g).to(wire)
    on_card = tree_map(lambda t: t.to(card), params)
    tol = 1e-5 if dtype == "float32" else 3e-2

    def close(got, want):
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)

    got, got_state = ssm.ssm_block(cfg, on_card, x.to(card), chunk=256,
                                   return_state=True)
    want, state = ssm.ssm_block(cfg, params, x, chunk=256,
                                return_state=True)
    close(got, want)
    for key in ("h", "conv"):
        assert got_state[key].device.type == "cuda"
        close(got_state[key], state[key])
    ptrs = [t.data_ptr() for t in got_state.values()]
    for tok in steps:
        got, got_state = ssm.ssm_decode(cfg, on_card, tok.to(card),
                                        got_state)
        want, state = ssm.ssm_decode(cfg, params, tok, state)
        close(got, want)
    assert [t.data_ptr() for t in got_state.values()] == ptrs
    for key in ("h", "conv"):
        close(got_state[key], state[key])


def _equal_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.is_floating_point:
        a, b = a.contiguous().view(torch.int16 if a.element_size() == 2
                                   else torch.int32), \
            b.contiguous().view(torch.int16 if b.element_size() == 2
                                else torch.int32)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["256", "773", "100", "70000", "zeros",
                                  "bf16", "b64", "b200", "b16", "3200",
                                  "8192"])
def test_quantize_kernels_match_plain_versions_bit_for_bit(card, case):
    """The JAX package's kernel-test sizes, and the SSM rounds' leaves:
    ``A_log``'s rows of N = 16, ``D`` and ``dt_bias`` of d_inner 3200
    (hymba-1.5b) and 8192 (falcon-mamba-7b)."""
    g = torch.Generator(device=card).manual_seed(1)
    n, block, dtype = {"b16": (16 * 8192, 16, "float32"),
                       "3200": (3200, 256, "float32"),
                       "8192": (8192, 256, "float32"),
                       "256": (256, 256, "float32"),
                       "773": (773, 256, "float32"),
                       "100": (100, 256, "float32"),
                       "70000": (70000, 256, "float32"),
                       "zeros": (512, 256, "float32"),
                       "bf16": (773, 256, "bfloat16"),
                       "b64": (64 * 37 + 9, 64, "float32"),
                       "b200": (200 * 11, 200, "float32")}[case]
    x = torch.randn(n, generator=g, device=card) * 3
    if case == "zeros":
        x.zero_()
    x = x.to(WIRE[dtype])
    before = [k.launches for k in Q_KERNELS]
    q, s = qops.quantize(x, block=block)
    qr, sr = qops.quantize(x, block=block, impl="torch")
    _equal_bits(q, qr)
    _equal_bits(s, sr)
    for out_dtype in (torch.float32, torch.bfloat16):
        back = qops.dequantize(q, s, n, out_dtype=out_dtype)
        _equal_bits(back, qops.dequantize(q, s, n, out_dtype=out_dtype,
                                          impl="torch"))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(Q_KERNELS, before)] == [1, 2]
    # error bound: |x - deq| <= scale/2 per block
    err = (qops.dequantize(q, s, n) - x.float()).abs()
    assert bool((err <= s.repeat_interleave(block)[:n] / 2 + 1e-7).all())


@pytest.mark.gpu
def test_quantize_wrappers_refuse_what_the_kernels_do_not_take(card):
    with pytest.raises(ValueError, match="1 to 256"):
        quantize_cuda(torch.zeros(2, 300, device=card))
    with pytest.raises(TypeError):
        quantize_cuda(torch.zeros(2, 8, device=card,
                                         dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        quantize_cuda(torch.zeros(8, 4, device=card).t())
    with pytest.raises(ValueError, match="scales"):
        dequantize_cuda(torch.zeros(2, 8, device=card,
                                           dtype=torch.int8),
                               torch.ones(3, device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("intra", ["seq", "assoc"])
def test_ssm_scan_sharded_on_the_card_matches_the_cpu(card, intra):
    """Reduced falcon-mamba-7b's scan params, 2 x 40 steps at chunk 16
    (chunks of 10) from a non-zero state: y, the final state and the
    gradients of u, h0 and the params, card against CPU at fp32 rtol =
    atol 1e-5 (sums in another order, ``tests/test_torch_ssm.py``'s scan
    tolerance)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["falcon-mamba-7b"].reduced(dtype="float32")
    block = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, cfg.d_model,
                         torch.float32)
    g = torch.Generator().manual_seed(1)
    d_in = block["dt_proj"].shape[1]
    u = torch.randn(2, 40, d_in, generator=g)
    h0 = torch.randn(2, d_in, cfg.ssm.d_state, generator=g) * 0.1
    cy, ch = torch.randn(u.shape, generator=g), torch.randn(h0.shape,
                                                           generator=g)
    keys = ("x_proj", "dt_proj", "dt_bias", "A_log", "D")

    def run(device):
        p = {k: block[k].to(device).requires_grad_() for k in keys}
        uu, hh = u.to(device).requires_grad_(), h0.to(device).requires_grad_()
        y, h = ssm.ssm_scan_sharded(cfg, p, uu, hh, chunk=16,
                                    dp_axes=("data",), model_axis="model",
                                    intra_chunk=intra, mesh=make_host_mesh())
        grads = torch.autograd.grad(
            (y * cy.to(device)).sum() + (h * ch.to(device)).sum(),
            [p[k] for k in keys] + [uu, hh])
        return [t.detach().cpu() for t in (y, h, *grads)]

    for got, want in zip(run(card), run("cpu")):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _card_vs_cpu_round(card, cfg, seq=32, opts=None):
    """One reduced hierarchical int8 round on the card against the CPU,
    from the same params: quantize and dequantize once per leaf and pod,
    the same loss within 1e-5, and the two-part limit (at most 0.1 % of
    elements over 1e-5, none over one quantization step of its block,
    s / n_pods x server_lr)."""
    import numpy as np

    from repro_torch.data.loader import CohortTokenLoader
    from repro_torch.fl.round import AggregationConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import FusedFLTrainer
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh((2, 1, 1), ("pod", "data", "model"))
    agg = AggregationConfig(compress="int8", num_microbatches=2)
    batch = CohortTokenLoader(cfg.vocab_size, seq, 4).round_batch(8, 0)
    if cfg.frontend:
        batch["frontend"] = np.random.default_rng(2).normal(
            0, 0.02, size=(8, cfg.frontend_tokens, cfg.d_model)).astype(
                np.float32)
    cpu = FusedFLTrainer(cfg, mesh, agg, opts=opts, device="cpu")
    cpu.init(0)
    on_card = FusedFLTrainer(cfg, mesh, agg, opts=opts)
    on_card.params = tree_map(lambda t: t.to(card), cpu.params)
    on_card.server_state = tree_map(lambda t: t.to(card), cpu.server_state)
    before = [k.launches for k in Q_KERNELS]
    got = on_card.train_round(batch)
    torch.cuda.synchronize()
    n_leaves = len(tree_leaves(cpu.params))
    assert [k.launches - b for k, b in zip(Q_KERNELS, before)] == \
        [2 * n_leaves, 2 * n_leaves]
    steps = _pod_steps(cpu, batch)
    want = cpu.train_round(batch)
    assert abs(got["loss"] - want["loss"]) < 1e-5
    # the two-part limit: at most 0.1 % of elements over 1e-5, none over
    # one quantization step of its block (s / n_pods x server_lr)
    diffs = [(a.cpu() - b).abs() for a, b in
             zip(tree_leaves(on_card.params), tree_leaves(cpu.params))]
    over = sum(int((d > 1e-5).sum()) for d in diffs)
    assert over <= 1e-3 * sum(d.numel() for d in diffs)
    assert all(bool((d <= st + 1e-5).all()) for d, st in zip(diffs, steps))


@pytest.mark.gpu
def test_fused_int8_round_on_the_card_matches_the_cpu(card):
    from repro_torch.configs import ARCHS

    _card_vs_cpu_round(card, ARCHS["llama3.2-3b"].reduced(dtype="float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2",
                                  "falcon-mamba-7b", "hymba-1.5b"])
def test_fused_int8_round_of_each_family_on_the_card_matches_the_cpu(card,
                                                                     arch):
    """``build_train_step``'s options; the SSM configs with chunks of 8
    (4 a 32-token sequence), the frontend configs with the stub's
    embeddings."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.fl.round import AggregationConfig, train_options
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = ARCHS[arch].reduced(dtype="float32")
    opts = None
    if cfg.ssm is not None:
        opts = dataclasses.replace(train_options(
            cfg, make_debug_mesh((2, 1, 1), ("pod", "data", "model")),
            AggregationConfig()), ssm_chunk=8)
    _card_vs_cpu_round(card, cfg, opts=opts)


def _pod_steps(trainer, batch):
    """Per element, the largest quantization step of its block over the
    pods' deltas of the round about to run (on the CPU trainer)."""
    from repro_torch.fl import compression
    from repro_torch.fl.round import accumulate_updates
    from repro_torch.tree import tree_leaves

    n_pods, agg = trainer.mesh.shape["pod"], trainer.agg
    steps = None
    for i in range(n_pods):
        b = {k: torch.from_numpy(v[i * len(v) // n_pods:
                                   (i + 1) * len(v) // n_pods])
             for k, v in batch.items()}
        d, _, _ = accumulate_updates(trainer.model, trainer.params, b, agg)
        per = []
        for leaf in tree_leaves(d):
            _, safe, last = compression._quantize_blocks_last_axis(leaf, 256)
            st = safe.repeat_interleave(min(256, last), dim=-1)[..., :last]
            per.append(st.reshape(leaf.shape) / n_pods * agg.server_lr)
        steps = per if steps is None else [torch.maximum(a, c)
                                           for a, c in zip(steps, per)]
    return steps


# ---------------------------------------------------------------------------
# the multi-process and multi-node runtimes on the card
# ---------------------------------------------------------------------------

def _small_fleet(device, n_clients=6):
    from repro_torch.configs.resnet import RESNET18
    from repro_torch.core import ClientInfo
    from repro_torch.data import (build_client_datasets, dirichlet_partition,
                                  synthetic_femnist)
    from repro_torch.models.resnet import build_resnet
    from repro_torch.runtime import ClientRuntime

    model = build_resnet(RESNET18.reduced())
    imgs, labels = synthetic_femnist(96, num_classes=10, seed=0)
    shards = dirichlet_partition(labels, n_clients, alpha=0.5)
    clients = [ClientRuntime(ClientInfo(d.client_id, d.num_samples), d)
               for d in build_client_datasets(imgs, labels, shards)]
    return model, model.init(0, device=device), clients


@pytest.mark.gpu
def test_shmproc_round_after_card_training_survives_a_respawn(card):
    """Forked numpy workers after the parent trained clients on the card:
    a cold round, a warm one, then a busy worker SIGKILLed mid-round is
    replaced by a fresh fork and the round still folds its full goal.
    Against an inproc session on the card within 3e-4, both training
    with cuDNN's deterministic algorithms (otherwise two sessions'
    convolutions differ run to run, and three rounds of SGD carry it
    past the limit)."""
    import os

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got, want, prefix = _shmproc_and_inproc_rounds(card)
    finally:
        torch.backends.cudnn.deterministic = was
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) < 3e-4


def _shmproc_and_inproc_rounds(card):
    import os
    import signal

    from repro_torch.api import Session
    from repro_torch.core import RoundConfig
    from repro_torch.runtime.events import UpdateArrived, WorkerCrashed
    from repro_torch.tree import tree_leaves

    model, params, clients = _small_fleet(card)
    cfg = lambda: RoundConfig(aggregation_goal=4)   # noqa: E731
    with Session.open(model, params, clients, round_cfg=cfg(),
                      seed=0) as ref:
        for _ in range(3):
            ref.run_round(client_lr=0.05, client_batch_size=16)
        want = [l.detach().cpu() for l in tree_leaves(ref.params)]
    crashes, seen = [], []
    with Session.open(model, params, clients, runtime="shmproc",
                      round_cfg=cfg(), seed=0) as s:
        for _ in range(2):
            assert s.run_round(client_lr=0.05,
                               client_batch_size=16)["updates"] == 4.0
        shm = s.trainer._runtime._rt

        def kill(ev):
            seen.append(ev)
            if len(seen) == 2:
                busy = [w for w in shm._workers if w.state == "busy"]
                os.kill(busy[0].proc.pid, signal.SIGKILL)

        s.on(UpdateArrived, kill)
        s.on(WorkerCrashed, crashes.append)
        rec = s.run_round(client_lr=0.05, client_batch_size=16)
        assert rec["updates"] == 4.0 and rec["redispatched"] >= 1
        assert crashes and shm.stats["forked"] >= 2
        assert shm.stats["warm_starts"] >= 1
        got = [l.detach().cpu() for l in tree_leaves(s.params)]
        return got, want, shm.prefix


@pytest.mark.gpu
def test_netd_on_the_card_folds_with_the_kernels(card):
    """A daemon started without ``--device`` folds on the card: its
    ``stats_reply`` says ``cuda`` and counts one eager fold launch per
    update, and the round's delta is bit-equal to the blocked numpy
    engine's (the eager kernel rounds where numpy does)."""
    import subprocess

    import numpy as np

    from repro_torch.core.engine import EngineConfig
    from repro_torch.runtime.driver import InProcRuntime, RoundDriver
    from repro_torch.runtime.netrt import (RemoteRuntime, connect,
                                           reap_local_daemon,
                                           spawn_local_daemon)

    n = 1 << 20
    rng = np.random.default_rng(0)
    ups = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    ws = [1.0, 2.0, 3.5, 0.5]

    def drive(rt):
        out = RoundDriver(rt).run_round(
            round_id=0, assignment={"nodeA": [0, 1, 2, 3]},
            updates=(("nodeA", f"c{i}", u, w)
                     for i, (u, w) in enumerate(zip(ups, ws))),
            goal=4, n_elems=n)
        rt.close()
        return out.delta

    want = drive(InProcRuntime(agg_engine="blocked"))
    proc, addr = spawn_local_daemon("nodeA", stdout=subprocess.DEVNULL,
                                    timeout=120.0)
    try:
        got = drive(RemoteRuntime([addr], agg_engine=EngineConfig(
            name="auto", device="cuda")))
        conn = connect(addr, timeout=10.0)
        conn.send("hello", {"role": "client"})
        conn.recv_expect(("welcome",), 10.0)
        conn.send("stats", {})
        meta = conn.recv_expect(("stats_reply",), 10.0).meta
        conn.close()
    finally:
        reap_local_daemon(proc)
    assert meta["device"].startswith("cuda")
    assert meta["kernel_launches"]["eager_accumulate"] == 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_service_on_the_card_folds_with_the_kernels_and_copies_once(
        card, monkeypatch):
    """``AggregationService()`` lands on the card: a two-job round of
    external updates folds through the fedavg kernels, each publish
    copies its accumulator to pinned host memory once, and the deltas
    are the CPU service's within the burst kernel's 1e-5 (a delivery
    that finds several updates queued folds them as one burst)."""
    import numpy as np

    from repro_torch.core import (ClientInfo, NodeState, RoundConfig,
                                  TorchEngine)
    from repro_torch.runtime.events import PartialReady
    from repro_torch.serve import AggregationService, GoalPolicy

    class Model:
        def loss(self, params, batch):
            return (params["w"] ** 2).sum(), {}

    n = 1 << 20
    rng = np.random.default_rng(0)
    ups = {f"{j}-u{k}": rng.standard_normal(n).astype(np.float32)
           for j in ("a", "b") for k in range(4)}

    def run(device):
        nodes = {f"node{i}": NodeState(node=f"node{i}", max_capacity=20.0)
                 for i in range(2)}
        svc = AggregationService(nodes, **({} if device is None
                                           else {"device": device}))
        published = []
        svc.driver.on(PartialReady, published.append)
        try:
            for j, w in (("a", 2.0), ("b", 1.0)):
                svc.add_job(j, Model(), {"w": torch.zeros(n)},
                            [ClientInfo(f"{j}-r{i}", 10) for i in range(8)],
                            weight=w,
                            round_cfg=RoundConfig(aggregation_goal=4))
            for cid, u in ups.items():
                svc.submit(cid[0], cid, u, 1.0 + int(cid[-1]))
            recs = svc.run_rounds({"a": 1, "b": 1}, policy=GoalPolicy())
            mids = [e for k, e in svc.runtime._engines.items()
                    if k.startswith("mid")]
            out = {r["job"]: np.asarray(r["outcome"].delta) for r in recs}
            params = svc.trainer("a").params["w"]
            return out, published, mids, params
        finally:
            svc.close()

    pinned = []
    to_numpy = TorchEngine.to_numpy

    def spy(self, acc):
        arr = to_numpy(self, acc)
        pinned.append(torch.from_numpy(arr).is_pinned())
        return arr

    before = sum(k.launches for k in cuda_fed.KERNELS)
    monkeypatch.setattr(TorchEngine, "to_numpy", spy)
    got, published, mids, params = run(None)
    monkeypatch.undo()
    assert params.device.type == "cuda"
    assert sum(k.launches for k in cuda_fed.KERNELS) - before >= 2
    assert sum(e.elements_folded for e in mids) == 8 * n
    assert sum(e.host_copies for e in mids) == len(published) == 2
    assert pinned and all(pinned)
    want, *_ = run("cpu")
    for job in ("a", "b"):
        np.testing.assert_allclose(got[job], want[job], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A bf16 LM tree on the card: ``AsyncCheckpointer.submit`` copies it
    to pinned host memory before it returns, and a restore onto the card
    or the CPU gives the same bits."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.configs import ARCHS
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.tree import tree_leaves

    cfg = ARCHS["llama3.2-3b"].reduced(dtype="bfloat16")
    params = build_model(cfg, ModelOptions(attn_impl="naive",
                                           remat=False)).init(0)
    want = [t.clone() for t in tree_leaves(params)]
    ck = AsyncCheckpointer(tmp_path)
    ck.submit(1, params)
    for t in tree_leaves(params):
        t.add_(1)
    ck.wait()
    for device in (None, "cpu"):
        got, step = restore_checkpoint(tmp_path, like=params, device=device)
        assert step == 1
        for g, w in zip(tree_leaves(got), want):
            assert g.dtype == w.dtype
            assert g.device.type == (device or "cuda")
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.gpu
def test_two_rank_ring_on_the_card(card):
    """Two gloo ranks on the card (``spawn_ranks``, every wire tensor
    staged through pinned host memory): ``pod_mean_compressed`` of each
    pod's (3, n) leaf (seed = pod) bit-equal on both ranks to the mean
    of the two pods' int8 round trips (plain versions, in pod-0 order),
    with one quantize and two dequantize launches a rank; ``pod_mean``
    the plain mean."""
    import _torch_dist_ranks as ranks
    from repro_torch.launch.dist import spawn_ranks

    n = 70000
    out = spawn_ranks(ranks.ring_on_card, 2, n, timeout_s=300)
    xs = [torch.randn(3, n, device=card,
                      generator=torch.Generator(device=card).manual_seed(p))
          for p in range(2)]
    deq = []
    for x in xs:
        q, s = quantize_ref(_last_axis_blocks(x))
        deq.append(dequantize_ref(q, s, torch.float32))
    want = ((deq[0] + deq[1]) / 2).reshape(3, -1)[:, :n].cpu()
    mean = ((xs[0] + xs[1]) / 2).cpu()
    for got, got_mean, launches, device in out:
        assert device == "cuda:0" and launches == (1, 2)
        assert torch.equal(torch.from_numpy(got), want)
        torch.testing.assert_close(torch.from_numpy(got_mean), mean,
                                   rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_two_rank_model_axis_round_on_the_card(card):
    """Two gloo ranks on the card on a (1,1,2) mesh (the model axis:
    context-parallel flash, the vocab-sharded embedding and loss),
    reduced fp32 llama3.2-3b from seed-0 params: both ranks'
    params bit-identical; uncompressed within atol 5e-5 of the
    one-process round on the card; int8 with at most 0.1 % of elements
    over 1e-5 from it (part a of the two-part limit), quantize once a
    leaf and dequantize once a leaf (one pod) on each rank."""
    import numpy as np

    import _torch_model_ranks as ranks
    from repro_torch.configs import ARCHS
    from repro_torch.fl.round import AggregationConfig, build_train_step
    from repro_torch.fl.server import init_server_state
    from repro_torch.launch.dist import spawn_ranks
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.tree import tree_leaves

    arch = "llama3.2-3b"
    cfg = ARCHS[arch].reduced(dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(8, 32))
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    mesh = make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
    init, want = None, {}
    for comp in ("none", "int8"):
        step, model = build_train_step(cfg, mesh, AggregationConfig(
            compress=comp, num_microbatches=2))
        params = model.init(0, device=card)
        init = [t.cpu().numpy() for t in tree_leaves(params)]
        new, _, _ = step(params, init_server_state("fedavg", params),
                         {k: torch.from_numpy(v).to(card)
                          for k, v in batch.items()})
        want[comp] = [t.cpu().numpy() for t in tree_leaves(new)]
    out = spawn_ranks(ranks.two_rank_round_on_card, 2, arch, init, batch,
                      timeout_s=300)
    leaves = len(init)
    for comp in ("none", "int8"):
        got = out[0][comp]["params"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(got, out[1][comp]["params"]))
        d = np.concatenate([np.abs(g.astype(np.float64) - w).ravel()
                            for g, w in zip(got, want[comp])])
        if comp == "none":
            assert d.max() <= 5e-5, d.max()
        else:
            assert (d > 1e-5).mean() <= 1e-3
            for res in out:
                assert res[comp]["launches"] == (leaves, leaves)
        assert out[0][comp]["wire"]["model_all_gather"]["calls"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "seamless-m4t-large-v2"])
def test_two_rank_ssm_and_encoder_model_axis_round_on_the_card(card, arch):
    """Two gloo ranks on the card on a (1,1,2) mesh, reduced fp32
    falcon-mamba-7b (the SSM scan's d_inner split over the model ranks)
    and seamless-m4t-large-v2 (the encoder's non-causal layers through
    the context-parallel flash, 4 stub frames) from seed-0 params: both
    ranks' params bit-identical; uncompressed within atol 5e-5 of the
    one-process round on the card; int8 with at most 0.1 % of elements
    over 1e-5 from it, quantize and dequantize once a leaf on each
    rank."""
    import numpy as np

    import _torch_model_ranks as ranks
    from repro_torch.configs import ARCHS
    from repro_torch.fl.round import AggregationConfig, build_train_step
    from repro_torch.fl.server import init_server_state
    from repro_torch.launch.dist import spawn_ranks
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.tree import tree_leaves

    cfg = ARCHS[arch].reduced(dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(8, 32))
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.frontend:
        batch["frontend"] = rng.normal(
            size=(8, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    mesh = make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
    init, want = None, {}
    for comp in ("none", "int8"):
        step, model = build_train_step(cfg, mesh, AggregationConfig(
            compress=comp, num_microbatches=2))
        params = model.init(0, device=card)
        init = [t.cpu().numpy() for t in tree_leaves(params)]
        new, _, _ = step(params, init_server_state("fedavg", params),
                         {k: torch.from_numpy(v).to(card)
                          for k, v in batch.items()})
        want[comp] = [t.cpu().numpy() for t in tree_leaves(new)]
    out = spawn_ranks(ranks.two_rank_round_on_card, 2, arch, init, batch,
                      timeout_s=300)
    leaves = len(init)
    for comp in ("none", "int8"):
        got = out[0][comp]["params"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(got, out[1][comp]["params"]))
        d = np.concatenate([np.abs(g.astype(np.float64) - w).ravel()
                            for g, w in zip(got, want[comp])])
        if comp == "none":
            assert d.max() <= 5e-5, d.max()
        else:
            assert (d > 1e-5).mean() <= 1e-3
            for res in out:
                assert res[comp]["launches"] == (leaves, leaves)
        # falcon-mamba-7b gathers only its scan's y and state
        assert out[0][comp]["wire"]["model_all_gather"]["calls"] > 0


def _last_axis_blocks(x):
    """A (rows, n) leaf as the int8 hop blocks it: rows of 256 along the
    last axis, zero-padded."""
    pad = -x.shape[-1] % 256
    return torch.nn.functional.pad(x, (0, pad)).reshape(-1, 256)


@pytest.mark.gpu
def test_two_rank_sharded_int8_round_on_the_card(card):
    """Two gloo ranks on the card on a (1,2,1) mesh, reduced fp32
    llama3.2-3b from seed-0 params, each rank holding only its blocks of
    ``train_shardings``' specs: the uncompressed round within 1e-6 of the
    largest element of the replicated round on the same ranks; the int8
    round within Σ_p (s_p + s'_p) / 2P of it (whole-leaf and shard block
    scales, ``_torch_fsdp_ranks.int8_limits``); the leaves that neither
    rank splits bit-identical on both; quantize and dequantize once a
    leaf on each rank, on the card."""
    import numpy as np

    import _torch_fsdp_ranks as ranks
    from repro_torch.launch.dist import spawn_ranks

    plan = [(comp, "train", dict(arch="llama3.2-3b", shape=(1, 2, 1),
                                 hierarchy="hierarchical", compress=comp))
            for comp in ("none", "int8")]
    out = spawn_ranks(ranks.run_plan, 2, plan, timeout_s=300)
    for comp in ("none", "int8"):
        rows = [r[comp] for r in out]
        got, want = rows[0]["whole"], rows[0]["rep"]
        if comp == "none":
            scale = max(float(np.abs(w).max()) for w in want)
            assert max(float(np.abs(g - w).max())
                       for g, w in zip(got, want)) <= 1e-6 * scale
        else:
            _, bounds = ranks.int8_limits(rows)
            for g, w, b in zip(got, want, bounds):
                assert np.all(np.abs(g.astype(np.float64) - w)
                              <= b + 1e-5)
            leaves = len(got)
            for r in rows:
                assert r["launches"] == {"quantize": leaves,
                                         "dequantize": leaves}
        whole = [i for i, (g, b) in enumerate(
            zip(got, rows[0]["block_shapes"])) if g.shape == tuple(b)]
        assert all(rows[0]["digests"][i] == rows[1]["digests"][i]
                   for i in whole)
        assert rows[0]["wire"]["data_all_gather"]["calls"] > 0
