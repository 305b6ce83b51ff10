"""The numerics and the dispatch of the fp32 flash-attention kernel on the
tensor cores (``csrc/flash_attention_tf32x3.cu``), on the CPU.

The kernel cannot run here, so its arithmetic is emulated in plain torch:
TF32 rounding as ``cvt.rna.tf32.f32`` (to nearest, ties away) by integer
operations on the fp32 words; every product in 3xTF32 (each operand split
as hi = tf32(x), lo = tf32(x - hi); lo.hi + hi.lo + hi.hi, each k8 step's
sum rounded once to fp32 and added to the running fp32 sum); the online
softmax over 32-key tiles with IEEE exp and the kernel's -1e30 mask.  The
emulation must sit within the fp32 tolerance of the JAX package's kernel
test (rtol = atol = 2e-6, ``tests/test_kernels.py``) of the plain version
and of the JAX kernel in interpret mode, at that test's four shapes and at
a reduced serve-path shape; one TF32 pass must land outside it, so the
tolerance tells the two apart.  The kernel itself is held against the
plain version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    BY_VARIANT, FLASH_TF32X3, KERNELS, LIB_TF32X3, LIBS, VARIANTS,
    flash_attention_fwd_cuda, flash_variant)
from repro_torch.kernels.flash_attention.ref import GLOBAL

torch.set_num_threads(2)

TOL = 2e-6
#: the JAX package's kernel-test shapes (B, S, K, G, D, window)
JAX_SHAPES = [(1, 128, 1, 1, 32, -1), (2, 256, 2, 3, 64, -1),
              (1, 256, 4, 1, 64, 64), (2, 192, 2, 2, 32, 16)]
#: the serve path's heads and head dim (8 KV heads, 3 query heads each,
#: D = 128) at S = 512 and B = 1
PATH_SHAPE = (1, 512, 8, 3, 128, -1)
BN = 32          # keys a KV tile, as in the kernel
NEG_INF = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 (still in fp32 words), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a (..., M, K) @ b (..., K, N) as the kernel takes it: k8 steps, each
    step's sum rounded to fp32 once and added to an fp32 accumulator.
    ``passes=3`` is 3xTF32, ``passes=1`` one TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        f = lambda x, y: x[..., ks].double() @ y[..., ks, :].double()
        step = f(ah, bh)
        if passes == 3:
            step = f(al, bh) + f(ah, bl) + step
        out = out + step.float()
    return out


def emulated_attention(q, k, v, *, scale, window=GLOBAL, causal=True,
                       passes=3):
    """q (B, H, S, D), k and v (B, K, S, D) fp32 -> (B, H, S, Dv): the
    kernel's arithmetic, tile by tile."""
    B, H, S, _ = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s_all = product(q, k.transpose(-1, -2), passes) * np.float32(scale)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, v.shape[-1]))
    for kv0 in range(0, S, BN):
        cols = torch.arange(kv0, min(kv0 + BN, S))[None, :]
        ok = torch.ones((S, cols.shape[1]), dtype=torch.bool)
        if causal:
            ok &= rows >= cols
        if window != GLOBAL:
            ok &= rows - cols < window
        s = torch.where(ok, s_all[..., kv0:kv0 + BN], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + product(p, v[..., kv0:kv0 + BN, :], passes)
        m = m_new
    return acc / l.clamp_min(1e-30)


def _inputs(B, S, K, G, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, S, K, G, D), (B, S, K, D), (B, S, K, D))]


def _heads(q, k, v):
    """(B, S, K, G, D) / (B, S, K, D) numpy -> (B, H, S, D) torch."""
    B, S, K, G, D = q.shape
    return (torch.from_numpy(q).reshape(B, S, K * G, D).transpose(1, 2),
            torch.from_numpy(k).transpose(1, 2),
            torch.from_numpy(v).transpose(1, 2))


def _limit_share(got, want):
    """max |got - want| / (TOL + TOL |want|): above 1 is outside."""
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


def _check(B, S, K, G, D, window, against_jax):
    qn, kn, vn = _inputs(B, S, K, G, D)
    q, k, v = _heads(qn, kn, vn)
    scale = D ** -0.5
    kw = dict(scale=scale, window=window, causal=True)
    plain = flash_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                            torch.from_numpy(vn), impl="torch", **kw)
    plain = plain.reshape(B, S, K * G, D).transpose(1, 2)
    x3 = emulated_attention(q, k, v, **kw)
    one = emulated_attention(q, k, v, passes=1, **kw)
    assert _limit_share(x3, plain) <= 1.0
    # one TF32 pass is hundreds of times the tolerance off
    assert _limit_share(one, plain) > 10.0
    if against_jax:
        want = jax_flash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                         impl="pallas_interpret", bq=64, bk=64, **kw)
        want = torch.from_numpy(np.array(want, np.float32))
        want = want.reshape(B, S, K * G, D).transpose(1, 2)
        assert _limit_share(x3, want) <= 1.0


def test_tf32_rounds_to_nearest_ties_away():
    # 1 + 2^-11 is half a TF32 step above 1: ties go away from zero
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
                         1 + 2 ** -9, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert torch.equal(torch.signbit(tf32(x)), torch.signbit(want))
    # hi keeps 11 significant bits; hi + lo is x to about 22
    y = torch.from_numpy(np.random.default_rng(1).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split(y)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2 ** -11
    assert float(((y - hi - lo).abs() / y.abs()).max()) <= 2 ** -21


@pytest.mark.parametrize("passes", [3, 1])
def test_3xtf32_product_keeps_fp32_accuracy(passes):
    """Against the exact product: 3xTF32 errs no more than an fp32
    product of the same inputs; one TF32 pass errs hundreds of times
    more."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(128, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    err = float((product(a, b, passes).double() - exact).abs().max())
    fp32 = float(((a @ b).double() - exact).abs().max())
    if passes == 3:
        assert err <= fp32
    else:
        assert err > 100 * fp32


@pytest.mark.parametrize("B,S,K,G,D,window", JAX_SHAPES)
def test_emulated_kernel_is_inside_the_fp32_tolerance(B, S, K, G, D, window):
    _check(B, S, K, G, D, window, against_jax=True)


def test_emulated_kernel_at_a_reduced_serve_path_shape():
    _check(*PATH_SHAPE, against_jax=False)


@pytest.mark.parametrize("dim", [8, 32, 64, 120, 128, 256])
def test_dispatch_sends_fp32_to_the_tensor_cores(dim):
    assert flash_variant(torch.float32, dim, dim) == "tf32x3"
    assert flash_variant(torch.float32, dim, 64) == "tf32x3"
    assert flash_variant(torch.float32, 64, dim) == "tf32x3"


@pytest.mark.parametrize("d,dv,aligned", [(15, 15, True), (120, 36, True),
                                          (36, 120, True), (4, 8, True),
                                          (128, 128, False)])
def test_dispatch_sends_what_cp_async_cannot_take_to_the_cuda_cores(
        d, dv, aligned):
    """Head dims that are not multiples of 8, or a pointer off 16 bytes,
    which the 16-byte copies cannot take: fp32 is always 4-byte aligned,
    so the 3xTF32 kernel takes them with its 4-byte copies, chosen at
    launch; the CUDA-core kernel is on no route."""
    assert flash_variant(torch.float32, d, dv, aligned) == "tf32x3"


def test_the_kernel_is_registered_with_the_others():
    assert VARIANTS == ("wgmma", "tf32x3", "mma", "simt")
    assert BY_VARIANT["tf32x3"] is FLASH_TF32X3
    assert FLASH_TF32X3 in KERNELS and LIB_TF32X3 in LIBS
    assert FLASH_TF32X3.lib is LIB_TF32X3
    assert LIB_TF32X3.src.name == "flash_attention_tf32x3.cu"
    assert LIB_TF32X3.src.exists()
    assert FLASH_TF32X3.name == "flash_attention_fwd_tf32x3"
    assert FLASH_TF32X3.replaces == \
        "src/repro/kernels/flash_attention/flash_attention.py:89"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wrapper_refuses_tf32x3_for_16_bit_inputs(dtype):
    q = torch.zeros(1, 8, 1, 2, 16, dtype=dtype)
    k = torch.zeros(1, 8, 1, 16, dtype=dtype)
    before = [kern.launches for kern in KERNELS]
    with pytest.raises(ValueError, match="tf32x3 kernel does not take"):
        flash_attention_fwd_cuda(q, k, k, scale=1.0, variant="tf32x3")
    assert [kern.launches for kern in KERNELS] == before


def test_wrapper_refuses_tf32x3_for_what_only_the_cuda_cores_take():
    """What only the CUDA-core kernel took (a head dim of 12, a view one
    element into its buffer) the 3xTF32 kernel now takes: each gets as
    far as the device check, named or chosen."""
    before = [kern.launches for kern in KERNELS]
    q, k = torch.zeros(1, 8, 1, 1, 12), torch.zeros(1, 8, 1, 12)
    buf = torch.zeros(1 + 8 * 16)
    views = (buf[1:].view(1, 8, 1, 1, 16), buf[1:].view(1, 8, 1, 16))
    for q, k in ((q, k), views, (torch.zeros(1, 8, 1, 1, 16),
                                 torch.zeros(1, 8, 1, 16))):
        for variant in ("tf32x3", None):
            with pytest.raises(ValueError, match="CUDA tensor"):
                flash_attention_fwd_cuda(q, k, k, scale=1.0, variant=variant)
    assert [kern.launches for kern in KERNELS] == before
