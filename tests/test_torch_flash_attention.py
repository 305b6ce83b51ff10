"""The port's flash-attention forward and LM layers against the JAX
package's.

Inputs are made from a seed with numpy and go through both packages:
the JAX kernel in interpret mode (``impl="pallas_interpret"``, 64-row
tiles, as its own kernel tests run it), the port through its plain
PyTorch version, each case causal and not (seamless-m4t-large-v2's
encoder attends without a causal mask).  Shapes and tolerances are those of
``tests/test_kernels.py:112-136``: rtol = atol = 2e-6 in fp32 (fp32
sums in another order), 2e-2 in bf16 and fp16 (one 16-bit rounding of
the output), plus the head dims of the port's configs (120 and 256) and
hymba-1.5b's group of 5 query heads a KV head.
The choice among the CUDA kernels is a pure function of dtype, head
dims and alignment, tested here; the kernels themselves are held
against the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    KERNELS, flash_attention_fwd_cuda, flash_variant)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as tlayers

# the suite runs in parallel workers that share the host's cores:
# the port's tests take two threads, not all of them
torch.set_num_threads(2)

SHAPES = [(1, 128, 1, 1, 32, -1), (2, 256, 2, 3, 64, -1),
          (1, 256, 4, 1, 64, 64), (2, 192, 2, 2, 32, 16)]
DTYPES = {"float32": (np.float32, torch.float32, 2e-6),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2e-2)}
FP16 = (np.float16, torch.float16, 2e-2)
#: the port's configs' head dims: h2o-danube-3-4b (120, window 4096)
#: and gemma3 (256), at a ragged S
WIDE_SHAPES = [(1, 333, 2, 2, 120, 100), (1, 200, 1, 2, 256, -1)]
#: hymba-1.5b's odd group count: 25 query heads over 5 KV heads, D 64,
#: a sliding window crossed by the sequence
HYMBA_SHAPE = (1, 256, 5, 5, 64, 64)
#: every JAX-against-port case runs causal and not
CAUSAL = pytest.mark.parametrize("causal", [True, False],
                                 ids=["causal", "noncausal"])


def _both(x: np.ndarray, dtype: str):
    """The same rounded values in both packages."""
    nd, td, _ = DTYPES.get(dtype, FP16)
    xn = x.astype(nd)
    if dtype == "bfloat16":
        return jnp.asarray(xn), torch.from_numpy(xn.view(np.int16)).view(td)
    return jnp.asarray(xn), torch.from_numpy(xn)


def _qkv(B, S, K, G, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [_both(rng.normal(size=shape), dtype) for shape in
            ((B, S, K, G, D), (B, S, K, D), (B, S, K, D))]


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@CAUSAL
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,K,G,D,window", SHAPES)
def test_plain_flash_matches_jax_pallas_kernel(B, S, K, G, D, window, dtype,
                                               causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, S, K, G, D, dtype)
    scale = D ** -0.5
    want = jax_flash(qj, kj, vj, window=window, causal=causal, scale=scale,
                     impl="pallas_interpret", bq=64, bk=64)
    got = flash_attention(qt, kt, vt, window=window, causal=causal,
                          scale=scale, impl="torch")
    assert got.dtype == vt.dtype and got.shape == (B, S, K, G, D)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # the (B, H, S, D) oracle itself, on the upcast inputs
    ref = attention_ref(
        qt.float().reshape(B, S, K * G, D).transpose(1, 2),
        kt.float().transpose(1, 2), vt.float().transpose(1, 2),
        scale=scale, window=window, causal=causal,
    ).transpose(1, 2).reshape(B, S, K, G, D)
    np.testing.assert_allclose(ref.numpy(), _f32(want), rtol=tol, atol=tol)


def _against_jax(B, S, K, G, D, window, dtype, causal, **blocks):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, S, K, G, D, dtype)
    scale = D ** -0.5
    want = jax_flash(qj, kj, vj, window=window, causal=causal, scale=scale,
                     impl="pallas_interpret", **blocks)
    got = flash_attention(qt, kt, vt, window=window, causal=causal,
                          scale=scale, impl="torch")
    assert got.dtype == vt.dtype and got.shape == (B, S, K, G, D)
    tol = DTYPES.get(dtype, FP16)[2]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@CAUSAL
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,K,G,D,window", WIDE_SHAPES)
def test_plain_flash_matches_jax_pallas_kernel_at_wide_heads(B, S, K, G, D,
                                                             window, dtype,
                                                             causal):
    """The JAX kernel with its default blocks (bq 128, and bk 512, which
    covers S): in interpret mode a ragged key block reads the
    interpreter's NaN padding."""
    _against_jax(B, S, K, G, D, window, dtype, causal)


@CAUSAL
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_flash_matches_jax_pallas_kernel_at_hymbas_odd_group(dtype,
                                                                   causal):
    _against_jax(*HYMBA_SHAPE, dtype, causal, bq=64, bk=64)


@CAUSAL
@pytest.mark.parametrize("B,S,K,G,D,window", [SHAPES[1], SHAPES[3]])
def test_plain_flash_matches_jax_pallas_kernel_in_fp16(B, S, K, G, D,
                                                       window, causal):
    _against_jax(B, S, K, G, D, window, "float16", causal, bq=64, bk=64)


@pytest.mark.parametrize("dim", [32, 64, 120, 128, 256])
def test_dispatch_sends_16_bit_inputs_to_the_tensor_cores(dim):
    for dtype in (torch.bfloat16, torch.float16):
        assert flash_variant(dtype, dim, dim) == "wgmma"
        assert flash_variant(dtype, dim, 64) == "wgmma"
    # fp32 on the tensor cores too, in 3xTF32 (one TF32 pass misses
    # fp32's tolerance of 2e-6; tests/test_torch_flash_tf32x3.py)
    assert flash_variant(torch.float32, dim, dim) == "tf32x3"


@pytest.mark.parametrize("d,dv,aligned", [(15, 15, True), (120, 36, True),
                                          (128, 128, False)])
def test_dispatch_sends_what_tma_cannot_take_to_the_cuda_cores(d, dv,
                                                               aligned):
    """TMA needs 16-byte strides and addresses: 16-bit inputs with head
    dims that are not multiples of 8, or a pointer off 16 bytes, go to the
    mma.sync kernel on the tensor cores, which realigns its loads; the
    CUDA-core kernel is on no route."""
    for dtype in (torch.bfloat16, torch.float16):
        assert flash_variant(dtype, d, dv, aligned) == "mma"


def test_dispatch_raises_over_256_and_on_other_dtypes():
    for d, dv in ((264, 128), (128, 264), (512, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="up to 256"):
                flash_variant(dtype, d, dv)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        flash_variant(torch.float64, 64, 64)


def test_wrapper_refuses_wgmma_for_what_only_the_cuda_cores_take():
    q, k = torch.zeros(1, 8, 1, 1, 16), torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        flash_attention_fwd_cuda(q, k, k, scale=1.0, variant="wgmma")
    with pytest.raises(ValueError, match="unknown variant"):
        flash_attention_fwd_cuda(q, k, k, scale=1.0, variant="tc")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_fwd_cuda(q.bfloat16(), k.bfloat16(), k.bfloat16(),
                                 scale=1.0, variant="wgmma")


def test_auto_on_a_cpu_tensor_is_the_plain_version():
    (_, q), (_, k), (_, v) = _qkv(2, 70, 2, 3, 16, "float32", seed=1)
    kw = dict(window=9, causal=True, scale=0.25)
    assert torch.equal(flash_attention(q, k, v, **kw),
                       flash_attention(q, k, v, impl="torch", **kw))


def test_gqa_maps_query_head_kg_to_kv_head_k():
    """Query head h = k·G + g reads KV head h // G: each query group is
    plain attention over its own KV head."""
    (_, q), (_, k), (_, v) = _qkv(1, 40, 3, 2, 8, "float32", seed=2)
    out = flash_attention(q, k, v, scale=0.3, impl="torch")
    for kh in range(3):
        for g in range(2):
            one = flash_attention(q[:, :, kh:kh + 1, g:g + 1], k[:, :, kh:kh + 1],
                                  v[:, :, kh:kh + 1], scale=0.3, impl="torch")
            torch.testing.assert_close(out[:, :, kh, g], one[:, :, 0, 0],
                                       rtol=1e-6, atol=1e-6)


def test_cuda_impl_on_a_cpu_tensor_raises():
    (_, q), (_, k), (_, v) = _qkv(1, 16, 1, 1, 8, "float32")
    before = [kern.launches for kern in KERNELS]
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q, k, v, scale=1.0, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, k, v, scale=1.0, impl="pallas")
    assert [kern.launches for kern in KERNELS] == before


@pytest.mark.parametrize("case,err,match", [
    ("dtype", TypeError, "share a dtype"),
    ("float64", TypeError, "fp32, bf16 or fp16"),
    ("strided", ValueError, "contiguous"),
    ("head_dim", ValueError, "up to 256"),
    ("shape", ValueError, "do not match"),
    ("window", ValueError, "window"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case, err,
                                                              match):
    q, k, v = (torch.zeros(1, 8, 1, 2, 16), torch.zeros(1, 8, 1, 16),
               torch.zeros(1, 8, 1, 16))
    kw = {}
    if case == "dtype":
        k = k.double()
    elif case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "strided":
        k = torch.zeros(1, 8, 1, 32)[..., ::2]
    elif case == "head_dim":
        q, k, v = (torch.zeros(1, 8, 1, 2, 300), torch.zeros(1, 8, 1, 300),
                   torch.zeros(1, 8, 1, 300))
    elif case == "shape":
        k = torch.zeros(1, 9, 1, 16)
    else:
        kw["window"] = -5
    with pytest.raises(err, match=match):
        flash_attention_fwd_cuda(q, k, v, scale=1.0, **kw)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

LAYER_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    xj, xt = _both(rng.normal(size=(2, 5, 24)) * 3, dtype)
    sj, st = _both(rng.normal(size=(24,)), dtype)
    tol = LAYER_TOL[dtype]
    np.testing.assert_allclose(
        _f32(tlayers.rmsnorm({"scale": st}, xt, 1e-6)),
        _f32(jlayers.rmsnorm({"scale": sj}, xj, 1e-6)), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _f32(tlayers.rmsnorm_headwise(st[:8], xt.reshape(2, 5, 3, 8), 1e-5)),
        _f32(jlayers.rmsnorm_headwise(sj[:8], xj.reshape(2, 5, 3, 8), 1e-5)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("head_dim", [16, 15])
def test_apply_rope_matches_jax(head_dim, dtype):
    """Even head dims rotate by halves; an odd one keeps its tail lane."""
    rng = np.random.default_rng(head_dim)
    xj, xt = _both(rng.normal(size=(2, 300, 3, head_dim)), dtype)
    pos = np.arange(1700, 2000, dtype=np.int32)
    got = tlayers.apply_rope(xt, torch.from_numpy(pos), 5e5)
    want = jlayers.apply_rope(xj, jnp.asarray(pos), 5e5)
    # fp32 sin/cos of angles up to 2000 rad: a few ulps of the angle
    tol = 1e-5 if dtype == "float32" else LAYER_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    if head_dim % 2:
        assert torch.equal(got[..., -1], xt[..., -1])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ffn_matches_jax(dtype):
    rng = np.random.default_rng(5)
    xj, xt = _both(rng.normal(size=(2, 7, 32)), dtype)
    pj, pt = {}, {}
    for name, shape in (("gate", (32, 48)), ("up", (32, 48)),
                        ("down", (48, 32))):
        pj[name], pt[name] = _both(rng.normal(size=shape) / 6, dtype)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(tlayers.ffn(pt, xt)),
                               _f32(jlayers.ffn(pj, xj)), rtol=tol, atol=tol)


def test_dense_init_is_a_truncated_fan_in_normal():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, (400, 300), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (400, 300)
    std = 400 ** -0.5
    assert float(w.float().abs().max()) <= 2 * std * 1.004
    # a normal cut at ±2σ keeps 0.8796 of its σ
    assert abs(float(w.float().std()) / std - 0.8796) < 0.01
