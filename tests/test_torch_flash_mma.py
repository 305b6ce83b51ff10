"""The numerics, loads and dispatch of the 16-bit flash-attention kernel
on the tensor cores for the inputs TMA cannot take
(``csrc/flash_attention_mma.cu``), on the CPU.

The kernel cannot run here, so its arithmetic is emulated in plain torch:
exact products of 16-bit values summed in fp32 in k16 steps (each step's
sum rounded to fp32 once and added to the running fp32 sum, as
``mma.sync.m16n8k16`` accumulates), the online softmax over 32-key
tiles in base 2, its running max in units of c = scale·log2(e) (one
fp32 factor) and each p = exp2(s·c - m) one fused multiply-add, a tile
the mask crosses scaled first with the kernel's -1e30 as the masked
score, the row sums in fp32, and P rounded to the inputs'
16-bit type before P.V.  The
emulation must sit within the 16-bit tolerance of the JAX package's
kernel test (rtol = atol = 2e-2, ``tests/test_kernels.py``) of the plain
version and of the JAX kernel in interpret mode, at that test's four
shapes and at head dims 15 and 120; the same arithmetic on the view one
element back must land outside it.

Its loads are emulated too, on a byte image of memory: the aligned
16-byte words that cover a row piece, shifted into place (``__byte_perm``
on 32-bit words), or W-byte pieces where ``load_width`` gives W < 16;
every piece must come out equal to the row, zero past its end, at every
element offset and row stride.  The kernel itself is held against the
plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    BY_VARIANT, FLASH_MMA, KERNELS, LIB_MMA, LIBS, flash_attention_fwd_cuda,
    flash_variant, load_width)
from repro_torch.kernels.flash_attention.ref import GLOBAL

torch.set_num_threads(2)

TOL = 2e-2
LOG2E = np.float32(1.4426950408889634)
BN = 32          # keys a KV tile, as in the kernel
TPR = 8          # threads a row of a 32-row tile (8 warps), as in the kernel
NEG_INF = -1e30
#: the JAX package's kernel-test shapes (B, S, K, G, D, window), and head
#: dims 15 (no multiple of 8) and 120 (h2o-danube-3-4b's)
SHAPES = [(1, 128, 1, 1, 32, -1), (2, 256, 2, 3, 64, -1),
          (1, 256, 4, 1, 64, 64), (2, 192, 2, 2, 32, 16),
          (1, 128, 2, 3, 15, -1), (1, 192, 2, 2, 120, 100)]
DTYPES = {"bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "float16": (np.float16, torch.float16)}


def product16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) of 16-bit values (held in fp32) as
    mma.sync.m16n8k16 takes it: k16 steps, each step's exact sum rounded
    to fp32 once and added to an fp32 accumulator."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 16):
        ks = slice(k0, k0 + 16)
        out = out + (a[..., ks].double() @ b[..., ks, :].double()).float()
    return out


def emulated_attention(q, k, v, *, scale, window=GLOBAL, causal=True,
                       dtype=torch.bfloat16):
    """q (B, H, S, D), k (B, K, S, D), v (B, K, S, Dv), 16-bit values in
    fp32 -> (B, H, S, Dv) in ``dtype``: the kernel's arithmetic, tile by
    tile."""
    B, H, S, _ = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    c = float(np.float32(np.float32(scale) * LOG2E))   # scale log2 e
    s_all = product16(q, k.transpose(-1, -2))
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
        s = s_all[..., kv0:kv0 + BN]
        sc = c
        if not bool(ok.all()):        # a tile the mask crosses: scaled first
            s, sc = torch.where(ok, s * c, NEG_INF), 1.0
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sc)
        corr = torch.exp2(m - m_new)
        # one FFMA: s sc - m rounded once
        p = torch.exp2((s.double() * sc - m_new.double()).float())
        l = l * corr + p.sum(-1, keepdim=True)
        p16 = p.to(dtype).float()          # P.V's A fragment is 16-bit
        acc = acc * corr + product16(p16, v[..., kv0:kv0 + BN, :])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(dtype)


def _inputs(B, S, K, G, D, dtype, seed=0, offset=0):
    """numpy (16-bit) and torch (fp32 holding the same values) q, k, v;
    ``offset`` = 1 gives the views moved back one element in their
    buffers."""
    nd, td = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, S, K, G, D), (B, S, K, D), (B, S, K, D)):
        n = int(np.prod(shape))
        buf = rng.normal(size=n + 1).astype(np.float32).astype(nd)
        out.append(buf[1 - offset:n + 1 - offset].reshape(shape))
    return out


def _heads(q, k, v):
    """(B, S, K, G, D) / (B, S, K, D) numpy -> (B, H, S, D) fp32 torch."""
    B, S, K, G, D = q.shape
    f = lambda x: torch.from_numpy(x.astype(np.float32))
    return (f(q).reshape(B, S, K * G, D).transpose(1, 2),
            f(k).transpose(1, 2), f(v).transpose(1, 2))


def _to_bshgd(x, B, S, K, G):
    return x.transpose(1, 2).reshape(B, S, K, G, -1)


def _limit_share(got, want):
    """max |got - want| / (TOL + TOL |want|): above 1 is outside."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


def _torch16(x, td):
    return torch.from_numpy(x.astype(np.float32)).to(td)


def _check(B, S, K, G, D, window, dtype, causal):
    _, td = DTYPES[dtype]
    qn, kn, vn = _inputs(B, S, K, G, D, dtype)
    kw = dict(scale=D ** -0.5, window=window, causal=causal)
    got = _to_bshgd(emulated_attention(*_heads(qn, kn, vn), dtype=td, **kw),
                    B, S, K, G)
    plain = flash_attention(*(_torch16(x, td) for x in (qn, kn, vn)),
                            impl="torch", **kw)
    assert plain.dtype == got.dtype == td
    assert _limit_share(got, plain) <= 1.0
    want = jax_flash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                     impl="pallas_interpret", bq=64, bk=64, **kw)
    want = torch.from_numpy(np.asarray(want).astype(np.float32))
    assert _limit_share(got, want) <= 1.0
    # a planted fault: the views moved back one element land outside
    short = _inputs(B, S, K, G, D, dtype, offset=1)
    bad = _to_bshgd(emulated_attention(*_heads(*short), dtype=td, **kw),
                    B, S, K, G)
    assert _limit_share(bad, plain) > 1.0


@pytest.mark.parametrize("B,S,K,G,D,window", SHAPES)
def test_emulated_kernel_is_inside_the_16_bit_tolerance(B, S, K, G, D,
                                                        window):
    _check(B, S, K, G, D, window, "bfloat16", causal=True)


@pytest.mark.parametrize("B,S,K,G,D,window", [SHAPES[1], SHAPES[4]])
def test_emulated_kernel_in_fp16_and_non_causal(B, S, K, G, D, window):
    _check(B, S, K, G, D, window, "float16", causal=False)


# ---- the loads: a byte image of memory, rows at any offset and stride ----

def byte_perm(x: int, y: int, sel: int) -> int:
    """``__byte_perm(x, y, sel)`` for the two selectors the kernel uses:
    0x3210 keeps x, 0x5432 takes x's high half and y's low half."""
    if sel == 0x3210:
        return x
    assert sel == 0x5432
    return ((x >> 16) | (y << 16)) & 0xFFFFFFFF


def span(wide: bool) -> int:
    """16-byte chunks of a thread's piece of a row, as the kernel's."""
    return (256 if wide else 128) // (8 * TPR)


def padded_dim(d: int) -> int:
    return -(-d // (8 * TPR)) * (8 * TPR)


def load_piece(mem: np.ndarray, addr: int, n: int, width: int,
               sp: int) -> list:
    """The kernel's ``load_piece``: elements [0, n) of the 16-bit row piece
    at byte ``addr`` of ``mem`` (n <= 8 sp) -> 4 sp 32-bit words, two
    elements a word, zero past n, and the mask of the bytes read."""
    words = [0] * (4 * sp + (4 if width == 16 else 0))
    read = np.zeros(len(mem), dtype=bool)

    def word(a):                   # one 32-bit little-endian word
        read[a:a + 4] = True
        return int.from_bytes(mem[a:a + 4].tobytes(), "little")

    if width == 16:
        base, sh = addr & ~15, addr & 15
        assert sh % 2 == 0
        nw = (sh + 2 * n + 15) >> 4 if n > 0 else 0
        for i in range(min(nw, sp + 1)):
            for j in range(4):
                words[4 * i + j] = word(base + 16 * i + 4 * j)
        sel = 0x5432 if sh & 2 else 0x3210
        ws = sh >> 2
        words = [byte_perm(words[j + ws], words[j + ws + 1], sel)
                 for j in range(4 * sp)]
    else:
        assert addr % width == 0
        for i in range(0, 2 * n, width):      # W-byte pieces over 2n bytes
            if width == 2:
                read[addr + i:addr + i + 2] = True
                v = int.from_bytes(mem[addr + i:addr + i + 2].tobytes(),
                                   "little")
                words[i // 4] |= v << (16 * ((i // 2) % 2))
            else:
                for j in range(0, width, 4):
                    words[(i + j) // 4] = word(addr + i + j)
    for j in range(4 * sp):
        if 2 * j >= n:
            words[j] = 0
        elif 2 * j + 1 == n:
            words[j] &= 0xFFFF
    return words[:4 * sp], read


def _row_pieces(cols):
    """(e0, len) of the TPR threads' pieces of one row of ``cols``."""
    return [(p * (cols // TPR), cols // TPR) for p in range(TPR)]


@pytest.mark.parametrize("d", [15, 36, 64, 120, 128, 200, 256])
@pytest.mark.parametrize("heads", [1, 3, 8])
@pytest.mark.parametrize("offset", range(8))
def test_realigned_row_loads_equal_the_rows(offset, heads, d):
    """Every row of a (S, heads, d) 16-bit tensor that starts ``offset``
    elements into a buffer, loaded in pieces as the kernel loads a Q or K
    tile at ``load_width``'s width: each piece equals its elements of the
    row, zero past d, and only bytes of the tensor (or of the aligned
    words that hold them) are read."""
    S, esz = 5, 2
    rng = np.random.default_rng(offset * 1000 + heads * 10 + d)
    mem = rng.integers(0, 256, size=32 + 2 * (offset + S * heads * d) + 32,
                       dtype=np.uint8)
    start = 32 + 2 * offset                    # the buffer is 16-aligned
    width = load_width([start], esz, heads, heads, d, d)
    if heads * d * esz % 16 == 0:
        assert width == 16
    dp = padded_dim(d)
    sp = span(width < 16 or dp > 128)
    elems = mem[start:start + 2 * S * heads * d].view(np.uint16)
    rows = elems.reshape(S * heads, d)
    touched = np.zeros(len(mem), dtype=bool)
    for r in range(S * heads):
        row_addr = start + 2 * r * d
        got = []
        for e0, ln in _row_pieces(dp):
            assert ln <= 8 * sp
            n = max(0, min(ln, d - e0))
            words, read = load_piece(mem, row_addr + 2 * e0, n, width, sp)
            touched |= read
            got.append(np.array(words[:ln // 2], dtype=np.uint32)
                       .view(np.uint16))
        want = np.zeros(dp, dtype=np.uint16)
        want[:d] = rows[r]
        np.testing.assert_array_equal(np.concatenate(got), want)
    # reads stay within the 16-byte words that hold the tensor's bytes
    lo, hi = start & ~15, (start + 2 * S * heads * d + 15) & ~15
    assert not touched[:lo].any() and not touched[hi:].any()


@pytest.mark.parametrize("dv", [15, 36, 64, 120, 200])
@pytest.mark.parametrize("offset", range(8))
def test_realigned_v_chunk_loads_equal_the_rows(offset, dv):
    """V's dv chunks (64 or 128 columns a block, TPR threads a row) at
    every offset: each chunk's pieces equal the row's columns, zero past
    Dv."""
    S, kh, esz = 3, 2, 2
    rng = np.random.default_rng(offset + dv)
    mem = rng.integers(0, 256, size=64 + 2 * (offset + S * kh * dv),
                       dtype=np.uint8)
    start = 32 + 2 * offset
    width = load_width([start], esz, kh, kh, dv, dv)
    dvc = 64 if dv <= 64 and width == 16 else 128
    rows = mem[start:start + 2 * S * kh * dv].view(np.uint16).reshape(-1, dv)
    for r in range(S * kh):
        for c0 in range(0, dv, dvc):
            vw = min(dvc, dv - c0)
            got = []
            for e0, ln in _row_pieces(dvc):
                n = max(0, min(ln, vw - e0))
                words, _ = load_piece(mem, start + 2 * (r * dv + c0 + e0), n,
                                      width, span(False))
                got.append(np.array(words[:ln // 2], dtype=np.uint32)
                           .view(np.uint16))
            want = np.zeros(dvc, dtype=np.uint16)
            want[:vw] = rows[r, c0:c0 + vw]
            np.testing.assert_array_equal(np.concatenate(got), want)


@pytest.mark.parametrize("h,kh,d,dv,ptrs,width", [
    (32, 8, 120, 120, (2, 18, 34), 16),    # h2o-danube off 16 bytes
    (16, 16, 64, 64, (2, 0, 0), 16),       # seamless's encoder off 16
    (6, 2, 15, 15, (0, 0, 0), 2),          # an odd head dim
    (3, 1, 36, 36, (0, 0, 0), 8),          # strides off 16, rows on 8
    (3, 1, 36, 36, (4, 0, 0), 4),          # one pointer on 4
    (3, 1, 18, 18, (0, 0, 0), 4),          # 36-byte rows
    (3, 1, 36, 15, (0, 0, 0), 2),          # v's 30-byte rows
    (4, 2, 36, 120, (2, 0, 0), 16)])       # Dv unlike D, strides on 16
def test_load_width_is_the_widest_every_row_allows(h, kh, d, dv, ptrs,
                                                   width):
    assert load_width([256 + p for p in ptrs], 2, h, kh, d, dv) == width


@pytest.mark.parametrize("d,dv,aligned", [(15, 15, True), (120, 36, True),
                                          (36, 120, True), (4, 8, True),
                                          (128, 128, False),
                                          (256, 256, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dispatch_sends_16_bit_inputs_tma_cannot_take_to_mma(dtype, d, dv,
                                                             aligned):
    assert flash_variant(dtype, d, dv, aligned) == "mma"
    assert flash_variant(torch.float32, d, dv, aligned) == "tf32x3"


def test_the_kernel_is_registered_with_the_others():
    assert BY_VARIANT["mma"] is FLASH_MMA
    assert FLASH_MMA in KERNELS and LIB_MMA in LIBS
    assert FLASH_MMA.lib is LIB_MMA and LIB_MMA.extra_flags == ()
    assert LIB_MMA.src.name == "flash_attention_mma.cu"
    assert LIB_MMA.src.is_file()
    assert FLASH_MMA.name == "flash_attention_fwd_mma"
    assert FLASH_MMA.replaces == \
        "src/repro/kernels/flash_attention/flash_attention.py:89"
    # the load width goes between the dtype code and the stream
    args = LIB_MMA.signatures["flash_attention_fwd_mma"]
    assert len(args) == 16 and isinstance(LIB_MMA, CudaLibrary)


def test_wrapper_takes_mma_for_16_bit_and_refuses_it_for_fp32():
    before = [kern.launches for kern in KERNELS]
    buf = torch.zeros(1 + 8 * 16, dtype=torch.bfloat16)
    views = (buf[1:].view(1, 8, 1, 1, 16), buf[1:].view(1, 8, 1, 16))
    aligned = (torch.zeros(1, 8, 1, 1, 16, dtype=torch.bfloat16),
               torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16))
    for q, k in (views, aligned):         # chosen off 16 bytes, or named
        for variant in ("mma", None):
            with pytest.raises(ValueError, match="CUDA tensor"):
                flash_attention_fwd_cuda(q, k, k, scale=1.0, variant=variant)
    q, k = torch.zeros(1, 8, 1, 1, 16), torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="mma kernel does not take"):
        flash_attention_fwd_cuda(q, k, k, scale=1.0, variant="mma")
    # wgmma stays refused for what TMA cannot take
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        flash_attention_fwd_cuda(*views, views[1], scale=1.0,
                                 variant="wgmma")
    assert [kern.launches for kern in KERNELS] == before
