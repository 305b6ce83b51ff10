// Flash-attention forward for Hopper (sm_90a) in fp32 on the tensor cores:
// causal / sliding-window GQA attention with an online softmax, each
// product in 3xTF32 so that it keeps fp32's tolerance of 2e-6.
//
// Replaces _flash_fwd_kernel behind flash_attention_fwd_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:89), for fp32
// inputs.  For query head h = kh*G + g of batch b:
//
//   s[i, j]   = (q[b, i, h, :] . k[b, j, kh, :]) * scale
//   visible   = j < S  &&  (!causal || i >= j)  &&  (window < 0 || i - j < window)
//   out[b, i, h, :] = sum_j softmax_j(visible ? s : -1e30) * v[b, j, kh, :]
//
// with the running (m, l, acc) of each row in fp32 across KV tiles, as the
// TPU kernel carries them across its sequential kv grid axis, written as
// acc / max(l, 1e-30).
//
// What bounds it on the card.  At the serve path's prefill shape (B = 4,
// S = 2000, 24 query heads over 8 KV heads, D = 128) a launch does 98 GFLOP
// of causal pairs over 262 MB of fp32 q, k, v and o: operations bound it.
// One TF32 product keeps about three digits, so each fp32 product is three
// (below): 295 GFLOP of TF32 at 495 TFLOP/s, about 0.6 ms.  The CUDA-core
// kernel (flash_attention.cu) runs the 98 GFLOP as fp32 FMA, whose peak
// (67 TFLOP/s) puts its bound at 1.47 ms.
//
// This design, for the card:
//   * both products on the tensor cores through mma.sync m16n8k8 tf32 with
//     fp32 accumulation, in 3xTF32: each operand is split as
//     hi = tf32(x), lo = tf32(x - hi) (round to nearest, ties away, as
//     cvt.rna.tf32.f32, on the fp32 word), and a.b is lo_a.hi_b +
//     hi_a.lo_b + hi_a.hi_b, the small terms first.  The tensor cores
//     truncate as they add, so the three products of one k8 step go into
//     a fresh accumulator and the step's sum joins the running one by an
//     IEEE add: the truncation is of one step's sum, whose sign varies,
//     and not of the running sum, where it would pile up;
//   * wgmma is not used: for tf32 it takes both operands K-major from
//     shared memory, and V in the model's [key][dv] layout is MN-major for
//     P.V (TMA cannot transpose it).  mma.sync's B fragment reads V's rows
//     as they stand;
//   * FlashAttention-2's layout: a block of 4 warps owns 64 query rows of
//     one head, each warp 16; S and O stay in registers; a row's max and
//     sum reduce across the quad of threads that holds it (two
//     xor-shuffles), the sum per thread until the end;
//   * the order of a contraction is free, so both are permuted to fit the
//     fragments.  Q.K^T: k8 step 2p + e takes d = 16p + 4t + 2e (column t)
//     and + 1 (column t + 4), so thread t of a quad reads Q's and K's
//     words 16p + 4t .. + 3 as one float4 for two steps.  P.V: k8 step j
//     takes key 8j + 2t (column t) and 8j + 2t + 1 (column t + 4), which
//     is S's accumulator fragment as it stands (columns 2t, 2t + 1 of
//     rows g and g + 8), so P needs no shuffle; and n8 tile m of each
//     32-column group of Dv takes column 4g + m, so a thread reads V's
//     words 4g .. 4g + 3 of a row as one float4 for four tiles and holds
//     8 neighbouring output columns of each row at the end;
//   * a ring of two K/V stages in shared memory filled by cp.async.cg
//     16-byte copies (rows past S zero-filled): the copies of the next
//     tile overlap this tile's products.  fp32 is always 4-byte aligned,
//     so where a pointer is off 16 bytes or a head dim is not a multiple
//     of 8 the same ring is filled by 4-byte cp.async.ca copies (template
//     CW, chosen at each launch): four times the copy instructions, the
//     same tiles and products.  Row strides are 16 (Q, K) and
//     4 (V) words mod 32, so the float4 fragment loads hit every bank once
//     a quarter-warp.  Tiles are split in registers as they are read, not
//     stored twice: shared memory's bandwidth is the scarcer;
//   * head dims are padded with zeros: the contraction to a multiple of
//     16 (D = 120 contracts over 128, D = 15 over 16), Dv to groups of 32
//     columns (120: 128, the last 8 computed and not written).  Dv above 128 is split
//     across blocks (blockIdx.y = head x column chunk), each recomputing
//     S for its chunk, so that O takes at most 64 registers a thread;
//   * KV tiles of 32 keys: 108 KB of shared memory at D = 128, so two
//     blocks share an SM (173 KB and one block at D = 256); the loop over
//     the contraction is unrolled twice, so that the next step's loads
//     overlap this one's products;
//   * KV tiles wholly above the diagonal or outside the window are not
//     loaded; a warp skips the products of a loaded tile that is dead for
//     its 16 rows; only tiles that cross the diagonal, the window edge or
//     S run the mask.  The masked value is -1e30, never -inf: a wholly
//     masked stretch before a row's first visible key is wiped by
//     corr = exp(-1e30 - m) = 0, as in the TPU kernel.  Query tiles run
//     last-first, so the longest causal blocks start first;
//   * IEEE expf and division, no fast math; the scores are scaled by an
//     uncontracted multiply, as the plain version rounds them.
//
// Measured on an H100 (700 W) by tools/flash_tf32x3_probe.py: mma.sync
// m16n8k8 tf32 peaks near 315 TFLOP/s there, so the three products take
// at least about 1 ms at the serve path's shape; the kernel takes about
// 2.8 ms: around the products its warps do the splits, the IEEE adds and
// the softmax, and the 8 warps an SM (registers and shared memory allow
// no more) do not hide their latency.
//
// D and Dv up to 256, any; every fp32 input the wrapper takes.  The entry
// returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libflash_tf32x3.so
//        flash_attention_tf32x3.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // query rows a block: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kBN = 32;          // keys a KV tile
constexpr int kStages = 2;       // K/V tiles in the ring
constexpr int kDvChunk = 128;    // dv columns a block at most
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// CW bytes global -> shared, zero-filled when !valid: 16 bypassing L1
// (cp.async.cg), 4 through it (cp.async.ca; cg copies only 16).
template <int CW>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  if constexpr (CW == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    static_assert(CW == 4, "the copies are 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TF32 rounding to nearest, ties away (cvt.rna.tf32.f32), on the fp32 word.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 22 bits: hi = tf32(x), lo = tf32(x - hi); x - hi is
// exact in fp32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d = a.b + c, m16n8k8, tf32 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// acc += a.b for one k8 step in 3xTF32: the three products in a fresh
// accumulator, small terms first, then one IEEE add a value.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4];
  mma_tf32(t, al, bh0, bh1, zero);
  mma_tf32(t, ah, bl0, bl1, t);
  mma_tf32(t, ah, bh0, bh1, t);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// A thread's walk over the (row, chunk) pieces of a tile: it
// starts at piece threadIdx.x and steps by the block, with no division
// a piece.
struct Walk {
  int r, c, r_step, c_step, chunks;
};

__device__ __forceinline__ Walk make_walk(int chunks) {
  return {(int)threadIdx.x / chunks, (int)threadIdx.x % chunks,
          kThreads / chunks, kThreads % chunks, chunks};
}

// Copy rows [row0, row0 + rows) x [0, CW / 4 * w.chunks) of a strided
// fp32 source into shared memory (row stride ld words) in CW-byte pieces;
// rows past S are zero-filled.
template <int CW>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int row0,
                                          int rows, Walk w, int S) {
  int r = w.r, c = w.c;
  while (r < rows) {
    const int s = row0 + r;
    const bool ok = s < S;
    cp_async<CW>(smem_u32(dst + r * ld + CW / 4 * c),
                 src + (ok ? (int64_t)s * row_stride : 0) + CW / 4 * c, ok);
    r += w.r_step;
    c += w.c_step;
    if (c >= w.chunks) {
      c -= w.chunks;
      ++r;
    }
  }
}

// NQ: 32-column groups of the block's dv chunk (1 .. 4); CW: the copies'
// bytes, 16 where every row start is 16-byte aligned, else 4.
template <int NQ, int CW>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, int S, int H, int KH,
                            int D, int Dv, float scale, int window,
                            int causal, int n_chunks) {
  constexpr int DVC = 32 * NQ;
  constexpr int VS = DVC + 4;             // V row stride: 4 mod 32 words
  const int DP = (D + 15) & ~15;          // the contraction, padded
  const int QS = DP % 32 ? DP : DP + 16;  // Q, K row stride: 16 mod 32
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBM][QS]
  float* Ks = Qs + kBM * QS;                     // [kStages][kBN][QS]
  float* Vs = Ks + kStages * kBN * QS;           // [kStages][kBN][VS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // long tiles first
  const int h = blockIdx.y / n_chunks;
  const int c0 = (blockIdx.y - h * n_chunks) * DVC;    // the dv chunk
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;          // the warp's rows r0 .. r0 + 15
  const int vw = min(DVC, Dv - c0);       // the chunk's columns in Dv

  const int n_kv = (S + kBN - 1) / kBN;
  int t_end = n_kv;
  if (causal) t_end = min(n_kv, (q0 + kBM - 1) / kBN + 1);
  int t_begin = 0;
  if (window >= 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / kBN;

  const int64_t q_rs = (int64_t)H * D, k_rs = (int64_t)KH * D;
  const int64_t v_rs = (int64_t)KH * Dv, o_rs = (int64_t)H * Dv;
  const float* qb = q + ((int64_t)b * S * H + h) * D;
  const float* kb = k + ((int64_t)b * S * KH + kh) * D;
  const float* vb = v + ((int64_t)b * S * KH + kh) * Dv + c0;
  float* ob = o + ((int64_t)b * S * H + h) * Dv + c0;

  // the padding columns, which no copy writes, are zero once and for all
  if (DP > D)
    for (int r = threadIdx.x; r < kBM + kStages * kBN; r += kThreads)
      for (int c = D; c < DP; ++c) Qs[r * QS + c] = 0.f;
  if (vw < DVC)
    for (int r = threadIdx.x; r < kStages * kBN; r += kThreads)
      for (int c = vw; c < DVC; ++c) Vs[r * VS + c] = 0.f;

  // Q with the first tile, then a group a stage: kStages groups in flight
  const Walk wk = make_walk(D * 4 / CW), wv = make_walk(vw * 4 / CW);
  load_rows<CW>(Qs, QS, qb, q_rs, q0, kBM, wk, S);
  for (int st = 0; st < kStages; ++st) {
    const int tile = t_begin + st;
    if (tile < t_end) {
      load_rows<CW>(Ks + st * kBN * QS, QS, kb, k_rs, tile * kBN, kBN, wk, S);
      load_rows<CW>(Vs + st * kBN * VS, VS, vb, v_rs, tile * kBN, kBN, wv, S);
    }
    cp_async_commit();                // an empty group keeps the count
  }

  float acc[NQ][4][4];
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][m][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float* q_lo = Qs + (16 * warp + g) * QS + 4 * t;   // row g
  const float* q_hi = q_lo + 8 * QS;                       // row g + 8

  for (int it = 0, tile = t_begin; tile < t_end; ++it, ++tile) {
    const int kv0 = tile * kBN;
    const int stage = it % kStages;
    cp_async_wait<kStages - 1>();
    __syncthreads();                  // every thread's copies of the tile

    const bool dead = (causal && kv0 > r0 + 15) ||
                      (window >= 0 && kv0 + kBN - 1 <= r0 - window);
    if (!dead) {
      const float* Kt = Ks + stage * kBN * QS;
      const float* Vt = Vs + stage * kBN * VS;

      // ---- S = Q.K^T: k8 steps 2p, 2p + 1 from one float4 each ----
      float s[kBN / 8][4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 2
      for (int p = 0; p < DP / 16; ++p) {
        const float4 x = *reinterpret_cast<const float4*>(q_lo + 16 * p);
        const float4 y = *reinterpret_cast<const float4*>(q_hi + 16 * p);
        // A fragment: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4),
        // a3 (g + 8, t + 4); step 2p takes words 4t, 4t + 1, step 2p + 1
        // words 4t + 2, 4t + 3
        uint32_t ah[2][4], al[2][4];
        split(x.x, ah[0][0], al[0][0]);
        split(y.x, ah[0][1], al[0][1]);
        split(x.y, ah[0][2], al[0][2]);
        split(y.y, ah[0][3], al[0][3]);
        split(x.z, ah[1][0], al[1][0]);
        split(y.z, ah[1][1], al[1][1]);
        split(x.w, ah[1][2], al[1][2]);
        split(y.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          // B fragment: b0 (col t, key g), b1 (col t + 4, key g)
          const float4 kf = *reinterpret_cast<const float4*>(
              Kt + (8 * j + g) * QS + 16 * p + 4 * t);
          uint32_t bh[4], bl[4];
          split(kf.x, bh[0], bl[0]);
          split(kf.y, bh[1], bl[1]);
          split(kf.z, bh[2], bl[2]);
          split(kf.w, bh[3], bl[3]);
          mma_3xtf32(s[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
        }
      }

      // ---- scale, mask, online softmax: s[j][i] is row g + 8 (i / 2),
      // key kv0 + 8j + 2t + (i % 2) ----
      const bool edge = (causal && kv0 + kBN - 1 > r0) ||
                        (window >= 0 && kv0 <= r0 + 15 - window) ||
                        kv0 + kBN > S;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = r0 + g + 8 * (i / 2);
            const int col = kv0 + 8 * j + 2 * t + (i % 2);
            bool ok = col < S;
            if (causal) ok = ok && row >= col;
            if (window >= 0) ok = ok && row - col < window;
            s[j][i] = ok ? __fmul_rn(s[j][i], scale) : kNegInf;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = __fmul_rn(s[j][i], scale);
      }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hh], mx);
        corr[hh] = expf(m_run[hh] - m_new);
        m_run[hh] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = expf(s[j][i] - m_run[i / 2]);
          ps[i / 2] += s[j][i];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * corr[hh] + ps[hh];
      // a row whose max did not move keeps its sum: skip when no row of
      // the warp moved (the multiply by 1 it saves is exact)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))
#pragma unroll
      for (int a = 0; a < NQ; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[a][m][i] *= corr[i / 2];

      // ---- O += P.V: k8 step j over keys 8j + 2t (col t), + 1 (t + 4) ----
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);   // row g,     key 8j + 2t
        split(s[j][2], ph[1], pl[1]);   // row g + 8, key 8j + 2t
        split(s[j][1], ph[2], pl[2]);   // row g,     key 8j + 2t + 1
        split(s[j][3], ph[3], pl[3]);   // row g + 8, key 8j + 2t + 1
        const float* v0 = Vt + (8 * j + 2 * t) * VS + 4 * g;
#pragma unroll
        for (int a = 0; a < NQ; ++a) {
          // n8 tile m of group a is dv column 32a + 4g + m
          const float4 x = *reinterpret_cast<const float4*>(v0 + 32 * a);
          const float4 y = *reinterpret_cast<const float4*>(v0 + VS + 32 * a);
          const float xs[4] = {x.x, x.y, x.z, x.w};
          const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t bh0, bl0, bh1, bl1;
            split(xs[m], bh0, bl0);
            split(ys[m], bh1, bl1);
            mma_3xtf32(acc[a][m], ph, pl, bh0, bh1, bl0, bl1);
          }
        }
      }
    }

    __syncthreads();                  // every warp is done with the stage
    if (tile + kStages < t_end) {
      load_rows<CW>(Ks + stage * kBN * QS, QS, kb, k_rs,
                    (tile + kStages) * kBN, kBN, wk, S);
      load_rows<CW>(Vs + stage * kBN * VS, VS, vb, v_rs,
                    (tile + kStages) * kBN, kBN, wv, S);
    }
    cp_async_commit();                // an empty group keeps the count
  }

  // ---- epilogue: acc / max(l, 1e-30); thread (g, t) holds columns
  // 32a + 8t .. + 7 of rows g and g + 8 ----
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + g + 8 * hh;
    if (row >= S) continue;
    const float denom = fmaxf(l_run[hh], 1e-30f);
    float* orow = ob + (int64_t)row * o_rs;
#pragma unroll
    for (int a = 0; a < NQ; ++a) {
      const int col = 32 * a + 8 * t;
      if (col >= vw) continue;
      if constexpr (CW == 4) {        // rows of any Dv: one word a store
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (col + m < vw) orow[col + m] = acc[a][m % 4][2 * hh + m / 4] / denom;
        continue;
      }
      // vw is a multiple of 8 and the rows 16-byte aligned
      float4 lo, hi;
      lo.x = acc[a][0][2 * hh] / denom;
      lo.y = acc[a][1][2 * hh] / denom;
      lo.z = acc[a][2][2 * hh] / denom;
      lo.w = acc[a][3][2 * hh] / denom;
      hi.x = acc[a][0][2 * hh + 1] / denom;
      hi.y = acc[a][1][2 * hh + 1] / denom;
      hi.z = acc[a][2][2 * hh + 1] / denom;
      hi.w = acc[a][3][2 * hh + 1] / denom;
      *reinterpret_cast<float4*>(orow + col) = lo;
      *reinterpret_cast<float4*>(orow + col + 4) = hi;
    }
  }
}

template <int NQ, int CW>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KH, int D, int Dv, float scale, int window,
           int causal, int n_chunks, cudaStream_t stream) {
  const int DP = (D + 15) & ~15, QS = DP % 32 ? DP : DP + 16;
  const size_t smem =
      sizeof(float) * ((size_t)(kBM + kStages * kBN) * QS +
                       (size_t)kStages * kBN * (32 * NQ + 4));
  auto kern = flash_fwd_tf32x3_kernel<NQ, CW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBM - 1) / kBM, H * n_chunks, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KH, D, Dv,
      scale, window, causal, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, D), k (B, S, KH, D), v (B, S, KH, Dv), out (B, S, H, Dv),
// fp32 and contiguous; H a multiple of KH; D and Dv up to 256; window < 0
// is GLOBAL.  dtype must be 0 (fp32).  16-byte copies where D and Dv are
// multiples of 8 and every pointer is 16-byte aligned, 4-byte ones else.
int flash_attention_fwd_tf32x3(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int KH, int D,
                               int Dv, float scale, int window, int causal,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || Dv <= 0 ||
      D > kMaxDim || Dv > kMaxDim || dtype != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o);
  if (ptrs % 4) return (int)cudaErrorMisalignedAddress;
  const bool wide = ptrs % 16 == 0 && D % 8 == 0 && Dv % 8 == 0;
  // Dv in chunks of at most 128 columns, each a whole number of 32-column
  // groups
  const int n_chunks = (Dv + kDvChunk - 1) / kDvChunk;
  const int groups = ((Dv + n_chunks - 1) / n_chunks + 31) / 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (groups * (wide ? 1 : -1)) {
    case 1: return launch<1, 16>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    case 2: return launch<2, 16>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    case 3: return launch<3, 16>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    case 4: return launch<4, 16>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    case -1: return launch<1, 4>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    case -2: return launch<2, 4>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    case -3: return launch<3, 4>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    case -4: return launch<4, 4>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, n_chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
