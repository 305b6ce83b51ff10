// Flash-attention forward for Hopper (sm_90a) on the tensor cores, for the
// 16-bit inputs that TMA cannot take: causal / sliding-window GQA attention
// in bf16 or fp16 with an online softmax, at any head dims up to 256 and
// any element alignment.
//
// Replaces _flash_fwd_kernel behind flash_attention_fwd_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:89), for bf16 and
// fp16 inputs whose head dims are not multiples of 8 or whose pointers are
// off 16 bytes: a view one element into its buffer (q[..., 1:]), a slice of
// a fused QKV buffer.  For query head h = kh*G + g of batch b:
//
//   s[i, j]   = (q[b, i, h, :] . k[b, j, kh, :]) * scale
//   visible   = j < S  &&  (!causal || i >= j)  &&  (window < 0 || i - j < window)
//   out[b, i, h, :] = sum_j softmax_j(visible ? s : -1e30) * v[b, j, kh, :]
//
// with the running (m, l, acc) of each row in fp32 across KV tiles, as the
// TPU kernel carries them across its sequential kv grid axis, written as
// acc / max(l, 1e-30) in v's dtype.
//
// What bounds it on the card.  At h2o-danube-3-4b's prefill (B = 4,
// S = 2000, 32 query heads over 8 KV heads, D = 120, window 4096) a launch
// does 123 GFLOP of causal pairs over 12 MB: the bf16 tensor-core peak
// bounds it (about 0.12 ms).  The wgmma kernel (flash_attention_sm90.cu)
// cannot take these inputs: TMA needs 16-byte addresses and strides, and a
// bf16 view one element off its buffer sits at 2 mod 16 bytes, which no
// cp.async size fits either.  The CUDA-core kernel (flash_attention.cu)
// takes them at fp32 FMA's 67 TFLOP/s, with each tile widened to fp32 in
// shared memory and loaded one element a thread between two barriers.
//
// This design, for the card:
//   * both products on the tensor cores through mma.sync m16n8k16 (bf16
//     or f16 inputs, fp32 accumulators), in FlashAttention-2's layout: a
//     block of 8 warps owns 256 query rows of one head, each warp 32 (two
//     16-row m tiles, so that each K and V fragment read from shared
//     memory serves two products); S and O stay in registers; a row's max
//     and sum reduce across the quad of threads that holds it (two
//     xor-shuffles), the sum per thread until the end.  Q's A fragments
//     and K's B fragments come from ldmatrix on the [row][d] tiles (K
//     needs no transpose: mma's B is column-major), the next k16 step's
//     read while this step's products run;
//   * P.V from registers: S's accumulator fragment (rows g, g + 8, keys
//     2t, 2t + 1 of each 8-key tile), exponentiated and packed to 16-bit
//     pairs, is P.V's A fragment as it stands.  V's B fragments come from
//     ldmatrix.trans on the [key][dv] tile, one step ahead;
//   * exp2 (ex2.approx) with scale * log2(e) folded in, as the wgmma
//     kernel does: the running max in those units and each p one FFMA
//     and one ex2 (a tile the mask crosses is scaled first, so a masked
//     score is -1e30 in those units).  On 16-bit inputs the tolerance is
//     2e-2, and P.V rounds P to 16 bits anyway.  The products of 16-bit
//     values are exact in fp32; only the order of the sums differs from
//     the TPU kernel;
//   * loads staged through registers and sized per launch (template W, the
//     wrapper's load_width).  W = 16 where every row stride is a multiple
//     of 16 bytes, so that all the rows a block reads start at one offset
//     mod 16: a thread reads the 16-byte-aligned words that cover its piece
//     of a row (ld.global.nc) and shifts them into place in registers
//     (__byte_perm) only when it stores them, so a piece off 16 bytes
//     costs one extra word, not eight times the load instructions.  Else
//     W = 8, 4 or 2 bytes, the widest that every row start allows;
//   * tiles are stored 16-bit and zero-padded (the contraction to a
//     multiple of 64, Dv to chunks of 64 or 128 columns) into shared
//     memory with rows padded by 16 bytes, so the 8 rows an ldmatrix
//     phase reads fall in 8 distinct 16-byte bank groups;
//   * overlap in place of a cp.async ring: two K and two V buffers; the
//     loads of K and V tile t + 1 are issued into registers before tile
//     t's products and stored after them, one barrier a tile;
//   * KV tiles of 32 keys; Dv above 128 split across blocks (blockIdx.y =
//     head x column chunk), each recomputing S for its chunk, so that O
//     takes at most 128 registers a thread.  About 104 KB of shared
//     memory at D = Dv = 120, and one block an SM (registers);
//   * KV tiles wholly above the diagonal or outside the window are not
//     loaded; a warp skips the products of a loaded tile that is dead for
//     its 32 rows; only tiles that cross the diagonal, the window edge or
//     S run the mask.  The masked value is -1e30, never -inf: a wholly
//     masked stretch before a row's first visible key is wiped by
//     corr = exp2(-1e30 - m) = 0, as in the TPU kernel.  Query tiles run
//     last-first, so the longest causal blocks start first.
//
// Measured on an H100 (700 W) by tools/flash_mma_probe.py: mma.sync
// m16n8k16 bf16 peaks near 620 TFLOP/s there (the wgmma kernel's 989 is
// out of its reach); this kernel reaches about 150 TFLOP/s.  Its tile
// costs do not overlap: ldmatrix moves about as many bytes through shared
// memory as the products take cycles, the softmax waits on the whole
// Q.K^T chain, the staged loads and one barrier a tile come on top, and
// registers allow one block of 8 warps an SM (PERF.md).
//
// dtype code: 1 bf16, 2 fp16 (q, k, v and out share it).  D and Dv up to
// 256, any; q, k and v 2-byte aligned, their row starts as load_width
// (the ``width`` argument) says.  The entry returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libflash_mma.so flash_attention_mma.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBlocksPerSM = 8 / kWarps;  // 8 warps an SM
constexpr int kMT = 2;                  // 16-row m tiles a warp
constexpr int kBM = 16 * kMT * kWarps;  // query rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 32;                 // keys a KV tile
constexpr int kTPR = kThreads / kBN;    // threads a row of a kBN-row tile
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 16-byte chunks of a thread's piece of a row: a head dim of up to 128
// (or, WIDE, 256) columns over kTPR threads.
template <bool WIDE>
__host__ __device__ constexpr int span() {
  return (WIDE ? 256 : 128) / (8 * kTPR);
}

// The contraction, padded so that each of a row's kTPR pieces is a whole
// number of 16-byte chunks.
__host__ __device__ __forceinline__ int padded_dim(int D) {
  return (D + 8 * kTPR - 1) / (8 * kTPR) * (8 * kTPR);
}

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ uint16_t one(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  // d += a.b, m16n8k16, fp32 accumulators
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ uint16_t one(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 16-bit matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A thread's piece of one tile row in registers: up to SPAN 16-byte
// chunks, two elements a word, and at W = 16 one chunk more to realign;
// n elements, the first at byte sh mod 16 (W = 16).
template <int W, int SPAN>
struct Piece {
  static constexpr int kWords = 4 * SPAN + (W == 16 ? 4 : 0);
  uint32_t r[kWords];
  int n, sh;
};

// r[0 .. 4 SPAN) = bytes [4 WS + 2 h, ...) of r: the shift by a whole
// number of words is the template's, the half word's a byte_perm selector.
template <int WS, int SPAN, int N>
__device__ __forceinline__ void shift_words(uint32_t (&r)[N], uint32_t sel) {
#pragma unroll
  for (int j = 0; j < 4 * SPAN; ++j)
    r[j] = __byte_perm(r[j + WS], r[j + WS + 1], sel);
}

// Issue the loads of elements [0, n) of a row piece that starts at p
// (n <= 8 SPAN).  W = 16: the aligned 16-byte words that cover the piece's
// bytes; W < 16: W-byte loads (the wrapper has checked that every row
// start is W-aligned).  Only words that hold a byte of the piece are read.
// The words are not touched until finish_piece, so a thread does not wait
// for them before then.
template <int W, int SPAN>
__device__ __forceinline__ void load_piece(Piece<W, SPAN>& pc,
                                           const uint16_t* p, int n) {
  constexpr int N = Piece<W, SPAN>::kWords;
#pragma unroll
  for (int i = 0; i < N; ++i) pc.r[i] = 0u;
  pc.n = n;
  if constexpr (W == 16) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint4* base = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
    pc.sh = static_cast<int>(a & 15);               // even: 2-byte elements
    const int nw = n > 0 ? (pc.sh + 2 * n + 15) >> 4 : 0;
#pragma unroll
    for (int i = 0; i < SPAN + 1; ++i) {
      if (i < nw) {
        const uint4 x = __ldg(base + i);
        pc.r[4 * i] = x.x;
        pc.r[4 * i + 1] = x.y;
        pc.r[4 * i + 2] = x.z;
        pc.r[4 * i + 3] = x.w;
      }
    }
  } else if constexpr (W == 8) {
    const uint2* src = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 2 * SPAN; ++i) {
      if (8 * i < 2 * n) {
        const uint2 x = __ldg(src + i);
        pc.r[2 * i] = x.x;
        pc.r[2 * i + 1] = x.y;
      }
    }
  } else if constexpr (W == 4) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4 * SPAN; ++i)
      if (2 * i < n) pc.r[i] = __ldg(src + i);
  } else {
    static_assert(W == 2, "W is 16, 8, 4 or 2 bytes");
#pragma unroll
    for (int i = 0; i < 8 * SPAN; ++i)
      if (i < n) pc.r[i / 2] |= uint32_t(__ldg(p + i)) << (16 * (i % 2));
  }
}

// The loaded words into place: at W = 16 shifted by sh bytes, then zero
// past n (the next head's elements, or nothing).
template <int W, int SPAN>
__device__ __forceinline__ void finish_piece(Piece<W, SPAN>& pc) {
  if constexpr (W == 16) {
    const uint32_t sel = (pc.sh & 2) ? 0x5432u : 0x3210u;
    switch (pc.sh >> 2) {   // one value for the block's rows: no divergence
      case 0: shift_words<0, SPAN>(pc.r, sel); break;
      case 1: shift_words<1, SPAN>(pc.r, sel); break;
      case 2: shift_words<2, SPAN>(pc.r, sel); break;
      default: shift_words<3, SPAN>(pc.r, sel); break;
    }
  }
#pragma unroll
  for (int j = 0; j < 4 * SPAN; ++j) {
    if (2 * j >= pc.n) pc.r[j] = 0u;
    else if (2 * j + 1 == pc.n) pc.r[j] &= 0xffffu;
  }
}

// One piece a thread of a kBN-row tile: kTPR threads share a row of
// `cols` elements (a multiple of 8 kTPR, at most 8 kTPR SPAN).
template <int W, int SPAN>
struct Tile {
  Piece<W, SPAN> pc;

  // Rows [row0, row0 + kBN) x columns [0, width) of a strided 16-bit
  // source; rows past S and columns past width zero.
  __device__ __forceinline__ void load(const uint16_t* src, int64_t stride,
                                       int row0, int S, int width,
                                       int cols) {
    const int s = row0 + threadIdx.x / kTPR;
    const int e0 = (threadIdx.x % kTPR) * (cols / kTPR);
    const int n = max(0, min(cols / kTPR, width - e0));
    load_piece<W, SPAN>(pc, src + (s < S ? (int64_t)s * stride + e0 : 0),
                        s < S ? n : 0);
  }

  // Into place, then into shared memory (row stride ld elements, a
  // multiple of 8), every column of [0, cols) written.
  __device__ __forceinline__ void store(uint16_t* dst, int ld, int cols) {
    finish_piece<W, SPAN>(pc);
    const int len = cols / kTPR;
    uint4* row = reinterpret_cast<uint4*>(
        dst + (threadIdx.x / kTPR) * ld + (threadIdx.x % kTPR) * len);
#pragma unroll
    for (int c = 0; c < SPAN; ++c)
      if (8 * c < len)
        row[c] = make_uint4(pc.r[4 * c], pc.r[4 * c + 1], pc.r[4 * c + 2],
                            pc.r[4 * c + 3]);
  }
};

// W: load width in bytes; WIDE: D above 128; NV: 16-column groups of the
// block's dv chunk.
template <typename T, int W, bool WIDE, int NV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    flash_fwd_mma_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         uint16_t* __restrict__ o, int S, int H, int KH,
                         int D, int Dv, float scale_log2, int window,
                         int causal, int n_chunks) {
  constexpr int DVC = 16 * NV;            // the block's dv columns
  constexpr int VS = DVC + 8;             // V row stride: 16 bytes of pad
  constexpr int SK = span<WIDE>(), SV = span<false>();
  constexpr int WR = 16 * kMT;            // query rows a warp
  const int DP = padded_dim(D);
  const int QS = DP + 8;                  // Q, K row stride
  extern __shared__ uint4 smem4[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem4);   // [kBM][QS]
  uint16_t* Ks = Qs + kBM * QS;                        // [2][kBN][QS]
  uint16_t* Vs = Ks + 2 * kBN * QS;                    // [2][kBN][VS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // long tiles first
  const int h = blockIdx.y / n_chunks;
  const int c0 = (blockIdx.y - h * n_chunks) * DVC;    // the dv chunk
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + WR * warp;          // the warp's rows r0 .. r0 + WR - 1
  const int vw = min(DVC, Dv - c0);       // the chunk's columns in Dv

  const int n_kv = (S + kBN - 1) / kBN;
  int t_end = n_kv;
  if (causal) t_end = min(n_kv, (q0 + kBM - 1) / kBN + 1);
  int t_begin = 0;
  if (window >= 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / kBN;

  const int64_t q_rs = (int64_t)H * D, k_rs = (int64_t)KH * D;
  const int64_t v_rs = (int64_t)KH * Dv, o_rs = (int64_t)H * Dv;
  const uint16_t* qb = q + ((int64_t)b * S * H + h) * D;
  const uint16_t* kb = k + ((int64_t)b * S * KH + kh) * D;
  const uint16_t* vb = v + ((int64_t)b * S * KH + kh) * Dv + c0;
  uint16_t* ob = o + ((int64_t)b * S * H + h) * Dv + c0;

  // Q (kBM / kBN tiles of kBN rows) and the first K/V tile, every load
  // issued before the first store
  {
    Tile<W, SK> tq[kBM / kBN], tk;
    Tile<W, SV> tv;
#pragma unroll
    for (int r = 0; r < kBM / kBN; ++r)
      tq[r].load(qb, q_rs, q0 + r * kBN, S, D, DP);
    const bool any = t_begin < t_end;
    if (any) {
      tk.load(kb, k_rs, t_begin * kBN, S, D, DP);
      tv.load(vb, v_rs, t_begin * kBN, S, vw, DVC);
    }
#pragma unroll
    for (int r = 0; r < kBM / kBN; ++r)
      tq[r].store(Qs + r * kBN * QS, QS, DP);
    if (any) {
      tk.store(Ks, QS, DP);
      tv.store(Vs, VS, DVC);
    }
  }
  __syncthreads();

  float acc[kMT][2 * NV][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < 2 * NV; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_run[mt][hh] = kNegInf;
      l_run[mt][hh] = 0.f;
    }

  // ldmatrix addresses of this lane: Q rows WR warp + 16 mt + lane % 16,
  // columns + 8 (lane / 16); K keys lane % 8 + 8 (lane / 16), columns
  // + 8 ((lane / 8) % 2); V keys lane % 16, columns + 8 (lane / 16)
  const uint32_t q_addr =
      smem_u32(Qs + (WR * warp + lane % 16) * QS + 8 * (lane / 16));
  const int k_lane = (lane % 8 + 8 * (lane / 16)) * QS + 8 * ((lane / 8) % 2);
  const int v_lane = (lane % 16) * VS + 8 * (lane / 16);

  for (int it = 0, tile = t_begin; tile < t_end; ++it, ++tile) {
    const int kv0 = tile * kBN;
    const int cur = it & 1;
    const bool more = tile + 1 < t_end;
    const uint16_t* Kt = Ks + cur * kBN * QS;
    const uint16_t* Vt = Vs + cur * kBN * VS;
    const bool dead = (causal && kv0 > r0 + WR - 1) ||
                      (window >= 0 && kv0 + kBN - 1 <= r0 - window);

    // the next K and V tiles' loads, in flight across this tile's
    // products and softmax
    Tile<W, SK> tk;
    Tile<W, SV> tv;
    if (more) {
      tk.load(kb, k_rs, kv0 + kBN, S, D, DP);
      tv.load(vb, v_rs, kv0 + kBN, S, vw, DVC);
    }

    // ---- S = Q.K^T: s[mt][j][i] is row 16 mt + g + 8 (i / 2), key
    // kv0 + 8j + 2t + (i % 2); each K fragment serves every m tile ----
    float s[kMT][kBN / 8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] = 0.f;
    if (!dead) {
      const uint32_t k_addr = smem_u32(Kt + k_lane);
      // step kk's Q and K fragments, and its products; the fragments of
      // the next step are read while this step's products run
      uint32_t fa[2][kMT][4], fb[2][kBN / 16][4];
      auto frags = [&](uint32_t (&a)[kMT][4], uint32_t (&bk)[kBN / 16][4],
                       int kk) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldmatrix_x4(a[mt], q_addr + 2 * 16 * mt * QS + 32 * kk);
#pragma unroll
        for (int jj = 0; jj < kBN / 16; ++jj)
          ldmatrix_x4(bk[jj], k_addr + 2 * 16 * jj * QS + 32 * kk);
      };
      auto products = [&](const uint32_t (&a)[kMT][4],
                          const uint32_t (&bk)[kBN / 16][4]) {
#pragma unroll
        for (int jj = 0; jj < kBN / 16; ++jj)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            Ops<T>::mma(s[mt][2 * jj], a[mt], bk[jj][0], bk[jj][1]);
            Ops<T>::mma(s[mt][2 * jj + 1], a[mt], bk[jj][2], bk[jj][3]);
          }
      };
      frags(fa[0], fb[0], 0);
      for (int kk = 0; kk < DP / 16; kk += 2) {     // DP / 16 is even
        frags(fa[1], fb[1], kk + 1);
        products(fa[0], fb[0]);
        if (kk + 2 < DP / 16) frags(fa[0], fb[0], kk + 2);
        products(fa[1], fb[1]);
      }
    }

    if (!dead) {
      // ---- mask, online softmax in base 2, the running max in units of
      // scale log2 e: each p = exp2(s sc - m) one FFMA, sc = scale log2 e;
      // a tile the mask crosses is scaled first (sc = 1), so that a
      // masked score is -1e30 in those units, as the TPU kernel's ----
      const bool edge = (causal && kv0 + kBN - 1 > r0) ||
                        (window >= 0 && kv0 <= r0 + WR - 1 - window) ||
                        kv0 + kBN > S;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (edge) {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = r0 + 16 * mt + g + 8 * (i / 2);
              const int col = kv0 + 8 * j + 2 * t + (i % 2);
              bool ok = col < S;
              if (causal) ok = ok && row >= col;
              if (window >= 0) ok = ok && row - col < window;
              s[mt][j][i] = ok ? s[mt][j][i] * scale_log2 : kNegInf;
            }
        }
        const float sc = edge ? 1.f : scale_log2;
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
            mx = fmaxf(mx, fmaxf(s[mt][j][2 * hh], s[mt][j][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[mt][hh], mx * sc);
          corr[hh] = ex2(m_run[mt][hh] - m_new);
          m_run[mt][hh] = m_new;
        }
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[mt][j][i] = ex2(fmaf(s[mt][j][i], sc, -m_run[mt][i / 2]));
            ps[i / 2] += s[mt][j][i];
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          l_run[mt][hh] = l_run[mt][hh] * corr[hh] + ps[hh];
        // a row whose max did not move keeps its sum: skip when no row of
        // the warp's m tile moved (the multiply by 1 it saves is exact)
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))
#pragma unroll
          for (int n = 0; n < 2 * NV; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][n][i] *= corr[i / 2];
      }

      // ---- O += P.V: k16 step kk over keys 16 kk .. + 15; P's A
      // fragment is S's accumulator packed to 16-bit pairs; each V
      // fragment serves every m tile ----
      uint32_t pa[kBN / 16][kMT][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          pa[kk][mt][0] = Ops<T>::pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[kk][mt][1] = Ops<T>::pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[kk][mt][2] =
              Ops<T>::pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[kk][mt][3] =
              Ops<T>::pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
      // step i = (kk, n): keys 16 kk .. + 15, dv columns 16 n .. + 15; the
      // next step's V fragment is read while this one's products run
      const uint32_t v_addr = smem_u32(Vt + v_lane);
      constexpr int kSteps = kBN / 16 * NV;
      uint32_t bv[2][4];
      ldmatrix_x4_trans(bv[0], v_addr);
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        if (i + 1 < kSteps)
          ldmatrix_x4_trans(bv[(i + 1) % 2],
                            v_addr + 2 * 16 * ((i + 1) / NV) * VS +
                                32 * ((i + 1) % NV));
        const int kk = i / NV, n = i % NV;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          Ops<T>::mma(acc[mt][2 * n], pa[kk][mt], bv[i % 2][0], bv[i % 2][1]);
          Ops<T>::mma(acc[mt][2 * n + 1], pa[kk][mt], bv[i % 2][2],
                      bv[i % 2][3]);
        }
      }
    }
    if (more) {
      tk.store(Ks + (cur ^ 1) * kBN * QS, QS, DP);
      tv.store(Vs + (cur ^ 1) * kBN * VS, VS, DVC);
    }
    __syncthreads();        // the next tile stored, this one read by all
  }

  // ---- epilogue: acc / max(l, 1e-30); thread (g, t) holds columns
  // 8n + 2t, + 1 of rows g and g + 8 of each m tile ----
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[mt][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r0 + 16 * mt + g + 8 * hh;
      if (row >= S) continue;
      const float denom = fmaxf(l, 1e-30f);
      uint16_t* orow = ob + (int64_t)row * o_rs;
#pragma unroll
      for (int n = 0; n < 2 * NV; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= vw) continue;
        const float x0 = acc[mt][n][2 * hh] / denom;
        const float x1 = acc[mt][n][2 * hh + 1] / denom;
        if (col + 1 < vw &&
            (reinterpret_cast<uintptr_t>(orow + col) & 3) == 0) {
          *reinterpret_cast<uint32_t*>(orow + col) = Ops<T>::pack(x0, x1);
        } else {              // an odd Dv: rows alternate in alignment
          orow[col] = Ops<T>::one(x0);
          if (col + 1 < vw) orow[col + 1] = Ops<T>::one(x1);
        }
      }
    }
}

template <typename T, int W, bool WIDE, int NV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KH, int D, int Dv, float scale, int window,
           int causal, cudaStream_t stream) {
  const int DP = padded_dim(D);
  const int n_chunks = (Dv + 16 * NV - 1) / (16 * NV);
  const size_t smem =
      sizeof(uint16_t) * ((size_t)(kBM + 2 * kBN) * (DP + 8) +
                          (size_t)2 * kBN * (16 * NV + 8));
  auto kern = flash_fwd_mma_kernel<T, W, WIDE, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBM - 1) / kBM, H * n_chunks, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), S, H, KH,
      D, Dv, scale * kLog2e, window, causal, n_chunks);
  return (int)cudaGetLastError();
}

// At W = 16 the shapes that fit: D up to 128 with a 64- or 128-column dv
// chunk, or up to 256 with a 128-column one.  The narrow widths, which
// only odd strides need, take the one instantiation that fits every
// shape.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KH, int D, int Dv, float scale, int window,
             int causal, int width, cudaStream_t st) {
  const bool wide = padded_dim(D) > 128, narrow_v = Dv <= 64;
  switch (width) {
    case 16:
      if (wide) return launch<T, 16, true, 8>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st);
      if (narrow_v) return launch<T, 16, false, 4>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st);
      return launch<T, 16, false, 8>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st);
    case 8: return launch<T, 8, true, 8>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st);
    case 4: return launch<T, 4, true, 8>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st);
    case 2: return launch<T, 2, true, 8>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, H, D), k (B, S, KH, D), v (B, S, KH, Dv), out (B, S, H, Dv),
// contiguous; H a multiple of KH; D and Dv up to 256; window < 0 is
// GLOBAL.  width: 16 if every row stride (H D, KH D, KH Dv elements) is a
// multiple of 16 bytes, else 8, 4 or 2 with every pointer and 2 D, 2 Dv a
// multiple of it (the wrapper's load_width).
int flash_attention_fwd_mma(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, int KH, int D,
                            int Dv, float scale, int window, int causal,
                            int dtype, int width, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || Dv <= 0 ||
      D > kMaxDim || Dv > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o);
  if (ptrs % 2) return (int)cudaErrorMisalignedAddress;
  if (width == 16) {
    if ((2LL * H * D) % 16 || (2LL * KH * D) % 16 || (2LL * KH * Dv) % 16)
      return (int)cudaErrorMisalignedAddress;
  } else if (width == 8 || width == 4 || width == 2) {
    const uintptr_t qkv = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
    if (qkv % width || (2 * D) % width || (2 * Dv) % width)
      return (int)cudaErrorMisalignedAddress;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, width, st);
    case 2: return dispatch<__half>(q, k, v, o, B, S, H, KH, D, Dv, scale, window, causal, width, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
