// Flash-attention forward for Hopper (sm_90a) on the tensor cores.
//
// Replaces the Pallas TPU kernel tpu_dist/ops/flash_attention.py:148
// `_fwd_kernel`, launched by `_fwd` at :200-240. For each of the BH
// independent instances of q, k, v [BH, L, D] it computes
//
//   O   = softmax(scale * Q K^T [+ causal mask]) V       [BH, L, D], input dtype
//   lse = rowwise logsumexp of the masked scaled scores   [BH, L, 1], fp32
//
// with the online softmax: the [L, L] score matrix never reaches device
// memory. The finalisation is the TPU kernel's (:193-197): l_safe =
// max(l, 1e-30), O = acc / l_safe, lse = m + log(l_safe), so a row with no
// admissible key gives O = 0 and lse = -inf, never NaN.
//
// What bounds it on an H100. At the training shape [BH=512, L=512, D=64]
// fp32 causal it reads q, k, v and writes O and lse (about 0.27 GB, 0.08 ms
// at 3.35 TB/s) and does two L x L x D products over the causal pairs
// (1.72e10 FLOP): the operations bound it. fp32-accurate products on the
// tensor cores are three TF32 products each (3xTF32: 495 / 3 = 165
// TFLOP/s), so the bound is 0.104 ms (0.257 ms on the CUDA cores at 67
// TFLOP/s, the route of this file's first design). In bf16 the products
// run at 989 TFLOP/s and the bytes bound it (0.040 ms). At the serving
// shape [BH=8, L=128..512, D=64] the grid is the limit: 8 instances of 1-4
// query tiles leave most of 132 SMs idle. What bounds this kernel now
// (chip_smoke.py phases 2 and 11) is instruction throughput: the TF32
// splits, fragment loads and the softmax are most of its instructions, the
// HMMA a small share.
//
// Design (the backward's dQ kernel, flash_bwd.cu, with one product fewer
// and an online softmax):
//   * One block per (instance, 128 query rows at D <= 64, 64 at D = 128);
//     4 warps, each owning 16-row m tiles (two at D <= 64, so each K/V
//     fragment loaded and split serves two MMAs; one at D = 128, where two
//     spill the fp32 accumulators). A loop over 32-row key tiles, up to the
//     diagonal under causal masking (the TPU kernel's live rule
//     `j * tk < (qi + 1) * tq`, :169), streams K and V in with 16-byte
//     `cp.async` copies, double-buffered: the next tile's copy is in flight
//     while this tile's products run. Rows past L are zero-filled by the
//     copy itself. A warp skips a key tile wholly past its own rows. Query
//     tiles start heaviest first.
//   * Both products run on the tensor cores through warp-level `mma.sync`:
//     m16n8k8 TF32 for fp32 inputs as 3xTF32 (x = big + small, each a TF32
//     value; each product sums small*big + big*small + big*big, never
//     plain TF32), m16n8k16 bf16 for bf16 inputs; fp32 accumulation.
//   * Q is split once: after its copy lands, each warp splits its own rows
//     (the only ones it reads) into big and small planes in shared memory,
//     so no key tile splits Q again. K and V are split where their
//     fragments are loaded. (Splitting each K/V tile once per block into
//     planes, behind one more barrier, ran slower on an H100 at the
//     training shape: more shared memory, so fewer blocks an SM, and twice
//     the shared-memory loads.) Q and K fragments come from `ldmatrix`
//     (an 8 x 8 b16 matrix is an 8 x 4 fp32 one: lane (g, t) gets row g,
//     word t).
//   * P stays in registers: the S accumulator becomes P and is used as the
//     A operand of PV. For bf16 two adjacent 8-column tiles form one
//     16-deep A fragment, and P is rounded to bf16 first, as the TPU kernel
//     casts it (`p.astype(v_blk.dtype)`, :190); l sums the unrounded fp32 p,
//     as there. For TF32 the 8-deep step reads a thread's columns (2t,
//     2t+1) as k = (t, t + 4), and V's rows are read in the same order.
//   * P = 2^(s scale log2(e) - m scale log2(e)): one FFMA and one
//     `ex2.approx` per score (the running max m is taken over the raw
//     scores, so scale must be positive). Only tiles that cross the
//     diagonal or L test the mask.
//   * A split over keys for small grids: the wrapper picks `splits` from
//     the SM count (1 at training sizes, 4-8 at serving's pads of 128-512).
//     Block z of a query tile then takes the z-th of `splits` equal runs of
//     its live key tiles and writes fp32 partials (unnormalised acc, raw
//     max m, sum l) to a workspace; a second kernel merges them in a fixed
//     order (m = max, l = sum l_i 2^((m_i - m) scale log2 e), acc likewise;
//     a run with no live key, m_i = -inf, is skipped) and applies the
//     finalisation. No atomics anywhere: two calls give the same bits,
//     split or not.
//   * `mma.sync`, not `wgmma`: the TF32 `wgmma` takes both operands K-major
//     from shared memory, which for PV means a transposed copy of V in the
//     swizzled layout it reads; that is the next step.
//
// Shared memory (4 warps, 128 threads; S the padded row in elements: fp32
// D + 4, bf16 D + 8, so every fragment load hits distinct banks): Q
// [rows][S] (fp32: its big and small planes, 2 x [rows][S]) and the K and V
// copies [2][32][S] each.
//   D     rows   fp32      bf16
//   32    128    55,296    20,480
//   64    128    104,448   36,864
//   128   64     135,168   52,224
// Above 48 KB the launch opts in with cudaFuncSetAttribute (at most 227 KB
// a block) and returns its error.
//
// C interface (loaded with ctypes): tpu_dist_flash_fwd launches on the
// given stream, allocates nothing (the wrapper passes the split workspace),
// does not synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kStream = 32;              // key rows per streamed tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return is_f32<T>() ? D + 4 : D + 8;
}

// 16-row m tiles per warp: two at D <= 64, so each K/V fragment loaded
// (and, in fp32, split) serves two MMAs; one at D = 128, where two would
// spill the fp32 accumulators.
template <int D>
__host__ __device__ constexpr int m_tiles() {
  return D <= 64 ? 2 : 1;
}

// Query rows a block owns: 4 warps of 16 m_tiles rows (128 or 64).
template <int D>
__host__ __device__ constexpr int block_rows() {
  return 16 * m_tiles<D>() * kWarps;
}

template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int S = row_stride<T, D>();
  // Q (fp32: its big and small planes) and the double-buffered K, V.
  return sizeof(T) * ((is_f32<T>() ? 2 : 1) * block_rows<D>() +
                      4 * kStream) * S;
}

// ---- PTX wrappers (as in flash_bwd.cu) --------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte global -> shared copy that zero-fills the destination when
// !valid (the source pointer is then only a placeholder and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x (ex2.approx: relative error about 2^-22; 0 below 2^-126 and at -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// x = big + small to about 21 significant bits, each part a TF32 value:
// big = x with its low 13 mantissa bits cleared (one LOP; x - big is then
// exact), small = cvt.rna.tf32.f32(x - big) done by two integer ops (half a
// TF32 ulp added to the magnitude bits, the low 13 bits cleared: the
// instruction's bits for every finite value, as flash_bwd.cu's split_tf32).
// |x - big - small| <= 2^-11 |small| < 2^-21 |x|. (flash_bwd.cu rounds big
// with cvt.rna, which costs several instructions; here the truncation ran
// faster at the training shape on an H100.) A non-finite x
// gives a non-finite big or small, so NaN and infinity still propagate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & ~0x1FFFu;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & ~0x1FFFu;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Two fp32 values rounded to nearest bf16, `lo` in the low half: the TPU
// kernel's astype(bf16) of P.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- tiles ------------------------------------------------------------------

// Rows [row0, row0 + ROWS) of an [L, D] instance into a padded [ROWS][S]
// tile with 16-byte async copies; rows past L are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst,
                                                const T* __restrict__ src,
                                                int row0, int L) {
  constexpr int S = row_stride<T, D>();
  constexpr int kChunk = 16 / sizeof(T);  // elements per copy
  constexpr int kPerRow = D / kChunk;
  static_assert((ROWS * kPerRow) % kThreads == 0, "copies split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * kPerRow / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kPerRow, c = (idx % kPerRow) * kChunk;
    const int pos = row0 + r;
    const bool ok = pos < L;
    cp_async16(dst + r * S + c, src + (int64_t)(ok ? pos : 0) * D + c, ok);
  }
}

// A warp's ROWS rows of the fp32 Q tile [ROWS][S] split in place: big over
// the copy, small into `small`.
template <int D, int ROWS>
__device__ __forceinline__ void split_q_rows(float* tile, float* small,
                                             int lane) {
  constexpr int S = row_stride<float, D>();
  constexpr int kPerRow = D / 4;
#pragma unroll
  for (int i = 0; i < ROWS * kPerRow / 32; ++i) {
    const int idx = lane + i * 32;
    const int off = (idx / kPerRow) * S + (idx % kPerRow) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    uint4 b, s;
    split_tf32(x.x, b.x, s.x);
    split_tf32(x.y, b.y, s.y);
    split_tf32(x.z, b.z, s.z);
    split_tf32(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(tile + off) = b;
    *reinterpret_cast<uint4*>(small + off) = s;
  }
}

// Fragment coordinates (PTX mma layouts): lane = 4 g + t. An accumulator
// tile [16 x 8] gives the thread (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// as c[0..3].

// s[mt][j] += Q[16 rows of m tile mt][0..D) . K[8 j .. 8 j + 8][0..D)^T,
// over the warp's MT m tiles, fragments by
// ldmatrix. fp32: Q as its split planes (qb big, qs small); K the padded
// copy, split where it is loaded (an 8 x 8 b16 matrix is an 8 x 4 fp32 one:
// lane (g, t) gets row g, word t). bf16: qb and kb the padded tiles (qs
// unused).
template <typename T, int D, int MT, int NT>
__device__ __forceinline__ void gemm_qk(float (&s)[MT][NT][4], const T* qb,
                                        const T* qs, const T* kb, int lane) {
  constexpr int S = row_stride<T, D>();
  if constexpr (is_f32<T>()) {
    static_assert(NT % 2 == 0, "B fragments come in pairs of tiles");
    const int arow = (lane & 15) * S + (lane >> 4) * 4;
    const int brow = ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 4;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(ab[mt], qb + mt * 16 * S + arow + kk * 8);
        ldmatrix_x4(as[mt], qs + mt * 16 * S + arow + kk * 8);
      }
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, kb + 16 * jj * S + brow + kk * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(r[e]), bb[2 * jj + e / 2][e % 2],
                     bs[2 * jj + e / 2][e % 2]);
      }
      // The small terms first; the tiles are independent, so no MMA waits
      // on the one before it.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(s[mt][j], as[mt], bb[j][0], bb[j][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(s[mt][j], ab[mt], bs[j][0], bs[j][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(s[mt][j], ab[mt], bb[j][0], bb[j][1]);
    }
  } else {
    static_assert(NT % 2 == 0, "bf16 B fragments come in pairs of tiles");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], qb + (mt * 16 + (lane & 15)) * S + kk * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + (16 * jj + (lane & 7) + (lane >> 4) * 8) * S +
                           kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * jj], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * jj + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

// acc[mt][n] += P[m tile mt][16 x 8 NT] . V[0 .. 8 NT)[8 n .. 8 n + 8), P
// in accumulator registers and V the padded tile. fp32: V split where it is loaded; bf16:
// fragments by ldmatrix.trans.
template <typename T, int D, int MT, int NT>
__device__ __forceinline__ void gemm_pv(float (&acc)[MT][D / 8][4],
                                        const float (&p)[MT][NT][4],
                                        const T* __restrict__ vt, int lane) {
  constexpr int S = row_stride<T, D>();
  constexpr int NO = D / 8;
  if constexpr (is_f32<T>()) {
    const int g = lane >> 2, t = lane & 3;
    constexpr int kChunk = NO < 8 ? NO : 8;  // B tiles held at once
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // k = t is column 2t of the tile, k = t + 4 column 2t + 1.
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(p[mt][j][0], ab[mt][0], as[mt][0]);
        split_tf32(p[mt][j][2], ab[mt][1], as[mt][1]);
        split_tf32(p[mt][j][1], ab[mt][2], as[mt][2]);
        split_tf32(p[mt][j][3], ab[mt][3], as[mt][3]);
      }
      const T* b0 = vt + (8 * j + 2 * t) * S + g;
      const T* b1 = b0 + S;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += kChunk) {
        uint32_t bb[kChunk][2], bs[kChunk][2];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          split_tf32(b0[8 * (n0 + i)], bb[i][0], bs[i][0]);
          split_tf32(b1[8 * (n0 + i)], bb[i][1], bs[i][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            mma_tf32(acc[mt][n0 + i], as[mt], bb[i][0], bb[i][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            mma_tf32(acc[mt][n0 + i], ab[mt], bs[i][0], bs[i][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            mma_tf32(acc[mt][n0 + i], ab[mt], bb[i][0], bb[i][1]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(p[mt][2 * kk][0], p[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(p[mt][2 * kk][2], p[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vt + (16 * kk + (lane & 15)) * S + 16 * nn + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * nn], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nn + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

// ---- kernels ----------------------------------------------------------------

template <typename T>
struct Params {
  const T *q, *k, *v;
  T* o;
  float* lse;       // [BH, L]
  float* part_acc;  // [splits, BH, L, D] unnormalised acc, when splits > 1
  float2* part_ml;  // [splits, BH, L] (raw max m, sum l), when splits > 1
  int L, causal;
  float scale;
};

// O and lse (or, when gridDim.z > 1, the partials of run blockIdx.z) of
// query rows [q0, q0 + block_rows), the grid's tiles in reverse order, of
// instance blockIdx.x.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params<T> pr) {
  const T* __restrict__ q = pr.q;
  const T* __restrict__ k = pr.k;
  const T* __restrict__ v = pr.v;
  const int L = pr.L, causal = pr.causal;
  constexpr int S = row_stride<T, D>();
  constexpr int KT = kStream;
  constexpr int NT = KT / 8;
  constexpr int NO = D / 8;
  constexpr int MT = m_tiles<D>();
  constexpr int WR = 16 * MT;
  constexpr int BR = block_rows<D>();

  extern __shared__ __align__(16) unsigned char smem[];
  T* qb = reinterpret_cast<T*>(smem);  // Q (fp32: big)  [BR][S]
  T* kst = qb + BR * S;                // K copies        [2][KT][S]
  T* vst = kst + 2 * KT * S;           // V copies        [2][KT][S]
  T* qsm = vst + 2 * KT * S;           // fp32: Q small   [BR][S]
  // P = 2^(s scale log2(e) - m scale log2(e)): one FFMA and one MUFU.EX2.
  const float scale_log2 = pr.scale * kLog2e;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)blockIdx.x * L * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int w0 = q0 + warp * WR;  // this warp's first query row
  // This thread's query rows: w0 + g + 8 r, r = 2 mt + h.
  constexpr int R = 2 * MT;

  // This block's key tiles: run blockIdx.z of gridDim.z equal runs of the
  // query tile's live tiles (all of them when there is no split). Key tiles
  // wholly past the diagonal are fully masked.
  const int kend = causal ? min(L, q0 + BR) : L;
  const int ntiles = (kend + KT - 1) / KT;
  const int t_begin = blockIdx.z * ntiles / gridDim.z;
  const int t_end = (blockIdx.z + 1) * ntiles / gridDim.z;

  auto load_keys = [&](int tile, int buf) {
    load_tile_async<T, D, KT>(kst + buf * KT * S, k + base, tile * KT, L);
    load_tile_async<T, D, KT>(vst + buf * KT * S, v + base, tile * KT, L);
  };
  if (t_begin < t_end) {
    load_tile_async<T, D, BR>(qb, q + base, q0, L);
    load_keys(t_begin, 0);
    cp_async_commit();
  }

  // Online-softmax state of the thread's rows: the raw running max m (-inf
  // until a live key), this thread's share of l (its columns; the quad's
  // four shares are summed at the end), and acc.
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = -INFINITY, l[r] = 0.f;
  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  int buf = 0;
  for (int tile = t_begin; tile < t_end; ++tile, buf ^= 1) {
    // This tile (and Q, on the first) has landed, and every warp is done
    // with the buffers the previous tile used.
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < t_end) load_keys(tile + 1, buf ^ 1);
    cp_async_commit();
    T* kt = kst + buf * KT * S;
    T* vt = vst + buf * KT * S;
    if constexpr (is_f32<T>()) {
      // Q is split once, each warp its own rows (the only ones it reads).
      if (tile == t_begin) {
        split_q_rows<D, WR>(qb + warp * WR * S, qsm + warp * WR * S, lane);
        __syncwarp();
      }
    }
    const int kt0 = tile * KT;
    // A tile wholly past this warp's rows is fully masked for it: the warp
    // skips it (its m, l and acc would not change).
    if (causal && kt0 > w0 + WR - 1) continue;

    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
    gemm_qk<T, D, MT, NT>(s, qb + warp * WR * S, qsm + warp * WR * S, kt,
                          lane);  // S = Q K^T

    const bool interior = kt0 + KT <= L && (!causal || kt0 + KT - 1 <= w0);
    float tmax[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tmax[r] = -INFINITY;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mt + (e >> 1);
          if (!interior) {
            const int kpos = kt0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= L || (causal && kpos > w0 + g + 8 * r))
              s[mt][j][e] = -INFINITY;
          }
          tmax[r] = fmaxf(tmax[r], s[mt][j][e]);
        }
      }
    }
    float corr[R], ms[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      // A row with no live key so far keeps m = -inf; shifting by 0 then
      // gives p = 2^-inf = 0 instead of NaN. corr = 0 while m was -inf.
      ms[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      corr[r] = exp2_approx(m[r] * scale_log2 - ms[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mt + (e >> 1);
          s[mt][j][e] = exp2_approx(fmaf(s[mt][j][e], scale_log2, -ms[r]));
          l[r] += s[mt][j][e];
        }
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= corr[2 * mt + (e >> 1)];
    }
    gemm_pv<T, D, MT, NT>(acc, s, vt, lane);  // acc += P V
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int64_t srow = (int64_t)blockIdx.x * L;
  const int64_t prow = (int64_t)blockIdx.z * gridDim.x * L + srow;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= L) continue;
    const int mt = r >> 1, h = r & 1;
    if (gridDim.z == 1) {
      const float l_safe = fmaxf(l[r], 1e-30f);
      T* dst = pr.o + base + (int64_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2(dst + 8 * n, acc[mt][n][2 * h] / l_safe,
               acc[mt][n][2 * h + 1] / l_safe);
      if (t == 0) pr.lse[srow + row] = m[r] * pr.scale + logf(l_safe);
    } else {
      float* dst = pr.part_acc + (prow + row) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2(dst + 8 * n, acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
      if (t == 0) pr.part_ml[prow + row] = make_float2(m[r], l[r]);
    }
  }
}

// Merges the `splits` partials of each of the BH L rows in a fixed order
// and writes O and lse. D / 4 threads share a row, 4 columns each.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_fwd_merge_kernel(const float* __restrict__ part_acc,
                       const float2* __restrict__ part_ml, T* __restrict__ o,
                       float* __restrict__ lse, int64_t rows, int splits,
                       float scale) {
  constexpr int kLanes = D / 4;
  const int64_t row =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  if (row >= rows) return;
  const int c = (threadIdx.x % kLanes) * 4;
  const float scale_log2 = scale * kLog2e;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, part_ml[i * rows + row].x);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < splits; ++i) {
    const float2 ml = part_ml[i * rows + row];
    if (ml.x == -INFINITY) continue;  // no live key in this run
    const float w = exp2_approx((ml.x - m) * scale_log2);
    const float4 a = *reinterpret_cast<const float4*>(
        part_acc + (i * rows + row) * D + c);
    l = fmaf(ml.y, w, l);
    acc.x = fmaf(a.x, w, acc.x);
    acc.y = fmaf(a.y, w, acc.y);
    acc.z = fmaf(a.z, w, acc.z);
    acc.w = fmaf(a.w, w, acc.w);
  }
  const float l_safe = fmaxf(l, 1e-30f);
  T* dst = o + row * D + c;
  store2(dst, acc.x / l_safe, acc.y / l_safe);
  store2(dst + 2, acc.z / l_safe, acc.w / l_safe);
  if (c == 0) lse[row] = m * scale + logf(l_safe);
}

// ---- launch -----------------------------------------------------------------

// Opts flash_fwd_kernel<T, D> into its dynamic shared memory (needed above
// 48 KB) and the largest carveout, so the most blocks share an SM: once per
// device, since the serving path launches it for every layer of every
// prefill. (Two threads racing here only set the same attributes twice.)
template <typename T, int D>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<T, D>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <typename T, int D>
cudaError_t launch(const Params<T>& pr, int bh, int splits,
                   cudaStream_t stream) {
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (pr.L + block_rows<D>() - 1) / block_rows<D>(),
                  splits);
  flash_fwd_kernel<T, D>
      <<<grid, kThreads, smem_bytes<T, D>(), stream>>>(pr);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t rows = (int64_t)bh * pr.L;
  const int64_t blocks = (rows * (D / 4) + 255) / 256;
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  flash_fwd_merge_kernel<T, D><<<(unsigned)blocks, 256, 0, stream>>>(
      pr.part_acc, pr.part_ml, pr.o, pr.lse, rows, splits, pr.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params<T>& pr, int bh, int D, int splits,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(pr, bh, splits, stream);
    case 64:
      return launch<T, 64>(pr, bh, splits, stream);
    case 128:
      return launch<T, 128>(pr, bh, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
Params<T> params(const void* q, const void* k, const void* v, void* o,
                 void* lse, void* part_acc, void* part_ml, int L, int causal,
                 float scale) {
  return Params<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<T*>(o),
                   static_cast<float*>(lse), static_cast<float*>(part_acc),
                   static_cast<float2*>(part_ml), L, causal, scale};
}

}  // namespace

// splits = 1: one kernel writes O and lse. splits > 1: part_acc ([splits,
// bh, L, D] fp32) and part_ml ([splits, bh, L, 2] fp32) receive the runs'
// partials, and the merge kernel writes O and lse. q, k, v, o and part_acc
// must be 16-byte aligned (the tile copies are 16 bytes wide); the wrapper
// guarantees it. scale must be positive (the running max is taken over the
// raw scores).
extern "C" int tpu_dist_flash_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  void* part_acc, void* part_ml, int bh,
                                  int L, int D, int is_bf16, int causal,
                                  float scale, int splits, void* stream) {
  // grid.y holds the query tiles (of 64 rows or more) and grid.z the runs,
  // each at most 65535.
  if (bh < 1 || L < 1 || (L + 63) / 64 > 65535 ||
      splits < 1 || splits > 65535 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorMisalignedAddress;
  if (splits > 1 && (part_acc == nullptr || part_ml == nullptr ||
                     !aligned16(part_acc) ||
                     (reinterpret_cast<uintptr_t>(part_ml) & 7) != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? dispatch_d<__nv_bfloat16>(
                         params<__nv_bfloat16>(q, k, v, o, lse, part_acc,
                                               part_ml, L, causal, scale),
                         bh, D, splits, st)
                   : dispatch_d<float>(params<float>(q, k, v, o, lse,
                                                     part_acc, part_ml, L,
                                                     causal, scale),
                                       bh, D, splits, st));
}
