// Flash-attention backward for Hopper (sm_90a) on the tensor cores.
//
// Replaces the Pallas TPU kernels of tpu_dist/ops/flash_attention.py:
//   * `_dq_kernel` (:245, launched by `_bwd` at :393)  -> flash_bwd_dq_kernel
//   * `_dkv_kernel` (:285, launched at :412)            -> flash_bwd_dkv_kernel
//   * `_dqkv_single_kernel` (:332, launched at :369 when L is one TPU tile,
//     the benchmark's L = 512): the same two kernels at that L. Here a tile
//     is 64 rows whatever L is, so there is no one-tile special case.
//
// For each of the BH independent instances of q, k, v, o, dO [BH, L, D],
// with lse [BH, L] from the forward kernel and delta = rowsum(dO * O)
// [BH, L] (both fp32; delta is the elementwise-reduce `_bwd` leaves to XLA
// at :365, here flash_bwd_delta_kernel, launched by its own C entry):
//
//   P  = exp(scale * Q K^T [+ causal mask] - lse)   recomputed, never stored
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dV = P^T dO,   dK = dS^T Q,   dQ = dS K          in the input dtype
//
// For bf16 inputs P and dS are rounded to bf16 before their products, as
// the TPU kernels cast them (:318, :320, :274); every sum is fp32.
//
// What bounds it on an H100. At the training shape [BH=512, L=512, D=64]
// fp32 causal the backward reads q, k, v, o, dO, lse and writes dq, dk, dv
// (about 0.54 GB, 0.16 ms at 3.35 TB/s) and does five L x L x D products
// over the causal pairs (about 43 GFLOP): the operations bound it. On the
// CUDA cores (67 TFLOP/s fp32, the design this file had before) that is
// 0.64 ms at best, and those kernels took 5.3 ms. The tensor cores do
// fp32-accurate products as 3xTF32 (three TF32 products per fp32 one:
// 495 / 3 = 165 TFLOP/s) and bf16 at 989 TFLOP/s, so the bound on this
// card's fastest route is 0.26 ms for fp32 and, in bf16, the bytes
// (0.08 ms). What bounds these kernels now (chip_smoke.py phases 2 and 11)
// is the TF32 split: the HMMA are about a tenth of the fp32 kernels'
// instructions and the splits well over half, so the fp32 kernels are
// bound by issue and latency, not by the tensor cores. The next steps are
// `wgmma` and operands split once per tile in shared memory, not by every
// warp that reads them.
//
// Design.
//   * Every product runs on the tensor cores through warp-level
//     `mma.sync`: m16n8k8 TF32 for fp32 inputs, m16n8k16 bf16 for bf16
//     inputs, fp32 accumulation. An fp32 operand x is split into
//     big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big) (that second
//     rounding by two integer ops: see split_tf32), and each
//     product sums small*big + big*small + big*big (the 3xTF32 scheme of
//     CUTLASS's OpMultiplyAddFastF32, here by hand): fp32 accuracy, and no
//     fp32 product ever goes through plain (1x) TF32. `mma.sync` rather than
//     `wgmma`: it takes operands from registers in any row order, which the
//     recomputed P and dS tiles need (they never leave registers), and it
//     needs no K-major shared layout for TF32; `wgmma` is later work.
//   * Two deterministic kernels, no atomics (FA2's split, as before): each
//     block owns the rows it writes, so two calls give the same bits. Each
//     launch puts its heaviest tiles first.
//       - dK/dV: one block per (instance, 64 keys); 4 warps, 16 key rows
//         each. K and V stay in shared memory; a loop over 32-row query tiles
//         (from the diagonal when causal: the TPU kernel's live rule
//         `(i + 1) * tq > ki * tk` at :303) streams Q, dO, lse and delta
//         in. Per tile a warp computes S^T = K Q^T and dP^T = V dO^T for its
//         rows, turns them into P^T and dS^T in registers, and accumulates
//         dV += P^T dO and dK += dS^T Q in registers.
//       - dQ: one block per (instance, 64 queries); 4 warps, 16 query rows
//         each; a loop over 32-row key tiles up to the diagonal (the rule
//         `j * tk < (qi + 1) * tq` at :258) streams K and V in, recomputes
//         S and dP, and accumulates dQ += dS K.
//     Seven products where five are needed (S and dP in both kernels).
//   * P = 2^(S scale log2(e) - lse log2(e)): one FFMA and one `ex2.approx`
//     per score; only tiles that cross the diagonal or L test the mask.
//   * P and dS are used as the A operand straight from the accumulator
//     registers. For bf16 the m16n8k16 accumulator layout of two adjacent
//     8-column tiles is the A layout of one 16-deep step; for TF32 the
//     8-deep step takes a thread's columns (2t, 2t+1) as k = (t, t + 4),
//     and the B operand's rows are read in the same order.
//   * Streamed tiles are double-buffered with 16-byte `cp.async` copies
//     (4-byte ones for lse and delta): the next tile's copy is in flight
//     while this tile's products run. Rows past L are zero-filled by the
//     copy itself.
//   * Shared-memory rows are padded so fragment loads do not conflict on
//     banks: fp32 rows by 4 floats (every scalar TF32 fragment load, in
//     either operand order, hits 32 distinct banks), bf16 rows by 8 values
//     (16 bytes: the eight 16-byte rows of each `ldmatrix` 8x8 matrix hit
//     distinct banks). bf16 fragments come from `ldmatrix` (`.trans` where
//     the tile is k-major).
//
// Ragged L: rows past L load as zeros, scores whose query or key lies past
// L get P = 0 (and so dS = 0), and nothing is written past L: any L >= 1.
//
// Tiles, warps and shared memory (4 warps, 128 threads per block; 64 owned
// rows and 32-row streamed tiles; S the padded row in elements):
//   D     dK/dV bytes fp32 / bf16      dQ bytes fp32 / bf16
//   32     37,376 / 20,992              36,864 / 20,480
//   64     70,144 / 37,376              69,632 / 36,864
//   128   135,680 / 70,144             135,168 / 69,632
// dK/dV: K, V [64][S] + Q, dO [2][32][S] + lse, delta [2][32] fp32;
// dQ: Q, dO [64][S] + K, V [2][32][S]. Above 48 KB the launch opts in with
// cudaFuncSetAttribute (at most 227 KB a block) and returns its error.
//
// C interface (loaded with ctypes): tpu_dist_flash_bwd_delta and
// tpu_dist_flash_bwd launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // 128
constexpr int kBlockRows = 16 * kWarps;  // rows a block owns: 64
// Rows per streamed tile (queries in dK/dV, keys in dQ). 32 rather than 64
// keeps each kernel under 170 registers and 70 KB of shared memory at
// D = 64 fp32, so three blocks share an SM: the MMAs wait on loads and on
// each other, and more warps hide that (on an H100, 32-row tiles ran
// faster than 64-row ones).
constexpr int kStream = 32;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// Padded shared-memory row, in elements (see the note above).
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return is_f32<T>() ? D + 4 : D + 8;
}

template <typename T, int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(T) * (2 * kBlockRows + 4 * kStream) * row_stride<T, D>();
}

template <typename T, int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return dq_smem_bytes<T, D>() + sizeof(float) * 4 * kStream;
}

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Global -> shared copies that zero-fill the destination when !valid (the
// source pointer is then only a placeholder and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 2^x (ex2.approx: relative error about 2^-22; 0 below 2^-126).
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 22 significant bits, each part a TF32 value:
// big = cvt.rna.tf32.f32(x) and small = cvt.rna.tf32.f32(x - big). The
// second rounding is done with two integer ops (half a TF32 ulp added to
// the magnitude bits, the low 13 bits cleared), which gives cvt.rna's bits
// for every finite x - big at under half its cost (the instruction guards
// NaN and infinity, which it compiles to several more). When x is not
// finite, big is not finite either and the products stay so.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
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

// Two fp32 values rounded to nearest bf16, `lo` in the low half: the
// TPU kernels' astype(bf16) of P and dS.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- tiles ----------------------------------------------------------------

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

// Fragment coordinates (PTX mma layouts): lane = 4 g + t. An accumulator
// tile [16 x 8] gives the thread (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// as c[0..3].

// acc[j] += A[16 rows][0..D) . B[8 j .. 8 j + 8][0..D)^T, with A (the
// warp's 16 rows) and B row-major padded tiles in shared memory: S^T = K Q^T
// and dP^T = V dO^T in the dK/dV kernel, S = Q K^T and dP = dO V^T in dQ.
template <typename T, int D, int NT>
__device__ __forceinline__ void gemm_smem(float (&acc)[NT][4],
                                          const T* __restrict__ A,
                                          const T* __restrict__ B, int lane) {
  constexpr int S = row_stride<T, D>();
  if constexpr (is_f32<T>()) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const int k = ks * 8 + t;
      uint32_t ab[4], as[4];
      split_tf32(A[g * S + k], ab[0], as[0]);
      split_tf32(A[(g + 8) * S + k], ab[1], as[1]);
      split_tf32(A[g * S + k + 4], ab[2], as[2]);
      split_tf32(A[(g + 8) * S + k + 4], ab[3], as[3]);
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32(B[(8 * j + g) * S + k], bb[j][0], bs[j][0]);
        split_tf32(B[(8 * j + g) * S + k + 4], bb[j][1], bs[j][1]);
      }
      // The small terms first; the NT tiles are independent, so no MMA
      // waits on the one before it.
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], as, bb[j][0], bb[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ab, bb[j][0], bb[j][1]);
    }
  } else {
    static_assert(NT % 2 == 0, "bf16 B fragments come in pairs of tiles");
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, A + (lane & 15) * S + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t b[4];
        ldmatrix_x4(b, B + (16 * jj + (lane & 7) + (lane >> 4) * 8) * S +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * jj], a, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// out[n] += P[16 x 8 NT] . B[0 .. 8 NT)[8 n .. 8 n + 8), with P in
// accumulator registers (P^T or dS^T in dK/dV, dS in dQ) and B a row-major
// padded tile whose rows are the contraction (dO or Q in dK/dV, K in dQ).
template <typename T, int D, int NT>
__device__ __forceinline__ void gemm_regs(float (&out)[D / 8][4],
                                          const float (&p)[NT][4],
                                          const T* __restrict__ B, int lane) {
  constexpr int S = row_stride<T, D>();
  constexpr int NO = D / 8;
  if constexpr (is_f32<T>()) {
    const int g = lane >> 2, t = lane & 3;
    constexpr int kChunk = NO < 8 ? NO : 8;  // B tiles held at once
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // k = t is column 2t of the tile, k = t + 4 column 2t + 1.
      uint32_t ab[4], as[4];
      split_tf32(p[j][0], ab[0], as[0]);
      split_tf32(p[j][2], ab[1], as[1]);
      split_tf32(p[j][1], ab[2], as[2]);
      split_tf32(p[j][3], ab[3], as[3]);
      const T* b0 = B + (8 * j + 2 * t) * S + g;
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
        for (int i = 0; i < kChunk; ++i)
          mma_tf32(out[n0 + i], as, bb[i][0], bb[i][1]);
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          mma_tf32(out[n0 + i], ab, bs[i][0], bs[i][1]);
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          mma_tf32(out[n0 + i], ab, bb[i][0], bb[i][1]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, B + (16 * kk + (lane & 15)) * S + 16 * nn + (lane >> 4) * 8);
        mma_bf16(out[2 * nn], a, b[0], b[1]);
        mma_bf16(out[2 * nn + 1], a, b[2], b[3]);
      }
    }
  }
}

// Rows row and row + 8 of a warp's [16 x D] accumulator into global memory.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (&acc)[D / 8][4],
                                           int row, int L, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= L) continue;
    T* dst = out + (int64_t)r * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(dst + 8 * n, acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// ---- kernels --------------------------------------------------------------

template <typename T>
struct Params {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  T *dq, *dk, *dv;
  int L, causal;
  float scale;
};

// Blocks start roughly in grid order, y after x, so each kernel puts its
// heaviest tiles first: causal dK/dV work falls with the key tile, dQ work
// grows with the query tile. (One launch holding both kinds of block ran
// markedly slower in fp32 on an H100, most likely because an SM running
// both must hold two large unrolled bodies in its instruction cache.)

// dK and dV of key rows [k0, k0 + 64), k0 = 64 blockIdx.y, of instance
// blockIdx.x.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params<T> pr) {
  const T* __restrict__ q = pr.q;
  const T* __restrict__ k = pr.k;
  const T* __restrict__ v = pr.v;
  const T* __restrict__ dout = pr.dout;
  const float* __restrict__ lse = pr.lse;
  const float* __restrict__ delta = pr.delta;
  const int L = pr.L, causal = pr.causal;
  const float scale = pr.scale;
  constexpr int S = row_stride<T, D>();
  constexpr int BR = kStream;
  constexpr int NT = BR / 8;
  constexpr int NO = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // K tile   [64][S]
  T* vs = ks + kBlockRows * S;         // V tile   [64][S]
  T* qs = vs + kBlockRows * S;         // Q tiles  [2][BR][S]
  T* dos = qs + 2 * BR * S;            // dO tiles [2][BR][S]
  float* lses = reinterpret_cast<float*>(dos + 2 * BR * S);  // [2][BR]
  float* deltas = lses + 2 * BR;                              // [2][BR]
  // P = 2^(S scale log2(e) - lse log2(e)): one FFMA and one MUFU.EX2.
  const float scale_log2 = scale * kLog2e;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)blockIdx.x * L * D;
  const int64_t sbase = (int64_t)blockIdx.x * L;
  const int k0 = blockIdx.y * kBlockRows;
  const int krow = k0 + warp * 16 + g;  // this thread's key rows: +0, +8

  auto load_queries = [&](int q0, int buf) {
    load_tile_async<T, D, BR>(qs + buf * BR * S, q + base, q0, L);
    load_tile_async<T, D, BR>(dos + buf * BR * S, dout + base, q0, L);
    if (threadIdx.x < BR) {
      const int pos = q0 + threadIdx.x;
      const bool ok = pos < L;
      const int64_t src = sbase + (ok ? pos : 0);
      cp_async4(lses + buf * BR + threadIdx.x, lse + src, ok);
      cp_async4(deltas + buf * BR + threadIdx.x, delta + src, ok);
    }
  };

  // Query tiles wholly before this key tile see none of its keys.
  const int q_first = causal ? (k0 / BR) * BR : 0;
  load_tile_async<T, D, kBlockRows>(ks, k + base, k0, L);
  load_tile_async<T, D, kBlockRows>(vs, v + base, k0, L);
  load_queries(q_first, 0);
  cp_async_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int buf = 0;
  for (int q0 = q_first; q0 < L; q0 += BR, buf ^= 1) {
    // The next tile's copy runs while this one's products do; the buffer
    // it fills was released by the previous iteration's closing barrier.
    if (q0 + BR < L) load_queries(q0 + BR, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* qt = qs + buf * BR * S;
    const T* dot = dos + buf * BR * S;
    const float* lt = lses + buf * BR;
    const float* dt = deltas + buf * BR;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    gemm_smem<T, D, NT>(s, ks + warp * 16 * S, qt, lane);   // S^T = K Q^T
    gemm_smem<T, D, NT>(dp, vs + warp * 16 * S, dot, lane);  // dP^T = V dO^T

    // P^T and dS^T in place of S^T and dP^T. Only tiles that straddle
    // the diagonal or L test each score.
    const bool interior = q0 + BR <= L && k0 + kBlockRows <= L &&
                          (!causal || q0 >= k0 + kBlockRows - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;  // and col + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + col);
      const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
      const float dlt[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = krow + 8 * (e >> 1);
        const int qpos = q0 + col + (e & 1);
        const bool ok = interior || (qpos < L && kpos < L &&
                                     (!causal || kpos <= qpos));
        const float p =
            ok ? exp2_approx(s[j][e] * scale_log2 - lse2[e & 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dlt[e & 1]) * scale;
        s[j][e] = p;
      }
    }
    gemm_regs<T, D, NT>(dv_acc, s, dot, lane);  // dV += P^T dO
    gemm_regs<T, D, NT>(dk_acc, dp, qt, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this buffer
  }

  store_rows<T, D>(pr.dk + base, dk_acc, krow, L, t);
  store_rows<T, D>(pr.dv + base, dv_acc, krow, L, t);
}

// dQ of query rows [q0, q0 + 64), the grid's tiles in reverse order, of
// instance blockIdx.x.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params<T> pr) {
  const T* __restrict__ q = pr.q;
  const T* __restrict__ k = pr.k;
  const T* __restrict__ v = pr.v;
  const T* __restrict__ dout = pr.dout;
  const float* __restrict__ lse = pr.lse;
  const float* __restrict__ delta = pr.delta;
  const int L = pr.L, causal = pr.causal;
  const float scale = pr.scale;
  constexpr int S = row_stride<T, D>();
  constexpr int KT = kStream;
  constexpr int NT = KT / 8;
  constexpr int NO = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // Q tile   [64][S]
  T* dos = qs + kBlockRows * S;        // dO tile  [64][S]
  T* kst = dos + kBlockRows * S;       // K tiles  [2][KT][S]
  T* vst = kst + 2 * KT * S;           // V tiles  [2][KT][S]
  const float scale_log2 = scale * kLog2e;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)blockIdx.x * L * D;
  const int64_t sbase = (int64_t)blockIdx.x * L;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int qrow = q0 + warp * 16 + g;  // this thread's query rows: +0, +8

  auto load_keys = [&](int kt0, int buf) {
    load_tile_async<T, D, KT>(kst + buf * KT * S, k + base, kt0, L);
    load_tile_async<T, D, KT>(vst + buf * KT * S, v + base, kt0, L);
  };
  load_tile_async<T, D, kBlockRows>(qs, q + base, q0, L);
  load_tile_async<T, D, kBlockRows>(dos, dout + base, q0, L);
  load_keys(0, 0);
  cp_async_commit();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qrow + 8 * h;
    row_lse[h] = r < L ? lse[sbase + r] * kLog2e : 0.f;
    row_delta[h] = r < L ? delta[sbase + r] : 0.f;
  }
  float dq_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  // Key tiles wholly past this query tile's diagonal are fully masked.
  const int kend = causal ? min(L, q0 + kBlockRows) : L;
  int buf = 0;
  for (int kt0 = 0; kt0 < kend; kt0 += KT, buf ^= 1) {
    if (kt0 + KT < kend) load_keys(kt0 + KT, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* kt = kst + buf * KT * S;
    const T* vt = vst + buf * KT * S;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    gemm_smem<T, D, NT>(s, qs + warp * 16 * S, kt, lane);    // S = Q K^T
    gemm_smem<T, D, NT>(dp, dos + warp * 16 * S, vt, lane);  // dP = dO V^T

    const bool interior = q0 + kBlockRows <= L && kt0 + KT <= L &&
                          (!causal || kt0 + KT - 1 <= q0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qpos = qrow + 8 * h;
        const int kpos = kt0 + 8 * j + 2 * t + (e & 1);
        const bool ok = interior || (qpos < L && kpos < L &&
                                     (!causal || kpos <= qpos));
        const float p =
            ok ? exp2_approx(s[j][e] * scale_log2 - row_lse[h]) : 0.f;
        dp[j][e] = p * (dp[j][e] - row_delta[h]) * scale;
      }
    }
    gemm_regs<T, D, NT>(dq_acc, dp, kt, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this buffer
  }

  store_rows<T, D>(pr.dq + base, dq_acc, qrow, L, t);
}

// delta[r] = sum_d dO[r][d] O[r][d] in fp32 for each of the BH L rows: the
// elementwise-reduce `_bwd` leaves to XLA (:365). kLanes threads share a
// row, each reading 16 bytes of dO and of O, then sum with shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                       float* __restrict__ delta, int64_t rows) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kLanes = D / kChunk;  // 4 to 32, a power of two
  const int64_t row =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int c = (threadIdx.x % kLanes) * kChunk;
  float sum = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + row * D + c);
    const uint4 b = *reinterpret_cast<const uint4*>(o + row * D + c);
    const T* x = reinterpret_cast<const T*>(&a);
    const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) sum += to_f32(x[i]) * to_f32(y[i]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && threadIdx.x % kLanes == 0) delta[row] = sum;
}

// ---- launch ---------------------------------------------------------------

// Opts the kernel into `bytes` of dynamic shared memory (needed above
// 48 KB) and prefers the largest carveout, so the most blocks share an SM;
// then launches it.
template <typename T>
cudaError_t launch_one(void (*kernel)(Params<T>), const Params<T>& pr,
                       dim3 grid, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(pr);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params<T>& pr, int bh, int parts,
                   cudaStream_t stream) {
  const dim3 grid(bh, (pr.L + kBlockRows - 1) / kBlockRows);
  cudaError_t err = cudaSuccess;
  if (parts & 1)
    err = launch_one<T>(flash_bwd_dkv_kernel<T, D>, pr, grid,
                        dkv_smem_bytes<T, D>(), stream);
  if (err == cudaSuccess && (parts & 2))
    err = launch_one<T>(flash_bwd_dq_kernel<T, D>, pr, grid,
                        dq_smem_bytes<T, D>(), stream);
  return err;
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int bh, int L, int D,
                       int causal, float scale, int parts,
                       cudaStream_t stream) {
  const Params<T> pr{static_cast<const T*>(q),
                     static_cast<const T*>(k),
                     static_cast<const T*>(v),
                     static_cast<const T*>(dout),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<T*>(dq),
                     static_cast<T*>(dk),
                     static_cast<T*>(dv),
                     L,
                     causal,
                     scale};
  switch (D) {
    case 32:
      return launch<T, 32>(pr, bh, parts, stream);
    case 64:
      return launch<T, 64>(pr, bh, parts, stream);
    case 128:
      return launch<T, 128>(pr, bh, parts, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int D>
cudaError_t launch_delta(const void* dout, const void* o, void* delta,
                         int64_t rows, cudaStream_t stream) {
  constexpr int kRowsPerBlock = 256 / (D * sizeof(T) / 16);
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_delta(const void* dout, const void* o, void* delta,
                           int64_t rows, int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_delta<T, 32>(dout, o, delta, rows, stream);
    case 64:
      return launch_delta<T, 64>(dout, o, delta, rows, stream);
    case 128:
      return launch_delta<T, 128>(dout, o, delta, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// delta = rowsum(dout * o) [rows] fp32 for dout, o [rows, D] (16-byte
// aligned), the backward's other input besides lse.
extern "C" int tpu_dist_flash_bwd_delta(const void* dout, const void* o,
                                        void* delta, long long rows, int D,
                                        int is_bf16, void* stream) {
  if (rows < 1 || !aligned16(dout) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_delta<__nv_bfloat16>(dout, o, delta, rows,
                                                       D, st)
                       : dispatch_delta<float>(dout, o, delta, rows, D, st));
}

// parts: 1 launches the dK/dV kernel, 2 the dQ kernel, 3 both (the
// backward); the wrapper always passes 3, a benchmark may time one alone.
// q, k, v, dout, dq, dk, dv must be 16-byte aligned (the tile copies are 16
// bytes wide); the wrapper guarantees it.
extern "C" int tpu_dist_flash_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, int bh, int L, int D, int is_bf16,
                                  int causal, float scale, int parts,
                                  void* stream) {
  // grid.y holds the row tiles, and is at most 65535.
  if (bh < 1 || bh > (1 << 30) || L < 1 ||
      (L + kBlockRows - 1) / kBlockRows > 65535 || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
        aligned16(dq) && aligned16(dk) && aligned16(dv)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                                   dq, dk, dv, bh, L, D,
                                                   causal, scale, parts, st)
                       : dispatch_d<float>(q, k, v, dout, lse, delta, dq, dk,
                                           dv, bh, L, D, causal, scale, parts,
                                           st));
}
