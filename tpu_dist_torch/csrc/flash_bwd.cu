// Flash-attention backward for Hopper (sm_90a), fp32 arithmetic.
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
// [BH, L] (both fp32; delta is one elementwise-reduce the wrapper computes,
// as `_bwd` computes it outside Pallas at :365):
//
//   P  = exp(scale * Q K^T [+ causal mask] - lse)   recomputed, never stored
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dV = P^T dO,   dK = dS^T Q,   dQ = dS K          in the input dtype
//
// For bf16 inputs P and dS are rounded to bf16 before their products, as
// the TPU kernels cast them (:318, :320, :274); every sum is fp32.
//
// Design. FA2-style and deterministic, with no atomics: two kernels, each
// block owning the rows it writes, so nothing is summed across blocks.
//   * dK/dV: one block per (instance, 64-row key tile). K and V stay in
//     shared memory; a loop over 64-row query tiles (from the diagonal when
//     causal: the TPU kernel's live rule `(i + 1) * tq > ki * tk` at :303)
//     streams Q, dO, lse and delta in, recomputes the [64 x 64] tile of P^T
//     and dP^T, and accumulates dV and dK rows in registers.
//   * dQ: one block per (instance, 64-row query tile); a loop over key
//     tiles up to the diagonal (the rule `j * tk < (qi + 1) * tq` at :258)
//     recomputes P and dP and accumulates dQ rows in registers.
// Four threads own one row of the block's tile: each computes 16 of the
// tile's 64 scores, and each keeps D/4 columns of its row's accumulators.
// Tiles are staged in shared memory as fp32 (bf16 widened on load), rows
// padded to D+1 floats so the rows a warp reads sit in distinct banks. A
// row's P/dS values are written and read by its own four threads (one
// warp), so a __syncwarp orders them.
//
// Ragged L: rows past L load as zeros, scores whose query or key lies past
// L get P = 0 (and so dS = 0), and nothing is written past L: any L >= 1.
//
// Shared memory: dK/dV holds K, V, Q, dO [64][D+1] fp32 plus P^T, dS^T
// [64][65]: 165,888 bytes at D = 128, above the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute and returns its error.
//
// What bounds it on an H100. At the training shape [BH=512, L=512, D=64]
// fp32 causal the backward must read q, k, v, o, dO and lse and write dq,
// dk, dv (about 67 MB) and do five L x L x D products over the causal
// pairs (about 43 GFLOP): ~640 FLOP/byte, far above the ~20 FLOP/byte at
// which fp32 CUDA-core math (67 TFLOP/s) overtakes memory (3.35 TB/s), so
// the bound is the operations. The two kernels recompute S and dP in both
// (seven products where five are needed), and they are fp32 FMAs on the
// CUDA cores fed from shared memory (about one shared load per FMA), so
// they run well below even the fp32 peak; no tensor core is used and fp32
// inputs never go through TF32. Making it fast (wgmma on bf16 operands,
// TMA-fed tiles, one fused pass for L <= 128) is later work.
//
// C interface (loaded with ctypes): tpu_dist_flash_bwd launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;                           // query rows per tile
constexpr int kBlockN = 64;                           // key rows per tile
constexpr int kRowThreads = 4;                        // threads per row
constexpr int kThreads = kBlockM * kRowThreads;       // 256
constexpr int kColsPerThread = kBlockN / kRowThreads;  // 16
constexpr int kPStride = kBlockN + 1;
static_assert(kBlockM == kBlockN, "the causal loop bounds assume square tiles");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// A product operand at the input's precision (the TPU kernels' astype).
template <typename T>
__device__ __forceinline__ float operand(float x);
template <>
__device__ __forceinline__ float operand<float>(float x) { return x; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [row0, row0 + 64) of a [L, D] instance into a [64][D+1] fp32 tile.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int L) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    const int pos = row0 + row;
    dst[row * (D + 1) + col] =
        pos < L ? to_float(src[(int64_t)pos * D + col]) : 0.f;
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * kBlockN * kPStride +
                          2 * kBlockM);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + kBlockM * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int L, int causal, float scale) {
  static_assert(D % kRowThreads == 0, "D must split over a row's threads");
  constexpr int kS = D + 1;
  constexpr int kAcc = D / kRowThreads;

  extern __shared__ float smem[];
  float* ks = smem;                       // K tile   [64][D+1]
  float* vs = ks + kBlockN * kS;          // V tile   [64][D+1]
  float* qs = vs + kBlockN * kS;          // Q tile   [64][D+1]
  float* dos = qs + kBlockM * kS;         // dO tile  [64][D+1]
  float* pts = dos + kBlockM * kS;        // P^T      [64 keys][65]
  float* dsts = pts + kBlockN * kPStride;  // dS^T     [64 keys][65]
  float* lses = dsts + kBlockN * kPStride;  // [64]
  float* deltas = lses + kBlockM;           // [64]

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;   // key row within the tile
  const int c4 = tid % kRowThreads;  // which quarter of the row
  const int64_t base = (int64_t)blockIdx.x * L * D;
  const int64_t sbase = (int64_t)blockIdx.x * L;
  const int k0 = blockIdx.y * kBlockN;
  const int kpos = k0 + r;

  load_tile<T, D>(ks, k + base, k0, L);
  load_tile<T, D>(vs, v + base, k0, L);

  float acc_dk[kAcc], acc_dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  // Query tiles strictly before this key tile's diagonal see none of its
  // keys (the tiles are square, so the first live one starts at k0).
  for (int q0 = causal ? k0 : 0; q0 < L; q0 += kBlockM) {
    __syncthreads();  // the previous tile's Q/dO/P^T/dS^T reads are done
    load_tile<T, D>(qs, q + base, q0, L);
    load_tile<T, D>(dos, dout + base, q0, L);
    if (tid < kBlockM) {
      const int pos = q0 + tid;
      lses[tid] = pos < L ? lse[sbase + pos] : 0.f;
      deltas[tid] = pos < L ? delta[sbase + pos] : 0.f;
    }
    __syncthreads();

    // Row r of S^T and dP^T: key r against query columns c4 + 4 j.
    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[r * kS + d];
      const float vv = vs[r * kS + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int qr = c4 + kRowThreads * j;
        s[j] = fmaf(kv, qs[qr * kS + d], s[j]);
        dp[j] = fmaf(vv, dos[qr * kS + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int qr = c4 + kRowThreads * j;
      const int qpos = q0 + qr;
      const bool ok = qpos < L && kpos < L && (!causal || kpos <= qpos);
      const float p = ok ? expf(s[j] * scale - lses[qr]) : 0.f;
      const float ds = p * (dp[j] - deltas[qr]) * scale;
      pts[r * kPStride + qr] = operand<T>(p);
      dsts[r * kPStride + qr] = operand<T>(ds);
    }
    __syncwarp();  // a key row's P^T/dS^T is written and read by its warp

    for (int c = 0; c < kBlockM; ++c) {
      const float pt = pts[r * kPStride + c];
      const float dst = dsts[r * kPStride + c];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int col = c4 + kRowThreads * i;
        acc_dv[i] = fmaf(pt, dos[c * kS + col], acc_dv[i]);
        acc_dk[i] = fmaf(dst, qs[c * kS + col], acc_dk[i]);
      }
    }
  }

  if (kpos < L) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int64_t g = base + (int64_t)kpos * D + c4 + kRowThreads * i;
      store(dk + g, acc_dk[i]);
      store(dv + g, acc_dv[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int L, int causal, float scale) {
  static_assert(D % kRowThreads == 0, "D must split over a row's threads");
  constexpr int kS = D + 1;
  constexpr int kAcc = D / kRowThreads;

  extern __shared__ float smem[];
  float* qs = smem;                 // Q tile   [64][D+1]
  float* dos = qs + kBlockM * kS;   // dO tile  [64][D+1]
  float* ks = dos + kBlockM * kS;   // K tile   [64][D+1]
  float* vs = ks + kBlockN * kS;    // V tile   [64][D+1]
  float* dss = vs + kBlockN * kS;   // dS       [64 queries][65]

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;   // query row within the tile
  const int c4 = tid % kRowThreads;
  const int64_t base = (int64_t)blockIdx.x * L * D;
  const int q0 = blockIdx.y * kBlockM;
  const int qpos = q0 + r;
  const float row_lse = qpos < L ? lse[(int64_t)blockIdx.x * L + qpos] : 0.f;
  const float row_delta =
      qpos < L ? delta[(int64_t)blockIdx.x * L + qpos] : 0.f;

  load_tile<T, D>(qs, q + base, q0, L);
  load_tile<T, D>(dos, dout + base, q0, L);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // Key tiles strictly past this query tile's diagonal are fully masked.
  const int kend = causal ? min(L, q0 + kBlockM) : L;
  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // the previous tile's K/V/dS reads are done
    load_tile<T, D>(ks, k + base, k0, L);
    load_tile<T, D>(vs, v + base, k0, L);
    __syncthreads();

    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * kS + d];
      const float dov = dos[r * kS + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kr = c4 + kRowThreads * j;
        s[j] = fmaf(qv, ks[kr * kS + d], s[j]);
        dp[j] = fmaf(dov, vs[kr * kS + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int kr = c4 + kRowThreads * j;
      const int kpos = k0 + kr;
      const bool ok = qpos < L && kpos < L && (!causal || kpos <= qpos);
      const float p = ok ? expf(s[j] * scale - row_lse) : 0.f;
      dss[r * kPStride + kr] = operand<T>(p * (dp[j] - row_delta) * scale);
    }
    __syncwarp();  // a query row's dS is written and read by its warp

    for (int c = 0; c < kBlockN; ++c) {
      const float ds = dss[r * kPStride + c];
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = fmaf(ds, ks[c * kS + c4 + kRowThreads * i], acc[i]);
    }
  }

  if (qpos < L) {
    T* out = dq + base + (int64_t)qpos * D;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) store(out + c4 + kRowThreads * i, acc[i]);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, L, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a, int parts) {
  const dim3 grid(a.bh, (a.L + kBlockM - 1) / kBlockM);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (parts & 1) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    // Above 48 KB a block's shared memory must be opted into per kernel.
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.L, a.causal, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & 2) {
    constexpr size_t smem = dq_smem_bytes<D>();
    auto kernel = flash_bwd_dq_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.L, a.causal,
        a.scale);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int D, int parts) {
  switch (D) {
    case 32:
      return launch<T, 32>(a, parts);
    case 64:
      return launch<T, 64>(a, parts);
    case 128:
      return launch<T, 128>(a, parts);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// parts: 1 launches the dK/dV kernel, 2 the dQ kernel, 3 both (the
// backward); the wrapper always passes 3, a benchmark may time one alone.
extern "C" int tpu_dist_flash_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, int bh, int L, int D, int is_bf16,
                                  int causal, float scale, int parts,
                                  void* stream) {
  // grid.y holds the row tiles, and is at most 65535.
  if (bh < 1 || L < 1 || (L + kBlockM - 1) / kBlockM > 65535 || parts < 1 ||
      parts > 3)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  dout,   lse,   delta,
               dq, dk, dv, bh,     L,     causal,
               scale, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = is_bf16
                              ? dispatch_d<__nv_bfloat16>(a, D, parts)
                              : dispatch_d<float>(a, D, parts);
  return (int)err;
}
