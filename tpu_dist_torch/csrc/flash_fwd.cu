// Flash-attention forward for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the Pallas TPU kernel tpu_dist/ops/flash_attention.py:148
// `_fwd_kernel`, launched by `_fwd` at :210. For each of the BH
// independent instances of q, k, v [BH, L, D] it computes
//
//   O   = softmax(scale * Q K^T [+ causal mask]) V       [BH, L, D], input dtype
//   lse = rowwise logsumexp of the masked scaled scores   [BH, L, 1], fp32
//
// with the online softmax: the [L, L] score matrix never reaches device
// memory.
//
// Design. One thread block per (instance, 64-row query tile); a loop over
// 64-row key tiles inside the block takes the place of the TPU kernel's
// sequential key-axis grid dimension (blocks run in parallel and in no
// order here, so nothing can be carried between them). Under causal
// masking the loop stops at the diagonal, with the TPU kernel's live
// condition `j * tk < (qi + 1) * tq`. The Q tile and each K/V tile are
// staged through shared memory as fp32 (bf16 inputs are widened on load);
// rows are padded by one float so the rows a warp reads sit in distinct
// banks. Four threads own one query row: each computes 16 of the tile's 64
// scores, the row max and sum are reduced across the four with shuffles,
// and each keeps D/4 output columns of the fp32 accumulator in registers.
// The online-softmax state (m, l, acc) is fp32; the finalisation is the
// TPU kernel's (:193-197), including l_safe = max(l, 1e-30), so a row with
// no admissible key never yields NaN. Rows and keys past L are masked
// here, so any L >= 1 is accepted (no tile-multiple requirement).
//
// All arithmetic is fp32 FMAs on the CUDA cores: fp32 inputs never go
// through TF32, and no tensor core is used.
//
// What bounds it on an H100. At the serving shape [BH=8, L=128..512,
// D=64] fp32 causal it reads and writes about 4*BH*L*D*4 bytes (4.2 MB at
// L=512) and does 4*BH*D*L*(L+1)/2 FLOPs (0.27 GFLOP at L=512): about 64
// FLOP/byte, above the ~20 FLOP/byte at which fp32 CUDA-core math (67
// TFLOP/s) overtakes memory (3.35 TB/s), so the bound is the operations —
// and far below the ~295 FLOP/byte of the bf16 tensor cores. In practice
// it is launch- and occupancy-bound: BH=8 times L/64 query tiles is 16 to
// 64 blocks for 132 SMs, and the key loop is serial inside a block.
// Making it fast (wgmma on bf16 operands, TMA-fed K/V rings, split-K over
// the key axis for small BH) is later work.
//
// C interface (loaded with ctypes): tpu_dist_flash_fwd launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;                           // query rows per block
constexpr int kBlockN = 64;                           // key rows per tile
constexpr int kRowThreads = 4;                        // threads per query row
constexpr int kThreads = kBlockM * kRowThreads;       // 256
constexpr int kColsPerThread = kBlockN / kRowThreads;  // 16
constexpr int kPStride = kBlockN + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q [64][D+1], K [64][D+1], V [64][D], P [64][65], all fp32.
  return sizeof(float) * (kBlockM * (D + 1) + kBlockN * (D + 1) +
                          kBlockN * D + kBlockM * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int L, int causal, float scale) {
  static_assert(D % kRowThreads == 0, "D must split over a row's threads");
  constexpr int kQK = D + 1;
  constexpr int kAcc = D / kRowThreads;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * kQK;
  float* vs = ks + kBlockN * kQK;
  float* ps = vs + kBlockN * D;

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;   // query row within the tile
  const int c4 = tid % kRowThreads;  // which quarter of the row
  const int64_t base = (int64_t)blockIdx.x * L * D;
  const int q0 = blockIdx.y * kBlockM;
  const int qpos = q0 + r;

  for (int idx = tid; idx < kBlockM * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    const int pos = q0 + row;
    qs[row * kQK + col] =
        pos < L ? to_float(q[base + (int64_t)pos * D + col]) : 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // Key tiles strictly past this query tile's diagonal are fully masked.
  const int kend = causal ? min(L, q0 + kBlockM) : L;
  for (int k0 = 0; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int row = idx / D, col = idx % D;
      const int pos = k0 + row;
      const bool in = pos < L;
      const int64_t g = base + (int64_t)pos * D + col;
      ks[row * kQK + col] = in ? to_float(k[g]) : 0.f;
      vs[row * D + col] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * kQK + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s[j] = fmaf(qv, ks[(c4 + kRowThreads * j) * kQK + d], s[j]);
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int kpos = k0 + c4 + kRowThreads * j;
      const bool ok = kpos < L && (!causal || kpos <= qpos);
      s[j] = ok ? s[j] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // A row with no admissible key so far keeps m = -inf; shifting by 0
    // then gives p = corr = 0 instead of exp(-inf + inf) = NaN.
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m - m_use);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = expf(s[j] - m_use);
      ps[r * kPStride + c4 + kRowThreads * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= corr;
    __syncwarp();  // a row's P is written and read by its own warp
    for (int c = 0; c < kBlockN; ++c) {
      const float p = ps[r * kPStride + c];
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = fmaf(p, vs[c * D + c4 + kRowThreads * i], acc[i]);
    }
  }

  if (qpos < L) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* out = o + base + (int64_t)qpos * D;
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      store(out + c4 + kRowThreads * i, acc[i] / l_safe);
    if (c4 == 0) lse[(int64_t)blockIdx.x * L + qpos] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int L, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  // Above 48 KB a block's shared memory must be opted into per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (L + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      L, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int L, int D, int causal,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, L, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, L, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, L, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tpu_dist_flash_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int bh,
                                  int L, int D, int is_bf16, int causal,
                                  float scale, void* stream) {
  // grid.y holds the query tiles, and is at most 65535.
  if (bh < 1 || L < 1 || (L + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, L, D, causal,
                                          scale, s)
              : dispatch_d<float>(q, k, v, o, lse, bh, L, D, causal, scale,
                                  s);
  return (int)err;
}
