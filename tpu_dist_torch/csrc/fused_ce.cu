// Fused sparse softmax cross-entropy for Hopper (sm_90a): forward and
// backward kernels over [B, C] logits with integer labels.
//
// Replaces the Pallas TPU kernels tpu_dist/ops/pallas_kernels.py:73
// `_ce_fwd_kernel` (launched by `_ce_fwd` at :96) and :123 `_ce_bwd_kernel`
// (launched by `_ce_bwd` at :144). For every row i:
//
//   forward:  lse_i  = log(sum_j exp(x_ij))
//             loss_i = lse_i - x_i[label_i]
//   backward: dx_ij  = (exp(x_ij - lse_i) - [j == label_i]) * g_i
//
// in fp32 whatever the logits' dtype (fp32 or bf16); dx is written in the
// logits' dtype. A label outside [0, C) matches no column, as on the TPU:
// its loss is lse and its one-hot row is empty.
//
// Design. The TPU kernel holds a (rows, C) tile in VMEM and reduces it in
// one go; its tile shrinks with C to stay inside the VMEM budget, and past
// C = 64k it gives up. Here one block owns one row and loops over it, so
// any C works: each thread keeps a running (max, sum of exp(x - max)) over
// its share of the row, rescaling the sum when the max grows (one expf per
// element), and the block merges the pairs with warp shuffles and one
// round through shared memory. Rows whose width allows it (C a multiple of
// 16 bytes' worth of elements, 16-byte aligned base) are read with 16-byte
// loads, neighbouring threads on neighbouring addresses. The block has as
// many threads as the row has 16-byte vectors, in warps, up to 256: a
// 10-class row gets one warp. The backward reads each logit once and
// writes each gradient once. expf and logf are the accurate versions (not
// __expf), and the products and differences round to nearest without
// contraction, as the plain PyTorch version computes them.
//
// What bounds it on an H100. Per element the forward reads 4 bytes (fp32)
// and does ~4 FLOPs plus one expf; the backward reads 4 and writes 4. Both
// are far below the ~20 FLOP/byte at which fp32 math (67 TFLOP/s) would
// overtake memory (3.35 TB/s): bound by bytes. At the LM's [32768, 8192]
// fp32 the forward moves 1.074 GB (0.321 ms), the backward 2.148 GB
// (0.641 ms). At the MNIST CNN's [64, 10] a launch does next to nothing and
// the launch itself bounds it.
//
// C interface (loaded with ctypes): each function launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). dtype 0 is fp32, 1 bf16; label_bytes
// is 4 (int32) or 8 (int64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC consecutive elements at p (16-byte aligned when VEC > 1) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_float(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
    alignas(16) T buf[VEC];
    *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_float(buf[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(v[0]);
  } else {
    alignas(16) T buf[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) buf[k] = from_float<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(buf);
  }
}

// A running max m and s = sum of exp(x - m) over the values seen; s == 0
// means none seen yet.
struct MaxSum {
  float m;
  float s;
};

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  float s = 0.f;
  if (a.s > 0.f) s = __fadd_rn(s, __fmul_rn(a.s, expf(__fsub_rn(a.m, m))));
  if (b.s > 0.f) s = __fadd_rn(s, __fmul_rn(b.s, expf(__fsub_rn(b.m, m))));
  return {m, s};
}

// Merges every thread's pair; the result is valid in thread 0. blockDim.x
// is a multiple of 32, at most kMaxThreads.
__device__ __forceinline__ MaxSum block_merge(MaxSum r) {
  __shared__ MaxSum warp_r[kMaxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const MaxSum o{__shfl_xor_sync(0xffffffffu, r.m, off),
                   __shfl_xor_sync(0xffffffffu, r.s, off)};
    r = merge(r, o);
  }
  const int nwarps = blockDim.x / 32;
  if (nwarps == 1) return r;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_r[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = lane < nwarps ? warp_r[lane] : MaxSum{neg_inf(), 0.f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const MaxSum o{__shfl_xor_sync(0xffffffffu, r.m, off),
                     __shfl_xor_sync(0xffffffffu, r.s, off)};
      r = merge(r, o);
    }
  }
  return r;
}

template <typename T, typename L, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
ce_fwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse_out,
              int64_t cols) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * cols;
  MaxSum r{neg_inf(), 0.f};
  const int64_t nvec = cols / VEC;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[VEC];
    load_vec<T, VEC>(x + i * VEC, v);
    float vm = v[0];
#pragma unroll
    for (int k = 1; k < VEC; ++k) vm = fmaxf(vm, v[k]);
    if (vm > r.m) {
      if (r.s > 0.f) r.s = __fmul_rn(r.s, expf(__fsub_rn(r.m, vm)));
      r.m = vm;
    }
    if (r.m != neg_inf()) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        r.s = __fadd_rn(r.s, expf(__fsub_rn(v[k], r.m)));
    }
  }
  r = block_merge(r);
  if (threadIdx.x == 0) {
    const float lse = __fadd_rn(logf(r.s), r.m);
    const int64_t label = static_cast<int64_t>(labels[row]);
    const float picked =
        (label >= 0 && label < cols) ? to_float(x[label]) : 0.f;
    loss[row] = __fsub_rn(lse, picked);
    lse_out[row] = lse;
  }
}

template <typename T, typename L, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
ce_bwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dlogits, int64_t cols) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * cols;
  T* dx = dlogits + row * cols;
  const float l = lse[row], gr = g[row];
  const int64_t label = static_cast<int64_t>(labels[row]);
  const int64_t nvec = cols / VEC;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[VEC];
    load_vec<T, VEC>(x + i * VEC, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float onehot = (i * VEC + k == label) ? 1.f : 0.f;
      v[k] = __fmul_rn(__fsub_rn(expf(__fsub_rn(v[k], l)), onehot), gr);
    }
    store_vec<T, VEC>(dx + i * VEC, v);
  }
}

// 16 bytes' worth of T when every row starts 16-byte aligned, else 1.
template <typename T>
int vec_width(int64_t cols, const void* a, const void* b) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return (cols % kVec == 0 && aligned) ? kVec : 1;
}

int threads_for(int64_t vectors) {
  const int64_t warps = (vectors + 31) / 32;
  return static_cast<int>(warps >= kMaxThreads / 32 ? kMaxThreads : warps * 32);
}

template <typename T, typename L>
int launch_fwd(const void* logits, const void* labels, void* loss, void* lse,
               int64_t rows, int64_t cols, cudaStream_t stream) {
  const int vec = vec_width<T>(cols, logits, logits);
  const int threads = threads_for(cols / vec);
  const auto* x = static_cast<const T*>(logits);
  const auto* y = static_cast<const L*>(labels);
  auto* lo = static_cast<float*>(loss);
  auto* ls = static_cast<float*>(lse);
  if (vec == 1)
    ce_fwd_kernel<T, L, 1><<<rows, threads, 0, stream>>>(x, y, lo, ls, cols);
  else
    ce_fwd_kernel<T, L, 16 / sizeof(T)>
        <<<rows, threads, 0, stream>>>(x, y, lo, ls, cols);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_bwd(const void* logits, const void* labels, const void* lse,
               const void* g, void* dlogits, int64_t rows, int64_t cols,
               cudaStream_t stream) {
  const int vec = vec_width<T>(cols, logits, dlogits);
  const int threads = threads_for(cols / vec);
  const auto* x = static_cast<const T*>(logits);
  const auto* y = static_cast<const L*>(labels);
  const auto* ls = static_cast<const float*>(lse);
  const auto* gr = static_cast<const float*>(g);
  auto* dx = static_cast<T*>(dlogits);
  if (vec == 1)
    ce_bwd_kernel<T, L, 1>
        <<<rows, threads, 0, stream>>>(x, y, ls, gr, dx, cols);
  else
    ce_bwd_kernel<T, L, 16 / sizeof(T)>
        <<<rows, threads, 0, stream>>>(x, y, ls, gr, dx, cols);
  return (int)cudaGetLastError();
}

bool bad_args(int dtype, int label_bytes, int64_t rows, int64_t cols) {
  return (dtype != 0 && dtype != 1) || (label_bytes != 4 && label_bytes != 8) ||
         rows < 1 || rows > 0x7fffffff || cols < 1;
}

}  // namespace

extern "C" int tpu_dist_ce_fwd(const void* logits, int dtype,
                               const void* labels, int label_bytes,
                               void* loss, void* lse, int64_t rows,
                               int64_t cols, void* stream) {
  if (bad_args(dtype, label_bytes, rows, cols))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return label_bytes == 4
               ? launch_fwd<float, int32_t>(logits, labels, loss, lse, rows,
                                            cols, s)
               : launch_fwd<float, int64_t>(logits, labels, loss, lse, rows,
                                            cols, s);
  return label_bytes == 4
             ? launch_fwd<__nv_bfloat16, int32_t>(logits, labels, loss, lse,
                                                  rows, cols, s)
             : launch_fwd<__nv_bfloat16, int64_t>(logits, labels, loss, lse,
                                                  rows, cols, s);
}

extern "C" int tpu_dist_ce_bwd(const void* logits, int dtype,
                               const void* labels, int label_bytes,
                               const void* lse, const void* g, void* dlogits,
                               int64_t rows, int64_t cols, void* stream) {
  if (bad_args(dtype, label_bytes, rows, cols))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return label_bytes == 4
               ? launch_bwd<float, int32_t>(logits, labels, lse, g, dlogits,
                                            rows, cols, s)
               : launch_bwd<float, int64_t>(logits, labels, lse, g, dlogits,
                                            rows, cols, s);
  return label_bytes == 4
             ? launch_bwd<__nv_bfloat16, int32_t>(logits, labels, lse, g,
                                                  dlogits, rows, cols, s)
             : launch_bwd<__nv_bfloat16, int64_t>(logits, labels, lse, g,
                                                  dlogits, rows, cols, s);
}
