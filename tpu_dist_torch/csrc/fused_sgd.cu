// Fused SGD update for Hopper (sm_90a): every parameter in one launch.
//
// Replaces the Pallas TPU kernels tpu_dist/ops/pallas_kernels.py:237
// `_sgd_kernel` and :241 `_sgd_momentum_kernel` (both launched through
// `_sgd_pallas_call` at :284 by `fused_sgd_apply`). For every fp32 element
// of every parameter leaf, in place, with learning rate lr and momentum m:
//
//   plain SGD:  p' = p - lr g
//   momentum:   v' = m v - lr g;   p' = p + v'
//   Nesterov:   v' = m v - lr g;   p' = p + m v' - lr g
//
// lr is a device scalar, read through a pointer as fused_adam.cu reads its
// step scale: a schedule's value never reaches the host, and one built
// kernel serves a constant rate and a schedule alike. (The TPU kernels bake
// lr in as a compile-time constant, so the JAX package keeps a schedule off
// them; nothing here forces that.)
//
// Design. The TPU kernels run over one (rows, 128) buffer into which every
// leaf is raveled, concatenated and padded (`_flatten_padded`, :251),
// because Mosaic tiles are (8, 128): a copy of every input in and every
// output out. Here, as in fused_adam.cu, the wrapper passes a device table
// with one row per leaf: the (p, g, v) addresses (v null for plain SGD),
// the length n and the index of the leaf's first 4096-element chunk. Block
// b finds its leaf by a binary search of that column and updates chunk b
// of it where the tensors already live; a chunk never crosses a leaf. The
// table is a few KB, built and uploaded on every step, so nothing depends
// on the grads keeping their addresses. Each element is read and written
// once, neighbouring threads on neighbouring addresses. The arithmetic
// rounds to nearest at every operation (no contraction into FMAs), in the
// order of the plain version, so the two agree bit for bit.
//
// What bounds it on an H100. Per element plain SGD reads 8 bytes and
// writes 4, momentum reads 12 and writes 8; each does 2-5 FLOPs. Far below
// the ~20 FLOP/byte at which fp32 math (67 TFLOP/s) overtakes memory
// (3.35 TB/s): bound by bytes. Over the benchmark LM's 21,269,504
// parameters that is 255 MB (0.076 ms) and 425 MB (0.127 ms). Over the
// MNIST CNN's 225,034 parameters (0.9 MB) a launch is bound by the launch.
//
// C interface (loaded with ctypes): tpu_dist_fused_sgd launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). mode 0 is plain SGD, 1 momentum, 2
// Nesterov momentum; lr points to one fp32 value on the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 4096;  // elements per block; must match ops/fused.py

struct Leaf {
  float* p;
  const float* g;
  float* v;
  int64_t n;
  int64_t first_chunk;
};
static_assert(sizeof(Leaf) == 5 * sizeof(int64_t), "table row is 5 int64s");

template <int MODE>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                 const float* __restrict__ lr_ptr, float m) {
  // The last leaf whose first chunk is at or before this block's.
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].first_chunk <= blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const Leaf leaf = leaves[lo];
  const int64_t start = (blockIdx.x - leaf.first_chunk) * kChunk;
  const int64_t end = min(start + kChunk, leaf.n);
  const float lr = *lr_ptr;
#pragma unroll 4
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float step = __fmul_rn(lr, leaf.g[i]);
    if constexpr (MODE == 0) {
      leaf.p[i] = __fsub_rn(leaf.p[i], step);
    } else {
      const float v = __fsub_rn(__fmul_rn(m, leaf.v[i]), step);
      leaf.v[i] = v;
      if constexpr (MODE == 1)
        leaf.p[i] = __fadd_rn(leaf.p[i], v);
      else
        leaf.p[i] = __fsub_rn(__fadd_rn(leaf.p[i], __fmul_rn(m, v)), step);
    }
  }
}

}  // namespace

extern "C" int tpu_dist_fused_sgd(const void* leaves, int n_leaves,
                                  int n_chunks, int mode, const void* lr,
                                  float m, void* stream) {
  if (n_leaves < 1 || n_chunks < 1 || mode < 0 || mode > 2 || lr == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto* table = static_cast<const Leaf*>(leaves);
  const auto* rate = static_cast<const float*>(lr);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    fused_sgd_kernel<0><<<n_chunks, kThreads, 0, s>>>(table, n_leaves, rate, m);
  else if (mode == 1)
    fused_sgd_kernel<1><<<n_chunks, kThreads, 0, s>>>(table, n_leaves, rate, m);
  else
    fused_sgd_kernel<2><<<n_chunks, kThreads, 0, s>>>(table, n_leaves, rate, m);
  return (int)cudaGetLastError();
}
