// Fused Adam update for Hopper (sm_90a): every parameter in one launch.
//
// Replaces the Pallas TPU kernel tpu_dist/ops/pallas_kernels.py:359
// `_adam_kernel` (launched by `fused_adam_apply` at :425). For every fp32
// element of every parameter leaf, in place:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   p' = p - scale m' / (sqrt(v') + eps)
//
// where scale = lr sqrt(1 - b2^t) / (1 - b1^t) is a device scalar, read
// through a pointer: the step counter never reaches the host, and one
// built kernel serves every step.
//
// Design. The TPU kernel concatenates and pads every leaf into one
// [rows, 128] buffer (`_flatten_padded`, :251) because Mosaic tiles are
// (8, 128), which costs a copy of every input in and every output out.
// Here the wrapper passes a device table with one row per leaf: the
// (p, g, m, v) addresses, the length n and the index of the leaf's first
// 4096-element chunk (the running sum of the chunks before it). Block b
// finds its leaf by a binary search of that column (~7 probes for the
// benchmark LM's 70 leaves, the same addresses for every thread) and
// updates chunk b of it where the tensors already live; a chunk never
// crosses a leaf. The table is a few KB, built and uploaded (pinned,
// asynchronous) on every step, so nothing depends on the grads keeping
// their addresses between steps. Each element is read and written once,
// neighbouring threads on neighbouring addresses. The arithmetic uses
// round-to-nearest intrinsics (no contraction into FMAs) in the order of
// the plain version, so the two agree bit for bit.
//
// What bounds it on an H100. Per element it reads 16 bytes and writes 12
// and does about ten FLOPs: under one FLOP per byte, far below the ~20
// FLOP/byte at which fp32 math (67 TFLOP/s) overtakes memory (3.35 TB/s).
// It is bound by bytes: 28 bytes x 21.3 M parameters of the benchmark LM
// is about 596 MB, 0.18 ms at 3.35 TB/s. The design does no more than
// stream each byte once; the chunks keep every block busy with the
// same amount of work whatever the leaves' sizes.
//
// C interface (loaded with ctypes): tpu_dist_fused_adam launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 4096;  // elements per block; must match ops/fused.py

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  int64_t first_chunk;
};
static_assert(sizeof(Leaf) == 6 * sizeof(int64_t), "table row is 6 int64s");

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                  const float* __restrict__ scale_ptr, float b1, float omb1,
                  float b2, float omb2, float eps) {
  // The last leaf whose first chunk is at or before this block's.
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].first_chunk <= blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const Leaf leaf = leaves[lo];
  const int64_t start = (blockIdx.x - leaf.first_chunk) * kChunk;
  const int64_t end = min(start + kChunk, leaf.n);
  const float scale = *scale_ptr;
#pragma unroll 4
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float g = leaf.g[i];
    const float m = __fadd_rn(__fmul_rn(b1, leaf.m[i]), __fmul_rn(omb1, g));
    const float v =
        __fadd_rn(__fmul_rn(b2, leaf.v[i]), __fmul_rn(omb2, __fmul_rn(g, g)));
    leaf.m[i] = m;
    leaf.v[i] = v;
    leaf.p[i] = __fsub_rn(
        leaf.p[i], __fdiv_rn(__fmul_rn(scale, m), __fadd_rn(__fsqrt_rn(v), eps)));
  }
}

}  // namespace

extern "C" int tpu_dist_fused_adam(const void* leaves, int n_leaves,
                                   int n_chunks, const void* scale, float b1,
                                   float omb1, float b2, float omb2, float eps,
                                   void* stream) {
  if (n_leaves < 1 || n_chunks < 1) return (int)cudaErrorInvalidValue;
  fused_adam_kernel<<<n_chunks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves,
      static_cast<const float*>(scale), b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}
