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
// What bounds it on an H100. Per element plain SGD reads 8 bytes and
// writes 4, momentum reads 12 and writes 8; each does 2-5 FLOPs. Far below
// the ~20 FLOP/byte at which fp32 math (67 TFLOP/s) overtakes memory
// (3.35 TB/s): bound by bytes. Over the benchmark LM's 21,269,504
// parameters that is 255 MB (0.076 ms) and 425 MB (0.127 ms). Over the
// MNIST CNN's 225,034 parameters (0.9 MB) a launch is bound by the launch,
// and the wrapper's host work is what counts there.
//
// Design. The TPU kernels run over one (rows, 128) buffer into which every
// leaf is raveled, concatenated and padded (`_flatten_padded`, :251),
// because Mosaic tiles are (8, 128): a copy of every input in and every
// output out. Here the kernel updates each leaf where it lives, walking a
// device table (ops/fused.py): one row per non-empty leaf (the p and v
// addresses, v null for plain SGD, the index of its grad, the length n, the
// index of its first 4096-element chunk and a flag set when p and v start
// on a 16-byte boundary), then an int32 map from each chunk to its row.
// The grads' addresses come with each launch, among the kernel's
// parameters (read in place, __grid_constant__): backward hands out new
// grads every step. Block b reads its row through the map (two dependent
// loads, no search), and its grad's address, and updates chunk b of that
// leaf; a chunk never crosses a leaf. To keep the memory system full, each
// thread first issues all its loads, four 16-byte vectors of each column
// (float4, when the row's flag is set and the grad is aligned too; 16
// scalars otherwise), and only then does its arithmetic and stores: 16 KB
// of each column in flight per block, several blocks per SM, far more
// than the ~2 MB across the card that its latency asks for. A leaf's last
// n % 4 elements go one per thread. Every element is read and written
// once, neighbouring threads on neighbouring addresses. The arithmetic
// rounds to nearest at every operation (no contraction into FMAs), in the
// order of the plain version, so the two agree bit for bit on either path.
//
// Why the cached table is safe: it is built once per set of params and
// state tensors and kept on the card by the wrapper (ops/fused.py
// `LeafTables`), which re-checks on every call the addresses, identities
// and lengths it was built from and the grads' dtype, device, shape and
// layout (its note lists which facts are read again and which hold by
// construction), so no launch sees a row that does not match its tensors.
//
// C interface (loaded with ctypes): tpu_dist_fused_sgd launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). leaves points to the table: n_leaves
// rows, then n_chunks int32 row indices; grads to n_grads (at most
// kMaxGrads) device addresses on the host, one per leaf. mode 0 is plain
// SGD, 1 momentum, 2 Nesterov momentum; lr points to one fp32 value on the
// device.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                         // float4s a thread per column
constexpr int kChunk = kThreads * 4 * kVec;     // 4096; must match ops/fused.py
constexpr int kScalar = kChunk / kThreads;      // scalars a thread, unaligned

struct Leaf {
  float* p;
  float* v;
  int64_t grad;     // index into the launch's grad addresses
  int64_t n;
  int64_t first_chunk;
  int64_t aligned;  // p and v start on a 16-byte boundary
};
static_assert(sizeof(Leaf) == 6 * sizeof(int64_t), "table row is 6 int64s");

// The grads' addresses, passed by value among the kernel's parameters
// (read in place from the parameter bank: __grid_constant__).
constexpr int kMaxGrads = 4000;  // 32,000 bytes; must match ops/fused.py
template <int CAP>
struct Grads {
  const float* g[CAP];
};

template <int MODE>
__device__ __forceinline__ void update(float& p, float g, float& v, float lr,
                                       float m) {
  const float step = __fmul_rn(lr, g);
  if constexpr (MODE == 0) {
    p = __fsub_rn(p, step);
  } else {
    v = __fsub_rn(__fmul_rn(m, v), step);
    if constexpr (MODE == 1)
      p = __fadd_rn(p, v);
    else
      p = __fsub_rn(__fadd_rn(p, __fmul_rn(m, v)), step);
  }
}

template <int MODE>
__device__ __forceinline__ void update4(float4& p, const float4& g, float4& v,
                                        float lr, float m) {
  update<MODE>(p.x, g.x, v.x, lr, m);
  update<MODE>(p.y, g.y, v.y, lr, m);
  update<MODE>(p.z, g.z, v.z, lr, m);
  update<MODE>(p.w, g.w, v.w, lr, m);
}

// One chunk of `len` elements at p, g, v, all 16-byte aligned.
template <int MODE>
__device__ __forceinline__ void chunk_vec(float4* __restrict__ p,
                                          const float4* __restrict__ g,
                                          float4* __restrict__ v, int len,
                                          float lr, float m) {
  const int n4 = len >> 2;
  float4 pr[kVec], gr[kVec], vr[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n4) {
      gr[k] = __ldg(g + i);
      pr[k] = p[i];
      if constexpr (MODE != 0) vr[k] = v[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n4) {
      update4<MODE>(pr[k], gr[k], vr[k], lr, m);
      p[i] = pr[k];
      if constexpr (MODE != 0) v[i] = vr[k];
    }
  }
  const int i = (n4 << 2) + threadIdx.x;  // the leaf's last n % 4
  if (i < len) {
    float* ps = reinterpret_cast<float*>(p);
    float* vs = reinterpret_cast<float*>(v);
    float pe = ps[i], ve = MODE != 0 ? vs[i] : 0.f;
    update<MODE>(pe, reinterpret_cast<const float*>(g)[i], ve, lr, m);
    ps[i] = pe;
    if constexpr (MODE != 0) vs[i] = ve;
  }
}

// The same chunk on a leaf that does not start on a 16-byte boundary.
template <int MODE>
__device__ __forceinline__ void chunk_scalar(float* __restrict__ p,
                                             const float* __restrict__ g,
                                             float* __restrict__ v, int len,
                                             float lr, float m) {
  float pr[kScalar], gr[kScalar], vr[kScalar];
#pragma unroll
  for (int k = 0; k < kScalar; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < len) {
      gr[k] = __ldg(g + i);
      pr[k] = p[i];
      if constexpr (MODE != 0) vr[k] = v[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kScalar; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < len) {
      update<MODE>(pr[k], gr[k], vr[k], lr, m);
      p[i] = pr[k];
      if constexpr (MODE != 0) v[i] = vr[k];
    }
  }
}

template <int MODE, int CAP>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const Leaf* __restrict__ leaves,
                 const int* __restrict__ chunk_row,
                 const float* __restrict__ lr_ptr, float m,
                 const __grid_constant__ Grads<CAP> grads) {
  const Leaf leaf = leaves[chunk_row[blockIdx.x]];
  const int64_t start =
      (static_cast<int64_t>(blockIdx.x) - leaf.first_chunk) * kChunk;
  const int len = static_cast<int>(min(static_cast<int64_t>(kChunk),
                                       leaf.n - start));
  const float lr = __ldg(lr_ptr);
  const float* g = grads.g[leaf.grad] + start;
  float* v = MODE != 0 ? leaf.v + start : nullptr;
  if (leaf.aligned && (reinterpret_cast<uintptr_t>(g) & 15) == 0)
    chunk_vec<MODE>(reinterpret_cast<float4*>(leaf.p + start),
                    reinterpret_cast<const float4*>(g),
                    reinterpret_cast<float4*>(v), len, lr, m);
  else
    chunk_scalar<MODE>(leaf.p + start, g, v, len, lr, m);
}

template <int MODE, int CAP>
cudaError_t launch_cap(const Leaf* table, const int* chunk_row, int n_chunks,
                   const float* lr, float m, const void* grads, int n_grads,
                   cudaStream_t s) {
  Grads<CAP> g;
  memcpy(g.g, grads, sizeof(void*) * n_grads);
  fused_sgd_kernel<MODE, CAP><<<n_chunks, kThreads, 0, s>>>(table, chunk_row,
                                                            lr, m, g);
  return cudaGetLastError();
}

// A small parameter block for the usual models, the largest beyond them.
template <int MODE>
cudaError_t launch(const Leaf* table, const int* chunk_row, int n_chunks,
                   const float* lr, float m, const void* grads, int n_grads,
                   cudaStream_t s) {
  return n_grads <= 256
             ? launch_cap<MODE, 256>(table, chunk_row, n_chunks, lr, m,
                                     grads, n_grads, s)
             : launch_cap<MODE, kMaxGrads>(table, chunk_row, n_chunks, lr, m,
                                           grads, n_grads, s);
}

}  // namespace

extern "C" int tpu_dist_fused_sgd(const void* leaves, int n_leaves,
                                  int n_chunks, int mode, const void* lr,
                                  float m, const void* grads, int n_grads,
                                  void* stream) {
  if (n_leaves < 1 || n_chunks < 1 || mode < 0 || mode > 2 || lr == nullptr ||
      grads == nullptr || n_grads < 1 || n_grads > kMaxGrads)
    return (int)cudaErrorInvalidValue;
  const auto* table = static_cast<const Leaf*>(leaves);
  const auto* chunk_row = reinterpret_cast<const int*>(table + n_leaves);
  const auto* rate = static_cast<const float*>(lr);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mode == 0 ? launch<0>(table, chunk_row, n_chunks, rate, m, grads,
                            n_grads, s)
      : mode == 1 ? launch<1>(table, chunk_row, n_chunks, rate, m, grads,
                              n_grads, s)
                  : launch<2>(table, chunk_row, n_chunks, rate, m, grads,
                              n_grads, s);
  return (int)err;
}
