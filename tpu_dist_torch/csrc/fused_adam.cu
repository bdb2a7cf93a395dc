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
// where scale = lr sqrt(1 - b2^t) / (1 - b1^t). Each block computes scale
// itself from the step counter t and the learning rate, both read through
// pointers on the device (a schedule's rate too), with the plain version's
// fp32 operations: float(t), powf, 1 - x, a correctly rounded sqrt, the
// product, the quotient. So the counter never reaches the host, one built
// kernel serves every step, and the optimizer's update launches only the
// counter's increment besides (and a schedule's ops, with a schedule).
//
// What bounds it on an H100. Per element it reads 16 bytes and writes 12
// and does about ten FLOPs: under one FLOP per byte, far below the ~20
// FLOP/byte at which fp32 math (67 TFLOP/s) overtakes memory (3.35 TB/s).
// It is bound by bytes: 28 bytes x 21.3 M parameters of the benchmark LM
// is about 596 MB, 0.18 ms at 3.35 TB/s.
//
// Design. The TPU kernel concatenates and pads every leaf into one
// [rows, 128] buffer (`_flatten_padded`, :251) because Mosaic tiles are
// (8, 128), which costs a copy of every input in and every output out.
// Here the kernel updates each leaf where it lives, walking a device table
// (ops/fused.py): one row per non-empty leaf (the p, m, v addresses, the
// index of its grad, the length n, the index of its first 4096-element
// chunk and a flag set when p, m and v start on a 16-byte boundary), then
// an int32 map from each chunk to its row. The grads' addresses come with
// each launch, among the kernel's parameters (read in place,
// __grid_constant__): backward hands out new grads every step. Block b
// reads its row through the map (two dependent loads, no search), and its
// grad's address, and updates chunk b of that leaf; a chunk never crosses
// a leaf. To keep the memory system full, each thread first issues all
// its loads, four 16-byte vectors (float4) of each of the four columns
// (when the row's flag is set and the grad is aligned too; 16 scalars each
// otherwise), and only then does its arithmetic and stores: 64 KB in
// flight per block, well past the ~2 MB across the card that its latency
// asks for. A leaf's last n % 4 elements go one per thread. Every element
// is read and written once, neighbouring threads on neighbouring
// addresses. The arithmetic uses round-to-nearest intrinsics (no
// contraction into FMAs) in the order of the plain version, so the two
// agree bit for bit on either path.
//
// Why the cached table is safe: it is built once per set of params and
// moments and kept on the card by the wrapper (ops/fused.py `LeafTables`),
// which re-checks on every call the addresses, identities and lengths it
// was built from and the grads' dtype, device, shape and layout (its note
// lists which facts are read again and which hold by construction), so no
// launch sees a row that does not match its tensors.
//
// C interface (loaded with ctypes): tpu_dist_fused_adam launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success). leaves points to the table: n_leaves
// rows, then n_chunks int32 row indices; grads to n_grads (at most
// kMaxGrads) device addresses on the host, one per leaf; step to the int32
// update count (this update included) and lr to one fp32 value, both on
// the device.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                         // float4s a thread per column
constexpr int kChunk = kThreads * 4 * kVec;     // 4096; must match ops/fused.py
constexpr int kScalar = kChunk / kThreads;      // scalars a thread, unaligned

struct Leaf {
  float* p;
  float* m;
  float* v;
  int64_t grad;     // index into the launch's grad addresses
  int64_t n;
  int64_t first_chunk;
  int64_t aligned;  // p, m and v start on a 16-byte boundary
};
static_assert(sizeof(Leaf) == 7 * sizeof(int64_t), "table row is 7 int64s");

// The grads' addresses, passed by value among the kernel's parameters
// (read in place from the parameter bank: __grid_constant__).
constexpr int kMaxGrads = 4000;  // 32,000 bytes; must match ops/fused.py
template <int CAP>
struct Grads {
  const float* g[CAP];
};

struct Coef {
  float scale, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Coef& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.scale, m),
                             __fadd_rn(__fsqrt_rn(v), c.eps)));
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m,
                                        float4& v, const Coef& c) {
  update(p.x, g.x, m.x, v.x, c);
  update(p.y, g.y, m.y, v.y, c);
  update(p.z, g.z, m.z, v.z, c);
  update(p.w, g.w, m.w, v.w, c);
}

// One chunk of `len` elements, all four columns 16-byte aligned.
__device__ __forceinline__ void chunk_vec(float4* __restrict__ p,
                                          const float4* __restrict__ g,
                                          float4* __restrict__ m,
                                          float4* __restrict__ v, int len,
                                          const Coef& c) {
  const int n4 = len >> 2;
  float4 pr[kVec], gr[kVec], mr[kVec], vr[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n4) {
      gr[k] = __ldg(g + i);
      mr[k] = m[i];
      vr[k] = v[i];
      pr[k] = p[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < n4) {
      update4(pr[k], gr[k], mr[k], vr[k], c);
      m[i] = mr[k];
      v[i] = vr[k];
      p[i] = pr[k];
    }
  }
  const int i = (n4 << 2) + threadIdx.x;  // the leaf's last n % 4
  if (i < len) {
    float* ps = reinterpret_cast<float*>(p);
    float* ms = reinterpret_cast<float*>(m);
    float* vs = reinterpret_cast<float*>(v);
    float pe = ps[i], me = ms[i], ve = vs[i];
    update(pe, reinterpret_cast<const float*>(g)[i], me, ve, c);
    ms[i] = me;
    vs[i] = ve;
    ps[i] = pe;
  }
}

// The same chunk on a leaf that does not start on a 16-byte boundary.
__device__ __forceinline__ void chunk_scalar(float* __restrict__ p,
                                             const float* __restrict__ g,
                                             float* __restrict__ m,
                                             float* __restrict__ v, int len,
                                             const Coef& c) {
  float pr[kScalar], gr[kScalar], mr[kScalar], vr[kScalar];
#pragma unroll
  for (int k = 0; k < kScalar; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < len) {
      gr[k] = __ldg(g + i);
      mr[k] = m[i];
      vr[k] = v[i];
      pr[k] = p[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kScalar; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < len) {
      update(pr[k], gr[k], mr[k], vr[k], c);
      m[i] = mr[k];
      v[i] = vr[k];
      p[i] = pr[k];
    }
  }
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const Leaf* __restrict__ leaves,
                  const int* __restrict__ chunk_row,
                  const int* __restrict__ step_ptr,
                  const float* __restrict__ lr_ptr, float b1, float omb1,
                  float b2, float omb2, float eps,
                  const __grid_constant__ Grads<CAP> grads) {
  const Leaf leaf = leaves[chunk_row[blockIdx.x]];
  const int64_t start =
      (static_cast<int64_t>(blockIdx.x) - leaf.first_chunk) * kChunk;
  const int len = static_cast<int>(min(static_cast<int64_t>(kChunk),
                                       leaf.n - start));
  const float t = static_cast<float>(__ldg(step_ptr));
  const float corr = __fsqrt_rn(__fsub_rn(1.f, powf(b2, t)));
  const float scale = __fdiv_rn(__fmul_rn(__ldg(lr_ptr), corr),
                                __fsub_rn(1.f, powf(b1, t)));
  const Coef c{scale, b1, omb1, b2, omb2, eps};
  const float* g = grads.g[leaf.grad] + start;
  if (leaf.aligned && (reinterpret_cast<uintptr_t>(g) & 15) == 0)
    chunk_vec(reinterpret_cast<float4*>(leaf.p + start),
              reinterpret_cast<const float4*>(g),
              reinterpret_cast<float4*>(leaf.m + start),
              reinterpret_cast<float4*>(leaf.v + start), len, c);
  else
    chunk_scalar(leaf.p + start, g, leaf.m + start, leaf.v + start, len, c);
}

template <int CAP>
cudaError_t launch_cap(const Leaf* table, int n_leaves, int n_chunks,
                       const int* step, const float* lr,
                       const float (&coef)[5], const void* grads, int n_grads,
                       cudaStream_t s) {
  Grads<CAP> g;
  memcpy(g.g, grads, sizeof(void*) * n_grads);
  fused_adam_kernel<CAP><<<n_chunks, kThreads, 0, s>>>(
      table, reinterpret_cast<const int*>(table + n_leaves), step, lr,
      coef[0], coef[1], coef[2], coef[3], coef[4], g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpu_dist_fused_adam(const void* leaves, int n_leaves,
                                   int n_chunks, const void* step,
                                   const void* lr, float b1, float omb1,
                                   float b2, float omb2, float eps,
                                   const void* grads, int n_grads,
                                   void* stream) {
  if (n_leaves < 1 || n_chunks < 1 || step == nullptr || lr == nullptr ||
      grads == nullptr || n_grads < 1 || n_grads > kMaxGrads)
    return (int)cudaErrorInvalidValue;
  const auto* table = static_cast<const Leaf*>(leaves);
  const auto* t = static_cast<const int*>(step);
  const auto* rate = static_cast<const float*>(lr);
  const float coef[5] = {b1, omb1, b2, omb2, eps};
  auto s = static_cast<cudaStream_t>(stream);
  // A small parameter block for the usual models, the largest beyond them.
  const cudaError_t err =
      n_grads <= 256
          ? launch_cap<256>(table, n_leaves, n_chunks, t, rate, coef, grads,
                            n_grads, s)
          : launch_cap<kMaxGrads>(table, n_leaves, n_chunks, t, rate, coef,
                                  grads, n_grads, s);
  return (int)err;
}
