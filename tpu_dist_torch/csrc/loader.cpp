// Host input-pipeline core of the port: fused gather + normalize, and a
// seeded index shuffle. Host C++, not a kernel: it assembles a training
// batch from a shuffled in-memory dataset on the CPU.
//
// The port's copy of the JAX package's loader (tpu_dist/data/_native/
// loader.cpp): the same functions with the same results, so both packages
// draw the same permutations and the same float32 batches. One
// multithreaded pass gathers random rows into a contiguous batch and
// converts uint8 -> float32 * scale, where numpy would make separate
// fancy-index, astype and multiply passes.
//
// Build: g++ -O3 -shared -fPIC -pthread loader.cpp -o libloader.so
// (tpu_dist_torch/data/native.py builds it at first use into
// tpu_dist_torch/_build/; the numpy path stands in without a toolchain).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// SplitMix64: small, seedable, statistically sound for shuffling.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void gather_scale_rows(const uint8_t* in, const int64_t* idx, int64_t begin,
                       int64_t end, int64_t row_elems, float scale,
                       float* out) {
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t* src = in + idx[i] * row_elems;
    float* dst = out + i * row_elems;
    for (int64_t j = 0; j < row_elems; ++j) {
      dst[j] = static_cast<float>(src[j]) * scale;
    }
  }
}

}  // namespace

extern "C" {

// out[i, :] = float32(in[idx[i], :]) * scale, rows split over threads.
void tpu_dist_gather_scale_u8_f32(const uint8_t* in, const int64_t* idx,
                                  int64_t n_out, int64_t row_elems,
                                  float scale, float* out, int n_threads) {
  if (n_threads <= 1 || n_out < n_threads * 4) {
    gather_scale_rows(in, idx, 0, n_out, row_elems, scale, out);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n_out + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk < n_out ? begin + chunk : n_out;
    if (begin >= end) break;
    workers.emplace_back(gather_scale_rows, in, idx, begin, end, row_elems,
                         scale, out);
  }
  for (auto& w : workers) w.join();
}

// The same gather for int64 rows (labels), without scaling.
void tpu_dist_gather_i64(const int64_t* in, const int64_t* idx, int64_t n_out,
                         int64_t row_elems, int64_t* out) {
  for (int64_t i = 0; i < n_out; ++i) {
    std::memcpy(out + i * row_elems, in + idx[i] * row_elems,
                sizeof(int64_t) * row_elems);
  }
}

// Fisher-Yates permutation of [0, n) drawn from a seeded SplitMix64 stream.
void tpu_dist_shuffled_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t state = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix64(state) % (uint64_t)(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

}  // extern "C"
