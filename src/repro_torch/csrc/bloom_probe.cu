// Batched k-hash Bloom-filter probe for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bloom_probe.py:bloom_probe
// (body _kernel -> kernels/common.py bloom_hit).
//
// What bounds it here: per key, up to k hashes (~25 integer ops each with
// the bit test) and as many random bitmap-word gathers, against 12
// compulsory bytes per key (two key lanes in, one int32 out) plus the
// bitmap once. A stored key needs all k probes; a miss stops at its first
// zero bit, about 2 probes on a half-full bitmap. So a batch of stored keys
// is bound by the INT32 pipes and a batch of misses comes close to the
// bytes; each gather costs a 32-byte sector, from L2 while the bitmap fits.
//
// What the design does about it: one thread per key over flat hi/lo lanes
// (coalesced loads and stores), the probes in registers with an exit at
// the first zero bit, the bitmap read through the read-only path.
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const uint32_t* __restrict__ words,
                   const uint32_t* __restrict__ hi,
                   const uint32_t* __restrict__ lo, int32_t* __restrict__ out,
                   uint32_t m_bits, uint32_t k, uint32_t seed,
                   uint32_t offset, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<int32_t>(
      probe::bloom_hit(words, hi[i], lo[i], m_bits, k, seed, offset));
}

}  // namespace

extern "C" int bloom_probe_launch(const void* words, const void* hi,
                                  const void* lo, void* out, uint32_t m_bits,
                                  uint32_t k, uint32_t seed, uint32_t offset,
                                  int64_t n, void* stream) {
  if (n > 0) {
    bloom_probe_kernel<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(hi),
        static_cast<const uint32_t*>(lo), static_cast<int32_t*>(out), m_bits, k,
        seed, offset, n);
  }
  return static_cast<int>(cudaGetLastError());
}
