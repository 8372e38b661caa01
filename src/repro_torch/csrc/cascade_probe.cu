// Fused ChainedFilterCascade probe (paper §4, Algorithm 2) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cascade_probe.py:cascade_probe
// (body _kernel). Per key, first_zero is the first Bloom layer (1-based)
// that misses, or L+1 when every layer hits; the key is a member iff
// first_zero is even, or L is odd when no layer misses; the sequential
// probe count is min(first_zero, L).
//
// What bounds it here: a key needs each layer up to its first missing one
// and each of a layer's k hashes up to its first zero bit (24 integer ops
// and one random bitmap-word gather per hash). A layer passes about half
// the keys it sees (fpr 1/2 from layer 2 on at delta = 1/2), so a key
// probes ~2-3 layers and ~10-20 hashes; against 16 compulsory bytes per
// key (two lanes in, two int32 out) at 4M keys that is ~1-2 G ops
// (~0.1 ms at the INT32 peak) over ~64 MB (~0.02 ms): the INT32 pipes set
// the floor, and the gathers come from L2 (the layers hold ~2 MB at 1M
// positives).
//
// What the design does about it: one thread per key over flat hi/lo
// lanes, a loop over the layers that stops at the first missing layer and
// a Bloom test that stops at the first zero bit (the outputs depend on
// nothing after them), and the layers as data, not code: an int32 [L, 4]
// descriptor (m_bits, k, seed, offset) staged in shared memory once per
// block, so any L >= 1 runs on one build (the TPU kernel unrolls a static
// L). Descriptors of more than kSmemLayers layers are read from global
// memory through the read-only path instead of being refused.
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int kDescK = 4;           // m_bits, k, seed, offset
constexpr int kSmemLayers = 1024;   // 16 KB of shared memory per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cascade_probe_kernel(const uint32_t* __restrict__ words,
                     const uint32_t* __restrict__ desc, int32_t n_layers,
                     const uint32_t* __restrict__ hi,
                     const uint32_t* __restrict__ lo,
                     int32_t* __restrict__ member,
                     int32_t* __restrict__ probes, int64_t n) {
  __shared__ uint32_t sdesc[kSmemLayers * kDescK];
  const bool staged = n_layers <= kSmemLayers;
  if (staged) {
    for (int j = threadIdx.x; j < n_layers * kDescK; j += blockDim.x) {
      sdesc[j] = desc[j];
    }
  }
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t h = hi[i];
  const uint32_t l = lo[i];
  int32_t first_zero = n_layers + 1;
  for (int32_t t = 0; t < n_layers; ++t) {
    uint32_t f[kDescK];
#pragma unroll
    for (int j = 0; j < kDescK; ++j) {
      f[j] = staged ? sdesc[t * kDescK + j] : __ldg(desc + t * kDescK + j);
    }
    if (!probe::bloom_hit(words, h, l, f[0], f[1], f[2], f[3])) {
      first_zero = t + 1;
      break;
    }
  }
  member[i] = first_zero > n_layers ? (n_layers & 1)
                                    : static_cast<int32_t>((first_zero & 1) == 0);
  probes[i] = min(first_zero, n_layers);
}

}  // namespace

extern "C" int cascade_probe_launch(const void* words, const void* desc,
                                    int32_t n_layers, const void* hi,
                                    const void* lo, void* member, void* probes,
                                    int64_t n, void* stream) {
  if (n_layers < 1) return cudaErrorInvalidValue;
  if (n > 0) {
    cascade_probe_kernel<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const uint32_t*>(desc), n_layers,
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<int32_t*>(member), static_cast<int32_t*>(probes), n);
  }
  return static_cast<int>(cudaGetLastError());
}
