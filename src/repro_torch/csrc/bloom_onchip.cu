// On-chip path of the Bloom probes for Hopper (sm_90a): bloom_probe and
// cascade_probe from a persistent grid, the layer descriptors and, where
// it fits one block, the bitmap in shared memory.
//
// Replaces, beside the gather kernels of bloom_probe.cu and
// cascade_probe.cu, the TPU kernels src/repro/kernels/bloom_probe.py:32
// (bloom_probe) and src/repro/kernels/cascade_probe.py:49 (cascade_probe)
// on every probe that kernels/bloom_onchip.py onchip_reason sends here.
// Outputs are bit-identical to the gather kernels'.
//
// What bounds these probes on this card (PERF.md, Findings; NVIDIA H100
// 80GB HBM3, 700 W): at large
// batches, not the bitmap's L2 sectors. A key's Bloom test stops at its
// first zero bit, so its probe count is geometric (mean ~2 on a half-full
// bitmap) and a warp runs until the last of its 32 keys stops: a batch
// costs ~3.3x the probes its keys need, wherever the bitmap sits (L2 or
// shared memory), and no scheme measured to hand lanes new keys as theirs
// stop recovered it. At small batches, the latency of each thread's chain
// of dependent reads: a key load, then one bitmap read per hash; reading
// the bitmap from shared memory shortens that chain.
//
// What this design does about it: persistent blocks of 1,024 threads
// (at most one round of them) walk the keys with a grid stride, each
// thread loading its next key's lanes while it probes the current one.
// The layer descriptors (m_bits, k, seed, offset) lie in shared memory as
// one 16-byte word each. Where the span — the bitmap, or for a cascade the
// bank span from its first layer to the end of its last — fits one block
// (kLocal), each block copies it into shared memory with one cp.async.bulk
// on an mbarrier and every probe reads it there (descriptor offsets
// rebased to the span); elsewhere (kGlobal) probes read the bank through
// the read-only path.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe_common.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLayers = 256;   // kernels/bloom_onchip.py MAX_LAYERS

enum Mode : int32_t { kLocal = 0, kGlobal = 1 };

struct Staging {
  const uint32_t* src;   // kLocal: the bank at the first staged word
                         // (16-B aligned); kGlobal: the bank
  uint32_t base;         // that word's index in the bank (kGlobal: 0)
  uint32_t words;        // words staged, a multiple of 4 (kGlobal: 0)
};

// member = the cascade's first-zero parity rule (for one layer: the Bloom
// test itself); probes, where given, = min(first_zero, n_layers)
template <int kMode>
__global__ void __launch_bounds__(kThreads)
onchip_probe_kernel(Staging s, const uint4* __restrict__ desc, uint4 one,
                    int32_t n_layers, const uint32_t* __restrict__ hi,
                    const uint32_t* __restrict__ lo,
                    int32_t* __restrict__ member,
                    int32_t* __restrict__ probes, int64_t n) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ __align__(8) uint64_t bar;
  uint4* layers = reinterpret_cast<uint4*>(smem + s.words);
  if (kMode == kLocal && threadIdx.x == 0) {
    tma::mbar_init(&bar, 1);
    tma::fence_barrier_init();
  }
  for (int j = threadIdx.x; j < n_layers; j += blockDim.x) {
    uint4 d = desc != nullptr ? desc[j] : one;
    d.w -= s.base;   // the layer's first word within the staged span
    layers[j] = d;
  }
  __syncthreads();
  if (kMode == kLocal && threadIdx.x == 0) {
    tma::mbar_expect_tx(&bar, 4u * s.words);
    tma::bulk_copy(smem, s.src, 4u * s.words, &bar);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  // the first key's lanes load while the span streams in
  uint32_t h = 0u, l = 0u;
  if (i < n) {
    h = __ldcs(hi + i);
    l = __ldcs(lo + i);
  }
  if (kMode == kLocal) tma::mbar_wait(&bar, 0u);
  for (; i < n; i += stride) {
    const int64_t next = i + stride;
    uint32_t hn = 0u, ln = 0u;
    if (next < n) {
      hn = __ldcs(hi + next);
      ln = __ldcs(lo + next);
    }
    int32_t first_zero = n_layers + 1;
    for (int32_t t = 0; t < n_layers; ++t) {
      const uint4 f = layers[t];
      bool hit;
      if constexpr (kMode == kLocal) {
        hit = probe::bloom_hit(probe::SharedWords{smem}, h, l, f.x, f.y, f.z,
                               f.w);
      } else {
        hit = probe::bloom_hit(probe::GlobalWords{s.src}, h, l, f.x, f.y,
                               f.z, f.w);
      }
      if (!hit) {
        first_zero = t + 1;
        break;
      }
    }
    member[i] = first_zero > n_layers
                    ? (n_layers & 1)
                    : static_cast<int32_t>((first_zero & 1) == 0);
    if (probes != nullptr) probes[i] = min(first_zero, n_layers);
    h = hn;
    l = ln;
  }
}

template <int kMode>
int launch(const Staging& s, const uint4* desc, uint4 one, int32_t n_layers,
           const uint32_t* hi, const uint32_t* lo, int32_t* member,
           int32_t* probes, int64_t n, int64_t want_blocks,
           cudaStream_t stream) {
  auto kernel = onchip_probe_kernel<kMode>;
  const size_t smem = 4ull * s.words + sizeof(uint4) * n_layers;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one round of resident blocks at most: each stages the span once
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t blocks = want_blocks < resident ? want_blocks : resident;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      s, desc, one, n_layers, hi, lo, member, probes, n);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* words, uint32_t base, uint32_t stage_words,
             int32_t mode, const void* desc, uint4 one, int32_t n_layers,
             const void* hi, const void* lo, void* member, void* probes,
             int64_t n, int64_t want_blocks, void* stream) {
  const bool local = mode == kLocal;
  if (n_layers < 1 || n_layers > kMaxLayers ||
      (mode != kLocal && mode != kGlobal) || stage_words % 4 != 0 ||
      local != (stage_words != 0) ||
      (local && reinterpret_cast<uintptr_t>(words) % 16 != 0) ||
      want_blocks < 1) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Staging s{static_cast<const uint32_t*>(words), base, stage_words};
  const auto* d = static_cast<const uint4*>(desc);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* l = static_cast<const uint32_t*>(lo);
  auto* m = static_cast<int32_t*>(member);
  auto* p = static_cast<int32_t*>(probes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return local ? launch<kLocal>(s, d, one, n_layers, h, l, m, p, n,
                                want_blocks, st)
               : launch<kGlobal>(s, d, one, n_layers, h, l, m, p, n,
                                 want_blocks, st);
}

}  // namespace

// bloom_probe: one layer given by value; out int32 [n]. kLocal: `words`
// is the bank at word `base`, the first of `stage_words` staged words;
// kGlobal: the bank, with base and stage_words 0.
extern "C" int bloom_onchip_launch(const void* words, uint32_t base,
                                   uint32_t stage_words, int32_t mode,
                                   uint32_t m_bits, uint32_t k, uint32_t seed,
                                   uint32_t offset, const void* hi,
                                   const void* lo, void* out, int64_t n,
                                   int64_t want_blocks, void* stream) {
  return dispatch(words, base, stage_words, mode, nullptr,
                  make_uint4(m_bits, k, seed, offset), 1, hi, lo, out,
                  nullptr, n, want_blocks, stream);
}

// cascade_probe: the int32 [n_layers, 4] descriptor (bank offsets);
// member and probes int32 [n].
extern "C" int cascade_onchip_launch(const void* words, uint32_t base,
                                     uint32_t stage_words, int32_t mode,
                                     const void* desc, int32_t n_layers,
                                     const void* hi, const void* lo,
                                     void* member, void* probes, int64_t n,
                                     int64_t want_blocks, void* stream) {
  if (desc == nullptr) return cudaErrorInvalidValue;
  return dispatch(words, base, stage_words, mode, desc,
                  make_uint4(0u, 0u, 0u, 0u), n_layers, hi, lo, member,
                  probes, n, want_blocks, stream);
}
