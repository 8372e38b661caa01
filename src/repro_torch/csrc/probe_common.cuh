// Device functions shared by the probe kernels (lsm_probe.cu, bloom_probe.cu).
//
// Each mirrors, bit for bit, a host function of the port and of the JAX
// package:
//   fmix32 / hash_u32 / fastrange  <- core/hashing.py (np_* and t_* twins)
//   bloom_hit                      <- kernels/common.py bloom_hit
//   xor_lookup                     <- kernels/common.py xor_slots + xor_lookup
//   othello_hit                    <- kernels/lsm_probe.py othello_hit
// All arithmetic is uint32 and wraps mod 2^32, as the host versions do:
// seeds combine as seed*1000+i (Bloom), seed*7919+i (Xor slots), 3*seed+1
// and 3*seed+2 (Othello). fastrange is __umulhi, the exact floor(h*n/2^32)
// that the JAX package builds from 16-bit partial products.
#pragma once

#include <cstdint>

namespace probe {

constexpr uint32_t kFmixC1 = 0x85EBCA6Bu;
constexpr uint32_t kFmixC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kFmixC1;
  x ^= x >> 13;
  x *= kFmixC2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t hi, uint32_t lo,
                                             uint32_t seed) {
  uint32_t h = fmix32(lo ^ seed);
  return fmix32(h ^ hi ^ (seed * kGolden));
}

__device__ __forceinline__ uint32_t fastrange(uint32_t h, uint32_t n) {
  return __umulhi(h, n);
}

// Read-only bank word through the non-coherent (texture) path.
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ words,
                                         uint32_t i) {
  return __ldg(words + i);
}

// k-hash Bloom test: bit fastrange(hash(seed*1000+i), m_bits) for every i;
// the first zero bit decides a miss, so later hashes are skipped.
__device__ __forceinline__ bool bloom_hit(const uint32_t* __restrict__ words,
                                          uint32_t hi, uint32_t lo,
                                          uint32_t m_bits, uint32_t k,
                                          uint32_t seed, uint32_t offset) {
  for (uint32_t i = 0; i < k; ++i) {
    uint32_t idx = fastrange(hash_u32(hi, lo, seed * 1000u + i), m_bits);
    if (((word(words, offset + (idx >> 5)) >> (idx & 31u)) & 1u) == 0u) {
      return false;
    }
  }
  return true;
}

// XOR of the key's three Bloomier slots. Uniform layout: slot i lies in
// segment i. Fuse layout: a window of three consecutive segments starting
// at fastrange(hash(seed*7919+3), n_seg-2).
__device__ __forceinline__ uint32_t xor_lookup(const uint32_t* __restrict__ words,
                                               uint32_t hi, uint32_t lo,
                                               bool fuse, uint32_t seed,
                                               uint32_t seg_len,
                                               uint32_t n_seg_m2,
                                               uint32_t offset) {
  uint32_t base = seed * 7919u;
  uint32_t start = fuse ? fastrange(hash_u32(hi, lo, base + 3u), n_seg_m2) : 0u;
  uint32_t v = 0u;
#pragma unroll
  for (uint32_t i = 0; i < 3u; ++i) {
    uint32_t h = fastrange(hash_u32(hi, lo, base + i), seg_len);
    v ^= word(words, offset + (start + i) * seg_len + h);
  }
  return v;
}

// Stage 1 of an LSM ChainedFilter: the alpha-bit fingerprint match.
__device__ __forceinline__ bool xor_stage1(const uint32_t* __restrict__ words,
                                           uint32_t hi, uint32_t lo, bool fuse,
                                           uint32_t seed, uint32_t seg_len,
                                           uint32_t n_seg_m2, uint32_t offset,
                                           uint32_t alpha_mask,
                                           uint32_t fp_seed) {
  uint32_t v = xor_lookup(words, hi, lo, fuse, seed, seg_len, n_seg_m2, offset);
  return ((v ^ hash_u32(hi, lo, fp_seed)) & alpha_mask) == 0u;
}

// Othello 1-bit classifier: A[u] ^ B[v] over LSB-first packed bitmaps.
__device__ __forceinline__ bool othello_hit(const uint32_t* __restrict__ words,
                                            uint32_t hi, uint32_t lo,
                                            uint32_t ma, uint32_t mb,
                                            uint32_t seed, uint32_t off_a,
                                            uint32_t off_b) {
  uint32_t u = fastrange(hash_u32(hi, lo, seed * 3u + 1u), ma);
  uint32_t v = fastrange(hash_u32(hi, lo, seed * 3u + 2u), mb);
  uint32_t a = word(words, off_a + (u >> 5)) >> (u & 31u);
  uint32_t b = word(words, off_b + (v >> 5)) >> (v & 31u);
  return ((a ^ b) & 1u) != 0u;
}

}  // namespace probe
