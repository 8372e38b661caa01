// Device functions shared by the probe kernels (lsm_probe.cu, lsm_window.cu,
// bloom_probe.cu, bloom_onchip.cu, xor_probe.cu, chained_probe.cu,
// bloomier_onchip.cu, cascade_probe.cu).
//
// Each mirrors, bit for bit, a host function of the port and of the JAX
// package:
//   fmix32 / hash_u32 / fastrange  <- core/hashing.py (np_* and t_* twins)
//   bloom_hit                      <- kernels/common.py bloom_hit
//   xor_lookup                     <- kernels/common.py xor_slots + xor_lookup
//   bloomier_match                 <- kernels/ref.py xor_probe_ref and
//                                     exact_bloomier_ref
//   SharedPlane                    <- kernels/bloomier_onchip.py pack_plane
//   othello_hit                    <- kernels/common.py othello_hit
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

// Where a Bloom test reads its words: the bank in global memory through
// the read-only path, or a copy staged in this block's shared memory.
// Each is indexed by the word's position in its source.
struct GlobalWords {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](uint32_t i) const {
    return __ldg(p + i);
  }
};

struct SharedWords {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](uint32_t i) const {
    return p[i];
  }
};

// A Bloomier table's narrow plane staged in shared memory: the low bits of
// each slot as a field of 2^log_width bits (1, 2, 4, 8 or 16), packed
// LSB-first, 2^log_fields fields a word, so no field straddles a word.
// Indexed by the slot's position in its table. The bits above alpha are 0,
// so a compare under a mask of alpha bits sees what the slot word gives.
struct SharedPlane {
  const uint32_t* p;
  uint32_t log_fields;   // log2(32 / width)
  uint32_t log_width;
  uint32_t field_mask;   // 2^width - 1
  __device__ __forceinline__ uint32_t operator[](uint32_t slot) const {
    const uint32_t w = p[slot >> log_fields];
    return (w >> ((slot & ((1u << log_fields) - 1u)) << log_width)) &
           field_mask;
  }
};

// k-hash Bloom test: bit fastrange(hash(seed*1000+i), m_bits) for every i;
// the first zero bit decides a miss, so later hashes are skipped. One
// function for every word source, so the hash, the fastrange and the exit
// are the same wherever the bitmap lives.
template <class Words>
__device__ __forceinline__ bool bloom_hit(const Words& words, uint32_t hi,
                                          uint32_t lo, uint32_t m_bits,
                                          uint32_t k, uint32_t seed,
                                          uint32_t offset) {
  for (uint32_t i = 0; i < k; ++i) {
    uint32_t idx = fastrange(hash_u32(hi, lo, seed * 1000u + i), m_bits);
    if (((words[offset + (idx >> 5)] >> (idx & 31u)) & 1u) == 0u) {
      return false;
    }
  }
  return true;
}

// The Bloom test over the bank in global memory.
__device__ __forceinline__ bool bloom_hit(const uint32_t* __restrict__ words,
                                          uint32_t hi, uint32_t lo,
                                          uint32_t m_bits, uint32_t k,
                                          uint32_t seed, uint32_t offset) {
  return bloom_hit(GlobalWords{words}, hi, lo, m_bits, k, seed, offset);
}

// Fuse layout: the first of the key's three consecutive segments,
// fastrange(hash(seed*7919+3), n_seg-2). The gather path (xor_lookup) and
// the window path's partition (lsm_window.cu) both call this one function.
__device__ __forceinline__ uint32_t window_start(uint32_t hi, uint32_t lo,
                                                 uint32_t seed,
                                                 uint32_t n_seg_m2) {
  return fastrange(hash_u32(hi, lo, seed * 7919u + 3u), n_seg_m2);
}

// The key's slot i within its segment: fastrange(hash(seed*7919+i), seg_len).
__device__ __forceinline__ uint32_t segment_slot(uint32_t hi, uint32_t lo,
                                                 uint32_t seed, uint32_t i,
                                                 uint32_t seg_len) {
  return fastrange(hash_u32(hi, lo, seed * 7919u + i), seg_len);
}

// XOR of the key's three Bloomier slots in the window of three segments
// that starts at segment `start` (0 for the uniform layout, whose slot i
// lies in segment i), read from any slot source: the bank (GlobalWords,
// `offset` the table's first word) or a staged plane (SharedPlane,
// `offset` 0).
template <class Slots>
__device__ __forceinline__ uint32_t xor_window(const Slots& slots, uint32_t hi,
                                               uint32_t lo, uint32_t start,
                                               uint32_t seed, uint32_t seg_len,
                                               uint32_t offset) {
  uint32_t v = 0u;
#pragma unroll
  for (uint32_t i = 0; i < 3u; ++i) {
    v ^= slots[offset + (start + i) * seg_len +
               segment_slot(hi, lo, seed, i, seg_len)];
  }
  return v;
}

// XOR of the key's three Bloomier slots. Uniform layout: slot i lies in
// segment i. Fuse layout: a window of three consecutive segments starting
// at window_start.
__device__ __forceinline__ uint32_t xor_lookup(const uint32_t* __restrict__ words,
                                               uint32_t hi, uint32_t lo,
                                               bool fuse, uint32_t seed,
                                               uint32_t seg_len,
                                               uint32_t n_seg_m2,
                                               uint32_t offset) {
  uint32_t start = fuse ? window_start(hi, lo, seed, n_seg_m2) : 0u;
  return xor_window(GlobalWords{words}, hi, lo, start, seed, seg_len, offset);
}

// One Bloomier table of a packed bank and the test a key must pass there
// (kernels/xor_probe.py bloomier_fields builds it on the host):
//   Xor filter:         mask = 2^alpha - 1, target = hash(fp_seed)
//   exact, strategy a:  mask = 1,           target = hash(bit_seed)
//   exact, strategy b:  mask = 1,           target = 1
struct BloomierParams {
  uint32_t fuse;         // 1 = fuse slot layout, 0 = uniform
  uint32_t seed;         // slot seed
  uint32_t seg_len;
  uint32_t n_seg_m2;     // max(n_seg - 2, 1): the fuse window's range
  uint32_t offset;       // first word of the table in the bank
  uint32_t mask;         // the value bits compared (0xFFFFFFFF at alpha 32)
  uint32_t hash_target;  // 1: target = hash(target_seed); 0: target itself
  uint32_t target;
};

// The key's target compared with a slot XOR in the bits of mask.
__device__ __forceinline__ bool bloomier_decide(uint32_t v, uint32_t hi,
                                                uint32_t lo,
                                                const BloomierParams& p) {
  uint32_t t = p.hash_target ? hash_u32(hi, lo, p.target) : p.target;
  return ((v ^ t) & p.mask) == 0u;
}

// The key's three-slot XOR equals its target in the bits of mask.
__device__ __forceinline__ bool bloomier_match(const uint32_t* __restrict__ words,
                                               uint32_t hi, uint32_t lo,
                                               const BloomierParams& p) {
  uint32_t v = xor_lookup(words, hi, lo, p.fuse != 0u, p.seed, p.seg_len,
                          p.n_seg_m2, p.offset);
  return bloomier_decide(v, hi, lo, p);
}

// bloomier_match over a staged plane, the key's window start given (0 for
// the uniform layout): the same slots, hash and compare.
__device__ __forceinline__ bool bloomier_match(const SharedPlane& plane,
                                               uint32_t hi, uint32_t lo,
                                               uint32_t start,
                                               const BloomierParams& p) {
  uint32_t v = xor_window(plane, hi, lo, start, p.seed, p.seg_len, 0u);
  return bloomier_decide(v, hi, lo, p);
}

// Stage 1 of an LSM ChainedFilter: the alpha-bit fingerprint match.
__device__ __forceinline__ bool xor_stage1(const uint32_t* __restrict__ words,
                                           uint32_t hi, uint32_t lo, bool fuse,
                                           uint32_t seed, uint32_t seg_len,
                                           uint32_t n_seg_m2, uint32_t offset,
                                           uint32_t alpha_mask,
                                           uint32_t fp_seed) {
  return bloomier_match(words, hi, lo,
                        BloomierParams{fuse ? 1u : 0u, seed, seg_len, n_seg_m2,
                                       offset, alpha_mask, 1u, fp_seed});
}

// Fill a BloomierParams from its 8 host words, in field order.
inline BloomierParams bloomier_params(const uint32_t* f) {
  return BloomierParams{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7]};
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
