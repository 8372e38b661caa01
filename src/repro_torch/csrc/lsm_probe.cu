// Gather path of the fused LSM filter probe (lsm_probe: every probe that
// its window path, lsm_window.cu, does not take) and the single-chain
// probe (lsm_chain_probe: always) for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/lsm_probe.py:lsm_probe (body
// _kernel, vectorized _grouped_chain_hits + scalar _table_hit) and
// src/repro/kernels/lsm_probe.py:lsm_chain_probe (body _kernel_single).
//
// What bounds it here: integer work. Per key and per two-stage chain table
// stage 1 hashes 5 times (fmix32 twice each: the fuse window, 3 slots, the
// fingerprint) and gathers 3 random bank words; stage 2 (2 hashes, 2
// gathers) runs only where stage 1 passes: on one table for a stored key
// and on about 2^-alpha of the others. A 16-table probe of 1M keys is
// ~1.9 G integer ops against ~57 MB of compulsory traffic (keys, outputs,
// the bank once), so the INT32 pipes, not HBM, set the floor. The gathers
// are random 4-byte reads: each costs a 32-byte sector, served from L2
// while the bank (~41 MB at 8M keys) stays under the card's 50 MB L2.
//
// What the design does about it: one thread per key over flat hi/lo
// lanes (coalesced key loads and output stores), a loop over the T <= 32
// tables inside the thread so each key is loaded once per store and the
// newest-first reduction (first_hit, hits_mask) stays in registers, stage
// 2 skipped where stage 1 rejects (in both kernels), and the bank read
// through the read-only path. Every table's tag and fields travel in one int32
// [T, 16] descriptor array, staged in shared memory once per block, so a
// new generation with the same shape reuses the same code with new
// inputs. No tensor cores or TMA: the work is gathers and integer hashing.
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int kDescK = 16;       // int32 words per table descriptor
constexpr int kMaxTables = 32;   // hits_mask is one 32-bit word
constexpr int kTagChain = 0;
constexpr int kTagBloom = 1;
constexpr int kTagAlways = 2;
constexpr int kThreads = 256;

// Descriptor row (kernels/lsm_probe.py desc_row): [tag, has_stage1, fuse,
// f3 .. f15]
//   chain:  f3..f8 = stage-1 seed, seg_len, n_seg-2, offset, alpha mask,
//           fingerprint seed; f9..f13 = ma, mb, othello seed, offsets A, B
//   bloom:  f3..f6 = m_bits, k, seed, offset
__device__ __forceinline__ bool chain_hit(const uint32_t* __restrict__ words,
                                          const uint32_t* f, uint32_t hi,
                                          uint32_t lo) {
  // stage 2 only where stage 1 passes (s1 & s2, the same decision)
  if (f[1] && !probe::xor_stage1(words, hi, lo, f[2] != 0, f[3], f[4], f[5],
                                 f[6], f[7], f[8])) {
    return false;
  }
  return probe::othello_hit(words, hi, lo, f[9], f[10], f[11], f[12], f[13]);
}

__device__ __forceinline__ bool table_hit(const uint32_t* __restrict__ words,
                                          const int32_t* d, uint32_t hi,
                                          uint32_t lo) {
  const uint32_t* f = reinterpret_cast<const uint32_t*>(d);
  switch (d[0]) {
    case kTagChain:
      return chain_hit(words, f, hi, lo);
    case kTagBloom:
      return probe::bloom_hit(words, hi, lo, f[3], f[4], f[5], f[6]);
    case kTagAlways:
    default:  // the wrapper admits no other tag
      return true;
  }
}

__global__ void __launch_bounds__(kThreads)
lsm_probe_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ desc, int32_t n_tables,
                 const uint32_t* __restrict__ hi,
                 const uint32_t* __restrict__ lo, int32_t* __restrict__ first,
                 int32_t* __restrict__ mask, int64_t n) {
  __shared__ int32_t sdesc[kMaxTables * kDescK];
  for (int j = threadIdx.x; j < n_tables * kDescK; j += blockDim.x) {
    sdesc[j] = desc[j];
  }
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t h = hi[i];
  const uint32_t l = lo[i];
  uint32_t bits = 0u;
  for (int t = 0; t < n_tables; ++t) {
    bits |= static_cast<uint32_t>(table_hit(words, sdesc + t * kDescK, h, l))
            << t;
  }
  // lowest set bit = newest table that fired; none fired -> n_tables
  first[i] = bits ? __ffs(bits) - 1 : n_tables;
  mask[i] = static_cast<int32_t>(bits);
}

__global__ void __launch_bounds__(kThreads)
lsm_chain_probe_kernel(const uint32_t* __restrict__ words,
                       const uint32_t* __restrict__ hi,
                       const uint32_t* __restrict__ lo,
                       int32_t* __restrict__ member,
                       int32_t* __restrict__ probes, int32_t has_stage1,
                       int32_t fuse, uint32_t seed, uint32_t seg_len,
                       uint32_t n_seg_m2, uint32_t xor_offset,
                       uint32_t alpha_mask, uint32_t fp_seed, uint32_t ma,
                       uint32_t mb, uint32_t oth_seed, uint32_t off_a,
                       uint32_t off_b, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t h = hi[i];
  const uint32_t l = lo[i];
  bool s1 = true;
  if (has_stage1) {
    s1 = probe::xor_stage1(words, h, l, fuse != 0, seed, seg_len, n_seg_m2,
                           xor_offset, alpha_mask, fp_seed);
  }
  // stage 2 only where stage 1 passes (s1 & s2, the same decision)
  const bool s2 = s1 && probe::othello_hit(words, h, l, ma, mb, oth_seed,
                                           off_a, off_b);
  member[i] = static_cast<int32_t>(s2);
  // sequential probe count: the Othello stage is touched only when stage 1
  // fires; a chain without stage 1 costs one probe
  probes[i] = has_stage1 ? 1 + static_cast<int32_t>(s1) : 1;
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int lsm_probe_launch(const void* words, const void* desc,
                                int32_t n_tables,
                                const void* hi, const void* lo, void* first,
                                void* mask, int64_t n, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables) return cudaErrorInvalidValue;
  if (n > 0) {
    lsm_probe_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(desc), n_tables,
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<int32_t*>(first), static_cast<int32_t*>(mask), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lsm_chain_probe_launch(
    const void* words, const void* hi, const void* lo, void* member,
    void* probes, int32_t has_stage1, int32_t fuse, uint32_t seed,
    uint32_t seg_len, uint32_t n_seg_m2, uint32_t xor_offset,
    uint32_t alpha_mask, uint32_t fp_seed, uint32_t ma, uint32_t mb,
    uint32_t oth_seed, uint32_t off_a, uint32_t off_b, int64_t n,
    void* stream) {
  if (n > 0) {
    lsm_chain_probe_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<int32_t*>(member), static_cast<int32_t*>(probes),
        has_stage1, fuse, seed, seg_len, n_seg_m2, xor_offset, alpha_mask,
        fp_seed, ma, mb, oth_seed, off_a, off_b, n);
  }
  return static_cast<int>(cudaGetLastError());
}
