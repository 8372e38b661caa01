// Bloomier-table probes for Hopper (sm_90a): the alpha-bit Xor filter
// (xor_probe) and the 1-bit exact Bloomier (exact_probe).
//
// Replaces the TPU kernels src/repro/kernels/xor_probe.py:xor_probe (body
// _kernel) and src/repro/kernels/xor_probe.py:exact_probe (body
// _kernel_exact). Both are one test per key, ((T[s0] ^ T[s1] ^ T[s2]) ^
// target) & mask == 0 (probe_common.cuh bloomier_match), so both wrappers
// launch the one kernel below with their own mask and target: the Xor
// filter's 2^alpha - 1 (alpha = 1..32, 0xFFFFFFFF at 32, made on the host)
// and hash(fp_seed); the exact filter's 1 and hash(bit_seed) (strategy a)
// or the constant 1 (strategy b).
//
// What bounds it here (PERF.md, Findings; NVIDIA H100 80GB HBM3, 700 W):
// the rate of its three random 4-byte gathers a key, not the integer
// work. Over synthetic tables at 4M keys it runs at 393-405 G gathers/s
// where every gather hits an SM's L1 (96 B-24 KB: the hash-and-issue
// floor, 0.030 ms, near the 0.027 ms the ~113 integer ops a key take at
// the INT32 peak), 344 G/s at 217 KB, then 125-138 G/s from 573 KB to
// 14.5 MB, where each gather costs a 32-byte L2 sector, and 47 G/s at
// 67 MB, past the L2. The filters cell's tables (4.6 and 6.9 MB) sit on
// the L2 plateau: 0.095 ms against a 0.027 ms bound. Where the table's
// narrow plane fits one block, the on-chip path (bloomier_onchip.cu)
// reads it from shared memory instead.
//
// What the design does about it: one thread per key over flat hi/lo lanes
// (coalesced key loads and stores), the hashes and XOR in registers, the
// table read through the read-only path, the table's fields passed by
// value as kernel parameters (constant bank) so no thread loads them.
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bloomier_probe_kernel(const uint32_t* __restrict__ words,
                      const uint32_t* __restrict__ hi,
                      const uint32_t* __restrict__ lo,
                      int32_t* __restrict__ out, probe::BloomierParams p,
                      int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<int32_t>(probe::bloomier_match(words, hi[i], lo[i], p));
}

}  // namespace

// fields: kBloomierFields host words (kernels/xor_probe.py bloomier_fields)
extern "C" int bloomier_probe_launch(const void* words, const void* hi,
                                     const void* lo, void* out,
                                     const uint32_t* fields, int64_t n,
                                     void* stream) {
  if (n > 0) {
    bloomier_probe_kernel<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(hi),
        static_cast<const uint32_t*>(lo), static_cast<int32_t*>(out),
        probe::bloomier_params(fields), n);
  }
  return static_cast<int>(cudaGetLastError());
}
