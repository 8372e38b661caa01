// Fused ChainedFilterAnd probe (paper §4, Algorithm 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/chained_probe.py:chained_probe
// (body _kernel): an optional alpha-bit Xor stage 1 AND a 1-bit exact
// Bloomier stage 2 over one packed bank, with the sequential probe count
// 1 + (stage 1 passed), or 1 for a filter without stage 1 (lambda < 2).
//
// What bounds it here (PERF.md, Findings; NVIDIA H100 80GB HBM3, 700 W):
// the rate of its random 4-byte gathers (3 a key for stage 1, 3 more where
// stage 1 passes), not the integer work: ~123-130 G gathers/s over the
// filters cell's 13.8 MB bank, an L2 sector a gather, whether every key
// passes stage 1 (0.185 ms), 1/8 do (0.109 ms) or the cell's mix (19%,
// 0.115 ms). The time follows the gathers the keys need: stage 2's early
// exit costs no lost lanes that show. Where both stages' narrow planes fit
// one block, the on-chip path (bloomier_onchip.cu) reads them from shared
// memory instead.
//
// What the design does about it: one thread per key over flat hi/lo
// lanes, stage 2 skipped where stage 1 rejects (member is then 0 and the
// probe count 1, the same outputs as evaluating both), the stages' fields
// passed by value as kernel parameters, and the lack of a stage 1 a
// runtime flag of this one kernel. The TPU kernel's branch-free form
// evaluates both stages on every key; here a warp pays stage 2 only when
// one of its 32 lanes passed stage 1.
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chained_probe_kernel(const uint32_t* __restrict__ words,
                     const uint32_t* __restrict__ hi,
                     const uint32_t* __restrict__ lo,
                     int32_t* __restrict__ member,
                     int32_t* __restrict__ probes, int32_t has_stage1,
                     probe::BloomierParams s1, probe::BloomierParams s2,
                     int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t h = hi[i];
  const uint32_t l = lo[i];
  const bool pass1 = !has_stage1 || probe::bloomier_match(words, h, l, s1);
  member[i] = static_cast<int32_t>(pass1 && probe::bloomier_match(words, h, l, s2));
  probes[i] = has_stage1 ? 1 + static_cast<int32_t>(pass1) : 1;
}

}  // namespace

// stage1 / stage2: kBloomierFields host words each (kernels/xor_probe.py
// bloomier_fields); stage1 is read only when has_stage1 is set
extern "C" int chained_probe_launch(const void* words, const void* hi,
                                    const void* lo, void* member, void* probes,
                                    int32_t has_stage1, const uint32_t* stage1,
                                    const uint32_t* stage2, int64_t n,
                                    void* stream) {
  if (n > 0) {
    chained_probe_kernel<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(hi),
        static_cast<const uint32_t*>(lo), static_cast<int32_t*>(member),
        static_cast<int32_t*>(probes), has_stage1,
        probe::bloomier_params(stage1), probe::bloomier_params(stage2), n);
  }
  return static_cast<int>(cudaGetLastError());
}
