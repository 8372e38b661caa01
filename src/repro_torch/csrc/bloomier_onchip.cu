// On-chip path of the Bloomier probes for Hopper (sm_90a): xor_probe,
// exact_probe and chained_probe reading each table's narrow plane (the low
// alpha bits of every slot, kernels/bloomier_onchip.py pack_plane) from the
// shared memory of every block, where the planes fit one block.
//
// Replaces, beside the gather kernels of xor_probe.cu and chained_probe.cu,
// the TPU kernels src/repro/kernels/xor_probe.py:65 (xor_probe),
// src/repro/kernels/xor_probe.py:77 (exact_probe) and
// src/repro/kernels/chained_probe.py:58 (chained_probe) on every probe that
// kernels/bloomier_onchip.py onchip_reason sends here. The TPU kernels kept
// the whole table in VMEM; this path keeps the bits the compare reads.
// Outputs are bit-identical to the gather kernels' (the slots, hashes and
// compare are probe_common.cuh's, over a SharedPlane word source).
//
// What bounds these probes on this card (PERF.md, Findings; NVIDIA H100
// 80GB HBM3, 700 W): the gather kernels issue three random 4-byte reads a
// key, and once the table outgrows what an SM's L1 keeps (between 217 KB
// and 573 KB) each costs a 32-byte L2 sector: they run at ~125-139 G
// gathers/s from 573 KB to 14.5 MB, against ~353-416 G/s where the table
// stays in L1. Shared memory serves the random reads at the L1's rate.
//
// What this design does about it: persistent blocks of 1,024 threads (at
// most one round of them) each copy the probe's planes into shared memory
// once (one cp.async.bulk a plane on an mbarrier) and walk the keys with a
// grid stride, one key a thread, loading the next key's lanes while they
// probe the current one; every slot is a field read from shared memory.
// A plane holds alpha bits a slot (rounded up to 1, 2, 4, 8 or 16), so a
// 1-bit exact table of 1.74M slots (217 KB) fits where its words (6.9 MB)
// would not. Planes that do not fit one block stay on the gather kernels:
// a cluster variant that sharded them by fuse window across 2-8 blocks
// measured 2.3-6.6x slower than the gather kernels and was removed (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "probe_common.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 1024;   // kernels/bloomier_onchip.py THREADS

// One stage as kernels/bloomier_onchip.py stage_words lays it out: the 8
// BloomierParams words (offset unused: a plane is indexed by slot), then
// the plane's field geometry and where it lies in shared memory.
struct Stage {
  probe::BloomierParams p;
  uint32_t log_fields;   // log2(32 / width)
  uint32_t log_width;
  uint32_t field_mask;   // 2^width - 1
  uint32_t smem_word;    // first shared-memory word of the plane
  uint32_t n_words;      // plane words (a multiple of 4)
  uint32_t pad[3];
};
static_assert(sizeof(Stage) == 4 * 16, "Stage is 16 host words");

struct Args {
  Stage s[2];
  const uint32_t* plane[2];
  const uint32_t* hi;
  const uint32_t* lo;
  int32_t* member;
  int32_t* probes;   // null: no probe counts (xor, exact)
  int64_t n;
  int32_t n_stages;  // 2: stage 1 AND stage 2 (probes 1 + pass)
};

__device__ __forceinline__ probe::SharedPlane plane_of(const uint32_t* smem,
                                                       const Stage& s) {
  return probe::SharedPlane{smem + s.smem_word, s.log_fields, s.log_width,
                            s.field_mask};
}

__device__ __forceinline__ bool match(const probe::SharedPlane& plane,
                                      const Stage& s, uint32_t hi,
                                      uint32_t lo) {
  const uint32_t start =
      s.p.fuse ? probe::window_start(hi, lo, s.p.seed, s.p.n_seg_m2) : 0u;
  return probe::bloomier_match(plane, hi, lo, start, s.p);
}

__global__ void __launch_bounds__(kThreads)
onchip_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
    for (int k = 0; k < a.n_stages; ++k) bytes += 4u * a.s[k].n_words;
    tma::mbar_expect_tx(&bar, bytes);
    for (int k = 0; k < a.n_stages; ++k) {
      tma::bulk_copy(smem + a.s[k].smem_word, a.plane[k],
                     4u * a.s[k].n_words, &bar);
    }
  }
  const probe::SharedPlane p0 = plane_of(smem, a.s[0]);
  const probe::SharedPlane p1 = plane_of(smem, a.s[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  // the first key's lanes load while the planes stream in
  uint32_t h = 0u, l = 0u;
  if (i < a.n) {
    h = __ldcs(a.hi + i);
    l = __ldcs(a.lo + i);
  }
  tma::mbar_wait(&bar, 0u);
  for (; i < a.n; i += stride) {
    const int64_t next = i + stride;
    uint32_t hn = 0u, ln = 0u;
    if (next < a.n) {
      hn = __ldcs(a.hi + next);
      ln = __ldcs(a.lo + next);
    }
    const bool m0 = match(p0, a.s[0], h, l);
    if (a.n_stages == 2) {
      a.member[i] = static_cast<int32_t>(m0 && match(p1, a.s[1], h, l));
      a.probes[i] = 1 + static_cast<int32_t>(m0);
    } else {
      a.member[i] = static_cast<int32_t>(m0);
      if (a.probes != nullptr) a.probes[i] = 1;
    }
    h = hn;
    l = ln;
  }
}

}  // namespace

// stages: n_stages x 16 host words (kernels/bloomier_onchip.py
// stage_words); planes: each stage's plane, 16-byte aligned, its words a
// multiple of 4; probes may be null with one stage. smem_bytes: the
// planes' shared memory a block takes; want_blocks: the grid the keys ask
// for (capped at one round of resident blocks).
extern "C" int bloomier_onchip_launch(const uint32_t* stages, int32_t n_stages,
                                      const void* plane0, const void* plane1,
                                      uint32_t smem_bytes, const void* hi,
                                      const void* lo, void* member,
                                      void* probes, int64_t n,
                                      int64_t want_blocks, void* stream) {
  if (n_stages < 1 || n_stages > 2 || (n_stages == 2 && probes == nullptr) ||
      want_blocks < 1 || reinterpret_cast<uintptr_t>(plane0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(plane1) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  Args a = {};
  const Stage* s = reinterpret_cast<const Stage*>(stages);
  a.s[0] = s[0];
  a.s[1] = n_stages == 2 ? s[1] : s[0];
  a.plane[0] = static_cast<const uint32_t*>(plane0);
  a.plane[1] = static_cast<const uint32_t*>(plane1);
  a.hi = static_cast<const uint32_t*>(hi);
  a.lo = static_cast<const uint32_t*>(lo);
  a.member = static_cast<int32_t*>(member);
  a.probes = static_cast<int32_t*>(probes);
  a.n = n;
  a.n_stages = n_stages;
  cudaError_t err = cudaFuncSetAttribute(
      onchip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onchip_kernel,
                                                      kThreads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one round of resident blocks at most: each stages the planes once
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t blocks = want_blocks < resident ? want_blocks : resident;
  onchip_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
