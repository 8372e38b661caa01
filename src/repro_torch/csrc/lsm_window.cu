// Window path of the fused LSM filter probe (lsm_probe) for Hopper
// (sm_90a).
//
// Replaces, beside the gather kernel of lsm_probe.cu, the TPU kernel
// src/repro/kernels/lsm_probe.py:270 (lsm_probe) on every probe that
// kernels/lsm_window.py path_reason sends here: every table a two-stage
// chain with a fuse stage 1 whose window fits the shared-memory budget,
// is 16-byte aligned and has enough keys of the batch to pay for its
// copy, enough tables to pay for the partition, and scratch within its
// share of the card's memory. Outputs are bit-identical to the gather
// path's.
//
// What bounds the gather path on this card: each key costs three random
// 4-byte stage-1 gathers per table, and each costs a whole 32-byte L2
// sector (52.8 M sectors, 1.69 GB, at 1M keys x 16 tables). They move at
// ~3.5 TB/s out of L2, so the sector rate, not the integer pipes, sets
// its pace.
//
// What this design does about it: a fuse-layout key's three slots lie in
// three consecutive segments starting at probe::window_start, one
// contiguous window of 3 * seg_len words (96 KB at 500k keys per table).
//   1. Partition (count, scan, scatter): each 4096-key unit counts its
//      keys per (table, window) bucket in shared memory, a scan turns the
//      bucket x unit counts into offsets, and the scatter writes each
//      key-table's hi, lo and key index (12 B) in bucket order as SoA
//      scratch. The order is stable (units in key order, keys ranked
//      inside a unit by warp ballots), so the scratch equals its torch twin
//      (kernels/lsm_window.py partition_ref) and runs are written
//      coalesced.
//   2. Probe: persistent blocks take (bucket, chunk) items from an atomic
//      counter. One thread copies the item's window into shared memory
//      with cp.async.bulk completing on an mbarrier, double-buffered so
//      the next window streams in while the current one is probed. Stage
//      1 reads shared memory only; the Othello stage 2 reads global
//      memory only where stage 1 passes. A key that passes stage 1 ORs
//      the table's bit (0 where stage 2 rejects) into hits_mask with
//      atomicOr (order-free, so deterministic); stage-1 misses write
//      nothing.
//   3. Finalize: first_hit = lowest set bit of hits_mask, or T.
// The random L2 sectors fall to stage 2's; in their place come the
// coalesced scratch writes and reads and the bulk window copies.
//
// What bounds this path (PERF.md, Findings): the partition's ranking and
// scratch writes (the scatter is its largest kernel) and the probe's
// integer hashing, in kernels that run one after another. Its fixed cost
// of six launches and whole passes over the keys is why a bank of few
// tables, and the single-table lsm_chain_probe, stay on the gather path.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe_common.cuh"
#include "tma.cuh"

namespace {

constexpr int kDescK = 16;       // int32 words per table descriptor
constexpr int kMaxTables = 32;   // hits_mask is one 32-bit word
// descriptor fields (kernels/lsm_probe.py desc_row)
constexpr int kSeed = 3, kSegLen = 4, kNSegM2 = 5, kOffset = 6,
              kAlphaMask = 7, kFpSeed = 8, kMa = 9, kMb = 10, kOthSeed = 11,
              kOffA = 12, kOffB = 13;

// partition: one block per unit of kUnitKeys keys, 8 keys per thread;
// warp w owns the unit's keys [w * 256, (w + 1) * 256)
constexpr int kUnitThreads = 512;
constexpr int kUnitWarps = kUnitThreads / 32;
constexpr int kKeysPerThread = 8;
constexpr int kWarpKeys = 32 * kKeysPerThread;
constexpr int kUnitKeys = kUnitThreads * kKeysPerThread;  // lsm_window.py UNIT_KEYS
constexpr int kMaxWindows = 512;   // windows (n_seg - 2) per table: MAX_WINDOWS
static_assert(kMaxWindows <= kUnitThreads, "one window per scan thread");
static_assert(kUnitKeys <= 65535, "unit positions are uint16");
constexpr int kScanThreads = 256;
constexpr int kTotalsThreads = 1024;
// three scatter blocks per SM: at most 40 registers a thread
constexpr int kScatterBlocksPerSm = 3;
// one probe block per SM at seg_len 8192 (two 96 KB windows): 32 warps,
// each thread with kProbeUnroll keys' loads in flight
constexpr int kProbeThreads = 1024;
constexpr int kProbeUnroll = 4;
constexpr int kItemsPerBlock = 4;  // work items aimed at per resident block
constexpr int kThreads = 256;


struct Tables {
  uint32_t d[kMaxTables * kDescK];
  uint32_t base[kMaxTables + 1];   // first global bucket of each table
};

__device__ void load_tables(Tables& s, const int32_t* __restrict__ desc,
                            int n_tables) {
  for (int j = threadIdx.x; j < n_tables * kDescK; j += blockDim.x) {
    s.d[j] = static_cast<uint32_t>(desc[j]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t acc = 0;
    for (int t = 0; t < n_tables; ++t) {
      s.base[t] = acc;
      acc += s.d[t * kDescK + kNSegM2];
    }
    s.base[n_tables] = acc;
  }
  __syncthreads();
}

// Exclusive scan of one value per thread over the block; *total gets the
// block's sum. Every thread of the block calls it.
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < n_warps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[n_warps - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return before + x - v;
}

// This thread's keys of unit blockIdx.x: key j is unit key
// warp * 256 + j * 32 + lane (coalesced for each j).
__device__ __forceinline__ void load_unit_keys(const uint32_t* __restrict__ hi,
                                               const uint32_t* __restrict__ lo,
                                               int64_t n, uint32_t* h,
                                               uint32_t* l, bool* ok) {
  const int64_t unit0 = static_cast<int64_t>(blockIdx.x) * kUnitKeys;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int64_t i = unit0 + warp * kWarpKeys + j * 32 + lane;
    ok[j] = i < n;
    h[j] = ok[j] ? hi[i] : 0u;
    l[j] = ok[j] ? lo[i] : 0u;
  }
}

// counts[bucket * n_units + unit] = keys of the unit in the bucket;
// zero_out (hits_mask), where given, set to 0 for the unit's keys
__global__ void __launch_bounds__(kUnitThreads)
window_count_kernel(const int32_t* __restrict__ desc, int32_t n_tables,
                    const uint32_t* __restrict__ hi,
                    const uint32_t* __restrict__ lo, int64_t n,
                    uint32_t* __restrict__ counts, int32_t n_units,
                    int32_t* __restrict__ zero_out) {
  __shared__ Tables st;
  __shared__ uint32_t hist[kMaxWindows];
  load_tables(st, desc, n_tables);
  uint32_t h[kKeysPerThread], l[kKeysPerThread];
  bool ok[kKeysPerThread];
  load_unit_keys(hi, lo, n, h, l, ok);
  const int64_t key0 = static_cast<int64_t>(blockIdx.x) * kUnitKeys +
                       (threadIdx.x >> 5) * kWarpKeys + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    if (ok[j] && zero_out != nullptr) zero_out[key0 + j * 32] = 0;
  }
  for (int t = 0; t < n_tables; ++t) {
    const uint32_t* f = st.d + t * kDescK;
    const uint32_t n_win = f[kNSegM2];
    for (uint32_t b = threadIdx.x; b < n_win; b += blockDim.x) hist[b] = 0u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (ok[j]) {
        atomicAdd(&hist[probe::window_start(h[j], l[j], f[kSeed], n_win)], 1u);
      }
    }
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < n_win; b += blockDim.x) {
      counts[static_cast<int64_t>(st.base[t] + b) * n_units + blockIdx.x] =
          hist[b];
    }
    __syncthreads();
  }
}

// One block per bucket: its row of unit counts -> exclusive offsets in
// place; totals[bucket] = the bucket's keys.
__global__ void __launch_bounds__(kScanThreads)
window_scan_units_kernel(uint32_t* __restrict__ counts, int32_t n_units,
                         uint32_t* __restrict__ totals) {
  uint32_t* row = counts + static_cast<int64_t>(blockIdx.x) * n_units;
  uint32_t carry = 0;
  for (int c = 0; c < n_units; c += blockDim.x) {
    const int u = c + threadIdx.x;
    const uint32_t v = u < n_units ? row[u] : 0u;
    uint32_t sum;
    const uint32_t ex = block_exclusive_scan(v, &sum);
    if (u < n_units) row[u] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One block: bucket totals -> bstart[0 .. n_buckets] (exclusive, with the
// grand total last); the probe's work counter, where given, set to 0.
__global__ void __launch_bounds__(kTotalsThreads)
window_scan_totals_kernel(const uint32_t* __restrict__ totals,
                          int32_t n_buckets, uint32_t* __restrict__ bstart,
                          uint32_t* __restrict__ next_item) {
  if (next_item != nullptr && threadIdx.x == 0) *next_item = 0u;
  uint32_t carry = 0;
  for (int c = 0; c < n_buckets; c += blockDim.x) {
    const int g = c + threadIdx.x;
    const uint32_t v = g < n_buckets ? totals[g] : 0u;
    uint32_t sum;
    const uint32_t ex = block_exclusive_scan(v, &sum);
    if (g < n_buckets) bstart[g] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) bstart[n_buckets] = carry;
}

// Lanes of the warp whose v equals this lane's, for v < 2**bits: one
// ballot per bit (all 32 lanes call it), 7 at 70 windows, in place of
// __match_any_sync.
__device__ __forceinline__ uint32_t peers_of(uint32_t v, int bits) {
  uint32_t peers = 0xFFFFFFFFu;
  for (int b = 0; b < bits; ++b) {
    const bool set = (v >> b) & 1u;
    const uint32_t m = __ballot_sync(0xFFFFFFFFu, set);
    peers &= set ? m : ~m;
  }
  return peers;
}

// Zero the scatter's per-warp window counts, 32 bits at a time.
__device__ __forceinline__ void zero_whist(uint16_t (*whist)[kMaxWindows]) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&whist[0][0]);
  for (int j = threadIdx.x; j < kUnitWarps * kMaxWindows / 2; j += blockDim.x) {
    w[j] = 0u;
  }
}

// The scatter's dynamic shared memory: the unit's keys in window order.
struct UnitSort {
  uint32_t key_hi[kUnitKeys];   // unit position -> the key's lanes
  uint32_t key_lo[kUnitKeys];
  uint16_t key[kUnitKeys];      // unit position -> the key's unit index
  uint16_t win[kUnitKeys];      // unit position -> its window
};

// Each unit writes its keys of every table in bucket order at
// bstart[bucket] + counts[bucket, unit]: hi, lo and the key's index. The
// keys are sorted by window in shared memory first, so every window's run
// leaves as consecutive stores.
__global__ void __launch_bounds__(kUnitThreads, kScatterBlocksPerSm)
window_scatter_kernel(const int32_t* __restrict__ desc, int32_t n_tables,
                      const uint32_t* __restrict__ hi,
                      const uint32_t* __restrict__ lo, int64_t n,
                      const uint32_t* __restrict__ counts, int32_t n_units,
                      const uint32_t* __restrict__ bstart,
                      uint32_t* __restrict__ s_hi,
                      uint32_t* __restrict__ s_lo,
                      int32_t* __restrict__ s_idx) {
  __shared__ Tables st;
  __shared__ __align__(16) uint16_t whist[kUnitWarps][kMaxWindows];  // per warp
  __shared__ uint16_t lstart[kMaxWindows];   // window's first unit position
  __shared__ uint32_t gstart[kMaxWindows];   // its first scratch position
  extern __shared__ __align__(16) unsigned char unit_sort_raw[];
  UnitSort& us = *reinterpret_cast<UnitSort*>(unit_sort_raw);
  load_tables(st, desc, n_tables);
  uint32_t h[kKeysPerThread], l[kKeysPerThread];
  bool ok[kKeysPerThread];
  load_unit_keys(hi, lo, n, h, l, ok);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;
  const int64_t unit0 = static_cast<int64_t>(blockIdx.x) * kUnitKeys;
  const int unit_keys = static_cast<int>(
      n - unit0 < kUnitKeys ? n - unit0 : kUnitKeys);
  zero_whist(whist);
  for (int t = 0; t < n_tables; ++t) {
    const uint32_t* f = st.d + t * kDescK;
    const uint32_t n_win = f[kNSegM2];
    const int n_bits = 32 - __clz(n_win);   // windows and the sentinel n_win
    // window b's first scratch position for this unit, loaded now so its
    // latency passes under the ranking
    const uint32_t b = threadIdx.x;
    uint32_t g_first = 0;
    if (b < n_win) {
      const uint32_t g = st.base[t] + b;
      g_first = bstart[g] + counts[static_cast<int64_t>(g) * n_units +
                                   blockIdx.x];
    }
    __syncthreads();
    // each key's window; per-warp counts by its groups of equal windows
    uint32_t win[kKeysPerThread], peers[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      win[j] = ok[j] ? probe::window_start(h[j], l[j], f[kSeed], n_win)
                     : n_win;
      peers[j] = peers_of(win[j], n_bits);
      if (ok[j] && lane == __ffs(peers[j]) - 1) {
        whist[warp][win[j]] += __popc(peers[j]);
      }
      __syncwarp();
    }
    __syncthreads();
    // per window: warp offsets inside the window, then window starts
    uint32_t tot = 0;
    if (b < n_win) {
      for (int w = 0; w < kUnitWarps; ++w) {
        const uint32_t c = whist[w][b];
        whist[w][b] = static_cast<uint16_t>(tot);
        tot += c;
      }
    }
    uint32_t unit_total;
    const uint32_t ls = block_exclusive_scan(b < n_win ? tot : 0u, &unit_total);
    if (b < n_win) {
      lstart[b] = static_cast<uint16_t>(ls);
      gstart[b] = g_first;
    }
    __syncthreads();
    // stable rank: earlier warps, then earlier groups, then lower lanes
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (ok[j]) {
        const uint32_t pos = lstart[win[j]] + whist[warp][win[j]] +
                             __popc(peers[j] & lanes_below);
        us.key_hi[pos] = h[j];
        us.key_lo[pos] = l[j];
        us.key[pos] = static_cast<uint16_t>(warp * kWarpKeys + j * 32 + lane);
        us.win[pos] = static_cast<uint16_t>(win[j]);
      }
      __syncwarp();
      if (ok[j] && lane == __ffs(peers[j]) - 1) {
        whist[warp][win[j]] += __popc(peers[j]);
      }
      __syncwarp();
    }
    __syncthreads();
    // a window's run of unit positions is a run of scratch positions
    for (int p = threadIdx.x; p < unit_keys; p += blockDim.x) {
      const uint32_t w = us.win[p];
      const uint32_t g = gstart[w] + (p - lstart[w]);
      // streaming stores: the scratch is read once, and should not evict
      // the bank from L2
      __stcs(s_hi + g, us.key_hi[p]);
      __stcs(s_lo + g, us.key_lo[p]);
      __stcs(s_idx + g, static_cast<int32_t>(unit0 + us.key[p]));
    }
    zero_whist(whist);   // for the next table
    __syncthreads();
  }
}

// The probe pass's view of one work item, in shared memory per stage.
struct Item {
  int32_t table;     // -1: no more items
  uint32_t window;   // window index inside the table
  uint32_t begin, end;   // scratch positions [begin, end)
};

// Thread 0: take work item `item` (a chunk of a bucket) into stage s and
// start its window copy. Items past n_items stop the block.
__device__ void issue_item(uint32_t item, int32_t n_items, int32_t parts,
                           const Tables& st, const uint32_t* __restrict__ bstart,
                           const uint32_t* __restrict__ words, uint32_t* buf,
                           uint64_t* bar, Item* it) {
  if (item >= static_cast<uint32_t>(n_items)) {
    it->table = -1;
    return;
  }
  const uint32_t g = item / parts;
  const uint32_t part = item % parts;
  const uint32_t b0 = bstart[g];
  const uint64_t len = bstart[g + 1] - b0;
  int t = 0;
  while (g >= st.base[t + 1]) ++t;
  it->table = t;
  it->window = g - st.base[t];
  it->begin = b0 + static_cast<uint32_t>(len * part / parts);
  it->end = b0 + static_cast<uint32_t>(len * (part + 1) / parts);
  if (it->begin < it->end) {
    const uint32_t* f = st.d + t * kDescK;
    const uint32_t seg = f[kSegLen];
    const uint32_t bytes = 12u * seg;
    // the buffer was last read through the generic proxy
    tma::fence_proxy_async();
    tma::mbar_expect_tx(bar, bytes);
    tma::bulk_copy(buf, words + f[kOffset] + it->window * seg, bytes, bar);
  }
}

// Persistent blocks over (bucket, chunk) items: atomicOr of the table's
// bit into hits_mask where both stages pass (of 0 where stage 2 rejects).
__global__ void __launch_bounds__(kProbeThreads)
window_probe_kernel(const uint32_t* __restrict__ words,
                    const int32_t* __restrict__ desc, int32_t n_tables,
                    const uint32_t* __restrict__ s_hi,
                    const uint32_t* __restrict__ s_lo,
                    const int32_t* __restrict__ s_idx,
                    const uint32_t* __restrict__ bstart, int32_t n_items,
                    int32_t parts, uint32_t win_words,
                    uint32_t* __restrict__ next_item,
                    uint32_t* __restrict__ mask) {
  extern __shared__ __align__(128) uint32_t windows[];   // 2 x win_words
  __shared__ Tables st;
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ Item items[2];
  load_tables(st, desc, n_tables);
  if (threadIdx.x == 0) {
    tma::mbar_init(&bar[0], 1);
    tma::mbar_init(&bar[1], 1);
    tma::fence_barrier_init();
    issue_item(atomicAdd(next_item, 1u), n_items, parts, st, bstart, words,
               windows, &bar[0], &items[0]);
  }
  __syncthreads();
  uint32_t phase = 0;   // bit s: parity of bar[s]'s next completion
  for (int s = 0;; s ^= 1) {
    const Item it = items[s];
    if (it.table < 0) break;
    // the other buffer was released by the __syncthreads that ended the
    // previous item: stream the next window into it now
    if (threadIdx.x == 0) {
      issue_item(atomicAdd(next_item, 1u), n_items, parts, st, bstart, words,
                 windows + (s ^ 1) * win_words, &bar[s ^ 1], &items[s ^ 1]);
    }
    if (it.begin < it.end) {
      tma::mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
      const uint32_t* f = st.d + it.table * kDescK;
      const uint32_t seed = f[kSeed], seg = f[kSegLen];
      const uint32_t alpha_mask = f[kAlphaMask], fp_seed = f[kFpSeed];
      const uint32_t ma = f[kMa], mb = f[kMb], oth_seed = f[kOthSeed];
      const uint32_t off_a = f[kOffA], off_b = f[kOffB];
      const uint32_t bit = 1u << it.table;
      const uint32_t* w = windows + s * win_words;
      const uint32_t stride = kProbeUnroll * blockDim.x;
      for (uint32_t p0 = it.begin + threadIdx.x; p0 < it.end; p0 += stride) {
        // the loads of kProbeUnroll keys first, so they are in flight together
        uint32_t hs[kProbeUnroll], ls[kProbeUnroll];
#pragma unroll
        for (int u = 0; u < kProbeUnroll; ++u) {
          const uint32_t p = p0 + u * blockDim.x;
          hs[u] = p < it.end ? __ldcs(s_hi + p) : 0u;   // read once
          ls[u] = p < it.end ? __ldcs(s_lo + p) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kProbeUnroll; ++u) {
          const uint32_t p = p0 + u * blockDim.x;
          const uint32_t h = hs[u], l = ls[u];
          const uint32_t v =
              w[probe::segment_slot(h, l, seed, 0u, seg)] ^
              w[seg + probe::segment_slot(h, l, seed, 1u, seg)] ^
              w[2u * seg + probe::segment_slot(h, l, seed, 2u, seg)];
          // stage 1 rejects (most keys): nothing to write
          if (p >= it.end ||
              ((v ^ probe::hash_u32(h, l, fp_seed)) & alpha_mask) != 0u) {
            continue;
          }
          // OR the bit where stage 2 passes too, else 0: a no-op, made
          // without a branch so that the index's load is issued beside
          // stage 2's gathers (behind a branch it would wait for them)
          const int32_t i = __ldcs(s_idx + p);
          const bool hit =
              probe::othello_hit(words, h, l, ma, mb, oth_seed, off_a, off_b);
          atomicOr(mask + i, hit ? bit : 0u);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
window_first_hit_kernel(const uint32_t* __restrict__ mask,
                        int32_t* __restrict__ first, int32_t n_tables,
                        int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t m = mask[i];
  // lowest set bit = newest table that fired; none fired -> n_tables
  first[i] = m ? __ffs(m) - 1 : n_tables;
}

}  // namespace

// Partition pass: counts [n_buckets * n_units], totals [n_buckets],
// bstart [n_buckets + 1], scratch s_hi / s_lo / s_idx [n * n_tables].
// Where given (else null), the probe's mask and work counter are set on
// the way: zero_out [n] to 0, next_item to 0.
extern "C" int lsm_window_partition_launch(
    const void* desc, int32_t n_tables, const void* hi, const void* lo,
    int64_t n, int32_t n_buckets, void* counts, void* totals, void* bstart,
    void* s_hi, void* s_lo, void* s_idx, void* zero_out, void* next_item,
    void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || n < 1 || n_buckets < 1) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      window_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(UnitSort)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t n_units = static_cast<int32_t>((n + kUnitKeys - 1) / kUnitKeys);
  const auto* d = static_cast<const int32_t*>(desc);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* l = static_cast<const uint32_t*>(lo);
  auto* c = static_cast<uint32_t*>(counts);
  auto* bs = static_cast<uint32_t*>(bstart);
  window_count_kernel<<<n_units, kUnitThreads, 0, st>>>(
      d, n_tables, h, l, n, c, n_units, static_cast<int32_t*>(zero_out));
  window_scan_units_kernel<<<n_buckets, kScanThreads, 0, st>>>(
      c, n_units, static_cast<uint32_t*>(totals));
  window_scan_totals_kernel<<<1, kTotalsThreads, 0, st>>>(
      static_cast<const uint32_t*>(totals), n_buckets, bs,
      static_cast<uint32_t*>(next_item));
  window_scatter_kernel<<<n_units, kUnitThreads, sizeof(UnitSort), st>>>(
      d, n_tables, h, l, n, c, n_units, bs, static_cast<uint32_t*>(s_hi),
      static_cast<uint32_t*>(s_lo), static_cast<int32_t*>(s_idx));
  return static_cast<int>(cudaGetLastError());
}

// Probe pass and first_hit, after the partition pass has set next_item
// (one uint32) to 0 and zeroed mask [n].
extern "C" int lsm_window_probe_launch(
    const void* words, const void* desc, int32_t n_tables, int32_t n_buckets,
    uint32_t win_words, const void* bstart, const void* s_hi,
    const void* s_lo, const void* s_idx, void* next_item, void* mask,
    void* first, int64_t n, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || n < 1 || n_buckets < 1 ||
      win_words == 0 || win_words % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2ull * win_words * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      window_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, window_probe_kernel, kProbeThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int resident = sms * per_sm;
  // split buckets into equal chunks so that even one table's buckets
  // give every resident block kItemsPerBlock items
  const int parts = (kItemsPerBlock * resident + n_buckets - 1) / n_buckets;
  const int n_items = n_buckets * parts;
  const int grid = n_items < resident ? n_items : resident;
  window_probe_kernel<<<grid, kProbeThreads, smem, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(desc),
      n_tables, static_cast<const uint32_t*>(s_hi),
      static_cast<const uint32_t*>(s_lo), static_cast<const int32_t*>(s_idx),
      static_cast<const uint32_t*>(bstart), n_items, parts, win_words,
      static_cast<uint32_t*>(next_item), static_cast<uint32_t*>(mask));
  window_first_hit_kernel<<<static_cast<unsigned int>((n + kThreads - 1) /
                                                      kThreads),
                            kThreads, 0, st>>>(
      static_cast<const uint32_t*>(mask), static_cast<int32_t*>(first),
      n_tables, n);
  return static_cast<int>(cudaGetLastError());
}
