// Sorted-array rank for the LSM store: out[i] = #{fence <= key_i} (right)
// or #{fence < key_i} (left), int64 throughout.
//
// Replaces the overlap_scan TPU kernel: src/repro/kernels/overlap_scan/
// kernel.py, _rank_kernel / fence_rank_call.  The TPU version compares
// every 128-key tile against every 128-fence tile (O(m*n) work, no
// gathers), which suits the VPU; fences there are split into int32 planes.
//
// Bound on the H100: dependent, divergent loads.  The bytes the function
// must move are the keys, the ranks and the fence entries the searches
// touch (a few MB at most), but a binary search over a flat level of
// millions of fences is a chain of ~23 dependent loads per key, each warp
// load below the shared top levels touching 32 different sectors.  Design:
// one thread per key, a binary search in global memory with native int64
// compares and 32-bit indices where the array allows (fewer instructions
// per step).  All keys share the top levels of the search, which L1 and L2
// serve; measured on the H100, staging those levels in shared memory
// (2^levels - 1 sampled fences, or the whole array when it fits in 48 KB,
// as an earlier version did up to 6,144 fences), smaller blocks, 2-4 keys
// per thread and a final 16-fence scan were all as fast or slower at the
// store's shapes, since every block pays for its staging (PERF.md).  The
// strict rank is computed directly, so neither INT64_MIN nor INT64_MAX
// keys need the reference's special cases.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename I>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int64_t* __restrict__ f, I n,
            const int64_t* __restrict__ keys, int64_t m,
            int64_t* __restrict__ out, int right) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= m) return;
  const int64_t v = keys[i];
  I lo = 0, hi = n;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;  // lo + hi < 2^32 for 32-bit indices
    const int64_t x = f[mid];
    if (right ? x <= v : x < v) lo = mid + 1; else hi = mid;
  }
  out[i] = static_cast<int64_t>(lo);
}

}  // namespace

// fences: [n_f] sorted int64; keys, out: [n_k] int64; all contiguous.
// right: 1 for #{fence <= key}, 0 for #{fence < key}.
extern "C" int fence_rank_launch(const void* fences, int64_t n_f,
                                 const void* keys, int64_t n_k, void* out,
                                 int right, void* stream) {
  if (n_k == 0) return 0;
  if (n_f < 0 || n_k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((n_k + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* f = static_cast<const int64_t*>(fences);
  const int64_t* k = static_cast<const int64_t*>(keys);
  int64_t* o = static_cast<int64_t*>(out);
  if (n_f < (int64_t(1) << 31))
    rank_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        f, static_cast<uint32_t>(n_f), k, n_k, o, right);
  else
    rank_kernel<int64_t><<<blocks, kThreads, 0, s>>>(f, n_f, k, n_k, o,
                                                     right);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The GET path's fused probe: one launch resolves a whole GET batch against
// every run of an LSM tree, in the order LSMTree._lookup_batch walks them,
// stopping at a key's first hit:
//   - a memtable (its sorted, deduplicated view): a hit costs nothing;
//   - an L0 SST: if smallest <= key <= largest, one probe; a hit is one
//     block read, a miss one more read when the bloom filter's
//     deterministic false positive fires for (key, the SST's seed);
//   - a sorted, disjoint level: the SST whose fences hold the key is
//     [rank_left(largest, key), rank_right(smallest, key)); if that is not
//     empty, one probe over the level's flat keys, counted as an L0 probe
//     with the seed of SST min(start, n_ssts - 1).
// The chain of torch ops it replaces (lookup_probe_plain in
// kernels/overlap_scan/ops.py) has no TPU kernel of its own: on the TPU it is
// XLA's fusion of the reference's ops around _rank_kernel.
//
// Bound on the H100: dependent loads.  A key's walk is up to ~10 searches
// of 6-23 steps each, and the bytes it must move are its key, its three
// results and one line a search step (PERF.md).  Design: a group of kLanes
// threads per key, all walking the same runs in lock step; each search step
// loads kLanes pivots at once, one a lane, and narrows the range to one of
// kLanes + 1 pieces with a ballot, so a search over 8 M keys takes 6 steps
// of the group instead of 23 of one thread, and a 10,000-key batch puts
// 160,000 threads on the card instead of 10,000.  Measured on the H100 at
// the YCSB-B cell's batch (PERF.md), 16 lanes a key beat 8 and 32.  The run
// table (kRunFields int64 a run) is read through the read-only cache;
// every lane of a group reads the same entry.

namespace {

constexpr int kRunFields = 8;
constexpr int64_t kMemtableRun = 0, kL0Run = 1, kLevelRun = 2;
constexpr int kProbeThreads = 256;
constexpr int kLanes = 16;                       // threads a key
constexpr int kGroups = kProbeThreads / kLanes;  // keys a block

// rank over f[0, n) of v by the kLanes threads of one group (lane g of it,
// mask its lanes): #{f <= v} if right, else #{f < v}.
__device__ __forceinline__ int64_t group_rank(const int64_t* __restrict__ f,
                                              int64_t n, int64_t v,
                                              bool right, int g,
                                              unsigned mask) {
  int64_t lo = 0, hi = n;  // the rank lies in [lo, hi]
  while (hi - lo > kLanes) {
    // kLanes strictly increasing pivots inside [lo, hi)
    const int64_t p = lo + (hi - lo) * (g + 1) / (kLanes + 1);
    const int64_t x = f[p];
    const int c = __popc(__ballot_sync(mask, right ? x <= v : x < v));
    const int64_t below = __shfl_sync(mask, p, c > 0 ? c - 1 : 0, kLanes);
    const int64_t above = __shfl_sync(mask, p, c < kLanes ? c : 0, kLanes);
    if (c > 0) lo = below + 1;
    if (c < kLanes) hi = above;
  }
  const int64_t p = lo + g;
  const bool in = p < hi && (right ? f[p] <= v : f[p] < v);
  return lo + __popc(__ballot_sync(mask, in));
}

// bloom_false_positives of ops.py, bit for bit: the low 32 bits of
// key * KEY_MIX + seed (wrapping), as a float64 fraction of 2^32 - 1.
__device__ __forceinline__ bool bloom_false_positive(int64_t key, int64_t seed,
                                                     double fpr) {
  const uint64_t h = (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull +
                      static_cast<uint64_t>(seed)) & 0xFFFFFFFFull;
  return static_cast<double>(h) / 4294967295.0 < fpr;
}

__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(const int64_t* __restrict__ keys, int64_t m,
             const int64_t* __restrict__ table, int n_runs, double fpr,
             int64_t* __restrict__ out) {
  const int g = threadIdx.x % kLanes;
  const int64_t i = blockIdx.x * static_cast<int64_t>(kGroups) +
                    threadIdx.x / kLanes;
  if (i >= m) return;  // the whole group leaves together
  const unsigned mask = ((1u << kLanes) - 1u)
                        << (threadIdx.x % 32 / kLanes * kLanes);
  const int64_t k = keys[i];
  int64_t seq = -1, reads = 0, probed = 0;
  for (int r = 0; r < n_runs; ++r) {
    const int64_t* d = table + r * kRunFields;
    const int64_t kind = __ldg(d);
    const int64_t* rk = reinterpret_cast<const int64_t*>(__ldg(d + 1));
    const int64_t n = __ldg(d + 3);
    int64_t seed = 0;
    if (kind == kL0Run) {
      if (k < __ldg(d + 4) || k > __ldg(d + 5)) continue;
      seed = __ldg(d + 6);
    } else if (kind == kLevelRun) {
      const int64_t n_ssts = __ldg(d + 7);
      const int64_t start = group_rank(
          reinterpret_cast<const int64_t*>(__ldg(d + 5)), n_ssts, k, false,
          g, mask);
      const int64_t end = group_rank(
          reinterpret_cast<const int64_t*>(__ldg(d + 4)), n_ssts, k, true,
          g, mask);
      if (end <= start) continue;
      seed = reinterpret_cast<const int64_t*>(__ldg(d + 6))[
          start < n_ssts - 1 ? start : n_ssts - 1];
    }
    const bool costs = kind != kMemtableRun;
    probed += costs;
    if (n > 0) {
      int64_t pos = group_rank(rk, n, k, false, g, mask);
      if (pos > n - 1) pos = n - 1;
      if (rk[pos] == k) {
        const int64_t enc =
            reinterpret_cast<const int64_t*>(__ldg(d + 2))[pos];
        seq = (enc & 1) ? -1 : (enc >> 1);
        reads += costs;
        break;
      }
    }
    reads += costs && bloom_false_positive(k, seed, fpr);
  }
  if (g == 0) {
    out[i] = seq;
    out[m + i] = reads;
    out[2 * m + i] = probed;
  }
}

}  // namespace

// packed: [n_keys] int64 keys, then n_runs rows of kRunFields int64 (the
// layout of ops.probe_table); out: [3, n_keys] int64 (seqs, reads, probed).
extern "C" int lookup_probe_launch(const void* packed, int64_t n_keys,
                                   int n_runs, double fpr, void* out,
                                   void* stream) {
  if (n_keys == 0) return 0;
  if (n_keys < 0 || n_runs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* k = static_cast<const int64_t*>(packed);
  const unsigned blocks =
      static_cast<unsigned>((n_keys + kGroups - 1) / kGroups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_kernel<<<blocks, kProbeThreads, 0, s>>>(
      k, n_keys, k + n_keys, n_runs, fpr, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
