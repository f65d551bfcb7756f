// Stable merge of two sorted int64 key runs carrying int64 seqs; run A
// precedes run B on equal keys.
//
// Replaces the merge_path TPU kernel: src/repro/kernels/merge_path/
// kernel.py, _merge_kernel / merge_path_call.  The TPU version walks the
// merge-path diagonal per 128-element output tile, then ranks and scatters
// with 128x128 comparison counts over int32 (hi, lo) planes, with runs
// padded by a sentinel tile and seqs limited to int32.
//
// Bound on the H100: memory.  Each output element costs 32 bytes (a key
// and a seq read, a key and a seq written) against 3.35 TB/s.  Design: the
// merge-path merge with the tile in shared memory.  Block b owns the
// kTile outputs [b * kTile, (b + 1) * kTile); 1,024-output tiles (256
// threads of 4) measured fastest at the store's merges, more blocks a SM
// hiding more of each block's chain of round trips (PERF.md).
//   1. Its two diagonals, k0 and k1, are split between the runs by a
//      search that every thread of the block takes part in: each round,
//      thread t tests one point of each diagonal and the block counts the
//      true ones, so a range shrinks kThreads + 1-fold a round, where one
//      thread's binary search would wait on ~15 dependent loads.  The
//      split of diagonal k is the largest a with A[a - 1] <= B[k - a] (A
//      first on ties).
//   2. Once both ranges are within kSlack, the runs around them, keys and
//      seqs, are staged into shared memory with coalesced loads: the
//      tile's windows A[a0, a1) and B[k0 - a0, k1 - a1) and the points
//      the splits can still take, so the last round of the search runs
//      there and costs no round trip of its own.
//   3. Each thread splits its own kItems outputs' diagonal by a binary
//      search in shared memory, merges them serially and writes, for each
//      output, the index of its source in the staged tile (16 bits).
//   4. The block writes keys and seqs out coalesced, gathering each from
//      the staged tile through its index.
// Native int64 throughout: no padding, no sentinel, no limit on seqs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // a thread's source indices go out as one uint2
constexpr int kTile = kThreads * kItems;  // ops.py asserts its TILE on load
// A split is narrowed in device memory until it lies within kSlack
// positions; the windows around both splits, kStage keys at most, are
// then staged and the splits finished in shared memory.
constexpr int kSlack = 128;
constexpr int kStage = kTile + 4 * kSlack;
static_assert(kStage <= 65536, "source indices are 16-bit");

// Split of diagonal k, narrowed in place: the answer lies in [lo, hi] and
// P(lo) holds.  P(a): A[a - 1] <= B[k - a], defined for lo < a <= hi.
struct Diag {
  int64_t k, lo, hi, step;
};

__device__ __forceinline__ Diag diag(int64_t k, int64_t n_a, int64_t n_b) {
  return {k, k > n_b ? k - n_b : 0, k < n_a ? k : n_a, 0};
}

// P at this thread's point of d, or false past hi; a and b hold A and B
// from positions a_off and b_off on.
__device__ __forceinline__ bool probe(Diag& d, const int64_t* a,
                                      int64_t a_off, const int64_t* b,
                                      int64_t b_off) {
  d.step = (d.hi - d.lo + kThreads - 1) / kThreads;
  const int64_t at = d.lo + (threadIdx.x + 1) * d.step;
  return d.lo < d.hi && at <= d.hi &&
         a[at - 1 - a_off] <= b[d.k - at - b_off];
}

// The points at which P held number `count`: they are the first ones.
__device__ __forceinline__ void narrow(Diag& d, int count) {
  if (d.lo >= d.hi) return;
  const int64_t lo = d.lo + count * d.step;
  d.hi = min(d.hi, d.lo + (count + 1) * d.step - 1);
  d.lo = lo;
}

// One round for both splits, all threads together: a range shrinks
// kThreads + 1-fold.  Uniform over the block.
__device__ __forceinline__ void search_round(Diag& d0, Diag& d1,
                                             const int64_t* a, int64_t a_off,
                                             const int64_t* b,
                                             int64_t b_off) {
  const bool p0 = probe(d0, a, a_off, b, b_off);
  const bool p1 = probe(d1, a, a_off, b, b_off);
  narrow(d0, __syncthreads_count(p0));
  narrow(d1, __syncthreads_count(p1));
}

__global__ void __launch_bounds__(kThreads)
    merge_path_kernel(const int64_t* __restrict__ a_k,
                      const int64_t* __restrict__ a_s, int64_t n_a,
                      const int64_t* __restrict__ b_k,
                      const int64_t* __restrict__ b_s, int64_t n_b,
                      int64_t* __restrict__ o_k, int64_t* __restrict__ o_s) {
  __shared__ int64_t s_key[kStage];
  __shared__ int64_t s_seq[kStage];
  __shared__ __align__(16) uint16_t s_src[kTile];
  const int tid = threadIdx.x;
  const int64_t n = n_a + n_b;
  const int64_t k0 = blockIdx.x * (int64_t)kTile;
  const int64_t k1 = min(k0 + kTile, n);
  const int len = static_cast<int>(k1 - k0);

  // 1. narrow both splits in device memory, then bound each by the other:
  //    a0 <= a1 <= a0 + len
  Diag d0 = diag(k0, n_a, n_b), d1 = diag(k1, n_a, n_b);
  while (d0.hi - d0.lo > kSlack || d1.hi - d1.lo > kSlack)
    search_round(d0, d1, a_k, 0, b_k, 0);
  d0.hi = min(d0.hi, d1.hi);
  d1.lo = max(d1.lo, d0.lo);
  d1.hi = min(d1.hi, d0.hi + len);
  d0.lo = max(d0.lo, d1.lo - len);

  // 2. stage A[a_lo, d1.hi) and B[b_lo, k1 - d1.lo), keys and seqs: every
  //    point either split can still take, and the tile's windows
  const int64_t a_lo = d0.lo, b_lo = k0 - d0.hi;
  const int n_sa = static_cast<int>(d1.hi - a_lo);
  const int n_stage = n_sa + static_cast<int>(k1 - d1.lo - b_lo);
#pragma unroll
  for (int r = 0; r < (kStage + kThreads - 1) / kThreads; ++r) {
    const int i = r * kThreads + tid;
    if (i < n_stage) {
      const bool from_a = i < n_sa;
      const int64_t src = from_a ? a_lo + i : b_lo + (i - n_sa);
      s_key[i] = from_a ? a_k[src] : b_k[src];
      s_seq[i] = from_a ? a_s[src] : b_s[src];
    }
  }
  __syncthreads();
  //    and finish both splits there
  while (d0.lo < d0.hi || d1.lo < d1.hi)
    search_round(d0, d1, s_key, a_lo, s_key + n_sa, b_lo);
  const int a_at = static_cast<int>(d0.lo - a_lo);           // A[a0] in s_key
  const int b_at = n_sa + static_cast<int>(k0 - d0.lo - b_lo);  // B[b0]
  const int na = static_cast<int>(d1.lo - d0.lo), nb = len - na;

  // 3. this thread's kItems outputs: split its diagonal, merge serially
  const int64_t* sa = s_key + a_at;
  const int64_t* sb = s_key + b_at;
  const int dd = min(tid * kItems, len);
  int lo = dd > nb ? dd - nb : 0, hi = dd < na ? dd : na;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sa[mid - 1] <= sb[dd - mid]) lo = mid; else hi = mid - 1;
  }
  int i = lo, j = dd - lo;
  uint16_t src[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool take_a = j >= nb || (i < na && sa[i] <= sb[j]);
    src[r] = static_cast<uint16_t>(take_a ? a_at + i : b_at + j);
    i += take_a;
    j += !take_a;
  }
  if (dd < len) {  // whole words even for the last thread: s_src has room
    *reinterpret_cast<uint2*>(s_src + tid * kItems) =
        make_uint2(src[0] | (uint32_t)src[1] << 16,
                   src[2] | (uint32_t)src[3] << 16);
  }
  __syncthreads();

  // 4. write out coalesced
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int p = r * kThreads + tid;
    if (p < len) {
      const int from = s_src[p];
      o_k[k0 + p] = s_key[from];
      o_s[k0 + p] = s_seq[from];
    }
  }
}

}  // namespace

extern "C" int merge_path_launch(const void* a_k, const void* a_s,
                                 int64_t n_a, const void* b_k,
                                 const void* b_s, int64_t n_b, void* o_k,
                                 void* o_s, void* stream) {
  const int64_t n = n_a + n_b;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  merge_path_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a_k), static_cast<const int64_t*>(a_s), n_a,
      static_cast<const int64_t*>(b_k), static_cast<const int64_t*>(b_s), n_b,
      static_cast<int64_t*>(o_k), static_cast<int64_t*>(o_s));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int merge_path_tile() { return kTile; }
