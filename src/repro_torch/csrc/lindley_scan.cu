// Exact Lindley recursion over a ragged batch of FIFO queues, float64:
//   D_j = S_j + max(d0, max_{k<=j} g_k),  g_k = a_k - S_{k-1},
//   S_j = cumsum(s)_j.
//
// Replaces the lindley_scan TPU kernel: src/repro/kernels/lindley_scan/
// kernel.py, _lindley_kernel / lindley_scan_call.  The TPU version walks
// the tiles of a padded [B, N] batch in grid order and carries the running
// service sum and max-plus state from tile to tile in SMEM scratch.
//
// Bound on the H100: memory.  Per op the function reads a service time and
// an arrival and writes a departure, 24 bytes against 3.35 TB/s.  Blocks
// run in no order here, so the carries go through device memory, in one
// streaming pass.  A block takes the next tile id from an atomic counter
// (so every lower tile is resident or done), loads its kTile ops of s and
// a as 16-byte pairs, and publishes the tile's service sum.  The max is
// exact in any order, the float64 sums are not, so the two carries are
// taken apart and neither depends on timing; two calls on the same inputs
// give the same bits:
//   - S offset: the sum of the earlier tiles of the row, in a fixed order:
//     each full group of kGroup tiles has its sum published by its last
//     tile (its kGroup tile sums, added in a fixed order), and a tile adds
//     the earlier groups' sums and the earlier tiles of its own group, each
//     set in a fixed order, waiting for any not yet published.
//   - The running max of g: the tile publishes its own max of g, and takes
//     the earlier tiles' of its row from a decoupled look-back over those
//     (the row's first tile takes d0 instead).
//   - D_j = S_j + the running max, written as 16-byte pairs.
// The shuffle scans within the tile need no carry and run while the
// carries arrive (see lindley_tiles); registers are capped for 3 resident
// blocks a SM, which measured fastest (PERF.md).
// Each published value is one 8-byte word, stored and loaded whole, and
// is its own flag: the call first sets every word to all ones, a pattern
// no sum or max takes (-inf is 0xfff0..., and a NaN is published as the
// canonical one, whatever payload the inputs gave it), so no fence has to
// order a value after a flag.  (A 16-byte value-and-flag word, written and read
// with one vector access each, gave wrong sums on the H100: a new flag
// beside an old value.)  The sums are re-associated from the sequential
// pass by float64 round-off only (~1e-13 s at DES time scales).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;              // resident blocks a SM
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 8;                  // 16-byte pairs a thread loads
constexpr int kSeg = 64 * kPairs;          // ops of one warp's segment
constexpr int64_t kTile = kWarps * kSeg;   // ops.py asserts its TILE on load
constexpr int kGroup = 32;                 // tiles whose sums one warp adds
static_assert(kGroup == 32, "a group's tile sums are one per lane");
constexpr unsigned long long kUnset = ~0ull;  // a word not yet published

// The batch: each row's tiles start at its first op; tile t of the batch
// is tile t - tfirst[r] of its row r = trow[t].  One row: trow is null and
// the row is [0, n) with d0v.
struct Plan {
  const int64_t* off;     // [rows + 1] op offsets
  const int64_t* tfirst;  // [rows + 1] first tile of each row
  const double* d0;       // [rows]
  const int64_t* trow;    // [tiles] row of each tile
  int64_t n;
  double d0v;
};

struct Tile {
  int64_t begin, end, first;  // ops [begin, end); the row's first tile
  double d0;
};

__device__ __forceinline__ Tile tile_of(const Plan& P, int64_t t) {
  if (P.trow == nullptr) {
    const int64_t b = t * kTile;
    return {b, min(b + kTile, P.n), 0, P.d0v};
  }
  const int64_t r = P.trow[t];
  const int64_t first = P.tfirst[r];
  const int64_t b = P.off[r] + (t - first) * kTile;
  return {b, min(b + kTile, P.off[r + 1]), first, P.d0[r]};
}

// A tile's published words, each kUnset until written.
struct Carries {
  double* sum;     // [tiles] the tile's service sum
  double* group;   // [tiles] at a full group's last tile: the group's sum
  double* agg;     // [tiles] the tile's max of g
  double* prefix;  // [tiles] the row's max of g up to the tile, with d0
};

__device__ __forceinline__ void publish(double* w, double v) {
  const double word = v != v ? CUDART_NAN : v;  // never kUnset
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(w),
               "l"(__double_as_longlong(word))
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(const double* w) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(w)
               : "memory");
  return v;
}

// The word, once published.
__device__ __forceinline__ double wait_for(const double* w) {
  unsigned long long v = peek(w);
  while (v == kUnset) v = peek(w);
  return __longlong_as_double(static_cast<long long>(v));
}

// Pair r of this thread within tile [begin, end): ops j, j + 1 with
// j = begin + warp * kSeg + r * 64 + 2 * lane.  `vec`: p + begin is 16-byte
// aligned, so whole pairs load as one double2.
__device__ __forceinline__ int64_t pair_at(int64_t begin, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return begin + warp * kSeg + r * 64 + 2 * lane;
}

__device__ __forceinline__ double2 load_pair(const double* __restrict__ p,
                                             int64_t j, int64_t end,
                                             bool vec, double fill) {
  if (vec && j + 1 < end) return __ldcs(reinterpret_cast<const double2*>(p + j));
  return make_double2(j < end ? __ldcs(p + j) : fill,
                      j + 1 < end ? __ldcs(p + j + 1) : fill);
}

__device__ __forceinline__ void store_pair(double* p, int64_t j, int64_t end,
                                           bool vec, double2 v) {
  if (vec && j + 1 < end) {
    __stcs(reinterpret_cast<double2*>(p + j), v);
    return;
  }
  if (j < end) __stcs(p + j, v.x);
  if (j + 1 < end) __stcs(p + j + 1, v.y);
}

__device__ __forceinline__ bool aligned16(const double* p, int64_t j) {
  return (reinterpret_cast<uintptr_t>(p + j) & 15) == 0;
}

// Every lane gets the same sum: x + y == y + x bitwise at each level.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

template <bool kMax>
__device__ __forceinline__ double warp_incl_scan(double v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = kMax ? fmax(v, o) : o + v;
  }
  return v;
}

// The S offset of tile t, local tile u of its row (whose first tile is
// `first`), for warp 0: the earlier groups' sums, then the earlier tiles
// of its own group, each added in a fixed order.  The last tile of a full
// group publishes the group's sum (`mine` is its own tile's).
__device__ double row_offset(const Carries& C, int64_t t, int64_t first,
                             double mine) {
  const int lane = threadIdx.x & 31;
  const int64_t u = t - first, g = u / kGroup;
  const int64_t g0 = first + g * kGroup;  // this group's first tile
  double own = t - g0 > lane ? wait_for(C.sum + g0 + lane) : 0.0;
  if (t - g0 == kGroup - 1) {
    const double total = warp_sum(lane == kGroup - 1 ? mine : own);
    if (lane == 0) publish(C.group + t, total);
  }
  own = warp_sum(own);
  double before = 0.0;
  for (int64_t h = lane; h < g; h += 32)
    before += wait_for(C.group + first + h * kGroup + kGroup - 1);
  return warp_sum(before) + own;
}

// The running max of the row's tiles before t: lane i looks at tile
// t - 1 - i - 32 m (its prefix, else its own max), until a tile whose
// prefix is published.
__device__ double look_back(const Carries& C, int64_t t, int64_t first) {
  const int lane = threadIdx.x & 31;
  double run = -CUDART_INF;
  for (int64_t pred = t - 1;;) {
    const int64_t i = pred - lane;
    unsigned long long v = __double_as_longlong(-CUDART_INF);
    bool pre = true;  // before the row: nothing, as a prefix of -inf
    if (i >= first) {
      const unsigned long long p = peek(C.prefix + i), g = peek(C.agg + i);
      pre = p != kUnset;
      v = pre ? p : g;
    }
    const unsigned pres = __ballot_sync(0xffffffffu, pre);
    const unsigned rdy = __ballot_sync(0xffffffffu, v != kUnset);
    const int stop = pres ? __ffs(pres) - 1 : 31;
    const unsigned need = stop == 31 ? 0xffffffffu : (2u << stop) - 1;
    if ((rdy & need) != need) continue;  // a tile not published yet
    run = fmax(run, warp_max(lane <= stop ? __longlong_as_double(v)
                                          : -CUDART_INF));
    if (pres) return run;
    pred -= 32;
  }
}

// The pass: S, g, both carries and D.  The tile's sum is published as soon
// as the loads are in, then everything that needs no carry is done while
// the carries of earlier tiles arrive:
//   per warp, e_j and i_j, the sums of the warp's ops before and up to j,
//   h_j = a_j - e_j and its running max H_j;
// then, with c_w = the tile's offset + the sums of the earlier warps,
//   S_j = c_w + i_j,  g_j = h_j - c_w,  max_{k<=j} g_k = H_j - c_w
// (rounding is monotone, so the max commutes with subtracting c_w), and
// D_j = S_j + max(the running max before the warp, H_j - c_w).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    lindley_tiles(const double* __restrict__ service,
                  const double* __restrict__ arrivals, Plan P, Carries C,
                  unsigned long long* counter, double* __restrict__ out) {
  __shared__ double s_sum[kWarps];   // each warp's service sum
  __shared__ double s_hmax[kWarps];  // each warp's max of h, then of g
  __shared__ int64_t s_tile;
  __shared__ double s_offset, s_prior;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)  // the counter starts at all ones: ids from 0
    s_tile = static_cast<int64_t>(atomicAdd(counter, 1ull) + 1);
  __syncthreads();
  const int64_t t = s_tile;
  const Tile T = tile_of(P, t);
  const bool head = t == T.first;
  const bool vs = aligned16(service, T.begin),
             va = aligned16(arrivals, T.begin);
  double2 s[kPairs], a[kPairs];
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const int64_t j = pair_at(T.begin, r);
    s[r] = load_pair(service, j, T.end, vs, 0.0);
    a[r] = load_pair(arrivals, j, T.end, va, -CUDART_INF);
  }
  double ws = 0.0;  // this warp's sum, in a fixed order
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    ws += s[r].x;
    ws += s[r].y;
  }
  ws = warp_sum(ws);
  if (lane == 0) s_sum[warp] = ws;
  __syncthreads();
  if (threadIdx.x == 0) {
    double mine = s_sum[0];
    for (int w = 1; w < kWarps; ++w) mine += s_sum[w];
    publish(C.sum + t, mine);
  }
  // i_j into s, H_j into a
  double sum = 0.0, hmax = -CUDART_INF;
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const double incl = warp_incl_scan<false>(s[r].x + s[r].y);
    const double before = __shfl_up_sync(0xffffffffu, incl, 1);
    const double e0 = lane == 0 ? sum : sum + before, e1 = e0 + s[r].x;
    const double h0 = a[r].x - e0, h1 = a[r].y - e1;
    s[r] = make_double2(e1, e1 + s[r].y);
    const double hi = warp_incl_scan<true>(fmax(h0, h1));
    const double hb = __shfl_up_sync(0xffffffffu, hi, 1);
    const double m0 = fmax(lane == 0 ? hmax : fmax(hmax, hb), h0);
    a[r] = make_double2(m0, fmax(m0, h1));
    sum += __shfl_sync(0xffffffffu, incl, 31);
    hmax = fmax(hmax, __shfl_sync(0xffffffffu, hi, 31));
  }
  if (lane == 0) s_hmax[warp] = hmax;
  __syncthreads();
  if (warp == 0) {  // both carries
    double mine = s_sum[0];
    for (int w = 1; w < kWarps; ++w) mine += s_sum[w];
    const double off = head ? 0.0 : row_offset(C, t, T.first, mine);
    double c = off;  // lane w: c_w, as every warp forms its own below
    for (int w = 0; w < lane && w < kWarps; ++w) c += s_sum[w];
    const double g = lane < kWarps ? s_hmax[lane] - c : -CUDART_INF;
    const double tile_max = warp_max(g);
    if (!head && lane == 0) publish(C.agg + t, tile_max);
    const double prior = head ? T.d0 : look_back(C, t, T.first);
    if (lane == 0) {
      publish(C.prefix + t, fmax(prior, tile_max));
      s_offset = off;
      s_prior = prior;
    }
    __syncwarp();
    if (lane < kWarps) s_hmax[lane] = g;
  }
  __syncthreads();
  double c = s_offset, run = s_prior;
  for (int w = 0; w < warp; ++w) {
    c += s_sum[w];
    run = fmax(run, s_hmax[w]);
  }
  const bool vo = aligned16(out, T.begin);
#pragma unroll
  for (int r = 0; r < kPairs; ++r)
    store_pair(out, pair_at(T.begin, r), T.end, vo,
               make_double2(c + s[r].x + fmax(run, a[r].x - c),
                            c + s[r].y + fmax(run, a[r].y - c)));
}

}  // namespace

// plan: null for one row of n ops with d0 = d0v; else int64 [off (rows + 1)
// | tfirst (rows + 1) | d0 (rows, float64 bits) | trow (tiles)].  scratch:
// 16 + 32 * tiles bytes, set to all ones here before the pass.
extern "C" int lindley_scan_launch(const void* service, const void* arrivals,
                                   const void* plan, int64_t rows,
                                   int64_t tiles, int64_t n, double d0v,
                                   void* scratch, void* out, void* stream) {
  if (tiles <= 0) return 0;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  Plan P{nullptr, nullptr, nullptr, nullptr, n, d0v};
  if (plan != nullptr) {
    const int64_t* p = static_cast<const int64_t*>(plan);
    P.off = p;
    P.tfirst = p + rows + 1;
    P.d0 = reinterpret_cast<const double*>(p + 2 * (rows + 1));
    P.trow = p + 3 * rows + 2;
  }
  cudaError_t err = cudaMemsetAsync(scratch, 0xff, 16 + 32 * tiles, sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* counter = static_cast<unsigned long long*>(scratch);
  double* w = reinterpret_cast<double*>(counter + 2);
  const Carries C{w, w + tiles, w + 2 * tiles, w + 3 * tiles};
  lindley_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, sm>>>(
      static_cast<const double*>(service),
      static_cast<const double*>(arrivals), P, C, counter,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lindley_scan_tile() { return static_cast<int>(kTile); }
