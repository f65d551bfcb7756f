// Exact Lindley recursion over a ragged batch of FIFO queues, float64:
//   D_j = S_j + max(d0, max_{k<=j}(a_k - S_{k-1})),  S_j = cumsum(s)_j.
//
// Replaces the lindley_scan TPU kernel: src/repro/kernels/lindley_scan/
// kernel.py, _lindley_kernel / lindley_scan_call.  The TPU version walks
// the tiles of a padded [B, N] batch in grid order and carries the running
// service sum and max-plus state from tile to tile in SMEM scratch.
//
// Bound on the H100: memory.  Per op the function reads a service time and
// an arrival and writes a departure, 24 bytes against 3.35 TB/s.  Blocks
// run in no order here, so nothing can be carried from one tile to the
// next; the recursion is a scan over the monoid
//   (s1, g1) o (s2, g2) = (s1 + s2, max(g1, g2 - s1)),
// where op j is the element (s_j, a_j) and a prefix (S, G) yields
// D = S + G once the row's seed (0, d0) is composed in front.  Design:
// three simple passes, no look-back.
//   1. tile_reduce: one block per 1024-op tile computes the tile's
//      aggregate (each thread folds 4 ops, then a block scan).
//   2. row_scan: one block per row scans its tiles' aggregates,
//      seeded with (0, d0), into each tile's exclusive carry.
//   3. tile_apply: each tile recomputes its local prefixes, composes
//      its carry in front and writes D = S + G for every op.
// The batch is CSR: row offsets plus, per row, the index of its first tile.
// Re-associating the sums across tiles differs from the sequential pass by
// float64 round-off only (~1e-13 s at DES time scales).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // must match ops.py TILE

struct Agg {
  double s;
  double g;
};

__device__ __forceinline__ Agg identity() { return {0.0, -CUDART_INF}; }

__device__ __forceinline__ Agg combine(Agg x, Agg y) {
  return {x.s + y.s, fmax(x.g, y.g - x.s)};
}

// Exclusive scan of one value per thread in thread order; *total gets the
// composition of all of them.  Hillis-Steele over shared memory.
__device__ Agg block_exclusive_scan(Agg mine, Agg* total) {
  __shared__ double ss[2][kThreads];
  __shared__ double gs[2][kThreads];
  const int t = threadIdx.x;
  int cur = 0;
  ss[cur][t] = mine.s;
  gs[cur][t] = mine.g;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    Agg v = {ss[cur][t], gs[cur][t]};
    if (t >= off) v = combine({ss[cur][t - off], gs[cur][t - off]}, v);
    ss[cur ^ 1][t] = v.s;
    gs[cur ^ 1][t] = v.g;
    cur ^= 1;
    __syncthreads();
  }
  Agg excl = t == 0 ? identity() : Agg{ss[cur][t - 1], gs[cur][t - 1]};
  *total = {ss[cur][kThreads - 1], gs[cur][kThreads - 1]};
  __syncthreads();  // the buffers are reused by the next call
  return excl;
}

// Row of tile t: the last r with tile_first[r] <= t.
__device__ __forceinline__ int64_t row_of_tile(const int64_t* tile_first,
                                               int64_t n_rows, int64_t t) {
  int64_t lo = 0, hi = n_rows;  // answer in [0, n_rows)
  while (hi - lo > 1) {
    int64_t mid = (lo + hi) >> 1;
    if (tile_first[mid] <= t) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void tile_bounds(const int64_t* offsets,
                                            const int64_t* tile_first,
                                            int64_t n_rows, int64_t t,
                                            int64_t* row, int64_t* begin,
                                            int64_t* end) {
  int64_t r = row_of_tile(tile_first, n_rows, t);
  *row = r;
  *begin = offsets[r] + (t - tile_first[r]) * kTile;
  int64_t row_end = offsets[r + 1];
  *end = *begin + kTile < row_end ? *begin + kTile : row_end;
}

__global__ void tile_reduce(const double* __restrict__ service,
                            const double* __restrict__ arrivals,
                            const int64_t* __restrict__ offsets,
                            const int64_t* __restrict__ tile_first,
                            int64_t n_rows, double* __restrict__ tile_agg) {
  const int64_t t = blockIdx.x;
  int64_t row, begin, end;
  tile_bounds(offsets, tile_first, n_rows, t, &row, &begin, &end);
  Agg acc = identity();
  const int64_t first = begin + threadIdx.x * (int64_t)kItems;
  for (int k = 0; k < kItems; ++k) {
    int64_t j = first + k;
    if (j < end) acc = combine(acc, {service[j], arrivals[j]});
  }
  Agg total;
  block_exclusive_scan(acc, &total);
  if (threadIdx.x == 0) {
    tile_agg[2 * t] = total.s;
    tile_agg[2 * t + 1] = total.g;
  }
}

__global__ void row_scan(const int64_t* __restrict__ tile_first,
                         const double* __restrict__ d0,
                         const double* __restrict__ tile_agg,
                         double* __restrict__ tile_carry) {
  const int64_t r = blockIdx.x;
  const int64_t t0 = tile_first[r], t1 = tile_first[r + 1];
  Agg carry = {0.0, d0[r]};
  for (int64_t chunk = t0; chunk < t1; chunk += kTile) {
    const int64_t first = chunk + threadIdx.x * (int64_t)kItems;
    Agg acc = identity();
    for (int k = 0; k < kItems; ++k) {
      int64_t t = first + k;
      if (t < t1) acc = combine(acc, {tile_agg[2 * t], tile_agg[2 * t + 1]});
    }
    Agg total;
    Agg run = combine(carry, block_exclusive_scan(acc, &total));
    for (int k = 0; k < kItems; ++k) {
      int64_t t = first + k;
      if (t < t1) {
        tile_carry[2 * t] = run.s;
        tile_carry[2 * t + 1] = run.g;
        run = combine(run, {tile_agg[2 * t], tile_agg[2 * t + 1]});
      }
    }
    carry = combine(carry, total);
  }
}

__global__ void tile_apply(const double* __restrict__ service,
                           const double* __restrict__ arrivals,
                           const int64_t* __restrict__ offsets,
                           const int64_t* __restrict__ tile_first,
                           int64_t n_rows,
                           const double* __restrict__ tile_carry,
                           double* __restrict__ out) {
  const int64_t t = blockIdx.x;
  int64_t row, begin, end;
  tile_bounds(offsets, tile_first, n_rows, t, &row, &begin, &end);
  const int64_t first = begin + threadIdx.x * (int64_t)kItems;
  double s[kItems], a[kItems];
  Agg acc = identity();
  for (int k = 0; k < kItems; ++k) {
    int64_t j = first + k;
    s[k] = j < end ? service[j] : 0.0;
    a[k] = j < end ? arrivals[j] : -CUDART_INF;
    acc = combine(acc, {s[k], a[k]});
  }
  Agg total;
  Agg excl = block_exclusive_scan(acc, &total);
  Agg run = combine({tile_carry[2 * t], tile_carry[2 * t + 1]}, excl);
  for (int k = 0; k < kItems; ++k) {
    int64_t j = first + k;
    run = combine(run, {s[k], a[k]});
    if (j < end) out[j] = run.s + run.g;
  }
}

}  // namespace

extern "C" int lindley_scan_launch(const void* service, const void* arrivals,
                                   const void* offsets,
                                   const void* tile_first, const void* d0,
                                   int64_t n_rows, int64_t n_tiles,
                                   void* tile_agg, void* tile_carry,
                                   void* out, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* s = static_cast<const double*>(service);
  const double* a = static_cast<const double*>(arrivals);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int64_t* tf = static_cast<const int64_t*>(tile_first);
  double* agg = static_cast<double*>(tile_agg);
  double* carry = static_cast<double*>(tile_carry);
  tile_reduce<<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(
      s, a, off, tf, n_rows, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_scan<<<static_cast<unsigned>(n_rows), kThreads, 0, st>>>(
      tf, static_cast<const double*>(d0), agg, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_apply<<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(
      s, a, off, tf, n_rows, carry, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
