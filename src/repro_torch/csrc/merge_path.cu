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
// simplest correct data-parallel merge.  One thread per input element
// computes its output position as its own index plus its rank in the other
// run -- i + #{B < a_i} for A, j + #{A <= b_j} for B (stable: A wins ties)
// -- by a binary search in global memory, then writes key and seq there.
// Reads of the element itself are coalesced; the searches are dependent
// gathers whose upper tree levels stay in L2.  No partition pass, no
// padding, native int64 throughout.  A merge-path partition with
// shared-memory tiles is the later, faster design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// #{x[k] < v} (strict) or #{x[k] <= v} over sorted x[0..n).
template <bool kInclusive>
__device__ __forceinline__ int64_t rank_in(const int64_t* __restrict__ x,
                                           int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    int64_t y = x[mid];
    bool below = kInclusive ? (y <= v) : (y < v);
    if (below) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_path_kernel(const int64_t* __restrict__ a_k,
                                  const int64_t* __restrict__ a_s,
                                  int64_t n_a,
                                  const int64_t* __restrict__ b_k,
                                  const int64_t* __restrict__ b_s,
                                  int64_t n_b,
                                  int64_t* __restrict__ o_k,
                                  int64_t* __restrict__ o_s) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n_a) {
    int64_t k = a_k[i];
    int64_t p = i + rank_in<false>(b_k, n_b, k);
    o_k[p] = k;
    o_s[p] = a_s[i];
  } else if (i < n_a + n_b) {
    int64_t j = i - n_a;
    int64_t k = b_k[j];
    int64_t p = j + rank_in<true>(a_k, n_a, k);
    o_k[p] = k;
    o_s[p] = b_s[j];
  }
}

}  // namespace

extern "C" int merge_path_launch(const void* a_k, const void* a_s,
                                 int64_t n_a, const void* b_k,
                                 const void* b_s, int64_t n_b, void* o_k,
                                 void* o_s, void* stream) {
  const int64_t n = n_a + n_b;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  merge_path_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a_k), static_cast<const int64_t*>(a_s), n_a,
      static_cast<const int64_t*>(b_k), static_cast<const int64_t*>(b_s), n_b,
      static_cast<int64_t*>(o_k), static_cast<int64_t*>(o_s));
  return static_cast<int>(cudaGetLastError());
}
