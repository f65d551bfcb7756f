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
