// Sorted-array rank for the LSM store: out[i] = #{fence <= key_i} (right)
// or #{fence < key_i} (left), int64 throughout.
//
// Replaces the overlap_scan TPU kernel: src/repro/kernels/overlap_scan/
// kernel.py, _rank_kernel / fence_rank_call.  The TPU version compares
// every 128-key tile against every 128-fence tile (O(m*n) work, no
// gathers), which suits the VPU; fences there are split into int32 planes.
//
// Bound on the H100: memory.  The function has to read m keys and n fences
// and write m ranks, (8m + 8n + 8m) bytes, against 3.35 TB/s; the
// O(m log n) compares are negligible.  Design: one thread per key, a
// binary search with native int64 compares.  When the fences fit in 48 KB
// (6144 entries; LevelIndex fence arrays, memtables of the test scale)
// every block stages them in shared memory first, so the log n dependent
// probes hit shared memory; larger arrays (flat levels of millions of
// keys) are searched in global memory, where the top of the search tree
// stays in L2 across threads.  The strict rank is computed directly, so
// neither INT64_MIN nor INT64_MAX keys need the reference's special cases.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSharedFences = 6144;  // 48 KB of int64

__device__ __forceinline__ int64_t rank_of(const int64_t* __restrict__ f,
                                           int64_t n, int64_t v, int right) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    int64_t x = f[mid];
    bool go_right = right ? (x <= v) : (x < v);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void rank_global(const int64_t* __restrict__ fences, int64_t n_f,
                            const int64_t* __restrict__ keys, int64_t n_k,
                            int64_t* __restrict__ out, int right) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n_k) out[i] = rank_of(fences, n_f, keys[i], right);
}

__global__ void rank_shared(const int64_t* __restrict__ fences, int64_t n_f,
                            const int64_t* __restrict__ keys, int64_t n_k,
                            int64_t* __restrict__ out, int right) {
  extern __shared__ int64_t sf[];
  for (int64_t j = threadIdx.x; j < n_f; j += blockDim.x) sf[j] = fences[j];
  __syncthreads();
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n_k) out[i] = rank_of(sf, n_f, keys[i], right);
}

}  // namespace

extern "C" int fence_rank_launch(const void* fences, int64_t n_f,
                                 const void* keys, int64_t n_k, void* out,
                                 int right, void* stream) {
  if (n_k == 0) return 0;
  const int64_t blocks = (n_k + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* f = static_cast<const int64_t*>(fences);
  const int64_t* k = static_cast<const int64_t*>(keys);
  int64_t* o = static_cast<int64_t*>(out);
  if (n_f <= kSharedFences) {
    size_t smem = static_cast<size_t>(n_f > 0 ? n_f : 1) * sizeof(int64_t);
    rank_shared<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        f, n_f, k, n_k, o, right);
  } else {
    rank_global<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        f, n_f, k, n_k, o, right);
  }
  return static_cast<int>(cudaGetLastError());
}
