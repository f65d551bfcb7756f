// Single-token (decode) attention over a page pool through a page table,
// query heads grouped per kv head, fp32 online softmax, for bf16 or fp32
// q and pages of head_dim 64 or 128.
//
// Replaces the paged_attention TPU kernel: src/repro/kernels/
// paged_attention/kernel.py, _paged_kernel / paged_attention_call (wrapper
// ops.py, oracle ref.py).  There the grid is (B, Hkv, MAXP) with the page
// sweep as the sequential minor dimension, the page table and lengths in
// SMEM by scalar prefetch, each step's BlockSpec picking page pt[b, p] out
// of HBM, the running max, sum and accumulator in VMEM scratch, and pages
// past the length skipped with pl.when.  Here one thread block owns one
// (sequence b, kv head h) and loops over the sequence's tokens itself, 32
// at a time (one per lane): each row of a tile looks up its own page
// (page_table[b, tok / PS], row tok % PS), so a tile may span pages and
// any page size works.  Only tokens below min(length, MAXP * PS) are
// visited, so neither a page-table entry past the length nor a page row
// past it is ever read.  The block's G query rows (G = Hq / Hkv, 1..8) sit
// in shared memory as fp32; K and V tiles are converted to fp32 in shared
// memory; lane j scores key j against each query row, the warp of that row
// updates its running max and sum (shuffles), and each thread accumulates
// one output column of its rows in registers.  Semantics are the
// reference's: logits of masked keys are -1e30, masked probabilities are
// zero, the output is acc / max(l, 1e-30), so a length of 0 gives zeros.
//
// Bound on the H100: memory.  The function reads each live token's K and V
// rows once (2 * length * D * bytes per kv head) and does 4 * D operations
// per (query head, token), a few operations per byte, far below the ~295
// per byte where the tensor cores would bind.  This first version does not
// pipeline its loads (no cp.async/TMA) and gives each (b, kv head) one
// block: at batch 1 and 8 kv heads the grid is 8 blocks on 132 SMs, so a
// sequence's pages are not split over blocks (flash-decoding) yet.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;         // tokens per tile: one per lane
constexpr int kMaxG = 8;        // query heads per kv head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One 16-byte load of T, widened to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_fwd(const T* __restrict__ q, const T* __restrict__ kp,
          const T* __restrict__ vp, const int* __restrict__ page_table,
          const int* __restrict__ lengths, T* __restrict__ o, int hkv, int g,
          int ps, int maxp, float scale) {
  constexpr int LD = D + 1;             // padded row: lane j reads row j
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = D / VN;           // 16-byte vectors per row
  constexpr int CPT = kThreads / D;     // threads per output column
  constexpr int RPT = kMaxG / CPT;      // query rows a thread may own
  __shared__ float sq[kMaxG][D];
  __shared__ float sk[kTK][LD];
  __shared__ float sv[kTK][LD];
  __shared__ float sp[kMaxG][kTK + 1];
  __shared__ float sm[kMaxG], sl[kMaxG], salpha[kMaxG];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t q_off = ((size_t)b * hkv + h) * (size_t)g * D;
  for (int i = tid; i < g * D; i += kThreads) sq[i / D][i % D] = to_f(q[q_off + i]);
  if (tid < kMaxG) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  const int length = lengths[b];
  const long long cap = (long long)maxp * ps;
  const int n_tok = length <= 0 ? 0 : (int)(length < cap ? length : cap);
  const int* pt = page_table + (size_t)b * maxp;
  const size_t row_stride = (size_t)hkv * D;    // between rows of a page
  const int col = tid % D;
  const int g0 = tid / D;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < n_tok; t0 += kTK) {
    __syncthreads();    // the previous tile's readers are done
    for (int i = tid; i < kTK * VPR; i += kThreads) {
      const int r = i / VPR;
      const int c = (i % VPR) * VN;
      const int tok = t0 + r;
      float kx[VN], vx[VN];
      if (tok < n_tok) {
        const size_t off =
            ((size_t)pt[tok / ps] * ps + tok % ps) * row_stride +
            (size_t)h * D + c;
        Vec<T>::load(kp + off, kx);
        Vec<T>::load(vp + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        sk[r][c + e] = kx[e];
        sv[r][c + e] = vx[e];
      }
    }
    __syncthreads();
    const bool live = t0 + lane < n_tok;
    for (int gi = warp; gi < g; gi += kWarps) {
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(sq[gi][d], sk[lane][d], s);
      s = live ? s * scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm[gi];
      const float m_new = fmaxf(m_prev, mx);
      const float p = live ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sp[gi][lane] = p;
      // every lane read m_prev before the shuffles above
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[gi] = alpha * sl[gi] + sum;
        sm[gi] = m_new;
        salpha[gi] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int gi = g0 + i * CPT;
      if (gi < g) {
        float a = acc[i] * salpha[gi];
#pragma unroll 8
        for (int j = 0; j < kTK; ++j) a = fmaf(sp[gi][j], sv[j][col], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();      // sl is final (and initialised when n_tok == 0)
  T* ob = o + q_off;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gi = g0 + i * CPT;
    if (gi < g) store(ob + (size_t)gi * D + col, acc[i] / fmaxf(sl[gi], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* lengths, void* o, int b, int hkv, int g, int ps,
           int maxp, float scale, cudaStream_t stream) {
  dim3 grid(hkv, b);
  paged_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(lengths), static_cast<T*>(o), hkv, g, ps, maxp,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128.  q, o: [b, hq, d];
// k, v: [n_pages, ps, hkv, d]; page_table: [b, maxp] int32; lengths: [b]
// int32; all contiguous, q/k/v 16-byte aligned.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* page_table,
                                      const void* lengths, void* o, int b,
                                      int hq, int hkv, int d, int ps,
                                      int maxp, float scale, int dtype,
                                      void* stream) {
  if (b <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxG || ps <= 0 || maxp < 0 ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, page_table, lengths, o, b, hkv, g, ps,
                             maxp, scale, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, page_table, lengths, o, b, hkv, g, ps,
                              maxp, scale, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, page_table, lengths, o, b, hkv,
                                     g, ps, maxp, scale, st);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, page_table, lengths, o, b,
                                      hkv, g, ps, maxp, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
