// Mamba2 SSD scan: s_t = exp(dt_t a) s_{t-1} + dt_t B_t x_t^T, y_t = C_t s_t
// per head, computed chunk by chunk with the [N, P] state carried across
// chunks, for bf16 or fp32 x/dt/B/C (a in fp32), fp32 arithmetic.  Writes
// y and the final state s_L (fp32), which a prefill hands to decode.
//
// Replaces the ssd_scan TPU kernel: src/repro/kernels/ssd_scan/kernel.py,
// _ssd_kernel / ssd_scan_call (wrapper ops.py).  There the grid is
// (BH, chunks) with the chunk sweep as the sequential minor dimension and
// the state in VMEM scratch.  Here one thread block owns one head (bh), or
// a group of its state columns, and loops over the sequence itself,
// holding the state in shared memory, in sub-chunks of up to 64 steps (the
// math is exact for any chunking; the wrapper still pads L as the
// reference's ops.py does).  Per sub-chunk, with a_cs = a * cumsum(dt):
//   y_t  = exp(a_cs_t) C_t S_prev + sum_{j<=t} exp(a_cs_t - a_cs_j) dt_j
//          (C_t . B_j) x_j
//   S    = exp(a_cs_last) S_prev + sum_j exp(a_cs_last - a_cs_j) dt_j B_j x_j^T
// exp(a_cs_t - a_cs_j) is evaluated only for j <= t, where its argument is
// <= 0; the TPU kernel evaluates every pair and masks afterwards, which can
// overflow to inf before the mask.  B and C are read per group (head h
// uses group h / (H / G)), so the wrapper does not repeat them.
//
// Bound on the H100: memory — the function reads x, dt, B, C and writes y
// once, and its 4*N*P operations per step are far below the tensor-core
// rate.  The products run on the CUDA cores in fp32, register-tiled 4x4
// out of shared memory.  The state's P columns are independent, so a head
// of P = 64 runs as two blocks of 32 columns (each recomputes the chunk's
// C.B products): 128 blocks for zamba2-1.2b at batch 1, near the 132 SMs.
// Splitting the sequence across blocks needs a second pass over the chunk
// states and is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kKC = 64;          // steps per sub-chunk
constexpr int kLD = kKC + 4;     // padded row stride of the transposed tiles
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Columns of the state (and of x and y) handled by one block.
int cols_per_block(int p) { return p % 32 == 0 ? 32 : p; }

size_t smem_floats(int n, int pp) {
  return (size_t)n * pp             // state S [n][pp]
         + (size_t)kKC * pp         // x [KC][pp]
         + 2 * (size_t)n * kLD      // B^T, C^T [n][LD]
         + (size_t)kKC * kLD        // W^T [KC][LD]: W^T[j][t] = W[t][j]
         + 3 * (size_t)kKC;         // dt, a_cs, w_j
}

// One block per (head, group of pp state columns): the columns of S, x
// and y are independent, so heads of P = 64 run as two blocks each.
// Within a sub-chunk every product is register-tiled: a thread owns a 4x4
// output tile and reads float4 rows of shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const T* __restrict__ dt,
        const float* __restrict__ a, const T* __restrict__ bmat,
        const T* __restrict__ cmat, T* __restrict__ y,
        float* __restrict__ s_out, int h, int g, int L, int n, int p,
        int pp) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                  // [n][pp]
  float* xs = st + n * pp;           // [KC][pp]
  float* bT = xs + kKC * pp;         // [n][LD]
  float* cT = bT + n * kLD;          // [n][LD]
  float* wT = cT + n * kLD;          // [KC][LD]
  float* dts = wT + kKC * kLD;       // [KC]
  float* acs = dts + kKC;            // [KC]
  float* wj = acs + kKC;             // [KC]

  const int bh = blockIdx.x;
  const int p0 = blockIdx.y * pp;
  const int bg = (bh / h) * g + (bh % h) / (h / g);
  const float av = a[bh];
  const T* xg = x + (size_t)bh * L * p;
  const T* dg = dt + (size_t)bh * L;
  const T* bgp = bmat + (size_t)bg * L * n;
  const T* cgp = cmat + (size_t)bg * L * n;
  T* yg = y + (size_t)bh * L * p;
  const int tid = threadIdx.x;
  const int pq = pp / 4;

  for (int i = tid; i < n * pp; i += kThreads) st[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kKC) {
    const int T_ = min(kKC, L - t0);
    const int tq = (T_ + 3) / 4;   // 4-row tiles; rows past T_ are zero
    const int T4 = 4 * tq;
    __syncthreads();  // the previous sub-chunk's reads are done
    for (int i = tid; i < T4 * pp; i += kThreads) {
      const int t = i / pp, c = i % pp;
      xs[i] = t < T_ ? to_f(xg[(size_t)(t0 + t) * p + p0 + c]) : 0.f;
    }
    for (int i = tid; i < T4 * n; i += kThreads) {
      const int t = i / n, c = i % n;
      const bool in = t < T_;
      bT[c * kLD + t] = in ? to_f(bgp[(size_t)(t0 + t) * n + c]) : 0.f;
      cT[c * kLD + t] = in ? to_f(cgp[(size_t)(t0 + t) * n + c]) : 0.f;
    }
    for (int i = tid; i < kKC; i += kThreads)
      dts[i] = i < T_ ? to_f(dg[t0 + i]) : 0.f;
    __syncthreads();
    if (tid < 32) {  // a_cs = a * inclusive cumsum(dt): a warp scan
      const float v0 = dts[2 * tid], v1 = dts[2 * tid + 1];
      float run = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += o;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (tid == 0) before = 0.f;
      acs[2 * tid] = av * (before + v0);
      acs[2 * tid + 1] = av * (before + v0 + v1);
    }
    __syncthreads();
    const float a_last = acs[T_ - 1];
    for (int i = tid; i < kKC; i += kThreads)  // 0 past T_ (dt = 0 there)
      wj[i] = expf(a_last - acs[i]) * dts[i];
    // W[t][j] = (C_t . B_j) * exp(a_cs_t - a_cs_j) * dt_j for j <= t, else 0
    for (int i = tid; i < tq * tq; i += kThreads) {
      const int tb = i / tq, jb = i % tq;
      float acc[4][4] = {};
      if (jb <= tb) {
        for (int c = 0; c < n; ++c) {
          const float4 cv = ld4(&cT[c * kLD + 4 * tb]);
          const float4 bv = ld4(&bT[c * kLD + 4 * jb]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) acc[r][s] += cr[r] * br[s];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int t = 4 * tb + r, j = 4 * jb + s;
          wT[j * kLD + t] =
              j <= t ? acc[r][s] * expf(acs[t] - acs[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();
    // y_t = exp(a_cs_t) C_t S_prev + sum_{j<=t} W[t][j] x_j
    for (int i = tid; i < tq * pq; i += kThreads) {
      const int tb = i / pq, pb = i % pq;
      float inter[4][4] = {}, intra[4][4] = {};
      for (int e = 0; e < n; ++e) {
        const float4 cv = ld4(&cT[e * kLD + 4 * tb]);
        const float4 sv = ld4(&st[e * pp + 4 * pb]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) inter[r][s] += cr[r] * sr[s];
      }
      for (int j = 0; j < 4 * tb + 4; ++j) {
        const float4 wv = ld4(&wT[j * kLD + 4 * tb]);
        const float4 xv = ld4(&xs[j * pp + 4 * pb]);
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) intra[r][s] += wr[r] * xr[s];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * tb + r;
        if (t >= T_) continue;
        const float decay = expf(acs[t]);
        T* out = &yg[(size_t)(t0 + t) * p + p0 + 4 * pb];
#pragma unroll
        for (int s = 0; s < 4; ++s)
          store(&out[s], decay * inter[r][s] + intra[r][s]);
      }
    }
    __syncthreads();  // every read of S_prev is done
    // S = exp(a_cs_last) S_prev + sum_j (B_j w_j) x_j^T
    const float lam = expf(a_last);
    for (int i = tid; i < (n / 4) * pq; i += kThreads) {
      const int eb = i / pq, pb = i % pq;
      float acc[4][4] = {};
      for (int j = 0; j < T4; ++j) {
        const float w = wj[j];
        const float4 xv = ld4(&xs[j * pp + 4 * pb]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bw = bT[(4 * eb + r) * kLD + j] * w;
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] += bw * xr[s];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float* sp = &st[(4 * eb + r) * pp + 4 * pb + s];
          *sp = lam * *sp + acc[r][s];
        }
    }
  }
  __syncthreads();
  float* sg = s_out + (size_t)bh * n * p + p0;  // this block's columns
  for (int i = tid; i < n * pp; i += kThreads)
    sg[(size_t)(i / pp) * p + i % pp] = st[i];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* s_out, int bh, int h, int g, int L,
           int n, int p, cudaStream_t stream) {
  const int pp = cols_per_block(p);
  const size_t smem = smem_floats(n, pp) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, p / pp);
  ssd_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(s_out), h, g, L, n, p, pp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c, y); a is float32.
// x, y: [bh, L, p]; dt: [bh, L]; a: [bh]; b, c: [(bh / h) * g, L, n];
// s_out: [bh, n, p] float32, the state after step L - 1; all contiguous;
// n and p multiples of 4.  A block's state columns and
// sub-chunk buffers (smem_floats) must fit in its 227 KB of shared memory.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y,
                               void* s_out, int bh, int h, int g, int L, int n,
                               int p, int dtype, void* stream) {
  if (bh <= 0 || L <= 0) return 0;
  if (h <= 0 || g <= 0 || h % g != 0 || bh % h != 0 || n <= 0 || p <= 0 ||
      n % 4 != 0 || p % 4 != 0 ||
      smem_floats(n, cols_per_block(p)) * sizeof(float) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, b, c, y, s_out, bh, h, g, L, n, p, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, s_out, bh, h, g, L, n, p,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
