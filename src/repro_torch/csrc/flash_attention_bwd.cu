// The gradient of flash_attention (csrc/flash_attention.cu): dQ, dK and dV
// of causal, sliding-window or non-causal (Sk != Sq) attention, for bf16
// or fp32 q/k/v of head_dim 64, 128 or 256, with fp32 accumulation and the
// grads written in the inputs' dtype.
//
// The TPU reference has no backward kernel: it trains through plain jnp
// attention (src/repro/models/attention.py, _sdpa, differentiated by
// jax.grad; train_loss(use_pallas=False)).  The port's attention always
// goes through the flash_attention kernel, so its gradient is this kernel,
// the backward of the autograd.Function in kernels/flash_attention/ops.py.
//
// The formulas (the plain version, flash_attention_bwd_plain): P is
// recomputed from the forward's fp32 row log-sum-exp under the forward's
// mask (kj < Sk; kj <= qi if causal; qi - kj < window), then
//   delta = rowsum(dO * O),  dV = P^T dO,  dS = P * (dO V^T - delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// A fully masked row has P = 0, so it adds nothing anywhere: the forward's
// clamp gives it an output of 0.
//
// Two kernels, both deterministic (no atomics: every output element is
// summed by one thread in a fixed order, so two calls are bitwise equal):
//
// * bwd_dq: one block per (b, q head, query tile).  Its prologue computes
//   delta for the tile's rows from O and dO and writes it out for bwd_dkdv;
//   then it walks the key tiles the rows can see and accumulates dQ.
// * bwd_dkdv: one block per (b, kv head, key tile).  It walks every query
//   tile that can see its keys, for every query head of its GQA group in
//   turn, so the group's sum happens inside the block.  Launched after
//   bwd_dq on the same stream, it reads delta from it.
//
// Bound on the H100: 10 * D operations per unmasked (query, key) pair
// (five products of 2 * D: Q.K^T and dO.V^T recomputed, dV, dK, dQ),
// against bf16's tensor-core rate.  This first kernel is simple rather
// than fast: every product runs on the CUDA cores in fp32 from fp32 tiles
// in shared memory, 256 threads a block, T x T tiles (T = 64, 32 at D
// 256, where a thread's dK and dV accumulators are 2 x 32 fp32 registers
// as at D 128).  Each tile row's T / (256 / T) scores are computed by the
// 256 / T consecutive threads of one warp that later read them back, so a
// tile of P and dS needs only __syncwarp between its writes and reads.
// Tensor cores (wgmma), TMA and warp specialisation are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
struct Cfg {
  static constexpr int T = D == 256 ? 32 : 64;   // query rows = keys a tile
  static constexpr int R = kThreads / T;         // threads per tile row
  static constexpr int N = T / R;                // scores per thread
  static constexpr int C4 = D / (4 * R);         // float4 columns a thread
  static constexpr int LD = D + 4;               // padded q/k/v/dO row
  static constexpr int LP = T + 4;               // padded P / dS row
  static constexpr size_t TILE = sizeof(float) * T * LD;
  static constexpr size_t PTILE = sizeof(float) * T * LP;
  // bwd_dq: Q, dO, K, V tiles, dS, lse and delta
  static constexpr size_t SMEM_DQ = 4 * TILE + PTILE + 2 * sizeof(float) * T;
  // bwd_dkdv: K, V, Q, dO tiles, P, dS, lse and delta
  static constexpr size_t SMEM_DKDV =
      4 * TILE + 2 * PTILE + 2 * sizeof(float) * T;
  static_assert(SMEM_DKDV <= 232448, "a block's shared memory");
};

// rows [r0, r0 + T) of a [rows, D] matrix into a padded fp32 tile, zeros
// past `rows`
template <typename T_, int D, int T>
__device__ __forceinline__ void load_tile(float* dst, const T_* src, int r0,
                                          int rows) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < T * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] =
        (r0 + r < rows) ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

__device__ __forceinline__ bool keep(int qi, int kj, int sq, int sk,
                                     int causal, int window) {
  return qi < sq && kj < sk && (!causal || kj <= qi) &&
         (window <= 0 || qi - kj < window);
}

// x . y over D columns of two padded fp32 rows
template <int D>
__device__ __forceinline__ float dot_row(const float* x, const float* y) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + d);
    const float4 b = *reinterpret_cast<const float4*>(y + d);
    acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  return acc;
}

template <typename T_, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq(const T_* __restrict__ q, const T_* __restrict__ k,
       const T_* __restrict__ v, const T_* __restrict__ o,
       const float* __restrict__ lse, const T_* __restrict__ dout,
       T_* __restrict__ dq, float* __restrict__ delta, int hq, int hkv,
       int sq, int sk, int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int T = C::T, R = C::R, LD = C::LD, LP = C::LP;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                 // [T][LD]
  float* s_do = s_q + T * LD;        // [T][LD]
  float* s_k = s_do + T * LD;        // [T][LD]
  float* s_v = s_k + T * LD;         // [T][LD]
  float* s_ds = s_v + T * LD;        // [T][LP]
  float* s_lse = s_ds + T * LP;      // [T]
  float* s_delta = s_lse + T;        // [T]

  const int bh = blockIdx.y;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int i = tid / R, sub = tid % R;   // this thread's row and lane in it
  const int qi = q0 + i;
  const T_* kg = k + (size_t)kvh * sk * D;
  const T_* vg = v + (size_t)kvh * sk * D;

  load_tile<T_, D, T>(s_q, q + (size_t)bh * sq * D, q0, sq);
  load_tile<T_, D, T>(s_do, dout + (size_t)bh * sq * D, q0, sq);
  // delta of row i: its R threads each sum a slice of dO * O
  {
    float part = 0.f;
    if (qi < sq) {
      const T_* orow = o + ((size_t)bh * sq + qi) * D;
      const T_* drow = dout + ((size_t)bh * sq + qi) * D;
      for (int c = sub; c < D; c += R) part += to_f(drow[c]) * to_f(orow[c]);
    }
#pragma unroll
    for (int off = 1; off < R; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (sub == 0) {
      s_delta[i] = part;
      s_lse[i] = qi < sq ? lse[(size_t)bh * sq + qi] : 0.f;
      if (qi < sq) delta[(size_t)bh * sq + qi] = part;
    }
  }

  float acc[4 * C::C4];
#pragma unroll
  for (int c = 0; c < 4 * C::C4; ++c) acc[c] = 0.f;

  const int q_last = min(q0 + T - 1, sq - 1);
  const int n_kt = (sk + T - 1) / T;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / T : 0;
  const int kt_hi = causal ? min(n_kt, q_last / T + 1) : n_kt;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * T;
    __syncthreads();   // the previous tile's reads of s_k / s_v are done
    load_tile<T_, D, T>(s_k, kg, k0, sk);
    load_tile<T_, D, T>(s_v, vg, k0, sk);
    __syncthreads();
    const float lse_i = s_lse[i], delta_i = s_delta[i];
#pragma unroll 2
    for (int n = 0; n < C::N; ++n) {
      const int j = sub + R * n;
      float ds = 0.f;
      if (keep(qi, k0 + j, sq, sk, causal, window)) {
        const float p =
            expf(dot_row<D>(s_q + i * LD, s_k + j * LD) * scale - lse_i);
        ds = p * (dot_row<D>(s_do + i * LD, s_v + j * LD) - delta_i);
      }
      s_ds[i * LP + j] = ds;
    }
    __syncwarp();      // row i of dS is written and read by one warp
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      const float ds = s_ds[i * LP + j];
#pragma unroll
      for (int c4 = 0; c4 < C::C4; ++c4) {
        const float4 kv = *reinterpret_cast<const float4*>(
            &s_k[j * LD + sub * 4 + 4 * R * c4]);
        acc[4 * c4 + 0] += ds * kv.x;
        acc[4 * c4 + 1] += ds * kv.y;
        acc[4 * c4 + 2] += ds * kv.z;
        acc[4 * c4 + 3] += ds * kv.w;
      }
    }
    __syncwarp();      // row i of dS is rewritten by the next tile
  }
  if (qi < sq) {
    T_* row = dq + ((size_t)bh * sq + qi) * D;
#pragma unroll
    for (int c4 = 0; c4 < C::C4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&row[sub * 4 + 4 * R * c4 + e], acc[4 * c4 + e] * scale);
  }
}

template <typename T_, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv(const T_* __restrict__ q, const T_* __restrict__ k,
         const T_* __restrict__ v, const float* __restrict__ lse,
         const T_* __restrict__ dout, const float* __restrict__ delta,
         T_* __restrict__ dk, T_* __restrict__ dv, int hq, int hkv, int sq,
         int sk, int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int T = C::T, R = C::R, LD = C::LD, LP = C::LP;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                 // [T][LD]
  float* s_v = s_k + T * LD;         // [T][LD]
  float* s_q = s_v + T * LD;         // [T][LD]
  float* s_do = s_q + T * LD;        // [T][LD]
  float* s_p = s_do + T * LD;        // [T][LP]
  float* s_ds = s_p + T * LP;        // [T][LP]
  float* s_lse = s_ds + T * LP;      // [T]
  float* s_delta = s_lse + T;        // [T]

  const int bkv = blockIdx.y;        // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int rep = hq / hkv;
  const int k0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int j = tid / R, sub = tid % R;   // this thread's key and lane
  const int kj = k0 + j;

  load_tile<T_, D, T>(s_k, k + (size_t)bkv * sk * D, k0, sk);
  load_tile<T_, D, T>(s_v, v + (size_t)bkv * sk * D, k0, sk);

  float acc_k[4 * C::C4], acc_v[4 * C::C4];
#pragma unroll
  for (int c = 0; c < 4 * C::C4; ++c) acc_k[c] = acc_v[c] = 0.f;

  // the query tiles some key of this tile is visible from
  const int k_last = min(k0 + T - 1, sk - 1);
  const int n_qt = (sq + T - 1) / T;
  const int qt_lo = causal ? k0 / T : 0;
  const int qt_hi =
      window > 0 ? min(n_qt, (k_last + window - 1) / T + 1) : n_qt;
  for (int g = 0; g < rep; ++g) {
    const int bh = b * hq + kvh * rep + g;
    const T_* qg = q + (size_t)bh * sq * D;
    const T_* dog = dout + (size_t)bh * sq * D;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * T;
      __syncthreads();   // the previous tile's reads are done
      load_tile<T_, D, T>(s_q, qg, q0, sq);
      load_tile<T_, D, T>(s_do, dog, q0, sq);
      if (tid < T) {
        const bool in = q0 + tid < sq;
        s_lse[tid] = in ? lse[(size_t)bh * sq + q0 + tid] : 0.f;
        s_delta[tid] = in ? delta[(size_t)bh * sq + q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int n = 0; n < C::N; ++n) {
        const int i = sub + R * n;
        float p = 0.f, ds = 0.f;
        if (keep(q0 + i, kj, sq, sk, causal, window)) {
          p = expf(dot_row<D>(s_q + i * LD, s_k + j * LD) * scale -
                   s_lse[i]);
          ds = p * (dot_row<D>(s_do + i * LD, s_v + j * LD) - s_delta[i]);
        }
        s_p[i * LP + j] = p;
        s_ds[i * LP + j] = ds;
      }
      __syncwarp();    // column j of P and dS is written and read by one warp
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        const float p = s_p[i * LP + j], ds = s_ds[i * LP + j];
#pragma unroll
        for (int c4 = 0; c4 < C::C4; ++c4) {
          const int c = sub * 4 + 4 * R * c4;
          const float4 dov =
              *reinterpret_cast<const float4*>(&s_do[i * LD + c]);
          const float4 qv =
              *reinterpret_cast<const float4*>(&s_q[i * LD + c]);
          acc_v[4 * c4 + 0] += p * dov.x;
          acc_v[4 * c4 + 1] += p * dov.y;
          acc_v[4 * c4 + 2] += p * dov.z;
          acc_v[4 * c4 + 3] += p * dov.w;
          acc_k[4 * c4 + 0] += ds * qv.x;
          acc_k[4 * c4 + 1] += ds * qv.y;
          acc_k[4 * c4 + 2] += ds * qv.z;
          acc_k[4 * c4 + 3] += ds * qv.w;
        }
      }
      __syncwarp();
    }
  }
  if (kj < sk) {
    T_* krow = dk + ((size_t)bkv * sk + kj) * D;
    T_* vrow = dv + ((size_t)bkv * sk + kj) * D;
#pragma unroll
    for (int c4 = 0; c4 < C::C4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = sub * 4 + 4 * R * c4 + e;
        store(&krow[c], acc_k[4 * c4 + e] * scale);
        store(&vrow[c], acc_v[4 * c4 + e]);
      }
  }
}

template <typename T_, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int b, int hq, int hkv, int sq, int sk, int causal,
           int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq<T_, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM_DQ));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(bwd_dkdv<T_, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM_DKDV));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const T_* qt = static_cast<const T_*>(q);
  const T_* kt = static_cast<const T_*>(k);
  const T_* vt = static_cast<const T_*>(v);
  const T_* dot = static_cast<const T_*>(dout);
  dim3 grid_q((sq + C::T - 1) / C::T, b * hq);
  bwd_dq<T_, D><<<grid_q, kThreads, C::SMEM_DQ, stream>>>(
      qt, kt, vt, static_cast<const T_*>(o), lse, dot, static_cast<T_*>(dq),
      delta, hq, hkv, sq, sk, causal, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sk <= 0) return 0;
  dim3 grid_k((sk + C::T - 1) / C::T, b * hkv);
  bwd_dkdv<T_, D><<<grid_k, kThreads, C::SMEM_DKDV, stream>>>(
      qt, kt, vt, lse, dot, delta, static_cast<T_*>(dk), static_cast<T_*>(dv),
      hq, hkv, sq, sk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 64, 128 or 256; window <= 0 =
// global; sk != sq only for a non-causal, unwindowed call.
// q, o, dout, dq: [b*hq, sq, d]; k, v, dk, dv: [b*hkv, sk, d]; lse (the
// forward's) and delta (scratch, written here): [b*hq, sq] fp32; all
// contiguous.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    int window, float scale, int dtype, void* stream) {
  if (b * hq <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sk < 0 || b * hq > 65535 ||
      (sk != sq && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define FLASH_BWD(T_, D)                                                    \
  return launch<T_, D>(q, k, v, o, l, dout, dq, dk, dv, dl, b, hq, hkv, sq, \
                       sk, causal, window, scale, st)
  if (dtype == 0 && d == 64) FLASH_BWD(float, 64);
  if (dtype == 0 && d == 128) FLASH_BWD(float, 128);
  if (dtype == 0 && d == 256) FLASH_BWD(float, 256);
  if (dtype == 1 && d == 64) FLASH_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) FLASH_BWD(__nv_bfloat16, 128);
  if (dtype == 1 && d == 256) FLASH_BWD(__nv_bfloat16, 256);
#undef FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
