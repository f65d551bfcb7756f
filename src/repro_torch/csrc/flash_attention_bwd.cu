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
// summed by one thread, or by one chain of wgmmas, in a fixed order, so
// two calls are bitwise equal):
//
// * dq: one block per (b, q head, query tile).  Its prologue computes
//   delta for the tile's rows from O and dO and writes it out for dkdv;
//   then it walks the key tiles the rows can see and accumulates dQ.
// * dkdv: one block per (b, kv head, key tile).  It walks every query
//   tile that can see its keys, for every query head of its GQA group in
//   turn, so the group's sum happens inside the block (at bf16 D 256 it
//   may take one query head a block and leave the group's sum to a third
//   kernel, below).  Launched after dq on the same stream, it reads delta
//   from it.
//
// Bound on the H100: 10 * D operations per unmasked (query, key) pair
// (five products of 2 * D: Q.K^T and dO.V^T recomputed, dV, dK, dQ),
// against bf16's tensor-core rate.
//
// bf16 (bwd_dq_wgmma, with bwd_dkdv_wgmma at head_dim 64 and 128 and
// bwd_dkdv_wgmma2 at 256), the training paths' shapes (qwen3's 128,
// whisper's 64, gemma3's 256): every product is a wgmma with fp32
// accumulators, its operands in 128-byte-swizzled shared tiles filled by a
// cp.async ring (the helpers of wgmma.cuh, shared with the forward):
//
//   bwd_dq, 64 query rows:  S = Q.K^T and dP = dO.V^T with Q and dO
//     resident and K and V tiles streaming (all K-major), then dQ += dS.K
//     with dS from registers and K through the descriptor's transpose
//     (MN-major), as the forward reads V.  Key tiles of 64, but of 32 at D
//     256, where dQ alone is 128 fp32 registers a thread (S and dP then
//     m64n32, 16 each, as the forward's D 256 scores).
//   bwd_dkdv, 64 keys:  S^T = K.Q^T and dP^T = V.dO^T with K and V
//     resident and Q and dO tiles streaming, then dV += P^T.dO and
//     dK += dS^T.Q with P^T and dS^T from registers and dO and Q
//     MN-major.  The key tile is M, so the accumulator fragment of S^T is
//     exactly the A fragment of P^T.dO (wgmma.cuh's note): P, P^T, dS and
//     dS^T are never transposed, and each Q or dO tile is a K-major B in
//     one product and an MN-major B in another.  Each thread reads the lse
//     and delta of its fragment's query columns from a small shared array
//     that rides with the tile.
//
// The plain version multiplies fp32 P and dS into dV, dK and dQ; one bf16
// rounding of them leaves dozens of elements of each gradient outside the
// bf16 TOL at every tested shape, so each of the three is two wgmmas per
// 16 columns, hi then lo (~16 significant bits; the CPU mirror in
// tests/test_torch_flash_backward.py shows both), which makes the work
// 10 products of 2 * D a pair, twice the bound's count.  Registers: at D
// 128 dK and dV alone take 128 fp32 accumulators a thread, so bwd_dkdv
// there takes 32-query tiles (S^T and dP^T as m64n32, 16 each); at D 64,
// 64-query tiles.  Longest work first: bwd_dq runs its query tiles in
// reverse (the long causal rows first), bwd_dkdv its key tiles from 0.
// At D 64 and 128, dV's wgmmas run while dS^T is formed; otherwise each
// warpgroup waits on its own wgmmas, and the probabilities, the mask and
// the splits run on the CUDA cores.
//
// bwd_dkdv at D 256 (gemma3's 4 query heads over 1 kv head): dK and dV of
// 64 keys would take 128 + 128 fp32 registers a thread in one warpgroup,
// so bwd_dkdv_wgmma2 runs two warpgroups a block, WG0 owning dV and WG1
// dK, each with one 128-register accumulator.  On each 32-query tile WG0
// computes S^T = K.Q^T and P^T under the mask and hands P^T, in fp32, to
// WG1 through 8 KB of shared memory (each thread's 16 values at the same
// fragment position in both warpgroups, so thread t of WG1 reads what
// thread t of WG0 wrote; a named barrier, arrive then sync, orders them),
// then dV += P^T.dO; WG1 meanwhile computes dP^T = V.dO^T, takes P^T and
// forms dS^T = P^T * (dP^T - delta), then dK += dS^T.Q.  Each warpgroup
// runs one SS and one split RS product a tile, on the same products and
// in the same fp32 arithmetic as bwd_dkdv_wgmma.  One exchange buffer is
// enough:
// the ring's __syncthreads at the top of every tile keeps the two
// warpgroups within one tile of each other.  This was chosen over two
// one-warpgroup passes (dV, then dK, each recomputing S^T) because it
// costs no product beyond the one-warpgroup design's and the exchange is a
// plain per-thread copy.  K and V stay resident (64 KB), Q and dO tiles of
// 32 rows come through a four-stage ring (128 KB), one block an SM.  With
// gemma3's one kv head, one block per (b, kv head, 64 keys) is 64 blocks
// at 4,096 tokens on 132 SMs, the first walking 4 heads x 128 query tiles
// (measured: dK and dV took 5x dQ's time), so with GQA the wrapper passes
// fp32 scratch and each block takes one query head of the group and
// writes its unscaled sums there; bwd_dkdv_sum then adds the group's
// heads in order, scales dK and rounds both once to bf16 (still no
// atomics).
//
// What stays on the CUDA-core kernels below (bwd_dq, bwd_dkdv: every
// product in fp32 from fp32 shared tiles, 256 threads, T x T tiles, T 64,
// 32 at D 256): every fp32 call.  The fp32 TOL (1e-4, 1e-4) and the
// float32 card-vs-CPU training cross-checks need fp32 operands; bf16 or
// TF32 ones do not meet them.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---------------------------------------------------------------- wgmma
constexpr int kWg = 128;      // one warpgroup
constexpr int kRows = 64;     // M of every wgmma: query rows or keys
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WCfg {
  static constexpr int TILE = kRows * D * 2;   // a resident 64-row tile
  // bwd_dq_wgmma: BK-key K and V tiles through an NS_Q-stage ring
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int NS_Q = D == 64 ? 3 : D == 128 ? 2 : 4;
  static constexpr int KV_TILE = BK * D * 2;
  static constexpr int STAGE_Q = 2 * KV_TILE;   // K tile then V tile
  // + 1024 to align the tiles to the swizzle's 1024-byte period
  static constexpr size_t SMEM_DQ = 1024 + 2 * TILE + NS_Q * STAGE_Q;
  // bwd_dkdv_wgmma(2): BQ-query Q and dO tiles through an NS_K-stage ring,
  // each stage's rows' lse and delta in a float array after the ring
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int NS_K = D == 256 ? 4 : 3;
  static constexpr int Q_TILE = BQ * D * 2;
  static constexpr int STAGE_K = 2 * Q_TILE;    // Q tile then dO tile
  static constexpr size_t SMEM_DKDV =
      1024 + 2 * TILE + NS_K * STAGE_K + NS_K * 2 * BQ * sizeof(float);
  // bwd_dkdv_wgmma2's P^T exchange (static shared memory): BQ / 2 fp32
  // values a thread of one warpgroup
  static constexpr size_t XCH = BQ / 2 * kWg * sizeof(float);
  static_assert(SMEM_DQ + kRows * sizeof(float) <= 232448 &&
                    SMEM_DKDV + (D == 256 ? XCH : 0) <= 232448,
                "a block's shared memory");
};

// sum of the products of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s += fx.x * fy.x + fx.y * fy.y;
  }
  return s;
}

// dQ of 64 query rows of one (b, q head): S = Q.K^T and dP = dO.V^T (Q, dO
// resident; K, V streaming; all K-major), P = exp(S * scale - lse) under
// the mask, dS = P * (dP - delta), dQ += dS.K with dS from registers in
// hi and lo halves and K MN-major.  Writes delta for the rows first.
template <int D>
__global__ void __launch_bounds__(kWg, 1)
bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ o,
             const float* __restrict__ lse,
             const __nv_bfloat16* __restrict__ dout,
             __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
             int hq, int hkv, int sq, int sk, int causal, int window,
             float scale) {
  using C = WCfg<D>;
  constexpr int BK = C::BK, NS = C::NS_Q;
  constexpr int KS = D / 16;     // k-steps of S and dP
  constexpr int NT = BK / 8;     // 8-key groups of a tile
  constexpr int DT = D / 8;      // 8-column groups of dQ
  constexpr int CPR = D / 8;     // 16-byte chunks a row
  extern __shared__ unsigned char smem_raw[];
  __shared__ float s_delta[kRows];
  const uint32_t s_q = (smem_base(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_do = s_q + C::TILE;
  const uint32_t s_kv = s_do + C::TILE;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = qt * kRows;
  const size_t row0 = (size_t)bh * sq;
  const __nv_bfloat16* kg = k + (size_t)kvh * sk * D;
  const __nv_bfloat16* vg = v + (size_t)kvh * sk * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;   // this thread's rows
  const int qa = q0 + ra, qb = q0 + rb;
  const int q_last = min(q0 + kRows - 1, sq - 1);
  // the key tiles some row of the block can see (the forward's test)
  const int n_kt = (sk + BK - 1) / BK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  const int n_tiles = max(0, kt_hi - kt_lo);

  load_swz<D, kRows>(s_q, q + row0 * D, q0, sq);
  load_swz<D, kRows>(s_do, dout + row0 * D, q0, sq);
  cp_async_commit();
  auto load_tile = [&](int i) {
    const int k0 = (kt_lo + i) * BK;
    const uint32_t st = s_kv + (i % NS) * C::STAGE_Q;
    load_swz<D, BK>(st, kg, k0, sk);
    load_swz<D, BK>(st + C::KV_TILE, vg, k0, sk);
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // delta of the tile's rows, two threads a row, while the copies fly
  {
    const int r = tid >> 1, half = tid & 1;
    float part = 0.f;
    if (q0 + r < sq) {
      const uint4* orow =
          reinterpret_cast<const uint4*>(o + (row0 + q0 + r) * D);
      const uint4* drow =
          reinterpret_cast<const uint4*>(dout + (row0 + q0 + r) * D);
#pragma unroll
      for (int c = half; c < CPR; c += 2) part += dot8(orow[c], drow[c]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      s_delta[r] = part;
      if (q0 + r < sq) delta[row0 + q0 + r] = part;
    }
  }
  __syncthreads();
  const float del_a = s_delta[ra], del_b = s_delta[rb];
  // the rows' lse in log2 units: P = 2^(S * scale * log2 e - lse2)
  const float lse_a = qa < sq ? lse[row0 + qa] * kLog2e : 0.f;
  const float lse_b = qb < sq ? lse[row0 + qb] * kLog2e : 0.f;
  const float scale2 = scale * kLog2e;

  float acc[DT * 4];
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NS - 2>();   // Q, dO and tile i have landed (this thread's)
    fence_proxy_async();
    __syncthreads();           // ... everyone's; tile i - 1 is done
    if (i + NS - 1 < n_tiles) load_tile(i + NS - 1);
    cp_async_commit();

    const int k0 = (kt_lo + i) * BK;
    const uint32_t s_k = s_kv + (i % NS) * C::STAGE_Q;
    const uint32_t s_v = s_k + C::KV_TILE;
    float s[NT * 4], dp[NT * 4];   // the first k-step overwrites them
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks & 3) * 32;   // 16 columns = 32 bytes
      wgmma_ss<BK>(s, smem_desc(s_q + (ks >> 2) * kRows * 128 + off, 16, 1024),
                   smem_desc(s_k + (ks >> 2) * BK * 128 + off, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      wgmma_ss<BK>(dp,
                   smem_desc(s_do + (ks >> 2) * kRows * 128 + off, 16, 1024),
                   smem_desc(s_v + (ks >> 2) * BK * 128 + off, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // S is in; dP may still be running
    fence_regs(s);

    // P of the tile, the mask tests compiled in only where some element
    // is masked (diagonal, window edge, ragged Sk)
    auto probs = [&](auto masked_t) {
      constexpr bool kMasked = decltype(masked_t)::value;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[nt * 4 + e], scale2, e < 2 ? -lse_a : -lse_b));
          if constexpr (kMasked) {
            if (!keep(e < 2 ? qa : qb, k0 + nt * 8 + tq * 2 + (e & 1), sq,
                      sk, causal, window))
              p = 0.f;
          }
          s[nt * 4 + e] = p;
        }
    };
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q0 + kRows - 1 - k0 >= window);
    if (masked)
      probs(std::true_type{});
    else
      probs(std::false_type{});

    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt * 4 + e] *= dp[nt * 4 + e] - (e < 2 ? del_a : del_b);   // dS
    uint32_t dh[BK / 16][4], dl[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) split_frag<BK>(s, j, dh[j], dl[j]);
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      fence_regs(dh[j]);
      fence_regs(dl[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // keys 16j..16j+15: two 8-key groups of 1024 bytes; the 64-column
      // blocks of K lie BK * 128 bytes apart
      const uint64_t db = smem_desc(s_k + j * 2048, BK * 128, 1024);
      wgmma_rs<D>(acc, dh[j], db);
      wgmma_rs<D>(acc, dl[j], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      fence_regs(dh[j]);
      fence_regs(dl[j]);
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqg = dq + row0 * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (qa < sq)
      *reinterpret_cast<__nv_bfloat162*>(&dqg[(size_t)qa * D + col]) =
          __floats2bfloat162_rn(acc[dt * 4 + 0] * scale,
                                acc[dt * 4 + 1] * scale);
    if (qb < sq)
      *reinterpret_cast<__nv_bfloat162*>(&dqg[(size_t)qb * D + col]) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] * scale,
                                acc[dt * 4 + 3] * scale);
  }
}

// dK and dV of 64 keys of one (b, kv head), over every visible BQ-query
// tile of every query head of its GQA group in a fixed order: S^T = K.Q^T
// and dP^T = V.dO^T (K, V resident; Q, dO streaming; all K-major), P^T and
// dS^T as in bwd_dq, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T
// from registers in hi and lo halves and dO and Q MN-major.
template <int D>
__global__ void __launch_bounds__(kWg, 1)
bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ lse,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int hq, int hkv, int sq, int sk, int causal, int window,
               float scale) {
  using C = WCfg<D>;
  constexpr int BQ = C::BQ, NS = C::NS_K;
  constexpr int KS = D / 16;     // k-steps of S^T and dP^T
  constexpr int NT = BQ / 8;     // 8-query groups of a tile
  constexpr int DT = D / 8;      // 8-column groups of dK and dV
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_base(smem_raw);
  const uint32_t s_k = (raw + 1023u) & ~1023u;
  const uint32_t s_v = s_k + C::TILE;
  const uint32_t s_ring = s_v + C::TILE;
  const uint32_t s_rows = s_ring + NS * C::STAGE_K;   // [NS][lse, delta][BQ]
  const float* rows_f =
      reinterpret_cast<const float*>(smem_raw + (s_rows - raw));

  const int bkv = blockIdx.x;        // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int rep = hq / hkv;
  const int k0 = blockIdx.y * kRows;   // longest causal tiles first
  const __nv_bfloat16* kg = k + (size_t)bkv * sk * D;
  const __nv_bfloat16* vg = v + (size_t)bkv * sk * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ka = k0 + warp * 16 + g, kb = ka + 8;   // this thread's keys

  load_swz<D, kRows>(s_k, kg, k0, sk);
  load_swz<D, kRows>(s_v, vg, k0, sk);
  cp_async_commit();
  // the query tiles some key of this tile is visible from, for each head
  // of the group in turn
  const int k_last = min(k0 + kRows - 1, sk - 1);
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt_lo = causal ? k0 / BQ : 0;
  const int qt_hi =
      window > 0 ? min(n_qt, (k_last + window - 1) / BQ + 1) : n_qt;
  const int nqt = max(0, qt_hi - qt_lo);
  const int n_items = rep * nqt;
  auto load_item = [&](int i) {
    const size_t row0 = (size_t)(b * hq + kvh * rep + i / nqt) * sq;
    const int q0 = (qt_lo + i % nqt) * BQ;
    const uint32_t st = s_ring + (i % NS) * C::STAGE_K;
    load_swz<D, BQ>(st, q + row0 * D, q0, sq);
    load_swz<D, BQ>(st + C::Q_TILE, dout + row0 * D, q0, sq);
    if (tid < 2 * BQ) {   // lse for tid < BQ, then delta
      const int r = tid % BQ;
      const bool in = q0 + r < sq;
      const float* src = (tid < BQ ? lse : delta) + row0 + q0 + r;
      cp_async4(s_rows + ((i % NS) * 2 * BQ + tid) * 4, in ? src : lse,
                in ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_items) load_item(i);
    cp_async_commit();
  }

  float acc_k[DT * 4], acc_v[DT * 4];
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<NS - 2>();   // K, V and item i have landed (this thread's)
    fence_proxy_async();
    __syncthreads();           // ... everyone's; item i - 1 is done
    if (i + NS - 1 < n_items) load_item(i + NS - 1);
    cp_async_commit();

    const int q0 = (qt_lo + i % nqt) * BQ;
    const uint32_t s_qt = s_ring + (i % NS) * C::STAGE_K;
    const uint32_t s_dot = s_qt + C::Q_TILE;
    const float* lse_t = rows_f + (i % NS) * 2 * BQ;
    const float* del_t = lse_t + BQ;
    float st[NT * 4], dpt[NT * 4];   // the first k-step overwrites them
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      wgmma_ss<BQ>(st, smem_desc(s_k + (ks >> 2) * kRows * 128 + off, 16, 1024),
                   smem_desc(s_qt + (ks >> 2) * BQ * 128 + off, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      wgmma_ss<BQ>(dpt,
                   smem_desc(s_v + (ks >> 2) * kRows * 128 + off, 16, 1024),
                   smem_desc(s_dot + (ks >> 2) * BQ * 128 + off, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();   // S^T is in; dP^T may still be running
    fence_regs(st);

    // P^T: key ka (e < 2) or kb, query column q0 + 8 nt + 2 tq + (e & 1)
    auto probs = [&](auto masked_t) {
      constexpr bool kMasked = decltype(masked_t)::value;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + tq * 2 + (e & 1);
          float p = ex2(fmaf(st[nt * 4 + e], scale2, -lse_t[c] * kLog2e));
          if constexpr (kMasked) {
            if (!keep(q0 + c, e < 2 ? ka : kb, sq, sk, causal, window))
              p = 0.f;
          }
          st[nt * 4 + e] = p;
        }
    };
    const bool masked = q0 + BQ > sq || k0 + kRows > sk ||
                        (causal && k0 + kRows - 1 > q0) ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
    if (masked)
      probs(std::true_type{});
    else
      probs(std::false_type{});
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) split_frag<BQ>(st, j, ph[j], pl[j]);
    fence_regs(acc_v);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      fence_regs(ph[j]);
      fence_regs(pl[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      // queries 16j..16j+15 of the dO tile, MN-major
      const uint64_t db = smem_desc(s_dot + j * 2048, BQ * 128, 1024);
      wgmma_rs<D>(acc_v, ph[j], db);
      wgmma_rs<D>(acc_v, pl[j], db);
    }
    wgmma_commit();

    wgmma_wait<1>();   // dP^T is in; dV's wgmmas may still be running
    fence_regs(dpt);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt * 4 + e] *=
            dpt[nt * 4 + e] - del_t[nt * 8 + tq * 2 + (e & 1)];   // dS^T
    uint32_t dh[BQ / 16][4], dl[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) split_frag<BQ>(st, j, dh[j], dl[j]);
    fence_regs(acc_k);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      fence_regs(dh[j]);
      fence_regs(dl[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint64_t db = smem_desc(s_qt + j * 2048, BQ * 128, 1024);
      wgmma_rs<D>(acc_k, dh[j], db);
      wgmma_rs<D>(acc_k, dl[j], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      fence_regs(ph[j]);
      fence_regs(pl[j]);
      fence_regs(dh[j]);
      fence_regs(dl[j]);
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* dkg = dk + (size_t)bkv * sk * D;
  __nv_bfloat16* dvg = dv + (size_t)bkv * sk * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (ka < sk) {
      *reinterpret_cast<__nv_bfloat162*>(&dkg[(size_t)ka * D + col]) =
          __floats2bfloat162_rn(acc_k[dt * 4 + 0] * scale,
                                acc_k[dt * 4 + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(&dvg[(size_t)ka * D + col]) =
          __floats2bfloat162_rn(acc_v[dt * 4 + 0], acc_v[dt * 4 + 1]);
    }
    if (kb < sk) {
      *reinterpret_cast<__nv_bfloat162*>(&dkg[(size_t)kb * D + col]) =
          __floats2bfloat162_rn(acc_k[dt * 4 + 2] * scale,
                                acc_k[dt * 4 + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(&dvg[(size_t)kb * D + col]) =
          __floats2bfloat162_rn(acc_v[dt * 4 + 2], acc_v[dt * 4 + 3]);
    }
  }
}

// bwd_dkdv_wgmma's dK and dV at D 256 with two warpgroups a block (the
// header's note): WG0 computes S^T = K.Q^T, P^T, hands P^T to WG1 and
// accumulates dV += P^T.dO; WG1 computes dP^T = V.dO^T, dS^T from P^T and
// accumulates dK += dS^T.Q.  The Q and dO tiles, their lse and delta and
// the copies are shared by both.  Given `part`, one block a (b, q head, 64
// keys) walks only its head's query tiles and writes its fp32 sums to
// part ([2][b * hq][sk][D]: dV's, then dK's, unscaled) for bwd_dkdv_sum;
// else one block a (b, kv head, 64 keys) walks its whole GQA group.
template <int D>
__global__ void __launch_bounds__(2 * kWg, 1)
bwd_dkdv_wgmma2(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ lse,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                int hq, int hkv, int sq, int sk, int causal, int window,
                float scale) {
  using C = WCfg<D>;
  constexpr int BQ = C::BQ, NS = C::NS_K;
  constexpr int KS = D / 16;     // k-steps of S^T and dP^T
  constexpr int NT = BQ / 8;     // 8-query groups of a tile
  constexpr int DT = D / 8;      // 8-column groups of dK or dV
  constexpr int NTH = 2 * kWg;
  extern __shared__ unsigned char smem_raw[];
  // P^T of the current tile, WG0 -> WG1: value e of thread t at e * kWg + t
  __shared__ float s_xch[NT * 4 * kWg];
  const uint32_t raw = smem_base(smem_raw);
  const uint32_t s_k = (raw + 1023u) & ~1023u;
  const uint32_t s_v = s_k + C::TILE;
  const uint32_t s_ring = s_v + C::TILE;
  const uint32_t s_rows = s_ring + NS * C::STAGE_K;   // [NS][lse, delta][BQ]
  const float* rows_f =
      reinterpret_cast<const float*>(smem_raw + (s_rows - raw));

  const int rep = hq / hkv;
  // blockIdx.x: b * hq + q head with part, else b * hkv + kv head
  const int b = blockIdx.x / (part ? hq : hkv);
  const int kvh = part ? blockIdx.x % hq / rep : blockIdx.x % hkv;
  const int bkv = b * hkv + kvh;
  const int g0 = part ? blockIdx.x % hq % rep : 0;   // the first head
  const int heads = part ? 1 : rep;                  // of the group
  const int k0 = blockIdx.y * kRows;
  const __nv_bfloat16* kg = k + (size_t)bkv * sk * D;
  const __nv_bfloat16* vg = v + (size_t)bkv * sk * D;
  const int tid = threadIdx.x;
  const int wg = tid / kWg;          // 0: dV, 1: dK (warp-uniform)
  const int t = tid % kWg;           // the thread's place in its warpgroup
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ka = k0 + warp * 16 + g, kb = ka + 8;   // this thread's keys

  load_swz<D, kRows, NTH>(s_k, kg, k0, sk);
  load_swz<D, kRows, NTH>(s_v, vg, k0, sk);
  cp_async_commit();
  const int k_last = min(k0 + kRows - 1, sk - 1);
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt_lo = causal ? k0 / BQ : 0;
  const int qt_hi =
      window > 0 ? min(n_qt, (k_last + window - 1) / BQ + 1) : n_qt;
  const int nqt = max(0, qt_hi - qt_lo);
  const int n_items = heads * nqt;
  auto load_item = [&](int i) {
    const size_t row0 = (size_t)(b * hq + kvh * rep + g0 + i / nqt) * sq;
    const int q0 = (qt_lo + i % nqt) * BQ;
    const uint32_t st = s_ring + (i % NS) * C::STAGE_K;
    load_swz<D, BQ, NTH>(st, q + row0 * D, q0, sq);
    load_swz<D, BQ, NTH>(st + C::Q_TILE, dout + row0 * D, q0, sq);
    if (tid < 2 * BQ) {   // lse for tid < BQ, then delta
      const int r = tid % BQ;
      const bool in = q0 + r < sq;
      const float* src = (tid < BQ ? lse : delta) + row0 + q0 + r;
      cp_async4(s_rows + ((i % NS) * 2 * BQ + tid) * 4, in ? src : lse,
                in ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_items) load_item(i);
    cp_async_commit();
  }

  float acc[DT * 4];   // dV in WG0, dK in WG1
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;
  const float scale2 = scale * kLog2e;
  const uint32_t s_a = wg == 0 ? s_k : s_v;   // A of the SS product

  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<NS - 2>();   // K, V and item i have landed (this thread's)
    fence_proxy_async();
    __syncthreads();           // ... everyone's; item i - 1 is done
    if (i + NS - 1 < n_items) load_item(i + NS - 1);
    cp_async_commit();

    const int q0 = (qt_lo + i % nqt) * BQ;
    const uint32_t s_qt = s_ring + (i % NS) * C::STAGE_K;
    const uint32_t s_dot = s_qt + C::Q_TILE;
    const float* lse_t = rows_f + (i % NS) * 2 * BQ;
    const float* del_t = lse_t + BQ;
    // WG0: S^T = K.Q^T; WG1: dP^T = V.dO^T (all K-major)
    const uint32_t s_b = wg == 0 ? s_qt : s_dot;
    float st[NT * 4];   // the first k-step overwrites it
    fence_regs(st);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      wgmma_ss<BQ>(st, smem_desc(s_a + (ks >> 2) * kRows * 128 + off, 16, 1024),
                   smem_desc(s_b + (ks >> 2) * BQ * 128 + off, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);

    if (wg == 0) {
      // P^T: key ka (e < 2) or kb, query column q0 + 8 nt + 2 tq + (e & 1)
      auto probs = [&](auto masked_t) {
        constexpr bool kMasked = decltype(masked_t)::value;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + tq * 2 + (e & 1);
            float p = ex2(fmaf(st[nt * 4 + e], scale2, -lse_t[c] * kLog2e));
            if constexpr (kMasked) {
              if (!keep(q0 + c, e < 2 ? ka : kb, sq, sk, causal, window))
                p = 0.f;
            }
            st[nt * 4 + e] = p;
          }
      };
      const bool masked = q0 + BQ > sq || k0 + kRows > sk ||
                          (causal && k0 + kRows - 1 > q0) ||
                          (window > 0 && q0 + BQ - 1 - k0 >= window);
      if (masked)
        probs(std::true_type{});
      else
        probs(std::false_type{});
#pragma unroll
      for (int e = 0; e < NT * 4; ++e) s_xch[e * kWg + t] = st[e];
      bar_arrive(1, NTH);
    } else {
      bar_sync(1, NTH);        // WG0's P^T of this tile is in s_xch
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[nt * 4 + e] = s_xch[(nt * 4 + e) * kWg + t] *
                           (st[nt * 4 + e] -
                            del_t[nt * 8 + tq * 2 + (e & 1)]);   // dS^T
    }
    // WG0: dV += P^T.dO; WG1: dK += dS^T.Q (the tile MN-major)
    const uint32_t s_n = wg == 0 ? s_dot : s_qt;
    uint32_t hi[BQ / 16][4], lo[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) split_frag<BQ>(st, j, hi[j], lo[j]);
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      // queries 16j..16j+15 of the tile
      const uint64_t db = smem_desc(s_n + j * 2048, BQ * 128, 1024);
      wgmma_rs<D>(acc, hi[j], db);
      wgmma_rs<D>(acc, lo[j], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
  }
  cp_async_wait<0>();

  if (part) {
    float* pout = part + ((size_t)wg * gridDim.x + blockIdx.x) * sk * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + tq * 2;
      if (ka < sk)
        *reinterpret_cast<float2*>(&pout[(size_t)ka * D + col]) =
            make_float2(acc[dt * 4 + 0], acc[dt * 4 + 1]);
      if (kb < sk)
        *reinterpret_cast<float2*>(&pout[(size_t)kb * D + col]) =
            make_float2(acc[dt * 4 + 2], acc[dt * 4 + 3]);
    }
    return;
  }
  __nv_bfloat16* out = (wg == 0 ? dv : dk) + (size_t)bkv * sk * D;
  const float f = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (ka < sk)
      *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)ka * D + col]) =
          __floats2bfloat162_rn(acc[dt * 4 + 0] * f, acc[dt * 4 + 1] * f);
    if (kb < sk)
      *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)kb * D + col]) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] * f, acc[dt * 4 + 3] * f);
  }
}

// dV and dK of every (b, kv head, key) from bwd_dkdv_wgmma2's per-head
// fp32 sums: the group's heads added in order (deterministic), dK scaled,
// both rounded once to bf16; four columns a thread.
__global__ void __launch_bounds__(256)
bwd_dkdv_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, int b, int hq, int hkv, int sk,
             int d, float scale) {
  const int rep = hq / hkv;
  const size_t row = (size_t)sk * d;               // one head's elements
  const size_t half = (size_t)b * hq * row;        // dV's sums, then dK's
  const size_t n4 = (size_t)b * hkv * row / 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 4 * i;
    const size_t bkv = e / row, off = e % row;
    const size_t bh0 = (bkv / hkv) * hq + (bkv % hkv) * rep;
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), sk4 = sv;
    for (int g = 0; g < rep; ++g) {
      const size_t src = (bh0 + g) * row + off;
      const float4 pv = *reinterpret_cast<const float4*>(part + src);
      const float4 pk = *reinterpret_cast<const float4*>(part + half + src);
      sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
      sk4.x += pk.x; sk4.y += pk.y; sk4.z += pk.z; sk4.w += pk.w;
    }
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + e);
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + e);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
    ok[0] = __floats2bfloat162_rn(sk4.x * scale, sk4.y * scale);
    ok[1] = __floats2bfloat162_rn(sk4.z * scale, sk4.w * scale);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, void* dq, void* dk,
                 void* dv, float* delta, float* part, int b, int hq, int hkv,
                 int sq, int sk, int causal, int window, float scale,
                 cudaStream_t stream) {
  using C = WCfg<D>;
  using B = const __nv_bfloat16*;
  using O = __nv_bfloat16*;
  // D 256: two warpgroups a block (bwd_dkdv_wgmma2), else one
  constexpr bool kPair = D == 256;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM_DQ));
    if (e != cudaSuccess) return static_cast<int>(e);
    if constexpr (kPair)
      e = cudaFuncSetAttribute(bwd_dkdv_wgmma2<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM_DKDV));
    else
      e = cudaFuncSetAttribute(bwd_dkdv_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM_DKDV));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_qt = (sq + kRows - 1) / kRows, n_kt = (sk + kRows - 1) / kRows;
  if (n_qt > 65535 || n_kt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd_dq_wgmma<D><<<dim3(b * hq, n_qt), kWg, C::SMEM_DQ, stream>>>(
      static_cast<B>(q), static_cast<B>(k), static_cast<B>(v),
      static_cast<B>(o), lse, static_cast<B>(dout), static_cast<O>(dq),
      delta, hq, hkv, sq, sk, causal, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sk <= 0) return 0;
  if constexpr (kPair) {
    // with part: a block per query head, then the group's sum
    bwd_dkdv_wgmma2<D><<<dim3(b * (part ? hq : hkv), n_kt), 2 * kWg,
                         C::SMEM_DKDV, stream>>>(
        static_cast<B>(q), static_cast<B>(k), static_cast<B>(v), lse,
        static_cast<B>(dout), delta, static_cast<O>(dk), static_cast<O>(dv),
        part, hq, hkv, sq, sk, causal, window, scale);
    if (part == nullptr) return static_cast<int>(cudaGetLastError());
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t n4 = (size_t)b * hkv * sk * D / 4;
    const size_t want = (n4 + 255) / 256;
    const int blocks = want < 4096 ? static_cast<int>(want) : 4096;
    bwd_dkdv_sum<<<blocks, 256, 0, stream>>>(part, static_cast<O>(dk),
                                             static_cast<O>(dv), b, hq, hkv,
                                             sk, D, scale);
  } else {
    if (part != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    bwd_dkdv_wgmma<D><<<dim3(b * hkv, n_kt), kWg, C::SMEM_DKDV, stream>>>(
        static_cast<B>(q), static_cast<B>(k), static_cast<B>(v), lse,
        static_cast<B>(dout), delta, static_cast<O>(dk), static_cast<O>(dv),
        hq, hkv, sq, sk, causal, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 64, 128 or 256; window <= 0 =
// global; sk != sq only for a non-causal, unwindowed call.
// q, o, dout, dq: [b*hq, sq, d]; k, v, dk, dv: [b*hkv, sk, d]; lse (the
// forward's) and delta (scratch, written here): [b*hq, sq] fp32; all
// contiguous.  part: null, or (bf16 at d 256 only) fp32 scratch of
// [2, b*hq, sk, d], which splits dK and dV's blocks over the query heads
// of each GQA group and adds the heads' sums in a second kernel.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* part, int b, int hq, int hkv, int sq, int sk, int d,
    int causal, int window, float scale, int dtype, void* stream) {
  if (b * hq <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sk < 0 || b * hq > 65535 ||
      (sk != sq && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (part != nullptr && (dtype != 1 || d != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
#define FLASH_BWD(T_, D)                                                    \
  return launch<T_, D>(q, k, v, o, l, dout, dq, dk, dv, dl, b, hq, hkv, sq, \
                       sk, causal, window, scale, st)
  if (dtype == 0 && d == 64) FLASH_BWD(float, 64);
  if (dtype == 0 && d == 128) FLASH_BWD(float, 128);
  if (dtype == 0 && d == 256) FLASH_BWD(float, 256);
#undef FLASH_BWD
  if (dtype == 1 && d == 64)
    return launch_wgmma<64>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, b, hq,
                            hkv, sq, sk, causal, window, scale, st);
  if (dtype == 1 && d == 128)
    return launch_wgmma<128>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, b, hq,
                             hkv, sq, sk, causal, window, scale, st);
  if (dtype == 1 && d == 256)
    return launch_wgmma<256>(q, k, v, o, l, dout, dq, dk, dv, dl, pt, b, hq,
                             hkv, sq, sk, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
