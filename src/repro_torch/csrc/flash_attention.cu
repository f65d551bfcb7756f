// Causal / sliding-window attention with an online softmax, fp32
// accumulation, for bf16 or fp32 q/k/v of head_dim 64, 128 or 256.
//
// Replaces the flash_attention TPU kernel: src/repro/kernels/
// flash_attention/kernel.py, _flash_kernel / flash_attention_call (wrapper
// ops.py).  There the grid is (BH, q-blocks, k-blocks) with the k sweep as
// the sequential minor dimension and the running max, sum and accumulator
// in VMEM scratch.  Here one thread block owns one (bh, 64-row q tile) and
// loops over 64-key tiles itself, keeping the running max m, sum l and the
// fp32 accumulator in registers.  Tiles that no query row of the block can
// see are never visited, by the reference's test (k_start <= q_end for
// causal, k_end > q_start - window for a window).  Semantics are the
// reference's: masked logits are -1e30, masked probabilities are zeroed,
// the output is acc / max(l, 1e-30), so a fully masked row gives 0.  GQA
// maps query head h to kv head h / (Hq / Hkv); keys past S are masked
// here, so S needs no padding.  A non-causal, unwindowed call may have Sk
// keys for Sq queries (whisper's cross attention: Sq decoder tokens over
// Sk = 1,500 encoder frames); causal and windowed calls have Sk = Sq.
// Given an lse pointer, each row's fp32 log-sum-exp m + log(max(l,
// 1e-30)) (natural log, scaled logits) goes to lse[bh * Sq + qi]: the
// backward kernel (flash_attention_bwd.cu) recomputes P from it.
//
// Bound on the H100: at the serving shapes (S of a few hundred) the bytes
// of q, k, v and o (memory); from S of a few thousand the 2*S^2*D
// operations per head (tensor-core rate for bf16).  Two kernels, chosen by
// dtype:
//
// * bf16 (flash_fwd_wgmma): one warpgroup per 64 query rows runs Q.K^T as
//   wgmma m64n64k16 from shared memory and P.V as wgmma with P from
//   registers and V through the descriptor's transpose, so no element-wise
//   transpose and no fragment loads.  The reference multiplies fp32
//   probabilities by V, so P is split into two bf16 halves and P.V is two
//   wgmmas per 16 keys: that split makes P.V's tensor work twice Q.K^T's,
//   which only wgmma's rate leaves room for.  K and V tiles arrive through
//   a ring of cp.async 16-byte copies written straight into the 128-byte
//   XOR swizzle the wgmma descriptors name; each thread fences its copies
//   into the async proxy (fence.proxy.async) before the barrier that
//   precedes the wgmmas.  At D 64 the ring has two stages (tile t+1 in
//   flight while t is computed) so that four blocks of 128 registers share
//   an SM; at D 128, three (tiles t+1 and t+2), two blocks.  At D 256
//   (gemma3) P.V is one m64n256k16 wgmma whose accumulator is 128 fp32
//   registers a thread; with 64-key tiles the 32 scores and P's 32
//   A-fragment registers on top spilled 332 bytes at the 255 registers
//   that __launch_bounds__(128, 1) allows, so D 256 takes 32-key tiles
//   (Q.K^T as m64n32k16) through four stages of 32 KB beside Q's 32 KB,
//   one block an SM.  The grid is
//   (bh, q tile) with the q tiles in reverse order on blockIdx.y, so the
//   longest causal rows start first and the short ones fill in behind;
//   64-row blocks keep 96 blocks at zamba2's serving prefill (S 189, 32
//   heads) where 128-row blocks would give 64.  The softmax runs in the
//   exp2 domain (scale * log2 e folded into the logits, ex2.approx.ftz),
//   which changes nothing beyond fp32 rounding, and compiles its mask tests
//   only into the tiles that need them.  What still separates it from its
//   bound: each warpgroup waits for its own wgmmas, so the tensor cores
//   idle during a block's softmax unless a co-resident block fills them
//   (overlapping the next tile's Q.K^T with the softmax inside a block
//   took a second score set, 250 registers at D 128, and measured slower),
//   and the softmax and the P split run on the CUDA cores, ~12
//   instructions per score.
// * fp32 (flash_fwd): both products on the CUDA cores in fp32 (4 threads
//   per query row: each scores a quarter of the tile's keys and
//   accumulates a quarter of the output columns), which the reference's
//   fp32 tolerance needs; no bf16 or TF32 operand meets it.  At D 256 its
//   q/k/v/p tiles take 217,088 bytes: one block an SM.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 4 threads per query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 4) + 2 * kBK * (D + 4) +
                                  kBQ * (kBK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int hq, int hkv, int s, int s_k, int causal, int window,
          float scale) {
  constexpr int LD = D + 4;      // padded row stride of the q/k/v tiles
  constexpr int LP = kBK + 4;    // padded row stride of the probability tile
  constexpr int KPT = kBK / 4;   // keys scored per thread in a tile
  constexpr int C4 = D / 16;     // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // [kBQ][LD]
  float* sk = sq + kBQ * LD;     // [kBK][LD]
  float* sv = sk + kBK * LD;     // [kBK][LD]
  float* sp = sv + kBK * LD;     // [kBQ][LP]

  const int bh = blockIdx.y;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* qg = q + (size_t)bh * s * D;
  const T* kg = k + (size_t)kvh * s_k * D;
  const T* vg = v + (size_t)kvh * s_k * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;        // this thread's query row in the tile
  const int quad = tid & 3;      // its quarter of the keys and columns
  const int qi = q0 + r;
  const int q_last = min(q0 + kBQ - 1, s - 1);

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    sq[row * LD + col] =
        (q0 + row < s) ? to_f(qg[(size_t)(q0 + row) * D + col]) : 0.f;
  }
  float acc[4 * C4];
#pragma unroll
  for (int c = 0; c < 4 * C4; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_kt = (s_k + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q_last) break;                        // above diagonal
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue; // out of window
    __syncthreads();  // the previous tile's reads of sk/sv are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int row = idx / D, col = idx % D;
      const bool in = k0 + row < s_k;
      const size_t off = (size_t)(k0 + row) * D + col;
      sk[row * LD + col] = in ? to_f(kg[off]) : 0.f;
      sv[row * LD + col] = in ? to_f(vg[off]) : 0.f;
    }
    __syncthreads();

    float sc[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&sq[r * LD + d]);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&sk[(quad + 4 * i) * LD + d]);
        sc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    unsigned ok = 0;
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kj = k0 + quad + 4 * i;
      const bool keep = kj < s_k && (!causal || kj <= qi) &&
                        (window <= 0 || qi - kj < window);
      ok |= (unsigned)keep << i;
      sc[i] = keep ? sc[i] * scale : kNegInf;
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = ((ok >> i) & 1u) ? expf(sc[i] - m_new) : 0.f;
      sp[r * LP + quad + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < 4 * C4; ++c) acc[c] *= alpha;
    __syncwarp();  // row r of sp is written and read by one quad of a warp
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float pj = sp[r * LP + j];
#pragma unroll
      for (int c4 = 0; c4 < C4; ++c4) {
        const float4 vv = *reinterpret_cast<const float4*>(
            &sv[j * LD + quad * 4 + 16 * c4]);
        acc[4 * c4 + 0] += pj * vv.x;
        acc[4 * c4 + 1] += pj * vv.y;
        acc[4 * c4 + 2] += pj * vv.z;
        acc[4 * c4 + 3] += pj * vv.w;
      }
    }
    __syncwarp();  // sp row r is rewritten by the next tile
  }

  if (qi < s) {
    const float den = fmaxf(l, 1e-30f);
    T* og = o + (size_t)bh * s * D + (size_t)qi * D;
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&og[quad * 4 + 16 * c4 + e], acc[4 * c4 + e] / den);
    if (lse != nullptr && quad == 0)
      lse[(size_t)bh * s + qi] = m + logf(den);
  }
}

constexpr int kWgThreads = 128;   // one warpgroup: 64 query rows

template <int D>
struct WCfg {
  // keys per tile: 64, but 32 at D 256, where 64 keys' scores and P
  // fragments on top of the 128 accumulators spilled 332 bytes at 255
  // registers
  static constexpr int BK = D == 256 ? 32 : kBK;
  // K/V ring depth and blocks per SM: at D 64, two stages (41 KB) let four
  // blocks of <= 128 registers share an SM; at D 128, three (113 KB), two;
  // at D 256, four stages of 32 KB (161 KB), one
  static constexpr int NS = D == 64 ? 2 : D == 128 ? 3 : 4;
  static constexpr int MIN_BLOCKS = D == 64 ? 4 : D == 128 ? 2 : 1;
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int T_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int STAGE = 2 * T_BYTES;       // K tile then V tile
  // + 1024 to align the tiles to the swizzle's 1024-byte period
  static constexpr size_t SMEM = 1024 + Q_BYTES + NS * STAGE;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// bf16 inputs: Q.K^T and P.V on the tensor cores with wgmma (fp32
// accumulators).  One warpgroup owns 64 query rows; warp w of it holds rows
// 16w..16w+15 of every accumulator, and a thread the same elements as in an
// mma.sync C fragment, repeated across N: per 8-key group the scores of
// rows g and g + 8 and keys 2t, 2t + 1, which is also P's A fragment for
// the P.V wgmma, so P goes from the score registers to the tensor cores
// without shared memory.  Q.K^T reads Q and K from shared memory (both
// K-major); P.V reads V through the descriptor's transpose (MN-major B).
// K and V tiles arrive through an NS-stage ring of cp.async copies made by
// the same threads, NS - 1 tiles ahead of the one being computed.
template <int D>
__global__ void __launch_bounds__(kWgThreads, WCfg<D>::MIN_BLOCKS)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int hq, int hkv, int s, int s_k, int causal, int window,
                float scale2) {
  using C = WCfg<D>;
  constexpr int NS = C::NS;
  constexpr int BK = C::BK;
  constexpr int KS = D / 16;     // k-steps of Q.K^T
  constexpr int NT = BK / 8;    // 8-key groups of a tile
  constexpr int DT = D / 8;      // 8-column groups of the output
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_base(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + C::Q_BYTES;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qg = q + (size_t)bh * s * D;
  const __nv_bfloat16* kg = k + (size_t)kvh * s_k * D;
  const __nv_bfloat16* vg = v + (size_t)kvh * s_k * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qa = q0 + warp * 16 + g, qb = qa + 8;  // this thread's rows
  const int q_last = min(q0 + kBQ - 1, s - 1);
  // the key tiles some row of the block can see (the reference's test)
  const int n_kt = (s_k + BK - 1) / BK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  const int n_tiles = max(0, kt_hi - kt_lo);

  load_swz<D, kBQ>(sq, qg, q0, s);
  cp_async_commit();
  auto load_tile = [&](int i) {
    const int k0 = (kt_lo + i) * BK;
    const uint32_t base = skv + (i % NS) * C::STAGE;
    load_swz<D, BK>(base, kg, k0, s_k);
    load_swz<D, BK>(base + C::T_BYTES, vg, k0, s_k);
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  float acc[DT * 4];
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NS - 2>();   // Q and tile i have landed (this thread's)
    fence_proxy_async();
    __syncthreads();                // ... everyone's; tile i - 1 is done
    if (i + NS - 1 < n_tiles) load_tile(i + NS - 1);
    cp_async_commit();

    const int k0 = (kt_lo + i) * BK;
    const uint32_t sk = skv + (i % NS) * C::STAGE;
    const uint32_t sv = sk + C::T_BYTES;
    float sc[NT * 4];   // the first k-step overwrites it (scale_d 0)
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks & 3) * 32;   // 16 columns = 32 bytes
      wgmma_ss<BK>(sc,
                   smem_desc(sq + (ks >> 2) * kBQ * 128 + off, 16, 1024),
                   smem_desc(sk + (ks >> 2) * BK * 128 + off, 16, 1024),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    float mn_a, mn_b, sum_a = 0.f, sum_b = 0.f;
    // the softmax of the tile, with the mask tests compiled in only for
    // tiles where some element is masked (diagonal, window edge, ragged S)
    auto softmax = [&](auto masked_t) {
      constexpr bool kMasked = decltype(masked_t)::value;
      unsigned ok = 0xffffffffu;  // bit 4*nt + e: row g (e < 2) or g + 8
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& xa = sc[nt * 4 + e];
          float& xb = sc[nt * 4 + 2 + e];
          xa *= scale2;
          xb *= scale2;
          if constexpr (kMasked) {
            const int kj = k0 + nt * 8 + tq * 2 + e;
            const bool keep_a = kj < s_k && (!causal || kj <= qa) &&
                                (window <= 0 || qa - kj < window);
            const bool keep_b = kj < s_k && (!causal || kj <= qb) &&
                                (window <= 0 || qb - kj < window);
            if (!keep_a) {
              xa = kNegInf;
              ok &= ~(1u << (4 * nt + e));
            }
            if (!keep_b) {
              xb = kNegInf;
              ok &= ~(1u << (4 * nt + 2 + e));
            }
          }
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      mn_a = fmaxf(m_a, mx_a);
      mn_b = fmaxf(m_b, mx_b);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(sc[nt * 4 + e] - (e < 2 ? mn_a : mn_b));
          if constexpr (kMasked)
            p = ((ok >> (4 * nt + e)) & 1u) ? p : 0.f;
          sc[nt * 4 + e] = p;
          if (e < 2) sum_a += p; else sum_b += p;
        }
    };
    const bool masked = k0 + BK > s_k || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - k0 >= window);
    if (masked)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    l_a = al_a * l_a + sum_a;
    l_b = al_b * l_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt * 4 + 0] *= al_a;
      acc[dt * 4 + 1] *= al_a;
      acc[dt * 4 + 2] *= al_b;
      acc[dt * 4 + 3] *= al_b;
    }
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) split_frag<BK>(sc, j, ph[j], pl[j]);
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      fence_regs(ph[j]);
      fence_regs(pl[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // keys 16j..16j+15: two 8-key groups of 1024 bytes; the 64-column
      // blocks of V lie BK * 128 bytes apart
      const uint64_t db = smem_desc(sv + j * 2048, BK * 128, 1024);
      wgmma_rs<D>(acc, ph[j], db);
      wgmma_rs<D>(acc, pl[j], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      fence_regs(ph[j]);
      fence_regs(pl[j]);
    }
  }
  cp_async_wait<0>();

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* og = o + (size_t)bh * s * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (qa < s)
      *reinterpret_cast<__nv_bfloat162*>(&og[(size_t)qa * D + col]) =
          __floats2bfloat162_rn(acc[dt * 4 + 0] / den_a,
                                acc[dt * 4 + 1] / den_a);
    if (qb < s)
      *reinterpret_cast<__nv_bfloat162*>(&og[(size_t)qb * D + col]) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] / den_b,
                                acc[dt * 4 + 3] / den_b);
  }
  // the row's log-sum-exp in natural units: m and l live in the exp2
  // domain of the scaled logits
  if (lse != nullptr && tq == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    if (qa < s) lse[(size_t)bh * s + qa] = (m_a + log2f(den_a)) * kLn2;
    if (qb < s) lse[(size_t)bh * s + qb] = (m_b + log2f(den_b)) * kLn2;
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int hq, int hkv, int s, int sk, int causal,
                 int window, float scale, cudaStream_t stream) {
  using C = WCfg<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_qt = (s + kBQ - 1) / kBQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(b * hq, n_qt);
  // exp(x * scale - m) computed as exp2(x * scale * log2(e) - m')
  flash_fwd_wgmma<D><<<grid, kWgThreads, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, hq, hkv, s, sk, causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int hq, int hkv, int s, int sk, int causal, int window,
           float scale, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = smem_bytes<D>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((s + kBQ - 1) / kBQ, b * hq);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, hq, hkv, s, sk,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 64, 128 or 256; window <= 0 =
// global; sk != sq only for a non-causal, unwindowed call.
// q: [b*hq, sq, d], k/v: [b*hkv, sk, d], o: [b*hq, sq, d], all contiguous;
// lse: null, or [b*hq, sq] fp32 for the rows' log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int hq, int hkv, int sq, int sk,
                                      int d, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (sq <= 0 || b * hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sk < 0 || (dtype == 0 && b * hq > 65535) ||
      (sk != sq && (causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, l, b, hq, hkv, sq, sk, causal,
                             window, scale, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, l, b, hq, hkv, sq, sk, causal,
                              window, scale, st);
  if (dtype == 0 && d == 256)
    return launch<float, 256>(q, k, v, o, l, b, hq, hkv, sq, sk, causal,
                              window, scale, st);
  if (dtype == 1 && d == 64)
    return launch_wgmma<64>(q, k, v, o, l, b, hq, hkv, sq, sk, causal,
                            window, scale, st);
  if (dtype == 1 && d == 128)
    return launch_wgmma<128>(q, k, v, o, l, b, hq, hkv, sq, sk, causal,
                             window, scale, st);
  if (dtype == 1 && d == 256)
    return launch_wgmma<256>(q, k, v, o, l, b, hq, hkv, sq, sk, causal,
                             window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
