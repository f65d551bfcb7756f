// Causal / sliding-window attention with an online softmax, fp32
// accumulation, for bf16 or fp32 q/k/v of head_dim 64 or 128.
//
// Replaces the flash_attention TPU kernel: src/repro/kernels/
// flash_attention/kernel.py, _flash_kernel / flash_attention_call (wrapper
// ops.py).  There the grid is (BH, q-blocks, k-blocks) with the k sweep as
// the sequential minor dimension and the running max, sum and accumulator
// in VMEM scratch.  Here one thread block owns one (bh, 64-row q tile) and
// loops over 64-key tiles itself, keeping the running max m, sum l and the
// fp32 accumulator in registers.  Tiles that no query row of the block can
// see are skipped with the reference's test (k_start <= q_end for causal,
// k_end > q_start - window for a window).  Semantics are the reference's:
// masked logits are -1e30, masked probabilities are zeroed, the output is
// acc / max(l, 1e-30), so a fully masked row gives 0.  GQA maps query head
// h to kv head h / (Hq / Hkv); keys past S are masked here, so S needs no
// padding.
//
// Bound on the H100: at the serving shapes (S of a few hundred) the bytes of
// q, k, v and o (memory); from S of a few thousand the 2*S^2*D operations
// per head (tensor-core rate for bf16).  Two kernels, chosen by dtype:
// bf16 inputs run both products on the tensor cores (mma.sync, fp32
// accumulators; P is split into two bf16 halves so that P.V keeps the
// reference's fp32 probabilities); fp32 inputs run them on the CUDA cores
// in fp32 (4 threads per query row: each scores a quarter of the tile's
// keys and accumulates a quarter of the output columns), which the
// reference's fp32 tolerance needs.  Neither pipelines its loads (no
// cp.async/TMA) or uses wgmma yet.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 4 threads per query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 4) + 2 * kBK * (D + 4) +
                                  kBQ * (kBK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
          int s, int causal, int window, float scale) {
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
  const T* kg = k + (size_t)kvh * s * D;
  const T* vg = v + (size_t)kvh * s * D;
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

  const int n_kt = (s + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q_last) break;                        // above diagonal
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue; // out of window
    __syncthreads();  // the previous tile's reads of sk/sv are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int row = idx / D, col = idx % D;
      const bool in = k0 + row < s;
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
      const bool keep = kj < s && (!causal || kj <= qi) &&
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
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p ~= hi + lo with both halves in bf16: ~16 significant bits, so the P.V
// products keep the fp32 probabilities of the reference to ~1e-5.
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h)));
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMmaThreads = 128;  // 4 warps, 16 query rows each

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (size_t)(kBQ * (D + 8) + kBK * (D + 8) + D * (kBK + 8));
}

// bf16 inputs: Q.K^T and P.V on the tensor cores (mma.sync m16n8k16, fp32
// accumulators).  Each warp owns 16 query rows of the block's 64; a thread
// holds, per 8-key tile, the scores of two rows (g and g + 8) and two keys,
// which is also the A-fragment layout of P for the P.V product, so P never
// leaves registers.  V is stored transposed in shared memory so that its
// B fragments are 32-bit loads.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int hq, int hkv, int s,
              int causal, int window, float scale) {
  constexpr int LDK = D + 8;    // bf16 row stride of the Q and K tiles
  constexpr int LDV = kBK + 8;  // bf16 row stride of the transposed V tile
  constexpr int KS = D / 16;    // k-steps of Q.K^T
  constexpr int NT = kBK / 8;   // 8-key tiles per 64-key tile
  constexpr int DT = D / 8;     // 8-column tiles of the output
  constexpr int C8 = D / 8;     // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBQ * LDK;   // [kBK][LDK]
  __nv_bfloat16* svt = sk + kBK * LDK;  // [D][LDV]

  const int bh = blockIdx.y;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* qg = q + (size_t)bh * s * D;
  const __nv_bfloat16* kg = k + (size_t)kvh * s * D;
  const __nv_bfloat16* vg = v + (size_t)kvh * s * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int qa = q0 + r0 + g, qb = qa + 8;  // this thread's two query rows
  const int q_last = min(q0 + kBQ - 1, s - 1);

  for (int idx = tid; idx < kBQ * C8; idx += kMmaThreads) {
    const int row = idx / C8, c = (idx % C8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + row < s)
      val = *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + row) * D + c);
    *reinterpret_cast<uint4*>(&sq[row * LDK + c]) = val;
  }
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* base = &sq[(r0 + g) * LDK + ks * 16 + tq * 2];
    qf[ks][0] = ld32(base);
    qf[ks][1] = ld32(base + 8 * LDK);
    qf[ks][2] = ld32(base + 8);
    qf[ks][3] = ld32(base + 8 * LDK + 8);
  }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  const int n_kt = (s + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q_last) break;                        // above diagonal
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue; // out of window
    __syncthreads();  // the previous tile's reads of sk/svt are done
    for (int idx = tid; idx < kBK * C8; idx += kMmaThreads) {
      const int row = idx / C8, c = (idx % C8) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + row < s) {
        const size_t off = (size_t)(k0 + row) * D + c;
        kv = *reinterpret_cast<const uint4*>(kg + off);
        vv = *reinterpret_cast<const uint4*>(vg + off);
      }
      *reinterpret_cast<uint4*>(&sk[row * LDK + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) svt[(c + e) * LDV + row] = ve[e];
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kb = &sk[(nt * 8 + g) * LDK + ks * 16 + tq * 2];
        mma_bf16(sc[nt], qf[ks], ld32(kb), ld32(kb + 8));
      }
    }
    unsigned ok = 0;  // bit 4*nt + e: row g (e < 2) or g + 8 (e >= 2)
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + nt * 8 + tq * 2 + e;
        const bool keep_a = kj < s && (!causal || kj <= qa) &&
                            (window <= 0 || qa - kj < window);
        const bool keep_b = kj < s && (!causal || kj <= qb) &&
                            (window <= 0 || qb - kj < window);
        ok |= ((unsigned)keep_a << (4 * nt + e)) |
              ((unsigned)keep_b << (4 * nt + 2 + e));
        sc[nt][e] = keep_a ? sc[nt][e] * scale : kNegInf;
        sc[nt][2 + e] = keep_b ? sc[nt][2 + e] * scale : kNegInf;
        mx_a = fmaxf(mx_a, sc[nt][e]);
        mx_b = fmaxf(mx_b, sc[nt][2 + e]);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_a : mn_b;
        const float p = ((ok >> (4 * nt + e)) & 1u) ? expf(sc[nt][e] - mn)
                                                   : 0.f;
        sc[nt][e] = p;
        if (e < 2) sum_a += p; else sum_b += p;
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    l_a = al_a * l_a + sum_a;
    l_b = al_b * l_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= al_a;
      acc[dt][1] *= al_a;
      acc[dt][2] *= al_b;
      acc[dt][3] *= al_b;
    }
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t ph[4], pl[4];
      split(sc[2 * j][0], sc[2 * j][1], ph[0], pl[0]);
      split(sc[2 * j][2], sc[2 * j][3], ph[1], pl[1]);
      split(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pl[2]);
      split(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vb = &svt[(dt * 8 + g) * LDV + j * 16 + tq * 2];
        const uint32_t b0 = ld32(vb), b1 = ld32(vb + 8);
        mma_bf16(acc[dt], ph, b0, b1);
        mma_bf16(acc[dt], pl, b0, b1);
      }
    }
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* og = o + (size_t)bh * s * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (qa < s)
      *reinterpret_cast<__nv_bfloat162*>(&og[(size_t)qa * D + col]) =
          __floats2bfloat162_rn(acc[dt][0] / den_a, acc[dt][1] / den_a);
    if (qb < s)
      *reinterpret_cast<__nv_bfloat162*>(&og[(size_t)qb * D + col]) =
          __floats2bfloat162_rn(acc[dt][2] / den_b, acc[dt][3] / den_b);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int s, int causal, int window, float scale,
               cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = mma_smem_bytes<D>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((s + kBQ - 1) / kBQ, b * hq);
  flash_fwd_mma<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq, hkv, s, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int causal, int window, float scale,
           cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128; window <= 0 = global.
// q: [b*hq, s, d], k/v: [b*hkv, s, d], o: [b*hq, s, d], all contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int s, int d, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (s <= 0 || b * hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, b, hq, hkv, s, causal, window,
                             scale, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, b, hq, hkv, s, causal, window,
                              scale, st);
  if (dtype == 1 && d == 64)
    return launch_mma<64>(q, k, v, o, b, hq, hkv, s, causal, window, scale,
                          st);
  if (dtype == 1 && d == 128)
    return launch_mma<128>(q, k, v, o, b, hq, hkv, s, causal, window, scale,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
