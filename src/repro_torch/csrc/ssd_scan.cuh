// Shared by the Mamba2 SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): the chunk size, strided tile loads, the chunk's
// decays, the tensor-core products of the per-chunk passes (mma.sync
// fragments, fp32 operands split into bf16 parts), a chunk's own [N, P]
// state as sum_j B_j w_j x_j^T (own_state), and the sequential pass that
// carries [N, P] matrices across the chunks (carry_states), forward for
// the states, in reverse for their adjoint.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQ = 64;             // steps per chunk
constexpr int kThreads = 128;      // 4 warps; warp w owns rows 16w..16w+15
constexpr int kStateThreads = 256;
constexpr int kStateDepth = 8;     // chunks a state-pass thread loads at once
constexpr size_t kMaxSmem = 232448;

struct Strides {  // in elements; the innermost dimension is contiguous
  int64_t b, l, h;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// B fragments of the two 8-column tiles n0 and n0 + 8, k rows k0..k0+15,
// of a row-major [k][ld] bf16 tile in shared memory, by one ldmatrix.trans:
// {b[0], b[1]} for tile n0, {b[2], b[3]} for tile n0 + 8.
__device__ __forceinline__ void ld_b_pair(const __nv_bfloat16* tile, int ld,
                                          int k0, int n0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row =
      tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8;
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(at)
      : "memory");
}
// v ~= hi + lo with both halves in bf16: ~16 significant bits.
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));
}
// v ~= hi + mid + lo, all three in bf16: ~24 significant bits.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = pack(h);
  mid = pack(m);
  lo = pack(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}
// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col).  A: a[0]
// rows g, k 2q..2q+1; a[1] rows g + 8; a[2], a[3] the same at k + 8.  B:
// b0 k 2q..2q+1, b1 k + 8, column g.  D: d[0..1] row g, columns 2q..2q+1;
// d[2..3] row g + 8 (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of chunk_out and the backward's bwd_out: warp w owns rows
// ra = 16w + lane/4 and ra + 8 of the chunk, a [16, 64] accumulator set
// acc[nt][4] holds their 8-column tiles nt (mma's D layout).

// A fragment (16 x 16) of rows ra, ra + 8 and k0..k0+15 of a row-major
// bf16 tile.
__device__ __forceinline__ void ld_a(const bf16* tile, int ld, int ra,
                                     int k0, uint32_t (&a)[4]) {
  const bf16* p = tile + ra * ld + k0 + 2 * (threadIdx.x & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// acc[nt] += (rows ra, ra + 8 of `a`) . (rows nt*8..nt*8+7 of `b`)^T over
// k < kdim, for the 8-column tiles lo <= nt < hi; both tiles row-major
// bf16 with k along a row.
__device__ __forceinline__ void band(float (&acc)[kQ / 8][4], const bf16* a,
                                     int lda, const bf16* b, int ldb,
                                     int kdim, int ra, int lo, int hi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int ks = 0; ks < kdim / 16; ++ks) {  // 8 independent accumulators
    uint32_t af[4];
    ld_a(a, lda, ra, ks * 16, af);
#pragma unroll
    for (int nt = 0; nt < kQ / 8; ++nt)
      if (nt >= lo && nt < hi) {
        const bf16* bb = b + (nt * 8 + g) * ldb + ks * 16 + 2 * q;
        mma(acc[nt], af, ld32(bb), ld32(bb + 8));
      }
  }
}

// An fp32 accumulator set as A fragments (k = its 64 columns) in bf16 hi
// and lo parts.
__device__ __forceinline__ void to_a_split(const float (&acc)[kQ / 8][4],
                                           uint32_t (&hi)[kQ / 16][4],
                                           uint32_t (&lo)[kQ / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    split(acc[2 * kk][0], acc[2 * kk][1], hi[kk][0], lo[kk][0]);
    split(acc[2 * kk][2], acc[2 * kk][3], hi[kk][1], lo[kk][1]);
    split(acc[2 * kk + 1][0], acc[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split(acc[2 * kk + 1][2], acc[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// dh[u] += hi . B and dl[u] += lo . B over the k-tiles kk0 <= kk < kk1,
// B = rows kk*16.. of the row-major bf16 tile `b` (k along its rows),
// columns n0 + 8u..n0 + 8u + 7.
__device__ __forceinline__ void split_product(
    float (&dh)[2][4], float (&dl)[2][4], const uint32_t (&hi)[kQ / 16][4],
    const uint32_t (&lo)[kQ / 16][4], const bf16* b, int ldb, int n0,
    int kk0, int kk1) {
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    if (kk < kk0 || kk >= kk1) continue;
    uint32_t bb[4];
    ld_b_pair(b, ldb, kk * 16, n0, bb);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mma(dh[u], hi[kk], bb[2 * u], bb[2 * u + 1]);
      mma(dl[u], lo[kk], bb[2 * u], bb[2 * u + 1]);
    }
  }
}

// dh[u] += A . Sh and dl[u] += A . Sl over k < kdim: A rows ra, ra + 8 of
// the bf16 tile `a`, Sh and Sl a state's hi and lo planes [k][lds],
// columns n0 + 8u..n0 + 8u + 7 (C . S_in, B . G_out).
__device__ __forceinline__ void planes_product(float (&dh)[2][4],
                                               float (&dl)[2][4],
                                               const bf16* a, int lda,
                                               const bf16* sh,
                                               const bf16* sl, int lds,
                                               int kdim, int ra, int n0) {
#pragma unroll 4
  for (int ks = 0; ks < kdim / 16; ++ks) {
    uint32_t af[4], bh[4], bl[4];
    ld_a(a, lda, ra, ks * 16, af);
    ld_b_pair(sh, lds, ks * 16, n0, bh);
    ld_b_pair(sl, lds, ks * 16, n0, bl);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mma(dh[u], af, bh[2 * u], bh[2 * u + 1]);
      mma(dl[u], af, bl[2 * u], bl[2 * u + 1]);
    }
  }
}

// Rows [0, rows) of a `tile_rows`-row tile (kQ by default) of `cols`
// elements into shared memory (row stride ld) by cp.async; rows past
// `rows` are zero-filled unread.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t row_stride, int rows,
                                          int cols, int tile_rows = kQ) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = cols / E;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < tile_rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * E;
    const bool in = r < rows;
    cp_async16(base + static_cast<uint32_t>((r * ld + c) * sizeof(T)),
               in ? src + r * row_stride + c : src, in ? 16 : 0);
  }
}

// dt of steps 2l and 2l + 1 of the chunk for lane l of warp 0 (0 past
// its rows), loaded early so the load overlaps the others in flight.
__device__ __forceinline__ float2 load_dt(const float* dt, const Strides& sd,
                                          int b, int h, int t0, int rows) {
  float2 v = make_float2(0.f, 0.f);
  const int i0 = 2 * threadIdx.x;
  if (threadIdx.x < 32) {
    const float* dtp = dt + b * sd.b + h * sd.h;
    if (i0 < rows) v.x = dtp[(int64_t)(t0 + i0) * sd.l];
    if (i0 + 1 < rows) v.y = dtp[(int64_t)(t0 + i0 + 1) * sd.l];
  }
  return v;
}

// dt into shared memory and a_cs = a * inclusive cumsum(dt), by warp 0
// from load_dt's values; ends in a barrier.
__device__ __forceinline__ void chunk_decay(float av, float2 v, float* dts,
                                            float* acs) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float run = v.x + v.y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, run, off);
      if (tid >= off) run += o;
    }
    float before = __shfl_up_sync(0xffffffffu, run, 1);
    if (tid == 0) before = 0.f;
    dts[2 * tid] = v.x;
    dts[2 * tid + 1] = v.y;
    acs[2 * tid] = av * (before + v.x);
    acs[2 * tid + 1] = av * (before + v.x + v.y);
  }
  __syncthreads();
}

template <typename T>
__host__ __device__ constexpr int pad() { return 16 / sizeof(T); }

// out[n][p] = sum_j B[j][n] w_j X[j][p] from the chunk's tiles in shared
// memory, by the whole block; bf16 tiles: on the tensor cores, B * w split
// into kParts bf16 parts.
template <int kParts, typename T>
__device__ __forceinline__ void own_state(const T* sB, int ldn, const T* sX,
                                          int ldp, const float* wj, int n,
                                          int p, float* out) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    for (int i = tid; i < n * p; i += kThreads) {
      const int e = i / p, q = i - e * p;
      float s = 0.f;
      for (int j = 0; j < kQ; ++j)
        s += sB[j * ldn + e] * wj[j] * sX[j * ldp + q];
      out[i] = s;
    }
  } else {
    // M = n (16-row tiles over the warps), N = p, K = j: A = (B * w)^T,
    // split into kParts bf16 parts (hi first); B = X.
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
    for (int mt = warp; mt < n / 16; mt += kThreads / 32) {
      const int r = mt * 16 + g;
      uint32_t af[kParts][kQ / 16][4];
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        const int j = ks * 16 + 2 * q;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int jj = j + (f >> 1) * 8, rr = r + (f & 1) * 8;
          const float v0 = to_f(sB[jj * ldn + rr]) * wj[jj],
                      v1 = to_f(sB[(jj + 1) * ldn + rr]) * wj[jj + 1];
          if constexpr (kParts == 3)
            split3(v0, v1, af[0][ks][f], af[1][ks][f], af[2][ks][f]);
          else
            split(v0, v1, af[0][ks][f], af[1][ks][f]);
        }
      }
      for (int nt = 0; nt < p / 8; nt += 2) {  // two 8-column tiles
        float d[kParts][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < kQ / 16; ++ks) {
          uint32_t bx[4];
          ld_b_pair(sX, ldp, ks * 16, nt * 8, bx);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int k = 0; k < kParts; ++k)
              mma(d[k][u], af[k][ks], bx[2 * u], bx[2 * u + 1]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // the small parts first
            v[e] = d[kParts - 1][u][e];
#pragma unroll
            for (int k = kParts - 2; k >= 0; --k) v[e] += d[k][u][e];
          }
          const int col = (nt + u) * 8 + 2 * q;
          store2(out + (size_t)r * p + col, v[0], v[1]);
          store2(out + (size_t)(r + 8) * p + col, v[2], v[3]);
        }
      }
    }
  }
}

// The forward's pass 2 (state_pass): per head, S_in(c) = exp(a_last(c-1))
// S_in(c-1) + S_own(c-1) over the chunks in order, each thread owning 4
// state elements; the state after the last chunk is s_L (written unless
// `state` is null).  S_in(c) replaces S_own(c) (kInPlace, the fp32 path),
// or goes to s_in16 as bf16 hi and lo planes (kSplit, the bf16 path), in
// the layout chunk_out's products read, or is not written (kFinal, the
// final state's run).  `reverse` walks the chunks from the last to the
// first, as the backward carries the state's adjoint: G_out(c) =
// exp(a_last(c+1)) G_out(c+1) + D_own(c+1), G_out of the last chunk 0 (a
// run-time flag: one body serves both directions of the backward's
// carry, in fewer registers than two).
enum StateOut { kInPlace, kSplit, kFinal };

template <StateOut kOut>
__device__ __forceinline__ void carry_states(const float* __restrict__ chunk_a,
                                             float* chunk_s,
                                             __nv_bfloat16* __restrict__ s_in16,
                                             float* __restrict__ state, int nc,
                                             int np4, bool reverse = false) {
  const int bh = blockIdx.y;
  const int i = blockIdx.x * kStateThreads + threadIdx.x;
  if (i >= np4) return;
  float4* s = reinterpret_cast<float4*>(chunk_s) + (int64_t)bh * nc * np4 + i;
  uint2* s16 = reinterpret_cast<uint2*>(s_in16) + (int64_t)bh * nc * 2 * np4 +
               i;  // 4 bf16 a thread; lo plane np4 further on
  const float* al = chunk_a + (int64_t)bh * nc;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 own[kStateDepth], next[kStateDepth];
  // the k-th chunk visited
  auto at = [nc, reverse](int k) -> int64_t {
    return reverse ? nc - 1 - k : k;
  };
#pragma unroll
  for (int k = 0; k < kStateDepth; ++k)
    if (k < nc) next[k] = s[at(k) * np4];
  for (int c0 = 0; c0 < nc; c0 += kStateDepth) {
    // the next group's loads are in flight while this group is stored
#pragma unroll
    for (int k = 0; k < kStateDepth; ++k) {
      own[k] = next[k];
      if (c0 + kStateDepth + k < nc)
        next[k] = s[at(c0 + kStateDepth + k) * np4];
    }
#pragma unroll
    for (int k = 0; k < kStateDepth; ++k)
      if (c0 + k < nc) {
        const int64_t cc = at(c0 + k);
        if constexpr (kOut == kSplit) {
          uint2 hi, lo;
          split(run.x, run.y, hi.x, lo.x);
          split(run.z, run.w, hi.y, lo.y);
          s16[cc * 2 * np4] = hi;
          s16[cc * 2 * np4 + np4] = lo;
        } else if constexpr (kOut == kInPlace) {
          s[cc * np4] = run;
        }
        const float lam = expf(al[cc]);
        run.x = lam * run.x + own[k].x;
        run.y = lam * run.y + own[k].y;
        run.z = lam * run.z + own[k].z;
        run.w = lam * run.w + own[k].w;
      }
  }
  if (state != nullptr)
    reinterpret_cast<float4*>(state)[(int64_t)bh * np4 + i] = run;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

}  // namespace
