// Mamba2 SSD scan's gradient: dx, d(dt), da, dB and dC of y_t = C_t s_t,
// s_t = exp(dt_t a) s_{t-1} + dt_t B_t x_t^T per head, given dy; bf16 or
// fp32 x/B/C/dy, fp32 dt and a, fp32 arithmetic on the CUDA cores (bf16
// converted on load).
//
// Replaces no TPU kernel: it is the gradient of the ssd_scan TPU kernel
// (src/repro/kernels/ssd_scan/kernel.py, _ssd_kernel / ssd_scan_call,
// whose forward ssd_scan.cu ports), which the reference trains through
// jax.grad of its sequential scan (kernels/ssd_scan/ref.py, ssd_scan_ref).
// Per head, with G_t = C_t dy_t^T + exp(dt_{t+1} a) G_{t+1} the adjoint of
// the state and dlog_t = exp(dt_t a) <G_t, s_{t-1}>:
//
//   dC_t = s_t dy_t    dB_t = dt_t G_t x_t    dx_t = dt_t G_t^T B_t
//   d(dt)_t = a dlog_t + B_t . (G_t x_t)      da = sum_t dt_t dlog_t
//
// The forward's chunked form run backwards, over its 64-step chunks
// (ssd_scan.cuh; a_cs = a * inclusive cumsum(dt) within a chunk), in five
// kernels:
//
//   bwd_chunk  grid (chunk, head): the chunk's own end state S_own =
//              sum_j exp(a_last - a_cs_j) dt_j B_j x_j^T, its own adjoint
//              D_own = sum_t exp(a_cs_t) C_t dy_t^T and a_last;
//   bwd_carry  grid (N*P / 1024, head, 2): z = 0 carries the states forward
//              (S_in(c) over S_own(c)), z = 1 the adjoint in reverse
//              (G_out(c), the adjoint of the chunk's end state through the
//              chunks after it, over D_own(c)), both by the forward's
//              carry_states;
//   bwd_out    grid (chunk, head): from S_in(c), G_out(c) and the chunk's
//              masked [64, 64] products, dx, d(dt), the head's dB and dC
//              (fp32 partials) and its da partial;
//   bwd_reduce dB and dC of each group: its heads' partials added in head
//              order;
//   bwd_da     da: the partials added over the batch and the chunks in
//              order.
//
// dlog_t is formed as four sums of products and no per-step state:
// sum_{tau >= t} exp(a_cs_tau) C_tau^T S_in dy_tau, exp(a_last) <G_out,
// S_in>, sum_{j < t} exp(a_last - a_cs_j) dt_j B_j^T G_out x_j, and the
// rectangle sum_{tau >= t > j} exp(a_cs_tau - a_cs_j) dt_j (C_tau . B_j)
// (dy_tau . x_j).  Each term is zero wherever the state is (the sequence's
// first step); the shorter sum_{k >= t} (C_k . dC_k - B_k . dB_k) leaves
// there the rounding of two equal products.
//
// Deterministic, with no atomics: every sum is taken in a fixed order
// (sequential loops, warp shuffles of a fixed pattern), so two launches are
// bitwise equal.  exp is taken only of non-positive arguments (clamped at 0
// against the rounding of a_cs's warp scan).  x, B, C and dy are read
// through their (batch, step, head) strides with no alignment needed (the
// model passes x, B and C as views of one xbc buffer); dx, d(dt), dB and dC
// are written contiguous.
//
// Bound on the H100: memory.  The function reads x, dt, B, C and dy and
// writes dx, d(dt), dB and dC once (~13 MB at zamba2-1.2b's training step,
// B 8 x L 64, 64 heads: 0.004 ms at the H100 SXM's 3.35 TB/s).  This first
// form is not near it: bwd_out's ~(3 N + 3 P + 96) * 64 fp32 multiply-adds
// per step and head run on the CUDA cores from shared memory; the tensor
// cores and the forward's bf16 hi/lo split are later work.

#include "ssd_scan.cuh"

namespace {

constexpr int kOutThreads = 256;     // 8 warps; warp w owns rows w, w+8, ...
constexpr int kReduceThreads = 256;
constexpr int kQ1 = kQ + 1;          // row stride of the [64, 64] matrices

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const void* dy;
  void* dx;        // [B, L, H, P], x's dtype
  float* ddt;      // [B, L, H]
  float* da;       // [H]
  void* db;        // [B, L, G, N], B's dtype
  void* dc;        // [B, L, G, N], C's dtype
  float* chunk_s;  // [B*H, chunks, N, P]: S_own, then S_in
  float* chunk_g;  // [B*H, chunks, N, P]: D_own, then G_out
  float* chunk_a;  // [B*H, chunks]: a_cs at the chunk's last step
  float* da_part;  // [B*H, chunks]
  float* db_part;  // [B, L, H, N]: each head's dB
  float* dc_part;  // [B, L, H, N]: each head's dC
  Strides sx, sdt, sb, sc, sdy;
  int bsz, h, g, L, n, p, nc;
};

__device__ __forceinline__ float decay(float v) {
  return expf(fminf(v, 0.f));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [0, rows) of a kQ-row tile of `cols` elements into fp32 shared
// memory (row stride ld), converted on load; rows past `rows` are zero.
template <typename T>
__device__ __forceinline__ void load_f32(float* dst, int ld, const T* src,
                                         int64_t row_stride, int rows,
                                         int cols) {
  for (int i = threadIdx.x; i < kQ * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = r < rows ? to_f(src[r * row_stride + c]) : 0.f;
  }
}

// The chunk's tiles of B, C (its group's), x and dy (its head's) as fp32
// [kQ][N + 1] / [kQ][P + 1] (odd strides: a warp reading a column is free
// of bank conflicts), dt and a_cs; ends in a barrier.
template <typename T>
__device__ __forceinline__ void load_chunk(const BwdArgs& A, int b, int h,
                                           int t0, int rows, float* sB,
                                           float* sC, float* sX, float* sY,
                                           float* dts, float* acs) {
  const int grp = h / (A.h / A.g), ldn = A.n + 1, ldp = A.p + 1;
  load_f32(sB, ldn,
           static_cast<const T*>(A.bm) + b * A.sb.b + (int64_t)t0 * A.sb.l +
               grp * A.sb.h,
           A.sb.l, rows, A.n);
  load_f32(sC, ldn,
           static_cast<const T*>(A.cm) + b * A.sc.b + (int64_t)t0 * A.sc.l +
               grp * A.sc.h,
           A.sc.l, rows, A.n);
  load_f32(sX, ldp,
           static_cast<const T*>(A.x) + b * A.sx.b + (int64_t)t0 * A.sx.l +
               h * A.sx.h,
           A.sx.l, rows, A.p);
  load_f32(sY, ldp,
           static_cast<const T*>(A.dy) + b * A.sdy.b +
               (int64_t)t0 * A.sdy.l + h * A.sdy.h,
           A.sdy.l, rows, A.p);
  chunk_decay(A.a[h], load_dt(A.dt, A.sdt, b, h, t0, rows), dts, acs);
}

size_t chunk_smem(int n, int p) {
  return sizeof(float) * (2 * (size_t)kQ * (n + 1) + 2 * (size_t)kQ * (p + 1) +
                          4 * kQ);
}

size_t out_smem(int n, int p) {
  return sizeof(float) * (2 * (size_t)kQ * (p + 1) + 2 * (size_t)kQ * (n + 1) +
                          2 * (size_t)n * (p + 1) + 3 * kQ * kQ1 + 6 * kQ + 8);
}

// Pass 1: S_own, D_own and a_last of chunk blockIdx.x of head blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_chunk(BwdArgs A) {
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / A.h, h = bh % A.h;
  const int t0 = c * kQ, rows = min(kQ, A.L - t0);
  const int n = A.n, p = A.p, ldn = n + 1, ldp = p + 1;
  extern __shared__ float smf[];
  float* sB = smf;               // [kQ][ldn]
  float* sC = sB + kQ * ldn;     // [kQ][ldn]
  float* sX = sC + kQ * ldn;     // [kQ][ldp]
  float* sY = sX + kQ * ldp;     // [kQ][ldp]
  float* dts = sY + kQ * ldp;
  float* acs = dts + kQ;
  float* wj = acs + kQ;          // exp(a_last - a_cs_j) dt_j
  float* wc = wj + kQ;           // exp(a_cs_t), 0 past rows
  load_chunk<T>(A, b, h, t0, rows, sB, sC, sX, sY, dts, acs);
  const int tid = threadIdx.x;
  const float a_last = acs[rows - 1];
  const int64_t at = (int64_t)bh * A.nc + c;
  if (tid < kQ) {
    wj[tid] = decay(a_last - acs[tid]) * dts[tid];
    wc[tid] = tid < rows ? decay(acs[tid]) : 0.f;
  }
  if (tid == 0) A.chunk_a[at] = a_last;
  __syncthreads();
  own_state<1>(sB, ldn, sX, ldp, wj, n, p, A.chunk_s + at * n * p);
  own_state<1>(sC, ldn, sY, ldp, wc, n, p, A.chunk_g + at * n * p);
}

// Pass 2: the states forward and their adjoint in reverse, in place.
__global__ void __launch_bounds__(kStateThreads) bwd_carry(BwdArgs A) {
  const int np4 = A.n * A.p / 4;
  if (blockIdx.z == 0)
    carry_states<kInPlace>(A.chunk_a, A.chunk_s, nullptr, nullptr, A.nc,
                           np4);
  else
    carry_states<kInPlace, true>(A.chunk_a, A.chunk_g, nullptr, nullptr,
                                 A.nc, np4);
}

// Pass 3: dx, d(dt), the head's dB and dC and its da partial for chunk
// blockIdx.x of head blockIdx.y.  With E[tau][j] = exp(a_cs_tau - a_cs_j)
// (j <= tau), M1 = (dY X^T) * E and M3 = (C B^T) * E:
//   dC_t = exp(a_cs_t) S_in dy_t + sum_{j <= t} M1[t][j] dt_j B_j
//   u_t  = sum_{tau >= t} M1[tau][t] C_tau + exp(a_last - a_cs_t) G_out x_t
//   dB_t = dt_t u_t
//   dx_t = dt_t (sum_{tau >= t} M3[tau][t] dy_tau
//                + exp(a_last - a_cs_t) G_out^T B_t)
//   d(dt)_t = a dlog_t + B_t . u_t
template <typename T>
__global__ void __launch_bounds__(kOutThreads) bwd_out(BwdArgs A) {
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / A.h, h = bh % A.h;
  const int t0 = c * kQ, rows = min(kQ, A.L - t0);
  const int n = A.n, p = A.p, ldn = n + 1, ldp = p + 1;
  const bool has_s = c > 0, has_g = c + 1 < A.nc;  // S_in, G_out nonzero
  extern __shared__ float smf[];
  float* sX = smf;               // [kQ][ldp]
  float* sY = sX + kQ * ldp;     // [kQ][ldp]
  float* sB = sY + kQ * ldp;     // [kQ][ldn]
  float* sC = sB + kQ * ldn;     // [kQ][ldn]
  float* sS = sC + kQ * ldn;     // S_in [n][ldp]
  float* sG = sS + n * ldp;      // G_out [n][ldp]
  float* m1 = sG + n * ldp;      // [kQ][kQ1]
  float* m3 = m1 + kQ * kQ1;     // [kQ][kQ1]
  float* wr = m3 + kQ * kQ1;     // [kQ][kQ1]: W, then its row prefixes
  float* dts = wr + kQ * kQ1;
  float* acs = dts + kQ;
  float* vv = acs + kQ;          // exp(a_cs_t) C_t^T S_in dy_t
  float* ww = vv + kQ;           // exp(a_last - a_cs_t) dt_t B_t^T G_out x_t
  float* qq = ww + kQ;           // B_t . u_t
  float* rect = qq + kQ;         // sum_{tau >= t > j} W[tau][j]
  float* red = rect + kQ;        // [8]: <G_out, S_in> per warp
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t at = (int64_t)bh * A.nc + c;
  if (has_s || has_g) {
    const float* gs = A.chunk_s + at * n * p;
    const float* gg = A.chunk_g + at * n * p;
    for (int i = tid; i < n * p; i += kOutThreads) {
      const int e = i / p, q = i - e * p;
      if (has_s) sS[e * ldp + q] = gs[i];
      if (has_g) sG[e * ldp + q] = gg[i];
    }
  }
  load_chunk<T>(A, b, h, t0, rows, sB, sC, sX, sY, dts, acs);
  const float a_last = acs[rows - 1];

  // the [64, 64] matrices, and W[tau][j] = M1[tau][j] (C_tau . B_j) dt_j
  for (int i = tid; i < kQ * kQ; i += kOutThreads) {
    const int tau = i / kQ, j = i - tau * kQ;
    float v1 = 0.f, v3 = 0.f, w = 0.f;
    if (j <= tau && tau < rows) {
      float yx = 0.f, cb = 0.f;
      for (int q = 0; q < p; ++q) yx += sY[tau * ldp + q] * sX[j * ldp + q];
      for (int e = 0; e < n; ++e) cb += sC[tau * ldn + e] * sB[j * ldn + e];
      const float ex = decay(acs[tau] - acs[j]);
      v1 = yx * ex;
      v3 = cb * ex;
      w = v1 * cb * dts[j];
    }
    m1[tau * kQ1 + j] = v1;
    m3[tau * kQ1 + j] = v3;
    wr[tau * kQ1 + j] = w;
  }
  float kp = 0.f;  // <G_out, S_in>, this thread's share
  if (has_s && has_g)
    for (int i = tid; i < n * p; i += kOutThreads) {
      const int e = i / p, q = i - e * p;
      kp += sG[e * ldp + q] * sS[e * ldp + q];
    }
  kp = warp_sum(kp);
  if (lane == 0) red[warp] = kp;
  __syncthreads();
  // W's rows into their exclusive prefix sums: wr[tau][t] = sum_{j<t} W
  for (int tau = warp; tau < kQ; tau += kOutThreads / 32) {
    float* row = wr + tau * kQ1 + 2 * lane;
    const float v0 = row[0], v1 = row[1];
    float run = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += o;
    }
    float before = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) before = 0.f;
    row[0] = before;
    row[1] = before + v0;
  }
  __syncthreads();
  if (tid < kQ) {  // the rectangle tau >= t > j
    float r = 0.f;
    for (int tau = tid; tau < rows; ++tau) r += wr[tau * kQ1 + tid];
    rect[tid] = r;
  }

  for (int t = warp; t < kQ; t += kOutThreads / 32) {
    if (t >= rows) {
      if (lane == 0) vv[t] = ww[t] = qq[t] = 0.f;
      continue;
    }
    const float e_t = decay(acs[t]), f_t = decay(a_last - acs[t]);
    const float d_t = dts[t];
    const int64_t row = ((int64_t)b * A.L + t0 + t) * A.h + h;
    float sv = 0.f, sw = 0.f, sq = 0.f;
    for (int e = lane; e < n; e += 32) {
      float sdy = 0.f;  // (S_in dy_t)[e]
      if (has_s)
        for (int q = 0; q < p; ++q) sdy += sY[t * ldp + q] * sS[e * ldp + q];
      float intra = 0.f;
      for (int j = 0; j <= t; ++j)
        intra += m1[t * kQ1 + j] * dts[j] * sB[j * ldn + e];
      const float dcv = e_t * sdy + intra;
      float back = 0.f;
      for (int tau = t; tau < rows; ++tau)
        back += m1[tau * kQ1 + t] * sC[tau * ldn + e];
      float gx = 0.f;   // (G_out x_t)[e]
      if (has_g)
        for (int q = 0; q < p; ++q) gx += sG[e * ldp + q] * sX[t * ldp + q];
      const float u = back + f_t * gx;
      A.dc_part[row * n + e] = dcv;
      A.db_part[row * n + e] = d_t * u;
      sv += sC[t * ldn + e] * sdy;
      sw += sB[t * ldn + e] * gx;
      sq += sB[t * ldn + e] * u;
    }
    sv = warp_sum(sv);
    sw = warp_sum(sw);
    sq = warp_sum(sq);
    if (lane == 0) {
      vv[t] = e_t * sv;
      ww[t] = f_t * d_t * sw;
      qq[t] = sq;
    }
    T* dx = static_cast<T*>(A.dx) + row * p;
    for (int q = lane; q < p; q += 32) {
      float back = 0.f;
      for (int tau = t; tau < rows; ++tau)
        back += m3[tau * kQ1 + t] * sY[tau * ldp + q];
      float gb = 0.f;   // (G_out^T B_t)[q]
      if (has_g)
        for (int e = 0; e < n; ++e) gb += sB[t * ldn + e] * sG[e * ldp + q];
      store1(dx + q, d_t * (back + f_t * gb));
    }
  }
  __syncthreads();

  if (warp == 0) {  // dlog, d(dt) and the da partial; lane l: rows 2l, 2l+1
    float kdot = 0.f;
    for (int w = 0; w < kOutThreads / 32; ++w) kdot += red[w];
    kdot *= decay(a_last);
    const int i0 = 2 * lane, i1 = i0 + 1;
    const float v0 = vv[i0], v1 = vv[i1];
    float suf = v0 + v1;   // sum of v over rows >= i0
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o;
    }
    float after = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) after = 0.f;
    const float w0 = ww[i0], w1 = ww[i1];
    float pre = w0 + w1;   // sum of w over rows <= i1
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, pre, off);
      if (lane >= off) pre += o;
    }
    float before = __shfl_up_sync(0xffffffffu, pre, 1);
    if (lane == 0) before = 0.f;
    const float suf1 = v1 + after, suf0 = v0 + suf1;
    const float dl0 = suf0 + kdot + before + rect[i0];
    const float dl1 = suf1 + kdot + (before + w0) + rect[i1];
    const float av = A.a[h];
    float* ddt = A.ddt + ((int64_t)b * A.L + t0) * A.h + h;
    if (i0 < rows) ddt[(int64_t)i0 * A.h] = av * dl0 + qq[i0];
    if (i1 < rows) ddt[(int64_t)i1 * A.h] = av * dl1 + qq[i1];
    const float part = warp_sum(dts[i0] * dl0 + dts[i1] * dl1);
    if (lane == 0) A.da_part[at] = part;
  }
}

// Pass 4: dB and dC of each (batch, step, group): its heads' partials in
// head order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) bwd_reduce(BwdArgs A) {
  const int rep = A.h / A.g;
  const int64_t total = (int64_t)A.bsz * A.L * A.g * A.n;
  for (int64_t e = blockIdx.x * (int64_t)kReduceThreads + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * kReduceThreads) {
    const int col = static_cast<int>(e % A.n);
    const int64_t rest = e / A.n;
    const int grp = static_cast<int>(rest % A.g);
    const int64_t base = ((rest / A.g) * A.h + (int64_t)grp * rep) * A.n + col;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += A.db_part[base + (int64_t)r * A.n];
      sc += A.dc_part[base + (int64_t)r * A.n];
    }
    store1(static_cast<T*>(A.db) + e, sb);
    store1(static_cast<T*>(A.dc) + e, sc);
  }
}

// Pass 5: da[h], the partials over the batch and the chunks in order.
__global__ void __launch_bounds__(kReduceThreads) bwd_da(BwdArgs A) {
  for (int hh = threadIdx.x; hh < A.h; hh += kReduceThreads) {
    float s = 0.f;
    for (int b = 0; b < A.bsz; ++b)
      for (int c = 0; c < A.nc; ++c)
        s += A.da_part[((int64_t)b * A.h + hh) * A.nc + c];
    A.da[hh] = s;
  }
}

template <typename T>
int launch(const BwdArgs& A, int bh, cudaStream_t stream) {
  static size_t allowed_chunk = 0, allowed_out = 0;
  const size_t s1 = chunk_smem(A.n, A.p), s3 = out_smem(A.n, A.p);
  if (s1 > kMaxSmem || s3 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(bwd_chunk<T>, s1, allowed_chunk);
  if (e == cudaSuccess) e = allow_smem(bwd_out<T>, s3, allowed_out);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(A.nc, bh);
  bwd_chunk<T><<<grid, kThreads, s1, stream>>>(A);
  const int np4 = A.n * A.p / 4;
  bwd_carry<<<dim3((np4 + kStateThreads - 1) / kStateThreads, bh, 2),
              kStateThreads, 0, stream>>>(A);
  bwd_out<T><<<grid, kOutThreads, s3, stream>>>(A);
  const int64_t total = (int64_t)A.bsz * A.L * A.g * A.n;
  const int64_t blocks = (total + kReduceThreads - 1) / kReduceThreads;
  bwd_reduce<T><<<static_cast<int>(blocks < 8LL * sm_count()
                                       ? blocks
                                       : 8LL * sm_count()),
                  kReduceThreads, 0, stream>>>(A);
  bwd_da<<<1, kReduceThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c, dy, dx, db, dc); dt is float32
// [bsz, L, h] and a float32 [h].  dims (int64): bsz, L, h, g, n, p, then
// the (batch, step, head) strides in elements of x, dt, b, c and dy, whose
// innermost dimension is contiguous.  dx [bsz, L, h, p], ddt [bsz, L, h],
// da [h], db and dc [bsz, L, g, n] are written whole, contiguous.  n, p
// multiples of 4 (fp32) or of 16 (bf16), bwd_out's shared memory within a
// block's (N 128 with P 64 fits).  scratch: float32 of 2 * bsz * h *
// chunks * (n * p + 1) + 2 * bsz * L * h * n, chunks = ceil(L / 64).
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* a, const void* b,
                                   const void* c, const void* dy, void* dx,
                                   void* ddt, void* da, void* db, void* dc,
                                   void* scratch, const int64_t* dims,
                                   int dtype, void* stream) {
  const int64_t bsz = dims[0], L = dims[1], h = dims[2], g = dims[3],
                n = dims[4], p = dims[5];
  if (bsz <= 0 || L <= 0 || h <= 0) return 0;
  const bool bf16 = dtype == 1;
  if ((dtype != 0 && !bf16) || g <= 0 || h % g != 0 || n <= 0 || p <= 0 ||
      (bf16 ? (n % 16 || p % 16) : (n % 4 || p % 4)) || bsz * h > 65535 ||
      L > (int64_t)1 << 30)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs A;
  A.x = x;
  A.dt = static_cast<const float*>(dt);
  A.a = static_cast<const float*>(a);
  A.bm = b;
  A.cm = c;
  A.dy = dy;
  A.dx = dx;
  A.ddt = static_cast<float*>(ddt);
  A.da = static_cast<float*>(da);
  A.db = db;
  A.dc = dc;
  A.nc = static_cast<int>((L + kQ - 1) / kQ);
  const int64_t heads = bsz * h, states = heads * A.nc * n * p;
  A.chunk_s = static_cast<float*>(scratch);
  A.chunk_g = A.chunk_s + states;
  A.chunk_a = A.chunk_g + states;
  A.da_part = A.chunk_a + heads * A.nc;
  A.db_part = A.da_part + heads * A.nc;
  A.dc_part = A.db_part + heads * L * n;
  Strides* st[5] = {&A.sx, &A.sdt, &A.sb, &A.sc, &A.sdy};
  for (int i = 0; i < 5; ++i) *st[i] = {dims[6 + 3 * i], dims[7 + 3 * i],
                                        dims[8 + 3 * i]};
  A.bsz = static_cast<int>(bsz);
  A.h = static_cast<int>(h);
  A.g = static_cast<int>(g);
  A.L = static_cast<int>(L);
  A.n = static_cast<int>(n);
  A.p = static_cast<int>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = static_cast<int>(heads);
  return bf16 ? launch<__nv_bfloat16>(A, bh, s) : launch<float>(A, bh, s);
}
