// Mamba2 SSD scan's gradient: dx, d(dt), da, dB and dC of y_t = C_t s_t,
// s_t = exp(dt_t a) s_{t-1} + dt_t B_t x_t^T per head, given dy; bf16 or
// fp32 x/B/C/dy, fp32 dt and a, fp32 accumulation.
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
//              sum_j exp(a_last - a_cs_j) dt_j B_j x_j^T (not of the last
//              chunk), its own adjoint D_own = sum_t exp(a_cs_t) C_t dy_t^T
//              (not of the first) and a_last;
//   bwd_carry  grid (N*P / 1024, head, 2): z = 0 carries the states forward
//              (S_in(c)), z = 1 the adjoint in reverse (G_out(c), the
//              adjoint of the chunk's end state through the chunks after
//              it), both by the forward's carry_states;
//   bwd_out    grid (chunk, head): from S_in(c), G_out(c) and the chunk's
//              masked [64, 64] products, dx, d(dt), the head's dB and dC
//              (fp32 partials) and its da partial;
//   bwd_reduce dB and dC of each group: its heads' partials added in head
//              order;
//   bwd_da     da: the partials added over the batch and the chunks in
//              order.
//
// bwd_out reads S_in only for chunks c > 0 and G_out only for c + 1 < nc,
// so a sequence of one chunk (zamba2-1.2b's training length, 64) launches
// neither bwd_chunk nor bwd_carry: three kernels instead of five.
//
// dlog_t is formed as four sums of products and no per-step state:
// sum_{tau >= t} exp(a_cs_tau) C_tau^T S_in dy_tau, exp(a_last) <G_out,
// S_in>, sum_{j < t} exp(a_last - a_cs_j) dt_j B_j^T G_out x_j, and the
// rectangle sum_{tau >= t > j} exp(a_cs_tau - a_cs_j) dt_j (C_tau . B_j)
// (dy_tau . x_j).  Each term is zero wherever the state is (the sequence's
// first step); the shorter sum_{k >= t} (C_k . dC_k - B_k . dB_k) leaves
// there the rounding of two equal products.
//
// bf16 inputs run every product on the tensor cores (mma.sync m16n8k16,
// fp32 accumulators), as the forward does: x, B, C and dy arrive by
// cp.async as bf16 tiles; bf16 x bf16 products are exact in fp32, and
// each fp32 operand is split into bf16 hi + lo parts (~16 significant
// bits), the parts' products added small first.  bwd_chunk is the
// forward's chunk_state twice, (B w)^T X and (C exp(a_cs))^T dY with the
// fp32 left operand split; bwd_carry writes S_in and G_out as hi and lo
// planes.  In bwd_out warp w owns rows 16w..16w+15 and forms each masked
// [64, 64] matrix in the orientation its product needs, from its own bf16
// product (only the warp's causal or anti-causal band of 8-column tiles):
//   dY.X^T, j <= t, exp(a_cs_t - a_cs_j) dt_j      (x B: dC's intra term)
//   X.dY^T, tau >= t, exp(a_cs_tau - a_cs_t)      (x C: u's backward term)
//   B.C^T,  tau >= t, exp(a_cs_tau - a_cs_t)      (x dY: dx's backward term)
// each split into hi + lo before its product; and the three state
// products dY.S_in^T, X.G_out^T and B.G_out with the bf16 input as one
// operand and the planes as the other.  d(dt)'s four sums come from the
// fp32 accumulators (W = M1 (C.B^T) dt_j, its row prefixes and column
// sums in shared memory, in fixed order).  Rounded once to bf16 instead
// of split, every one of those seven fp32 operands leaves elements
// outside the card's tolerance (tests/test_torch_ssd_backward.py).
// fp32 inputs run the same passes on the CUDA cores in fp32, converted on
// load into tiles with odd row strides (the float32 cross-checks of the
// training path hold to them).
//
// Deterministic, with no atomics: every sum is taken in a fixed order
// (sequential loops, mma, warp shuffles of a fixed pattern), so two
// launches are bitwise equal.  exp is taken only of non-positive
// arguments (clamped at 0 against the rounding of a_cs's warp scan).  x,
// B, C and dy are read through their (batch, step, head) strides (the
// model passes x, B and C as views of one xbc buffer), a row contiguous
// and, in bf16, 16-byte aligned; dx, d(dt), dB and dC are written
// contiguous.
//
// Bound on the H100: memory.  The function reads x, dt, B, C and dy and
// writes dx, d(dt), dB and dC once: ~13 MB at zamba2-1.2b's training step
// (B 8 x L 64, 64 heads of P 64, N 64), 0.0039 ms at the H100 SXM's
// 3.35 TB/s; 0.0313 ms at B 1 x L 4,096.  Its 14*N*P operations a step
// and head are far below the tensor-core rate even with the splits.  The
// fp32 dB and dC partials of every head, written by bwd_out and read by
// bwd_reduce in head order (~34 MB at the training shape, ~0.010 ms), are
// the floor of this scheme; adding a group's heads inside one block would
// remove them, and is later work.

#include "ssd_scan.cuh"

namespace {

constexpr int kOutThreads32 = 256;   // fp32 bwd_out: 8 warps, rows w, w+8..
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
  float* chunk_s;  // [B*H, chunks, N, P]: S_own (fp32: then S_in)
  float* chunk_g;  // [B*H, chunks, N, P]: D_own (fp32: then G_out)
  bf16* s16;       // bf16: [B*H, chunks, 2, N, P] S_in as hi, lo planes
  bf16* g16;       // bf16: [B*H, chunks, 2, N, P] G_out as hi, lo planes
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
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// The sum over the four lanes of a quad (one row of an mma fragment).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Row [64] of W into its exclusive prefix sums by one warp: row[t] =
// sum_{j<t} W[j].
__device__ __forceinline__ void prefix_row(float* row, int lane) {
  row += 2 * lane;
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

// dlog, d(dt) and the da partial of the chunk from its per-row sums, by
// warp 0 (lane l: rows 2l, 2l+1): vv, ww and qq per row, rect the
// rectangle, red[0..warps) <G_out, S_in> by warp.
__device__ __forceinline__ void finish_dlog(
    const BwdArgs& A, int b, int h, int t0, int rows, int64_t at,
    float a_last, const float* dts, const float* vv, const float* ww,
    const float* qq, const float* rect, const float* red, int warps) {
  const int lane = threadIdx.x & 31;
  float kdot = 0.f;
  for (int w = 0; w < warps; ++w) kdot += red[w];
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

// ---- fp32 inputs: the CUDA cores ----

// Rows [0, rows) of a kQ-row tile of `cols` elements into fp32 shared
// memory (row stride ld); rows past `rows` are zero.
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src,
                                         int64_t row_stride, int rows,
                                         int cols) {
  for (int i = threadIdx.x; i < kQ * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = r < rows ? src[r * row_stride + c] : 0.f;
  }
}

// The chunk's tiles of B, C (its group's), x and dy (its head's) as fp32
// [kQ][N + 1] / [kQ][P + 1] (odd strides: a warp reading a column is free
// of bank conflicts), dt and a_cs; ends in a barrier.
__device__ __forceinline__ void load_chunk(const BwdArgs& A, int b, int h,
                                           int t0, int rows, float* sB,
                                           float* sC, float* sX, float* sY,
                                           float* dts, float* acs) {
  const int grp = h / (A.h / A.g), ldn = A.n + 1, ldp = A.p + 1;
  load_f32(sB, ldn,
           static_cast<const float*>(A.bm) + b * A.sb.b +
               (int64_t)t0 * A.sb.l + grp * A.sb.h,
           A.sb.l, rows, A.n);
  load_f32(sC, ldn,
           static_cast<const float*>(A.cm) + b * A.sc.b +
               (int64_t)t0 * A.sc.l + grp * A.sc.h,
           A.sc.l, rows, A.n);
  load_f32(sX, ldp,
           static_cast<const float*>(A.x) + b * A.sx.b +
               (int64_t)t0 * A.sx.l + h * A.sx.h,
           A.sx.l, rows, A.p);
  load_f32(sY, ldp,
           static_cast<const float*>(A.dy) + b * A.sdy.b +
               (int64_t)t0 * A.sdy.l + h * A.sdy.h,
           A.sdy.l, rows, A.p);
  chunk_decay(A.a[h], load_dt(A.dt, A.sdt, b, h, t0, rows), dts, acs);
}

// Pass 3 for fp32 inputs, chunk blockIdx.x of head blockIdx.y.  With
// E[tau][j] = exp(a_cs_tau - a_cs_j) (j <= tau), M1 = (dY X^T) * E and
// M3 = (C B^T) * E:
//   dC_t = exp(a_cs_t) S_in dy_t + sum_{j <= t} M1[t][j] dt_j B_j
//   u_t  = sum_{tau >= t} M1[tau][t] C_tau + exp(a_last - a_cs_t) G_out x_t
//   dB_t = dt_t u_t
//   dx_t = dt_t (sum_{tau >= t} M3[tau][t] dy_tau
//                + exp(a_last - a_cs_t) G_out^T B_t)
//   d(dt)_t = a dlog_t + B_t . u_t
__device__ __forceinline__ void out_fp32(const BwdArgs& A) {
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
    for (int i = tid; i < n * p; i += kOutThreads32) {
      const int e = i / p, q = i - e * p;
      if (has_s) sS[e * ldp + q] = gs[i];
      if (has_g) sG[e * ldp + q] = gg[i];
    }
  }
  load_chunk(A, b, h, t0, rows, sB, sC, sX, sY, dts, acs);
  const float a_last = acs[rows - 1];

  // the [64, 64] matrices, and W[tau][j] = M1[tau][j] (C_tau . B_j) dt_j
  for (int i = tid; i < kQ * kQ; i += kOutThreads32) {
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
    for (int i = tid; i < n * p; i += kOutThreads32) {
      const int e = i / p, q = i - e * p;
      kp += sG[e * ldp + q] * sS[e * ldp + q];
    }
  kp = warp_sum(kp);
  if (lane == 0) red[warp] = kp;
  __syncthreads();
  for (int tau = warp; tau < kQ; tau += kOutThreads32 / 32)
    prefix_row(wr + tau * kQ1, lane);
  __syncthreads();
  if (tid < kQ) {  // the rectangle tau >= t > j
    float r = 0.f;
    for (int tau = tid; tau < rows; ++tau) r += wr[tau * kQ1 + tid];
    rect[tid] = r;
  }

  for (int t = warp; t < kQ; t += kOutThreads32 / 32) {
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
    float* dx = static_cast<float*>(A.dx) + row * p;
    for (int q = lane; q < p; q += 32) {
      float back = 0.f;
      for (int tau = t; tau < rows; ++tau)
        back += m3[tau * kQ1 + t] * sY[tau * ldp + q];
      float gb = 0.f;   // (G_out^T B_t)[q]
      if (has_g)
        for (int e = 0; e < n; ++e) gb += sB[t * ldn + e] * sG[e * ldp + q];
      dx[q] = d_t * (back + f_t * gb);
    }
  }
  __syncthreads();
  if (warp == 0)
    finish_dlog(A, b, h, t0, rows, at, a_last, dts, vv, ww, qq, rect, red,
                kOutThreads32 / 32);
}

// ---- bf16 inputs: the tensor cores ----

// acc (rows t = ra, ra + 8; columns tau) masked to tau >= t and times
// exp(a_cs_tau - a_cs_t).
__device__ __forceinline__ void anti_mask(float (&acc)[kQ / 8][4],
                                          const float* acs, int ra) {
  const int q = threadIdx.x & 3;
  const float ea = acs[ra], eb = acs[ra + 8];
#pragma unroll
  for (int nt = 0; nt < kQ / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tau = nt * 8 + 2 * q + e;
      const float at = acs[tau];
      acc[nt][e] = tau >= ra ? acc[nt][e] * decay(at - ea) : 0.f;
      acc[nt][2 + e] = tau >= ra + 8 ? acc[nt][2 + e] * decay(at - eb) : 0.f;
    }
}

// dh[u] += A . Sh^T and dl[u] += A . Sl^T over k < kdim: A rows ra, ra +
// 8 of the bf16 tile `a`, Sh and Sl a state's hi and lo planes [n][lds],
// rows n0 + 8u..n0 + 8u + 7 (dY . S_in^T, X . G_out^T).
__device__ __forceinline__ void planes_t_product(float (&dh)[2][4],
                                                 float (&dl)[2][4],
                                                 const bf16* a, int lda,
                                                 const bf16* sh,
                                                 const bf16* sl, int lds,
                                                 int kdim, int ra, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int ks = 0; ks < kdim / 16; ++ks) {
    uint32_t af[4];
    ld_a(a, lda, ra, ks * 16, af);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int off = (n0 + 8 * u + g) * lds + ks * 16 + 2 * q;
      mma(dh[u], af, ld32(sh + off), ld32(sh + off + 8));
      mma(dl[u], af, ld32(sl + off), ld32(sl + off + 8));
    }
  }
}

// Pass 3 for bf16 inputs, the same sums as out_fp32 on the tensor cores:
// warp w owns rows ra = 16w + lane/4 and rb = ra + 8 of the chunk.
__device__ __forceinline__ void out_mma(const BwdArgs& A) {
  constexpr int E = pad<bf16>();
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / A.h, h = bh % A.h, grp = h / (A.h / A.g);
  const int t0 = c * kQ, rows = min(kQ, A.L - t0);
  const int n = A.n, p = A.p, ldn = n + E, ldp = p + E;
  const bool has_s = c > 0, has_g = c + 1 < A.nc;  // S_in, G_out nonzero
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // [kQ][ldp]
  bf16* sY = sX + kQ * ldp;                  // [kQ][ldp]
  bf16* sB = sY + kQ * ldp;                  // [kQ][ldn]
  bf16* sC = sB + kQ * ldn;                  // [kQ][ldn]
  bf16* sSh = sC + kQ * ldn;                 // S_in hi, lo: [n][ldp] each
  bf16* sSl = sSh + n * ldp;
  bf16* sGh = sSl + n * ldp;                 // G_out hi, lo
  bf16* sGl = sGh + n * ldp;
  float* sW = reinterpret_cast<float*>(sGl + n * ldp);  // [kQ][kQ1]: W,
  float* dts = sW + kQ * kQ1;                          // then its row
  float* acs = dts + kQ;                               // prefixes
  float* vv = acs + kQ;     // exp(a_cs_t) C_t^T S_in dy_t
  float* ww = vv + kQ;      // exp(a_last - a_cs_t) dt_t B_t^T G_out x_t
  float* qq = ww + kQ;      // B_t . u_t
  float* rect = qq + kQ;    // sum_{tau >= t > j} W[tau][j]
  float* red = rect + kQ;   // [4]: <G_out, S_in> per warp
  const int64_t at = (int64_t)bh * A.nc + c;
  load_tile(sX, ldp,
            static_cast<const bf16*>(A.x) + b * A.sx.b +
                (int64_t)t0 * A.sx.l + h * A.sx.h,
            A.sx.l, rows, p);
  load_tile(sY, ldp,
            static_cast<const bf16*>(A.dy) + b * A.sdy.b +
                (int64_t)t0 * A.sdy.l + h * A.sdy.h,
            A.sdy.l, rows, p);
  load_tile(sB, ldn,
            static_cast<const bf16*>(A.bm) + b * A.sb.b +
                (int64_t)t0 * A.sb.l + grp * A.sb.h,
            A.sb.l, rows, n);
  load_tile(sC, ldn,
            static_cast<const bf16*>(A.cm) + b * A.sc.b +
                (int64_t)t0 * A.sc.l + grp * A.sc.h,
            A.sc.l, rows, n);
  if (has_s) {
    const bf16* s16 = A.s16 + at * 2 * n * p;
    load_tile(sSh, ldp, s16, p, n, p, n);
    load_tile(sSl, ldp, s16 + (size_t)n * p, p, n, p, n);
  }
  if (has_g) {
    const bf16* g16 = A.g16 + at * 2 * n * p;
    load_tile(sGh, ldp, g16, p, n, p, n);
    load_tile(sGl, ldp, g16 + (size_t)n * p, p, n, p, n);
  }
  chunk_decay(A.a[h], load_dt(A.dt, A.sdt, b, h, t0, rows), dts, acs);
  cp_async_wait_all();
  __syncthreads();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const float a_last = acs[rows - 1];
  {
    float kp = 0.f;  // <G_out, S_in>, this thread's share
    if (has_s && has_g)
      for (int i = tid; i < n * p; i += kThreads) {
        const int e = i / p, k = e * ldp + (i - e * p);
        kp += (to_f(sGl[k]) + to_f(sGh[k])) * (to_f(sSl[k]) + to_f(sSh[k]));
      }
    kp = warp_sum(kp);
    if (lane == 0) red[warp] = kp;
  }
  const int ra = warp * 16 + g, rb = ra + 8;
  const float ea = acs[ra], eb = acs[rb];
  const float e_a = decay(ea), e_b = decay(eb);
  const float f_a = decay(a_last - ea), f_b = decay(a_last - eb);
  const float d_a = dts[ra], d_b = dts[rb];
  const int64_t row_a = ((int64_t)b * A.L + t0 + ra) * A.h + h;
  const int64_t row_b = row_a + 8 * (int64_t)A.h;
  uint32_t mh[kQ / 16][4], ml[kQ / 16][4];  // a masked matrix, hi and lo

  // dY.X^T and C.B^T over the causal band j <= t: W into shared memory,
  // M1 * dt_j as A fragments; then dC = exp(a_cs_t) S_in dy_t + (M1 *
  // dt_j).B and C_t . (S_in dy_t).
  {
    float yx[kQ / 8][4] = {}, cb[kQ / 8][4] = {};
    band(yx, sY, ldp, sX, ldp, p, ra, 0, 2 * warp + 2);
    band(cb, sC, ldn, sB, ldn, n, ra, 0, 2 * warp + 2);
    float* wa = sW + ra * kQ1;
    float* wb = sW + rb * kQ1;
#pragma unroll
    for (int nt = 0; nt < kQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * q + e;
        const float dj = dts[j], aj = acs[j];
        const float m_a = j <= ra ? yx[nt][e] * decay(ea - aj) : 0.f;
        const float m_b = j <= rb ? yx[nt][2 + e] * decay(eb - aj) : 0.f;
        wa[j] = m_a * cb[nt][e] * dj;
        wb[j] = m_b * cb[nt][2 + e] * dj;
        yx[nt][e] = m_a * dj;
        yx[nt][2 + e] = m_b * dj;
      }
    to_a_split(yx, mh, ml);
  }
  float pa = 0.f, pb = 0.f;
  for (int pp = 0; pp < n / 16; ++pp) {
    float ih[2][4] = {}, il[2][4] = {}, sh[2][4] = {}, sl[2][4] = {};
    split_product(ih, il, mh, ml, sB, ldn, pp * 16, 0, warp + 1);
    if (has_s)
      planes_t_product(sh, sl, sY, ldp, sSh, sSl, ldp, p, ra, pp * 16);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = pp * 16 + 8 * u + 2 * q;
      float s[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // the small parts first
        s[i] = sl[u][i] + sh[u][i];
        d[i] = (i < 2 ? e_a : e_b) * s[i] + (il[u][i] + ih[u][i]);
      }
      if (ra < rows) store2(A.dc_part + row_a * n + col, d[0], d[1]);
      if (rb < rows) store2(A.dc_part + row_b * n + col, d[2], d[3]);
      pa += to_f(sC[ra * ldn + col]) * s[0] +
            to_f(sC[ra * ldn + col + 1]) * s[1];
      pb += to_f(sC[rb * ldn + col]) * s[2] +
            to_f(sC[rb * ldn + col + 1]) * s[3];
    }
  }
  pa = quad_sum(pa);
  pb = quad_sum(pb);
  if (q == 0) {
    vv[ra] = e_a * pa;
    vv[rb] = e_b * pb;
  }

  // X.dY^T over the anti-causal band tau >= t: M1^T as A fragments; then
  // u = M1^T.C + exp(a_last - a_cs_t) G_out x_t, dB = dt_t u, and
  // B_t . (G_out x_t) and B_t . u.
  {
    float xy[kQ / 8][4] = {};
    band(xy, sX, ldp, sY, ldp, p, ra, 2 * warp, kQ / 8);
    anti_mask(xy, acs, ra);
    to_a_split(xy, mh, ml);
  }
  float wa = 0.f, wb = 0.f;
  pa = pb = 0.f;
  for (int pp = 0; pp < n / 16; ++pp) {
    float uh[2][4] = {}, ul[2][4] = {}, gh[2][4] = {}, gl[2][4] = {};
    split_product(uh, ul, mh, ml, sC, ldn, pp * 16, warp, kQ / 16);
    if (has_g)
      planes_t_product(gh, gl, sX, ldp, sGh, sGl, ldp, p, ra, pp * 16);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = pp * 16 + 8 * u + 2 * q;
      float gx[4], uu[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gx[i] = gl[u][i] + gh[u][i];
        uu[i] = (ul[u][i] + uh[u][i]) + (i < 2 ? f_a : f_b) * gx[i];
      }
      if (ra < rows)
        store2(A.db_part + row_a * n + col, d_a * uu[0], d_a * uu[1]);
      if (rb < rows)
        store2(A.db_part + row_b * n + col, d_b * uu[2], d_b * uu[3]);
      const float b0 = to_f(sB[ra * ldn + col]),
                  b1 = to_f(sB[ra * ldn + col + 1]),
                  b2 = to_f(sB[rb * ldn + col]),
                  b3 = to_f(sB[rb * ldn + col + 1]);
      wa += b0 * gx[0] + b1 * gx[1];
      wb += b2 * gx[2] + b3 * gx[3];
      pa += b0 * uu[0] + b1 * uu[1];
      pb += b2 * uu[2] + b3 * uu[3];
    }
  }
  wa = quad_sum(wa);
  wb = quad_sum(wb);
  pa = quad_sum(pa);
  pb = quad_sum(pb);
  if (q == 0) {
    ww[ra] = f_a * d_a * wa;
    ww[rb] = f_b * d_b * wb;
    qq[ra] = pa;
    qq[rb] = pb;
  }

  // B.C^T over the anti-causal band: M3^T as A fragments; then dx =
  // dt_t (M3^T.dY + exp(a_last - a_cs_t) B_t G_out).
  {
    float bc[kQ / 8][4] = {};
    band(bc, sB, ldn, sC, ldn, n, ra, 2 * warp, kQ / 8);
    anti_mask(bc, acs, ra);
    to_a_split(bc, mh, ml);
  }
  bf16* dx = static_cast<bf16*>(A.dx);
  for (int pp = 0; pp < p / 16; ++pp) {
    float xh[2][4] = {}, xl[2][4] = {}, gh[2][4] = {}, gl[2][4] = {};
    split_product(xh, xl, mh, ml, sY, ldp, pp * 16, warp, kQ / 16);
    if (has_g)
      planes_product(gh, gl, sB, ldn, sGh, sGl, ldp, n, ra, pp * 16);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = pp * 16 + 8 * u + 2 * q;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (i < 2 ? d_a : d_b) *
               ((xl[u][i] + xh[u][i]) +
                (i < 2 ? f_a : f_b) * (gl[u][i] + gh[u][i]));
      if (ra < rows) store2(dx + row_a * p + col, v[0], v[1]);
      if (rb < rows) store2(dx + row_b * p + col, v[2], v[3]);
    }
  }

  __syncwarp();  // this warp's rows of W are in shared memory
  for (int tau = warp * 16; tau < warp * 16 + 16; ++tau)
    prefix_row(sW + tau * kQ1, lane);
  __syncthreads();
  if (tid < kQ) {  // the rectangle tau >= t > j
    float r = 0.f;
    for (int tau = tid; tau < rows; ++tau) r += sW[tau * kQ1 + tid];
    rect[tid] = r;
  }
  __syncthreads();
  if (warp == 0)
    finish_dlog(A, b, h, t0, rows, at, a_last, dts, vv, ww, qq, rect, red,
                kThreads / 32);
}

// ---- the passes ----

template <typename T>
size_t chunk_smem(int n, int p) {
  if constexpr (sizeof(T) == 4)
    return sizeof(float) * (2 * (size_t)kQ * (n + 1) +
                            2 * (size_t)kQ * (p + 1) + 4 * kQ);
  else
    return sizeof(T) * 2 * (size_t)kQ * (n + pad<T>() + p + pad<T>()) +
           sizeof(float) * 4 * kQ;
}

template <typename T>
size_t out_smem(int n, int p) {
  if constexpr (sizeof(T) == 4)
    return sizeof(float) * (2 * (size_t)kQ * (p + 1) +
                            2 * (size_t)kQ * (n + 1) +
                            2 * (size_t)n * (p + 1) + 3 * kQ * kQ1 + 6 * kQ +
                            8);
  else
    return sizeof(T) * (2 * (size_t)kQ * (p + pad<T>()) +
                        2 * (size_t)kQ * (n + pad<T>()) +
                        4 * (size_t)n * (p + pad<T>())) +
           sizeof(float) * (kQ * kQ1 + 6 * kQ + 4);
}

template <typename T>
constexpr int out_threads() {
  return sizeof(T) == 4 ? kOutThreads32 : kThreads;
}

// Pass 1: S_own (unless the chunk is the last), D_own (unless it is the
// first) and a_last of chunk blockIdx.x of head blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_chunk(BwdArgs A) {
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / A.h, h = bh % A.h;
  const int t0 = c * kQ, rows = min(kQ, A.L - t0);
  const int n = A.n, p = A.p;
  const bool own_s = c + 1 < A.nc, own_g = c > 0;  // what bwd_carry reads
  const int tid = threadIdx.x;
  const int64_t at = (int64_t)bh * A.nc + c;
  float* const s_own = A.chunk_s + at * n * p;
  float* const d_own = A.chunk_g + at * n * p;
  if constexpr (sizeof(T) == 4) {
    const int ldn = n + 1, ldp = p + 1;
    extern __shared__ float smf[];
    float* sB = smf;               // [kQ][ldn]
    float* sC = sB + kQ * ldn;     // [kQ][ldn]
    float* sX = sC + kQ * ldn;     // [kQ][ldp]
    float* sY = sX + kQ * ldp;     // [kQ][ldp]
    float* dts = sY + kQ * ldp;
    float* acs = dts + kQ;
    float* wj = acs + kQ;          // exp(a_last - a_cs_j) dt_j
    float* wc = wj + kQ;           // exp(a_cs_t), 0 past rows
    load_chunk(A, b, h, t0, rows, sB, sC, sX, sY, dts, acs);
    const float a_last = acs[rows - 1];
    if (tid < kQ) {
      wj[tid] = decay(a_last - acs[tid]) * dts[tid];
      wc[tid] = tid < rows ? decay(acs[tid]) : 0.f;
    }
    if (tid == 0) A.chunk_a[at] = a_last;
    __syncthreads();
    if (own_s) own_state<1>(sB, ldn, sX, ldp, wj, n, p, s_own);
    if (own_g) own_state<1>(sC, ldn, sY, ldp, wc, n, p, d_own);
  } else {
    constexpr int E = pad<T>();
    const int grp = h / (A.h / A.g), ldn = n + E, ldp = p + E;
    extern __shared__ __align__(16) unsigned char smem[];
    T* sB = reinterpret_cast<T*>(smem);  // [kQ][ldn]
    T* sC = sB + kQ * ldn;               // [kQ][ldn]
    T* sX = sC + kQ * ldn;               // [kQ][ldp]
    T* sY = sX + kQ * ldp;               // [kQ][ldp]
    float* dts = reinterpret_cast<float*>(sY + kQ * ldp);
    float* acs = dts + kQ;
    float* wj = acs + kQ;
    float* wc = wj + kQ;
    if (own_s) {
      load_tile(sB, ldn,
                static_cast<const T*>(A.bm) + b * A.sb.b +
                    (int64_t)t0 * A.sb.l + grp * A.sb.h,
                A.sb.l, rows, n);
      load_tile(sX, ldp,
                static_cast<const T*>(A.x) + b * A.sx.b +
                    (int64_t)t0 * A.sx.l + h * A.sx.h,
                A.sx.l, rows, p);
    }
    if (own_g) {
      load_tile(sC, ldn,
                static_cast<const T*>(A.cm) + b * A.sc.b +
                    (int64_t)t0 * A.sc.l + grp * A.sc.h,
                A.sc.l, rows, n);
      load_tile(sY, ldp,
                static_cast<const T*>(A.dy) + b * A.sdy.b +
                    (int64_t)t0 * A.sdy.l + h * A.sdy.h,
                A.sdy.l, rows, p);
    }
    chunk_decay(A.a[h], load_dt(A.dt, A.sdt, b, h, t0, rows), dts, acs);
    const float a_last = acs[rows - 1];
    if (tid < kQ) {
      wj[tid] = decay(a_last - acs[tid]) * dts[tid];
      wc[tid] = tid < rows ? decay(acs[tid]) : 0.f;
    }
    if (tid == 0) A.chunk_a[at] = a_last;
    cp_async_wait_all();
    __syncthreads();
    // the forward's chunk_state, B * w and C * exp(a_cs) in hi + lo
    if (own_s) own_state<2>(sB, ldn, sX, ldp, wj, n, p, s_own);
    if (own_g) own_state<2>(sC, ldn, sY, ldp, wc, n, p, d_own);
  }
}

// Pass 2: the states forward (z = 0) and their adjoint in reverse (z =
// 1): in place (fp32) or into hi and lo planes (bf16).
template <typename T>
__global__ void __launch_bounds__(kStateThreads) bwd_carry(BwdArgs A) {
  constexpr StateOut kOut = sizeof(T) == 4 ? kInPlace : kSplit;
  const bool adjoint = blockIdx.z == 1;
  carry_states<kOut>(A.chunk_a, adjoint ? A.chunk_g : A.chunk_s,
                     adjoint ? A.g16 : A.s16, nullptr, A.nc,
                     A.n * A.p / 4, adjoint);
}

// Pass 3: dx, d(dt), the head's dB and dC and its da partial for chunk
// blockIdx.x of head blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(out_threads<T>()) bwd_out(BwdArgs A) {
  if constexpr (sizeof(T) == 4)
    out_fp32(A);
  else
    out_mma(A);
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
  const size_t s1 = chunk_smem<T>(A.n, A.p), s3 = out_smem<T>(A.n, A.p);
  if (s1 > kMaxSmem || s3 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(bwd_chunk<T>, s1, allowed_chunk);
  if (e == cudaSuccess) e = allow_smem(bwd_out<T>, s3, allowed_out);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(A.nc, bh);
  if (A.nc > 1) {  // one chunk: S_in and G_out are zero, never read
    bwd_chunk<T><<<grid, kThreads, s1, stream>>>(A);
    const int np4 = A.n * A.p / 4;
    bwd_carry<T><<<dim3((np4 + kStateThreads - 1) / kStateThreads, bh, 2),
                   kStateThreads, 0, stream>>>(A);
  }
  bwd_out<T><<<grid, out_threads<T>(), s3, stream>>>(A);
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
// innermost dimension is contiguous; in bf16 the rows of x, b, c and dy,
// their base pointers and strides are 16-byte aligned.  dx [bsz, L, h, p],
// ddt [bsz, L, h], da [h], db and dc [bsz, L, g, n] are written whole,
// contiguous.  n, p multiples of 4 (fp32) or of 16 (bf16), bwd_out's
// shared memory within a block's (out_smem: at P 64, N up to 140 in fp32
// and up to 224 in bf16).  scratch: float32 of (2 fp32, 4 bf16) * bsz * h
// * chunks * n * p + 2 * bsz * h * chunks + 2 * bsz * L * h * n, chunks =
// ceil(L / 64).
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* a, const void* b,
                                   const void* c, const void* dy, void* dx,
                                   void* ddt, void* da, void* db, void* dc,
                                   void* scratch, const int64_t* dims,
                                   int dtype, void* stream) {
  const int64_t bsz = dims[0], L = dims[1], h = dims[2], g = dims[3],
                n = dims[4], p = dims[5];
  if (bsz <= 0 || L <= 0 || h <= 0) return 0;
  const bool bf16_in = dtype == 1;
  if ((dtype != 0 && !bf16_in) || g <= 0 || h % g != 0 || n <= 0 || p <= 0 ||
      (bf16_in ? (n % 16 || p % 16) : (n % 4 || p % 4)) || bsz * h > 65535 ||
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
  // scratch: S_own, D_own [bsz*h, chunks, n, p] fp32; (bf16) S_in's and
  // G_out's hi and lo planes [bsz*h, chunks, 2, n, p] bf16; chunk_a and
  // the da partials [bsz*h, chunks]; the dB and dC partials
  const int64_t heads = bsz * h, states = heads * A.nc * n * p;
  A.chunk_s = static_cast<float*>(scratch);
  A.chunk_g = A.chunk_s + states;
  float* rest = A.chunk_g + states;
  A.s16 = A.g16 = nullptr;
  if (bf16_in) {
    A.s16 = reinterpret_cast<bf16*>(rest);
    A.g16 = A.s16 + 2 * states;
    rest += 2 * states;
  }
  A.chunk_a = rest;
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
  return bf16_in ? launch<bf16>(A, bh, s) : launch<float>(A, bh, s);
}
