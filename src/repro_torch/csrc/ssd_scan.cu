// Mamba2 SSD scan: s_t = exp(dt_t a) s_{t-1} + dt_t B_t x_t^T, y_t = C_t s_t
// per head, for bf16 or fp32 x/B/C, fp32 dt and a, fp32 arithmetic.  dt
// stays fp32 with bf16 x, B and C because the model feeds y the fp32
// softplus output, as the reference's default route (ssd_scan_ref)
// computes it.
// Writes y and the final state s_L (fp32), which a prefill hands to decode.
//
// Replaces the ssd_scan TPU kernel: src/repro/kernels/ssd_scan/kernel.py,
// _ssd_kernel / ssd_scan_call (wrapper ops.py).  There the grid is
// (BH, chunks) with the chunk sweep as the sequential minor dimension and
// the state in VMEM scratch.  On the H100 a block per head walking the
// sequence leaves most SMs idle and waits on every load, so the sequence
// is split over blocks in Mamba2's own chunked form, three passes over
// chunks of 64 steps (a_cs = a * inclusive cumsum(dt) within a chunk):
//
//   chunk_state  grid (chunk, head): the chunk's own end state
//                S_own = sum_j exp(a_cs_last - a_cs_j) dt_j B_j x_j^T and
//                its decay a_cs_last, to fp32 scratch;
//   state_pass   grid (N*P / 1024, head): sequential over chunks, parallel
//                over the state, S_in(c) = exp(a_last(c-1)) S_in(c-1) +
//                S_own(c-1), written over S_own (fp32) or as bf16 hi and
//                lo planes (bf16 inputs); the last one is s_L;
//   chunk_out    grid (chunk, head): y_t = exp(a_cs_t) C_t S_in(c) +
//                sum_{j<=t} (C_t . B_j) exp(a_cs_t - a_cs_j) dt_j x_j;
//                eight warps instead of four (two per 16 rows, each half
//                of y's columns) when the grid fills at most 4 blocks per
//                SM, as at a serving prefill, where a block's latency sets
//                the kernel's time.
//
// Fusing the first two passes (each block walking the chunks in order for
// 16 state rows, the next chunks' tiles in a cp.async ring) was measured
// slower on the H100 at 189 and 4,096 steps: its per-chunk step is a
// serial chain, while chunk_state runs every chunk at once (PERF.md).
//
// exp(a_cs_t - a_cs_j) is evaluated only for j <= t, where its argument is
// <= 0; the TPU kernel evaluates every pair and masks afterwards, which
// can overflow to inf before the mask.  The kernels read the model's
// layout through strides (x [B, L, H, P], B and C [B, L, G, N] read per
// group, dt [B, L, H]; each row contiguous and 16-byte aligned) and write
// y [B, L, H, P] in place, so the wrapper makes no padding or transposing
// copy: a chunk's rows past L are zero-filled in shared memory, with
// dt = 0, which leaves y and the state as they are.
//
// Bound on the H100: memory.  The function reads x, dt, B, C and writes y
// once (~3 MB at zamba2-1.2b's prefill of 189 tokens); its 4*N*P
// operations per step and head are far below the tensor-core rate.  Every
// chunk's x, B and C tiles arrive by cp.async, 16 bytes a thread.  bf16
// inputs run all four products on the tensor cores (mma.sync m16n8k16,
// fp32 accumulators): C.B^T from the bf16 inputs, whose products are exact
// in fp32, and the three products with an fp32 operand (the decayed C.B^T
// times X, (B * w)^T times X, C times S_in) with that operand split into
// bf16 hi + lo halves (~16 significant bits); the state pass writes S_in
// already split, so chunk_out loads it by cp.async like its other tiles.
// fp32 inputs run the same passes on the CUDA cores in fp32.
//
// The final state, which a prefill hands to decode, follows Mamba2's
// sequential fp32 scan with dt in fp32 (the reference model's
// ssd_final_state): when the caller passes an fp32 state_dt, chunk_state
// also forms each chunk's own state from it, from the tiles it already
// holds, with B * w split into three bf16 parts (~24 significant bits,
// fp32's own), and the state pass carries that second chain too (grid
// z = 1), into s_L only.  With bf16 inputs the second chain runs even when
// state_dt is y's own fp32 dt: y's chain keeps ~16 bits of B * w.

#include "ssd_scan.cuh"

namespace {

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  void* y;
  float* state;    // [B*H, N, P]
  float* chunk_s;  // [B*H, chunks, N, P]: S_own (fp32 path: then S_in)
  void* s_in16;    // bf16 path: [B*H, chunks, 2, N, P] S_in as hi, lo
  float* chunk_a;  // [B*H, chunks]: a_cs at the chunk's last step
  const float* dt_state;  // fp32 dt of the final state, or null; then
  float* chunk_s2;        // S_own and
  float* chunk_a2;        // a_cs at the last step from it
  Strides sx, sdt, sb, sc, sy, sds;
  int h, g, L, n, p, nc;
};

template <typename T>
size_t state_smem(int n, int p) {
  return sizeof(T) * (size_t)kQ * (n + pad<T>() + p + pad<T>()) +
         sizeof(float) * 6 * kQ;
}

template <typename T>
size_t out_smem(int n, int p) {
  const size_t tiles = sizeof(T) * (size_t)kQ * (2 * (n + pad<T>()) + p +
                                                 pad<T>());
  const size_t s_in = sizeof(T) == 2
                          ? 2 * sizeof(T) * (size_t)n * (p + pad<T>())
                          : sizeof(float) * ((size_t)n * p + kQ * kQ);
  return tiles + s_in + sizeof(float) * 2 * kQ;
}

// Pass 1: S_own[n][p] = sum_j B[j][n] w_j X[j][p], w_j = exp(a_last -
// a_cs_j) dt_j, and a_last, for chunk blockIdx.x of head blockIdx.y; with
// kBoth, also from A.dt_state into chunk_s2 and chunk_a2, B * w in three
// bf16 parts (y's run: two).
template <typename T, bool kBoth>
__global__ void __launch_bounds__(kThreads) chunk_state(Args A) {
  constexpr int E = pad<T>();
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / A.h, h = bh % A.h, grp = h / (A.h / A.g);
  const int t0 = c * kQ, rows = min(kQ, A.L - t0);
  const int n = A.n, p = A.p, ldn = n + E, ldp = p + E;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sB = reinterpret_cast<T*>(smem);  // [kQ][ldn]
  T* sX = sB + kQ * ldn;               // [kQ][ldp]
  float* dts = reinterpret_cast<float*>(sX + kQ * ldp);  // per run: dt,
  float* acs = dts + 2 * kQ;                             // a_cs and w
  float* wj = acs + 2 * kQ;
  load_tile(sB, ldn,
            static_cast<const T*>(A.bm) + b * A.sb.b + (int64_t)t0 * A.sb.l +
                grp * A.sb.h,
            A.sb.l, rows, n);
  load_tile(sX, ldp,
            static_cast<const T*>(A.x) + b * A.sx.b + (int64_t)t0 * A.sx.l +
                h * A.sx.h,
            A.sx.l, rows, p);
  const float2 dv = load_dt(A.dt, A.sdt, b, h, t0, rows);
  float2 dv2 = make_float2(0.f, 0.f);
  if constexpr (kBoth) dv2 = load_dt(A.dt_state, A.sds, b, h, t0, rows);
  chunk_decay(A.a[h], dv, dts, acs);
  if constexpr (kBoth) chunk_decay(A.a[h], dv2, dts + kQ, acs + kQ);
  const int tid = threadIdx.x;
  const int64_t at = (int64_t)bh * A.nc + c;
#pragma unroll
  for (int run = 0; run < (kBoth ? 2 : 1); ++run) {
    const float* ac = acs + run * kQ;
    const float a_last = ac[rows - 1];
    if (tid < kQ)  // 0 past rows
      wj[run * kQ + tid] = expf(a_last - ac[tid]) * dts[run * kQ + tid];
    if (tid == 0) (run ? A.chunk_a2 : A.chunk_a)[at] = a_last;
  }
  cp_async_wait_all();
  __syncthreads();
  own_state<2>(sB, ldn, sX, ldp, wj, n, p, A.chunk_s + at * n * p);
  if constexpr (kBoth)
    own_state<3>(sB, ldn, sX, ldp, wj + kQ, n, p, A.chunk_s2 + at * n * p);
}

// Grid (N*P / 1024, head, 1 or 2): z = 0 carries y's chain (kOut; s_L as
// well unless a final-state chain follows), z = 1 the final state's.
template <StateOut kOut>
__global__ void __launch_bounds__(kStateThreads) state_pass(Args A) {
  const int np4 = A.n * A.p / 4;
  if (blockIdx.z == 0)
    carry_states<kOut>(A.chunk_a, A.chunk_s,
                       static_cast<__nv_bfloat16*>(A.s_in16),
                       A.dt_state == nullptr ? A.state : nullptr, A.nc, np4);
  else
    carry_states<kFinal>(A.chunk_a2, A.chunk_s2, nullptr, A.state, A.nc,
                         np4);
}

// Pass 3: y_t = exp(a_cs_t) C_t S_in + sum_{j<=t} W[t][j] x_j with
// W[t][j] = (C_t . B_j) exp(a_cs_t - a_cs_j) dt_j, for chunk blockIdx.x
// of head blockIdx.y.
// kHalves 2: eight warps, warps w and w + 4 owning the same rows and each
// half of y's columns (less work per warp where the grid leaves SMs idle).
template <typename T, int kHalves>
__global__ void __launch_bounds__(kThreads * kHalves) chunk_out(Args A) {
  constexpr int kOutThreads = kThreads * kHalves;
  constexpr int E = pad<T>();
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / A.h, h = bh % A.h, grp = h / (A.h / A.g);
  const int t0 = c * kQ, rows = min(kQ, A.L - t0);
  const int n = A.n, p = A.p, ldn = n + E, ldp = p + E;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sC = reinterpret_cast<T*>(smem);  // [kQ][ldn]
  T* sB = sC + kQ * ldn;               // [kQ][ldn]
  T* sX = sB + kQ * ldn;               // [kQ][ldp]
  T* sS = sX + kQ * ldp;               // S_in: see below
  const size_t s_elems = sizeof(T) == 2 ? 2 * (size_t)n * ldp
                                        : (size_t)n * p + kQ * kQ;
  float* dts = reinterpret_cast<float*>(sS + s_elems);
  float* acs = dts + kQ;
  const int64_t gb = b * A.sb.b + (int64_t)t0 * A.sb.l + grp * A.sb.h;
  const int64_t gc = b * A.sc.b + (int64_t)t0 * A.sc.l + grp * A.sc.h;
  load_tile(sC, ldn, static_cast<const T*>(A.cm) + gc, A.sc.l, rows, n);
  load_tile(sB, ldn, static_cast<const T*>(A.bm) + gb, A.sb.l, rows, n);
  load_tile(sX, ldp,
            static_cast<const T*>(A.x) + b * A.sx.b + (int64_t)t0 * A.sx.l +
                h * A.sx.h,
            A.sx.l, rows, p);
  const float2 dv = load_dt(A.dt, A.sdt, b, h, t0, rows);
  const int tid = threadIdx.x;
  if (c > 0) {
    if constexpr (sizeof(T) == 4) {  // S_in [n][p] as it is
      const float* s_in = A.chunk_s + ((int64_t)bh * A.nc + c) * n * p;
      const uint32_t base =
          static_cast<uint32_t>(__cvta_generic_to_shared(sS));
      for (int i = tid; i < n * p / 4; i += kOutThreads)
        cp_async16(base + 16 * i, s_in + 4 * i, 16);
    } else {  // S_in's hi and lo planes, [n][ldp] each
      const T* s16 = static_cast<const T*>(A.s_in16) +
                     ((int64_t)bh * A.nc + c) * 2 * n * p;
      load_tile(sS, ldp, s16, p, n, p, n);
      load_tile(sS + (size_t)n * ldp, ldp, s16 + (size_t)n * p, p, n, p, n);
    }
  }
  chunk_decay(A.a[h], dv, dts, acs);
  cp_async_wait_all();
  __syncthreads();
  T* yg = static_cast<T*>(A.y) + b * A.sy.b + (int64_t)t0 * A.sy.l +
          h * A.sy.h;

  if constexpr (sizeof(T) == 4) {
    float* sW = sS + (size_t)n * p;  // [kQ][kQ]
    for (int i = tid; i < kQ * kQ; i += kOutThreads) {
      const int t = i / kQ, j = i - t * kQ;
      float w = 0.f;
      if (j <= t) {
        for (int e = 0; e < n; ++e) w += sC[t * ldn + e] * sB[j * ldn + e];
        w *= expf(acs[t] - acs[j]) * dts[j];
      }
      sW[i] = w;
    }
    __syncthreads();
    for (int i = tid; i < rows * p; i += kOutThreads) {
      const int t = i / p, q = i - t * p;
      float inter = 0.f, intra = 0.f;
      if (c > 0)
        for (int e = 0; e < n; ++e) inter += sC[t * ldn + e] * sS[e * p + q];
      for (int j = 0; j <= t; ++j) intra += sW[t * kQ + j] * sX[j * ldp + q];
      yg[(int64_t)t * A.sy.l + q] = expf(acs[t]) * inter + intra;
    }
  } else {
    const int lane = tid & 31, g = lane >> 2, q = lane & 3;
    const int warp = (tid >> 5) & 3, half = kHalves == 2 ? tid >> 7 : 0;
    const int ra = warp * 16 + g, rb = ra + 8;  // this thread's two rows
    // G = C.B^T for rows ra, rb and every j of the warp's causal band.
    float sc[kQ / 8][4] = {};
    band(sc, sC, ldn, sB, ldn, n, ra, 0, 2 * warp + 2);
    // W, masked to j <= t, as A fragments of W.X in hi + lo halves.
    const float ea = acs[ra], eb = acs[rb];
    uint32_t wh[kQ / 16][4], wl[kQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < kQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * q + e;
        const float dj = dts[j], aj = acs[j];
        sc[nt][e] = j <= ra ? sc[nt][e] * expf(ea - aj) * dj : 0.f;
        sc[nt][2 + e] = j <= rb ? sc[nt][2 + e] * expf(eb - aj) * dj : 0.f;
      }
    to_a_split(sc, wh, wl);
    const __nv_bfloat16* sh = sS;
    const __nv_bfloat16* sl = sS + (size_t)n * ldp;
    const float da = expf(ea), db = expf(eb);
    // Per pair of 8-column tiles, four independent accumulators each: the
    // hi and lo halves of W.X and of C.S_in.
    const int pairs = p / 16;
    const int mid = kHalves == 2 ? (pairs + 1) / 2 : pairs;
    for (int pp = half ? mid : 0; pp < (half ? pairs : mid); ++pp) {
      float ih[2][4] = {}, il[2][4] = {}, eh[2][4] = {}, el[2][4] = {};
      split_product(ih, il, wh, wl, sX, ldp, pp * 16, 0, warp + 1);
      if (c > 0) planes_product(eh, el, sC, ldn, sh, sl, ldp, n, ra, pp * 16);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = (2 * pp + u) * 8 + 2 * q;
        if (ra < rows)
          store2(yg + (int64_t)ra * A.sy.l + col,
                 da * (eh[u][0] + el[u][0]) + (ih[u][0] + il[u][0]),
                 da * (eh[u][1] + el[u][1]) + (ih[u][1] + il[u][1]));
        if (rb < rows)
          store2(yg + (int64_t)rb * A.sy.l + col,
                 db * (eh[u][2] + el[u][2]) + (ih[u][2] + il[u][2]),
                 db * (eh[u][3] + el[u][3]) + (ih[u][3] + il[u][3]));
      }
    }
  }
}

template <typename T>
int launch(const Args& A, int bh, cudaStream_t stream) {
  static size_t allowed_state = 0, allowed_both = 0, allowed_out = 0,
                allowed_out2 = 0;
  const size_t s1 = state_smem<T>(A.n, A.p), s3 = out_smem<T>(A.n, A.p);
  if (s1 > kMaxSmem || s3 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  // bf16: eight warps a chunk when the grid fills at most 4 blocks per SM
  const bool halves =
      sizeof(T) == 2 && (int64_t)A.nc * bh <= 4 * (int64_t)sm_count();
  const bool both = A.dt_state != nullptr;
  cudaError_t e = both ? allow_smem(chunk_state<T, true>, s1, allowed_both)
                       : allow_smem(chunk_state<T, false>, s1, allowed_state);
  if (e == cudaSuccess) {
    if constexpr (sizeof(T) == 2)
      e = halves ? allow_smem(chunk_out<T, 2>, s3, allowed_out2)
                 : allow_smem(chunk_out<T, 1>, s3, allowed_out);
    else
      e = allow_smem(chunk_out<T, 1>, s3, allowed_out);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(A.nc, bh);
  if (both)
    chunk_state<T, true><<<grid, kThreads, s1, stream>>>(A);
  else
    chunk_state<T, false><<<grid, kThreads, s1, stream>>>(A);
  const int np4 = A.n * A.p / 4;
  const dim3 state_grid((np4 + kStateThreads - 1) / kStateThreads, bh,
                        both ? 2 : 1);
  if constexpr (sizeof(T) == 2) {
    state_pass<kSplit><<<state_grid, kStateThreads, 0, stream>>>(A);
    if (halves)
      chunk_out<T, 2><<<grid, 2 * kThreads, s3, stream>>>(A);
    else
      chunk_out<T, 1><<<grid, kThreads, s3, stream>>>(A);
  } else {
    state_pass<kInPlace><<<state_grid, kStateThreads, 0, stream>>>(A);
    chunk_out<T, 1><<<grid, kThreads, s3, stream>>>(A);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c, y); dt is float32 [bsz, L,
// h] and a float32 [h].
// dt_state: null, or float32 [bsz, L, h] dt for the final state.
// dims (int64): bsz, L, h, g, n, p, then the (batch, step, head) strides
// in elements of x, dt, b, c, y and dt_state, whose innermost dimension is
// contiguous.  Rows of x, b, c and y, their base pointers and strides
// must be 16-byte aligned; n, p multiples of 4 (fp32) or of 16 (bf16).
// state: [bsz * h, n, p] float32, written whole.  scratch: float32 of
// bsz * h * chunks * (n * p * (1 fp32, 2 bf16; one more with dt_state) +
// (1; 2 with dt_state)), chunks = ceil(L / 64).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c,
                               const void* dt_state, void* y, void* state,
                               void* scratch, const int64_t* dims, int dtype,
                               void* stream) {
  const int64_t bsz = dims[0], L = dims[1], h = dims[2], g = dims[3],
                n = dims[4], p = dims[5];
  if (bsz <= 0 || L <= 0 || h <= 0) return 0;
  const bool bf16 = dtype == 1;
  if ((dtype != 0 && !bf16) || g <= 0 || h % g != 0 || n <= 0 || p <= 0 ||
      (bf16 ? (n % 16 || p % 16) : (n % 4 || p % 4)) || bsz * h > 65535 ||
      L > (int64_t)1 << 30)
    return static_cast<int>(cudaErrorInvalidValue);
  Args A;
  A.x = x;
  A.dt = static_cast<const float*>(dt);
  A.a = static_cast<const float*>(a);
  A.bm = b;
  A.cm = c;
  A.y = y;
  A.state = static_cast<float*>(state);
  A.dt_state = static_cast<const float*>(dt_state);
  A.nc = static_cast<int>((L + kQ - 1) / kQ);
  // scratch: S_own [bsz*h, chunks, n, p] fp32, then (bf16) S_in's hi and
  // lo planes [bsz*h, chunks, 2, n, p] bf16, then (dt_state) the final
  // state's S_own, then chunk_a and (dt_state) chunk_a2 [bsz*h, chunks]
  const int64_t states = bsz * h * A.nc * n * p;
  A.chunk_s = static_cast<float*>(scratch);
  A.s_in16 = A.chunk_s + states;
  A.chunk_s2 = A.chunk_s + (bf16 ? 2 : 1) * states;
  A.chunk_a = A.chunk_s2 + (dt_state != nullptr ? states : 0);
  A.chunk_a2 = A.chunk_a + bsz * h * A.nc;
  Strides* st[6] = {&A.sx, &A.sdt, &A.sb, &A.sc, &A.sy, &A.sds};
  for (int i = 0; i < 6; ++i) *st[i] = {dims[6 + 3 * i], dims[7 + 3 * i],
                                        dims[8 + 3 * i]};
  A.h = static_cast<int>(h);
  A.g = static_cast<int>(g);
  A.L = static_cast<int>(L);
  A.n = static_cast<int>(n);
  A.p = static_cast<int>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = static_cast<int>(bsz * h);
  return bf16 ? launch<__nv_bfloat16>(A, bh, s) : launch<float>(A, bh, s);
}
