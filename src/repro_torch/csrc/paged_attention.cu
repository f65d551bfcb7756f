// Single-token (decode) attention over a page pool through a page table,
// query heads grouped per kv head, fp32 online softmax, for bf16 or fp32
// q and pages of head_dim 64, 128 or 256, over the whole prefix or over a
// sliding window of its last `window` tokens.
//
// Replaces the paged_attention TPU kernel: src/repro/kernels/
// paged_attention/kernel.py, _paged_kernel / paged_attention_call (wrapper
// ops.py, oracle ref.py).  There the grid is (B, Hkv, MAXP) with the page
// sweep as the sequential minor dimension, the page table and lengths in
// SMEM by scalar prefetch, each step's BlockSpec picking page pt[b, p] out
// of HBM, the running max, sum and accumulator in VMEM scratch, and pages
// past the length skipped with pl.when.
//
// Bound on the H100: memory.  The function reads each live token's K and V
// rows once (2 * length * D * bytes per kv head) and does 4 * D operations
// per (query head, token): with G <= 8 query rows per kv head that is a few
// operations per byte, far below the ~295 per byte where the tensor cores
// would bind, so the products stay on the CUDA cores in fp32 and the design
// is about keeping enough bytes in flight:
//
// * A sliding window (gemma3's local layers; the reference's attn_decode
//   masks pos - kj < window with pos = length - 1) makes the live tokens
//   [lo, length) with lo = max(0, length - window), and the block visits
//   only those: a local layer's decode costs its window, not its prefix.
//   lo need not be page-aligned; the first live page is read from row
//   lo % PS on, and no page-table entry or page row before lo is read.
// * Split over blocks (flash-decoding).  The grid is (kv head, sequence,
//   split); split z owns tokens [lo + z * split_tokens, lo + (z + 1) *
//   split_tokens) of its sequence, clipped to min(length, MAXP * PS).  The
//   wrapper picks the split from the span min(MAXP * PS, window), B * Hkv,
//   the SM count and the blocks that fit an SM at this D (ops.py,
//   split_plan), never from the device-side lengths, so nothing syncs.  A
//   split past the length writes an empty partial (m = -1e30, l = 0) and
//   exits; the others write their (m, l, unnormalised acc) for their G
//   rows to fp32 scratch, and paged_combine merges them in split order
//   (rescale by exp(m_i - m), sum, divide by max(l, 1e-30)).  With one
//   split the block writes the output itself.
// * A ring of kStages cp.async stages of raw K/V tiles of 32 tokens.  Each
//   token row is 16-byte chunks gathered through its own page-table entry
//   (page_table[b, tok / PS], row tok % PS), so a tile may span pages and
//   any page size works; rows past the split's end are zero-filled without
//   a read, so neither a page-table entry nor a page row past the length is
//   ever read.  While tile t is scored, tiles t+1 and t+2 are in flight.
//   Chunk c of row r sits at chunk c ^ (r & 7) of its row (XOR swizzle), so
//   the lanes that read one column of eight rows hit eight different banks.
// * Each warp owns 8 tokens of a tile and keeps its own online softmax:
//   lane l scores token l & 7 over quarter l >> 3 of D against every query
//   row (q in shared memory as fp32, broadcast), two shuffles finish the
//   dot product, and the lane then accumulates D / 32 output columns of the
//   G rows over the warp's 8 tokens.  bf16 is widened to fp32 in registers
//   at use.  The four warps' (m, l, acc) merge once, at the end of the
//   block.  Semantics are the reference's: logits of masked keys are -1e30,
//   masked probabilities are zero, the output is acc / max(l, 1e-30), so a
//   length of 0 gives zeros; expf (not __expf) throughout, and bf16 rounds
//   once, at the end.
// * Where the caller asks for it, each output row's fp32 log-sum-exp
//   m + log(l) over its live tokens (-1e30 for a row with none, the
//   reference's masked max) goes to lse[b * hq + head]: written where the
//   row's output is, by the single split's store or by paged_combine, so a
//   sequence-sharded decode can merge the rows of several caches
//   (distributed/flash_decode.py).  The output is the same with or without.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;         // tokens per tile: 8 per warp
constexpr int kStages = 3;      // cp.async ring depth
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

// Widen N elements of T at shared address p (N * sizeof(T) bytes, aligned
// to that size) to fp32.
template <typename T, int N>
__device__ __forceinline__ void widen(const unsigned char* p, float* out);
template <>
__device__ __forceinline__ void widen<float, 4>(const unsigned char* p,
                                                float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
template <>
__device__ __forceinline__ void widen<float, 2>(const unsigned char* p,
                                                float* out) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  out[0] = x.x; out[1] = x.y;
}
template <int N>
__device__ __forceinline__ void widen_bf16(const unsigned char* p,
                                           float* out) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16, 8>(
    const unsigned char* p, float* out) { widen_bf16<8>(p, out); }
template <>
__device__ __forceinline__ void widen<__nv_bfloat16, 4>(
    const unsigned char* p, float* out) { widen_bf16<4>(p, out); }
template <>
__device__ __forceinline__ void widen<__nv_bfloat16, 2>(
    const unsigned char* p, float* out) { widen_bf16<2>(p, out); }

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D>
struct Cfg {
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int CPR = D / EPC;              // chunks per row
  static constexpr int ROW = D * (int)sizeof(T);   // bytes per row
  static constexpr int TILE = kTK * ROW;           // bytes of a K or V tile
  static constexpr int STAGE = 2 * TILE;           // K tile then V tile
  static constexpr int QCH = CPR / 4;              // chunks per quarter row
  static constexpr int CPL = D / 32;               // output columns a lane
  // a lane's CPL columns of a V row: VN reads of VW elements (two 16-byte
  // chunks for fp32 at D 256, part of one chunk otherwise)
  static constexpr int VW =
      CPL * (int)sizeof(T) <= 16 ? CPL : 16 / (int)sizeof(T);
  static constexpr int VN = CPL / VW;
  static constexpr int RING = kStages * STAGE;
  static constexpr size_t SMEM =
      (size_t)RING + sizeof(float) * (kMaxG * D + kWarps * 8 * kMaxG);
  static_assert(CPR >= 8, "the swizzle needs eight chunks per row");
  static_assert(kWarps * (kMaxG * D + 2 * kMaxG) * sizeof(float) <= RING,
                "the warp merge reuses the ring");
};

// bf16: four blocks of <= 128 registers and 53 KB (D 128) share an SM; at
// D 256 (105 KB) two, whose 255 registers hold the 64 accumulators a lane
// keeps; fp32 takes 201 KB at D 256, one block
template <typename T, int D>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 2 ? (D == 256 ? 2 : 4) : 1)
paged_split(const T* __restrict__ q, const T* __restrict__ kp,
            const T* __restrict__ vp, const int* __restrict__ page_table,
            const int* __restrict__ lengths, T* __restrict__ o,
            float* __restrict__ part, float* __restrict__ lse, int hkv, int g,
            int ps, int maxp, int split_tokens, float scale, int window) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem + C::RING);   // [kMaxG][D]
  float* sp = sq + kMaxG * D;                             // [warp][8][kMaxG]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int ns = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * g;
  const int length = lengths[b];
  const long long cap = (long long)maxp * ps;
  const int n_tok = length <= 0 ? 0 : (int)(length < cap ? length : cap);
  const int lo = window > 0 && length > window ? length - window : 0;
  const int t_begin = lo + split * split_tokens;
  const int t_end = min(t_begin + split_tokens, n_tok);
  // partials of row (b, h * g + gi, split): m, l at part[2 * i], acc at
  // part[2 * rows * ns + D * i], i = (b * hq + h * g + gi) * ns + split
  const size_t rows_ns = (size_t)gridDim.y * hq * ns;
  const size_t prow = ((size_t)b * hq + (size_t)h * g) * ns + split;
  if (ns > 1 && t_begin >= n_tok) {       // empty split
    if (tid < g) {
      part[2 * (prow + (size_t)tid * ns)] = kNegInf;
      part[2 * (prow + (size_t)tid * ns) + 1] = 0.f;
    }
    return;
  }

  const size_t q_off = ((size_t)b * hkv + h) * (size_t)g * D;
  for (int i = tid; i < g * D; i += kThreads)
    sq[i] = to_f(q[q_off + i]);
  const int* pt = page_table + (size_t)b * maxp;
  const size_t row_stride = (size_t)hkv * D;    // between rows of a page
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kTK - 1) / kTK : 0;

  // thread tid copies chunk tid % CPR of rows tid / CPR + j * (kThreads /
  // CPR) of the K and the V tile: one page lookup per row for both
  auto load_tile = [&](int i) {
    const int t0 = t_begin + i * kTK;
    const uint32_t base = ring + (i % kStages) * C::STAGE;
    const int c = tid % C::CPR;
#pragma unroll
    for (int j = 0; j < kTK * C::CPR / kThreads; ++j) {
      const int r = tid / C::CPR + j * (kThreads / C::CPR);
      const int tok = t0 + r;
      const uint32_t dst = base + r * C::ROW + ((c ^ (r & 7)) << 4);
      if (tok < t_end) {
        const int page = tok / ps;
        const size_t off =
            ((size_t)pt[page] * ps + (tok - page * ps)) * row_stride +
            (size_t)h * D + c * C::EPC;
        cp_async16(dst, kp + off, 16);
        cp_async16(dst + C::TILE, vp + off, 16);
      } else {
        cp_async16(dst, kp, 0);
        cp_async16(dst + C::TILE, kp, 0);
      }
    }
  };

  float m[kMaxG], l[kMaxG], acc[kMaxG][C::CPL];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < C::CPL; ++e) acc[gi][e] = 0.f;
  }
  const int r = warp * 8 + (lane & 7);    // this lane's token row of a tile
  const int qq = lane >> 3;               // its quarter of D
  float* wp = sp + warp * 8 * kMaxG;
  // this lane's output columns lie in one chunk of each V row
  const int vbyte = lane * C::CPL * (int)sizeof(T);

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();       // tile i has landed (this thread's)
    __syncthreads();                    // ... everyone's; tile i-1 is done
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + (i % kStages) * C::STAGE;
    const unsigned char* krow = st + r * C::ROW;
    float s[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) s[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < C::QCH; ++j) {
      const int c = qq * C::QCH + j;
      float kx[C::EPC];
      widen<T, C::EPC>(krow + ((c ^ (r & 7)) << 4), kx);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          const float* qr = sq + gi * D + c * C::EPC;
#pragma unroll
          for (int e = 0; e < C::EPC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            s[gi] = fmaf(qv.x, kx[e], s[gi]);
            s[gi] = fmaf(qv.y, kx[e + 1], s[gi]);
            s[gi] = fmaf(qv.z, kx[e + 2], s[gi]);
            s[gi] = fmaf(qv.w, kx[e + 3], s[gi]);
          }
        }
      }
    }
    const bool live = t_begin + i * kTK + r < t_end;
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        float x = s[gi];
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        x = live ? x * scale : kNegInf;
        float mx = x;
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[gi], mx);
        const float p = live ? expf(x - m_new) : 0.f;
        const float alpha = expf(m[gi] - m_new);
        m[gi] = m_new;
        l[gi] = alpha * l[gi] + p;     // this lane's tokens; summed at the end
#pragma unroll
        for (int e = 0; e < C::CPL; ++e) acc[gi][e] *= alpha;
        if (qq == 0) wp[(lane & 7) * kMaxG + gi] = p;
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int rr = warp * 8 + t;
      float vx[C::CPL];
#pragma unroll
      for (int u = 0; u < C::VN; ++u) {
        const int vb = vbyte + u * 16;
        widen<T, C::VW>(st + C::TILE + rr * C::ROW +
                            ((((vb >> 4) ^ (rr & 7)) << 4) | (vb & 15)),
                        vx + u * C::VW);
      }
      const float4 p0 = *reinterpret_cast<const float4*>(wp + t * kMaxG);
      const float4 p1 = *reinterpret_cast<const float4*>(wp + t * kMaxG + 4);
      const float pv[kMaxG] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g)
#pragma unroll
          for (int e = 0; e < C::CPL; ++e)
            acc[gi][e] = fmaf(pv[gi], vx[e], acc[gi][e]);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the merge

  // merge the four warps: [warp][gi] m and l, then [warp][gi][D] acc
  float* cm = reinterpret_cast<float*>(smem);
  float* cl = cm + kWarps * kMaxG;
  float* ca = cl + kWarps * kMaxG;
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
      float x = l[gi];
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) {
        cm[warp * kMaxG + gi] = m[gi];
        cl[warp * kMaxG + gi] = x;
      }
#pragma unroll
      for (int e = 0; e < C::CPL; ++e)
        ca[(warp * kMaxG + gi) * D + lane * C::CPL + e] = acc[gi][e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int gi = idx / D, d = idx % D;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, cm[w * kMaxG + gi]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = expf(cm[w * kMaxG + gi] - mb);
      lb = fmaf(sc, cl[w * kMaxG + gi], lb);
      ab = fmaf(sc, ca[(w * kMaxG + gi) * D + d], ab);
    }
    if (ns == 1) {
      store(o + q_off + idx, ab / fmaxf(lb, 1e-30f));
      if (lse != nullptr && d == 0)
        lse[q_off / D + gi] = lb > 0.f ? mb + logf(lb) : kNegInf;
    } else {
      const size_t pi = prow + (size_t)gi * ns;
      part[2 * rows_ns + pi * D + d] = ab;
      if (d == 0) {
        part[2 * pi] = mb;
        part[2 * pi + 1] = lb;
      }
    }
  }
}

// One block per output row (b, query head), one thread per column: merge
// the row's ns partials in split order.  An empty split has l = 0 (a live
// one has l >= 1: its largest logit contributes exp(0)) and gets weight 0,
// so a sequence with no live token gives 0 / 1e-30 = 0.  The weights
// exp(m_i - m) are computed once per split into shared memory, and the
// column loop loads 16 partial accumulators at a time, so their latencies
// overlap.
constexpr int kCombineBatch = 16;

template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_combine(const float* __restrict__ part, T* __restrict__ o,
              float* __restrict__ lse, int ns, size_t rows_ns) {
  extern __shared__ float sw[];          // [ns] weights, then [ns] w * l
  float* swl = sw + ns;
  __shared__ float smax[D / 32];
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part + 2 * row * ns;
  float mx = kNegInf;
  for (int i = d; i < ns; i += D)
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((d & 31) == 0) smax[d >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < D / 32; ++w) mx = fmaxf(mx, smax[w]);
  for (int i = d; i < ns; i += D) {
    const float li = ml[2 * i + 1];
    const float w = li > 0.f ? expf(ml[2 * i] - mx) : 0.f;
    sw[i] = w;
    swl[i] = w * li;
  }
  __syncthreads();
  float lsum = 0.f, a = 0.f;
  const float* pa = part + 2 * rows_ns + row * ns * D + d;
  for (int i0 = 0; i0 < ns; i0 += kCombineBatch) {
    float x[kCombineBatch];
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j)   // unwritten if split empty
      x[j] = i0 + j < ns ? pa[(size_t)(i0 + j) * D] : 0.f;
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      if (i0 + j < ns && sw[i0 + j] > 0.f) {
        lsum += swl[i0 + j];
        a = fmaf(sw[i0 + j], x[j], a);
      }
    }
  }
  store(o + row * D + d, a / fmaxf(lsum, 1e-30f));
  if (lse != nullptr && d == 0)
    lse[row] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* lengths, void* o, void* part, void* lse, int b,
           int hkv, int g, int ps, int maxp, int ns, int split_tokens,
           float scale, int window, cudaStream_t stream) {
  using C = Cfg<T, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(hkv, b, ns);
  paged_split<T, D><<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(lengths), static_cast<T*>(o),
      static_cast<float*>(part), static_cast<float*>(lse), hkv, g, ps, maxp,
      split_tokens, scale, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ns == 1) return static_cast<int>(e);
  const size_t rows = (size_t)b * hkv * g;
  paged_combine<T, D><<<static_cast<unsigned>(rows), D,
                         2 * sizeof(float) * ns, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(o),
      static_cast<float*>(lse), ns, rows * ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 64, 128 or 256; window <= 0 =
// global, else the live tokens are [max(0, length - window), length).
// q, o: [b, hq, d]; k, v: [n_pages, ps, hkv, d]; page_table: [b, maxp]
// int32; lengths: [b] int32; all contiguous, q/k/v 16-byte aligned.  ns
// splits of split_tokens (a multiple of 32) tokens each, ns <= 4096, whose
// ns * split_tokens cover min(maxp * ps, window); with ns > 1, part is
// fp32 scratch of b * hq * ns * (d + 2) floats.  lse: nullptr, or fp32
// [b, hq] for each row's log-sum-exp.  Both kernels go on one stream.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* page_table,
                                      const void* lengths, void* o,
                                      void* part, void* lse, int b, int hq,
                                      int hkv, int d, int ps, int maxp,
                                      int ns, int split_tokens, float scale,
                                      int window, int dtype, void* stream) {
  if (b <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxG || ps <= 0 || maxp < 0 ||
      b > 65535 || ns < 1 || ns > 4096 || split_tokens <= 0 ||
      split_tokens % kTK != 0 || (ns > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
#define PAGED_CASE(DT, T, DIM)                                               \
  if (dtype == DT && d == DIM)                                               \
    return launch<T, DIM>(q, k, v, page_table, lengths, o, part, lse, b,     \
                          hkv, g, ps, maxp, ns, split_tokens, scale, window, \
                          st);
  PAGED_CASE(0, float, 64)
  PAGED_CASE(0, float, 128)
  PAGED_CASE(0, float, 256)
  PAGED_CASE(1, __nv_bfloat16, 64)
  PAGED_CASE(1, __nv_bfloat16, 128)
  PAGED_CASE(1, __nv_bfloat16, 256)
#undef PAGED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
