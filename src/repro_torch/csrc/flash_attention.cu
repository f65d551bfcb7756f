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
// this thread's finished generic-proxy (cp.async) writes to shared memory
// become visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 2^x on the special-function unit, subnormal results flushed to zero (a
// probability below 2^-126 of the row's largest adds nothing to a sum >= 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers' values at this point of the instruction stream: reads
// and writes of them stay on their side of a wgmma's launch and wait.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (layout type
// 1 in bits 62-63): start address, leading and stride byte offsets, all in
// 16-byte units.  Tiles start 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk c (8 bf16) of row r in a tile of `rows` rows
// of D bf16, in the 128-byte swizzle the descriptors name: 64-column blocks
// of rows * 128 bytes one after another, 128 bytes per row, and chunk c & 7
// of a row at c & 7 ^ r & 7.  Q and K (K-major operands) and V (the
// MN-major B of P.V) all use it.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// d (64 x 64, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 64,
// bf16, shared, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, fp32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 32,
// bf16, shared, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The scores of a BK-key tile: Q.K^T as one wgmma of N = BK.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n32(d, da, db, scale_d);
}

// d (64 x 64, fp32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared, MN-major: the descriptor's transpose).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// shared, MN-major: the descriptor's transpose).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, bf16, registers) * B (16 x 256, bf16,
// shared, MN-major: the descriptor's transpose).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64(acc, a, db);
  else if constexpr (D == 128)
    wgmma_rs_n128(acc, a, db);
  else
    wgmma_rs_n256(acc, a, db);
}

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
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
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

  for (int idx = tid; idx < kBQ * CPR; idx += kWgThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = q0 + r < s;
    cp_async16(sq + swz(r, c, kBQ),
               in ? qg + (size_t)(q0 + r) * D + c * 8 : qg, in ? 16 : 0);
  }
  cp_async_commit();
  auto load_tile = [&](int i) {
    const int k0 = (kt_lo + i) * BK;
    const uint32_t base = skv + (i % NS) * C::STAGE;
#pragma unroll
    for (int j = 0; j < 2 * BK * CPR / kWgThreads; ++j) {
      const int idx = tid + j * kWgThreads;
      const int kv = idx / (BK * CPR);
      const int r = (idx / CPR) % BK, c = idx % CPR;
      const bool in = k0 + r < s_k;
      const __nv_bfloat16* src = kv ? vg : kg;
      cp_async16(base + kv * C::T_BYTES + swz(r, c, BK),
                 in ? src + (size_t)(k0 + r) * D + c * 8 : kg, in ? 16 : 0);
    }
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
      wgmma_qk<BK>(sc,
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
    for (int j = 0; j < BK / 16; ++j) {
      split(sc[8 * j + 0], sc[8 * j + 1], ph[j][0], pl[j][0]);
      split(sc[8 * j + 2], sc[8 * j + 3], ph[j][1], pl[j][1]);
      split(sc[8 * j + 4], sc[8 * j + 5], ph[j][2], pl[j][2]);
      split(sc[8 * j + 6], sc[8 * j + 7], ph[j][3], pl[j][3]);
    }
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
      wgmma_pv<D>(acc, ph[j], db);
      wgmma_pv<D>(acc, pl[j], db);
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
