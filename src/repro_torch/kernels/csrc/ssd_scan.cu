// ssd_scan (M1): the Mamba2 chunked SSD scan (sm_90a).
//
// Replaces no TPU kernel: the reference runs this scan as XLA einsums in a
// `lax.scan` over chunks (src/repro/models/mamba2.py:115 `chunk_body`,
// scanned at :151), and the port's eager counterpart
// (`ssd_scan.chunk_scan`, the plain version) launches about 25 kernels a
// chunk.  This file computes the same function in three launches a call:
//
//   inputs  xh (b, S, nh, dh), B_ / C_ (b, S, ds) (float32 or bf16),
//           dt (b, S, nh) float32, A (nh,), D (nh,), the carried state
//           h (b, nh, dh, ds) float32, the chunk length Q;
//   within a chunk   L_t = cumsum(dt_t A),
//                    y_i = sum_{j<=i} exp(clip(L_i - L_j, -60, 0)) (C_i.B_j)
//                          dt_j x_j  +  exp(L_i) h C_i  +  D x_i,
//   across chunks    h' = exp(L_last) h + sum_j exp(max(L_last - L_j, -60))
//                          dt_j x_j B_j^T,
//   outputs y (b, S, nh * dh) in xh's dtype, the final state float32.
//
// Rows past S, and a last chunk shorter than Q, read as zeros (dt 0 adds
// nothing to L, x, B and C 0 add nothing to a sum): the plain version pads
// S to whole chunks with the same zeros.
//
//   1. ssd_chunk_state_kernel, a block per (chunk, head, batch row): the
//      chunk's own state contribution sum_j w_j x_j B_j^T (64 x 64 of
//      float32, K = Q) and its total log-decay L_last, into a scratch of
//      (b, chunks, nh, 64, 64).  Warpgroup g sums slab g (the chunk's rows
//      64 g .. 64 g + 63); the partial sums are added in slab order.
//   2. ssd_state_pass_kernel, a thread per (batch row, head, state entry):
//      walks the chunks in order, replaces each chunk's contribution by the
//      state entering that chunk, and writes the final state.
//   3. ssd_chunk_out_kernel, a block per (chunk, head, batch row),
//      warpgroup g owning the chunk's row tile g: the entering state's
//      term C h^T scaled by exp(L_i), then slab by slab of 64 j up to the
//      tile's diagonal C.B^T, the masked weights W = decay * C.B^T * dt in
//      registers and W x, then the skip, stored in xh's dtype.
//
// Bound on an H100 SXM: at zamba2-2.7b's widths (nh 80, dh 64, ds 64,
// Q 256) a token costs about 4.2 M multiply-adds over the heads (the
// causal half of the intra-chunk product, the state's contribution and
// its term in y) against 20 KB of bf16 x, y and float32 dt: operations
// bound it.  An earlier design ran them as float32 FMAs on a 4 x 4 register tile read
// from shared memory (8.6-13x its float32 bound) with one block walking
// 16 heads (1.2 waves at 2,048 rows).  This design puts every product on
// the tensor cores and loads each operand once a (chunk, head):
//
// * wgmma.m64n64k8.f32.tf32.tf32, a warpgroup a 64-row tile; B, and C as
//   A, are [64 rows][64 k] K-major tiles in shared memory in two 128-byte
//   swizzled K-blocks (the layout of tf32_wgmma.cuh).
// * A TF32 split of each float32 operand: hi = tf32(x) rounded to nearest,
//   lo = tf32(x - hi); a product takes lo.hi + hi.lo + hi.hi (3xTF32, as
//   B2, B4 and B6 do) and drops lo.lo.  A bf16 operand is exact in TF32
//   and has no lo half: with bf16 x, B and C, C.B^T is one pass (the
//   products of bf16 values are exact in the float32 accumulator) and W x,
//   C h^T and (w x)^T B two.
// * W never leaves registers: the C.B^T accumulator, masked and scaled in
//   place, is W x's A operand.  A thread holds W at columns (2 t, 2 t + 1)
//   of each 8-column group, where the A fragment wants (t, t + 4), so the
//   x tile stores its rows permuted the same way within each group of 8:
//   the sum over j is taken in another order, not over other terms.
// * The tensor cores add into the float32 accumulator truncating (round
//   toward zero), an error that grows with the chain of products summed
//   into it: a slab's product sums into a zeroed accumulator, added to the
//   running one in float32 (round to nearest).
// * A block's 512 threads load a slab's x and B rows together (16 loads a
//   thread in flight) once, and each row tile at or below the slab's
//   diagonal takes them from shared memory (a slab loaded for each row
//   tile, one row a thread at a time, leaves the kernel latency-bound).
//
// Offsets are 64-bit: at 524,288 rows xh alone holds 2.7e9 elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tf32_wgmma.cuh"

namespace {

using c4cam_tf32::tf32_round;

constexpr int kGroups = 4;         // warpgroups a block: a row tile or slab each
constexpr int kThreads = 128 * kGroups;
constexpr int kPassThreads = 256;  // the state pass
constexpr int kTile = 64;          // rows of a tile; dh and ds padded
constexpr int kMaxChunk = kGroups * kTile;
constexpr int kState = kTile * kTile;
constexpr int kTileBytes = kTile * kTile * 4;   // a [64][64] K-major tile
constexpr int kXPad = 72;          // row width of the chunk-state x slab (banks)
constexpr int kRowStep = kThreads / kTile;      // rows a load pass covers

struct SsdParams {
  int64_t b, s, nh, dh, ds, chunk, n_chunks;
  int64_t x_sb, x_ss, x_sh;        // xh strides: batch, row, head
  int64_t b_sb, b_ss;              // B_ strides: batch, row
  int64_t c_sb, c_ss;              // C_ strides: batch, row
  int64_t dt_sb, dt_ss;            // dt strides: batch, row
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Inclusive prefix sum over the block's threads (one value each).
__device__ __forceinline__ float block_scan(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();
  return v + before;
}

// dt_t of the chunk's rows (0 past the chunk or past S) into dts[t] and
// the inclusive scan of dt_t A, L_t, into cum[t], for t < kMaxChunk (a
// thread a row).  The caller synchronises before reading them.
__device__ __forceinline__ void chunk_log_decay(const float* dt, float a, const SsdParams& p,
                                                int64_t bi, int64_t c, int64_t h, float* cum,
                                                float* dts, float* warp_sums) {
  const int t = threadIdx.x;
  const int64_t row = c * p.chunk + t;
  const float d = (t < p.chunk && row < p.s) ? dt[bi * p.dt_sb + row * p.dt_ss + h] : 0.f;
  const float v = block_scan(d * a, warp_sums);
  if (t < kMaxChunk) {
    dts[t] = d;
    cum[t] = v;
  }
}

// Values of a row-major operand (row stride rs, width nw) at this
// thread's column tid % 64 and the chunk's rows r0 + tid / 64 + 8 u,
// u < kN, zero past the chunk, S or the width: kN loads issued together.
template <int kN, typename T>
__device__ __forceinline__ void load_rows(const T* base, int64_t rs, int64_t nw, int64_t row0,
                                          int r0, const SsdParams& p, float (&v)[kN]) {
  const int col = threadIdx.x % kTile;
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int jc = r0 + int(threadIdx.x) / kTile + kRowStep * u;
    const int64_t row = row0 + jc;
    v[u] = (jc < p.chunk && row < p.s && col < nw) ? to_f(base[row * rs + col]) : 0.f;
  }
}

// Byte offset of element (row n, column k) of a [64][64] K-major tile:
// two K-blocks of 32 floats, each [64 rows][128 bytes] in 128-byte
// swizzle (8-row atoms of 1024 bytes).
__device__ __forceinline__ int tile_off(int n, int k) {
  return (k >> 5) * (kTileBytes / 2) + n * 128 + ((((k & 31) >> 2) ^ (n & 7)) << 4) +
         (k & 3) * 4;
}

// v into a tile as tf32 hi and, with `split`, lo = tf32(v - hi) beside it.
__device__ __forceinline__ void put(unsigned char* hi, unsigned char* lo, int n, int k, float v,
                                    bool split) {
  const int off = tile_off(n, k);
  const float vh = tf32_round(v);
  *reinterpret_cast<float*>(hi + off) = vh;
  if (split) *reinterpret_cast<float*>(lo + off) = tf32_round(v - vh);
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float vh = tf32_round(v);
  hi = __float_as_uint(vh);
  lo = __float_as_uint(tf32_round(v - vh));
}

// The tiles' generic-proxy stores, fenced for wgmma (the async proxy).
__device__ __forceinline__ void fence_tiles() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of k-step kk (8 floats) of a tile.
__device__ __forceinline__ uint64_t tile_desc(const unsigned char* tile, int kk) {
  return c4cam_tf32::desc(c4cam_tf32::smem_u32(tile) + (kk >> 2) * (kTileBytes / 2) +
                          32 * (kk & 3));
}

__device__ __forceinline__ void fence_acc(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define C4CAM_ACC32                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define C4CAM_REGS32                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "     \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

// d (64 x 64, float32) += A B^T: tf32 A (64 x 8) in registers, the m16n8k8
// fragment of each warp's 16 rows ((g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)), and B (64 x 8) in shared memory, K-major.  Thread
// (warp v, lane 4 g + t) owns d's rows 16 v + g + 8 h, columns
// 8 n + 2 t + e as d[4 n + 2 h + e].
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" C4CAM_REGS32
               "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : C4CAM_ACC32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// The same with A (64 x 8) in shared memory too, K-major, as B.
__device__ __forceinline__ void wgmma64_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" C4CAM_REGS32
               "}, %32, %33, p, 1, 1;\n}\n"
               : C4CAM_ACC32
               : "l"(da), "l"(db));
}

// acc += A B^T over K = 64 with both operands tiles in shared memory and
// the TF32 split (lo.hi where A has a lo tile, hi.lo where B has one,
// then hi.hi), issued as one group and waited for.
template <bool kALo, bool kBLo>
__device__ __forceinline__ void product_ss(float (&acc)[32], const unsigned char* a_hi,
                                           const unsigned char* a_lo, const unsigned char* b_hi,
                                           const unsigned char* b_lo) {
  fence_acc(acc);
  c4cam_tf32::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t ahi = tile_desc(a_hi, kk), bhi = tile_desc(b_hi, kk);
    if constexpr (kALo) wgmma64_ss(acc, tile_desc(a_lo, kk), bhi);
    if constexpr (kBLo) wgmma64_ss(acc, ahi, tile_desc(b_lo, kk));
    wgmma64_ss(acc, ahi, bhi);
  }
  c4cam_tf32::wgmma_commit();
  c4cam_tf32::wgmma_wait0();
  fence_acc(acc);
}

// acc += A B^T over the kN k-steps kk0 .. kk0 + kN - 1 with A in
// registers (ah / al: those k-steps' fragments) and the same split,
// issued as one group and waited for.
template <int kN, bool kALo, bool kBLo>
__device__ __forceinline__ void product(float (&acc)[32], const uint32_t (&ah)[kN][4],
                                        const uint32_t (&al)[kN][4], int kk0,
                                        const unsigned char* b_hi, const unsigned char* b_lo) {
  fence_acc(acc);
  c4cam_tf32::wgmma_fence();
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const uint64_t dhi = tile_desc(b_hi, kk0 + n);
    if constexpr (kALo) wgmma64(acc, al[n], dhi);
    if constexpr (kBLo) wgmma64(acc, ah[n], tile_desc(b_lo, kk0 + n));
    wgmma64(acc, ah[n], dhi);
  }
  c4cam_tf32::wgmma_commit();
  c4cam_tf32::wgmma_wait0();
  fence_acc(acc);
#pragma unroll
  for (int n = 0; n < kN; ++n) {     // keep the A registers live to here
    asm volatile("" ::"r"(ah[n][0]), "r"(ah[n][1]), "r"(ah[n][2]), "r"(ah[n][3]));
    if constexpr (kALo)
      asm volatile("" ::"r"(al[n][0]), "r"(al[n][1]), "r"(al[n][2]), "r"(al[n][3]));
  }
}

// The chunk-state kernel's dynamic shared memory: for each slab B^T (hi,
// lo) and its x rows times w (row-major, padded); cum, dt, the weights,
// warp sums, and 1 KB of alignment slack.
constexpr size_t kSlabBytes = 2 * kTileBytes + sizeof(float) * kTile * kXPad;
constexpr size_t kStateSmem = kGroups * kSlabBytes + sizeof(float) * (3 * kMaxChunk + 16) + 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                       const float* __restrict__ dt, const float* __restrict__ A,
                       float* __restrict__ states, float* __restrict__ tot,
                       SsdParams p) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = c4cam_tf32::aligned_smem(smem_raw);
  float* cum = reinterpret_cast<float*>(sm + kGroups * kSlabBytes);
  float* dts = cum + kMaxChunk;
  float* w = dts + kMaxChunk;
  float* warp_sums = w + kMaxChunk;
  const int64_t c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, col = tid % kTile;
  const int n_slabs = int((p.chunk + kTile - 1) / kTile);
  const int64_t row0 = c * p.chunk;
  // slab sl: B^T (n = s, k = j) hi and lo, then xs [64 j][kXPad]: w_j x_j
  auto b_hi = [&](int sl) { return sm + sl * kSlabBytes; };
  auto xs = [&](int sl) {
    return reinterpret_cast<float*>(sm + sl * kSlabBytes + 2 * kTileBytes);
  };
  chunk_log_decay(dt, A[h], p, bi, c, h, cum, dts, warp_sums);
  __syncthreads();
  const float last = cum[p.chunk - 1];
  if (tid < kMaxChunk) w[tid] = expf(fmaxf(last - cum[tid], -60.f)) * dts[tid];
  __syncthreads();
  // every slab's x and B rows, two slabs' loads in flight at a time
#pragma unroll
  for (int pair = 0; pair < kGroups / 2; ++pair) {
    float xv[2][kTile / kRowStep], bv[2][kTile / kRowStep];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int sl = 2 * pair + q;
      load_rows<kTile / kRowStep>(x + bi * p.x_sb + h * p.x_sh, p.x_ss, p.dh, row0, kTile * sl,
                                  p, xv[q]);
      load_rows<kTile / kRowStep>(bm + bi * p.b_sb, p.b_ss, p.ds, row0, kTile * sl, p, bv[q]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int sl = 2 * pair + q;
#pragma unroll
      for (int u = 0; u < kTile / kRowStep; ++u) {
        const int jl = tid / kTile + kRowStep * u;
        xs(sl)[jl * kXPad + col] = w[kTile * sl + jl] * xv[q][u];
        put(b_hi(sl), b_hi(sl) + kTileBytes, col, jl, bv[q][u], !kExact);
      }
    }
  }
  fence_tiles();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (wg < n_slabs) {
    // A = (w x)^T of slab wg: rows d = 16 warp + g (+ 8), k = j
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = 16 * warp + g + 8 * (q & 1);
          const int jl = 8 * (4 * half + n) + t + 4 * (q >> 1);
          split(xs(wg)[jl * kXPad + d], ah[n][q], al[n][q]);
        }
      product<4, true, !kExact>(acc, ah, al, 4 * half, b_hi(wg), b_hi(wg) + kTileBytes);
    }
  }
  __syncthreads();                 // every slab's x read: its space takes the partial sum
  if (wg < n_slabs) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int d = 16 * warp + g + 8 * hh, s = 8 * n + 2 * t;
        *reinterpret_cast<float2*>(&xs(wg)[d * kTile + s]) =
            make_float2(acc[4 * n + 2 * hh], acc[4 * n + 2 * hh + 1]);
      }
  }
  __syncthreads();
  float* out = states + ((bi * p.n_chunks + c) * p.nh + h) * kState;
#pragma unroll
  for (int u = 0; u < kState / kThreads; ++u) {   // the slabs' sums in slab order
    const int e = tid + kThreads * u;
    float sum = xs(0)[e];
    for (int sl = 1; sl < n_slabs; ++sl) sum = __fadd_rn(sum, xs(sl)[e]);
    out[e] = sum;
  }
  if (tid == 0) tot[(bi * p.n_chunks + c) * p.nh + h] = last;
}

// h <- exp(L_last) h + contribution, chunk by chunk; each chunk's slot of
// `states` is left holding the state that enters it.  The contributions
// and totals of the next kAhead chunks are loaded ahead (a ring of
// registers), so a step waits for no load of its own.
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ tot,
                      const float* __restrict__ h0, float* __restrict__ h_out,
                      SsdParams p) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const int64_t h = blockIdx.y, bi = blockIdx.z;
  const int d = e / kTile, s = e % kTile;
  const bool live = d < p.dh && s < p.ds;
  const int64_t at = ((bi * p.nh + h) * p.dh + d) * p.ds + s;
  const int64_t first = (bi * p.n_chunks) * p.nh + h;      // chunk c's slot: first + c nh
  float hv = live ? h0[at] : 0.f;
  float contrib[kAhead], total[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i)
    if (i < p.n_chunks) {
      contrib[i] = states[(first + i * p.nh) * kState + e];
      total[i] = tot[first + i * p.nh];
    }
  for (int64_t c0 = 0; c0 < p.n_chunks; c0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int64_t c = c0 + i;
      if (c >= p.n_chunks) break;
      const float add = contrib[i], decay = expf(total[i]);
      if (c + kAhead < p.n_chunks) {
        contrib[i] = states[(first + (c + kAhead) * p.nh) * kState + e];
        total[i] = tot[first + (c + kAhead) * p.nh];
      }
      states[(first + c * p.nh) * kState + e] = hv;
      hv = __fadd_rn(__fmul_rn(decay, hv), add);
    }
  }
  if (live) h_out[at] = hv;
}

// The output kernel's dynamic shared memory: the chunk's C tiles (hi,
// lo), the h / B tile and the x tile (hi, lo each), cum, dt, warp sums,
// and 1 KB of alignment slack.
constexpr size_t kOutSmem = (2 * kGroups + 4) * size_t(kTileBytes) +
                            sizeof(float) * (2 * kMaxChunk + 16) + 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_out_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Dskip,
                     const float* __restrict__ states, T* __restrict__ y,
                     SsdParams p) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kCRows = kMaxChunk / kRowStep / 2;       // C rows a thread loads a half
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = c4cam_tf32::aligned_smem(smem_raw);
  unsigned char* c_hi = sm;                               // tile g: (n = i, k = s)
  unsigned char* c_lo = sm + kGroups * kTileBytes;
  unsigned char* t_hi = sm + 2 * kGroups * kTileBytes;   // h (n = d, k = s), then B (n = j, k = s)
  unsigned char* t_lo = t_hi + kTileBytes;
  unsigned char* x_hi = t_lo + kTileBytes;               // x (n = d, k = j permuted)
  unsigned char* x_lo = x_hi + kTileBytes;
  float* cum = reinterpret_cast<float*>(x_lo + kTileBytes);
  float* dts = cum + kMaxChunk;
  float* warp_sums = dts + kMaxChunk;

  const int64_t c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, col = tid % kTile;
  const int64_t row0 = c * p.chunk;
  const int n_tiles = int((p.chunk + kTile - 1) / kTile);
  const bool active = wg < n_tiles;                      // the warpgroup's tile holds rows
  const int ia = kTile * wg + 16 * warp + g;             // the thread's rows ia, ia + 8
  const unsigned char* my_c_hi = c_hi + wg * kTileBytes;
  const unsigned char* my_c_lo = c_lo + wg * kTileBytes;

  chunk_log_decay(dt, A[h], p, bi, c, h, cum, dts, warp_sums);
  // the chunk's C rows into the row tiles, K-major as stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[kCRows];
    load_rows<kCRows>(cm + bi * p.c_sb, p.c_ss, p.ds, row0, half * kMaxChunk / 2, p, v);
#pragma unroll
    for (int u = 0; u < kCRows; ++u) {
      const int i = half * kMaxChunk / 2 + tid / kTile + kRowStep * u;
      put(c_hi + (i / kTile) * kTileBytes, c_lo + (i / kTile) * kTileBytes, i % kTile, col,
          v[u], !kExact);
    }
  }
  // the state entering the chunk, K-major as stored: (n = d, k = s)
  const float* hin = states + ((bi * p.n_chunks + c) * p.nh + h) * kState;
  {
    float hv[kState / kThreads];
#pragma unroll
    for (int u = 0; u < kState / kThreads; ++u) hv[u] = hin[tid + u * kThreads];
#pragma unroll
    for (int u = 0; u < kState / kThreads; ++u) {
      const int e = tid + u * kThreads;
      put(t_hi, t_lo, e / kTile, e % kTile, hv[u], true);
    }
  }
  fence_tiles();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const float li0 = cum[ia], li1 = cum[ia + 8];
  if (active) {
    product_ss<!kExact, true>(acc, my_c_hi, my_c_lo, t_hi, t_lo);
    const float e0 = expf(li0), e1 = expf(li1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[4 * n] *= e0;
      acc[4 * n + 1] *= e0;
      acc[4 * n + 2] *= e1;
      acc[4 * n + 3] *= e1;
    }
  }
  for (int jb = 0; jb < n_tiles; ++jb) {
    __syncthreads();                         // the tiles' last readers are done
    {
      float xv[kTile / kRowStep], bv[kTile / kRowStep];
      load_rows<kTile / kRowStep>(x + bi * p.x_sb + h * p.x_sh, p.x_ss, p.dh, row0, kTile * jb,
                                  p, xv);
      load_rows<kTile / kRowStep>(bm + bi * p.b_sb, p.b_ss, p.ds, row0, kTile * jb, p, bv);
#pragma unroll
      for (int u = 0; u < kTile / kRowStep; ++u) {
        const int jl = tid / kTile + kRowStep * u;
        put(t_hi, t_lo, jl, col, bv[u], !kExact);
        // row j of the slab at k position 8 (j / 8) + perm(j % 8): the W
        // fragment's columns 2 t, 2 t + 1 at the A fragment's t, t + 4
        const int jm = jl & 7, kpos = (jl & ~7) + ((jm & 1) << 2) + (jm >> 1);
        put(x_hi, x_lo, col, kpos, xv[u], !kExact);
      }
    }
    fence_tiles();
    __syncthreads();
    if (!active || jb > wg) continue;        // the slab is past the tile's diagonal
    float cb[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[i] = 0.f;
    product_ss<!kExact, !kExact>(cb, my_c_hi, my_c_lo, t_hi, t_lo);
    // W = decay * C.B^T * dt, causal, in place
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int hh = q >> 1, e = q & 1;
        const int jg = kTile * jb + 8 * n + 2 * t + e, ig = ia + 8 * hh;
        const float decay = expf(fminf(fmaxf((hh ? li1 : li0) - cum[jg], -60.f), 0.f));
        cb[4 * n + q] = jg <= ig ? (decay * cb[4 * n + q]) * dts[jg] : 0.f;
      }
    // W x into a zeroed accumulator, two k-steps of W's fragments at a time
    // (fragment order (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
#pragma unroll
    for (int quarter = 0; quarter < 4; ++quarter) {
      uint32_t wh[2][4], wl[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int kk = 2 * quarter + n;
        split(cb[4 * kk], wh[n][0], wl[n][0]);
        split(cb[4 * kk + 2], wh[n][1], wl[n][1]);
        split(cb[4 * kk + 1], wh[n][2], wl[n][2]);
        split(cb[4 * kk + 3], wh[n][3], wl[n][3]);
      }
      product<2, true, !kExact>(part, wh, wl, 2 * quarter, x_hi, x_lo);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
  if (!active) return;
  // y = acc + D x_i, in xh's dtype
  const float dskip = Dskip[h];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ig = ia + 8 * hh;
    const int64_t row = row0 + ig;
    if (ig >= p.chunk || row >= p.s) continue;
    T* out = y + (bi * p.s + row) * (p.nh * p.dh) + h * p.dh;
    const T* xi = x + bi * p.x_sb + row * p.x_ss + h * p.x_sh;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < p.dh)
          store(out + d, __fadd_rn(acc[4 * n + 2 * hh + e], __fmul_rn(dskip, to_f(xi[d]))));
      }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const float* dt,
           const float* A, const float* Dskip, const float* h0, void* y,
           float* h_out, float* states, float* tot, const SsdParams& p,
           cudaStream_t stream) {
  static std::atomic<uint64_t> ready_out{0}, ready_state{0};
  cudaError_t err = set_smem(reinterpret_cast<const void*>(&ssd_chunk_out_kernel<T>), kOutSmem,
                             ready_out);
  if (err != cudaSuccess) return int(err);
  err = set_smem(reinterpret_cast<const void*>(&ssd_chunk_state_kernel<T>), kStateSmem,
                 ready_state);
  if (err != cudaSuccess) return int(err);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  ssd_chunk_state_kernel<T><<<dim3(unsigned(p.n_chunks), unsigned(p.nh), unsigned(p.b)),
                              kThreads, kStateSmem, stream>>>(xt, bt, dt, A, states, tot,
                                                              p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_state_pass_kernel<<<dim3(kState / kPassThreads, unsigned(p.nh), unsigned(p.b)),
                          kPassThreads, 0, stream>>>(states, tot, h0, h_out, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_chunk_out_kernel<T><<<dim3(unsigned(p.n_chunks), unsigned(p.nh), unsigned(p.b)),
                            kThreads, kOutSmem, stream>>>(xt, bt, ct, dt, A, Dskip,
                                                          states, static_cast<T*>(y), p);
  return int(cudaGetLastError());
}

}  // namespace

// params: b, s, nh, dh, ds, chunk, then the strides of xh (batch, row,
// head), B_ (batch, row), C_ (batch, row) and dt (batch, row), then 1 for
// bf16 operands (0: float32).  `states` is b * chunks * nh * 64 * 64
// floats of scratch, `tot` b * chunks * nh.
extern "C" int c4cam_ssd_scan(const void* x, const void* bm, const void* cm,
                              const float* dt, const float* A, const float* Dskip,
                              const float* h0, void* y, float* h_out, float* states,
                              float* tot, const int64_t* params, void* stream) {
  SsdParams p;
  p.b = params[0]; p.s = params[1]; p.nh = params[2]; p.dh = params[3];
  p.ds = params[4]; p.chunk = params[5];
  p.x_sb = params[6]; p.x_ss = params[7]; p.x_sh = params[8];
  p.b_sb = params[9]; p.b_ss = params[10];
  p.c_sb = params[11]; p.c_ss = params[12];
  p.dt_sb = params[13]; p.dt_ss = params[14];
  const bool bf16 = params[15] != 0;
  if (p.b <= 0 || p.s <= 0 || p.nh <= 0 || p.dh <= 0 || p.dh > kTile || p.ds <= 0 ||
      p.ds > kTile || p.chunk <= 0 || p.chunk > kMaxChunk || p.b > 65535 ||
      p.nh > 65535)
    return int(cudaErrorInvalidValue);
  p.n_chunks = (p.s + p.chunk - 1) / p.chunk;
  if (p.n_chunks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, bm, cm, dt, A, Dskip, h0, y, h_out, states, tot, p, st)
              : launch<float>(x, bm, cm, dt, A, Dskip, h0, y, h_out, states, tot, p, st);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
