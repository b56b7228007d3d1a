// flash_attention: online-softmax GQA attention forward (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`) and carries
// every attention call of the port's LM: prefill, decode and the no-cache
// forward.  Contract (the reference's layout): q (B, S, H, dh), k / v
// (B, T, KV, dh) read through their strides, query head h reads kv head
// h / (H / KV); scores q.k (k taken in q's precision) accumulated in float32
// and scaled by 1/sqrt(dh); row s is global position q_start + s; column t
// is visible when t < kv_len and, if causal, t <= q_start + s or
// t < prefix_len; hidden scores are the finite -1e30; probabilities are
// rounded to v's dtype before the PV product, which accumulates in float32;
// the output, acc / max(l, 1e-30), is stored in q's dtype.
//
// Bound on an H100 SXM: 4 * H * dh * (visible columns summed over rows)
// FLOP at 989 TFLOP/s (bf16 tensor cores), against the bytes of q, o and
// the visible K/V rows at 3.35 TB/s.  A 2048-token causal prefill of
// qwen2.5-14b (40 heads, dh 128) is 4.3e10 FLOP, 0.043 ms: compute-bound;
// a decode step reads 8.5 MB of cache for 2,080 rows, 2.5 us: memory-bound.
//
// Design, a simple first version: the Pallas grid's sequential kv axis
// (m, l and acc carried in VMEM scratch across grid steps) becomes a loop
// inside one block.  A block owns (b, h, 64 query rows) and walks 64-row kv
// tiles up to the last column any of its rows can see, so no tile wholly
// past kv_len or the causal diagonal is read, and column 0 (visible to every
// row) sits in the first tile: no row starts on a wholly masked tile.  A warp
// whose rows are all past S skips the arithmetic (decode uses one row).
//
// * bf16 q over bf16 k / v (the served model): flash_fwd_mma_kernel, 4 warps
//   of 16 rows on the tensor cores, mma.sync m16n8k16 with float32
//   accumulators.  Q's fragments stay in registers; K and V tiles are copied
//   as bf16 into padded shared memory (52 KB at dh 128); the probabilities
//   are rounded to bf16 straight from the score fragments, which are the
//   A fragments of the PV product, and V's B fragments come through
//   ldmatrix.trans.
// * float32 q (the parity checks; over a float32 or the float32 model's
//   bf16 cache): flash_fwd_kernel, 256 threads of float32 FMA on the CUDA
//   cores (products of bf16 values are exact in float32).  Q, K, V and the
//   probability tile are staged as float32 (118 KB at dh 128, one block per
//   SM); thread (ty, tx) holds rows 4ty..4ty+3 against columns tx + 16c of
//   the scores and tx + 16n of the accumulator; row max and sum reduce
//   across the 16 threads of a half-warp.
//
// The bf16 kernel stages each K / V tile with cp.async, every copy of a tile
// in flight at once; no load overlaps the arithmetic yet.  wgmma, TMA
// pipelines, heads folded into the tile's rows and split-KV decoding are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLdp = kBlockK + 4;   // padded row of the probability tile
constexpr float kNegBig = -1e30f;

// 16-byte loads converted to float32.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// x rounded (to nearest even) to T's precision, as float32.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

// Stage rows [r0, r0 + 64) of one head (row stride `rs`, elements) as
// float32 into a [64][DH + 4] tile; rows at or past `r_end` are zero.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* tile, const T* src, int64_t rs,
                                      int r0, int r_end) {
  constexpr int V = Vec<T>::N;
  constexpr int kPerRow = DH / V;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * V;
    float x[V];
    if (r0 + r < r_end) {
      load16(src + int64_t(r0 + r) * rs + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = 0.f;
    }
    float* dst = tile + r * (DH + 4) + c;
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  }
}

template <int DH, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, TQ* __restrict__ o, int S, int H,
                 int group, int causal, int prefix_len, int kv_len, int q_start,
                 int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kst,
                 int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh, float scale) {
  constexpr int kLd = DH + 4;       // padded row of the Q/K/V tiles (floats)
  constexpr int kCols = DH / 16;    // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kBlockQ][kLd]
  float* ks = qs + kBlockQ * kLd;   // [kBlockK][kLd]
  float* vs = ks + kBlockK * kLd;   // [kBlockK][kLd]
  float* ps = vs + kBlockK * kLd;   // [kBlockQ][kLdp]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int s0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, S - s0);
  const bool active = 8 * (tid >> 5) < rows;   // the warp has a row below S

  const TKV* kb = k + b * ksb + (h / group) * ksh;
  const TKV* vb = v + b * vsb + (h / group) * vsh;
  stage<DH>(qs, q + b * qsb + h * qsh + int64_t(s0) * qss, qss, 0, rows);

  // the last column any row of the block can see, plus one
  int col_end = kv_len;
  if (causal) col_end = min(col_end, max(q_start + s0 + rows, prefix_len));

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  for (int t0 = 0; t0 < col_end; t0 += kBlockK) {
    __syncthreads();                // the previous tile's readers are done
    stage<DH>(ks, kb, kst, t0, col_end);
    stage<DH>(vs, vb, vst, t0, col_end);
    __syncthreads();
    if (active) {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kk[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = sc[i][c];
            s = fmaf(a[i].x, kk[c].x, s);
            s = fmaf(a[i].y, kk[c].y, s);
            s = fmaf(a[i].z, kk[c].z, s);
            s = fmaf(a[i].w, kk[c].w, s);
            sc[i][c] = s;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q_start + s0 + 4 * ty + i;
        float mx = kNegBig;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = t0 + tx + 16 * c;
          const bool ok = col < kv_len && (!causal || col <= qi || col < prefix_len);
          sc[i][c] = ok ? sc[i][c] * scale : kNegBig;
          mx = fmaxf(mx, sc[i][c]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = expf(sc[i][c] - m_new);
          sum += p;
          ps[(4 * ty + i) * kLdp + tx + 16 * c] = round_to(p, v);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < kCols; ++n) acc[i][n] *= alpha;
      }
    }
    __syncthreads();                // the probability tile is complete
    if (active) {
#pragma unroll 2
      for (int j = 0; j < kBlockK; j += 4) {
        float4 p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p4[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kLdp + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vrow = vs + (j + u) * kLd + tx;
#pragma unroll
          for (int n = 0; n < kCols; ++n) {
            const float vv = vrow[16 * n];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
              acc[i][n] = fmaf(p, vv, acc[i][n]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = s0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    TQ* orow = o + ((int64_t(b) * S + row) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < kCols; ++n) store(orow + tx + 16 * n, acc[i][n] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 q over bf16 k / v: the tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;                 // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 at p (p[0] in the low half), as an mma operand register.
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B fragments of two 8x8 bf16 blocks stacked in k, read transposed from a
// row-major tile (lanes 0-15 give the 16 row addresses).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// Start copying rows [r0, r0 + 64) of one head into a [64][DH + 8] bf16
// tile, 16 bytes per cp.async, all in flight at once; rows at or past
// `r_end` are zero-filled (no byte is read for them).  Complete with
// cp_async_wait_all() and a barrier.
template <int DH>
__device__ __forceinline__ void stage_bf16(bf16* tile, const bf16* src,
                                           int64_t rs, int r0, int r_end) {
  constexpr int kPerRow = DH / 8;
#pragma unroll
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kMmaThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    const int row = min(r0 + r, r_end - 1);       // an address inside the tensor
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(tile + r * (DH + 8) + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(dst), "l"(src + int64_t(row) * rs + c),
                   "r"(r0 + r < r_end ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The same contract and recurrence as flash_fwd_kernel for bf16 q, k, v.
// Warp w owns query rows 16w..16w+15 of the block's 64; lane (g, t) =
// (lane / 4, lane % 4) holds rows g and g + 8 of them, and of each 8-column
// score or output tile the columns 2t and 2t + 1 (the mma C fragment).  The
// probabilities' C fragments are the A fragments of the PV product; V's B
// fragments come from its row-major tile through ldmatrix.trans.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                     int H, int group, int causal, int prefix_len, int kv_len,
                     int q_start, int64_t qsb, int64_t qss, int64_t qsh,
                     int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                     int64_t vst, int64_t vsh, float scale) {
  constexpr int kLdk = DH + 8;        // padded tile row (bf16): no bank conflicts
  constexpr int kSteps = DH / 16;     // k-steps of Q K^T
  constexpr int kNt = DH / 8;         // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBlockQ][kLdk]
  bf16* ks = qs + kBlockQ * kLdk;                 // [kBlockK][kLdk]
  bf16* vs = ks + kBlockK * kLdk;                 // [kBlockK][kLdk]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int s0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, S - s0);
  const bool active = 16 * warp < rows;           // the warp has a row below S

  const bf16* kb = k + b * ksb + (h / group) * ksh;
  const bf16* vb = v + b * vsb + (h / group) * vsh;
  stage_bf16<DH>(qs, q + b * qsb + h * qsh + int64_t(s0) * qss, qss, 0, rows);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[kSteps][4];                         // A fragments of the warp's Q
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const bf16* base = qs + (16 * warp + g) * kLdk + 16 * kk + 2 * t;
    qa[kk][0] = ld2(base);
    qa[kk][1] = ld2(base + 8 * kLdk);
    qa[kk][2] = ld2(base + 8);
    qa[kk][3] = ld2(base + 8 * kLdk + 8);
  }

  int col_end = kv_len;
  if (causal) col_end = min(col_end, max(q_start + s0 + rows, prefix_len));
  const int qi0 = q_start + s0 + 16 * warp + g, qi1 = qi0 + 8;

  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;   // rows g, g + 8
  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  for (int t0 = 0; t0 < col_end; t0 += kBlockK) {
    __syncthreads();                // the previous tile's readers are done
    stage_bf16<DH>(ks, kb, kst, t0, col_end);
    stage_bf16<DH>(vs, vb, vst, t0, col_end);
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    float sc[8][4];                 // scores: 8 tiles of 8 kv columns
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const bf16* kr = ks + (8 * nt + g) * kLdk + 16 * kk + 2 * t;
        mma_bf16(sc[nt], qa[kk], ld2(kr), ld2(kr + 8));
      }
    }
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = t0 + 8 * nt + 2 * t + j;
        const bool in = col < kv_len;
        const bool ok0 = in && (!causal || col <= qi0 || col < prefix_len);
        const bool ok1 = in && (!causal || col <= qi1 || col < prefix_len);
        sc[nt][j] = ok0 ? sc[nt][j] * scale : kNegBig;
        sc[nt][2 + j] = ok1 ? sc[nt][2 + j] * scale : kNegBig;
        mx0 = fmaxf(mx0, sc[nt][j]);
        mx1 = fmaxf(mx1, sc[nt][2 + j]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {       // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    uint32_t pa[4][4];              // A fragments of P: 4 steps of 16 kv rows
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(sc[nt][0] - n0), p1 = expf(sc[nt][1] - n0);
      const float p2 = expf(sc[nt][2] - n1), p3 = expf(sc[nt][3] - n1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + sum0;            // this lane's share of the row sums
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vs + (16 * kk + (lane & 15)) * kLdk + 8 * n);
        mma_bf16(acc[n], pa[kk], b0, b1);
      }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = s0 + 16 * warp + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= S) continue;
    const float d = half ? d1 : d0;
    bf16* orow = o + ((int64_t(b) * S + row) * H + h) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < kNt; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(acc[n][2 * half] / d, acc[n][2 * half + 1] / d);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int causal, int prefix_len, int kv_len,
               int q_start, const long long* st, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(bf16) * 3 * 64 * (DH + 8);
  auto kernel = flash_fwd_mma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  const float scale = float(1.0 / sqrt(double(DH)));
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, H / KV, causal,
      prefix_len, kv_len, q_start, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale);
  return int(cudaGetLastError());
}

template <int DH, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int prefix_len, int kv_len, int q_start,
           const long long* st, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * (3 * 64 * (DH + 4) + kBlockQ * kLdp);
  auto kernel = flash_fwd_kernel<DH, TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  const float scale = float(1.0 / sqrt(double(DH)));
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), S, H, H / KV, causal,
      prefix_len, kv_len, q_start, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale);
  return int(cudaGetLastError());
}

// launch<DH, TQ, TKV> (FMA) or, for bf16 q over bf16 k / v, launch_mma<DH>
template <typename TQ, typename TKV>
int by_dim(int dh, const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int causal, int prefix_len, int kv_len,
           int q_start, const long long* st, cudaStream_t s) {
  constexpr bool kMma = std::is_same_v<TQ, bf16>;
#define C4CAM_FLASH_CASE(D)                                                                 \
  case D:                                                                                   \
    if constexpr (kMma)                                                                     \
      return launch_mma<D>(q, k, v, o, B, S, H, KV, causal, prefix_len, kv_len, q_start, st, s); \
    else                                                                                    \
      return launch<D, TQ, TKV>(q, k, v, o, B, S, H, KV, causal, prefix_len, kv_len, q_start, st, s);
  switch (dh) {
    C4CAM_FLASH_CASE(16)
    C4CAM_FLASH_CASE(32)
    C4CAM_FLASH_CASE(64)
    C4CAM_FLASH_CASE(128)
    default: return int(cudaErrorInvalidValue);
  }
#undef C4CAM_FLASH_CASE
}

}  // namespace

// q (B, S, H, dh), k / v (B, T, KV, dh) with unit last stride and 16-byte
// aligned rows; strides in elements (q: b, s, h; k: b, t, h; v: b, t, h);
// o (B, S, H, dh) contiguous, q's dtype.  q_bf16 / kv_bf16 pick bfloat16
// over float32 (a bfloat16 q takes a bfloat16 k / v only).  kv_len in
// 1..T.  Returns a cudaError_t code.
extern "C" int c4cam_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int KV, int dh, int q_bf16, int kv_bf16, int causal, int prefix_len,
    int kv_len, int q_start, long long qsb, long long qss, long long qsh,
    long long ksb, long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || kv_len < 1 || prefix_len < 0 ||
      q_start < 0 || H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const long long st[9] = {qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return by_dim<bf16, bf16>(dh, q, k, v, o, B, S, H, KV, causal, prefix_len, kv_len, q_start, st, s);
  if (!q_bf16 && kv_bf16)
    return by_dim<float, bf16>(dh, q, k, v, o, B, S, H, KV, causal, prefix_len, kv_len, q_start, st, s);
  if (!q_bf16 && !kv_bf16)
    return by_dim<float, float>(dh, q, k, v, o, B, S, H, KV, causal, prefix_len, kv_len, q_start, st, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
