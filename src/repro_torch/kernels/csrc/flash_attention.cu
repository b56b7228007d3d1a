// flash_attention: online-softmax GQA attention forward (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`) and carries
// every attention call of the port's LM: prefill, decode and the no-cache
// forward.  Contract (the reference's layout): q (B, S, H, dh), k / v
// (B, T, KV, dh) read through their strides, query head h reads kv head
// h / (H / KV); scores q.k (k taken in q's precision) accumulated in float32
// and scaled by the caller's scale (1/sqrt of its head dim: the wrapper
// zero-pads other head dims to the next instantiated one, which leaves
// every score unchanged); row s is global position q_start + s; column t
// is visible when t < kv_len and, if causal, t <= q_start + s or
// t < prefix_len; hidden scores are the reference's finite -1e30 (the bf16
// kernels enter them as -inf, with the running max starting at -1e30: the
// same probabilities, 0, and never e^0 on a split no column of which a
// row sees); the unnormalised
// probabilities are rounded to v's dtype before the PV product, which
// accumulates in float32; the output, acc / max(l, 1e-30), is stored in q's
// dtype.  No kernel reads a K / V row at or past kv_len, and none walks a kv
// tile past the last column any of its rows can see (`col_end`).  When the
// caller wants a gradient every route also writes each row's float32
// log-sum-exp m + log(l) of the scaled scores (the prefill and FMA kernels
// from their own m and l, split-KV from its combine), the input of the
// backward (flash_attention_bwd.cu); serving passes no buffer.
//
// Bound on an H100 SXM: 4 * H * dh * (visible columns summed over rows)
// FLOP at 989 TFLOP/s (bf16 tensor cores), against the bytes of q, o and
// the visible K/V rows at 3.35 TB/s.  A 2048-token causal prefill of
// qwen2.5-14b (40 heads, dh 128) is 4.3e10 FLOP, 0.043 ms: compute-bound;
// a decode step reads 8.4 MB of cache for 2,049 rows, 2.5 us, and a
// 32,768-row decode 134 MB, 40 us: memory-bound.  The wrapper picks one of
// three routes from the shape (flash_attention.py, `flash_route`):
//
// * bf16, more than 64 query rows per kv head (S * H / KV): prefill,
//   flash_fwd_wgmma_kernel.  A block owns 128 query rows of one head, two
//   consumer warpgroups of 64 rows, and one producer warp that keeps a
//   3-stage ring of 128-row K / V tiles (at dh 256 a 2-stage ring of
//   64-row tiles: shared memory and registers) full by TMA (one mbarrier
//   per stage for "full", one for "empty"; the tensor maps cover the strided
//   (B, T, KV, dh) view with T cut to kv_len, so rows past it read as
//   zeros and are never fetched; with kv_len read on the device they cover
//   the whole view, and the tile that straddles kv_len is masked as ever)
//   and hands its registers to the consumers
//   (setmaxnreg).  S = Q K^T is wgmma m64n128k16 (n64 at dh 256) with Q
//   and K from shared memory (K-major, swizzled as TMA wrote them: 128 B
//   rows at dh 64, 128 and 256, 64 B at dh 32, 32 B at dh 16 and, in five
//   16-column atoms, at dh 80); the score accumulators,
//   rounded to bf16, are the A registers of O += P V (wgmma with V
//   through the transposed-B descriptor).  A tile's softmax runs while the
//   previous tile's P V is on the tensor cores, and the two warpgroups
//   take turns to start their products (ping-pong), so one's softmax runs
//   while the other's products do.  Only tiles that straddle the
//   diagonal, kv_len or prefix_len are masked (one branch a tile); the
//   longest causal query blocks launch first, so the causal tail is
//   short; the output leaves through shared memory in 16-byte chunks.
//   What bounds it: the softmax (an accurate expf, 8 instructions of ~15 a
//   score, kept so that the probabilities round where the recurrence's
//   do) on the CUDA cores, beside the tensor cores' share.
// * bf16, at most 64 query rows per kv head: decode and short chunks,
//   flash_fwd_splitkv_kernel + flash_fwd_splitkv_combine.  A block owns
//   one kv head of one batch row and folds its H / KV query heads times
//   S rows into the rows of one or four m16 tiles, so every K / V byte is
//   read once per kv head.  The kv walk is cut into splits of whole
//   64-row tiles, about two blocks an SM (one at dh 256); each split runs
//   the recurrence from m = -1e30 over its tiles through a 3-stage (dh 256:
//   2-stage) cp.async ring (no TMA: a decode call encodes no tensor map)
//   with mma.sync m16n8k16, its 4 warps taking 16 score columns and a
//   quarter of dh each (whole 8-column tiles: at dh 80, 24, 24, 24, 8),
//   and writes (m, l, acc) to float32 scratch.  The combine kernel merges the
//   splits: m* = max m_i, l = sum l_i e^(m_i - m*), acc likewise,
//   out = acc / max(l, 1e-30).  A split with no visible column for a row
//   contributes m = -1e30, l = 0, acc = 0.  What bounds it: the bytes of
//   the cache, and at short caches the two launches' latency.
// * float32 q (the parity checks; over a float32 or the float32 model's
//   bf16 cache): flash_fwd_kernel, 256 threads of float32 FMA on the CUDA
//   cores (products of bf16 values are exact in float32).  Q, K, V and the
//   probability tile are staged as float32 (118 KB at dh 128, 212 KB at
//   dh 256, one block per SM); thread (ty, tx) holds rows 4ty..4ty+3
//   against columns tx + 16c of the scores and tx + 16n of the
//   accumulator; row max and sum reduce across the 16 threads of a
//   half-warp.
//
// Head dims: 16, 32, 64, 80, 128, 256.  The kv tile width of each route
// (128, or 64 at dh 256; 64; 64) is the recurrence's block_k: a row's
// running max, and so the rounding point of its probabilities, moves at
// tile (and split) boundaries, which the wrapper exposes so that the
// checks follow the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <type_traits>

#include "bf16_wgmma.cuh"  // mbarriers, TMA, wgmma (shared with the backward)

namespace {

using c4cam_bf16::allow_smem;
using c4cam_bf16::bf16;
using c4cam_bf16::pack_bf16;
using c4cam_bf16::smem_u32;

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLdp = kBlockK + 4;   // padded row of the probability tile
constexpr float kNegBig = -1e30f;

// A device start (the rows a cache held before this call, which a CUDA
// graph's replay reads where a host int would be frozen at capture): query
// row s then sits at start + q_start + s and the columns below
// min(start + kv_len, extent) are visible; extent is the rows the K / V
// views hold.  Every bound a kernel walks follows from these two.
__device__ __forceinline__ void from_device(const int* start, int extent, int& q_start,
                                            int& kv_len) {
  if (start != nullptr) {
    const int s0 = *start;
    q_start += s0;
    kv_len = min(kv_len + s0, extent);
  }
}

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
                 const TKV* __restrict__ v, TQ* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int group, int causal, int prefix_len, int kv_len, int q_start,
                 const int* __restrict__ start, int extent, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kst,
                 int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh, float scale) {
  constexpr int kLd = DH + 4;       // padded row of the Q/K/V tiles (floats)
  constexpr int kCols = DH / 16;    // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kBlockQ][kLd]
  float* ks = qs + kBlockQ * kLd;   // [kBlockK][kLd]
  float* vs = ks + kBlockK * kLd;   // [kBlockK][kLd]
  float* ps = vs + kBlockK * kLd;   // [kBlockQ][kLdp]

  from_device(start, extent, q_start, kv_len);
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
    if (lse != nullptr && tx == 0) lse[(int64_t(b) * H + h) * S + row] = m[i] + logf(l[i]);
    TQ* orow = o + ((int64_t(b) * S + row) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < kCols; ++n) store(orow + tx + 16 * n, acc[i][n] / denom);
  }
}

template <int DH, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int causal, int prefix_len, int kv_len,
           int q_start, const int* start, int extent, float scale, const long long* st,
           cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * (3 * 64 * (DH + 4) + kBlockQ * kLdp);
  auto kernel = flash_fwd_kernel<DH, TQ, TKV>;
  static std::atomic<uint64_t> ready{0};
  const cudaError_t err = allow_smem(kernel, kSmem, ready);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), lse, S, H, H / KV, causal,
      prefix_len, kv_len, q_start, start, extent, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Prefill: flash_fwd_wgmma_kernel (TMA ring, warp-specialised, wgmma)
// ---------------------------------------------------------------------------

namespace wg {

using namespace c4cam_bf16;

constexpr int kBlockQ = 128;       // two consumer warpgroups of 64 rows
constexpr int kThreads = 384;      // warpgroups 0-1 consume, 2 produces
constexpr int kConsumerWarps = 8;

// Shared-memory geometry of the [rows][DH] bf16 tiles as TMA writes them
// (bf16_wgmma.cuh, `Atoms`).  Q tiles have kBlockQ rows, K / V tiles
// kBlockK: 128 (the Pallas default) in a 3-stage ring, but 64 in 2
// stages at dh 256, where 128-row tiles would neither fit shared memory
// (7 x 64 KB) nor leave the consumers the registers for their scores next
// to a 128-register accumulator.
template <int DH>
struct Geo : Atoms<DH> {
  using Atoms<DH>::kSwizzle;
  using Atoms<DH>::kAtoms;
  static constexpr int kBlockK = DH > 128 ? 64 : 128;
  static constexpr int kStages = DH > 128 ? 2 : 3;
  static constexpr int kQAtomBytes = kBlockQ * kSwizzle;
  static constexpr int kKAtomBytes = kBlockK * kSwizzle;
  static constexpr int kQTileBytes = kAtoms * kQAtomBytes;   // 128 x DH x 2
  static constexpr int kKTileBytes = kAtoms * kKAtomBytes;   // kBlockK x DH x 2
  // Q, kStages K and V tiles, 1 KB of alignment slack, the barriers
  static constexpr size_t kSmem =
      size_t(kQTileBytes) + size_t(2 * kStages) * kKTileBytes + 1024 + 64;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// S = Q K^T for one warpgroup's 64 rows (at q_rows) and a K tile, over dh
// in k-steps of 16 columns (32 bytes of an atom row).
template <int DH>
__device__ __forceinline__ void start_s(float (&sc)[Geo<DH>::kBlockK / 2],
                                        uint32_t q_rows, uint32_t kt) {
  using G = Geo<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t atom = 16 * kk / G::kAtomCols, col = (16 * kk % G::kAtomCols) * 2;
    wgmma_ss<G::kBlockK>(sc, desc<DH>(q_rows + atom * G::kQAtomBytes + col, 16, 8 * G::kSwizzle),
                         desc<DH>(kt + atom * G::kKAtomBytes + col, 16, 8 * G::kSwizzle),
                         kk > 0);
  }
}

// O += P V: V's rows 16kk..16kk+15 of every atom, N-major.
template <int DH>
__device__ __forceinline__ void start_pv(float (&acc)[DH / 2],
                                         const uint32_t (&pa)[Geo<DH>::kBlockK / 16][4],
                                         uint32_t vt) {
  using G = Geo<DH>;
#pragma unroll
  for (int kk = 0; kk < G::kBlockK / 16; ++kk)
    wgmma_rs<DH>(acc, pa[kk],
                 desc<DH>(vt + kk * 16 * G::kSwizzle, G::kKAtomBytes, 8 * G::kSwizzle));
}

// The probabilities (already e^(S - m), float), rounded to bf16 into the A
// registers of P V: k-step kk covers score blocks 2kk and 2kk + 1.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// One thread's two rows: positions, masks, and the running max and sum
// (this lane's share of each row's sum), over kv tiles of BK columns.
template <int BK>
struct Rows {
  int p0, p1, full_end, kv_len, prefix_len, causal;
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  // Scale and mask the scores of the tile at column t0 (only a tile
  // that straddles full_end is masked; hidden scores become -inf), move
  // the running max, and replace each score by e^(score - max); a0, a1
  // are the rows' rescale factors.
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int t0, float scale,
                                          float& a0, float& a1, int t) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (t0 + BK > full_end) {                    // one branch for the tile
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t0 + 8 * j + 2 * t + e;
          const bool in = col < kv_len, pre = col < prefix_len;
          const bool ok0 = in && (!causal || col <= p0 || pre);
          const bool ok1 = in && (!causal || col <= p1 || pre);
          sc[4 * j + e] = ok0 ? sc[4 * j + e] * scale : -INFINITY;
          sc[4 * j + 2 + e] = ok1 ? sc[4 * j + 2 + e] * scale : -INFINITY;
        }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= scale;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {       // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    a0 = expf(m0 - n0);
    a1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = expf(sc[4 * j + e] - n0);
        sc[4 * j + 2 + e] = expf(sc[4 * j + 2 + e] - n1);
        sum0 += sc[4 * j + e];
        sum1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  }
};

// Block (h, b, z): query rows [s0, s0 + 128) of head h in batch row b,
// with z = 0 taking the last query block, so the longest causal rows start
// first.  Consumer warpgroup w owns rows 64w..64w+63; in it, warp u and
// lane (g, t) = (lane / 4, lane % 4) hold rows 16u + g and 16u + g + 8 and,
// of each 8-column block j of a score or output tile, columns 8j + 2t and
// 8j + 2t + 1 (the wgmma accumulator layout; registers 4j + {0, 1} and
// 4j + {2, 3}).
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse, int S, int H,
                       int group, int causal, int prefix_len, int kv_len, int q_start,
                       const int* __restrict__ start, int extent, float scale) {
  using G = Geo<DH>;
  constexpr int kBlockK = G::kBlockK, kStages = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms
  const uint32_t sq = base;
  const uint32_t sk = base + G::kQTileBytes;                    // + stage tile
  const uint32_t sv = sk + kStages * G::kKTileBytes;
  const uint32_t bars = sv + kStages * G::kKTileBytes;
  const uint32_t qbar = bars + 16 * kStages;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s)

  from_device(start, extent, q_start, kv_len);
  const int h = blockIdx.x, b = blockIdx.y;
  const int s0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;
  const int rows = min(kBlockQ, S - s0);
  int col_end = kv_len;            // the last column any row can see, + 1
  if (causal) col_end = min(col_end, max(q_start + s0 + rows, prefix_len));
  const int n_tiles = (col_end + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const int kvh = h / group;
      mbar_expect_tx(qbar, G::kQTileBytes);
#pragma unroll
      for (int a = 0; a < G::kAtoms; ++a)
        tma_load_4d(sq + a * G::kQAtomBytes, &tq, qbar, a * G::kAtomCols, h, s0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (kStages + st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * G::kKTileBytes);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          const uint32_t off = st * G::kKTileBytes + a * G::kKAtomBytes;
          tma_load_4d(sk + off, &tk, full, a * G::kAtomCols, kvh, i * kBlockK, b);
          tma_load_4d(sv + off, &tv, full, a * G::kAtomCols, kvh, i * kBlockK, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    if (64 * wgi >= rows) {          // every row of this warpgroup is past S
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(bars + 8 * (i % kStages), (i / kStages) & 1);
        if (lane == 0) mbar_arrive(bars + 8 * (kStages + i % kStages));
      }
      return;
    }
    const int r0 = 64 * wgi + 16 * warp + g;                // rows r0, r0 + 8
    Rows<kBlockK> rw;
    rw.p0 = q_start + s0 + r0;                              // their positions
    rw.p1 = rw.p0 + 8;
    // columns visible to every row of this warpgroup: [0, full_end)
    rw.full_end = kv_len;
    if (causal) rw.full_end = min(kv_len, max(q_start + s0 + 64 * wgi + 1, prefix_len));
    rw.kv_len = kv_len;
    rw.prefix_len = prefix_len;
    rw.causal = causal;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float sc[kBlockK / 2];
    uint32_t pa[kBlockK / 16][4];
    const uint32_t q_rows = sq + 64 * wgi * G::kSwizzle;
    mbar_wait(qbar, 0);

    // Tile i's softmax overlaps tile i - 1's P V on the tensor cores: S_i
    // and P_{i-1} V_{i-1} are started together, S_i is awaited, its
    // probabilities computed, then P V is awaited before the rescale.
    // When both warpgroups have rows they take turns to start them (named
    // barriers 3 and 4, warpgroup 0 first), so one's softmax runs while
    // the other's products do.
    const bool pingpong = rows > 64;
    const int mine = 3 + wgi, other = 4 - wgi;
    if (pingpong && wgi == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    auto turn = [&] {
      if (pingpong) asm volatile("bar.sync %0, 256;\n" ::"r"(mine) : "memory");
    };
    auto pass = [&](bool last) {
      if (pingpong && !(last && wgi == 1))
        asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
    };
    mbar_wait(bars, 0);
    fence_regs(sc);
    turn();
    wgmma_fence();
    start_s<DH>(sc, q_rows, sk);
    wgmma_commit();
    pass(false);
    wgmma_wait<0>();
    fence_regs(sc);
    float a0, a1;
    rw.softmax(sc, 0, scale, a0, a1, t);
    pack_p<kBlockK>(pa, sc);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(bars + 8 * st, (i / kStages) & 1);
      fence_regs(sc);
      fence_regs(acc);
      turn();
      wgmma_fence();
      start_s<DH>(sc, q_rows, sk + st * G::kKTileBytes);
      wgmma_commit();
      start_pv<DH>(acc, pa, sv + prev * G::kKTileBytes);
      wgmma_commit();
      pass(false);
      wgmma_wait<1>();               // S_i is in
      fence_regs(sc);
      rw.softmax(sc, i * kBlockK, scale, a0, a1, t);
      wgmma_wait<0>();               // P_{i-1} V_{i-1} is in
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + prev));
      if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {   // a max moved
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          acc[4 * n] *= a0;
          acc[4 * n + 1] *= a0;
          acc[4 * n + 2] *= a1;
          acc[4 * n + 3] *= a1;
        }
      }
      pack_p<kBlockK>(pa, sc);
    }
    {
      const int last = (n_tiles - 1) % kStages;
      fence_regs(acc);
      turn();
      wgmma_fence();
      start_pv<DH>(acc, pa, sv + last * G::kKTileBytes);
      wgmma_commit();
      pass(true);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + last));
    }

    float l0 = rw.l0, l1 = rw.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (lse != nullptr && t == 0) {   // each row's m + log(l), (B, H, S)
      float* lrow = lse + (int64_t(blockIdx.y) * H + h) * S + s0 + r0;
      if (s0 + r0 < S) lrow[0] = rw.m0 + logf(l0);
      if (s0 + r0 + 8 < S) lrow[8] = rw.m1 + logf(l1);
    }
    // The output tile goes through this warpgroup's Q rows in shared
    // memory (no wgmma reads them any more), 16-byte chunks XOR-swizzled
    // by row, then out to global memory as whole 16-byte chunks of rows.
    unsigned char* qs = smem_raw + (sq - smem_u32(smem_raw)) + 64 * wgi * G::kSwizzle;
    constexpr int kChunks = G::kSwizzle / 16;        // 16-byte chunks a row
    auto chunk = [&](int r, int c) {                 // row r, 8-column chunk c
      return qs + (c / kChunks) * G::kQAtomBytes + r * G::kSwizzle +
             ((c % kChunks) ^ (r % kChunks)) * 16;
    };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      const float d = half ? d1 : d0;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(chunk(r, n) + 4 * t) =
            pack_bf16(acc[4 * n + 2 * half] / d, acc[4 * n + 2 * half + 1] / d);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
    for (int i = tid; i < 64 * (DH / 8); i += 128) {
      const int r = i / (DH / 8), c = i % (DH / 8);
      const int row = s0 + 64 * wgi + r;
      if (row < S)
        *reinterpret_cast<uint4*>(o + ((int64_t(blockIdx.y) * S + row) * H + h) * DH + 8 * c) =
            *reinterpret_cast<const uint4*>(chunk(r, c));
    }
  }
}

}  // namespace wg

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 int B, int S, int H, int KV, int causal, int prefix_len, int kv_len,
                 int q_start, const int* start, int extent, float scale,
                 const long long* st, cudaStream_t stream) {
  using G = wg::Geo<DH>;
  using c4cam_bf16::encode;
  const CUtensorMapSwizzle sw = G::kTmaSwizzle;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, S, H, DH, st[0], st[1], st[2], G::kAtomCols, wg::kBlockQ, sw) ||
      !encode(&tk, k, B, extent, KV, DH, st[3], st[4], st[5], G::kAtomCols, G::kBlockK,
              sw) ||
      !encode(&tv, v, B, extent, KV, DH, st[6], st[7], st[8], G::kAtomCols, G::kBlockK,
              sw))
    return int(cudaErrorInvalidValue);
  auto kernel = wg::flash_fwd_wgmma_kernel<DH>;
  static std::atomic<uint64_t> ready{0};
  const cudaError_t err = allow_smem(kernel, G::kSmem, ready);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(H, B, (S + wg::kBlockQ - 1) / wg::kBlockQ);
  kernel<<<grid, wg::kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, S, H, H / KV, causal, prefix_len,
      kv_len, q_start, start, extent, scale);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Decode and short chunks: flash_fwd_splitkv_kernel + its combine
// ---------------------------------------------------------------------------

namespace sk {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBlockK = 64;        // kv rows per tile; 16 score columns a warp
constexpr int kLdp = kBlockK + 8;  // padded row of the probability tile

// cp.async ring depth: 3 (two blocks an SM at dh 128), but 2 at dh 256,
// where three stages of four row tiles (242 KB) would not fit one block.
template <int DH, int RT>
struct Smem {
  static constexpr int kStages = DH > 128 ? 2 : 3;
  static constexpr int kLd = DH + 8;   // padded tile row (bf16): no bank conflicts
  static constexpr size_t kBytes =
      sizeof(bf16) * (RT * 16 * kLd + 2 * kStages * kBlockK * kLd + RT * 16 * kLdp) +
      sizeof(float) * 2 * 4 * RT * 16;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

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

// The A fragment of rows [0, 16) and columns [0, 16) of a row-major tile
// with row stride ld (lane (g, t) reads rows g and g + 8).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile, int ld,
                                       int g, int t) {
  const bf16* p = tile + g * ld + 2 * t;
  a[0] = ld2(p);
  a[1] = ld2(p + 8 * ld);
  a[2] = ld2(p + 8);
  a[3] = ld2(p + 8 * ld + 8);
}

// B fragments of two 8x8 bf16 blocks stacked in k, read transposed from a
// row-major tile (lanes 0-15 give the 16 row addresses).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// Start copying rows [r0, r0 + 64) of one head into a [64][DH + 8] tile,
// 16 bytes per cp.async; rows at or past r_end are zero-filled (no byte is
// read for them).
template <int DH>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src, int64_t rs,
                                      int r0, int r_end) {
  constexpr int kPerRow = DH / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kBlockK * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    const int row = min(r0 + r, r_end - 1);       // an address inside the tensor
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(smem_u32(tile + r * (DH + 8) + c)),
                   "l"(src + int64_t(row) * rs + c), "r"(r0 + r < r_end ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (split, kvh, b): kv tiles [split * per, + per) of
// kv head kvh in batch row b, for its R = S * group query rows, row
// r = s * group + j being query row s of head kvh * group + j.  RT m16
// row tiles cover R (rows past R are zero).  Lane (g, t) holds rows
// 16rt + g and 16rt + g + 8.  Warp w computes the scores of tile columns
// [16w, 16w + 16) and the output columns [8 kNpw w, 8 kNpw (w + 1)) below
// dh (kNpw = ceil(dh / 32) 8-column tiles: at dh 80, 3, 3, 3 and 1); row
// maxima and sums meet in shared memory, the probabilities too (the A
// operand of P V).  Writes the split's m, l (float32) and unnormalised acc
// to `part`: acc [B][KV][splits][R][DH], then m and l [B][KV][splits][R].
template <int DH, int RT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_splitkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, float* __restrict__ part,
                         int S, int KV, int group, int causal, int prefix_len,
                         int kv_len, int q_start, const int* __restrict__ start,
                         int extent, int split_target, int64_t qsb,
                         int64_t qss, int64_t qsh, int64_t ksb, int64_t kst,
                         int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh,
                         float scale) {
  constexpr int kLd = DH + 8;
  constexpr int kRows = 16 * RT;
  constexpr int kStages = Smem<DH, RT>::kStages;
  constexpr int kNpw = DH >= 32 ? (DH + 31) / 32 : 1;   // 8-column output tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kRows][kLd]
  bf16* ks = qs + kRows * kLd;                    // [kStages][kBlockK][kLd]
  bf16* vs = ks + kStages * kBlockK * kLd;        // [kStages][kBlockK][kLd]
  bf16* ps = vs + kStages * kBlockK * kLd;        // [kRows][kLdp]
  float* red_max = reinterpret_cast<float*>(ps + kRows * kLdp);   // [4][kRows]
  float* red_sum = red_max + 4 * kRows;                           // [4][kRows]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int R = S * group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  from_device(start, extent, q_start, kv_len);
  int col_end = kv_len;
  if (causal) col_end = min(col_end, max(q_start + S, prefix_len));
  const int n_tiles = (col_end + kBlockK - 1) / kBlockK;
  // the visible tiles spread over up to split_target splits of per tiles
  // (flash_attention.py, `_route`); the grid may hold more splits (sized
  // for a cache's capacity), and those past the last tile write m = -1e30,
  // l = 0, acc = 0, which the combine weighs 0
  const int per = (n_tiles + max(1, min(n_tiles, split_target)) - 1) /
                  max(1, min(n_tiles, split_target));
  const int tile0 = min(split * per, n_tiles);
  const int n_here = min(tile0 + per, n_tiles) - tile0;

  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;
  for (int i = threadIdx.x; i < kRows * (DH / 8); i += kThreads) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < R)
      x = *reinterpret_cast<const uint4*>(q + b * qsb + (r / group) * qss +
                                          (kvh * group + r % group) * qsh + c);
    *reinterpret_cast<uint4*>(qs + r * kLd + c) = x;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_here) {
      stage<DH>(ks + s * kBlockK * kLd, kb, kst, (tile0 + s) * kBlockK, col_end);
      stage<DH>(vs + s * kBlockK * kLd, vb, vst, (tile0 + s) * kBlockK, col_end);
    }
    cp_async_commit();
  }

  float m[RT][2], l[RT][2], acc[RT][kNpw][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[rt][hf] = kNegBig;
      l[rt][hf] = 0.f;
    }
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int n = 0; n < kNpw; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[rt][n][j] = 0.f;
  const int col0 = kNpw * 8 * warp;               // this warp's output columns
  const bool pv = col0 < DH;

  for (int i = 0; i < n_here; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();              // tile i is in; tile i - 1's readers are done
    {
      const int nx = i + kStages - 1;
      if (nx < n_here) {
        const int slot = nx % kStages;
        stage<DH>(ks + slot * kBlockK * kLd, kb, kst, (tile0 + nx) * kBlockK, col_end);
        stage<DH>(vs + slot * kBlockK * kLd, vb, vst, (tile0 + nx) * kBlockK, col_end);
      }
      cp_async_commit();
    }
    const bf16* kt = ks + (i % kStages) * kBlockK * kLd;
    const bf16* vt = vs + (i % kStages) * kBlockK * kLd;
    const int t0 = (tile0 + i) * kBlockK;

    float sc[RT][2][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[rt][nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t kb0[2], kb1[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* kr = kt + (16 * warp + 8 * nt + g) * kLd + 16 * kk + 2 * t;
        kb0[nt] = ld2(kr);
        kb1[nt] = ld2(kr + 8);
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        uint32_t a[4];
        load_a(a, qs + 16 * rt * kLd + 16 * kk, kLd, g, t);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(sc[rt][nt], a, kb0[nt], kb1[nt]);
      }
    }
    // scale, hide, and each row's max over this warp's 16 columns
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * rt + g + 8 * hf;
        const int pos = q_start + row / group;
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = t0 + 16 * warp + 8 * nt + 2 * t + e;
            const bool ok = col < col_end && (!causal || col <= pos || col < prefix_len);
            const float x = ok ? sc[rt][nt][2 * hf + e] * scale : -INFINITY;
            sc[rt][nt][2 * hf + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (t == 0) red_max[warp * kRows + row] = mx;
      }
    __syncthreads();
    float alpha[RT][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * rt + g + 8 * hf;
        float mx = red_max[row];
#pragma unroll
        for (int w = 1; w < 4; ++w) mx = fmaxf(mx, red_max[w * kRows + row]);
        const float mn = fmaxf(m[rt][hf], mx);
        alpha[rt][hf] = expf(m[rt][hf] - mn);
        m[rt][hf] = mn;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float p0 = expf(sc[rt][nt][2 * hf] - mn);
          const float p1 = expf(sc[rt][nt][2 * hf + 1] - mn);
          sum += p0 + p1;
          *reinterpret_cast<uint32_t*>(ps + row * kLdp + 16 * warp + 8 * nt + 2 * t) =
              pack_bf16(p0, p1);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t == 0) red_sum[warp * kRows + row] = sum;
      }
    __syncthreads();
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * rt + g + 8 * hf;
        float sum = red_sum[row];
#pragma unroll
        for (int w = 1; w < 4; ++w) sum += red_sum[w * kRows + row];
        l[rt][hf] = l[rt][hf] * alpha[rt][hf] + sum;
      }
    if (pv) {
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int n = 0; n < kNpw; ++n) {
          acc[rt][n][0] *= alpha[rt][0];
          acc[rt][n][1] *= alpha[rt][0];
          acc[rt][n][2] *= alpha[rt][1];
          acc[rt][n][3] *= alpha[rt][1];
        }
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t vb0[kNpw], vb1[kNpw];
#pragma unroll
        for (int n = 0; n < kNpw; ++n)
          if (col0 + 8 * n < DH)
            ldmatrix_x2_trans(vb0[n], vb1[n],
                              vt + (16 * kk + (lane & 15)) * kLd + col0 + 8 * n);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          uint32_t a[4];
          load_a(a, ps + 16 * rt * kLdp + 16 * kk, kLdp, g, t);
#pragma unroll
          for (int n = 0; n < kNpw; ++n)
            if (col0 + 8 * n < DH) mma_bf16(acc[rt][n], a, vb0[n], vb1[n]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int64_t total = int64_t(gridDim.z) * KV * gridDim.x * R;
  const int64_t row0 = ((int64_t(b) * KV + kvh) * gridDim.x + split) * R;
  float* pacc = part + row0 * DH;
  float* pm = part + total * DH + row0;
  float* pl = pm + total;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * rt + g + 8 * hf;
      if (row >= R) continue;
#pragma unroll
      for (int n = 0; n < kNpw; ++n)
        if (col0 + 8 * n < DH)
          *reinterpret_cast<float2*>(pacc + int64_t(row) * DH + col0 + 8 * n + 2 * t) =
              make_float2(acc[rt][n][2 * hf], acc[rt][n][2 * hf + 1]);
      if (warp == 0 && t == 0) {
        pm[row] = m[rt][hf];
        pl[row] = l[rt][hf];
      }
    }
}

// Block (r, kvh, b) merges the splits of folded row r and writes output
// row s = r / group of head kvh * group + r % group.  The 4 warps find
// m* and the weights e^(m_i - m*) over the splits together, then warp w
// sums the acc rows of splits w, w + 4, ... (lane: columns lane + 32c),
// and the four partial sums meet in shared memory.
template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_splitkv_combine(const float* __restrict__ part, bf16* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int KV, int group,
                          int n_splits) {
  constexpr int kCols = (DH + 31) / 32;
  extern __shared__ float wsm[];      // [n_splits] weights, then [4][DH] sums
  __shared__ float red[4];
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = S * group;
  const int64_t total = int64_t(gridDim.z) * KV * n_splits * R;
  const int64_t row0 = (int64_t(b) * KV + kvh) * n_splits * R + r;
  const float* pm = part + total * DH + row0;
  const float* pl = pm + total;

  float mx = kNegBig;
  for (int i = threadIdx.x; i < n_splits; i += 128) {
    wsm[i] = pm[int64_t(i) * R];
    mx = fmaxf(mx, wsm[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();                    // red is reused below
  float l = 0.f;
  for (int i = threadIdx.x; i < n_splits; i += 128) {   // the thread's own m_i
    const float w = expf(wsm[i] - mx);
    wsm[i] = w;
    l += pl[int64_t(i) * R] * w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = red[0] + red[1] + red[2] + red[3];
  if (lse != nullptr && threadIdx.x == 0)
    lse[(int64_t(b) * H + kvh * group + r % group) * S + r / group] = mx + logf(l);

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll 8
  for (int i = warp; i < n_splits; i += 4) {
    const float w = wsm[i];
    const float* src = part + (row0 + int64_t(i) * R) * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < DH) acc[c] += src[lane + 32 * c] * w;
  }
  float* sums = wsm + n_splits;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (lane + 32 * c < DH) sums[warp * DH + lane + 32 * c] = acc[c];
  __syncthreads();
  for (int d = threadIdx.x; d < DH; d += 128) {     // dh 256: two columns a thread
    const float a = (sums[d] + sums[DH + d]) + (sums[2 * DH + d] + sums[3 * DH + d]);
    o[((int64_t(b) * S + r / group) * H + kvh * group + r % group) * DH + d] =
        __float2bfloat16_rn(a / fmaxf(l, 1e-30f));
  }
}

}  // namespace sk

template <int DH, int RT>
int launch_splitkv_rt(const void* q, const void* k, const void* v, void* o,
                      void* part, float* lse, int B, int S, int H, int KV, int causal,
                      int prefix_len, int kv_len, int q_start, const int* start,
                      int extent, float scale, int split_target, int n_splits,
                      const long long* st, cudaStream_t stream) {
  constexpr size_t kSmem = sk::Smem<DH, RT>::kBytes;
  auto kernel = sk::flash_fwd_splitkv_kernel<DH, RT>;
  static std::atomic<uint64_t> ready{0};
  cudaError_t err = allow_smem(kernel, kSmem, ready);
  if (err != cudaSuccess) return int(err);
  const int group = H / KV;
  kernel<<<dim3(n_splits, KV, B), sk::kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(part), S, KV, group,
      causal, prefix_len, kv_len, q_start, start, extent, split_target, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  sk::flash_fwd_splitkv_combine<DH>
      <<<dim3(S * group, KV, B), 128, sizeof(float) * (n_splits + 4 * DH), stream>>>(
          static_cast<const float*>(part), static_cast<bf16*>(o), lse, S, H, KV, group,
          n_splits);
  return int(cudaGetLastError());
}

// one m16 row tile up to 16 folded rows, four up to 64
template <int DH>
int launch_splitkv(const void* q, const void* k, const void* v, void* o,
                   void* part, float* lse, int B, int S, int H, int KV, int causal,
                   int prefix_len, int kv_len, int q_start, const int* start,
                   int extent, float scale, int split_target, int n_splits,
                   const long long* st, cudaStream_t stream) {
  if (S * (H / KV) <= 16)
    return launch_splitkv_rt<DH, 1>(q, k, v, o, part, lse, B, S, H, KV, causal,
                                    prefix_len, kv_len, q_start, start, extent, scale,
                                    split_target, n_splits, st, stream);
  return launch_splitkv_rt<DH, 4>(q, k, v, o, part, lse, B, S, H, KV, causal,
                                  prefix_len, kv_len, q_start, start, extent, scale,
                                  split_target, n_splits, st, stream);
}

// route 0: launch<DH, TQ, TKV> (FMA); 1: launch_wgmma<DH>; 2: launch_splitkv<DH>
template <typename TQ, typename TKV>
int by_dim(int dh, int route, const void* q, const void* k, const void* v,
           void* o, void* part, float* lse, int B, int S, int H, int KV, int causal,
           int prefix_len, int kv_len, int q_start, const int* start, int extent,
           float scale, int split_target, int n_splits, const long long* st,
           cudaStream_t s) {
  constexpr bool kBf16 = std::is_same_v<TQ, bf16>;
#define C4CAM_FLASH_CASE(D)                                                         \
  case D:                                                                           \
    if constexpr (kBf16) {                                                          \
      if (route == 1)                                                               \
        return launch_wgmma<D>(q, k, v, o, lse, B, S, H, KV, causal, prefix_len,    \
                               kv_len, q_start, start, extent, scale, st, s);       \
      return launch_splitkv<D>(q, k, v, o, part, lse, B, S, H, KV, causal,         \
                               prefix_len, kv_len, q_start, start, extent, scale,   \
                               split_target, n_splits, st, s);                      \
    } else {                                                                        \
      return launch<D, TQ, TKV>(q, k, v, o, lse, B, S, H, KV, causal, prefix_len,   \
                                kv_len, q_start, start, extent, scale, st, s);      \
    }
  switch (dh) {
    C4CAM_FLASH_CASE(16)
    C4CAM_FLASH_CASE(32)
    C4CAM_FLASH_CASE(64)
    C4CAM_FLASH_CASE(80)
    C4CAM_FLASH_CASE(128)
    C4CAM_FLASH_CASE(256)
    default: return int(cudaErrorInvalidValue);
  }
#undef C4CAM_FLASH_CASE
}

}  // namespace

// q (B, S, H, dh), k / v (B, T, KV, dh) with unit last stride and 16-byte
// aligned base pointers and strides; o (B, S, H, dh) contiguous, q's dtype.
// p holds, in order: B, S, H, KV, dh, q_bf16, kv_bf16 (bfloat16 over
// float32; a bfloat16 q takes a bfloat16 k / v only), causal, prefix_len,
// kv_len (in 1..T), q_start, route (0 float32 FMA for a float32 q, 1
// wgmma, 2 split-KV: both bf16, split-KV for S * H / KV <= 64), the
// splits a (b, kv head) pair aims for (>= 1: the visible tiles are cut
// into splits of ceil(tiles / min(tiles, that)) tiles) and the grid's
// split count (<= 4096; with `start`, at least the cut of any live
// length: the wrapper passes min(T's tiles, the aim), since the cut is not
// monotone in the tiles; `part` is float32 scratch of B * KV * splits *
// S * (H / KV) * (dh + 2) values), then the strides in elements of q
// (b, s, h), k (b, t, h) and v (b, t, h), then the softmax scale as the
// bit pattern of a float32 (1/sqrt of the caller's head dim, which the
// wrapper may have zero-padded to dh), then T, the rows of the k / v
// views.  `start`, when not null, is a device int32 added to q_start and
// kv_len by the kernels (kv_len then capped at T): a call captured in a
// CUDA graph reads it at every replay.  `lse`, when not null, receives each
// row's float32 log-sum-exp m + log(l) of the scaled scores, (B, H, S)
// contiguous: the backward's input.  Returns a cudaError_t code.
extern "C" int c4cam_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, void* part, float* lse,
                                     const int* start, const long long* p,
                                     void* stream) {
  for (int i = 0; i < 14; ++i)
    if (p[i] < 0 || p[i] > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (p[23] < 0 || p[23] > 0xffffffffLL) return int(cudaErrorInvalidValue);
  if (p[24] < 1 || p[24] > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const uint32_t scale_bits = uint32_t(p[23]);
  float scale;
  memcpy(&scale, &scale_bits, sizeof scale);
  if (!(scale > 0.f) || isinf(scale)) return int(cudaErrorInvalidValue);
  const int B = int(p[0]), S = int(p[1]), H = int(p[2]), KV = int(p[3]), dh = int(p[4]);
  const int q_bf16 = int(p[5]), kv_bf16 = int(p[6]), causal = int(p[7]);
  const int prefix_len = int(p[8]), kv_len = int(p[9]), q_start = int(p[10]);
  const int route = int(p[11]), split_target = int(p[12]), n_splits = int(p[13]);
  const int extent = int(p[24]);
  const long long* st = p + 14;
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || kv_len < 1 || kv_len > extent ||
      H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const bool bf = q_bf16 && kv_bf16;
  if (route > 2 || (route == 0) == bool(q_bf16) || (route && !bf) ||
      (route == 2 && (S * (H / KV) > 64 || split_target < 1 || n_splits < 1 ||
                      n_splits > 4096 || part == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf)
    return by_dim<bf16, bf16>(dh, route, q, k, v, o, part, lse, B, S, H, KV, causal,
                              prefix_len, kv_len, q_start, start, extent, scale,
                              split_target, n_splits, st, s);
  if (kv_bf16)
    return by_dim<float, bf16>(dh, route, q, k, v, o, part, lse, B, S, H, KV, causal,
                               prefix_len, kv_len, q_start, start, extent, scale,
                               split_target, n_splits, st, s);
  return by_dim<float, float>(dh, route, q, k, v, o, part, lse, B, S, H, KV, causal,
                              prefix_len, kv_len, q_start, start, extent, scale,
                              split_target, n_splits, st, s);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
