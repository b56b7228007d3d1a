// flash_attention_bwd: the backward of B7's online-softmax GQA attention
// (sm_90a).
//
// Replaces no TPU kernel: the reference trains through jax's autodiff of
// the plain `attn_core` (src/repro/models/layers.py), which never reaches
// its Pallas forward.  The port's attention runs B7 on the card, so its
// gradient needs a kernel of its own: this one, behind
// `flash_attention.FlashAttentionFn`.  Contract (the forward's, see
// flash_attention.cu): q, o, dO (B, S, H, dh); k, v, dK, dV (B, T, KV, dh),
// all contiguous, one dtype (bfloat16 or float32); lse and D (B, H, S)
// float32; query head h reads kv head h / (H / KV); row s sits at q_start + s
// and sees column t when t < kv_len and, if causal, t <= q_start + s or
// t < prefix_len.  With the forward's row log-sum-exp lse (of the scaled
// scores) it recomputes, tile by tile,
//
//   P = exp(q.k * scale - lse)      (0 where hidden)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - D),   D = rowsum(dO * O)
//   dQ = scale * dS K,   dK = scale * dS^T Q
//
// in float32 and stores dQ, dK, dV in the input dtype.  Three kernels:
//
// * flash_bwd_dot_kernel: D, one warp a row.
// * flash_bwd_dkdv_kernel (float32; flash_bwd_dkdv_mma_kernel for bf16): a
//   block owns one (batch row, kv head, kv tile);
//   it walks, in a fixed order, the kv head's H / KV query heads and, for
//   each, the 64-row q tiles that can see the tile (causal: from the first
//   row at or past the tile's first column; the prefix's tiles from row 0),
//   recomputing S and dP and summing P^T dO and dS^T Q into registers.  The
//   group's query heads meet in those registers, so no block writes a dK /
//   dV row another block writes: no atomics, the same sums in the same
//   order on every run.
// * flash_bwd_dq_kernel (flash_bwd_dq_mma_kernel): a block owns one
//   (batch row, head, q tile) and walks
//   the kv tiles its rows can see, in order, summing dS K.
//
// Two routes, one per dtype, the same blocks and walks.  bf16 (training):
// the tensor cores, mma.sync m16n8k16 with float32 accumulators, 8 warps;
// the tiles in shared memory as bf16; P and dS rounded to bf16 between
// the two products that use them (the forward rounds P so too); the
// score tile of a (q tile, kv tile) pair cut among the warps by m16 tiles
// and n8 column groups, the outputs likewise, and the P / dS operands
// taken from shared memory (load_a) and the dO / Q / K ones through
// ldmatrix.trans.  float32 (the parity checks): the CUDA cores in FMA,
// staged as float32 as the forward's FMA route does, thread (ty, tx)
// holding score rows 4ty..4ty+3 against columns tx + 16c and output
// columns tx + 16n.  The kv tile is 64 rows (32 at dh 256, where the
// tiles and the two 64-row q tiles must fit 227 KB).  The work is five
// products of 2 S T dh FLOP a head (S, dP, dV, dK, dQ; halved when
// causal); the two-kernel split recomputes S and dP in the dQ kernel,
// seven in all.  Loads are plain 16-byte copies between the products,
// not a pipeline: the tiles' latency is exposed.
//
// Bound on an H100 SXM: that FLOP count at the bf16 tensor-core peak (989
// TFLOP/s) or the bytes of q, k, v, o, dO, lse and dQ, dK, dV at 3.35 TB/s,
// the larger; at qwen2.5-14b's (2048, 40 / 8, 128) causal shape 0.109 ms a
// batch row, compute-bound.  A simple kernel first: wgmma, TMA and a
// pipelined walk are a later redesign.  Head dims: 16, 32, 64, 80, 128, 256 (the wrapper
// zero-pads others to the next one, the scale staying the caller's).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;

template <int DH>
struct Geo {
  static constexpr int kBlockK = DH > 128 ? 32 : 64;  // kv rows a tile
  static constexpr int kLd = DH + 4;                  // float row of a Q/K/V/dO tile
  static constexpr int kLdp = kBlockK + 4;            // float row of a P / dS tile
  static constexpr int kC = kBlockK / 16;             // score columns a thread
  static constexpr int kN = DH / 16;                  // output columns a thread
  static constexpr int kR = kBlockK / 16;             // dK / dV rows a thread
  // dK / dV: K, V, Q, dO tiles, P and dS, lse and D of the q tile
  static constexpr size_t kSmemKV =
      sizeof(float) * (size_t(2 * kBlockK + 2 * kBlockQ) * kLd + 2 * kBlockQ * kLdp +
                       2 * kBlockQ);
  // dQ: the same without the P tile
  static constexpr size_t kSmemQ =
      sizeof(float) * (size_t(2 * kBlockK + 2 * kBlockQ) * kLd + kBlockQ * kLdp +
                       2 * kBlockQ);
  static_assert(kSmemKV <= 232448, "shared memory of one block");
  static_assert(DH % 16 == 0 && kBlockK % 16 == 0, "whole 16-column groups");
};

// cudaFuncSetAttribute(kernel, max dynamic shared memory) once per kernel
// and device; `done` holds a bit per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(bf16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// 16-byte loads converted to float32.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const bf16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Stage rows [r0, r0 + ROWS) of one head (row stride `rs`, elements) as
// float32 into a [ROWS][DH + 4] tile; rows at or past `r_end` are zero.
template <int DH, int ROWS, typename T>
__device__ __forceinline__ void stage(float* tile, const T* src, int64_t rs, int r0,
                                      int r_end) {
  constexpr int V = Vec<T>::N;
  constexpr int kPerRow = DH / V;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
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

// D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in float32; warp w of
// block i takes row 8i + w of the (B, S, H) rows, lanes the columns d = lane
// + 32j, summed lane by lane and then by the same shuffle tree every run.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                     float* __restrict__ dsum, int S, int H, int dh, int64_t rows) {
  const int64_t r = int64_t(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* a = dout + r * dh;
  const T* c = o + r * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc = fmaf(to_float(a[d]), to_float(c[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = int(r % H);
    const int64_t bs = r / H;                 // b * S + s
    const int64_t b = bs / S, s = bs % S;
    dsum[(b * H + h) * S + s] = acc;
  }
}

// The scores S = Q K^T and dP = dO V^T of one (q tile, kv tile) pair for
// this thread's rows 4ty + i and columns tx + 16c, then P = exp(S scale -
// lse) and dS = P (dP - D) under the forward's masks, written to ps / dss
// ([kBlockQ][kLdp]; ps may be null).  Rows at or past S are zero.
template <int DH>
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, const float* rl, const float* rd,
                                       float* ps, float* dss, int s0, int S, int t0,
                                       int causal, int prefix_len, int kv_len,
                                       int q_start, float scale) {
  using G = Geo<DH>;
  constexpr int kLd = G::kLd, kC = G::kC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[4][kC], dp[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      sc[i][c] = 0.f;
      dp[i][c] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], g[4], kk[kC], vv[kC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + d);
      g[i] = *reinterpret_cast<const float4*>(dos + (4 * ty + i) * kLd + d);
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      kk[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * kLd + d);
      vv[c] = *reinterpret_cast<const float4*>(vs + (tx + 16 * c) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float x = sc[i][c], y = dp[i][c];
        x = fmaf(a[i].x, kk[c].x, x);
        x = fmaf(a[i].y, kk[c].y, x);
        x = fmaf(a[i].z, kk[c].z, x);
        x = fmaf(a[i].w, kk[c].w, x);
        y = fmaf(g[i].x, vv[c].x, y);
        y = fmaf(g[i].y, vv[c].y, y);
        y = fmaf(g[i].z, vv[c].z, y);
        y = fmaf(g[i].w, vv[c].w, y);
        sc[i][c] = x;
        dp[i][c] = y;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, row = s0 + r, pos = q_start + row;
    const float lse = rl[r], dr = rd[r];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = t0 + tx + 16 * c;
      const bool ok = row < S && col < kv_len && (!causal || col <= pos || col < prefix_len);
      const float p = ok ? expf(sc[i][c] * scale - lse) : 0.f;
      if (ps != nullptr) ps[r * G::kLdp + tx + 16 * c] = p;
      dss[r * G::kLdp + tx + 16 * c] = p * (dp[i][c] - dr);
    }
  }
}

// The q tile's lse and D (zero past S).
__device__ __forceinline__ void stage_rows(float* rl, float* rd, const float* lse,
                                           const float* dsum, int64_t off, int s0, int S) {
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    const bool in = s0 + i < S;
    rl[i] = in ? lse[off + s0 + i] : 0.f;
    rd[i] = in ? dsum[off + s0 + i] : 0.f;
  }
}

// Block (kv tile, kv head, b): dK and dV of kv rows [t0, t0 + kBlockK).
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int Tk, int H,
                      int KV, int causal, int prefix_len, int kv_len, int q_start,
                      float scale) {
  using G = Geo<DH>;
  constexpr int kBlockK = G::kBlockK, kLd = G::kLd, kLdp = G::kLdp;
  constexpr int kN = G::kN, kR = G::kR;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // [kBlockK][kLd]
  float* vs = ks + kBlockK * kLd;        // [kBlockK][kLd]
  float* qs = vs + kBlockK * kLd;        // [kBlockQ][kLd]
  float* dos = qs + kBlockQ * kLd;       // [kBlockQ][kLd]
  float* ps = dos + kBlockQ * kLd;       // [kBlockQ][kLdp]
  float* dss = ps + kBlockQ * kLdp;      // [kBlockQ][kLdp]
  float* rl = dss + kBlockQ * kLdp;      // [kBlockQ]
  float* rd = rl + kBlockQ;              // [kBlockQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = blockIdx.x * kBlockK, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int64_t rs_q = int64_t(H) * DH, rs_k = int64_t(KV) * DH;

  // the first query row that sees a column of this tile
  int s_begin = 0;
  if (causal && t0 >= prefix_len) s_begin = min(S, max(0, t0 - q_start));
  s_begin -= s_begin % kBlockQ;
  if (t0 >= kv_len) s_begin = S;    // no row sees the tile: dK = dV = 0

  float dka[kR][kN], dva[kR][kN];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      dka[r][n] = 0.f;
      dva[r][n] = 0.f;
    }

  const T* kb = k + (int64_t(b) * Tk * KV + kvh) * DH;
  const T* vb = v + (int64_t(b) * Tk * KV + kvh) * DH;
  stage<DH, kBlockK>(ks, kb, rs_k, t0, kv_len);
  stage<DH, kBlockK>(vs, vb, rs_k, t0, kv_len);
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const T* qb = q + (int64_t(b) * S * H + h) * DH;
    const T* gb = dout + (int64_t(b) * S * H + h) * DH;
    const int64_t roff = (int64_t(b) * H + h) * S;
    for (int s0 = s_begin; s0 < S; s0 += kBlockQ) {
      __syncthreads();               // the previous q tile's readers are done
      stage<DH, kBlockQ>(qs, qb, rs_q, s0, S);
      stage<DH, kBlockQ>(dos, gb, rs_q, s0, S);
      stage_rows(rl, rd, lse, dsum, roff, s0, S);
      __syncthreads();
      scores<DH>(qs, dos, ks, vs, rl, rd, ps, dss, s0, S, t0, causal, prefix_len,
                 kv_len, q_start, scale);
      __syncthreads();               // P and dS are complete
#pragma unroll 2
      for (int i = 0; i < kBlockQ; ++i) {
        float pr[kR], dr[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          pr[r] = ps[i * kLdp + kR * ty + r];
          dr[r] = dss[i * kLdp + kR * ty + r];
        }
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float go = dos[i * kLd + tx + 16 * n];
          const float qq = qs[i * kLd + tx + 16 * n];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            dva[r][n] = fmaf(pr[r], go, dva[r][n]);
            dka[r][n] = fmaf(dr[r], qq, dka[r][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int t = t0 + kR * ty + r;
    if (t >= Tk) continue;
    const int64_t off = ((int64_t(b) * Tk + t) * KV + kvh) * DH;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      store(dk + off + tx + 16 * n, dka[r][n] * scale);
      store(dv + off + tx + 16 * n, dva[r][n]);
    }
  }
}

// Block (q tile, h, b): dQ of query rows [s0, s0 + 64) of head h.
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    T* __restrict__ dq, int S, int Tk, int H, int KV, int causal,
                    int prefix_len, int kv_len, int q_start, float scale) {
  using G = Geo<DH>;
  constexpr int kBlockK = G::kBlockK, kLd = G::kLd, kLdp = G::kLdp, kN = G::kN;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [kBlockQ][kLd]
  float* dos = qs + kBlockQ * kLd;       // [kBlockQ][kLd]
  float* ks = dos + kBlockQ * kLd;       // [kBlockK][kLd]
  float* vs = ks + kBlockK * kLd;        // [kBlockK][kLd]
  float* dss = vs + kBlockK * kLd;       // [kBlockQ][kLdp]
  float* rl = dss + kBlockQ * kLdp;      // [kBlockQ]
  float* rd = rl + kBlockQ;              // [kBlockQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int s0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(kBlockQ, S - s0);
  const int64_t rs_q = int64_t(H) * DH, rs_k = int64_t(KV) * DH;
  int col_end = kv_len;              // the last column any row can see, + 1
  if (causal) col_end = min(col_end, max(q_start + s0 + rows, prefix_len));

  const T* kb = k + (int64_t(b) * Tk * KV + kvh) * DH;
  const T* vb = v + (int64_t(b) * Tk * KV + kvh) * DH;
  stage<DH, kBlockQ>(qs, q + (int64_t(b) * S * H + h) * DH, rs_q, s0, S);
  stage<DH, kBlockQ>(dos, dout + (int64_t(b) * S * H + h) * DH, rs_q, s0, S);
  stage_rows(rl, rd, lse, dsum, (int64_t(b) * H + h) * S, s0, S);

  float dqa[4][kN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < kN; ++n) dqa[i][n] = 0.f;

  for (int t0 = 0; t0 < col_end; t0 += kBlockK) {
    __syncthreads();                 // the previous tile's readers are done
    stage<DH, kBlockK>(ks, kb, rs_k, t0, col_end);
    stage<DH, kBlockK>(vs, vb, rs_k, t0, col_end);
    __syncthreads();
    scores<DH>(qs, dos, ks, vs, rl, rd, nullptr, dss, s0, S, t0, causal, prefix_len,
               kv_len, q_start, scale);
    __syncthreads();                 // dS is complete
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = *reinterpret_cast<const float4*>(dss + (4 * ty + i) * kLdp + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* krow = ks + (j + u) * kLd + tx;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float kk = krow[16 * n];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = u == 0 ? d4[i].x : u == 1 ? d4[i].y : u == 2 ? d4[i].z : d4[i].w;
            dqa[i][n] = fmaf(x, kk, dqa[i][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = s0 + 4 * ty + i;
    if (row >= S) continue;
    T* out = dq + ((int64_t(b) * S + row) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < kN; ++n) store(out + tx + 16 * n, dqa[i][n] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: the same two kernels on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;      // 8 warps
constexpr int kBlockQ = 64;

// Tiles in shared memory are bf16, rows padded by 8 (16 bytes: ldmatrix
// rows stay aligned, consecutive rows fall in other banks).  In the dK / dV
// kernel the (kv x q) scores are cut among the warps as kMT m16 tiles of kv
// rows times kNW column groups of kNT n8 tiles; the (kv x dh) outputs as
// the same kMT m16 tiles times kNW column slices of kOut columns.
template <int DH>
struct Geo {
  static constexpr int kBlockK = DH > 128 ? 32 : 64;
  static constexpr int kLd = DH + 8;
  static constexpr int kLdS = kBlockQ + 8;        // P^T, dS^T: [kBlockK][kLdS]
  static constexpr int kLdQ = kBlockK + 8;        // dS (dQ kernel): [kBlockQ][kLdQ]
  static constexpr int kMT = kBlockK / 16;
  static constexpr int kNW = 8 / kMT;
  static constexpr int kNT = kBlockQ / 8 / kNW;
  static constexpr int kOut = DH / kNW;
  // dQ kernel: 4 m16 tiles of q rows x 2 column groups
  static constexpr int kNTq = kBlockK / 16;
  static constexpr int kOutQ = DH / 2;
  static constexpr size_t kSmemKV =
      sizeof(bf16) * (size_t(2 * kBlockK + 2 * kBlockQ) * kLd + 2 * kBlockK * kLdS) +
      sizeof(float) * 2 * kBlockQ;
  static constexpr size_t kSmemQ =
      sizeof(bf16) * (size_t(2 * kBlockK + 2 * kBlockQ) * kLd + kBlockQ * kLdQ) +
      sizeof(float) * 2 * kBlockQ;
  static_assert(kOut % 8 == 0 && kOutQ % 8 == 0, "whole n8 output tiles");
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
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
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile, int ld, int g,
                                       int t) {
  const bf16* p = tile + g * ld + 2 * t;
  a[0] = ld2(p);
  a[1] = ld2(p + 8 * ld);
  a[2] = ld2(p + 8);
  a[3] = ld2(p + 8 * ld + 8);
}

// B fragments of a 16 (k) x 8 (n) block of a row-major [k][n] tile, read
// transposed (lanes 0-15 give the 16 row addresses).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// Copy rows [r0, r0 + ROWS) of one head (row stride rs) into a [ROWS][DH + 8]
// bf16 tile, 16 bytes a load; rows at or past r_end are zero.
template <int DH, int ROWS>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src, int64_t rs, int r0,
                                      int r_end) {
  constexpr int kPerRow = DH / 8;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < r_end) x = *reinterpret_cast<const uint4*>(src + int64_t(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(tile + r * (DH + 8) + c) = x;
  }
}

// Block (kv tile, kv head, b): dK and dV of kv rows [t0, t0 + kBlockK).
// Per q tile: S^T = K Q^T and dP^T = V dO^T (warp w: kv rows 16 (w % kMT)
// on, q columns 8 kNT (w / kMT) on), P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - D) to shared memory in bf16, then dV += P^T dO and
// dK += dS^T Q (warp w: the same kv rows, dh columns kOut (w / kMT) on).
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Tk, int H, int KV,
            int causal, int prefix_len, int kv_len, int q_start, float scale) {
  using G = Geo<DH>;
  constexpr int kBlockK = G::kBlockK, kLd = G::kLd, kLdS = G::kLdS;
  constexpr int kNT = G::kNT, kON = G::kOut / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [kBlockK][kLd]
  bf16* vs = ks + kBlockK * kLd;                  // [kBlockK][kLd]
  bf16* qs = vs + kBlockK * kLd;                  // [kBlockQ][kLd]
  bf16* dos = qs + kBlockQ * kLd;                 // [kBlockQ][kLd]
  bf16* pt = dos + kBlockQ * kLd;                 // [kBlockK][kLdS]
  bf16* dst = pt + kBlockK * kLdS;                // [kBlockK][kLdS]
  float* rl = reinterpret_cast<float*>(dst + kBlockK * kLdS);   // [kBlockQ]
  float* rd = rl + kBlockQ;                                      // [kBlockQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % G::kMT, nw = warp / G::kMT;
  const int t0 = blockIdx.x * kBlockK, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int64_t rs_q = int64_t(H) * DH, rs_k = int64_t(KV) * DH;

  int s_begin = 0;
  if (causal && t0 >= prefix_len) s_begin = min(S, max(0, t0 - q_start));
  s_begin -= s_begin % kBlockQ;
  if (t0 >= kv_len) s_begin = S;    // no row sees the tile: dK = dV = 0

  float dka[kON][4], dva[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[n][e] = 0.f;
      dva[n][e] = 0.f;
    }

  stage<DH, kBlockK>(ks, k + (int64_t(b) * Tk * KV + kvh) * DH, rs_k, t0, kv_len);
  stage<DH, kBlockK>(vs, v + (int64_t(b) * Tk * KV + kvh) * DH, rs_k, t0, kv_len);
  const int col0 = nw * G::kOut;                  // this warp's output columns
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const bf16* qb = q + (int64_t(b) * S * H + h) * DH;
    const bf16* gb = dout + (int64_t(b) * S * H + h) * DH;
    const int64_t roff = (int64_t(b) * H + h) * S;
    for (int s0 = s_begin; s0 < S; s0 += kBlockQ) {
      __syncthreads();               // the previous q tile's readers are done
      stage<DH, kBlockQ>(qs, qb, rs_q, s0, S);
      stage<DH, kBlockQ>(dos, gb, rs_q, s0, S);
      stage_rows(rl, rd, lse, dsum, roff, s0, S);
      __syncthreads();
      {
        float st[kNT][4], dpt[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = 0.f;
            dpt[j][e] = 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t ak[4], av[4];
          load_a(ak, ks + 16 * mt * kLd + 16 * kk, kLd, g, t);
          load_a(av, vs + 16 * mt * kLd + 16 * kk, kLd, g, t);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int row = 8 * (nw * kNT + j) + g;       // a q row: an n index
            const bf16* qr = qs + row * kLd + 16 * kk + 2 * t;
            const bf16* gr = dos + row * kLd + 16 * kk + 2 * t;
            mma_bf16(st[j], ak, ld2(qr), ld2(qr + 8));
            mma_bf16(dpt[j], av, ld2(gr), ld2(gr + 8));
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int kr = 16 * mt + g + 8 * hf, kvr = t0 + kr;
            const int qc = 8 * (nw * kNT + j) + 2 * t;
            float p[2], d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = s0 + qc + e, pos = q_start + row;
              const bool ok = row < S && kvr < kv_len &&
                              (!causal || kvr <= pos || kvr < prefix_len);
              p[e] = ok ? expf(st[j][2 * hf + e] * scale - rl[qc + e]) : 0.f;
              d[e] = p[e] * (dpt[j][2 * hf + e] - rd[qc + e]);
            }
            *reinterpret_cast<uint32_t*>(pt + kr * kLdS + qc) = pack_bf16(p[0], p[1]);
            *reinterpret_cast<uint32_t*>(dst + kr * kLdS + qc) = pack_bf16(d[0], d[1]);
          }
      }
      __syncthreads();               // P^T and dS^T are complete
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        load_a(ap, pt + 16 * mt * kLdS + 16 * kk, kLdS, g, t);
        load_a(ad, dst + 16 * mt * kLdS + 16 * kk, kLdS, g, t);
        const int r = 16 * kk + (lane & 15);
#pragma unroll
        for (int n = 0; n < kON; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, dos + r * kLd + col0 + 8 * n);
          mma_bf16(dva[n], ap, b0, b1);
          ldmatrix_x2_trans(b0, b1, qs + r * kLd + col0 + 8 * n);
          mma_bf16(dka[n], ad, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int tr = t0 + 16 * mt + g + 8 * hf;
    if (tr >= Tk) continue;
    const int64_t off = ((int64_t(b) * Tk + tr) * KV + kvh) * DH + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kON; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          pack_bf16(dka[n][2 * hf] * scale, dka[n][2 * hf + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          pack_bf16(dva[n][2 * hf], dva[n][2 * hf + 1]);
    }
  }
}

// Block (q tile, h, b): dQ of query rows [s0, s0 + 64).  Per kv tile: S =
// Q K^T and dP = dO V^T (warp w: q rows 16 (w % 4) on, kv columns 8 kNTq
// (w / 4) on), dS = P (dP - D) to shared memory in bf16, then dQ += dS K
// (warp w: the same q rows, dh columns kOutQ (w / 4) on).
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          bf16* __restrict__ dq, int S, int Tk, int H, int KV, int causal,
          int prefix_len, int kv_len, int q_start, float scale) {
  using G = Geo<DH>;
  constexpr int kBlockK = G::kBlockK, kLd = G::kLd, kLdQ = G::kLdQ;
  constexpr int kNT = G::kNTq, kON = G::kOutQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBlockQ][kLd]
  bf16* dos = qs + kBlockQ * kLd;                 // [kBlockQ][kLd]
  bf16* ks = dos + kBlockQ * kLd;                 // [kBlockK][kLd]
  bf16* vs = ks + kBlockK * kLd;                  // [kBlockK][kLd]
  bf16* dss = vs + kBlockK * kLd;                 // [kBlockQ][kLdQ]
  float* rl = reinterpret_cast<float*>(dss + kBlockQ * kLdQ);   // [kBlockQ]
  float* rd = rl + kBlockQ;                                      // [kBlockQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4, nw = warp / 4;
  const int s0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(kBlockQ, S - s0);
  const int64_t rs_q = int64_t(H) * DH, rs_k = int64_t(KV) * DH;
  int col_end = kv_len;              // the last column any row can see, + 1
  if (causal) col_end = min(col_end, max(q_start + s0 + rows, prefix_len));

  const bf16* kb = k + (int64_t(b) * Tk * KV + kvh) * DH;
  const bf16* vb = v + (int64_t(b) * Tk * KV + kvh) * DH;
  stage<DH, kBlockQ>(qs, q + (int64_t(b) * S * H + h) * DH, rs_q, s0, S);
  stage<DH, kBlockQ>(dos, dout + (int64_t(b) * S * H + h) * DH, rs_q, s0, S);
  stage_rows(rl, rd, lse, dsum, (int64_t(b) * H + h) * S, s0, S);

  float dqa[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const int col0 = nw * G::kOutQ;

  for (int t0 = 0; t0 < col_end; t0 += kBlockK) {
    __syncthreads();                 // the previous tile's readers are done
    stage<DH, kBlockK>(ks, kb, rs_k, t0, col_end);
    stage<DH, kBlockK>(vs, vb, rs_k, t0, col_end);
    __syncthreads();
    {
      float sc[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t aq[4], ag[4];
        load_a(aq, qs + 16 * mt * kLd + 16 * kk, kLd, g, t);
        load_a(ag, dos + 16 * mt * kLd + 16 * kk, kLd, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int row = 8 * (nw * kNT + j) + g;         // a kv row: an n index
          const bf16* kr = ks + row * kLd + 16 * kk + 2 * t;
          const bf16* vr = vs + row * kLd + 16 * kk + 2 * t;
          mma_bf16(sc[j], aq, ld2(kr), ld2(kr + 8));
          mma_bf16(dp[j], ag, ld2(vr), ld2(vr + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int qr = 16 * mt + g + 8 * hf, row = s0 + qr, pos = q_start + row;
          const int kc = 8 * (nw * kNT + j) + 2 * t;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = t0 + kc + e;
            const bool ok = row < S && col < kv_len &&
                            (!causal || col <= pos || col < prefix_len);
            const float p = ok ? expf(sc[j][2 * hf + e] * scale - rl[qr]) : 0.f;
            d[e] = p * (dp[j][2 * hf + e] - rd[qr]);
          }
          *reinterpret_cast<uint32_t*>(dss + qr * kLdQ + kc) = pack_bf16(d[0], d[1]);
        }
    }
    __syncthreads();                 // dS is complete
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      load_a(a, dss + 16 * mt * kLdQ + 16 * kk, kLdQ, g, t);
      const int r = 16 * kk + (lane & 15);
#pragma unroll
      for (int n = 0; n < kON; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, ks + r * kLd + col0 + 8 * n);
        mma_bf16(dqa[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = s0 + 16 * mt + g + 8 * hf;
    if (row >= S) continue;
    bf16* out = dq + ((int64_t(b) * S + row) * H + h) * DH + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kON; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(dqa[n][2 * hf] * scale, dqa[n][2 * hf + 1] * scale);
  }
}

}  // namespace tc

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq, void* dk,
           void* dv, int B, int S, int Tk, int H, int KV, int causal, int prefix_len,
           int kv_len, int q_start, float scale, cudaStream_t stream) {
  using G = Geo<DH>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  const int64_t rows = int64_t(B) * S * H;
  flash_bwd_dot_kernel<T><<<unsigned((rows + 7) / 8), kThreads, 0, stream>>>(
      tg, static_cast<const T*>(o), dsum, S, H, DH, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  if constexpr (std::is_same_v<T, bf16>) {       // tensor cores
    using TG = tc::Geo<DH>;
    auto dkdv = tc::flash_bwd_dkdv_mma_kernel<DH>;
    static std::atomic<uint64_t> ready_kv{0};
    err = allow_smem(dkdv, TG::kSmemKV, ready_kv);
    if (err != cudaSuccess) return int(err);
    const dim3 grid_kv((Tk + TG::kBlockK - 1) / TG::kBlockK, KV, B);
    dkdv<<<grid_kv, tc::kThreads, TG::kSmemKV, stream>>>(
        tq, tk, tv, tg, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H,
        KV, causal, prefix_len, kv_len, q_start, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    auto dqk = tc::flash_bwd_dq_mma_kernel<DH>;
    static std::atomic<uint64_t> ready_q{0};
    err = allow_smem(dqk, TG::kSmemQ, ready_q);
    if (err != cudaSuccess) return int(err);
    const dim3 grid_q((S + tc::kBlockQ - 1) / tc::kBlockQ, H, B);
    dqk<<<grid_q, tc::kThreads, TG::kSmemQ, stream>>>(
        tq, tk, tv, tg, lse, dsum, static_cast<T*>(dq), S, Tk, H, KV, causal,
        prefix_len, kv_len, q_start, scale);
    return int(cudaGetLastError());
  } else {                                        // float32: FMA
    auto dkdv = flash_bwd_dkdv_kernel<DH, T>;
    static std::atomic<uint64_t> ready_kv{0};
    err = allow_smem(dkdv, G::kSmemKV, ready_kv);
    if (err != cudaSuccess) return int(err);
    const dim3 grid_kv((Tk + G::kBlockK - 1) / G::kBlockK, KV, B);
    dkdv<<<grid_kv, kThreads, G::kSmemKV, stream>>>(
        tq, tk, tv, tg, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H,
        KV, causal, prefix_len, kv_len, q_start, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    auto dqk = flash_bwd_dq_kernel<DH, T>;
    static std::atomic<uint64_t> ready_q{0};
    err = allow_smem(dqk, G::kSmemQ, ready_q);
    if (err != cudaSuccess) return int(err);
    const dim3 grid_q((S + kBlockQ - 1) / kBlockQ, H, B);
    dqk<<<grid_q, kThreads, G::kSmemQ, stream>>>(
        tq, tk, tv, tg, lse, dsum, static_cast<T*>(dq), S, Tk, H, KV, causal,
        prefix_len, kv_len, q_start, scale);
    return int(cudaGetLastError());
  }
}

template <typename T>
int by_dim(int dh, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq, void* dk,
           void* dv, int B, int S, int Tk, int H, int KV, int causal, int prefix_len,
           int kv_len, int q_start, float scale, cudaStream_t s) {
#define C4CAM_FLASH_BWD_CASE(D)                                                   \
  case D:                                                                         \
    return launch<D, T>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Tk, H, KV, \
                        causal, prefix_len, kv_len, q_start, scale, s);
  switch (dh) {
    C4CAM_FLASH_BWD_CASE(16)
    C4CAM_FLASH_BWD_CASE(32)
    C4CAM_FLASH_BWD_CASE(64)
    C4CAM_FLASH_BWD_CASE(80)
    C4CAM_FLASH_BWD_CASE(128)
    C4CAM_FLASH_BWD_CASE(256)
    default: return int(cudaErrorInvalidValue);
  }
#undef C4CAM_FLASH_BWD_CASE
}

}  // namespace

// q, o, dout, dq (B, S, H, dh) and k, v, dk, dv (B, T, KV, dh), contiguous,
// one dtype, 16-byte aligned; lse (B, H, S) float32 from the forward; dsum
// float32 scratch of B * H * S values.  p holds, in order: B, S, T, H, KV, dh,
// bf16 (1) or float32 (0), causal, prefix_len, kv_len (in 1..T), q_start and
// the softmax scale as the bit pattern of a float32.  Returns a cudaError_t
// code.
extern "C" int c4cam_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout,
                                         const float* lse, float* dsum, void* dq,
                                         void* dk, void* dv, const long long* p,
                                         void* stream) {
  for (int i = 0; i < 11; ++i)
    if (p[i] < 0 || p[i] > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (p[11] < 0 || p[11] > 0xffffffffLL) return int(cudaErrorInvalidValue);
  const int B = int(p[0]), S = int(p[1]), Tk = int(p[2]), H = int(p[3]);
  const int KV = int(p[4]), dh = int(p[5]), bf = int(p[6]), causal = int(p[7]);
  const int prefix_len = int(p[8]), kv_len = int(p[9]), q_start = int(p[10]);
  const uint32_t scale_bits = uint32_t(p[11]);
  float scale;
  memcpy(&scale, &scale_bits, sizeof scale);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || kv_len < 1 || kv_len > Tk ||
      H > 65535 || B > 65535 || !(scale > 0.f) || isinf(scale))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf)
    return by_dim<bf16>(dh, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Tk, H, KV,
                        causal, prefix_len, kv_len, q_start, scale, s);
  return by_dim<float>(dh, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Tk, H, KV,
                       causal, prefix_len, kv_len, q_start, scale, s);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
