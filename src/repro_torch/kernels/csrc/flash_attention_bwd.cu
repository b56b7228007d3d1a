// flash_attention_bwd: the backward of B7's online-softmax GQA attention
// (sm_90a).
//
// Replaces no TPU kernel: the reference trains through jax's autodiff of
// the plain `attn_core` (src/repro/models/layers.py), which never reaches
// its Pallas forward.  The port's attention runs B7 on the card, so its
// gradient needs a kernel of its own: this one, behind
// `flash_attention.FlashAttentionFn`.  Contract (the forward's, see
// flash_attention.cu): q, o, dO (B, S, H, dh); k, v, dK, dV (B, T, KV, dh),
// all contiguous, one dtype (bfloat16 or float32); lse (B, H, S) float32;
// query head h reads kv head h / (H / KV); row s sits at q_start + s and
// sees column t when t < kv_len and, if causal, t <= q_start + s or t <
// prefix_len.  With the forward's row log-sum-exp lse (of the scaled
// scores) it recomputes, tile by tile,
//
//   P = exp(q.k * scale - lse)      (0 where hidden)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - D),   D = rowsum(dO * O)
//   dQ = scale * dS K,   dK = scale * dS^T Q
//
// in float32 and stores dQ, dK, dV in the input dtype.  Every route runs a
// pre-pass for D, a dK / dV kernel in which a block owns kv rows of one kv
// head and walks, in a fixed order, query heads of its group and, for
// each, the q tiles that can see them (causal: from the first row at or
// past the tile's first column; the prefix's tiles from row 0), summing
// P^T dO and dS^T Q, and a dQ kernel in which a block owns query rows of
// one head and walks the kv tiles they can see, summing dS K.  No block
// writes a row another block writes and no sum is split by atomics: the
// same sums in the same order on every run.  The dQ kernel recomputes S
// and dP: seven products of 2 dh FLOP per visible (row, column) pair and
// head, five of them needed.  P and dS are rounded to bf16 before the
// products that use them (the forward rounds P so too).  Two routes,
// picked by the wrapper (flash_attention.py, `flash_bwd_route`) and passed
// in:
//
// * wgmma (bf16: the training path).  flash_bwd_rows_kernel writes each
//   row's (lse log2 e, D) pair, (0, 0) past S up to a multiple of 128
//   rows, so a stage's 64 rows are one 512-byte bulk copy.  Rows past S
//   need no mask (Q and dO zero, the pair (0, 0): P is 1, dP and D are 0,
//   so dV and dS gain 0); only stages that straddle kv_len, the diagonal
//   or the prefix are masked.  Causal calls pair kv tiles: a dK / dV block
//   owns kv tiles j and n - 1 - j, which see n + 1 q tiles between them
//   (the prefix's tiles a few more), so the blocks carry equal work.
//   Each kernel has a producer warp (warpgroup 2, setmaxnreg 24: one
//   thread starts every TMA load, tensor maps over (B, S, H, dh) and (B,
//   kv_len, KV, dh), rows past S or kv_len read as zeros) and two consumer
//   warpgroups (setmaxnreg 240) on wgmma with the operands in swizzled
//   shared memory.
//   - Head dims 16 to 128 (namespace wb).  flash_bwd_dkdv_wgmma_kernel: a
//     block owns 64 kv rows of one kv head, K and V resident; the producer
//     keeps a 4-stage ring of (Q, dO, rows) stages of 64 query rows full;
//     the consumers take a tile's stages in turns (stage j to warpgroup j
//     % 2), each computing S^T = K Q^T and dP^T = V dO^T for all 64 kv
//     rows (m64n64k16, both operands K-major), then P^T = exp2(S^T scale
//     log2 e - lse log2 e) and dS^T = P^T (dP^T - D) in the accumulators,
//     rounded to bf16 in registers as the A operands of dV += P^T dO and
//     dK += dS^T Q (RS at N = dh, dO and Q read N-major through the
//     transposed descriptor, as the forward reads V).  At a tile's end
//     warpgroup 1 hands its dV, then its dK, to warpgroup 0 through a 64 x
//     dh float32 buffer (named barriers 1 and 2), which adds each to its
//     own, always in that order, and stores.  dK and dV take dh / 2
//     float32 registers each, S^T and dP^T 32 each: 192 at dh 128.  At
//     qwen2.5-14b's causal shape 128 blocks for 132 SMs at B = 1, 512 at
//     B = 4.  flash_bwd_dq_wgmma_kernel: a block owns 128 query rows of
//     one head (a consumer warpgroup of 64 each), Q and dO resident; the
//     producer keeps a 3-stage ring of 64-row K and V tiles; each
//     warpgroup computes S = Q K^T and dP = dO V^T (m64n64k16), dS in
//     registers, and dQ += dS K (RS, K read N-major), skipping tiles past
//     its rows' last visible column; the longest causal blocks launch
//     first.  Q and dO stay SS operands: held as RS A registers across
//     tiles they are overwritten (ptxas frees a wgmma's A registers once
//     the product has read them: at dh 64 it packed dS into them), and
//     read anew by ldmatrix every tile they measured no faster on an
//     H100.  Shared memory at dh 128: 195 KB (dK / dV), 161 KB (dQ).
//   - Head dim 256 (namespace wh), where one warpgroup cannot hold a kv
//     tile's float32 dK and dV (256 registers a thread).
//     flash_bwd_dkdv_wgmma256_kernel: the consumers split dh instead of
//     the stages.  Per (Q, dO) stage warpgroup 0 computes S^T = K Q^T and
//     P^T, warpgroup 1 dP^T = V dO^T less D (m64n64k16 over dh 256, one
//     product each), each hands its 64 x 64 float32 tile to the other
//     through shared memory (named barriers 1-3), both form dS^T, and
//     warpgroup w adds P^T dO and dS^T Q over dh columns 128w.. (RS at N
//     128) to its own dV and dK: 64 + 64 registers, 32 for its score tile
//     and 32 for the other's.  K and V (32 KB each) stay resident beside
//     a 2-stage ring of 64 KB (Q, dO) stages and the two 16 KB exchange
//     buffers: 226 KB.  The group's query heads (and q tiles) are spread
//     over blocks: a grid of (kv tile pairs, KV x slices, B), slice i
//     taking the i-th of `slices` contiguous, equal ranges of the pair's
//     (head, q tile) stages (`flash_attention.flash_bwd_slices` picks the
//     count for the card's waves).  Each block writes its tiles' float32
//     partial dK and dV to scratch, and flash_bwd_sum_kernel adds the
//     slices that touched a row in slice order, scales dK and rounds both
//     to bf16.  flash_bwd_dq_wgmma256_kernel: a block owns 64 query rows
//     of one head, Q and dO resident (64 KB); the producer keeps a 5-stage
//     ring of 32-row K and V stages (32 KB each); warpgroup w takes stages
//     w, w + 2, ..., each computing S and dP (m64n32k16) and dQ += dS K
//     (RS at N 256, 128 registers); warpgroup 1 then hands its dQ to
//     warpgroup 0 through the ring, which adds it and stores; the longest
//     causal blocks launch first.
// * fma (float32: the parity checks): flash_bwd_dkdv_kernel and
//   flash_bwd_dq_kernel on the CUDA cores, staged as float32 as the
//   forward's FMA route does, thread (ty, tx) holding score rows
//   4ty..4ty+3 against columns tx + 16c and output columns tx + 16n;
//   64-row kv tiles (32 at dh 256); D from flash_bwd_dot_kernel, one warp
//   a row.
//
// Bound on an H100 SXM: the five products at the bf16 tensor-core peak
// (989 TFLOP/s) or the bytes of q, k, v, o, dO, lse and dQ, dK, dV at 3.35
// TB/s, the larger; at qwen2.5-14b's (2048, 40 / 8, 128) causal shape
// 0.109 ms a batch row, at paligemma-3b's (2304, 8 / 1, 256) prefix-LM
// shape 0.056 ms, both compute-bound.  Head dims: 16, 32, 64, 80, 128, 256
// (the wrapper zero-pads others to the next one, the scale staying the
// caller's).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "bf16_wgmma.cuh"  // mbarriers, TMA, wgmma (shared with the forward)

namespace {

using c4cam_bf16::allow_smem;
using c4cam_bf16::bf16;

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

// Stage rows [r0, r0 + ROWS) of one head (row stride `rs`, elements) into a
// [ROWS][DH + 4] tile, 16 bytes a load; rows at or past `r_end` are zero.
template <int DH, int ROWS>
__device__ __forceinline__ void stage(float* tile, const float* src, int64_t rs, int r0,
                                      int r_end) {
  constexpr int kPerRow = DH / 4;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < r_end) x = *reinterpret_cast<const float4*>(src + int64_t(r0 + r) * rs + c);
    *reinterpret_cast<float4*>(tile + r * (DH + 4) + c) = x;
  }
}

// D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in float32; warp w of
// block i takes row 8i + w of the (B, S, H) rows, lanes the columns d = lane
// + 32j, summed lane by lane and then by the same shuffle tree every run.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const float* __restrict__ dout, const float* __restrict__ o,
                     float* __restrict__ dsum, int S, int H, int dh, int64_t rows) {
  const int64_t r = int64_t(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* a = dout + r * dh;
  const float* c = o + r * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc = fmaf(a[d], c[d], acc);
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
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      float* __restrict__ dk, float* __restrict__ dv, int S, int Tk, int H,
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

  const float* kb = k + (int64_t(b) * Tk * KV + kvh) * DH;
  const float* vb = v + (int64_t(b) * Tk * KV + kvh) * DH;
  stage<DH, kBlockK>(ks, kb, rs_k, t0, kv_len);
  stage<DH, kBlockK>(vs, vb, rs_k, t0, kv_len);
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const float* qb = q + (int64_t(b) * S * H + h) * DH;
    const float* gb = dout + (int64_t(b) * S * H + h) * DH;
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
      dk[off + tx + 16 * n] = dka[r][n] * scale;
      dv[off + tx + 16 * n] = dva[r][n];
    }
  }
}

// Block (q tile, h, b): dQ of query rows [s0, s0 + 64) of head h.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    float* __restrict__ dq, int S, int Tk, int H, int KV, int causal,
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

  const float* kb = k + (int64_t(b) * Tk * KV + kvh) * DH;
  const float* vb = v + (int64_t(b) * Tk * KV + kvh) * DH;
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
    float* out = dq + ((int64_t(b) * S + row) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < kN; ++n) out[tx + 16 * n] = dqa[i][n] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dims up to 128: the wgmma route (TMA rings, warp-specialised)
// ---------------------------------------------------------------------------

namespace wb {

using namespace c4cam_bf16;

constexpr int kThreads = 384;          // warpgroups 0-1 consume, 2 loads
constexpr int kRows = 64;              // the rows of every tile: wgmma's M
constexpr int kRowBytes = kRows * 8;   // a stage's (lse log2 e, D) pairs
constexpr float kLog2e = 1.4426950408889634f;

// [64][DH] bf16 tiles as TMA writes them (bf16_wgmma.cuh, `Atoms`).  The
// dK / dV kernel keeps K and V, a ring of kStagesKV stages of Q and dO
// tiles and rows, and a 64 x DH float32 exchange buffer; the dQ kernel
// the two warpgroups' Q and dO tiles and a ring of kStagesQ K and V tiles.
template <int DH>
struct Geo : Atoms<DH> {
  using Atoms<DH>::kSwizzle;
  static constexpr int kAtomBytes = kRows * kSwizzle;   // one column atom
  static constexpr int kTile = kRows * DH * 2;
  static constexpr int kStagesKV = 4;
  static constexpr int kStagesQ = 3;
  // tiles, rows, the exchange buffer, 1 KB of alignment slack, barriers
  static constexpr size_t kSmemKV = size_t(2 + 2 * kStagesKV) * kTile +
                                    size_t(kStagesKV) * kRowBytes +
                                    size_t(kRows) * DH * 4 + 1024 + 128;
  static constexpr size_t kSmemQ = size_t(4 + 2 * kStagesQ) * kTile + 1024 + 128;
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "shared memory of one block");
  static_assert(kTile % 1024 == 0, "tiles keep the swizzle atoms aligned");
};

// rows[(b H + h) S_pad + s] = (lse[b, h, s] log2 e, D[b, h, s]) with D =
// sum_d dO[b, s, h, d] O[b, s, h, d] in float32, (0, 0) for s in [S,
// S_pad).  Warp w of block i takes entry 8i + w; lane l < dh / 8 sums the
// products of columns 8l..8l+7 in order, then the lanes meet by the same
// shuffle tree every run.
__global__ void __launch_bounds__(256)
flash_bwd_rows_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                      const float* __restrict__ lse, float2* __restrict__ rows, int S,
                      int S_pad, int H, int dh, int64_t n) {
  const int64_t r = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  if (r >= n) return;
  const int lane = threadIdx.x % 32;
  const int s = int(r % S_pad);
  const int64_t bh = r / S_pad;
  if (s >= S) {
    if (lane == 0) rows[r] = make_float2(0.f, 0.f);
    return;
  }
  const int64_t b = bh / H, h = bh % H;
  const int64_t off = ((b * S + s) * H + h) * dh;
  float acc = 0.f;
  if (lane < dh / 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(dout + off + 8 * lane);
    const uint4 y = *reinterpret_cast<const uint4*>(o + off + 8 * lane);
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(a[i]), w = __bfloat1622float2(c[i]);
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) rows[r] = make_float2(lse[bh * S + s] * kLog2e, acc);
}

// Whether kv column `col` is visible to the query row at position `pos`.
__device__ __forceinline__ bool visible(int col, int pos, int causal, int prefix_len,
                                        int kv_len) {
  return col < kv_len && (!causal || col <= pos || col < prefix_len);
}

// The first query row of the first q tile some row of which sees a
// column of the kv tile [t0, t0 + 64); S when no row does
// (flash_attention.py's _bwd_first_row copies it).
__device__ __forceinline__ int first_q_row(int t0, int S, int causal, int prefix_len,
                                           int kv_len, int q_start) {
  if (t0 >= kv_len) return S;
  int s = 0;
  if (causal && t0 >= prefix_len) s = max(0, t0 - q_start);
  if (s >= S) return S;
  return s - s % kRows;
}

// d = A B^T for 64-row tiles A and B (shared-memory addresses), both
// K-major: dh in k-steps of 16 columns (32 bytes of an atom row).
template <int DH>
__device__ __forceinline__ void start_ss(float (&d)[kRows / 2], uint32_t a, uint32_t b) {
  using G = Geo<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off =
        16 * kk / G::kAtomCols * G::kAtomBytes + (16 * kk % G::kAtomCols) * 2;
    wgmma_ss<kRows>(d, desc<DH>(a + off, 16, 8 * G::kSwizzle),
                    desc<DH>(b + off, 16, 8 * G::kSwizzle), kk > 0);
  }
}

// d += A B for A (64 x 64, bf16) in registers, k-step kk holding columns
// 16kk..16kk+15, and the 64-row tile B read N-major (its rows 16kk on).
template <int DH>
__device__ __forceinline__ void start_rs(float (&d)[DH / 2], const uint32_t (&a)[4][4],
                                         uint32_t b) {
  using G = Geo<DH>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DH>(d, a[kk], desc<DH>(b + kk * 16 * G::kSwizzle, G::kAtomBytes, 8 * G::kSwizzle));
}

// A 64 x 64 accumulator rounded to bf16 as the A registers of an RS
// product: k-step kk covers column blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[kRows / 2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Named barriers of 256 threads (both consumer warpgroups).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Warpgroup 1's partial sums `acc` into warpgroup 0's through `xbuf`
// (thread tid's registers at xbuf[e * 128 + tid]): warpgroup 1 waits until
// warpgroup 0 has read the previous hand-over (`handed` > 0), writes, and
// arrives at barrier 1; warpgroup 0 waits there, adds, and arrives at 2.
template <int DH>
__device__ __forceinline__ void hand_over(float (&acc)[DH / 2], float* xbuf, int tid,
                                          int wgi, int handed) {
  if (wgi == 1) {
    if (handed) bar_sync(2);
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) xbuf[e * 128 + tid] = acc[e];
    bar_arrive(1);
  } else {
    bar_sync(1);
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) acc[e] += xbuf[e * 128 + tid];
    bar_arrive(2);
  }
}

// One stage of the dK / dV walk for one warpgroup: the tile's 64 kv rows
// (this thread's r0 and r0 + 8, accumulator registers 4j + {0, 1} and
// 4j + {2, 3}) against the stage's 64 query rows s0.. (columns 8j + 2t +
// e).  S^T and dP^T start together; P^T is formed while dP^T finishes.
template <int DH>
__device__ __forceinline__ void dkdv_stage(float (&dka)[DH / 2], float (&dva)[DH / 2],
                                           uint32_t kt, uint32_t vt, uint32_t qt,
                                           uint32_t gt, const float2* rw, int r0, int s0,
                                           bool masked, int t, int causal, int prefix_len,
                                           int kv_len, int q_start, float scale2) {
  float sc[kRows / 2], dp[kRows / 2];
  wgmma_fence();
  start_ss<DH>(sc, kt, qt);
  wgmma_commit();
  start_ss<DH>(dp, vt, gt);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(sc);
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      const float l2 = rw[c].x;
      float p0 = exp2f(fmaf(sc[4 * j + e], scale2, -l2));
      float p1 = exp2f(fmaf(sc[4 * j + 2 + e], scale2, -l2));
      if (masked) {
        const int pos = q_start + s0 + c;
        if (!visible(r0, pos, causal, prefix_len, kv_len)) p0 = 0.f;
        if (!visible(r0 + 8, pos, causal, prefix_len, kv_len)) p1 = 0.f;
      }
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
    }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float d = rw[8 * j + 2 * t + e].y;
      dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - d);
      dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
    }
  uint32_t pa[4][4], da[4][4];
  pack_a(pa, sc);
  pack_a(da, dp);
  wgmma_fence();
  start_rs<DH>(dva, pa, gt);
  start_rs<DH>(dka, da, qt);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dva);
  fence_regs(dka);
}

// Block (x, kv head, b): dK and dV of the kv tiles x and, when `paired`,
// n - 1 - x (n = ceil(Tk / 64)), one after the other.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float2* __restrict__ rows, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int S, int S_pad, int Tk, int H,
                            int KV, int paired, int causal, int prefix_len, int kv_len,
                            int q_start, float scale) {
  using G = Geo<DH>;
  constexpr int kSt = G::kStagesKV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;         // swizzle atoms
  const uint32_t sk = base, sv = sk + G::kTile;
  const uint32_t sq = sv + G::kTile;                   // + slot * kTile
  const uint32_t sg = sq + kSt * G::kTile;             // dO: + slot * kTile
  const uint32_t srows = sg + kSt * G::kTile;          // + slot * kRowBytes
  const uint32_t sx = srows + kSt * kRowBytes;         // exchange buffer
  const uint32_t bars = sx + kRows * DH * 4;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kSt + s); K / V full, empty
  const uint32_t kv_full = bars + 16 * kSt, kv_empty = kv_full + 8;

  const int kvh = blockIdx.y, b = blockIdx.z, group = H / KV;
  const int n_tiles = (Tk + kRows - 1) / kRows, x = blockIdx.x;
  const int n_own = paired && n_tiles - 1 - x != x ? 2 : 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kSt + s), 4);             // the consuming warpgroup
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);                           // both warpgroups
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int i = 0, loaded = 0;
      for (int u = 0; u < n_own; ++u) {
        const int t0 = (u == 0 ? x : n_tiles - 1 - x) * kRows;
        const int s_first = first_q_row(t0, S, causal, prefix_len, kv_len, q_start);
        const int nq = (S - s_first + kRows - 1) / kRows;
        if (nq == 0) continue;
        if (loaded > 0) mbar_wait(kv_empty, (loaded - 1) & 1);
        ++loaded;
        mbar_expect_tx(kv_full, 2 * G::kTile);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          tma_load_4d(sk + a * G::kAtomBytes, &tk, kv_full, a * G::kAtomCols, kvh, t0, b);
          tma_load_4d(sv + a * G::kAtomBytes, &tv, kv_full, a * G::kAtomCols, kvh, t0, b);
        }
        for (int gi = 0; gi < group; ++gi) {
          const int h = kvh * group + gi;
          const float2* hrows = rows + (int64_t(b) * H + h) * S_pad;
          for (int qi = 0; qi < nq; ++qi, ++i) {
            const int s0 = s_first + qi * kRows, slot = i % kSt;
            mbar_wait(bars + 8 * (kSt + slot), ((i / kSt) & 1) ^ 1);
            const uint32_t full = bars + 8 * slot;
            mbar_expect_tx(full, 2 * G::kTile + kRowBytes);
#pragma unroll
            for (int a = 0; a < G::kAtoms; ++a) {
              const uint32_t off = slot * G::kTile + a * G::kAtomBytes;
              tma_load_4d(sq + off, &tq, full, a * G::kAtomCols, h, s0, b);
              tma_load_4d(sg + off, &tdo, full, a * G::kAtomCols, h, s0, b);
            }
            bulk_load(srows + slot * kRowBytes, hrows + s0, kRowBytes, full);
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const float scale2 = scale * kLog2e;
    float* xbuf = reinterpret_cast<float*>(smem_raw + (sx - raw));
    const float2* rbuf = reinterpret_cast<const float2*>(smem_raw + (srows - raw));
    int handed = 0;                                  // hand-overs so far
    float dka[DH / 2], dva[DH / 2];
    int i = 0, loaded = 0;
    for (int u = 0; u < n_own; ++u) {
      const int t0 = (u == 0 ? x : n_tiles - 1 - x) * kRows;
      const int s_first = first_q_row(t0, S, causal, prefix_len, kv_len, q_start);
      const int nq = (S - s_first + kRows - 1) / kRows;
      const int n_st = group * nq;                   // the tile's stages
      const int r0 = t0 + 16 * warp + lane / 4;      // kv rows r0, r0 + 8
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) {
        dka[e] = 0.f;
        dva[e] = 0.f;
      }
      if (n_st > 0) {
        mbar_wait(kv_full, loaded & 1);
        ++loaded;
        for (int j = wgi; j < n_st; j += 2) {        // stage j: warpgroup j % 2
          const int st = i + j, slot = st % kSt;
          const int s0 = s_first + (j % nq) * kRows;
          const bool masked = t0 + kRows > kv_len ||
                              (causal && t0 + kRows > prefix_len && t0 + kRows - 1 > q_start + s0);
          mbar_wait(bars + 8 * slot, (st / kSt) & 1);
          dkdv_stage<DH>(dka, dva, sk, sv, sq + slot * G::kTile, sg + slot * G::kTile,
                         rbuf + slot * kRows, r0, s0, masked, t, causal, prefix_len,
                         kv_len, q_start, scale2);
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (kSt + slot));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty);
      }
      i += n_st;
      if (n_st > 1) {
        hand_over<DH>(dva, xbuf, tid, wgi, handed++);
        hand_over<DH>(dka, xbuf, tid, wgi, handed++);
      }
      if (wgi == 0) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int tr = r0 + 8 * hf;
          if (tr >= Tk) continue;
          const int64_t off = ((int64_t(b) * Tk + tr) * KV + kvh) * DH + 2 * t;
#pragma unroll
          for (int n = 0; n < DH / 8; ++n) {
            *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
                pack_bf16(dka[4 * n + 2 * hf] * scale, dka[4 * n + 2 * hf + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
                pack_bf16(dva[4 * n + 2 * hf], dva[4 * n + 2 * hf + 1]);
          }
        }
      }
    }
    if (wgi == 1 && handed) bar_sync(2);             // the last hand-over read
  }
}

// One kv tile of the dQ walk for one warpgroup: its 64 query rows (this
// thread's rows at registers 4j + {0, 1} and 4j + {2, 3}, positions pa and
// pb) against the tile's 64 kv columns t0 + 8j + 2t + e.
template <int DH>
__device__ __forceinline__ void dq_stage(float (&dqa)[DH / 2], uint32_t qt, uint32_t gt,
                                         uint32_t kt, uint32_t vt, float2 ra, float2 rb,
                                         int pa, int pb, int t0, bool masked, int t,
                                         int causal, int prefix_len, int kv_len,
                                         float scale2) {
  float sc[kRows / 2], dp[kRows / 2];
  wgmma_fence();
  start_ss<DH>(sc, qt, kt);
  wgmma_commit();
  start_ss<DH>(dp, gt, vt);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(sc);
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p0 = exp2f(fmaf(sc[4 * j + e], scale2, -ra.x));
      float p1 = exp2f(fmaf(sc[4 * j + 2 + e], scale2, -rb.x));
      if (masked) {
        const int col = t0 + 8 * j + 2 * t + e;
        if (!visible(col, pa, causal, prefix_len, kv_len)) p0 = 0.f;
        if (!visible(col, pb, causal, prefix_len, kv_len)) p1 = 0.f;
      }
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
    }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ra.y);
      dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - rb.y);
    }
  uint32_t da[4][4];
  pack_a(da, dp);
  wgmma_fence();
  start_rs<DH>(dqa, da, kt);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dqa);
}

// Block (h, b, z): dQ of query rows [s0, s0 + 128) of head h, z = 0 taking
// the last block of rows (the longest causal walk) first.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float2* __restrict__ rows, bf16* __restrict__ dq, int S,
                          int S_pad, int H, int group, int causal, int prefix_len,
                          int kv_len, int q_start, float scale) {
  using G = Geo<DH>;
  constexpr int kSt = G::kStagesQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                            // + warpgroup * kTile
  const uint32_t sg = sq + 2 * G::kTile;               // dO
  const uint32_t sk = sg + 2 * G::kTile;               // + slot * kTile
  const uint32_t sv = sk + kSt * G::kTile;
  const uint32_t bars = sv + kSt * G::kTile;
  const uint32_t qbar = bars + 16 * kSt;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kSt + s)

  const int h = blockIdx.x, b = blockIdx.y;
  const int s0 = (gridDim.z - 1 - blockIdx.z) * 2 * kRows;
  const int n_rows = min(2 * kRows, S - s0);
  int col_end = kv_len;            // the last column any row can see, + 1
  if (causal) col_end = min(col_end, max(q_start + s0 + n_rows, prefix_len));
  const int n_kv = (col_end + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kSt + s), 8);            // both warpgroups
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const int kvh = h / group, halves = n_rows > kRows ? 2 : 1;
      mbar_expect_tx(qbar, 2 * halves * G::kTile);
      for (int w = 0; w < halves; ++w)
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          const uint32_t off = w * G::kTile + a * G::kAtomBytes;
          tma_load_4d(sq + off, &tq, qbar, a * G::kAtomCols, h, s0 + w * kRows, b);
          tma_load_4d(sg + off, &tdo, qbar, a * G::kAtomCols, h, s0 + w * kRows, b);
        }
      for (int i = 0; i < n_kv; ++i) {
        const int slot = i % kSt;
        const uint32_t full = bars + 8 * slot;
        mbar_wait(bars + 8 * (kSt + slot), ((i / kSt) & 1) ^ 1);
        mbar_expect_tx(full, 2 * G::kTile);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          const uint32_t off = slot * G::kTile + a * G::kAtomBytes;
          tma_load_4d(sk + off, &tk, full, a * G::kAtomCols, kvh, i * kRows, b);
          tma_load_4d(sv + off, &tv, full, a * G::kAtomCols, kvh, i * kRows, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    if (kRows * wgi >= n_rows) {     // every row of this warpgroup is past S
      for (int i = 0; i < n_kv; ++i) {
        mbar_wait(bars + 8 * (i % kSt), (i / kSt) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (kSt + i % kSt));
      }
      return;
    }
    const int r = s0 + kRows * wgi + 16 * warp + lane / 4;   // rows r, r + 8
    const float2* hrows = rows + (int64_t(b) * H + h) * S_pad;
    const float2 ra = hrows[r], rb = hrows[r + 8];            // (0, 0) past S
    const int first = q_start + s0 + kRows * wgi;             // this warpgroup's
    int wg_end = kv_len;             // last visible column + 1 of its rows
    int full_end = kv_len;           // columns every one of its rows sees
    if (causal) {
      wg_end = min(kv_len, max(first + kRows, prefix_len));
      full_end = min(kv_len, max(first + 1, prefix_len));
    }
    const float scale2 = scale * kLog2e;
    float dqa[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) dqa[e] = 0.f;
    const uint32_t qt = sq + wgi * G::kTile, gt = sg + wgi * G::kTile;
    mbar_wait(qbar, 0);
    for (int i = 0; i < n_kv; ++i) {
      const int slot = i % kSt, t0 = i * kRows;
      mbar_wait(bars + 8 * slot, (i / kSt) & 1);
      if (t0 < wg_end)
        dq_stage<DH>(dqa, qt, gt, sk + slot * G::kTile, sv + slot * G::kTile, ra, rb,
                     q_start + r, q_start + r + 8, t0, t0 + kRows > full_end, t, causal,
                     prefix_len, kv_len, scale2);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kSt + slot));
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r + 8 * hf;
      if (row >= S) continue;
      bf16* out = dq + ((int64_t(b) * S + row) * H + h) * DH + 2 * t;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            pack_bf16(dqa[4 * n + 2 * hf] * scale, dqa[4 * n + 2 * hf + 1] * scale);
    }
  }
}

}  // namespace wb

// ---------------------------------------------------------------------------
// bf16 at head dim 256: the wgmma route's own kernels (namespace wh)
// ---------------------------------------------------------------------------

namespace wh {

using namespace c4cam_bf16;
using wb::first_q_row;
using wb::kLog2e;
using wb::kRowBytes;
using wb::kRows;
using wb::visible;

constexpr int kDh = 256;
constexpr int kThreads = 384;          // warpgroups 0-1 consume, 2 loads
constexpr int kHalf = kDh / 2;         // the dK / dV columns a consumer owns
constexpr int kSwz = 128;              // bytes of a swizzled atom row
constexpr int kAtom = kRows * kSwz;    // one 64-column atom of a 64-row tile
constexpr int kTile = kRows * kDh * 2; // a 64-row tile: 32 KB
constexpr int kStagesKV = 2;
constexpr int kRowsQ = 32;             // kv rows of a dQ stage
constexpr int kAtomQ = kRowsQ * kSwz;
constexpr int kTileQ = kRowsQ * kDh * 2;
constexpr int kStagesQ = 5;
constexpr int kXch = kRows * kRows * 4; // a 64 x 64 float32 exchange buffer
// dK / dV: K, V, kStagesKV (Q, dO, rows) stages, the P and dP - D
// exchange buffers; dQ: Q, dO and kStagesQ (K, V) stages of 32 rows, the
// ring doubling as the 64 x 256 float32 hand-over buffer at the end.  Each
// with 1 KB of alignment slack and the barriers.
constexpr size_t kSmemKV = size_t(2 + 2 * kStagesKV) * kTile + kStagesKV * kRowBytes +
                           2 * kXch + 1024 + 128;
constexpr size_t kSmemQ = 2 * size_t(kTile) + 2 * size_t(kStagesQ) * kTileQ + 1024 + 128;
static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "shared memory of one block");
static_assert(2 * kStagesQ * kTileQ >= kRows * kDh * 4, "the ring holds the hand-over");

// The stages of a dK / dV block: kv tiles `tile[u]` (u < n_own), tile u's
// stages (query head gi of the group, q tile qi: stage gi nq[u] + qi)
// taken in [lo[u], hi[u]).  The pair's stages, tile 0's then tile 1's,
// are cut into `slices` contiguous ranges of equal length (one more or
// less); slice `slice` is this block's.  flash_attention.py's
// _bwd_unit_stages and _bwd_cut copy the count and the cut, for the
// slice rule.
struct Walk {
  int n_own;
  int tile[2], s_first[2], nq[2], lo[2], hi[2];
};

__device__ __forceinline__ Walk walk_of(int x, int slice, int slices, int n_tiles,
                                        int group, int S, int paired, int causal,
                                        int prefix_len, int kv_len, int q_start) {
  Walk w;
  w.n_own = paired && n_tiles - 1 - x != x ? 2 : 1;
  int start[2], total = 0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    w.tile[u] = u == 0 ? x : n_tiles - 1 - x;
    w.s_first[u] = first_q_row(w.tile[u] * kRows, S, causal, prefix_len, kv_len, q_start);
    w.nq[u] = (S - w.s_first[u] + kRows - 1) / kRows;
    start[u] = total;
    if (u < w.n_own) total += group * w.nq[u];
  }
  const int a = int(int64_t(slice) * total / slices);
  const int b = int(int64_t(slice + 1) * total / slices);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n = u < w.n_own ? group * w.nq[u] : 0;
    w.lo[u] = max(a, start[u]) - start[u];
    w.hi[u] = max(w.lo[u], min(b, start[u] + n) - start[u]);
  }
  return w;
}

// d = A B^T over dh (16 k-steps) for K-major tiles A and B whose 64-column
// atoms are a_atom and b_atom bytes apart.
template <int N>
__device__ __forceinline__ void start_ss(float (&d)[N / 2], uint32_t a, uint32_t b,
                                         uint32_t a_atom, uint32_t b_atom) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const uint32_t c = 16 * kk / 64, o = (16 * kk % 64) * 2;
    wgmma_ss<N>(d, desc<kDh>(a + c * a_atom + o, 16, 8 * kSwz),
                desc<kDh>(b + c * b_atom + o, 16, 8 * kSwz), kk > 0);
  }
}

// d += A B for A (64 x 16K, bf16) in registers, k-step kk holding columns
// 16kk..16kk+15, and B's N columns from address b read N-major (rows 16kk
// on; its 64-column atoms `atom` bytes apart).
template <int N, int K>
__device__ __forceinline__ void start_rs(float (&d)[N / 2], const uint32_t (&a)[K][4],
                                         uint32_t b, uint32_t atom) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    wgmma_rs<N>(d, a[kk], desc<kDh>(b + kk * 16 * kSwz, atom, 8 * kSwz));
}

// A 64 x 16K accumulator rounded to bf16 as the A registers of an RS
// product: k-step kk covers column blocks 2kk and 2kk + 1.
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], const float (&x)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// One stage of the dK / dV walk for warpgroup wgi: the tile's 64 kv rows
// (this thread's r0 and r0 + 8) against the stage's 64 query rows s0..
// (columns 8j + 2t + e).  Warpgroup 0 computes S^T = K Q^T and P^T,
// warpgroup 1 dP^T = V dO^T less D; each hands its 64 x 64 float32 tile to
// the other through shared memory (named barrier 1: both written; 2: P^T
// read, 3: dP^T - D read), both form dS^T = P^T (dP^T - D), and each adds
// P^T dO and dS^T Q over its 128 columns to dV and dK.
__device__ __forceinline__ void dkdv_stage(float (&dka)[kHalf / 2], float (&dva)[kHalf / 2],
                                           int wgi, int tid, uint32_t kt, uint32_t vt,
                                           uint32_t qt, uint32_t gt, const float2* rw,
                                           float* xp, float* xd, int exch, int r0, int s0,
                                           bool masked, int t, int causal, int prefix_len,
                                           int kv_len, int q_start, float scale2) {
  float sc[kRows / 2];
  wgmma_fence();
  start_ss<kRows>(sc, wgi == 0 ? kt : vt, wgi == 0 ? qt : gt, kAtom, kAtom);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  if (wgi == 0) {
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float l2 = rw[c].x;
        float p0 = exp2f(fmaf(sc[4 * j + e], scale2, -l2));
        float p1 = exp2f(fmaf(sc[4 * j + 2 + e], scale2, -l2));
        if (masked) {
          const int pos = q_start + s0 + c;
          if (!visible(r0, pos, causal, prefix_len, kv_len)) p0 = 0.f;
          if (!visible(r0 + 8, pos, causal, prefix_len, kv_len)) p1 = 0.f;
        }
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
      }
    if (exch > 0) wb::bar_sync(2);                    // the last P^T was read
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) xp[e * 128 + tid] = sc[e];
  } else {
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = rw[8 * j + 2 * t + e].y;
        sc[4 * j + e] -= d;
        sc[4 * j + 2 + e] -= d;
      }
    if (exch > 0) wb::bar_sync(3);                    // the last dP^T - D was read
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) xd[e * 128 + tid] = sc[e];
  }
  wb::bar_sync(1);                                    // both tiles written
  float o[kRows / 2];
  const float* other = wgi == 0 ? xd : xp;
#pragma unroll
  for (int e = 0; e < kRows / 2; ++e) o[e] = other[e * 128 + tid];
  wb::bar_arrive(wgi == 0 ? 3 : 2);                   // done reading it
  uint32_t pa[4][4], da[4][4];
  if (wgi == 0) {                                     // sc: P^T, o: dP^T - D
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) o[e] = sc[e] * o[e];
    pack_a<4>(pa, sc);
    pack_a<4>(da, o);
  } else {                                            // o: P^T, sc: dP^T - D
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) sc[e] = o[e] * sc[e];
    pack_a<4>(pa, o);
    pack_a<4>(da, sc);
  }
  const uint32_t half = 2 * wgi * kAtom;              // columns 128 wgi on
  wgmma_fence();
  start_rs<kHalf, 4>(dva, pa, gt + half, kAtom);
  start_rs<kHalf, 4>(dka, da, qt + half, kAtom);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dva);
  fence_regs(dka);
}

// Block (x, kv head * slices + slice, b): slice `slice` of the stages of
// kv tiles x and, when `paired`, n - 1 - x (n = ceil(Tk / 64)); each
// tile's float32 partial dK and dV (dK unscaled) to `part`, laid out
// [slices][B][Tk][KV][256], dV's `pv` floats after dK's.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma256_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const float2* __restrict__ rows, float* __restrict__ part,
                               int64_t pv, int B, int S, int S_pad, int Tk, int H, int KV,
                               int slices, int paired, int causal, int prefix_len,
                               int kv_len, int q_start, float scale) {
  constexpr int kSt = kStagesKV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;         // swizzle atoms
  const uint32_t sk = base, sv = sk + kTile;
  const uint32_t sq = sv + kTile;                      // + slot * kTile
  const uint32_t sg = sq + kSt * kTile;                // dO: + slot * kTile
  const uint32_t srows = sg + kSt * kTile;             // + slot * kRowBytes
  const uint32_t sxp = srows + kSt * kRowBytes, sxd = sxp + kXch;
  const uint32_t bars = sxd + kXch;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kSt + s); K / V full, empty
  const uint32_t kv_full = bars + 16 * kSt, kv_empty = kv_full + 8;

  const int kvh = blockIdx.y / slices, slice = blockIdx.y % slices, b = blockIdx.z;
  const int group = H / KV, n_tiles = (Tk + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kSt + s), 8);             // both warpgroups
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const Walk w = walk_of(blockIdx.x, slice, slices, n_tiles, group, S, paired, causal,
                             prefix_len, kv_len, q_start);
      int i = 0, loaded = 0;
#pragma unroll
      for (int u = 0; u < 2; ++u) {              // unrolled: w stays in registers
        if (u >= w.n_own || w.lo[u] >= w.hi[u]) continue;
        const int t0 = w.tile[u] * kRows, nq = w.nq[u];
        if (loaded > 0) mbar_wait(kv_empty, (loaded - 1) & 1);
        ++loaded;
        mbar_expect_tx(kv_full, 2 * kTile);
#pragma unroll
        for (int a = 0; a < kDh / 64; ++a) {
          tma_load_4d(sk + a * kAtom, &tk, kv_full, a * 64, kvh, t0, b);
          tma_load_4d(sv + a * kAtom, &tv, kv_full, a * 64, kvh, t0, b);
        }
        for (int st = w.lo[u]; st < w.hi[u]; ++st, ++i) {
          const int h = kvh * group + st / nq, s0 = w.s_first[u] + (st % nq) * kRows;
          const int slot = i % kSt;
          mbar_wait(bars + 8 * (kSt + slot), ((i / kSt) & 1) ^ 1);
          const uint32_t full = bars + 8 * slot;
          mbar_expect_tx(full, 2 * kTile + kRowBytes);
#pragma unroll
          for (int a = 0; a < kDh / 64; ++a) {
            const uint32_t off = slot * kTile + a * kAtom;
            tma_load_4d(sq + off, &tq, full, a * 64, h, s0, b);
            tma_load_4d(sg + off, &tdo, full, a * 64, h, s0, b);
          }
          bulk_load(srows + slot * kRowBytes, rows + (int64_t(b) * H + h) * S_pad + s0,
                    kRowBytes, full);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const Walk w = walk_of(blockIdx.x, slice, slices, n_tiles, group, S, paired, causal,
                           prefix_len, kv_len, q_start);
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const float scale2 = scale * kLog2e;
    float* xp = reinterpret_cast<float*>(smem_raw + (sxp - raw));
    float* xd = reinterpret_cast<float*>(smem_raw + (sxd - raw));
    const float2* rbuf = reinterpret_cast<const float2*>(smem_raw + (srows - raw));
    float dka[kHalf / 2], dva[kHalf / 2];
    int i = 0, loaded = 0, exch = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= w.n_own || w.lo[u] >= w.hi[u]) continue;
      const int t0 = w.tile[u] * kRows, nq = w.nq[u];
      const int r0 = t0 + 16 * warp + lane / 4;      // kv rows r0, r0 + 8
#pragma unroll
      for (int e = 0; e < kHalf / 2; ++e) {
        dka[e] = 0.f;
        dva[e] = 0.f;
      }
      mbar_wait(kv_full, loaded & 1);
      ++loaded;
      for (int st = w.lo[u]; st < w.hi[u]; ++st, ++i, ++exch) {
        const int slot = i % kSt, s0 = w.s_first[u] + (st % nq) * kRows;
        const bool masked = t0 + kRows > kv_len ||
                            (causal && t0 + kRows > prefix_len && t0 + kRows - 1 > q_start + s0);
        mbar_wait(bars + 8 * slot, (i / kSt) & 1);
        dkdv_stage(dka, dva, wgi, tid, sk, sv, sq + slot * kTile, sg + slot * kTile,
                   rbuf + slot * kRows, xp, xd, exch, r0, s0, masked, t, causal, prefix_len,
                   kv_len, q_start, scale2);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (kSt + slot));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);
      // this warpgroup's 128 columns of the tile's partial dK and dV
      const int c0 = kHalf * wgi + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tr = r0 + 8 * hf;
        if (tr >= Tk) continue;
        float* pk = part + (((int64_t(slice) * B + b) * Tk + tr) * KV + kvh) * kDh + c0;
#pragma unroll
        for (int n = 0; n < kHalf / 8; ++n) {
          *reinterpret_cast<float2*>(pk + 8 * n) =
              make_float2(dka[4 * n + 2 * hf], dka[4 * n + 2 * hf + 1]);
          *reinterpret_cast<float2*>(pk + pv + 8 * n) =
              make_float2(dva[4 * n + 2 * hf], dva[4 * n + 2 * hf + 1]);
        }
      }
    }
    if (exch > 0) wb::bar_sync(wgi == 0 ? 2 : 3);    // the last hand-over read
  }
}

// dK = scale sum_i part_i and dV = sum_i part_i over the slices i whose
// stages touched the row's kv tile, in slice order; 0 where none did.
// Thread: 4 columns of one (b, t, kv head) row.
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, int64_t pv, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int B, int S, int Tk, int H, int KV, int slices,
                     int paired, int causal, int prefix_len, int kv_len, int q_start,
                     float scale, int64_t n) {
  const int64_t idx = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= n) return;
  const int c = int(idx % (kDh / 4)) * 4;
  const int64_t row = idx / (kDh / 4);               // (b Tk + t) KV + kvh
  const int t = int(row / KV % Tk);
  const int n_tiles = (Tk + kRows - 1) / kRows, tile = t / kRows;
  const int x = paired ? min(tile, n_tiles - 1 - tile) : tile, u = tile == x ? 0 : 1;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int i = 0; i < slices; ++i) {
    const Walk w = walk_of(x, i, slices, n_tiles, H / KV, S, paired, causal, prefix_len,
                           kv_len, q_start);
    if ((u == 0 ? w.lo[0] : w.lo[1]) >= (u == 0 ? w.hi[0] : w.hi[1])) continue;
    const int64_t off = (int64_t(i) * B * Tk * KV + row) * kDh + c;
    const float4 a = *reinterpret_cast<const float4*>(part + off);
    const float4 g = *reinterpret_cast<const float4*>(part + pv + off);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += g.x; sv.y += g.y; sv.z += g.z; sv.w += g.w;
  }
  uint2 ok, ov;
  ok.x = pack_bf16(sk.x * scale, sk.y * scale);
  ok.y = pack_bf16(sk.z * scale, sk.w * scale);
  ov.x = pack_bf16(sv.x, sv.y);
  ov.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(dk + row * kDh + c) = ok;
  *reinterpret_cast<uint2*>(dv + row * kDh + c) = ov;
}

// One 32-row kv stage of the dQ walk for one warpgroup: the block's 64
// query rows (this thread's rows at registers 4j + {0, 1} and 4j + {2, 3},
// positions pa and pb) against the stage's columns t0 + 8j + 2t + e.
__device__ __forceinline__ void dq_stage(float (&dqa)[kDh / 2], uint32_t qt, uint32_t gt,
                                         uint32_t kt, uint32_t vt, float2 ra, float2 rb,
                                         int pa, int pb, int t0, bool masked, int t,
                                         int causal, int prefix_len, int kv_len,
                                         float scale2) {
  float sc[kRowsQ / 2], dp[kRowsQ / 2];
  wgmma_fence();
  start_ss<kRowsQ>(sc, qt, kt, kAtom, kAtomQ);
  wgmma_commit();
  start_ss<kRowsQ>(dp, gt, vt, kAtom, kAtomQ);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(sc);
#pragma unroll
  for (int j = 0; j < kRowsQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p0 = exp2f(fmaf(sc[4 * j + e], scale2, -ra.x));
      float p1 = exp2f(fmaf(sc[4 * j + 2 + e], scale2, -rb.x));
      if (masked) {
        const int col = t0 + 8 * j + 2 * t + e;
        if (!visible(col, pa, causal, prefix_len, kv_len)) p0 = 0.f;
        if (!visible(col, pb, causal, prefix_len, kv_len)) p1 = 0.f;
      }
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
    }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < kRowsQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ra.y);
      dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - rb.y);
    }
  uint32_t da[kRowsQ / 16][4];
  pack_a<kRowsQ / 16>(da, dp);
  wgmma_fence();
  start_rs<kDh, kRowsQ / 16>(dqa, da, kt, kAtomQ);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dqa);
}

// Block (h, b, z): dQ of query rows [s0, s0 + 64) of head h, z = 0 taking
// the last rows (the longest causal walk) first.  The producer keeps a
// ring of 32-row K and V stages full; warpgroup w takes stages w, w + 2,
// ..., each summing its own dQ; warpgroup 1 then hands its sum to
// warpgroup 0 through the ring (named barriers 1 and 2), which adds it
// and stores.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma256_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float2* __restrict__ rows, bf16* __restrict__ dq, int S,
                             int S_pad, int H, int group, int causal, int prefix_len,
                             int kv_len, int q_start, float scale) {
  constexpr int kSt = kStagesQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base, sg = sq + kTile;
  const uint32_t sk = sg + kTile;                      // + slot * kTileQ
  const uint32_t sv = sk + kSt * kTileQ;
  const uint32_t bars = sv + kSt * kTileQ;
  const uint32_t qbar = bars + 16 * kSt;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kSt + s)

  const int h = blockIdx.x, b = blockIdx.y;
  const int s0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int n_rows = min(kRows, S - s0);
  int col_end = kv_len;              // the last column any row can see, + 1
  int full_end = kv_len;             // the columns every row sees
  if (causal) {
    col_end = min(kv_len, max(q_start + s0 + n_rows, prefix_len));
    full_end = min(kv_len, max(q_start + s0 + 1, prefix_len));
  }
  const int n_kv = (col_end + kRowsQ - 1) / kRowsQ;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kSt + s), 4);             // the consuming warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const int kvh = h / group;
      mbar_expect_tx(qbar, 2 * kTile);
#pragma unroll
      for (int a = 0; a < kDh / 64; ++a) {
        tma_load_4d(sq + a * kAtom, &tq, qbar, a * 64, h, s0, b);
        tma_load_4d(sg + a * kAtom, &tdo, qbar, a * 64, h, s0, b);
      }
      for (int i = 0; i < n_kv; ++i) {
        const int slot = i % kSt;
        const uint32_t full = bars + 8 * slot;
        mbar_wait(bars + 8 * (kSt + slot), ((i / kSt) & 1) ^ 1);
        mbar_expect_tx(full, 2 * kTileQ);
#pragma unroll
        for (int a = 0; a < kDh / 64; ++a) {
          const uint32_t off = slot * kTileQ + a * kAtomQ;
          tma_load_4d(sk + off, &tk, full, a * 64, kvh, i * kRowsQ, b);
          tma_load_4d(sv + off, &tv, full, a * 64, kvh, i * kRowsQ, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int r = s0 + 16 * warp + lane / 4;                  // rows r, r + 8
    const float2* hrows = rows + (int64_t(b) * H + h) * S_pad;
    const float2 ra = hrows[r], rb = hrows[r + 8];            // (0, 0) past S
    const float scale2 = scale * kLog2e;
    float dqa[kDh / 2];
#pragma unroll
    for (int e = 0; e < kDh / 2; ++e) dqa[e] = 0.f;
    mbar_wait(qbar, 0);
    for (int i = wgi; i < n_kv; i += 2) {
      const int slot = i % kSt, t0 = i * kRowsQ;
      mbar_wait(bars + 8 * slot, (i / kSt) & 1);
      dq_stage(dqa, sq, sg, sk + slot * kTileQ, sv + slot * kTileQ, ra, rb, q_start + r,
               q_start + r + 8, t0, t0 + kRowsQ > full_end, t, causal, prefix_len, kv_len,
               scale2);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kSt + slot));
    }
    // warpgroup 1's sum into warpgroup 0's, through the ring (every stage
    // read: the products waited on)
    float* xbuf = reinterpret_cast<float*>(smem_raw + (sk - raw));
    wb::bar_sync(1);
    if (wgi == 1) {
#pragma unroll
      for (int e = 0; e < kDh / 2; ++e) xbuf[e * 128 + tid] = dqa[e];
      wb::bar_arrive(2);
    } else {
      wb::bar_sync(2);
#pragma unroll
      for (int e = 0; e < kDh / 2; ++e) dqa[e] += xbuf[e * 128 + tid];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r + 8 * hf;
        if (row >= S) continue;
        bf16* out = dq + ((int64_t(b) * S + row) * H + h) * kDh + 2 * t;
#pragma unroll
        for (int n = 0; n < kDh / 8; ++n)
          *reinterpret_cast<uint32_t*>(out + 8 * n) =
              pack_bf16(dqa[4 * n + 2 * hf] * scale, dqa[4 * n + 2 * hf + 1] * scale);
      }
    }
  }
}

}  // namespace wh

// The wgmma route: the rows pre-pass, then the dK / dV and dQ kernels.
// `scratch` holds B * H * S_pad float2 (S_pad: S rounded up to 128).
template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* scratch, void* dq, void* dk,
                 void* dv, int B, int S, int Tk, int H, int KV, int paired, int causal,
                 int prefix_len, int kv_len, int q_start, float scale,
                 cudaStream_t stream) {
  using G = wb::Geo<DH>;
  using c4cam_bf16::encode;
  // the tensor maps first: the pre-pass then runs straight into the kernels
  const long long qs = (long long)H * DH, ks = (long long)KV * DH;
  CUtensorMap tq, tdo, tk, tv;
  if (!encode(&tq, q, B, S, H, DH, qs * S, qs, DH, G::kAtomCols, wb::kRows, G::kTmaSwizzle) ||
      !encode(&tdo, dout, B, S, H, DH, qs * S, qs, DH, G::kAtomCols, wb::kRows,
              G::kTmaSwizzle) ||
      !encode(&tk, k, B, kv_len, KV, DH, ks * Tk, ks, DH, G::kAtomCols, wb::kRows,
              G::kTmaSwizzle) ||
      !encode(&tv, v, B, kv_len, KV, DH, ks * Tk, ks, DH, G::kAtomCols, wb::kRows,
              G::kTmaSwizzle))
    return int(cudaErrorInvalidValue);
  auto dkdv = wb::flash_bwd_dkdv_wgmma_kernel<DH>;
  auto dqk = wb::flash_bwd_dq_wgmma_kernel<DH>;
  static std::atomic<uint64_t> ready_kv{0}, ready_q{0};
  cudaError_t err = allow_smem(dkdv, G::kSmemKV, ready_kv);
  if (err == cudaSuccess) err = allow_smem(dqk, G::kSmemQ, ready_q);
  if (err != cudaSuccess) return int(err);

  const int S_pad = (S + 2 * wb::kRows - 1) / (2 * wb::kRows) * (2 * wb::kRows);
  float2* rows = static_cast<float2*>(scratch);
  const int64_t n = int64_t(B) * H * S_pad;
  wb::flash_bwd_rows_kernel<<<unsigned((n + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o), lse, rows, S, S_pad, H,
      DH, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n_tiles = (Tk + wb::kRows - 1) / wb::kRows;
  const dim3 grid_kv(paired ? (n_tiles + 1) / 2 : n_tiles, KV, B);
  dkdv<<<grid_kv, wb::kThreads, G::kSmemKV, stream>>>(
      tq, tdo, tk, tv, rows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, S_pad, Tk,
      H, KV, paired, causal, prefix_len, kv_len, q_start, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q(H, B, (S + 2 * wb::kRows - 1) / (2 * wb::kRows));
  dqk<<<grid_q, wb::kThreads, G::kSmemQ, stream>>>(
      tq, tdo, tk, tv, rows, static_cast<bf16*>(dq), S, S_pad, H, H / KV, causal,
      prefix_len, kv_len, q_start, scale);
  return int(cudaGetLastError());
}

// The wgmma route at dh 256: the rows pre-pass, the dK / dV kernel's
// partial sums, their sum, then the dQ kernel.  `scratch` holds B * H *
// S_pad float2, then the partial dK and dV: 2 slices B Tk KV 256 float32.
int launch_wgmma256(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, void* scratch, void* dq, void* dk,
                    void* dv, int B, int S, int Tk, int H, int KV, int slices, int paired,
                    int causal, int prefix_len, int kv_len, int q_start, float scale,
                    cudaStream_t stream) {
  using c4cam_bf16::encode;
  constexpr int D = wh::kDh;
  constexpr CUtensorMapSwizzle kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long qs = (long long)H * D, ks = (long long)KV * D;
  CUtensorMap tq, tdo, tk, tv, tk32, tv32;
  if (!encode(&tq, q, B, S, H, D, qs * S, qs, D, 64, wb::kRows, kSw) ||
      !encode(&tdo, dout, B, S, H, D, qs * S, qs, D, 64, wb::kRows, kSw) ||
      !encode(&tk, k, B, kv_len, KV, D, ks * Tk, ks, D, 64, wb::kRows, kSw) ||
      !encode(&tv, v, B, kv_len, KV, D, ks * Tk, ks, D, 64, wb::kRows, kSw) ||
      !encode(&tk32, k, B, kv_len, KV, D, ks * Tk, ks, D, 64, wh::kRowsQ, kSw) ||
      !encode(&tv32, v, B, kv_len, KV, D, ks * Tk, ks, D, 64, wh::kRowsQ, kSw))
    return int(cudaErrorInvalidValue);
  auto dkdv = wh::flash_bwd_dkdv_wgmma256_kernel;
  auto dqk = wh::flash_bwd_dq_wgmma256_kernel;
  static std::atomic<uint64_t> ready_kv{0}, ready_q{0};
  cudaError_t err = allow_smem(dkdv, wh::kSmemKV, ready_kv);
  if (err == cudaSuccess) err = allow_smem(dqk, wh::kSmemQ, ready_q);
  if (err != cudaSuccess) return int(err);

  const int S_pad = (S + 2 * wb::kRows - 1) / (2 * wb::kRows) * (2 * wb::kRows);
  float2* rows = static_cast<float2*>(scratch);
  const int64_t n = int64_t(B) * H * S_pad;
  float* part = reinterpret_cast<float*>(rows + n);
  const int64_t pv = int64_t(slices) * B * Tk * KV * D;
  wb::flash_bwd_rows_kernel<<<unsigned((n + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o), lse, rows, S, S_pad, H,
      D, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n_tiles = (Tk + wb::kRows - 1) / wb::kRows;
  const dim3 grid_kv(paired ? (n_tiles + 1) / 2 : n_tiles, KV * slices, B);
  dkdv<<<grid_kv, wh::kThreads, wh::kSmemKV, stream>>>(
      tq, tdo, tk, tv, rows, part, pv, B, S, S_pad, Tk, H, KV, slices, paired, causal,
      prefix_len, kv_len, q_start, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t n_sum = int64_t(B) * Tk * KV * (D / 4);
  wh::flash_bwd_sum_kernel<<<unsigned((n_sum + 255) / 256), 256, 0, stream>>>(
      part, pv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, Tk, H, KV, slices,
      paired, causal, prefix_len, kv_len, q_start, scale, n_sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q(H, B, (S + wb::kRows - 1) / wb::kRows);
  dqk<<<grid_q, wh::kThreads, wh::kSmemQ, stream>>>(
      tq, tdo, tk32, tv32, rows, static_cast<bf16*>(dq), S, S_pad, H, H / KV, causal,
      prefix_len, kv_len, q_start, scale);
  return int(cudaGetLastError());
}

// The fma route (float32): the D pre-pass into the first B * H * S floats
// of `scratch`, then its dK / dV and dQ kernels.
template <int DH>
int launch_fma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq, void* dk,
               void* dv, int B, int S, int Tk, int H, int KV, int causal, int prefix_len,
               int kv_len, int q_start, float scale, cudaStream_t stream) {
  using G = Geo<DH>;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tg = static_cast<const float*>(dout);
  const int64_t rows = int64_t(B) * S * H;
  flash_bwd_dot_kernel<<<unsigned((rows + 7) / 8), kThreads, 0, stream>>>(
      tg, static_cast<const float*>(o), dsum, S, H, DH, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  auto dkdv = flash_bwd_dkdv_kernel<DH>;
  static std::atomic<uint64_t> ready_kv{0};
  err = allow_smem(dkdv, G::kSmemKV, ready_kv);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_kv((Tk + G::kBlockK - 1) / G::kBlockK, KV, B);
  dkdv<<<grid_kv, kThreads, G::kSmemKV, stream>>>(
      tq, tk, tv, tg, lse, dsum, static_cast<float*>(dk), static_cast<float*>(dv), S, Tk,
      H, KV, causal, prefix_len, kv_len, q_start, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  auto dqk = flash_bwd_dq_kernel<DH>;
  static std::atomic<uint64_t> ready_q{0};
  err = allow_smem(dqk, G::kSmemQ, ready_q);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q((S + kBlockQ - 1) / kBlockQ, H, B);
  dqk<<<grid_q, kThreads, G::kSmemQ, stream>>>(
      tq, tk, tv, tg, lse, dsum, static_cast<float*>(dq), S, Tk, H, KV, causal,
      prefix_len, kv_len, q_start, scale);
  return int(cudaGetLastError());
}

// route: 0 fma (float32, every head dim), 2 wgmma (bf16); any other
// pairing is refused.
int by_route(int route, int dh, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, void* scratch, void* dq,
             void* dk, void* dv, int B, int S, int Tk, int H, int KV, int slices,
             int paired, int causal, int prefix_len, int kv_len, int q_start, float scale,
             cudaStream_t s) {
  float* dsum = static_cast<float*>(scratch);
#define C4CAM_BWD_WGMMA(D)                                                         \
  case D:                                                                          \
    return launch_wgmma<D>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, Tk, H, \
                           KV, paired, causal, prefix_len, kv_len, q_start, scale, s);
#define C4CAM_BWD_FMA(D)                                                          \
  case D:                                                                         \
    return launch_fma<D>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Tk, H, KV, \
                         causal, prefix_len, kv_len, q_start, scale, s);
  if (route == 2) {
    switch (dh) {
      C4CAM_BWD_WGMMA(16)
      C4CAM_BWD_WGMMA(32)
      C4CAM_BWD_WGMMA(64)
      C4CAM_BWD_WGMMA(80)
      C4CAM_BWD_WGMMA(128)
      case 256:
        return launch_wgmma256(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, Tk, H,
                               KV, slices, paired, causal, prefix_len, kv_len, q_start,
                               scale, s);
      default: break;
    }
  } else if (route == 0) {
    switch (dh) {
      C4CAM_BWD_FMA(16)
      C4CAM_BWD_FMA(32)
      C4CAM_BWD_FMA(64)
      C4CAM_BWD_FMA(80)
      C4CAM_BWD_FMA(128)
      C4CAM_BWD_FMA(256)
      default: break;
    }
  }
#undef C4CAM_BWD_WGMMA
#undef C4CAM_BWD_FMA
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout, dq (B, S, H, dh) and k, v, dk, dv (B, T, KV, dh), contiguous,
// one dtype, 16-byte aligned; lse (B, H, S) float32 from the forward;
// scratch: float32, 2 B H S_pad values (S_pad = S rounded up to 128: the
// wgmma route's (lse log2 e, D) pairs; the fma route's D uses the first B
// H S), and at dh 256 in bf16 2 slices B T KV 256 more (the partial dK and
// dV).  p holds, in order: B, S, T, H, KV, dh, bf16 (1) or float32 (0),
// causal, prefix_len, kv_len (in 1..T), q_start, the softmax scale as the
// bit pattern of a float32, the route (0 fma, 2 wgmma), whether the wgmma
// route pairs kv tiles j and n - 1 - j, and the slices each pair's stages
// are cut into at dh 256 (at least 1).  Returns a cudaError_t code.
extern "C" int c4cam_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout,
                                         const float* lse, void* scratch, void* dq,
                                         void* dk, void* dv, const long long* p,
                                         void* stream) {
  for (int i = 0; i < 15; ++i)
    if (i != 11 && (p[i] < 0 || p[i] > 0x7fffffffLL)) return int(cudaErrorInvalidValue);
  if (p[11] < 0 || p[11] > 0xffffffffLL) return int(cudaErrorInvalidValue);
  const int B = int(p[0]), S = int(p[1]), Tk = int(p[2]), H = int(p[3]);
  const int KV = int(p[4]), dh = int(p[5]), bf = int(p[6]), causal = int(p[7]);
  const int prefix_len = int(p[8]), kv_len = int(p[9]), q_start = int(p[10]);
  const uint32_t scale_bits = uint32_t(p[11]);
  const int route = int(p[12]), paired = int(p[13]), slices = int(p[14]);
  float scale;
  memcpy(&scale, &scale_bits, sizeof scale);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || kv_len < 1 || kv_len > Tk ||
      H > 65535 || B > 65535 || slices < 1 || int64_t(KV) * slices > 65535 ||
      !(scale > 0.f) || isinf(scale) || (route == 0) == (bf != 0))
    return int(cudaErrorInvalidValue);
  return by_route(route, dh, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, Tk, H, KV,
                  slices, paired, causal, prefix_len, kv_len, q_start, scale,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
