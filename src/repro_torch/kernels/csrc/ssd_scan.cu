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
// Every product is a float32 FMA (no TF32: the reference's einsums run at
// "highest" precision).  Rows past S, and a last chunk shorter than Q, read
// as zeros (dt 0 adds nothing to L, x, B and C 0 add nothing to a sum): the
// plain version pads S to whole chunks with the same zeros.
//
//   1. ssd_chunk_state_kernel, a block per (chunk, head, batch row): the
//      chunk's own state contribution sum_j w_j x_j B_j^T (64 x 64 of
//      float32, K = Q) and its total log-decay L_last, into a scratch of
//      (b, chunks, nh, 64, 64).
//   2. ssd_state_pass_kernel, a thread per (batch row, head, state entry):
//      walks the chunks in order, replaces each chunk's contribution by the
//      state entering that chunk, and writes the final state.
//   3. ssd_chunk_out_kernel, a block per (64-row tile of a chunk, group of
//      16 heads, batch row): C.B^T for the tile once (shared by the heads),
//      then for each head the masked intra-chunk product, the entering
//      state's term and the skip, stored in xh's dtype.
//
// Bound on an H100 SXM: float32 FMAs.  At zamba2-2.7b's widths (nh 80,
// dh 64, ds 64, Q 256) a token costs about 4.2 M multiply-adds over the
// heads (the causal half of the intra-chunk product, the state's
// contribution and its term in y), 8.4 MFLOP, against 20 KB of bf16 x, y
// and float32 dt: the operations bound it (67 TFLOP/s against 3.35 TB/s).
// The design keeps every operand of a product in shared memory and each
// thread on a 4 x 4 register tile read as float4s; making the products
// run on tensor cores (3xTF32 `wgmma`) is later work.
//
// Offsets are 64-bit: at 524,288 rows xh alone holds 2.7e9 elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kTile = 64;          // rows of an output tile; dh and ds padded
constexpr int kPad = 68;           // row width of a transposed tile (banks)
constexpr int kSlab = 32;          // rows of a chunk-state slab
constexpr int kHeadGroup = 16;     // heads an output block walks
constexpr int kState = kTile * kTile;

struct SsdParams {
  int64_t b, s, nh, dh, ds, chunk, n_chunks, row_tiles;
  int64_t x_sb, x_ss, x_sh;        // xh strides: batch, row, head
  int64_t b_sb, b_ss;              // B_ strides: batch, row
  int64_t c_sb, c_ss;              // C_ strides: batch, row
  int64_t dt_sb, dt_ss;            // dt strides: batch, row
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Inclusive prefix sum over the block's 256 threads (one value each).
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

// dt_t * A_h of the chunk's row t (0 past the chunk or past S), and the
// inclusive scan of it: L_t, into cum[t]; returns dt_t.
__device__ __forceinline__ float chunk_log_decay(const float* dt, float a,
                                                 const SsdParams& p, int64_t bi,
                                                 int64_t c, int64_t h, float* cum,
                                                 float* warp_sums) {
  const int t = threadIdx.x;
  const int64_t row = c * p.chunk + t;
  const float d = (t < p.chunk && row < p.s) ? dt[bi * p.dt_sb + row * p.dt_ss + h] : 0.f;
  cum[t] = block_scan(d * a, warp_sums);
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                       const float* __restrict__ dt, const float* __restrict__ A,
                       float* __restrict__ states, float* __restrict__ tot,
                       SsdParams p) {
  const int64_t c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  __shared__ float cum[kMaxChunk];
  __shared__ float w[kMaxChunk];
  __shared__ float warp_sums[kThreads / 32];
  __shared__ __align__(16) float xs[kSlab][kTile];
  __shared__ __align__(16) float bs[kSlab][kTile];
  const int tid = threadIdx.x;
  const float d = chunk_log_decay(dt, A[h], p, bi, c, h, cum, warp_sums);
  __syncthreads();
  const float last = cum[p.chunk - 1];
  w[tid] = expf(fmaxf(last - cum[tid], -60.f)) * d;
  const int ty = tid >> 4, tx = tid & 15;   // d rows ty*4.., s cols tx*4..
  float acc[4][4] = {};
  const int64_t row0 = c * p.chunk;
  for (int j0 = 0; j0 < p.chunk; j0 += kSlab) {
    __syncthreads();
    for (int e = tid; e < kSlab * kTile; e += kThreads) {
      const int j = e / kTile, col = e % kTile;
      const int64_t row = row0 + j0 + j;
      const bool live = j0 + j < p.chunk && row < p.s;
      const float wj = live ? w[j0 + j] : 0.f;
      xs[j][col] = (live && col < p.dh)
          ? wj * to_f(x[bi * p.x_sb + row * p.x_ss + h * p.x_sh + col]) : 0.f;
      bs[j][col] = (live && col < p.ds) ? to_f(bm[bi * p.b_sb + row * p.b_ss + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kSlab; ++j) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[j][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[j][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
    }
  }
  float* out = states + ((bi * p.n_chunks + c) * p.nh + h) * kState;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&out[(ty * 4 + i) * kTile + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (tid == 0) tot[(bi * p.n_chunks + c) * p.nh + h] = last;
}

// h <- exp(L_last) h + contribution, chunk by chunk; each chunk's slot of
// `states` is left holding the state that enters it.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ tot,
                      const float* __restrict__ h0, float* __restrict__ h_out,
                      SsdParams p) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int64_t h = blockIdx.y, bi = blockIdx.z;
  const int d = e / kTile, s = e % kTile;
  const bool live = d < p.dh && s < p.ds;
  const int64_t at = ((bi * p.nh + h) * p.dh + d) * p.ds + s;
  float hv = live ? h0[at] : 0.f;
  for (int64_t c = 0; c < p.n_chunks; ++c) {
    const int64_t slot = (bi * p.n_chunks + c) * p.nh + h;
    float* cell = states + slot * kState + e;
    const float contrib = *cell;
    const float decay = expf(tot[slot]);
    *cell = hv;
    hv = __fadd_rn(__fmul_rn(decay, hv), contrib);
  }
  if (live) h_out[at] = hv;
}

constexpr size_t kOutSmemFloats =
    size_t(kMaxChunk) * kTile      // cbt[j][i]: C_i . B_j for the tile
    + size_t(kTile) * kPad         // ct[s][i]: the tile's C, transposed
    + size_t(kTile) * kPad         // bt[s][j] (a B slab) / ht[s][d] (state)
    + size_t(kTile) * kTile        // xs[j][d]: an x slab
    + size_t(kTile) * kTile        // wt[j][i]: the masked weights of a slab
    + kMaxChunk * 2 + 32;          // cum, dt, warp sums
constexpr size_t kOutSmem = kOutSmemFloats * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_out_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Dskip,
                     const float* __restrict__ states, T* __restrict__ y,
                     SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* cbt = smem;
  float* ct = cbt + kMaxChunk * kTile;
  float* bt = ct + kTile * kPad;             // also ht
  float* xs = bt + kTile * kPad;
  float* wt = xs + kTile * kTile;
  float* cum = wt + kTile * kTile;
  float* dts = cum + kMaxChunk;
  float* warp_sums = dts + kMaxChunk;

  const int64_t c = blockIdx.x / p.row_tiles;
  const int i0 = int(blockIdx.x % p.row_tiles) * kTile;
  const int64_t bi = blockIdx.z;
  const int64_t h_first = int64_t(blockIdx.y) * kHeadGroup;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t row0 = c * p.chunk;
  const int j_end = min(int(p.chunk), i0 + kTile);   // columns any row reads
  const int n_slabs = (j_end + kTile - 1) / kTile;

  // the tile's C, transposed: ct[s][i]
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, s = e % kTile;
    const int64_t row = row0 + i0 + i;
    const bool live = i0 + i < p.chunk && row < p.s && s < p.ds;
    ct[s * kPad + i] = live ? to_f(cm[bi * p.c_sb + row * p.c_ss + s]) : 0.f;
  }
  // cbt[j][i] = C_i . B_j, slab by slab of 64 j
  for (int jb = 0; jb < n_slabs; ++jb) {
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int j = e / kTile, s = e % kTile;
      const int64_t row = row0 + jb * kTile + j;
      const bool live = jb * kTile + j < p.chunk && row < p.s && s < p.ds;
      bt[s * kPad + j] = live ? to_f(bm[bi * p.b_sb + row * p.b_ss + s]) : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};                    // j = ty*4+a, i = tx*4+k
#pragma unroll 4
    for (int s = 0; s < kTile; ++s) {
      const float4 b4 = *reinterpret_cast<const float4*>(&bt[s * kPad + ty * 4]);
      const float4 c4 = *reinterpret_cast<const float4*>(&ct[s * kPad + tx * 4]);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(cv[k], bv[a], acc[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(&cbt[(jb * kTile + ty * 4 + a) * kTile + tx * 4]) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }

  const int64_t h_end = h_first + kHeadGroup < p.nh ? h_first + kHeadGroup : p.nh;
  for (int64_t h = h_first; h < h_end; ++h) {
    __syncthreads();
    dts[tid] = chunk_log_decay(dt, A[h], p, bi, c, h, cum, warp_sums);
    // the state entering the chunk, transposed: ht[s][d]
    const float* hin = states + ((bi * p.n_chunks + c) * p.nh + h) * kState;
    for (int e = tid; e < kState; e += kThreads)
      bt[(e % kTile) * kPad + e / kTile] = hin[e];
    __syncthreads();
    // the entering state's term: sum_s C_i[s] h[d][s], i = ty*4+a, d = tx*4+k
    float inter[4][4] = {};
#pragma unroll 4
    for (int s = 0; s < kTile; ++s) {
      const float4 c4 = *reinterpret_cast<const float4*>(&ct[s * kPad + ty * 4]);
      const float4 h4 = *reinterpret_cast<const float4*>(&bt[s * kPad + tx * 4]);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) inter[a][k] = fmaf(cv[a], hv[k], inter[a][k]);
    }
    // the intra-chunk term, slab by slab of 64 j up to the tile's diagonal
    float acc[4][4] = {};
    for (int jb = 0; jb < n_slabs; ++jb) {
      __syncthreads();
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int j = e / kTile, col = e % kTile;
        const int64_t row = row0 + jb * kTile + j;
        const bool live = jb * kTile + j < p.chunk && row < p.s && col < p.dh;
        xs[e] = live ? to_f(x[bi * p.x_sb + row * p.x_ss + h * p.x_sh + col]) : 0.f;
      }
      {  // wt[j][i]: a thread owns one i (a warp 32 consecutive) and 16 j's
        const int il = tid & (kTile - 1), ig = i0 + il;
        const float li = cum[ig];
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const int jl = (tid >> 6) + 4 * q, jg = jb * kTile + jl;
          const float decay = expf(fminf(fmaxf(li - cum[jg], -60.f), 0.f));
          wt[jl * kTile + il] =
              jg <= ig ? (decay * cbt[jg * kTile + il]) * dts[jg] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float4 w4 = *reinterpret_cast<const float4*>(&wt[j * kTile + ty * 4]);
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[j * kTile + tx * 4]);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(wv[a], xv[k], acc[a][k]);
      }
    }
    // y = intra + exp(L_i) inter + D x_i; xs holds the diagonal slab's rows
    const float dskip = Dskip[h];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = ty * 4 + a, ig = i0 + il;
      const int64_t row = row0 + ig;
      if (ig >= p.chunk || row >= p.s) continue;
      const float e_l = expf(cum[ig]);
      T* out = y + (bi * p.s + row) * (p.nh * p.dh) + h * p.dh;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = tx * 4 + k;
        if (d >= p.dh) continue;
        const float xi = xs[(ig - (n_slabs - 1) * kTile) * kTile + d];
        store(out + d, __fadd_rn(__fadd_rn(acc[a][k], inter[a][k] * e_l),
                                 __fmul_rn(dskip, xi)));
      }
    }
  }
}

cudaError_t set_smem(const void* fn, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kOutSmem));
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const float* dt,
           const float* A, const float* Dskip, const float* h0, void* y,
           float* h_out, float* states, float* tot, const SsdParams& p,
           cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  cudaError_t err = set_smem(reinterpret_cast<const void*>(&ssd_chunk_out_kernel<T>), ready);
  if (err != cudaSuccess) return int(err);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  ssd_chunk_state_kernel<T><<<dim3(unsigned(p.n_chunks), unsigned(p.nh), unsigned(p.b)),
                              kThreads, 0, stream>>>(xt, bt, dt, A, states, tot, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_state_pass_kernel<<<dim3(kState / kThreads, unsigned(p.nh), unsigned(p.b)),
                          kThreads, 0, stream>>>(states, tot, h0, h_out, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t groups = (p.nh + kHeadGroup - 1) / kHeadGroup;
  ssd_chunk_out_kernel<T><<<dim3(unsigned(p.n_chunks * p.row_tiles), unsigned(groups),
                                 unsigned(p.b)),
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
      (p.nh + kHeadGroup - 1) / kHeadGroup > 65535 || p.nh > 65535)
    return int(cudaErrorInvalidValue);
  p.n_chunks = (p.s + p.chunk - 1) / p.chunk;
  p.row_tiles = (p.chunk + kTile - 1) / kTile;
  if (p.n_chunks * p.row_tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, bm, cm, dt, A, Dskip, h0, y, h_out, states, tot, p, st)
              : launch<float>(x, bm, cm, dt, A, Dskip, h0, y, h_out, states, tot, p, st);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
