// Shared body of the fused distance + block top-k kernels (sm_90a).
//
// One thread block owns kBlockM = 128 query rows and one *window* of
// gallery rows (a multiple of kTileN = 128, at least k).  It computes the
// (128 x window) distance block kTileN rows at a time: the inner dimension
// streams through shared memory kBlockK = 8 floats (or 32-cell lanes) per
// step, and each of the 256 threads accumulates an 8 x 8 micro-tile in
// registers.  The finished distances become selection keys in shared
// memory, and one warp per query row extracts the window's top-k with
// exactly the ordering of the reference's `_extract_block_topk`:
// largest key first, lowest global row index on equal keys, and rows
// at or beyond `n_valid` always lose (key -3e38, value -/+3e38).
//
// The output is the reference's candidate layout: row-major
// (M, n_windows * k) values (float32) and global row indices (int32),
// window-major within a row, ready for the host-side stable merge.
//
// Operand contract (checked by the Python wrapper): row-major, 16-byte
// aligned, inner dimension a positive multiple of kBlockK, gallery rows a
// multiple of the window.  Query rows are unrestricted (rows >= M load as
// zero and are never written).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace c4cam {

constexpr int kThreads = 256;
constexpr int kBlockM = 128;
constexpr int kTileN = 128;
constexpr int kBlockK = 8;
constexpr float kNegBig = -3.0e38f;
constexpr float kPosBig = 3.0e38f;

template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <class T>
__device__ __forceinline__ typename Vec4<T>::type load4(const T* ptr) {
  return *reinterpret_cast<const typename Vec4<T>::type*>(ptr);
}

template <class T>
__device__ __forceinline__ typename Vec4<T>::type zero4() {
  typename Vec4<T>::type v;
  v.x = v.y = v.z = v.w = T(0);
  return v;
}

// Transposed store of one 4-wide vector into a [kBlockK][rows] tile.
template <class V, class T>
__device__ __forceinline__ void store_t(T* tile, int rows, int col, int row,
                                        const V& v) {
  tile[(col + 0) * rows + row] = v.x;
  tile[(col + 1) * rows + row] = v.y;
  tile[(col + 2) * rows + row] = v.z;
  tile[(col + 3) * rows + row] = v.w;
}

// Eight values of a [kBlockK][rows] tile row: [4*t, 4*t+4) and
// [64 + 4*t, 64 + 4*t + 4), the conflict-free split micro-tile.
template <class T>
__device__ __forceinline__ void fetch8(const T* tile_row, int t, T out[8]) {
  const auto lo = *reinterpret_cast<const typename Vec4<T>::type*>(tile_row + 4 * t);
  const auto hi = *reinterpret_cast<const typename Vec4<T>::type*>(tile_row + 64 + 4 * t);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

__device__ __forceinline__ int micro_index(int t, int i) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + (i - 4);
}

template <class Tr>
size_t smem_bytes(int window) {
  const size_t operands = size_t(kBlockK) *
      (kBlockM + kTileN * (Tr::kCare ? 2 : 1)) * sizeof(typename Tr::T);
  return operands + (kBlockM + kTileN) * sizeof(float) +
         size_t(kBlockM) * window * sizeof(float);
}

template <class Tr>
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const typename Tr::T* __restrict__ q,
                  const typename Tr::T* __restrict__ p,
                  const typename Tr::T* __restrict__ care,
                  float* __restrict__ out_v, int* __restrict__ out_i,
                  int M, int D, int k, int window, int n_valid, int largest) {
  using T = typename Tr::T;
  using V = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem);                 // [kBlockK][kBlockM]
  T* b_s = a_s + kBlockK * kBlockM;                    // [kBlockK][kTileN]
  T* c_s = b_s + kBlockK * kTileN;                     // care, ternary only
  float* qn_s = reinterpret_cast<float*>(c_s + (Tr::kCare ? kBlockK * kTileN : 0));
  float* pn_s = qn_s + kBlockM;
  float* keys = pn_s + kTileN;                         // [kBlockM][window]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBlockM;
  const int wbase = blockIdx.x * window;
  const int lrow = tid >> 1, lcol = (tid & 1) * 4;    // loader coordinates

  for (int s = 0; s < window; s += kTileN) {
    const int n0 = wbase + s;
    typename Tr::Acc acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    float norm = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBlockK) {
      const int qrow = m0 + lrow;
      const V qv = qrow < M ? load4(q + size_t(qrow) * D + k0 + lcol) : zero4<T>();
      store_t(a_s, kBlockM, lcol, lrow, qv);
      const size_t poff = size_t(n0 + lrow) * D + k0 + lcol;
      store_t(b_s, kTileN, lcol, lrow, load4(p + poff));
      if constexpr (Tr::kCare) store_t(c_s, kTileN, lcol, lrow, load4(care + poff));
      __syncthreads();

      if constexpr (Tr::kNorms) {   // row sums of f(q) (threads 0..127), f(p) (128..255)
        const T* src = tid < kBlockM ? a_s + tid : b_s + (tid - kBlockM);
        const int stride = tid < kBlockM ? kBlockM : kTileN;
#pragma unroll
        for (int kk = 0; kk < kBlockK; ++kk) norm += Tr::f(src[kk * stride]);
      }
#pragma unroll
      for (int kk = 0; kk < kBlockK; ++kk) {
        T a[8], b[8], c[8] = {};
        fetch8(a_s + kk * kBlockM, ty, a);
        fetch8(b_s + kk * kTileN, tx, b);
        if constexpr (Tr::kCare) fetch8(c_s + kk * kTileN, tx, c);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) Tr::step(acc[i][j], a[i], b[j], c[j]);
      }
      __syncthreads();
    }

    if constexpr (Tr::kNorms) {
      if (tid < kBlockM) qn_s[tid] = norm; else pn_s[tid - kBlockM] = norm;
    }
    __syncthreads();
    // Distances -> selection keys.  qn_s/pn_s are rewritten only after the
    // next sub-tile's main loop, whose barriers order these reads first.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = micro_index(ty, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = micro_index(tx, j);
        float d;
        if constexpr (Tr::kNorms) d = Tr::finish(acc[i][j], qn_s[r], pn_s[c]);
        else d = Tr::finish(acc[i][j], 0.f, 0.f);
        keys[size_t(r) * window + s + c] =
            n0 + c < n_valid ? (largest ? d : -d) : kNegBig;
      }
    }
  }
  __syncthreads();

  // Block top-k: one warp per query row.  Column c of the window belongs
  // to lane c % 32; each lane keeps its best unconsumed (key, column), the
  // warp reduces to the winner, and the owning lane retires it (-inf) and
  // rescans its own columns.  Ascending scans and the lower-column rule
  // on equal keys give the lowest global index among ties.
  const int warp = tid >> 5, lane = tid & 31;
  const size_t ld = size_t(gridDim.x) * k;
  for (int r = warp; r < kBlockM; r += kThreads / 32) {
    const int row = m0 + r;
    if (row >= M) break;                                // warp-uniform
    float* kr = keys + size_t(r) * window;
    float bk = kr[lane];
    int bi = lane;
    for (int c = lane + 32; c < window; c += 32) {
      const float v = kr[c];
      if (v > bk) { bk = v; bi = c; }
    }
    float* ov = out_v + size_t(row) * ld + size_t(blockIdx.x) * k;
    int* oi = out_i + size_t(row) * ld + size_t(blockIdx.x) * k;
    for (int t = 0; t < k; ++t) {
      float wk = bk;
      int wi = bi;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ok = __shfl_xor_sync(0xffffffffu, wk, off);
        const int oc = __shfl_xor_sync(0xffffffffu, wi, off);
        if (ok > wk || (ok == wk && oc < wi)) { wk = ok; wi = oc; }
      }
      if (lane == 0) {
        const int g = wbase + wi;
        ov[t] = g < n_valid ? (largest ? wk : -wk) : (largest ? kNegBig : kPosBig);
        oi[t] = g;
      }
      if ((wi & 31) == lane) {
        kr[wi] = -INFINITY;
        bk = kr[lane];
        bi = lane;
        for (int c = lane + 32; c < window; c += 32) {
          const float v = kr[c];
          if (v > bk) { bk = v; bi = c; }
        }
      }
    }
  }
}

template <class Tr>
int launch_fused_topk(const typename Tr::T* q, const typename Tr::T* p,
                      const typename Tr::T* care, float* out_v, int* out_i,
                      int M, int N, int D, int k, int window, int n_valid,
                      int largest, cudaStream_t stream) {
  const size_t smem = smem_bytes<Tr>(window);
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_kernel<Tr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / window, (M + kBlockM - 1) / kBlockM);
  fused_topk_kernel<Tr><<<grid, kThreads, smem, stream>>>(
      q, p, care, out_v, out_i, M, D, k, window, n_valid, largest);
  return int(cudaGetLastError());
}

}  // namespace c4cam
