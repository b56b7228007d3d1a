// distance: the full CAM distance matrix (sm_90a).
//
// Replaces the TPU kernel `distance_pallas` (src/repro/kernels/cam_search.py,
// body `_dist_kernel`), behind the public `cam_distances` / `cam_exact` /
// `cam_range`.  It writes the float32 (M, N) matrix of the reference's
// decomposition  alpha * q.p + beta * sum f(q) + gamma * sum f(p)
// (METRIC_COEFFS; hamming on {0,1} cells (-2, 1, 1) with f(x) = x, squared
// eucl (-2, 1, 1) with f(x) = x * x, dot (1, 0, 0)), accumulated in float32
// FMA on the CUDA cores: no tensor cores, so no TF32 rounding.  The epilogue
// `-2 * acc + qn + pn` contracts to an FMA that rounds as the plain version's
// separate operations do (scaling by 2 is exact), so hamming and dot on
// {0,1} / +-1 cells, integers below 2**24, are bit-identical to it.
//
// Bound on an H100 SXM: 2*M*N*D FLOP against 67 TFLOP/s (float32, CUDA
// cores) and the bytes of q, p and the float32 output at 3.35 TB/s.  At the
// KNN shape (624 queries x 180,000 rows x 1024 dims) that is 3.4 ms of
// arithmetic against 0.36 ms of memory (a 449 MB output): compute-bound.
// The design is B4's (range_match.cu) main loop, copied so B1-B4's sources
// and library hashes stay as they are: a block owns 128 queries x 128 rows,
// the inner dimension streams through shared memory 8 floats per step, and
// each of the 256 threads accumulates an 8x8 register micro-tile (64 FMAs
// per 16 shared-memory loads).  The epilogue stores the distances, 16 bytes
// per thread and row where N allows.  wgmma/TMA pipelining is later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockM = 128;
constexpr int kBlockN = 128;
constexpr int kBlockK = 8;

// Transposed store of one float4 into a [kBlockK][128] tile.
__device__ __forceinline__ void store_t(float* tile, int col, int row, const float4& v) {
  tile[(col + 0) * 128 + row] = v.x;
  tile[(col + 1) * 128 + row] = v.y;
  tile[(col + 2) * 128 + row] = v.z;
  tile[(col + 3) * 128 + row] = v.w;
}

__device__ __forceinline__ void fetch8(const float* row, int t, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ int micro_index(int t, int i) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + (i - 4);
}

// kMetric: 0 = hamming, 1 = eucl, 2 = dot.
template <int kMetric>
__global__ void __launch_bounds__(kThreads)
distance_kernel(const float* __restrict__ q, const float* __restrict__ p,
                float* __restrict__ out, int M, int N, int D) {
  constexpr bool kNorms = kMetric != 2;
  __shared__ __align__(16) float a_s[kBlockK * kBlockM];
  __shared__ __align__(16) float b_s[kBlockK * kBlockN];
  __shared__ float qn_s[kBlockM];
  __shared__ float pn_s[kBlockN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBlockM;
  const int n0 = blockIdx.x * kBlockN;
  const int lrow = tid >> 1, lcol = (tid & 1) * 4;    // loader coordinates

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float norm = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < D; k0 += kBlockK) {
    const int qrow = m0 + lrow, prow = n0 + lrow;
    const float4 qv = qrow < M
        ? *reinterpret_cast<const float4*>(q + size_t(qrow) * D + k0 + lcol) : zero;
    const float4 pv = prow < N
        ? *reinterpret_cast<const float4*>(p + size_t(prow) * D + k0 + lcol) : zero;
    store_t(a_s, lcol, lrow, qv);
    store_t(b_s, lcol, lrow, pv);
    __syncthreads();

    if constexpr (kNorms) {   // row sums of f(q) (threads 0..127), f(p) (128..255)
      const float* src = tid < kBlockM ? a_s + tid : b_s + (tid - kBlockM);
#pragma unroll
      for (int kk = 0; kk < kBlockK; ++kk) {
        const float x = src[kk * 128];
        norm += kMetric == 1 ? x * x : x;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      float a[8], b[8];
      fetch8(a_s + kk * kBlockM, ty, a);
      fetch8(b_s + kk * kBlockN, tx, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if constexpr (kNorms) {
    if (tid < kBlockM) qn_s[tid] = norm; else pn_s[tid - kBlockM] = norm;
    __syncthreads();
  }

  const bool vec4 = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = micro_index(ty, i);
    const int row = m0 + r;
    if (row >= M) continue;
    float* orow = out + size_t(row) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 64 * half + 4 * tx;
      float d[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        d[jj] = acc[i][4 * half + jj];
        if constexpr (kNorms) d[jj] = -2.0f * d[jj] + qn_s[r] + pn_s[c0 + jj];
      }
      const int col = n0 + c0;
      if (vec4 && col + 3 < N) {
        *reinterpret_cast<float4*>(orow + col) = make_float4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (col + jj < N) orow[col + jj] = d[jj];
      }
    }
  }
}

template <int kMetric>
int launch(const float* q, const float* p, float* out, int M, int N, int D,
           cudaStream_t s) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
  distance_kernel<kMetric><<<grid, kThreads, 0, s>>>(q, p, out, M, N, D);
  return int(cudaGetLastError());
}

}  // namespace

// q (M, D), p (N, D) float32 row-major, D a positive multiple of 8, 16-byte
// aligned; out (M, N) float32.  metric: 0 = hamming, 1 = eucl, 2 = dot.
// Returns a cudaError_t code.
extern "C" int c4cam_distance(const float* q, const float* p, float* out, int M,
                              int N, int D, int metric, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % kBlockK) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case 0: return launch<0>(q, p, out, M, N, D, s);
    case 1: return launch<1>(q, p, out, M, N, D, s);
    case 2: return launch<2>(q, p, out, M, N, D, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
