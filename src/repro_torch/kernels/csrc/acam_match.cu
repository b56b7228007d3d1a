// acam_match: analog-CAM interval match (sm_90a).
//
// Replaces the TPU kernel `acam_match_pallas` (src/repro/kernels/acam.py,
// bodies `_interval_kernel` and `_write_match`).  Row j matches query i iff
// lo[j, d] <= q[i, d] <= hi[j, d] for every dimension d: a cell violates
// when `q < lo || q > hi`, and the output is `no violation` as one byte per
// (query, row) pair, written straight into a torch.bool (M, N) matrix.
// Rows at or past `n_valid` write 0.  A wildcard cell [-inf, +inf] can never
// violate, and a NaN query cell adds no violation (both compares are false),
// exactly as in `ref.acam_violations`.  The compares are IEEE: this file
// must not be built with --use_fast_math.
//
// Bound on an H100 SXM: no arithmetic beyond two float compares per cell.
// The CUDA C++ Programming Guide's throughput table gives 64 compares per
// clock per SM for compute capability 9.0, so at the forest shape
// (1024 queries x 131,072 interval rows x 64 dims = 8.6e9 cells) the bound
// is 1.7e10 compares / (64 x 132 SMs x 1.98 GHz) = 1.0 ms; the operands
// and the bool output are 0.2 GB, 0.06 ms at 3.35 TB/s.  The kernel is
// compare-bound.  The design: one block owns a 128-query x 128-row tile
// and loops over D itself (the TPU's sequential `d` grid axis and its VMEM
// accumulator become this loop; nothing crosses blocks).  Each D stage
// puts 16 dims of q, lo and hi in shared memory, and each of the 256
// threads keeps a violation flag for its 8 x 8 (query, row) pairs in
// registers: 64 cells for 24 shared-memory loads.  Neighbouring threads
// write neighbouring 4-byte groups of an output row.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockM = 128;   // queries per block
constexpr int kBlockN = 128;   // interval rows per block
constexpr int kBlockD = 16;    // dims per shared-memory stage

// Transposed stage of a (128 rows x kBlockD dims) slab of a row-major
// (rows, D) operand into tile[kBlockD][128]; rows past `rows` load zero.
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ src,
                                      int rows, int row0, int D, int d0, int tid) {
#pragma unroll
  for (int v = tid; v < 128 * kBlockD / 4; v += kThreads) {
    const int r = v / (kBlockD / 4);
    const int c = (v % (kBlockD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      x = *reinterpret_cast<const float4*>(src + size_t(row0 + r) * D + d0 + c);
    tile[(c + 0) * 128 + r] = x.x;
    tile[(c + 1) * 128 + r] = x.y;
    tile[(c + 2) * 128 + r] = x.z;
    tile[(c + 3) * 128 + r] = x.w;
  }
}

// Eight values of a tile row: [4*t, 4*t+4) and [64 + 4*t, 64 + 4*t + 4).
__device__ __forceinline__ void fetch8(const float* row, int t, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ int micro_index(int t, int i) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + (i - 4);
}

__global__ void __launch_bounds__(kThreads)
acam_match_kernel(const float* __restrict__ q, const float* __restrict__ lo,
                  const float* __restrict__ hi, unsigned char* __restrict__ out,
                  int M, int N, int D, int n_valid) {
  __shared__ __align__(16) float q_s[kBlockD * kBlockM];
  __shared__ __align__(16) float lo_s[kBlockD * kBlockN];
  __shared__ __align__(16) float hi_s[kBlockD * kBlockN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * kBlockM;

  unsigned bad[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) bad[i][j] = 0u;

  for (int d0 = 0; d0 < D; d0 += kBlockD) {
    stage(q_s, q, M, m0, D, d0, tid);
    stage(lo_s, lo, N, n0, D, d0, tid);
    stage(hi_s, hi, N, n0, D, d0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockD; ++kk) {
      float a[8], l[8], h[8];
      fetch8(q_s + kk * kBlockM, ty, a);
      fetch8(lo_s + kk * kBlockN, tx, l);
      fetch8(hi_s + kk * kBlockN, tx, h);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bad[i][j] |= unsigned((a[i] < l[j]) | (a[i] > h[j]));
    }
    __syncthreads();
  }

  const bool vec4 = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + micro_index(ty, i);
    if (row >= M) continue;
    unsigned char* orow = out + size_t(row) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = n0 + 64 * half + 4 * tx;
      unsigned char b[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        b[jj] = (c0 + jj < n_valid && !bad[i][4 * half + jj]) ? 1 : 0;
      if (vec4 && c0 + 3 < N) {
        *reinterpret_cast<uchar4*>(orow + c0) = make_uchar4(b[0], b[1], b[2], b[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (c0 + jj < N) orow[c0 + jj] = b[jj];
      }
    }
  }
}

}  // namespace

// q (M, D), lo / hi (N, D) float32 row-major, D a positive multiple of 16,
// 16-byte aligned; out (M, N) bytes.  Returns a cudaError_t code.
extern "C" int c4cam_acam_match(const float* q, const float* lo, const float* hi,
                                unsigned char* out, int M, int N, int D,
                                int n_valid, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % kBlockD) return int(cudaErrorInvalidValue);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
  acam_match_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, lo, hi, out, M, N, D, n_valid);
  return int(cudaGetLastError());
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
