// range_match: thresholded CAM distance, the TH sensing mode (sm_90a).
//
// Replaces the TPU kernel `range_match_pallas` (src/repro/kernels/acam.py:193,
// bodies `_range_kernel` and `_write_match`).  The distance is the
// reference's decomposition  alpha * q.p + beta * sum f(q) + gamma * sum f(p)
// (METRIC_COEFFS; hamming on {0,1} cells (-2, 1, 1) with f(x) = x, squared
// eucl (-2, 1, 1) with f(x) = x * x, dot (1, 0, 0)).  The epilogue maps it
// to the logical metric domain (identity, or v = dim - 2 * h for a bipolar
// search) and writes `v <= tau` (or `v >= tau`) as one byte per (query,
// row) pair into a torch.bool (M, N) matrix; rows at or past `n_valid`
// write 0.  Any M and N; D a multiple of 8 (TMA reads columns past D as 0).
//
// Bound on an H100 SXM: the product q.p on the tensor cores as 3xTF32,
// 3 * 2*M*N*D FLOP at 495 TFLOP/s: 2.29 ms at the range shape (1024-query
// chunk x 180,000 rows x 1024 dims), against 0.24 ms to read the 737 MB
// gallery once and 0.06 ms to write the 184 MB of bools at 3.35 TB/s.
// (On the CUDA cores' float32 FMA, the earlier route, the bound was
// 5.6 ms.)  The design:
//
// * 3xTF32 on a pipeline (tf32_wgmma.cuh, shared with B2's fused_topk.cu).
//   A block owns 128 queries x 128 gallery rows: hi/lo TF32 splits, three
//   wgmma.m64n128k8 per k-step from a 4-stage TMA ring filled by a
//   producer warp, two consumer warpgroups of 64 query rows.
// * The gallery read once.  The query-block index runs fastest in the
//   grid, so the 8 query blocks of a gallery tile run together and each
//   gallery byte comes from device memory once (the 4 MB of queries stay
//   in L2).
// * Norms and threshold.  sum f(q) and sum f(p) are taken in float32 on
//   the CUDA cores, in the same order for every tile, from the staged
//   float32 values; the epilogue folds the threshold into the accumulator
//   fragment and writes the bools through shared memory with 16-byte
//   stores where N allows.
#include "tf32_wgmma.cuh"

namespace {

using namespace c4cam_tf32;

// kMetric: 0 = hamming, 1 = eucl, 2 = dot.
template <int kMetric>
__global__ void __launch_bounds__(kThreads, 1)
range_match_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tp,
                   unsigned char* __restrict__ out, int M, int N, int D,
                   int n_valid, float tau, int below, int bipolar, float dimf) {
  constexpr bool kNorms = kMetric != 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int n_mb = (M + kBlockM - 1) / kBlockM;
  const int m0 = (blockIdx.x % n_mb) * kBlockM;
  const int n0 = (blockIdx.x / n_mb) * kBlockN;

  float acc[64];
  if (!product_tile<kMetric>(&tq, &tp, D, m0, n0, smem, acc)) return;
  const float* qn_s = row_norms(smem);
  const float* pn_s = col_norms(smem);

  // ---- epilogue ----
  const int w = threadIdx.x / 128, ctid = threadIdx.x % 128;
  const int lane = ctid % 32, t = lane % 4;
  const int r0 = 64 * w + 16 * (ctid / 32) + lane / 4;   // rows r0, r0 + 8

  // bools of this warpgroup's 64 rows x 128 columns into stage 0's q tile,
  // 16-byte chunks swizzled by row
  unsigned char* tile = smem + w * 64 * 128;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;                      // row within the block
      unsigned char b[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float d = acc[4 * j + 2 * h + e];
        if constexpr (kNorms)
          d = -2.0f * d + qn_s[r] + (pn_s[c + e] + pn_s[128 + c + e]);
        const float v = bipolar ? dimf - 2.0f * d : d;
        const bool hit = below ? (v <= tau) : (v >= tau);
        b[e] = (hit && n0 + c + e < n_valid) ? 1 : 0;
      }
      const int rl = r - 64 * w;
      const int off = rl * 128 + (((c >> 4) ^ (rl & 7)) << 4) + (c & 15);
      *reinterpret_cast<uchar2*>(tile + off) = make_uchar2(b[0], b[1]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
  const bool vec = (N & 15) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = ctid + 128 * i;                 // 64 rows x 8 chunks
    const int rl = idx >> 3, c = idx & 7;
    const int row = m0 + 64 * w + rl;
    const int col = n0 + 16 * c;
    if (row >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + rl * 128 + ((c ^ (rl & 7)) << 4));
    unsigned char* dst = out + size_t(row) * N + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&v);
      for (int e = 0; e < 16 && col + e < N; ++e) dst[e] = bytes[e];
    }
  }
}

template <int kMetric>
int launch(const float* q, const float* p, unsigned char* out, int M, int N, int D,
           int n_valid, float tau, int below, int bipolar, int dim, cudaStream_t s) {
  CUtensorMap tq, tp;
  if (!encode(&tq, q, M, D) || !encode(&tp, p, N, D)) return int(cudaErrorInvalidValue);
  static std::atomic<uint64_t> ready{0};     // the smem attribute, a bit per device
  const cudaError_t err = allow_smem(range_match_kernel<kMetric>, ready);
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((M + kBlockM - 1) / kBlockM) *
                          ((N + kBlockN - 1) / kBlockN);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  range_match_kernel<kMetric><<<unsigned(tiles), kThreads, kSmem, s>>>(
      tq, tp, out, M, N, D, n_valid, tau, below, bipolar, float(dim));
  return int(cudaGetLastError());
}

}  // namespace

// q (M, D), p (N, D) float32 row-major, D a positive multiple of 8, 16-byte
// aligned; out (M, N) bytes.  metric: 0 = hamming, 1 = eucl, 2 = dot.
// Returns a cudaError_t code.
extern "C" int c4cam_range_match(const float* q, const float* p, unsigned char* out,
                                 int M, int N, int D, int n_valid, float tau,
                                 int below, int bipolar, int dim, int metric,
                                 void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % 8) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case 0: return launch<0>(q, p, out, M, N, D, n_valid, tau, below, bipolar, dim, s);
    case 1: return launch<1>(q, p, out, M, N, D, n_valid, tau, below, bipolar, dim, s);
    case 2: return launch<2>(q, p, out, M, N, D, n_valid, tau, below, bipolar, dim, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
