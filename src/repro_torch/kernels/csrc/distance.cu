// distance: the full CAM distance matrix (sm_90a).
//
// Replaces the TPU kernel `distance_pallas` (src/repro/kernels/cam_search.py,
// body `_dist_kernel`), behind the public `cam_distances` / `cam_exact` /
// `cam_range`.  It writes the float32 (M, N) matrix of the reference's
// decomposition  alpha * q.p + beta * sum f(q) + gamma * sum f(p)
// (METRIC_COEFFS; hamming on {0,1} cells (-2, 1, 1) with f(x) = x, squared
// eucl (-2, 1, 1) with f(x) = x * x, dot (1, 0, 0)).  Any M and N; D a
// multiple of 8 (TMA reads columns past D as 0).
//
// Bound on an H100 SXM: the product q.p on the tensor cores as 3xTF32,
// 3 * 2*M*N*D FLOP at 495 TFLOP/s: 1.39 ms at the KNN shape (624 queries x
// 180,000 rows x 1024 dims), against 0.36 ms to read the operands and write
// the 449 MB float32 output at 3.35 TB/s.  (On the CUDA cores' float32
// FMA, the earlier route, the bound was 3.44 ms.)  The design is B4's
// (range_match.cu) with another epilogue:
//
// * 3xTF32 on a pipeline (tf32_wgmma.cuh, shared with B2 and B4).  A block
//   owns 128 queries x 128 gallery rows: hi/lo TF32 splits, three
//   wgmma.m64n128k8 per k-step from a 4-stage TMA ring filled by a producer
//   warp, two consumer warpgroups of 64 query rows.  On {0,1} and +-1
//   cells the lo halves are 0 and every partial sum an integer below 2^24,
//   so hamming and dot there are exact; eucl takes the tensor cores'
//   accumulation (each k-step's products aligned to the largest nominal
//   exponent and kept to 25 bits, the sum truncated to float32:
//   cam_search.tc_accumulate replays it).
// * The gallery read once.  The query-block index runs fastest in the
//   grid, so the query blocks of a gallery tile run together and each
//   gallery byte comes from device memory once.
// * The epilogue computes  -2 acc + qn + (pn_lo + pn_hi)  in B4's order and
//   stores the floats straight from the accumulator fragment: a quad of
//   threads owns 32 contiguous bytes of a row, 8-byte stores where N is
//   even.  (Staging the fragment through the freed ring for 16-byte stores
//   of whole rows was no faster: b6_ablation.py times the two.)
#include "tf32_wgmma.cuh"

namespace {

using namespace c4cam_tf32;

// kMetric: 0 = hamming, 1 = eucl, 2 = dot.
template <int kMetric>
__global__ void __launch_bounds__(kThreads, 1)
distance_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tp, float* __restrict__ out,
                int M, int N, int D) {
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
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& d = acc[4 * j + 2 * h + e];
        if constexpr (kNorms)
          d = -2.0f * d + qn_s[r] + (pn_s[c + e] + pn_s[128 + c + e]);
      }
    }
  }
  const bool vec = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r0 + 8 * h;
    if (row >= M) continue;
    float* orow = out + size_t(row) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
      if (vec && col + 1 < N) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(d0, d1);
      } else {
        if (col < N) orow[col] = d0;
        if (col + 1 < N) orow[col + 1] = d1;
      }
    }
  }
}

template <int kMetric>
int launch(const float* q, const float* p, float* out, int M, int N, int D,
           cudaStream_t s) {
  CUtensorMap tq, tp;
  if (!encode(&tq, q, M, D) || !encode(&tp, p, N, D)) return int(cudaErrorInvalidValue);
  static std::atomic<uint64_t> ready{0};     // the smem attribute, a bit per device
  const cudaError_t err = allow_smem(distance_kernel<kMetric>, ready);
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((M + kBlockM - 1) / kBlockM) *
                          ((N + kBlockN - 1) / kBlockN);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  distance_kernel<kMetric><<<unsigned(tiles), kThreads, kSmem, s>>>(tq, tp, out, M, N, D);
  return int(cudaGetLastError());
}

}  // namespace

// q (M, D), p (N, D) float32 row-major, D a positive multiple of 8, 16-byte
// aligned; out (M, N) float32.  metric: 0 = hamming, 1 = eucl, 2 = dot.
// Returns a cudaError_t code.
extern "C" int c4cam_distance(const float* q, const float* p, float* out, int M,
                              int N, int D, int metric, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % 8) return int(cudaErrorInvalidValue);
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
