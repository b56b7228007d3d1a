// fused_topk: float distance + block top-k (sm_90a).
//
// Replaces the TPU kernel `fused_topk_pallas` (src/repro/kernels/cam_search.py,
// bodies `_fused_kernel` and `_extract_block_topk`).  Every metric is the
// reference's decomposition  alpha * q.p + beta * sum f(q) + gamma * sum f(p):
//   hamming on {0,1} cells: (-2, 1, 1), f(x) = x
//   eucl (squared L2):      (-2, 1, 1), f(x) = x * x
//   dot:                    ( 1, 0, 0)
// and each window of gallery rows yields its block-local top-k in the
// reference's order: largest key first (key = value, or -value for
// smallest-first), lowest global row on equal keys, rows at or past
// `n_valid` losing (key -3e38, value -/+3e38), written as the (M,
// n_windows * k) window-major candidate layout.  Two routes, chosen by the
// caller from the window (`cam_search.float_route`):
//
// * "wgmma" (windows of 128 rows, k <= 128): the product q.p on the tensor
//   cores as 3xTF32 on B4's pipeline (tf32_wgmma.cuh: hi/lo TF32 splits,
//   three wgmma.m64n128k8 per k-step from a 4-stage TMA ring filled by a
//   producer warp, two consumer warpgroups of 64 query rows, the
//   query-block index fastest in the grid so each gallery tile is read
//   from device memory once).  A block owns 128 queries x one window.  The
//   epilogue selects from registers: in the m64n128 accumulator a row lives
//   in one quad of threads, 32 columns each; each thread keeps its best
//   unconsumed (key, column), the quad reduces to the winner in two
//   shuffles (lower column on equal keys), and the owner marks the column
//   consumed and rescans its 32 values; k rounds.  On {0,1} and +-1 cells
//   the TF32 lo halves are 0 and every partial sum an integer below 2^24,
//   so hamming and dot there are exact; eucl trades the exact float32 sums
//   for the tensor cores' (each k-step's eight products aligned and
//   truncated to the largest exponent, the sum truncated to float32).
// * "fma" (windows of 256 or 384 rows): the product in float32 FMA on the
//   CUDA cores, an 8x8 register micro-tile a thread, and the (128 x window)
//   key block's top-k in shared memory (fused_topk_common.cuh).
//
// Bound on an H100 SXM at the KNN shape (624 queries x 180,096 rows x 1024
// dims, 5 query blocks): the "wgmma" route's 3 * 2*M*N*D FLOP at 495
// TFLOP/s, 1.40 ms (the "fma" route's 2*M*N*D at 67 TFLOP/s, 3.43 ms),
// against 0.22 ms to read the 737 MB gallery once at 3.35 TB/s.
#include "fused_topk_common.cuh"
#include "tf32_wgmma.cuh"

namespace {

struct HammingF32 {
  using T = float;
  using Acc = float;
  static constexpr bool kCare = false;
  static constexpr bool kNorms = true;
  __device__ static void step(float& acc, float a, float b, float) { acc = fmaf(a, b, acc); }
  __device__ static float f(float x) { return x; }
  __device__ static float finish(float acc, float qn, float pn) { return -2.0f * acc + qn + pn; }
};

struct EuclF32 {
  using T = float;
  using Acc = float;
  static constexpr bool kCare = false;
  static constexpr bool kNorms = true;
  __device__ static void step(float& acc, float a, float b, float) { acc = fmaf(a, b, acc); }
  __device__ static float f(float x) { return x * x; }
  __device__ static float finish(float acc, float qn, float pn) { return -2.0f * acc + qn + pn; }
};

struct DotF32 {
  using T = float;
  using Acc = float;
  static constexpr bool kCare = false;
  static constexpr bool kNorms = false;
  __device__ static void step(float& acc, float a, float b, float) { acc = fmaf(a, b, acc); }
  __device__ static float finish(float acc, float, float) { return acc; }
};

int launch_fma(const float* q, const float* p, float* out_v, int* out_i, int M, int N,
               int D, int k, int window, int n_valid, int largest, int metric,
               cudaStream_t s) {
  switch (metric) {
    case 0:
      return c4cam::launch_fused_topk<HammingF32>(q, p, nullptr, out_v, out_i, M, N, D, k,
                                                  window, n_valid, largest, s);
    case 1:
      return c4cam::launch_fused_topk<EuclF32>(q, p, nullptr, out_v, out_i, M, N, D, k,
                                               window, n_valid, largest, s);
    case 2:
      return c4cam::launch_fused_topk<DotF32>(q, p, nullptr, out_v, out_i, M, N, D, k,
                                              window, n_valid, largest, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// ---- the "wgmma" route ----------------------------------------------------

namespace tc = c4cam_tf32;

// The best unconsumed (key, column) of this thread's 32 values of row
// r0 + 8 h: ascending columns with a strict compare, so the lowest column
// wins among equal keys.  Bit i of `used` is value (j, e) = (i / 2, i % 2),
// column 8 j + 2 t + e.
__device__ __forceinline__ void best_of(const float (&key)[64], int h, int t,
                                        uint32_t used, float& bk, int& bc) {
  bk = -INFINITY;
  bc = 255;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = key[4 * j + 2 * h + e];
      if (!((used >> (2 * j + e)) & 1u) && v > bk) {
        bk = v;
        bc = 8 * j + 2 * t + e;
      }
    }
}

// kMetric: 0 = hamming, 1 = eucl, 2 = dot.
template <int kMetric>
__global__ void __launch_bounds__(tc::kThreads, 1)
fused_topk_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tp,
                        float* __restrict__ out_v, int* __restrict__ out_i, int M,
                        int D, int k, int n_valid, int largest) {
  constexpr bool kNorms = kMetric != 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tc::aligned_smem(smem_raw);
  const int n_mb = (M + tc::kBlockM - 1) / tc::kBlockM;
  const int m0 = (blockIdx.x % n_mb) * tc::kBlockM;
  const int win = blockIdx.x / n_mb;
  const int n0 = win * tc::kBlockN;

  float key[64];
  if (!tc::product_tile<kMetric>(&tq, &tp, D, m0, n0, smem, key)) return;
  const float* qn_s = tc::row_norms(smem);
  const float* pn_s = tc::col_norms(smem);

  const int w = threadIdx.x / 128, ctid = threadIdx.x % 128;
  const int lane = ctid % 32, t = lane % 4;
  const int r0 = 64 * w + 16 * (ctid / 32) + lane / 4;   // rows r0, r0 + 8

  // distances -> selection keys, in place (B4's order of operations)
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        float d = key[4 * j + 2 * h + e];
        if constexpr (kNorms)
          d = -2.0f * d + qn_s[r0 + 8 * h] + (pn_s[c] + pn_s[128 + c]);
        key[4 * j + 2 * h + e] =
            n0 + c < n_valid ? (largest ? d : -d) : c4cam::kNegBig;
      }

  // k rounds per row, the two rows of the thread side by side
  const size_t ld = size_t(gridDim.x / n_mb) * k;
  const int rows[2] = {m0 + r0, m0 + r0 + 8};
  uint32_t used[2] = {0u, 0u};
  float bk[2];
  int bc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) best_of(key, h, t, used[h], bk[h], bc[h]);
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wk = bk[h];
      int wc = bc[h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ok = __shfl_xor_sync(0xffffffffu, wk, off);
        const int oc = __shfl_xor_sync(0xffffffffu, wc, off);
        if (ok > wk || (ok == wk && oc < wc)) { wk = ok; wc = oc; }
      }
      if (t == 0 && rows[h] < M) {
        const int g = n0 + wc;
        const size_t o = size_t(rows[h]) * ld + size_t(win) * k + it;
        out_v[o] = g < n_valid ? (largest ? wk : -wk)
                               : (largest ? c4cam::kNegBig : c4cam::kPosBig);
        out_i[o] = g;
      }
      if (wc < tc::kBlockN && ((wc >> 1) & 3) == t)   // the owner retires it
        used[h] |= 1u << (2 * (wc >> 3) + (wc & 1));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) best_of(key, h, t, used[h], bk[h], bc[h]);
  }
}

template <int kMetric>
int launch_wgmma_metric(const float* q, const float* p, float* out_v, int* out_i, int M,
                        int N, int D, int k, int n_valid, int largest, cudaStream_t s) {
  CUtensorMap tq, tp;
  if (!tc::encode(&tq, q, M, D) || !tc::encode(&tp, p, N, D))
    return int(cudaErrorInvalidValue);
  static std::atomic<uint64_t> ready{0};     // the smem attribute, a bit per device
  const cudaError_t err = tc::allow_smem(fused_topk_wgmma_kernel<kMetric>, ready);
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((M + tc::kBlockM - 1) / tc::kBlockM) *
                          (N / tc::kBlockN);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  fused_topk_wgmma_kernel<kMetric><<<unsigned(tiles), tc::kThreads, tc::kSmem, s>>>(
      tq, tp, out_v, out_i, M, D, k, n_valid, largest);
  return int(cudaGetLastError());
}

int launch_wgmma(const float* q, const float* p, float* out_v, int* out_i, int M, int N,
                 int D, int k, int window, int n_valid, int largest, int metric,
                 cudaStream_t s) {
  if (window != tc::kBlockN || k < 1 || k > window || N % window)
    return int(cudaErrorInvalidValue);
  switch (metric) {
    case 0: return launch_wgmma_metric<0>(q, p, out_v, out_i, M, N, D, k, n_valid, largest, s);
    case 1: return launch_wgmma_metric<1>(q, p, out_v, out_i, M, N, D, k, n_valid, largest, s);
    case 2: return launch_wgmma_metric<2>(q, p, out_v, out_i, M, N, D, k, n_valid, largest, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (M, D), p (N, D) float32 row-major, 16-byte aligned, D a positive
// multiple of 8, N a multiple of `window`; out_v / out_i (M, N / window * k).
// metric: 0 = hamming, 1 = eucl, 2 = dot; route: 1 = "wgmma" (window 128
// only), 0 = "fma".  Returns a cudaError_t code.
extern "C" int c4cam_fused_topk_f32(const float* q, const float* p,
                                    float* out_v, int* out_i, int M, int N,
                                    int D, int k, int window, int n_valid,
                                    int largest, int metric, int route,
                                    void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % 8) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return launch_wgmma(q, p, out_v, out_i, M, N, D, k, window, n_valid, largest, metric, s);
  return launch_fma(q, p, out_v, out_i, M, N, D, k, window, n_valid, largest, metric, s);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
