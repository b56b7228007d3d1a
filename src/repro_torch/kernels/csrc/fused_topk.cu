// fused_topk: float distance + block top-k on the CUDA cores (sm_90a).
//
// Replaces the TPU kernel `fused_topk_pallas` (src/repro/kernels/cam_search.py,
// bodies `_fused_kernel` and `_extract_block_topk`).  Every metric is the
// reference's decomposition  alpha * q.p + beta * sum f(q) + gamma * sum f(p):
//   hamming on {0,1} cells: (-2, 1, 1), f(x) = x
//   eucl (squared L2):      (-2, 1, 1), f(x) = x * x
//   dot:                    ( 1, 0, 0)
// The product q.p is accumulated here in float32 FMA on the CUDA cores:
// no tensor cores, so no TF32 rounding — near-tie indices on eucl depend on
// float32 accuracy.
//
// Bound on an H100 SXM: 2*M*N*D FLOP against 67 TFLOP/s (float32, CUDA
// cores).  At the KNN shape (1024-query chunk x 180,096 rows x 1024 dims)
// that is 5.6 ms, against 0.24 ms to read the 737 MB gallery once at
// 3.35 TB/s: the kernel is compute-bound.  The design answers with an
// 8x8 register micro-tile per thread (64 FMAs per 16 shared-memory loads)
// and keeps the (128 x window) distance block and its top-k selection in
// shared memory, so only k candidates per window reach device memory.
// wgmma/TMA pipelining is later work.
#include "fused_topk_common.cuh"

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

}  // namespace

// metric: 0 = hamming, 1 = eucl, 2 = dot.  Returns a cudaError_t code.
extern "C" int c4cam_fused_topk_f32(const float* q, const float* p,
                                    float* out_v, int* out_i, int M, int N,
                                    int D, int k, int window, int n_valid,
                                    int largest, int metric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
