// fused_topk_packed: XOR + popcount distance + block top-k (sm_90a).
//
// Replaces the TPU kernel `fused_topk_packed_pallas`
// (src/repro/kernels/cam_search.py, bodies `_packed_kernel`,
// `_packed_ternary_kernel`, `_packed_accumulate`, `_extract_block_topk`).
// Operands are 32-cell lanes (int32 bit patterns): the distance is
// popcount(q ^ p) for binary cells and popcount((q ^ p) & care) for TCAM
// ternary cells, summed over lanes in int32 — exact integers, so the
// candidates are bit-identical to the reference whatever the blocking.
//
// Bound on an H100: one __popc per (query, row, lane).  The CUDA C++
// Programming Guide's throughput table gives 16 population counts per
// clock per SM for compute capability 9.0, so at the KNN shape
// (1024-query chunk x 180,096 rows x 32 lanes, 5.9e9 popc) the bound is
// about 1.4 ms at 132 SMs and 1.98 GHz; the 23 MB packed gallery takes
// 7 us to read.  The kernel is popc-bound: the design keeps XOR, AND and
// the add on the 64-wide integer pipes beside the 16-wide popc pipe, with
// an 8x8 register micro-tile per thread (64 popc per 16 shared-memory
// loads), and selects the block top-k in shared memory.
#include "fused_topk_common.cuh"

namespace {

struct BinaryLanes {
  using T = int;
  using Acc = int;
  static constexpr bool kCare = false;
  static constexpr bool kNorms = false;
  __device__ static void step(int& acc, int a, int b, int) { acc += __popc(a ^ b); }
  __device__ static float finish(int acc, float, float) { return float(acc); }
};

struct TernaryLanes {
  using T = int;
  using Acc = int;
  static constexpr bool kCare = true;
  static constexpr bool kNorms = false;
  __device__ static void step(int& acc, int a, int b, int c) { acc += __popc((a ^ b) & c); }
  __device__ static float finish(int acc, float, float) { return float(acc); }
};

}  // namespace

// care == nullptr selects the binary kernel.  Returns a cudaError_t code.
extern "C" int c4cam_fused_topk_packed(const int* q, const int* p,
                                       const int* care, float* out_v,
                                       int* out_i, int M, int N, int L, int k,
                                       int window, int n_valid, int largest,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (care == nullptr)
    return c4cam::launch_fused_topk<BinaryLanes>(q, p, nullptr, out_v, out_i, M, N, L, k,
                                                 window, n_valid, largest, s);
  return c4cam::launch_fused_topk<TernaryLanes>(q, p, care, out_v, out_i, M, N, L, k,
                                                window, n_valid, largest, s);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
