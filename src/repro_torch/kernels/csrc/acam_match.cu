// acam_match: analog-CAM interval match (sm_90a).
//
// Replaces the TPU kernel `acam_match_pallas` (src/repro/kernels/acam.py,
// bodies `_interval_kernel` and `_write_match`).  Row j matches query i iff
// lo[j, d] <= q[i, d] <= hi[j, d] for every dimension d: a cell violates
// when `q < lo || q > hi`, and the output is `no violation` as one byte per
// (query, row) pair, written straight into a torch.bool (M, N) matrix.
// Rows at or past `n_valid` write 0.  A wildcard cell [-inf, +inf] can never
// violate, and a NaN query or bound adds no violation (both compares are
// false), exactly as in `ref.acam_violations`.
//
// No compares: the test runs on the FP32 pipe.  Each operand is made
// canonical once, as it is staged (x + 0: -0 becomes +0, and the card's
// FADD returns any NaN as the positive 0x7FFFFFFF), and a cell is
//   bad |= bits(q - lo) | bits(hi - q)
// (two FADDs and one LOP3); a pair matches iff bad's sign bit is clear.
// Without -0 operands the sign of an IEEE difference is the sign of the
// exact one: x - x is +0, a subnormal gap stays a nonzero subnormal, an
// overflow is an infinity of the right sign, and inf - inf or a NaN operand
// gives the canonical NaN (sign 0: no violation, as the compares give).
// So this file must not be built with --use_fast_math or -ftz: a
// subnormal operand flushed to zero would drop a violation.
//
// Bound on an H100 SXM: three issue slots per cell at 4 warp instructions
// per clock per SM.  At the forest shape (1024 queries x 131,072 interval
// rows x 64 dims = 8.6e9 cells) that is 2.6e10 lane slots /
// (128 x 132 SMs x 1.98 GHz) = 0.77 ms (two compares at 64 per clock per
// SM, the earlier basis, gave 1.03 ms); the operands and the bool output
// are 0.2 GB, 0.06 ms at 3.35 TB/s.  The design:
//
// * A block owns 128 queries x 64 interval rows and loops over D in stages
//   of 16 dims (q, lo and hi: 16 KB a stage) from a ring of 4 stages,
//   filled by cp.async while earlier stages are tested.  Each thread makes
//   canonical the 16-byte chunks it copied itself, once they have landed,
//   before the stage's barrier.  The query-block index runs fastest in the
//   grid, so each interval row comes from device memory once.
// * Stages keep the operands' row-major layout (64 bytes a row, 16-byte
//   chunks swizzled by row pair, so 8 consecutive rows read conflict-free).
//   Warp v owns 16 queries, all 64 rows; lane (g, r) of it the queries
//   16 v + 2 i + g, i = 0..7, and the rows r + 16 j, j = 0..3: per 4 dims
//   it holds its 8 queries' float4s and streams the rows' lo and hi
//   float4s, 16 16-byte loads for 384 issue slots.
// * 64 KB of shared memory and 128 registers (8 bytes spilled): two
//   blocks an SM.  The match bytes leave through the freed ring as 16-byte
//   stores.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMQ = 8, kMR = 4;              // queries, rows of a thread
constexpr int kMinBlocks = 2;                // blocks an SM (registers)
constexpr int kThreads = 256;
constexpr int kBlockM = 16 * kMQ;            // queries per block
constexpr int kBlockN = 16 * kMR;            // interval rows per block
constexpr int kBlockD = 16;                  // dims per stage
constexpr int kStages = 4;
constexpr int kQBytes = kBlockM * kBlockD * 4;
constexpr int kRBytes = kBlockN * kBlockD * 4;
constexpr int kStageBytes = kQBytes + 2 * kRBytes;       // q, lo, hi
constexpr int kChunks = kStageBytes / 16 / kThreads;     // a thread's copies
constexpr int kSmem = kStages * kStageBytes;
static_assert(kThreads == 256 && kBlockM % 64 == 0 && kBlockN % 64 == 0,
              "a thread's chunks: 64 rows apart, each within one operand");
static_assert(kBlockM * kBlockN <= kSmem, "the match tile fits the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (dims 4 c .. 4 c + 3) of tile row r.
__device__ __forceinline__ int chunk_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ float4 canonical(float4 x) {
  return make_float4(x.x + 0.0f, x.y + 0.0f, x.z + 0.0f, x.w + 0.0f);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
acam_match_kernel(const float* __restrict__ q, const float* __restrict__ lo,
                  const float* __restrict__ hi, unsigned char* __restrict__ out,
                  int M, int N, int D, int n_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n_mb = (M + kBlockM - 1) / kBlockM;
  const int m0 = (blockIdx.x % n_mb) * kBlockM;
  const int n0 = (blockIdx.x / n_mb) * kBlockN;
  const int nk = D / kBlockD;

  // a stage is q's kBlockM rows, then lo's and hi's kBlockN rows, 4 chunks
  // a row; this thread copies chunk tid % 4 of rows tid / 4 + 64 k.  Those
  // rows share a swizzle, so chunk k sits at cbase + 4096 k, and its
  // operand depends on k alone.  Rows past the operand copy nothing and
  // read as zero (no violation).
  const int cbase = chunk_off(tid / 4, tid % 4);
  auto load_stage = [&](int i) {
    if (i < nk) {
      const uint32_t dst = smem_u32(smem + (i % kStages) * kStageBytes) + cbase;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int r = 64 * k;                       // the rows' first, in the stage
        const bool is_q = r < kBlockM, is_lo = !is_q && r < kBlockM + kBlockN;
        const int row = tid / 4 + (is_q ? m0 + r : n0 + r - kBlockM - (is_lo ? 0 : kBlockN));
        const bool ok = row < (is_q ? M : N);
        const float* src = (is_q ? q : is_lo ? lo : hi) + size_t(ok ? row : 0) * D +
                           kBlockD * i + 4 * (tid % 4);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + 4096 * k),
                     "l"(src), "r"(ok ? 16 : 0)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 16, rr = lane % 16;
  unsigned bad[kMQ][kMR];
#pragma unroll
  for (int i = 0; i < kMQ; ++i)
#pragma unroll
    for (int j = 0; j < kMR; ++j) bad[i][j] = 0u;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_stage(i);
  for (int i = 0; i < nk; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    unsigned char* st = smem + (i % kStages) * kStageBytes;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      float4* x = reinterpret_cast<float4*>(st + cbase + 4096 * k);
      *x = canonical(*x);
    }
    __syncthreads();                 // stage i in; stage i - 1 done by all
    load_stage(i + kStages - 1);     // into stage i - 1's slot
    const unsigned char* ql = st;
    const unsigned char* lol = st + kQBytes;
    const unsigned char* hil = st + kQBytes + kRBytes;
#pragma unroll
    for (int c = 0; c < 4; ++c) {          // 4 dims at a time
      float4 a[kMQ];
#pragma unroll
      for (int ii = 0; ii < kMQ; ++ii)
        a[ii] = *reinterpret_cast<const float4*>(ql + chunk_off(2 * kMQ * warp + 2 * ii + g, c));
#pragma unroll
      for (int j = 0; j < kMR; ++j) {
        const int off = chunk_off(16 * j + rr, c);
        const float4 l = *reinterpret_cast<const float4*>(lol + off);
        const float4 h = *reinterpret_cast<const float4*>(hil + off);
#pragma unroll
        for (int ii = 0; ii < kMQ; ++ii) {
          const float4 v = a[ii];
          unsigned b = bad[ii][j];
          b |= __float_as_uint(v.x - l.x) | __float_as_uint(h.x - v.x);
          b |= __float_as_uint(v.y - l.y) | __float_as_uint(h.y - v.y);
          b |= __float_as_uint(v.z - l.z) | __float_as_uint(h.z - v.z);
          b |= __float_as_uint(v.w - l.w) | __float_as_uint(h.w - v.w);
          bad[ii][j] = b;
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                   // every stage read: the ring is free

  // match bytes into a kBlockM x kBlockN tile, then 16-byte stores of rows
#pragma unroll
  for (int ii = 0; ii < kMQ; ++ii)
#pragma unroll
    for (int j = 0; j < kMR; ++j) {
      const int col = 16 * j + rr;
      smem[(2 * kMQ * warp + 2 * ii + g) * kBlockN + col] =
          (n0 + col < n_valid && !(bad[ii][j] >> 31)) ? 1 : 0;
    }
  __syncthreads();
  const bool vec = (N & 15) == 0;
  constexpr int kRowChunks = kBlockN / 16;
#pragma unroll
  for (int k = 0; k < kBlockM * kRowChunks / kThreads; ++k) {
    const int idx = tid + kThreads * k;
    const int r = idx / kRowChunks, c = idx % kRowChunks;
    const int row = m0 + r, col = n0 + 16 * c;
    if (row >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(smem + r * kBlockN + 16 * c);
    unsigned char* dst = out + size_t(row) * N + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&v);
      for (int e = 0; e < 16 && col + e < N; ++e) dst[e] = bytes[e];
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
  static std::atomic<uint64_t> ready{0};     // the smem attribute, a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(acam_match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return int(err);
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  const long long tiles = (long long)((M + kBlockM - 1) / kBlockM) *
                          ((N + kBlockN - 1) / kBlockN);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  acam_match_kernel<<<unsigned(tiles), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      q, lo, hi, out, M, N, D, n_valid);
  return int(cudaGetLastError());
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
