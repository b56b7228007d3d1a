// The 3xTF32 tensor-core product of the float CAM kernels (sm_90a): one
// 128-query x 128-row tile of  q.p  plus the norms  sum f(q), sum f(p),
// shared by range_match.cu (B4, threshold compare) and fused_topk.cu (B2,
// block top-k), which differ only in their epilogues.
//
// * 3xTF32.  Each float32 operand x splits into hi = tf32(x), rounded to
//   nearest (cvt.rna, not the truncation wgmma applies to raw float32
//   bits), and lo = tf32(x - hi); the float32 wgmma accumulator takes
//   lo.hi + hi.lo + hi.hi per k-step (wgmma.m64n128k8.f32.tf32.tf32, both
//   operands K-major).  lo.lo (about 2^-22 of a product) is dropped.  On
//   {0,1} and +-1 cells lo is 0 and every partial sum is an integer below
//   2^24, so hamming, bipolar hamming and dot there are exact.
// * A pipeline.  One producer warp keeps a ring of 4 K-stages (32 floats
//   of q and p each, 128-byte swizzled) in flight by TMA, an mbarrier per
//   stage for "full" and one for "empty".  Two consumer warpgroups of 64
//   query rows split their q fragments into hi/lo in registers (the wgmma
//   A operand) and convert the staged p tile in place to hi plus a lo
//   copy, each warpgroup half of the rows, once per stage (the stores
//   fenced to the async proxy that wgmma and TMA use): stage i + 1 is
//   converted and its q fragments split (two register sets, taken in
//   turns) while stage i's products run on the tensor cores.
// * Norms.  sum f(q) and sum f(p) are taken in float32 on the CUDA cores,
//   in the same order for every tile, from the staged float32 values.
//
// A kernel built on it launches kThreads threads with kSmem bytes of
// dynamic shared memory, calls `product_tile`, and returns at once if that
// returns false (the producer warp).  The consumer threads then hold the
// 64-float accumulator fragment of their warpgroup's 64 x 128 block: thread
// (warpgroup w, warp v, lane 4 g + t) owns rows r0 = 64 w + 16 v + g and
// r0 + 8, columns 8 j + 2 t + e; acc[4 j + 2 h + e] is (row r0 + 8 h,
// column 8 j + 2 t + e).  The row norms are in qn_s[128] and the column
// norms in pn_s[256] (two halves: pn_s[c] + pn_s[128 + c]), and the ring's
// stages are free.
#pragma once

#include <cuda.h>          // CUtensorMap; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace c4cam_tf32 {

constexpr int kBlockM = 128;                 // two consumer warpgroups of 64
constexpr int kBlockN = 128;                 // gallery rows per tile
constexpr int kBlockK = 32;                  // floats per stage (128 bytes)
constexpr int kStages = 4;
constexpr int kThreads = 288;                // warpgroups 0-1 consume, warp 8 loads
constexpr int kTileBytes = 128 * kBlockK * 4;            // 16 KB
constexpr int kStageBytes = 3 * kTileBytes;              // q, p (hi), p lo
// stages, 1 KB of alignment slack, barriers, norms
constexpr size_t kSmem = size_t(kStages) * kStageBytes + 1024 + 128 + 4 * 128 * 4;
constexpr uint32_t kTf32Mask = 0xFFFFE000u;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to nearest (ties away) to tf32, the low 13 bits cleared.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & kTf32Mask);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One [128 rows][32 floats] box of a 2-D tensor map (coordinates innermost
// first) into shared memory; completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma descriptor of a K-major tile in 128-byte swizzle atoms (8 rows x
// 128 bytes, 1024 bytes apart).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(1) << 16 |
         uint64_t(1024 >> 4) << 32 | uint64_t(1) << 62;
}

// d (64 x 128, float32) += A B^T: tf32 A (64 x 8) in registers (the
// m16n8k8 fragment of each warp's 16 rows: (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)) and B (128 x 8) in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// kMetric: 0 = hamming (f(x) = x), 1 = eucl (f(x) = x * x), 2 = dot (no
// norms).
template <int kMetric>
__device__ __forceinline__ float term(float x) {
  return kMetric == 1 ? x * x : x;
}

// Rewrite this warpgroup's 64 rows of a staged p tile in place as tf32 hi
// and write lo beside it; add f(p) of the row's 16 floats to `pn`, in
// column order.  Thread c owns row 64 w + c % 64, columns 16 (c / 64) ...
// The stores are ordinary (generic proxy) ones; wgmma reads the tiles and
// TMA later overwrites them through the async proxy, so each thread fences
// its stores to that proxy before the barrier that hands the tile on.
template <int kMetric>
__device__ __forceinline__ void convert_p(unsigned char* p_tile, unsigned char* lo_tile,
                                          int w, int ctid, float& pn) {
  const int r = 64 * w + (ctid & 63);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * (ctid >> 6) + i;                // logical 16-byte chunk
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    float4 x = *reinterpret_cast<float4*>(p_tile + off);
    float4 hi, lo;
    hi.x = tf32_round(x.x); lo.x = tf32_round(x.x - hi.x);
    hi.y = tf32_round(x.y); lo.y = tf32_round(x.y - hi.y);
    hi.z = tf32_round(x.z); lo.z = tf32_round(x.z - hi.z);
    hi.w = tf32_round(x.w); lo.w = tf32_round(x.w - hi.w);
    *reinterpret_cast<float4*>(p_tile + off) = hi;
    *reinterpret_cast<float4*>(lo_tile + off) = lo;
    if constexpr (kMetric != 2) {
      pn += term<kMetric>(x.x);
      pn += term<kMetric>(x.y);
      pn += term<kMetric>(x.z);
      pn += term<kMetric>(x.w);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 x 128 tile (m0, n0) of q.p into `acc` (see the header).  `smem`
// is the 1024-aligned dynamic shared memory.  Returns false in the
// producer warp, whose threads must return without touching the named
// barriers 1.. of the consumers.
template <int kMetric>
__device__ __forceinline__ bool product_tile(const CUtensorMap* tq, const CUtensorMap* tp,
                                             int D, int m0, int n0, unsigned char* smem,
                                             float (&acc)[64]) {
  constexpr bool kNorms = kMetric != 2;
  const uint32_t base = smem_u32(smem);
  // stage s: q at s * kStageBytes, p (hi) + kTileBytes, p lo + 2 kTileBytes
  const uint32_t bars = base + kStages * kStageBytes;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s)
  float* norm_s = reinterpret_cast<float*>(smem + kStages * kStageBytes + 128);
  float* qn_s = norm_s;                 // [128]
  float* pn_s = norm_s + 128;           // [2][128]: the two column halves
  const int nk = (D + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread starts every TMA load ----
    if (threadIdx.x == 256) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % kStages;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (kStages + st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * kTileBytes);
        const uint32_t sq = base + st * kStageBytes;
        tma_load_2d(sq, tq, full, i * kBlockK, m0);
        tma_load_2d(sq + kTileBytes, tp, full, i * kBlockK, n0);
      }
    }
    return false;
  }

  // ---- consumers: warpgroup w owns query rows 64 w .. 64 w + 63 ----
  const int w = threadIdx.x / 128, ctid = threadIdx.x % 128;
  const int warp = ctid / 32, lane = ctid % 32;
  const int t = lane % 4;
  const int r0 = 64 * w + 16 * warp + lane / 4;      // rows r0, r0 + 8

#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float qn0 = 0.f, qn1 = 0.f, pn = 0.f;

  // A fragments of a stage's 4 k-steps from the raw q tile, split into
  // tf32 hi / lo; the q norms take the same values
  auto load_a = [&](int st, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const unsigned char* sq = smem + st * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 8 * (j & 1);
        const int k = 8 * kk + t + 4 * (j >> 1);
        const float x = *reinterpret_cast<const float*>(
            sq + r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4);
        const float hi = tf32_round(x);
        ah[kk][j] = __float_as_uint(hi);
        al[kk][j] = __float_as_uint(tf32_round(x - hi));
        if constexpr (kNorms) {
          if (j & 1) qn1 += term<kMetric>(x); else qn0 += term<kMetric>(x);
        }
      }
    }
  };
  // Stage i: start its products (fragments `ch` / `cl`), then, while they
  // run, convert stage i + 1's p and split its q into `nh` / `nl`.
  auto step = [&](int i, uint32_t (&ch)[4][4], uint32_t (&cl)[4][4],
                  uint32_t (&nh)[4][4], uint32_t (&nl)[4][4]) {
    const int st = i % kStages;
    const uint32_t pb = base + st * kStageBytes + kTileBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dhi = desc(pb + 32 * kk);
      const uint64_t dlo = desc(pb + kTileBytes + 32 * kk);
      wgmma_tf32(acc, cl[kk], dhi);
      wgmma_tf32(acc, ch[kk], dlo);
      wgmma_tf32(acc, ch[kk], dhi);
    }
    wgmma_commit();
    if (i + 1 < nk) {
      const int nx = (i + 1) % kStages;
      mbar_wait(bars + 8 * nx, ((i + 1) / kStages) & 1);
      convert_p<kMetric>(smem + nx * kStageBytes + kTileBytes,
                         smem + nx * kStageBytes + 2 * kTileBytes, w, ctid, pn);
      load_a(nx, nh, nl);
    }
    wgmma_wait0();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)     // keep the A registers live to here
      asm volatile("" ::"r"(ch[kk][0]), "r"(ch[kk][1]), "r"(ch[kk][2]),
                   "r"(ch[kk][3]), "r"(cl[kk][0]), "r"(cl[kk][1]),
                   "r"(cl[kk][2]), "r"(cl[kk][3]));
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));
    // both warpgroups have converted stage i + 1 and finished stage i
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  };

  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  mbar_wait(bars, 0);
  convert_p<kMetric>(smem + kTileBytes, smem + 2 * kTileBytes, w, ctid, pn);
  load_a(0, ah0, al0);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int i = 0; i < nk; i += 2) {   // two register sets, taken in turns
    step(i, ah0, al0, ah1, al1);
    if (i + 1 < nk) step(i + 1, ah1, al1, ah0, al0);
  }

  if constexpr (kNorms) {
    // q norms: the four threads of a quad hold columns t, t + 4 of each
    // k-step; add them in a fixed order
    qn0 += __shfl_xor_sync(0xffffffffu, qn0, 1);
    qn1 += __shfl_xor_sync(0xffffffffu, qn1, 1);
    qn0 += __shfl_xor_sync(0xffffffffu, qn0, 2);
    qn1 += __shfl_xor_sync(0xffffffffu, qn1, 2);
    pn_s[128 * (ctid >> 6) + 64 * w + (ctid & 63)] = pn;
    if (t == 0) {
      qn_s[r0] = qn0;
      qn_s[r0 + 8] = qn1;
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");   // norms in, stages free
  return true;
}

// The 1024-aligned start of the dynamic shared memory.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}
// The row and column norms `product_tile` left in shared memory.
__device__ __forceinline__ const float* row_norms(const unsigned char* smem) {
  return reinterpret_cast<const float*>(smem + kStages * kStageBytes + 128);
}
__device__ __forceinline__ const float* col_norms(const unsigned char* smem) {
  return row_norms(smem) + 128;
}

// cuTensorMapEncodeTiled, looked up in libcuda at first use (no -lcuda link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of a row-major (rows, D) float32 matrix in boxes of
// [128 rows][32 floats], 128-byte swizzle; reads past either edge are 0.
inline bool encode(CUtensorMap* map, const float* ptr, int rows, int D) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(rows)};
  cuuint64_t strides[1] = {cuuint64_t(D) * 4};
  cuuint32_t box[2] = {cuuint32_t(kBlockK), 128};
  cuuint32_t estride[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Allows `kernel` kSmem bytes of dynamic shared memory on the current
// device, once per device (`ready` holds a bit per device).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(kSmem));
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace c4cam_tf32
