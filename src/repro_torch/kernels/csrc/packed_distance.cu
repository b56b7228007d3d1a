// packed_distance: the (M, N) float32 matrix of popcount(q ^ p [& care])
// over packed lanes (sm_90a).  K1p.
//
// Replaces the products of the TPU kernel `fused_topk_packed_pallas`
// (src/repro/kernels/cam_search.py:304, `_packed_accumulate`) without its
// window top-k: the search route for k past the 384-row window
// (cam_search.topk_by_packed_distance) writes this matrix and selects
// from it with topk_select.cu.  Operands are 32-cell lanes (int32 bit
// patterns, LSB first): q (M, L), p and care (N, L), L a multiple of 8,
// N a multiple of 128.  Every entry is an exact integer, so the matrix is
// bit-identical to the reference whatever the blocking.
//
// Bound: the (M, N) float32 written, 0.134 ms at 624 x 180,000 on an
// H100 at 3.35 TB/s; the int8 products come second (0.116 ms at 1,979
// TOPS).  Both routes multiply on the int8 tensor cores: hamming =
// popc(p) + q . (1 - 2p) with q in {0, 1} and 1 - 2p in {-1, +1};
// ternary, popc((q ^ p) & c) = popc(p & c) + q . c(1 - 2p) with c(1 - 2p)
// in {-1, 0, +1}: wgmma.mma_async m64nNk32 .s32.s8.s8 accumulated in
// int32 (exact), both operands K-major in 128-byte swizzled shared memory
// (a K block is 4 lanes: 128 cells, one 128-byte atom row a matrix row).
// The row term popc(p [& c]) is counted while unpacking.
// cam_search.packed_distance_route picks the route and the grid.
//
// * "resident" / "streamed" (128-query tiles x 128-row gallery tiles):
//   warp-specialised and persistent, one block an SM walking a contiguous
//   run of tiles, query-tile-major.  Warpgroups 2 and 3 (setmaxnreg 56)
//   unpack every other K block each: a thread keeps its gallery row's
//   lanes in flight in a kRaw-deep cp.async ring (the next tile's rows
//   already on their way to L2 by a bulk prefetch), expands them into the
//   {-1, 0, +1} bytes in registers, stores them into a swizzled stage once
//   it is free, fences it to the async proxy and arrives on the
//   stage's mbarrier, once a warp (a ring of four stages, three for a
//   resident ternary tile).  Warpgroups 0 and 1 (setmaxnreg 200) each
//   multiply 64 of the tile's 128 query rows (m64n128k32 a K step) into
//   one of two int32 accumulator sets, in turns: while a tile's wgmma run
//   asynchronously, each stage also stores a slice of the last tile's set,
//   so the (M, N) write overlaps the products.  A slice goes through the
//   warp's 2 KB buffer in shared memory so that each store writes whole
//   128-byte rows (from the fragment a store covers 32-byte pieces of
//   eight rows).  The query tile is unpacked once a run ("resident", 128
//   x 32 L bytes: 128 KB at L = 32) between two named barriers of the
//   whole block; past L = 32 it streams with the gallery ("streamed").
// * "swapped" (up to 64 queries whose unpacked lanes fit): the gallery rows
//   take wgmma's 64-row M side and the queries its N side (8, 16, 32 or 64
//   columns, unpacked once and resident), so no product falls on more than
//   seven padding queries.  A block is one warpgroup, two or more blocks
//   an SM where they fit: it unpacks a 64-row tile four K blocks at a time
//   with every thread (the next three units' lanes in flight by cp.async),
//   multiplies it (m64nNk32) and stores its columns of the matrix from the
//   fragment.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "bf16_wgmma.cuh"   // mbarriers, wgmma fence / commit / wait, the TMA encoder

namespace {

using c4cam_bf16::allow_smem;
using c4cam_bf16::mbar_arrive;
using c4cam_bf16::mbar_init;
using c4cam_bf16::mbar_wait;
using c4cam_bf16::smem_u32;
using c4cam_bf16::wgmma_commit;
using c4cam_bf16::wgmma_fence;
using c4cam_bf16::wgmma_wait;

constexpr int kKB = 128;                 // unpacked bytes of a K block (4 lanes)
constexpr int kMaxSmem = 232448;
constexpr int kRouteResident = 0, kRouteStreamed = 1, kRouteSwapped = 2;

// tiles route
constexpr int kThreads = 512;            // warpgroups 0-1 multiply, 2-3 unpack
constexpr int kRaw = 3;                  // cp.async stages in flight a thread
constexpr int kRtSlots = 4;              // row terms of the last tiles
constexpr int kResidentLanes = 32;       // the widest resident 128-query tile
constexpr int kStgBytes = 2048;          // a consumer warp's store buffer: 16 x 32 float32

// swapped route
constexpr int kSwThreads = 128;
constexpr int kSwRows = 64;              // gallery rows a tile
constexpr int kSwKB = 4;                 // K blocks a unit
constexpr int kSwDepth = 4;              // units of lanes in flight
constexpr int kSwQBytes = 131072;        // the most unpacked queries

template <bool kCare, bool kResident>
struct TileGeo {
  static constexpr int kStages = kCare && kResident ? 3 : 4;   // the ring of gallery K blocks
  static constexpr int kStageBytes = 128 * kKB * (kResident ? 1 : 2);   // gallery (+ queries)
  static constexpr int kItems = (kCare ? 2 : 1) + (kResident ? 0 : 1);  // 16-byte loads a stage
  static constexpr int kRawBytes = 2 * kRaw * kItems * 128 * 16;       // per unpacking warpgroup
  // the ring, store buffers, resident queries (L / 4 K blocks of 128 rows),
  // raw ring, row terms (two halves a tile), barriers
  static constexpr int kFixed =
      kStages * kStageBytes + 8 * kStgBytes + kRawBytes + kRtSlots * 2 * 128 * 4 + 64;
  static size_t smem(int L) {
    return 1024 + size_t(kFixed) + (kResident ? size_t(128) * kKB * (L / 4) : 0);
  }
};

template <bool kCare>
struct SwapGeo {
  static constexpr int kItems = kCare ? 2 : 1;
  static constexpr int kABytes = kSwKB * kSwRows * kKB;                       // 32 KB
  static constexpr int kUnitBytes = kItems * kSwRows * 16 * kSwKB;           // a unit's lanes
  static constexpr int kRawBytes = kSwDepth * kUnitBytes;
  static size_t smem(int rows, int L) {
    return 1024 + size_t(rows) * kKB * (L / 4) + kABytes + kRawBytes + 2 * kSwRows * 4;
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// `bytes` (a multiple of 16, 16-byte aligned) of global memory into L2.
__device__ __forceinline__ void prefetch_l2(const void* src, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte swizzle atoms (8 rows
// x 128 bytes, 1024 bytes apart).
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(1) << 16 |
         uint64_t(1024 >> 4) << 32 | uint64_t(1) << 62;
}

// d (64 x N, int32) (+)= A B^T for int8 A (64 x 32) and B (N x 32) in
// shared memory, both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n8(int (&d)[4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 8) wgmma_s8_n8(d, da, db, scale_d);
  else if constexpr (N == 16) wgmma_s8_n16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_s8_n32(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_s8_n64(d, da, db, scale_d);
  else wgmma_s8_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t spread4(uint32_t x) {   // 4 bits -> 4 bytes
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Byte offset of 16-byte chunk c (0..7) of row r in a [rows][128 B]
// K block: the 128-byte swizzle.
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return uint32_t(r) * kKB + (uint32_t(c ^ (r & 7)) << 4);
}

// Query row r's K block (4 lanes) as {0, 1} bytes.
__device__ __forceinline__ void unpack_q(const int4& v, unsigned char* blk, int r) {
  const uint32_t w[4] = {uint32_t(v.x), uint32_t(v.y), uint32_t(v.z), uint32_t(v.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint4*>(blk + chunk_off(r, 2 * j + h)) =
          make_uint4(spread4(w[j] >> (16 * h)), spread4(w[j] >> (16 * h + 4)),
                     spread4(w[j] >> (16 * h + 8)), spread4(w[j] >> (16 * h + 12)));
}

// Lanes 2 h, 2 h + 1 of a gallery row's K block (p and care as int2) as
// their 4 16-byte chunks of 1 - 2p bytes (binary) or c(1 - 2p) (ternary),
// in registers; returns their row term popc(p [& c]).
template <bool kCare>
__device__ __forceinline__ int expand_g(const int2& pv, const int2& cv, uint4 (&w)[4]) {
  const uint32_t p[2] = {uint32_t(pv.x), uint32_t(pv.y)};
  const uint32_t c[2] = {uint32_t(cv.x), uint32_t(cv.y)};
  int rt = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t pc = kCare ? p[j] & c[j] : p[j];
    rt += __popc(pc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int s = 16 * h + 4 * n;
        b[n] = kCare ? spread4(c[j] >> s) | spread4(pc >> s) * 0xFEu
                     : spread4(pc >> s) * 0xFEu + 0x01010101u;
      }
      w[2 * j + h] = make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
  return rt;
}

// Chunks 4 h .. 4 h + 3 of row r of a K block.
__device__ __forceinline__ void store_half_row(const uint4 (&w)[4], unsigned char* blk, int r,
                                               int h) {
#pragma unroll
  for (int c = 0; c < 4; ++c) *reinterpret_cast<uint4*>(blk + chunk_off(r, 4 * h + c)) = w[c];
}

// Gallery row r's whole K block (4 lanes) as 1 - 2p or c(1 - 2p) bytes;
// returns its row term.
template <bool kCare>
__device__ __forceinline__ int unpack_g(const int4& pv, const int4& cv, unsigned char* blk,
                                        int r) {
  int rt = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 w[4];
    rt += expand_g<kCare>(h ? make_int2(pv.z, pv.w) : make_int2(pv.x, pv.y),
                          h ? make_int2(cv.z, cv.w) : make_int2(cv.x, cv.y), w);
    store_half_row(w, blk, r, h);
  }
  return rt;
}

// ---------------------------------------------------------------------------
// "resident" / "streamed": 128 queries x 128 gallery rows a tile
// ---------------------------------------------------------------------------

template <bool kCare, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
pd_tiles_kernel(const int* __restrict__ q, const int* __restrict__ p,
                const int* __restrict__ care, float* __restrict__ out, int M, int N, int L) {
  using G = TileGeo<kCare, kResident>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* const sp = smem_raw + (base - raw0);     // generic view of base
  const int S = L / 4;                                     // K blocks (stages) a tile
  const uint32_t s_stage = base;
  const uint32_t s_stg = s_stage + G::kStages * G::kStageBytes;          // store buffers
  const uint32_t s_q = s_stg + 8 * kStgBytes;                          // resident queries
  const uint32_t s_raw = s_q + (kResident ? uint32_t(128) * kKB * S : 0u);
  const uint32_t s_rt = s_raw + G::kRawBytes;                          // [kRtSlots][2][128]
  const uint32_t bars = s_rt + kRtSlots * 2 * 128 * 4;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (G::kStages + s)
  auto gen = [&](uint32_t a) { return sp + (a - base); };

  // this block's run of tiles [t0, t1) of n_qt x n_gt, query-tile-major;
  // tile t's K block kb is stage (t - t0) S + kb of the ring
  const int n_gt = N / 128;
  const long long T = (long long)((M + 127) / 128) * n_gt;
  const int t0 = int(T * blockIdx.x / gridDim.x);
  const int t1 = int(T * (blockIdx.x + 1) / gridDim.x);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(bars + 8 * s, 4);                    // an unpacking warpgroup's warps
      mbar_init(bars + 8 * (G::kStages + s), 8);        // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    // unpacking warpgroup u takes the K blocks kb with kb % 2 == u (S is
    // even); thread r of it owns gallery row r of each tile
    const int ut = threadIdx.x - 256, r = ut & 127, u = ut >> 7;
    // The raw lanes of the next own stage to issue (tile it, K block ikb):
    // this thread's gallery row (and care and, streamed, its query row), one
    // cp.async group a stage, into slot islot of its warpgroup's ring.
    int it = t0, ikb = u, islot = 0;
    size_t g_off = 0;
    int qrow = 0;
    auto rows_of = [&](int t) {
      g_off = size_t((t % n_gt) * 128 + r) * L;
      qrow = (t / n_gt) * 128 + r;
    };
    if (it < t1) rows_of(it);
    const uint32_t raw_u = s_raw + uint32_t(u) * kRaw * G::kItems * 2048 + r * 16;
    auto issue = [&]() {
      if (it < t1) {
        const uint32_t slot = raw_u + uint32_t(islot) * G::kItems * 2048;
        cp_async16(slot, p + g_off + 4 * ikb, true);
        if constexpr (kCare) cp_async16(slot + 2048, care + g_off + 4 * ikb, true);
        if constexpr (!kResident) {
          const bool in = qrow < M;
          cp_async16(slot + (G::kItems - 1) * 2048, q + size_t(in ? qrow : 0) * L + 4 * ikb,
                     in);
        }
        ikb += 2;
        if (ikb >= S) {
          ikb = u;
          if (++it < t1) rows_of(it);
        }
        islot = islot + 1 == kRaw ? 0 : islot + 1;
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kRaw - 1; ++i) issue();
    int cur_qt = -1, rslot = 0, rterm = 0;
    for (int t = t0; t < t1; ++t) {
      const int qt = t / n_gt;
      if (ut == 0 && t + 1 < t1) {      // the next tile's lanes into L2 (its rows are contiguous)
        const size_t g = size_t(((t + 1) % n_gt) * 128) * L;
        prefetch_l2(p + g, 128 * L * 4);
        if constexpr (kCare) prefetch_l2(care + g, 128 * L * 4);
        if (!kResident && (t + 1) / n_gt != qt)
          prefetch_l2(q + size_t((t + 1) / n_gt * 128) * L,
                      min(128, M - (t + 1) / n_gt * 128) * L * 4);
      }
      if (kResident && qt != cur_qt) {
        named_sync(1, kThreads);        // every product of the last query tile done
        // this thread's K blocks of query row r, two loads at a time
        const int row = qt * 128 + r;
        const bool in = row < M;
        for (int k0 = u; k0 < S; k0 += 4) {
          int4 v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            v[j] = in && k0 + 2 * j < S
                       ? __ldg(reinterpret_cast<const int4*>(q + size_t(row) * L) + k0 + 2 * j)
                       : make_int4(0, 0, 0, 0);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (k0 + 2 * j < S) unpack_q(v[j], gen(s_q + uint32_t(k0 + 2 * j) * 128 * kKB), r);
        }
        fence_async_smem();
        named_sync(2, kThreads);        // the query tile is in
        cur_qt = qt;
      }
      for (int kb = u; kb < S; kb += 2) {
        const int x = (t - t0) * S + kb;      // the ring's stage
        issue();
        cp_async_wait<kRaw - 1>();      // this thread's lanes of stage x are in
        const uint32_t rs = raw_u + uint32_t(rslot) * G::kItems * 2048;
        rslot = rslot + 1 == kRaw ? 0 : rslot + 1;
        const int4 pv = *reinterpret_cast<const int4*>(gen(rs));
        const int4 cv = kCare ? *reinterpret_cast<const int4*>(gen(rs + 2048))
                              : make_int4(-1, -1, -1, -1);
        uint4 wv[4];                          // half expanded before the slot is free
        rterm += expand_g<kCare>(make_int2(pv.x, pv.y), make_int2(cv.x, cv.y), wv);
        const int slot = x % G::kStages;
        mbar_wait(bars + 8 * (G::kStages + slot), ((x / G::kStages) & 1) ^ 1);
        unsigned char* st = gen(s_stage + uint32_t(slot) * G::kStageBytes);
        store_half_row(wv, st, r, 0);
        rterm += expand_g<kCare>(make_int2(pv.z, pv.w), make_int2(cv.z, cv.w), wv);
        store_half_row(wv, st, r, 1);
        if constexpr (!kResident)
          unpack_q(*reinterpret_cast<const int4*>(gen(rs + (G::kItems - 1) * 2048)),
                   st + 128 * kKB, r);
        if (kb >= S - 2) {                    // the tile's row terms, by warpgroup
          reinterpret_cast<int*>(gen(s_rt))[((t - t0) % kRtSlots) * 256 + ut] = rterm;
          rterm = 0;
        }
        fence_async_smem();
        __syncwarp();
        if ((ut & 31) == 0) mbar_arrive(bars + 8 * slot);   // one arrival a warp
      }
    }
    cp_async_wait<0>();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
    // Warpgroup wg multiplies query rows 64 wg .. 64 wg + 63 of each tile
    // into one of two accumulator sets, in turns; the other set, the last
    // tile's, is stored a slice each stage while the products run.
    int acc_a[64], acc_b[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_a[i] = acc_b[i] = 0;
    int cur_qt = -1, x = 0;
    int pm = -1, prt = 0;                    // the stored tile: rows pm, pm + 8; row terms
    size_t pcol0 = 0;
    const int* const rt_base = reinterpret_cast<const int*>(gen(s_rt));
    // The stored tile's 32-column boxes c with c * parts / 4 == part: each
    // goes through the warp's buffer (16-byte chunks swizzled by row) so
    // that every store writes four whole 128-byte rows.
    unsigned char* const stg = gen(s_stg + uint32_t(threadIdx.x / 32) * kStgBytes);
    auto store_part = [&](const int (&acc)[64], int part, int parts) {
      const int* rt = rt_base + prt * 256;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c * parts / 4 != part) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * c + jj, col = 8 * j + 2 * t4;
          const int2 a = *reinterpret_cast<const int2*>(rt + col);
          const int2 b = *reinterpret_cast<const int2*>(rt + 128 + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = g8 + 8 * h;
            *reinterpret_cast<float2*>(stg + row * 128 +
                                       (((2 * jj + (t4 >> 1)) ^ (row & 7)) << 4) + (t4 & 1) * 8) =
                make_float2(float(acc[4 * j + 2 * h] + a.x + b.x),
                            float(acc[4 * j + 2 * h + 1] + a.y + b.y));
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {          // rows 4 i + lane / 8, 16 bytes a lane
          const int row = 4 * i + lane / 8, ch = lane % 8;
          const float4 v =
              *reinterpret_cast<const float4*>(stg + row * 128 + ((ch ^ (row & 7)) << 4));
          if (pm - g8 + row < M)
            *reinterpret_cast<float4*>(out + size_t(pm - g8 + row) * N + pcol0 + 32 * c +
                                       4 * ch) = v;
        }
        __syncwarp();
      }
    };
    auto tile = [&](int (&acc)[64], const int (&prev)[64], int t) {
      const int qt = t / n_gt;
      if (kResident && qt != cur_qt) {
        named_sync(1, kThreads);
        named_sync(2, kThreads);
        cur_qt = qt;
      }
      const bool live = qt * 128 + 64 * wg < M;   // this warpgroup's rows hold a query
      int prev_slot = -1;
      for (int kb = 0; kb < S; ++kb, ++x) {
        const int slot = x % G::kStages;
        mbar_wait(bars + 8 * slot, (x / G::kStages) & 1);
        if (live) {
          const uint32_t st = s_stage + uint32_t(slot) * G::kStageBytes;
          const uint32_t qb =
              (kResident ? s_q + uint32_t(kb) * 128 * kKB : st + 128 * kKB) + wg * 64 * kKB;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_s8<128>(acc, desc128(qb + 32 * kk), desc128(st + 32 * kk), kb | kk);
          wgmma_commit();
        }
        if (pm >= 0) store_part(prev, kb, S);   // the last tile, while these products run
        wgmma_wait<1>();                        // the previous stage's products
        if (prev_slot >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (G::kStages + prev_slot));
        }
        prev_slot = slot;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (G::kStages + prev_slot));
      pm = live ? qt * 128 + 64 * wg + 16 * warp + g8 : -1;
      pcol0 = size_t(t % n_gt) * 128;
      prt = (t - t0) % kRtSlots;
    };
    int t = t0;
    for (; t + 1 < t1; t += 2) {
      tile(acc_a, acc_b, t);
      tile(acc_b, acc_a, t + 1);
    }
    if (t < t1) tile(acc_a, acc_b, t);
    // the run's last tile
    if (pm >= 0) {
      if ((t1 - t0) & 1) store_part(acc_a, 0, 1);
      else store_part(acc_b, 0, 1);
    }
  }
}

// ---------------------------------------------------------------------------
// "swapped": 64 gallery rows x the queries a tile, one warpgroup a block
// ---------------------------------------------------------------------------

template <bool kCare, int kQ>
__global__ void __launch_bounds__(kSwThreads)
pd_swapped_kernel(const int* __restrict__ q, const int* __restrict__ p,
                  const int* __restrict__ care, float* __restrict__ out, int M, int N,
                  int L) {
  using G = SwapGeo<kCare>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* const sp = smem_raw + (base - raw0);
  const int S = L / 4;                                     // K blocks
  const int n_kc = (S + kSwKB - 1) / kSwKB;                // units a tile
  const uint32_t s_a = base;                                // [kSwKB][64][128 B]
  const uint32_t s_q = s_a + G::kABytes;                    // [S][kQ][128 B]
  const uint32_t s_raw = s_q + uint32_t(kQ) * kKB * S;      // [kSwDepth][items][64][64 B]
  int* const rt_s = reinterpret_cast<int*>(sp + (s_raw + G::kRawBytes - base));  // [2][64]
  auto gen = [&](uint32_t a) { return sp + (a - base); };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;

  const int T = N / kSwRows;
  const int t0 = int((long long)T * blockIdx.x / gridDim.x);
  const int t1 = int((long long)T * (blockIdx.x + 1) / gridDim.x);
  const int U = (t1 - t0) * n_kc;                           // this block's units

  // raw lanes of unit u (tile t0 + u / n_kc, K blocks 4 kc ..): row r's
  // 16-byte piece c at (c ^ ((r / 2) % 4)), 64 bytes a row
  auto issue = [&](int u) {
    if (u < U) {
      const int n0 = (t0 + u / n_kc) * kSwRows, kc = u % n_kc;
      const uint32_t buf = s_raw + uint32_t(u % kSwDepth) * G::kUnitBytes;
#pragma unroll
      for (int i = 0; i < kSwKB * kSwRows / kSwThreads; ++i) {
        const int e = tid + kSwThreads * i, r = e % kSwRows, c = e / kSwRows;
        const int kb = kSwKB * kc + c;
        const bool in = kb < S;
        const size_t off = size_t(n0 + r) * L + 4 * (in ? kb : 0);
        const uint32_t dst = buf + uint32_t(r) * 64 + (uint32_t(c ^ ((r >> 1) & 3)) << 4);
        cp_async16(dst, p + off, in);
        if constexpr (kCare) cp_async16(dst + kSwRows * 64, care + off, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < kSwDepth - 1; ++u) issue(u);
  // the queries, unpacked once: (row, K block) e over kQ x S
  for (int e = tid; e < kQ * S; e += kSwThreads) {
    const int r = e % kQ, kb = e / kQ;
    const int4 v = r < M ? __ldg(reinterpret_cast<const int4*>(q + size_t(r) * L) + kb)
                         : make_int4(0, 0, 0, 0);
    unpack_q(v, gen(s_q + uint32_t(kb) * kQ * kKB), r);
  }
  int acc[kQ / 2];
#pragma unroll
  for (int i = 0; i < kQ / 2; ++i) acc[i] = 0;
  int rterm = 0;                                            // gallery row tid % 64
  for (int u = 0; u < U; ++u) {
    const int kc = u % n_kc, n0 = (t0 + u / n_kc) * kSwRows;
    issue(u + kSwDepth - 1);
    cp_async_wait<kSwDepth - 1>();
    __syncthreads();                      // unit u's lanes are in; the last products done
    const uint32_t buf = s_raw + uint32_t(u % kSwDepth) * G::kUnitBytes;
    const int r = tid % kSwRows;
#pragma unroll
    for (int i = 0; i < kSwKB * kSwRows / kSwThreads; ++i) {
      const int c = tid / kSwRows + (kSwThreads / kSwRows) * i;
      if (kSwKB * kc + c >= S) continue;
      const uint32_t src = buf + uint32_t(r) * 64 + (uint32_t(c ^ ((r >> 1) & 3)) << 4);
      const int4 pv = *reinterpret_cast<const int4*>(gen(src));
      const int4 cv = kCare ? *reinterpret_cast<const int4*>(gen(src + kSwRows * 64))
                            : make_int4(-1, -1, -1, -1);
      rterm += unpack_g<kCare>(pv, cv, gen(s_a + uint32_t(c) * kSwRows * kKB), r);
    }
    fence_async_smem();
    __syncthreads();                      // the unit is unpacked
    wgmma_fence();
    const int nkb = min(kSwKB, S - kSwKB * kc);
    for (int c = 0; c < nkb; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_s8<kQ>(acc, desc128(s_a + uint32_t(c) * kSwRows * kKB + 32 * kk),
                     desc128(s_q + uint32_t(kSwKB * kc + c) * kQ * kKB + 32 * kk),
                     kc | c | kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (kc == n_kc - 1) {                 // the tile's last unit: store it
      rt_s[(tid / kSwRows) * kSwRows + r] = rterm;
      rterm = 0;
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g8 + 8 * h;
        const int rth = rt_s[row] + rt_s[kSwRows + row];
#pragma unroll
        for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 8 * j + 2 * t4 + e;
            if (m < M) out[size_t(m) * N + n0 + row] = float(acc[4 * j + 2 * h + e] + rth);
          }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <bool kCare, bool kResident>
int launch_tiles(const int* q, const int* p, const int* care, float* out, int M, int N,
                 int L, int grid, cudaStream_t s) {
  auto kernel = pd_tiles_kernel<kCare, kResident>;
  const size_t smem = TileGeo<kCare, kResident>::smem(L);
  if (smem > size_t(kMaxSmem) || (long long)((M + 127) / 128) * (N / 128) < grid)
    return int(cudaErrorInvalidValue);
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(kernel, kMaxSmem, done);
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kThreads, smem, s>>>(q, p, care, out, M, N, L);
  return int(cudaGetLastError());
}

template <bool kCare, int kQ>
int launch_swapped(const int* q, const int* p, const int* care, float* out, int M, int N,
                   int L, int grid, cudaStream_t s) {
  auto kernel = pd_swapped_kernel<kCare, kQ>;
  const size_t smem = SwapGeo<kCare>::smem(kQ, L);
  if (smem > size_t(kMaxSmem) || N / kSwRows < grid) return int(cudaErrorInvalidValue);
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(kernel, kMaxSmem, done);
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kSwThreads, smem, s>>>(q, p, care, out, M, N, L);
  return int(cudaGetLastError());
}

template <bool kCare>
int launch_route(const int* q, const int* p, const int* care, float* out, int M, int N,
                 int L, int route, int grid, cudaStream_t s) {
  if (route == kRouteResident) {
    if (L > kResidentLanes) return int(cudaErrorInvalidValue);
    return launch_tiles<kCare, true>(q, p, care, out, M, N, L, grid, s);
  }
  if (route == kRouteStreamed) return launch_tiles<kCare, false>(q, p, care, out, M, N, L, grid, s);
  if (route != kRouteSwapped || M > 64) return int(cudaErrorInvalidValue);
  const int rows = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
  if ((long long)rows * 32 * L > kSwQBytes) return int(cudaErrorInvalidValue);
  switch (rows) {
    case 8: return launch_swapped<kCare, 8>(q, p, care, out, M, N, L, grid, s);
    case 16: return launch_swapped<kCare, 16>(q, p, care, out, M, N, L, grid, s);
    case 32: return launch_swapped<kCare, 32>(q, p, care, out, M, N, L, grid, s);
    default: return launch_swapped<kCare, 64>(q, p, care, out, M, N, L, grid, s);
  }
}

}  // namespace

// The (M, N) float32 distance matrix, popcount(q ^ p [& care]) per (query,
// row): q (M, L), p (N, L) int32 lanes, 16-byte aligned, L a multiple of 8,
// N a multiple of 128; care (N, L) or nullptr.  route: 0 "resident" (L at
// most 32), 1 "streamed", 2 "swapped" (M at most 64); grid: the persistent
// blocks (cam_search.packed_distance_route), at most the route's tiles.
// Returns a cudaError_t code.
extern "C" int c4cam_packed_distance(const int* q, const int* p, const int* care,
                                     float* out, int M, int N, int L, int route, int grid,
                                     void* stream) {
  if (M <= 0 || N <= 0 || L <= 0 || N % 128 || L % 8 || grid <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (care == nullptr)
    return launch_route<false>(q, p, nullptr, out, M, N, L, route, grid, s);
  return launch_route<true>(q, p, care, out, M, N, L, route, grid, s);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
