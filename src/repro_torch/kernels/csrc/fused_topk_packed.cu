// fused_topk_packed: hamming over packed lanes + window top-k (sm_90a).
//
// Replaces the TPU kernel `fused_topk_packed_pallas`
// (src/repro/kernels/cam_search.py:304, bodies `_packed_kernel`,
// `_packed_ternary_kernel`, `_packed_accumulate`, `_extract_block_topk`).
// Operands are 32-cell lanes (int32 bit patterns, LSB first): the distance
// is popcount(q ^ p) for binary cells and popcount((q ^ p) & care) for TCAM
// ternary cells — integers, so the candidates are bit-identical to the
// reference whatever the blocking.  Output: each window of `window` gallery
// rows gives its k best (value, global row) candidates, largest key first
// (key = value, or -value for smallest), lowest index on equal keys; rows at
// or past `n_valid` lose with value -/+3e38 and their own index.
//
// Two routes; the wrapper picks one from the shape (cam_search.packed_route):
//
// * "mma" (window 128 and at least one block per SM, e.g. the KNN shape,
//   1024-query chunk x 180,096 rows x 32 lanes).  The bound there is the
//   int8 tensor cores: hamming = popc(p) + q . (1 - 2p) with q in {0, 1}
//   and 1 - 2p in {-1, +1}; ternary, popc((q ^ p) & c) = popc(p & c) +
//   q . c(1 - 2p) with c(1 - 2p) in {-1, 0, +1}: one int8 product each,
//   2 * M * N * 32 L operations at 1,979 TOPS (0.19 ms at the KNN shape,
//   where the popcount pipe's 16 per clock per SM gave 1.41 ms).  A block
//   owns 128 queries x one 128-row window; the lanes stay packed in device
//   memory (the gallery stays at 23 MB), reach shared memory 32 lanes of
//   every row at once by cp.async, and are unpacked 8 lanes (256 cells) at
//   a time into int8 tiles (16-byte chunks swizzled by row), which 8 warps
//   of 32 x 64 read with ldmatrix into
//   mma.sync m16n8k32 s8 products accumulated in int32 (exact).  The row
//   term popc(p [& c]) is counted once per tile while unpacking.  The query
//   block runs fastest in the grid, so the 8 blocks of a window read it
//   from L2.  A warp whose 64 columns lie at or past n_valid skips its
//   products.
// * "rows" (every other shape, e.g. the HDC predict shape: 1024 queries x
//   256 lanes x one 128-row window of 10 classes, where the mma grid would
//   be 8 blocks on 132 SMs).  One warp per (query, window): the lanes are
//   spread over the warp, popc(q ^ p [& c]) summed with one warp reduction
//   per gallery row, and only rows below n_valid are computed: padding rows
//   write their losing key and cost nothing else.  The grid is M / 8
//   blocks per window, 128 at the HDC shape.
//
// (The search route past a 384-row window writes the (M, N) distance
// matrix of the same lanes with packed_distance.cu and selects from it.)
//
// The window top-k, both routes: each (query, window column) becomes one
// unique 32-bit key, rank << 9 | column (rank = distance, or 32 L -
// distance for largest; 32 L + 1 for padding), so the smallest keys are the
// answer in the reference's order.  A warp selects a row (two at once on
// the "mma" route, to hide latency): each lane sorts its window / 32 keys in
// registers, then each of k rounds takes the warp minimum of the lanes'
// heads in one redux.sync and the owning lane pops its head (a register
// shift); lane t keeps the t-th result and the lanes write their results
// together.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kColBits = 9;                 // window columns < 512
constexpr float kNegBig = -3.0e38f;
constexpr float kPosBig = 3.0e38f;

// ---------------------------------------------------------------------------
// selection
// ---------------------------------------------------------------------------

struct Row {
  float* ov;          // this (query, window)'s k output slots
  int* oi;
  int wbase;          // global row of window column 0
  int n_valid;
  int largest;
  int maxd;           // 32 * lanes, the largest distance
};

__device__ __forceinline__ uint32_t make_key(int d, int col, int gidx, const Row& r) {
  const uint32_t rank = gidx < r.n_valid ? uint32_t(r.largest ? r.maxd - d : d)
                                         : uint32_t(r.maxd + 1);
  return rank << kColBits | uint32_t(col);
}

__device__ __forceinline__ void write_key(uint32_t key, int slot, const Row& r) {
  const int col = int(key & ((1u << kColBits) - 1));
  const int g = r.wbase + col;
  const int rank = int(key >> kColBits);
  float v;
  if (g < r.n_valid) v = float(r.largest ? r.maxd - rank : rank);
  else v = r.largest ? kNegBig : kPosBig;
  r.ov[slot] = v;
  r.oi[slot] = g;
}

// The k smallest of each of R rows' window = 32 N keys (`keys[i]`, any
// order), in ascending order, written by the warp; the R rows' rounds are
// interleaved to hide the reductions' latency.  A row without `ov` is
// selected but not written.
template <int N, int R>
__device__ __forceinline__ void select_rows(const uint32_t* const (&keys)[R], int k,
                                            const Row (&r)[R], int lane) {
  uint32_t v[R][N];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(keys[j] + lane * N + i);
      v[j][i] = x.x; v[j][i + 1] = x.y; v[j][i + 2] = x.z; v[j][i + 3] = x.w;
    }
#pragma unroll
    for (int pass = 0; pass < N; ++pass)         // odd-even transposition sort
#pragma unroll
      for (int i = pass & 1; i + 1 < N; i += 2) {
        const uint32_t a = min(v[j][i], v[j][i + 1]), b = max(v[j][i], v[j][i + 1]);
        v[j][i] = a;
        v[j][i + 1] = b;
      }
  }
  uint32_t mine[R];
  for (int t = 0; t < k; ++t) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t m = __reduce_min_sync(0xffffffffu, v[j][0]);
      if (v[j][0] == m) {                        // keys are unique: one lane
#pragma unroll
        for (int i = 0; i + 1 < N; ++i) v[j][i] = v[j][i + 1];
        v[j][N - 1] = 0xffffffffu;
      }
      if ((t & 31) == lane) mine[j] = m;
    }
    if ((t & 31) == 31 || t == k - 1) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (r[j].ov && lane <= (t & 31)) write_key(mine[j], (t & ~31) + lane, r[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// route "rows": a warp per (query, window)
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;

template <bool kCare, int N>
__global__ void __launch_bounds__(32 * kRowWarps)
packed_rows_kernel(const int* __restrict__ q, const int* __restrict__ p,
                   const int* __restrict__ care, float* __restrict__ out_v,
                   int* __restrict__ out_i, int M, int L, int k, int n_windows,
                   int n_valid, int largest) {
  constexpr int W = 32 * N;
  __shared__ __align__(16) uint32_t keys_s[kRowWarps][W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * kRowWarps + warp;
  if (m >= M) return;                               // warp-uniform
  const int w = blockIdx.y;
  Row r;
  const size_t ld = size_t(n_windows) * k;
  r.ov = out_v + size_t(m) * ld + size_t(w) * k;
  r.oi = out_i + size_t(m) * ld + size_t(w) * k;
  r.wbase = w * W;
  r.n_valid = n_valid;
  r.largest = largest;
  r.maxd = 32 * L;
  uint32_t* keys = keys_s[warp];
#pragma unroll
  for (int j = lane; j < W; j += 32) keys[j] = make_key(0, j, n_valid, r);
  __syncwarp();
  const int* qr = q + size_t(m) * L;
  const int live = min(W, n_valid - r.wbase);       // rows below n_valid
  for (int j = 0; j < live; ++j) {
    const size_t off = size_t(r.wbase + j) * L;
    int part = 0;
    for (int l = lane; l < L; l += 32) {
      int x = __ldg(qr + l) ^ __ldg(p + off + l);
      if constexpr (kCare) x &= __ldg(care + off + l);
      part += __popc(x);
    }
    const int d = int(__reduce_add_sync(0xffffffffu, unsigned(part)));
    if (lane == 0) keys[j] = make_key(d, j, r.wbase + j, r);
  }
  __syncwarp();
  const uint32_t* const rows_keys[1] = {keys};
  const Row rows[1] = {r};
  select_rows<N, 1>(rows_keys, k, rows, lane);
}

// ---------------------------------------------------------------------------
// route "mma": int8 tensor cores, 128 queries x one 128-row window a block
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;
constexpr int kChunkLanes = 8;                    // 256 cells per unpack step
constexpr int kRowBytes = 32 * kChunkLanes;       // one unpacked row of a chunk
constexpr int kTileBytes = 128 * kRowBytes;       // 32 KB
constexpr int kStageLanes = 32;                   // lanes staged packed at once
constexpr int kPackedBytes = 128 * kStageLanes * 4;   // 16 KB an operand
// unpacked A and B tiles (the keys reuse them: 128 x 128 x 4 bytes), the
// two halves' row terms, then the packed q, p (and care) tiles
constexpr size_t mma_smem(bool care) {
  return 2 * size_t(kTileBytes) + 2 * 128 * 4 + (care ? 3 : 2) * size_t(kPackedBytes);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t spread4(uint32_t x) {   // 4 bits -> 4 bytes
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `c` (0..15) of row `row` in an unpacked tile.
__device__ __forceinline__ int tile_off(int row, int c) {
  return row * kRowBytes + ((c ^ (row & 7)) << 4);
}

template <bool kCare>
__global__ void __launch_bounds__(kMmaThreads, 2)
packed_mma_kernel(const int* __restrict__ q, const int* __restrict__ p,
                  const int* __restrict__ care, float* __restrict__ out_v,
                  int* __restrict__ out_i, int M, int L, int k, int n_windows,
                  int n_valid, int largest) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_s = smem;
  unsigned char* b_s = smem + kTileBytes;
  int* rt_s = reinterpret_cast<int*>(smem + 2 * kTileBytes);   // [2][128]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_qb = (M + 127) / 128;
  const int m0 = (blockIdx.x % n_qb) * 128;
  const int w = blockIdx.x / n_qb;
  const int wbase = w * 128;
  const int wm = warp & 3, wn = warp >> 2;          // 32 queries x 64 rows
  const bool live = wbase + 64 * wn < n_valid;      // warp-uniform

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // unpacker coordinates: row `ur`, lanes 4 uh .. 4 uh + 3 of each chunk
  const int ur = tid & 127, uh = tid >> 7;
  int rterm = 0;

  // packed tiles of kStageLanes lanes: row r's 16-byte piece c at c ^ (r % 8)
  int* pq_s = rt_s + 256;
  int* pp_s = pq_s + 128 * kStageLanes;
  int* pc_s = pp_s + 128 * kStageLanes;
  auto poff = [](int row, int c) { return row * kStageLanes + ((c ^ (row & 7)) << 2); };
  for (int c0 = 0; c0 < L; c0 += kChunkLanes) {
    const int s0 = c0 % kStageLanes;
    if (s0 == 0) {        // stage the next kStageLanes lanes of every row at once
      const int np = min(kStageLanes, L - c0) / 4;   // 16-byte pieces a row
      for (int idx = tid; idx < 128 * np; idx += kMmaThreads) {
        const int row = idx / np, c = idx % np;
        const int off = poff(row, c);
        const bool in = m0 + row < M;
        cp_async16(pq_s + off, in ? q + size_t(m0 + row) * L + c0 + 4 * c : q, in);
        const size_t src = size_t(wbase + row) * L + c0 + 4 * c;
        cp_async16(pp_s + off, p + src, true);
        if constexpr (kCare) cp_async16(pc_s + off, care + src, true);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();            // the staged lanes are in; the last products done
    const int mine = poff(ur, s0 / 4 + uh);
    const int4 qa = *reinterpret_cast<const int4*>(pq_s + mine);
    const int4 pa = *reinterpret_cast<const int4*>(pp_s + mine);
    int4 ca = make_int4(-1, -1, -1, -1);
    if constexpr (kCare) ca = *reinterpret_cast<const int4*>(pc_s + mine);
    const uint32_t qv[4] = {uint32_t(qa.x), uint32_t(qa.y), uint32_t(qa.z), uint32_t(qa.w)};
    const uint32_t pv[4] = {uint32_t(pa.x), uint32_t(pa.y), uint32_t(pa.z), uint32_t(pa.w)};
    const uint32_t cv[4] = {uint32_t(ca.x), uint32_t(ca.y), uint32_t(ca.z), uint32_t(ca.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 2 * (4 * uh + j);     // 16-byte chunks c, c + 1 of the row
      const uint32_t pc = pv[j] & cv[j];
      rterm += __popc(pc);
      uint32_t aw[8], bw[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        aw[n] = spread4(qv[j] >> (4 * n));
        if constexpr (kCare)
          bw[n] = spread4(cv[j] >> (4 * n)) | spread4(pc >> (4 * n)) * 0xFEu;
        else
          bw[n] = 0x01010101u ^ spread4(pv[j] >> (4 * n)) * 0xFEu;
      }
      *reinterpret_cast<uint4*>(a_s + tile_off(ur, c)) = make_uint4(aw[0], aw[1], aw[2], aw[3]);
      *reinterpret_cast<uint4*>(a_s + tile_off(ur, c + 1)) = make_uint4(aw[4], aw[5], aw[6], aw[7]);
      *reinterpret_cast<uint4*>(b_s + tile_off(ur, c)) = make_uint4(bw[0], bw[1], bw[2], bw[3]);
      *reinterpret_cast<uint4*>(b_s + tile_off(ur, c + 1)) = make_uint4(bw[4], bw[5], bw[6], bw[7]);
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int l = 0; l < kChunkLanes; ++l) {          // one k32 step per lane
        uint32_t a[2][4], b[4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = 32 * wm + 16 * mi + (lane & 15);
          ldmatrix_x4(a[mi], smem_u32(a_s + tile_off(row, 2 * l + (lane >> 4))));
        }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int row = 64 * wn + 16 * nb + ((lane >> 4) << 3) + (lane & 7);
          ldmatrix_x4(b[nb], smem_u32(b_s + tile_off(row, 2 * l + ((lane >> 3) & 1))));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
            mma_s8(acc[mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
      }
    }
  }
  rt_s[128 * uh + ur] = rterm;
  __syncthreads();                        // products done, tiles free

  // keys: key[row][col] at position (col + 8 (row % 8)) % 128 of the row
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  Row r;
  r.wbase = wbase;
  r.n_valid = n_valid;
  r.largest = largest;
  r.maxd = 32 * L;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wm + 16 * mi + g + 8 * h;
        const int col = 64 * wn + 8 * ni + 2 * t;
        uint32_t kv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = rt_s[col + e] + rt_s[128 + col + e] + acc[mi][ni][2 * h + e];
          kv[e] = make_key(d, col + e, wbase + col + e, r);
        }
        *reinterpret_cast<uint2*>(keys + row * 128 + ((col + 8 * (row & 7)) & 127)) =
            make_uint2(kv[0], kv[1]);
      }
  __syncthreads();

  // a warp selects rows warp + 16 i and warp + 16 i + 8 together
  const size_t ld = size_t(n_windows) * k;
  for (int row = warp; row < 128; row += 16) {
    if (m0 + row >= M) break;                         // warp-uniform
    Row rs[2] = {r, r};
    const uint32_t* const ks[2] = {keys + row * 128, keys + (row + 8) * 128};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + row + 8 * j;
      rs[j].ov = m < M ? out_v + size_t(m) * ld + size_t(w) * k : nullptr;
      rs[j].oi = out_i + size_t(m) * ld + size_t(w) * k;
    }
    select_rows<4, 2>(ks, k, rs, lane);
  }
}

template <bool kCare>
int launch_mma(const int* q, const int* p, const int* care, float* out_v, int* out_i,
               int M, int L, int k, int n_windows, int n_valid, int largest,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(packed_mma_kernel<kCare>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(mma_smem(kCare)));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)((M + 127) / 128) * n_windows;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  packed_mma_kernel<kCare><<<unsigned(blocks), kMmaThreads, mma_smem(kCare), s>>>(
      q, p, care, out_v, out_i, M, L, k, n_windows, n_valid, largest);
  return int(cudaGetLastError());
}

template <bool kCare>
int launch(int route, const int* q, const int* p, const int* care, float* out_v,
           int* out_i, int M, int N, int L, int k, int window, int n_valid,
           int largest, cudaStream_t s) {
  const int n_windows = N / window;
  if (route == 1) {
    if (window != 128 || L % kChunkLanes) return int(cudaErrorInvalidValue);
    return launch_mma<kCare>(q, p, care, out_v, out_i, M, L, k, n_windows, n_valid,
                             largest, s);
  }
  if (n_windows > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid((M + kRowWarps - 1) / kRowWarps, n_windows);
  switch (window) {
    case 128:
      packed_rows_kernel<kCare, 4><<<grid, 32 * kRowWarps, 0, s>>>(
          q, p, care, out_v, out_i, M, L, k, n_windows, n_valid, largest);
      break;
    case 256:
      packed_rows_kernel<kCare, 8><<<grid, 32 * kRowWarps, 0, s>>>(
          q, p, care, out_v, out_i, M, L, k, n_windows, n_valid, largest);
      break;
    case 384:
      packed_rows_kernel<kCare, 12><<<grid, 32 * kRowWarps, 0, s>>>(
          q, p, care, out_v, out_i, M, L, k, n_windows, n_valid, largest);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

// q (M, L), p (N, L) int32 lanes, 16-byte aligned, L a multiple of 8, N a
// multiple of `window` (128, 256 or 384); care (N, L) or nullptr for binary
// cells.  route: 0 = "rows", 1 = "mma" (window 128 only).  Returns a
// cudaError_t code.
extern "C" int c4cam_fused_topk_packed(const int* q, const int* p,
                                       const int* care, float* out_v,
                                       int* out_i, int M, int N, int L, int k,
                                       int window, int n_valid, int largest,
                                       int route, void* stream) {
  if (M <= 0 || N <= 0 || L <= 0 || k < 1 || k > window || N % window)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (care == nullptr)
    return launch<false>(route, q, p, nullptr, out_v, out_i, M, N, L, k, window,
                         n_valid, largest, s);
  return launch<true>(route, q, p, care, out_v, out_i, M, N, L, k, window, n_valid,
                      largest, s);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
