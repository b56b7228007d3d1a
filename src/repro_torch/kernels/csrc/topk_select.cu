// topk_select: the k best entries of each row of a float32 matrix by
// (value, lowest column), sorted (sm_90a).  K1s.
//
// Replaces the block top-k that the TPU kernels `fused_topk_pallas`
// (src/repro/kernels/cam_search.py:200) and `fused_topk_packed_pallas`
// (:304) run inside their bodies (`_extract_block_topk`) for any k, where
// the port's fused kernels stop at a 384-row window (the window's keys live
// in shared memory).  Past that the search writes the (M, N) distance
// matrix (B6's distance.cu, or K1p's packed_distance.cu) and this kernel
// selects from it.  The order is the reference's: key = -dist for largest,
// else dist, -0.0 folded into +0.0, ties to the lower column; columns at or
// past n_valid never win (1 <= k <= n_valid).  Values are the input's own
// bits, gathered from the matrix.
//
// Bound: one read of the n_valid live columns plus the (M, k) output, at
// 3.35 TB/s (0.134 ms at 624 x 180,000).  Design, one launch:
//
// * Stream-K grid.  The M x n_valid live entries, cut into 16-column
//   groups row by row, are shared out in equal contiguous stretches (one
//   group more or less) over a grid sized to the card's block slots
//   (cam_search.select_grid: two blocks an SM while the sort buffer
//   leaves room), so every SM reads the same bytes at 624 rows and at 13.
//   A stretch is a run of pieces, one a row it touches.
// * Sampled bound, then one filtering read.  For each piece the block finds
//   its row's bound: 2,048 keys in 32 runs of 64 columns spread over the
//   row, the key below which about twice k (plus a margin) of the row's
//   keys lie, by a radix select of 8-bit digits (warp-aggregated counts in
//   a 256-bin histogram).  Every block touching the row reads the same
//   samples and finds the same bound, so no block waits for another.  Then
//   each warp streams its own share of the piece with 16-byte loads, two a
//   lane in flight, with no block barrier, and stages its (key, column)
//   pairs at or below the bound in its part of shared memory; a full stage
//   goes to the row's candidate list in global scratch with one atomicAdd
//   on the row's slot counter (a capacity of kGatherCap; past it only the
//   count grows).
// * The last block finishes.  A block adds its piece's columns to the
//   row's arrival counter after a fence; the block that brings it to
//   n_valid (the classic last-block pattern) finishes the row, and resets
//   both counters for the next launch.  When the list holds at least k
//   pairs and did not overflow, it loads them into shared memory, fixes the
//   k-th key by the same 8-bit radix select and, where ties straddle it,
//   the largest column taken among the tied keys by one more on the
//   columns: exactly k pairs remain.  Arrival order only places pairs in
//   the list: the result is a total order on (key, column), the same on
//   every run.
// * Otherwise (many tied keys, a large k, a narrow row) the finishing
//   block runs a radix select over the whole row: a pass over the row
//   counts the keys matching the digits fixed so far in a shared-memory
//   histogram (four copies, by lane), the bin holding the k-th key fixes
//   the next digit; once the bin holds at most kGatherCap keys one more
//   pass writes every key below it to the list in row order (a block scan
//   of two 16-bit counts) and gathers the bin into shared memory, where
//   the remaining digits are resolved.
// * The k pairs are sorted by (key, column): up to 512 by a bitonic
//   network of one pair a thread (shuffles within a warp, shared memory
//   across warps); above, a stable LSD radix
//   sort of 8-bit digits, column first (a digit equal for every pair skips
//   its pass), in shared memory up to kSortCap pairs, else in global
//   scratch.  No float atomics, no waiting on other blocks, no grid
//   barrier.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

// the block's dynamic shared memory (its parts at the kOff* offsets below)
extern __shared__ __align__(16) unsigned char g_smem[];

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                         // entries a thread per batch
constexpr int kBatch = kThreads * kItems;         // 4096
constexpr int kGroup = 16;                        // columns of a stretch unit
constexpr int kBins = 2048;                       // 11-bit digits
constexpr int kCopies = 4;
constexpr int kGatherCap = 6144;                  // candidates of a row
constexpr int kSortCap = 8192;                    // pairs sorted in shared memory
constexpr int kWarpStaged = 256;                  // a warp's staged pairs (the copies' space)

// shared memory, in bytes
constexpr size_t kOffHist4 = 0;                                   // [kBins][kCopies]
constexpr size_t kOffHist = kOffHist4 + size_t(kBins) * kCopies * 4;
constexpr size_t kOffMisc = kOffHist + size_t(kBins) * 4;
constexpr int kMiscWords = 256;
constexpr size_t kOffGather = kOffMisc + size_t(kMiscWords) * 4;
constexpr size_t kOffSort = kOffGather + size_t(kGatherCap) * 8;
// misc words
constexpr int kScanA = 0, kScanB = 16, kRed = 32, kSel = 48, kLast = 52, kTotal = 53,
              kTaken = 54;
static_assert(kWarps * kWarpStaged * 8 <= kBins * kCopies * 4, "the staging fits the copies");

size_t smem_bytes(int k) {
  return kOffSort + (k <= kSortCap ? size_t(2) * k * 8 : 0);
}

__device__ __forceinline__ uint32_t order_bits(float d, int largest) {
  uint32_t b = __float_as_uint(d);
  if (largest) b ^= 0x80000000u;                  // -d
  if (b == 0x80000000u) b = 0u;                   // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Exclusive block scan of `mine` (two 16-bit counts); `total` gets the
// block's sum.  One __syncthreads; callers alternate `wsum` buffers.
__device__ __forceinline__ uint32_t scan_pair(uint32_t mine, uint32_t* wsum,
                                              uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  uint32_t before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = wsum[w];
    if (w < warp) before += s;
    tot += s;
  }
  total = tot;
  return before + incl - mine;
}

// The live columns [begin, end) of one row, read kItems contiguous columns
// a thread per batch (row order over the block).
struct RowPart {
  const float* row;
  int begin, end, vec, largest;
  __device__ int batches() const { return (end - begin + kBatch - 1) / kBatch; }
  __device__ int first(int b) const { return begin + b * kBatch + kItems * threadIdx.x; }
  __device__ void load(int b, float (&v)[kItems]) const {
    const int i0 = first(b);
#pragma unroll
    for (int c = 0; c < kItems; c += 4) {
      const int i = i0 + c;
      if (vec && i + 4 <= end) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + i));
        v[c] = x.x; v[c + 1] = x.y; v[c + 2] = x.z; v[c + 3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[c + e] = i + e < end ? __ldg(row + i + e) : 0.f;
      }
    }
  }
};

// Selection state, the same in every thread of the block.
struct State {
  uint32_t prefix = 0, pmask = 0;   // the digits fixed so far
  uint32_t less = 0;                // keys below the prefix's range
  uint32_t kk;                      // rank sought inside the range (1-based)
  uint32_t cnt;                     // keys inside the range
};

// The parts of shared memory, addressed from the symbol (no registers).
struct Shared {
  __device__ uint32_t* hist4() const { return reinterpret_cast<uint32_t*>(g_smem + kOffHist4); }
  __device__ uint32_t* hist() const { return reinterpret_cast<uint32_t*>(g_smem + kOffHist); }
  __device__ uint32_t* misc() const { return reinterpret_cast<uint32_t*>(g_smem + kOffMisc); }
  __device__ uint2* gather() const { return reinterpret_cast<uint2*>(g_smem + kOffGather); }
};

// Folds the copies and fixes the digit at `shift` (`width` bits) that
// holds the kk-th key; leaves the copies zeroed.
__device__ void fix_digit(const Shared& sh, State& st, int shift, int width) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();         // the pass's counts are in
  for (int bin = tid; bin < kBins; bin += kThreads) {
    uint4* h4 = reinterpret_cast<uint4*>(sh.hist4()) + bin;
    const uint4 h = *h4;
    sh.hist()[bin] = h.x + h.y + h.z + h.w;
    *h4 = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // the bin holding the kk-th key: thread t owns bins 4t .. 4t + 3
  const uint4 c = reinterpret_cast<const uint4*>(sh.hist())[tid];
  const uint32_t cs[4] = {c.x, c.y, c.z, c.w};
  const uint32_t s = c.x + c.y + c.z + c.w;
  uint32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  uint32_t* red = sh.misc() + kRed;
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  uint32_t run = incl - s;
  for (int w = 0; w < warp; ++w) run += red[w];
  if (run < st.kk && st.kk <= run + s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (st.kk <= run + cs[j]) {
        sh.misc()[kSel] = 4 * tid + j;
        sh.misc()[kSel + 1] = run;
        break;
      }
      run += cs[j];
    }
  }
  __syncthreads();
  const uint32_t b = sh.misc()[kSel], below = sh.misc()[kSel + 1];
  st.less += below;
  st.kk -= below;
  st.cnt = sh.hist()[b];
  st.prefix |= b << shift;
  st.pmask |= ((1u << width) - 1u) << shift;
}

// digit `level` (0, 1, 2): bits 31..21, 20..10, 9..0
__device__ __forceinline__ int digit_shift(int level) { return level == 0 ? 21 : level == 1 ? 10 : 0; }
__device__ __forceinline__ int digit_width(int level) { return level == 2 ? 10 : 11; }

__device__ __forceinline__ void count(uint32_t* hist4, uint32_t u, int shift, int lane) {
  atomicAdd(&hist4[(((u >> shift) & (kBins - 1)) << 2) | (lane & 3)], 1u);
}

__device__ void row_histogram(const RowPart& part, const Shared& sh, const State& st,
                              int shift) {
  const int nb = part.batches(), lane = threadIdx.x & 31;
  float nxt[kItems];
  if (nb > 0) part.load(0, nxt);
  for (int b = 0; b < nb; ++b) {
    float cur[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) cur[i] = nxt[i];
    if (b + 1 < nb) part.load(b + 1, nxt);
    const int i0 = part.first(b);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i0 + i >= part.end) break;
      const uint32_t u = order_bits(cur[i], part.largest);
      if ((u & st.pmask) == st.prefix) count(sh.hist4(), u, shift, lane);
    }
  }
}

// Counts the gathered keys in the range.
__device__ void gather_histogram(const Shared& sh, const State& st, int n, int shift) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const uint32_t u = sh.gather()[j].x;
    if ((u & st.pmask) == st.prefix) count(sh.hist4(), u, shift, lane);
  }
}

// The kk-th smallest (1-based) of the values v of the n items j for which
// get(j, v) holds: the value, how many lie below it, its rank among the
// equal ones and how many equal it.  Four 8-bit digits, most significant
// first; `bins` holds two 256-bin histograms (taken in turns), counted
// with one shared-memory atomic a warp and digit.
struct Sel {
  uint32_t value, less, kk, cnt;
};

// `fixed` leading bytes, equal to those of `prefix`, are known to be
// shared by every item: their levels are skipped.
template <class Get>
__device__ Sel radix8(uint32_t* bins, uint32_t* misc, int n, uint32_t kk, Get get,
                      int fixed = 0, uint32_t prefix = 0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t pmask = fixed ? ~0u << (32 - 8 * fixed) : 0u;
  Sel r{prefix & pmask, 0u, kk, uint32_t(n)};
  for (int level = fixed; level < 4; ++level) {
    const int shift = 24 - 8 * level;
    uint32_t* h = bins + (level & 1) * 256;
    if (tid < 256) h[tid] = 0;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kThreads) {
      const int j = j0 + tid;
      uint32_t v = 0;
      const bool in = j < n && get(j, v) && (v & pmask) == r.value;
      const uint32_t d = in ? (v >> shift) & 255u : 256u;
      const uint32_t peers = __match_any_sync(0xffffffffu, d);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&h[d], uint32_t(__popc(peers)));
    }
    __syncthreads();
    if (warp == 0) {                           // the bin holding the kk-th, 8 a lane
      uint32_t c[8], s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = h[8 * lane + i];
        s += c[i];
      }
      uint32_t incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      uint32_t run = incl - s;
      if (run < r.kk && r.kk <= run + s) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (r.kk <= run + c[i]) {
            misc[kSel] = 8 * lane + i;
            misc[kSel + 1] = run;
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    const uint32_t b = misc[kSel], below = misc[kSel + 1];
    r.less += below;
    r.kk -= below;
    r.cnt = h[b];
    r.value |= b << shift;
    pmask |= 0xFFu << shift;
  }
  __syncthreads();         // every thread has read the bins: the next call may clear them
  return r;
}

constexpr int kRuns = 32, kRunLen = 64;
constexpr int kSamples = kRuns * kRunLen;         // 2048: 4 a thread

// The r-th smallest (1-based) of kSamples keys read in kRuns runs of
// kRunLen columns spread evenly over the live columns: every block reads
// the same keys and finds the same bound.  The keys live in the copies'
// space meanwhile (the warps stage their pairs there once it is found).
__device__ uint32_t sample_bound(const float* row, const Shared& sh, int n_valid,
                                 int largest, uint32_t r) {
  uint32_t* keys = sh.hist4();
  const int tid = threadIdx.x;
  constexpr int kPerRun = kThreads / kRuns;
  const int run = tid / kPerRun;
  const int at = int((long long)run * (n_valid - kRunLen) / (kRuns - 1)) +
                 4 * (tid % kPerRun);
  __syncthreads();         // the buffer's last readers are done
#pragma unroll
  for (int j = 0; j < 4; ++j) keys[4 * tid + j] = order_bits(__ldg(row + at + j), largest);
  return radix8(sh.hist(), sh.misc(), kSamples, r, [&](int j, uint32_t& v) {
           v = keys[j];
           return true;
         }).value;
}

// Reads columns [c0, c1) of `row` once and appends each (key, column) at
// or below the row's sampled bound (the r-th sample) to the row's list.
// Each warp streams its own contiguous share of the piece, two 16-byte
// loads a lane in flight while it filters the last two, and stages its
// pairs in its own part of shared memory; a full stage goes to the list
// with one atomicAdd on the row's slot counter (slots past kGatherCap are
// counted, not written).  No block barrier while streaming.
__device__ void filter_piece(const float* row, int c0, int c1, int n_valid, uint32_t r,
                             int largest, const Shared& sh, uint2* list, int* slots) {
  const uint32_t bound = sample_bound(row, sh, n_valid, largest, r);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // 16-byte quads of the row from the aligned address `a` columns before it
  const int a = int((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const float4* quads = reinterpret_cast<const float4*>(row - a);
  const int q0 = (c0 + a) / 4, q1 = (c1 + a + 3) / 4;
  const int w0 = q0 + int((long long)(q1 - q0) * warp / kWarps);
  const int w1 = q0 + int((long long)(q1 - q0) * (warp + 1) / kWarps);
  uint2* stg = reinterpret_cast<uint2*>(sh.hist4()) + warp * kWarpStaged;
  uint32_t cnt = 0;                                  // the warp's staged pairs
  auto flush = [&]() {
    uint32_t at = 0;
    if (lane == 0) at = uint32_t(atomicAdd(slots, int(cnt)));
    at = __shfl_sync(0xffffffffu, at, 0);
    for (uint32_t i = lane; i < cnt; i += 32)
      if (at + i < uint32_t(kGatherCap)) list[at + i] = stg[i];
    __syncwarp();
    cnt = 0;
  };
  auto load = [&](int q) {
    return q < w1 ? __ldg(quads + q) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  // steps of 64 quads: a lane's quads q and q + 32
  float4 nxt[2] = {load(w0 + lane), load(w0 + 32 + lane)};
  for (int q = w0; q < w1; q += 64) {
    const float4 cur[2] = {nxt[0], nxt[1]};
    nxt[0] = load(q + 64 + lane);
    nxt[1] = load(q + 96 + lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qq = q + 32 * i + lane, col = 4 * qq - a;
      const float v[4] = {cur[i].x, cur[i].y, cur[i].z, cur[i].w};
      uint32_t f = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (qq < w1 && col + e >= c0 && col + e < c1 && order_bits(v[e], largest) <= bound)
          f |= 1u << e;
      const uint32_t h = __popc(f);
      uint32_t incl = h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      uint32_t at = cnt + incl - h;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (f >> e & 1u) stg[at++] = make_uint2(order_bits(v[e], largest), col + e);
      cnt += __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      if (cnt > uint32_t(kWarpStaged - 128)) flush();   // room for the next 128
    }
  }
  if (cnt) flush();
}

// Where the pairs of a compaction go.  Keys below the range (`a`) take
// list slots a_run + their rank; keys in it (`b`) either are ties of a
// fully fixed key (slot b_base + rank while the rank is below `take`) or
// are gathered into shared memory.
struct Sink {
  uint2* list;
  uint2* gather;
  uint32_t a_run, b_run;
  uint32_t b_base, take;
  bool ties;
  __device__ void put_a(uint32_t r, uint32_t u, int col) const { list[r] = make_uint2(u, col); }
  __device__ void put_b(uint32_t r, uint32_t u, int col) const {
    if (!ties) gather[r] = make_uint2(u, col);
    else if (r < take) list[b_base + r] = make_uint2(u, col);
  }
};

__device__ void row_compact(const RowPart& part, const Shared& sh, const State& st,
                            Sink sink) {
  const int nb = part.batches();
  float nxt[kItems];
  if (nb > 0) part.load(0, nxt);
  for (int b = 0; b < nb; ++b) {
    float cur[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) cur[i] = nxt[i];
    if (b + 1 < nb) part.load(b + 1, nxt);
    const int i0 = part.first(b);
    uint32_t fa = 0, fb = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i0 + i >= part.end) break;
      const uint32_t u = order_bits(cur[i], part.largest);
      if (u < st.prefix) fa |= 1u << i;
      else if ((u & st.pmask) == st.prefix) fb |= 1u << i;
    }
    if (!__syncthreads_or(fa | fb)) continue;
    uint32_t tot;
    const uint32_t excl = scan_pair(__popc(fa) | (__popc(fb) << 16),
                                    sh.misc() + ((b & 1) ? kScanB : kScanA), tot);
    uint32_t ra = sink.a_run + (excl & 0xffffu), rb = sink.b_run + (excl >> 16);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if ((fa | fb) >> i & 1u) {
        const uint32_t u = order_bits(cur[i], part.largest);
        if (fa >> i & 1u) sink.put_a(ra++, u, i0 + i);
        else sink.put_b(rb++, u, i0 + i);
      }
    }
    sink.a_run += tot & 0xffffu;
    sink.b_run += tot >> 16;
  }
}

__device__ void gather_compact(const Shared& sh, const State& st, int n, Sink sink) {
  const int nb = (n + kBatch - 1) / kBatch;
  for (int b = 0; b < nb; ++b) {
    const int i0 = b * kBatch + kItems * threadIdx.x;
    uint32_t fa = 0, fb = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i0 + i >= n) break;
      const uint32_t u = sh.gather()[i0 + i].x;
      if (u < st.prefix) fa |= 1u << i;
      else if (u == st.prefix) fb |= 1u << i;
    }
    if (!__syncthreads_or(fa | fb)) continue;
    uint32_t tot;
    const uint32_t excl = scan_pair(__popc(fa) | (__popc(fb) << 16),
                                    sh.misc() + ((b & 1) ? kScanB : kScanA), tot);
    uint32_t ra = sink.a_run + (excl & 0xffffu), rb = sink.b_run + (excl >> 16);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if ((fa | fb) >> i & 1u) {
        const uint2 e = sh.gather()[i0 + i];
        if (fa >> i & 1u) sink.put_a(ra++, e.x, int(e.y));
        else sink.put_b(rb++, e.x, int(e.y));
      }
    }
    sink.a_run += tot & 0xffffu;
    sink.b_run += tot >> 16;
  }
}

// Stable LSD radix sort of n (key, column) pairs on (key, column), 8-bit
// digits, the column's first; `scr` holds kWarps * 256 + 512 words.
// Returns the buffer holding the result (a or b).
__device__ uint2* lsd_sort(uint2* a, uint2* b, int n, uint32_t* scr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* wcnt = scr;                       // [kWarps][256]
  uint32_t* base = scr + kWarps * 256;        // [256]
  uint32_t* cnt = base + 256;                 // [256]
  auto digit = [](uint2 e, int pass) {
    return ((pass < 4 ? e.y : e.x) >> (8 * (pass & 3))) & 255u;
  };
  for (int pass = 0; pass < 8; ++pass) {
    if (tid < 256) cnt[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) atomicAdd(&cnt[digit(a[i], pass)], 1u);
    __syncthreads();
    if (__syncthreads_or(tid < 256 && cnt[tid] == uint32_t(n))) continue;  // one digit
    if (warp == 0) {                          // exclusive scan, 8 counts a lane
      uint32_t c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) { c[j] = cnt[8 * lane + j]; s += c[j]; }
      uint32_t incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      uint32_t run = incl - s;
#pragma unroll
      for (int j = 0; j < 8; ++j) { base[8 * lane + j] = run; run += c[j]; }
    }
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += kThreads) {
      for (int j = tid; j < kWarps * 256; j += kThreads) wcnt[j] = 0;
      const int i = t0 + tid;
      const bool valid = i < n;
      const uint2 e = valid ? a[i] : make_uint2(0, 0);
      const uint32_t d = valid ? digit(e, pass) : 256u;
      const uint32_t peers = __match_any_sync(0xffffffffu, d);
      __syncthreads();
      if (valid && lane == __ffs(peers) - 1) wcnt[warp * 256 + d] = __popc(peers);
      __syncthreads();
      if (tid < 256) {
        uint32_t run = base[tid];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const uint32_t c = wcnt[w * 256 + tid];
          wcnt[w * 256 + tid] = run;
          run += c;
        }
        base[tid] = run;
      }
      __syncthreads();
      if (valid) b[wcnt[warp * 256 + d] + __popc(peers & ((1u << lane) - 1u))] = e;
      __syncthreads();
    }
    uint2* t = a;
    a = b;
    b = t;
  }
  return a;
}

// The k best (key, column) pairs of the row into `list` (any order), by a
// radix select over the whole row.
__device__ void select_row(const RowPart& part, const Shared& sh, int k, int n_valid,
                           uint2* list) {
  for (int j = threadIdx.x; j < kBins * kCopies; j += kThreads) sh.hist4()[j] = 0;
  __syncthreads();                        // the copies held the candidates' staging
  State st;
  st.kk = uint32_t(k);
  st.cnt = uint32_t(n_valid);
  int level;
  for (level = 0;; ++level) {
    row_histogram(part, sh, st, digit_shift(level));
    fix_digit(sh, st, digit_shift(level), digit_width(level));
    if (level == 2 || st.cnt <= uint32_t(kGatherCap)) break;
  }
  const bool fixed = level == 2;
  const uint32_t less_row = st.less;
  Sink sink;
  sink.list = list;
  sink.gather = sh.gather();
  sink.a_run = 0;
  sink.b_run = 0;
  sink.b_base = less_row;
  sink.take = st.kk;
  sink.ties = fixed;
  row_compact(part, sh, st, sink);
  if (fixed) return;
  const int n = int(st.cnt);              // the range, gathered in row order
  __syncthreads();
  for (++level; level <= 2; ++level) {
    gather_histogram(sh, st, n, digit_shift(level));
    fix_digit(sh, st, digit_shift(level), digit_width(level));
  }
  sink.a_run = less_row;
  sink.b_run = 0;
  sink.b_base = st.less;
  sink.take = st.kk;
  sink.ties = true;
  gather_compact(sh, st, n, sink);
}

// The k best of the row's `total` candidates (all its keys at or below
// the sampled bound, k <= total <= kGatherCap) into `list`, any order.
__device__ void select_candidates(const Shared& sh, const uint2* cand, int total, int k,
                                  int n_valid, uint2* list) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint2* g = sh.gather();
  // the candidates, and the leading bytes every key shares (their least
  // and largest keys agree on them)
  uint32_t lo = 0xffffffffu, hi = 0u;
  for (int j = tid; j < total; j += kThreads) {
    const uint2 e = __ldcg(cand + j);
    sh.gather()[j] = e;
    lo = min(lo, e.x);
    hi = max(hi, e.x);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  uint32_t* red = sh.misc() + kRed;                  // [16] lows, then [16] highs
  if (lane == 0) {
    red[warp] = lo;
    sh.misc()[kScanA + warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, sh.misc()[kScanA + w]);
  }
  const int same = (lo ^ hi) ? __clz(lo ^ hi) / 8 : 4;
  const Sel s = radix8(
      sh.hist(), sh.misc(), total, uint32_t(k),
      [&](int j, uint32_t& v) {
        v = g[j].x;
        return true;
      },
      min(same, 3), lo);
  // the k-th key is s.value; of its s.cnt ties the s.kk lowest columns
  // (below 2^24 columns share their top byte)
  uint32_t col_max = 0xffffffffu;
  if (s.kk < s.cnt)
    col_max = radix8(
                  sh.hist(), sh.misc(), total, s.kk,
                  [&](int j, uint32_t& v) {
                    if (g[j].x != s.value) return false;
                    v = g[j].y;
                    return true;
                  },
                  n_valid <= (1 << 24) ? 1 : 0, 0u)
                  .value;
  uint32_t* taken = sh.misc() + kTaken;
  if (tid == 0) *taken = 0;
  __syncthreads();
  for (int j = tid; j < total; j += kThreads) {
    const uint2 e = g[j];
    if (e.x < s.value || (e.x == s.value && e.y <= col_max)) list[atomicAdd(taken, 1u)] = e;
  }
}

// The k pairs of `list` (any order) sorted by (key, column) into the row's
// outputs, the values gathered from the matrix.
__device__ void sort_write(const Shared& sh, uint2* list, int k, const float* rowp,
                           float* out_v, int* out_i) {
  const int tid = threadIdx.x;
  if (k <= kThreads) {                    // a bitonic network, a pair a thread
    uint64_t v = tid < k ? uint64_t(list[tid].x) << 32 | list[tid].y : ~uint64_t(0);
    uint64_t* xch = reinterpret_cast<uint64_t*>(sh.hist4());   // two buffers, in turns
    int turn = 0;
    for (int size = 2; size <= kThreads; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        uint64_t other;
        if (stride >= 32) {                // across warps, through shared memory
          uint64_t* b = xch + turn * kThreads;
          turn ^= 1;
          b[tid] = v;
          __syncthreads();
          other = b[tid ^ stride];
        } else {
          other = __shfl_xor_sync(0xffffffffu, v, stride);
        }
        const bool keep_min = ((tid & stride) == 0) == ((tid & size) == 0);
        v = keep_min ? min(v, other) : max(v, other);
      }
    if (tid < k) {
      const int col = int(uint32_t(v));
      out_i[tid] = col;
      out_v[tid] = rowp[col];
    }
    return;
  }
  const uint2* sorted = lsd_sort(list, list + k, k, sh.hist4());
  for (int j = tid; j < k; j += kThreads) {
    const uint2 e = sorted[j];
    out_i[j] = int(e.y);
    out_v[j] = rowp[e.y];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
topk_select_kernel(const float* __restrict__ dist, float* __restrict__ out_v,
                   int* __restrict__ out_i, uint2* __restrict__ cand,
                   int* __restrict__ counters, uint2* __restrict__ scratch, int M, int N,
                   int k, int n_valid, int largest, int sampled, int r) {
  const int tid = threadIdx.x;
  Shared sh;
  int* slots = counters;             // [M]: candidates appended a row
  int* arrived = counters + M;       // [M]: columns read a row

  // this block's stretch [g0, g1) of the M x gpr 16-column groups (the
  // launch keeps M x gpr below 2^31)
  const int gpr = (n_valid + kGroup - 1) / kGroup;
  const long long T = (long long)M * gpr;
  const int g1 = int(T * (blockIdx.x + 1) / gridDim.x);
  for (int g = int(T * blockIdx.x / gridDim.x); g < g1;) {
    const int row = g / gpr;
    const int end = min(g1, (row + 1) * gpr);
    const int c0 = (g - row * gpr) * kGroup;
    const int c1 = min((end - row * gpr) * kGroup, n_valid);
    g = end;
    const float* rowp = dist + size_t(row) * N;
    if (sampled)
      filter_piece(rowp, c0, c1, n_valid, uint32_t(r), largest, sh,
                   cand + size_t(row) * kGatherCap, slots + row);
    __threadfence();                        // the piece's pairs, before its arrival
    __syncthreads();
    if (tid == 0) {
      const int before = atomicAdd(arrived + row, c1 - c0);
      const bool last = before + (c1 - c0) == n_valid;
      sh.misc()[kLast] = last;
      if (last) {
        __threadfence();
        sh.misc()[kTotal] = uint32_t(atomicAdd(slots + row, 0));
        slots[row] = 0;                     // both counters clean for the next launch
        arrived[row] = 0;
      }
    }
    __syncthreads();
    if (!sh.misc()[kLast]) continue;
    // this block finishes the row
    const int total = int(sh.misc()[kTotal]);
    uint2* list = k <= kSortCap ? reinterpret_cast<uint2*>(g_smem + kOffSort)
                                : scratch + size_t(row) * 2 * k;
    if (sampled && total >= k && total <= kGatherCap) {
      select_candidates(sh, cand + size_t(row) * kGatherCap, total, k, n_valid, list);
    } else {
      RowPart part;
      part.row = rowp;
      part.begin = 0;
      part.end = n_valid;
      part.vec = (reinterpret_cast<uintptr_t>(dist) % 16 == 0) && (N % 4 == 0);
      part.largest = largest;
      select_row(part, sh, k, n_valid, list);
    }
    __syncthreads();                        // the k pairs are in
    sort_write(sh, list, k, rowp, out_v + size_t(row) * k, out_i + size_t(row) * k);
    __syncthreads();                        // the list and the sort's scratch are free
  }
}

}  // namespace

// dist (M, N) float32 row-major; out_v (M, k) float32, out_i (M, k) int32;
// cand: M * kGatherCap (key, column) pairs of 8 bytes; counters: 2 M int32,
// zero (the kernel leaves them zero); scratch: M * 2k pairs when k >
// kSortCap, else nullptr.  1 <= k <= n_valid <= N; grid: the blocks, at
// most M * ceil(n_valid / 16) (cam_search.select_grid).  Returns a
// cudaError_t code.
extern "C" int c4cam_topk_select(const float* dist, float* out_v, int* out_i, void* cand,
                                 void* counters, void* scratch, int M, int N, int k,
                                 int n_valid, int largest, int grid, void* stream) {
  const long long groups = (long long)M * ((n_valid + kGroup - 1) / kGroup);
  if (M <= 0 || N <= 0 || k < 1 || n_valid < k || n_valid > N || grid < 1 ||
      grid > groups || groups > 0x7fffffffLL || cand == nullptr || counters == nullptr ||
      (k > kSortCap && scratch == nullptr))
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  // the largest dynamic shared memory any k asks, allowed once a device
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(allowed.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_bytes(kSortCap)));
    if (err != cudaSuccess) return int(err);
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  // the sampled bound: rank r among the samples puts about 2k plus a
  // margin of the row's keys below it, when they fit the candidate list
  const long long r = (2LL * k * kSamples + n_valid - 1) / n_valid + 16;
  const int sampled = n_valid >= 4 * kSamples && r <= kSamples / 4 &&
                      r * n_valid <= (long long)kGatherCap * kSamples / 2;
  topk_select_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dist, out_v, out_i, static_cast<uint2*>(cand), static_cast<int*>(counters),
      static_cast<uint2*>(scratch), M, N, k, n_valid, largest, sampled, int(r));
  return int(cudaGetLastError());
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
