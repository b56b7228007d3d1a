// topk_select: the k best entries of each row of a float32 matrix by
// (value, lowest column), sorted (sm_90a).
//
// Replaces the block top-k that the TPU kernels `fused_topk_pallas`
// (src/repro/kernels/cam_search.py:200) and `fused_topk_packed_pallas`
// (:304) run inside their bodies (`_extract_block_topk`) for any k, where
// the port's fused kernels stop at a 384-row window (the window's keys live
// in shared memory).  Past that the search writes the (M, N) distance
// matrix (B6, or the packed distance route of fused_topk_packed.cu) and this
// kernel selects from it.  The order is the reference's: key = -dist for
// largest, else dist, -0.0 folded into +0.0, ties to the lower column;
// columns at or past n_valid never win (1 <= k <= n_valid).  Values are the
// input's own bits, gathered from the matrix.
//
// Bound: one read of the n_valid live columns plus the (M, k) output, at
// 3.35 TB/s (0.134 ms at 624 x 180,000).  Design:
//
// * A sampled bound first, where k is small beside the row: 2,048 keys in
//   32 runs of 64 columns spread over the row give the key below which
//   about twice k (plus a margin) of the row's keys lie; one read of the
//   row gathers every key at or below it into shared memory, in row order.
//   When that holds at least k keys and fits, the selection finishes there
//   (one read of the row); otherwise it falls back to the radix select
//   below (rows with many tied keys, large k).
// * Radix select on the 32-bit order-preserving key (the float's bits with
//   the sign folded, as cam_search.order_key orders them), most significant
//   digit first: 11, 11 and 10 bits.  A pass over the row counts the keys
//   that match the digits fixed so far in a shared-memory histogram (four
//   copies, by lane, so that keys crowding into a few bins meet fewer
//   same-address atomics); the bin holding the k-th key fixes the next
//   digit.  Counts are integers, so the result does not depend on their
//   order.  As soon as the bin holds at most kGatherCap keys, one more pass
//   writes every key below the bin to the output list and gathers the bin's
//   keys into shared memory, where the remaining digits are resolved: two
//   reads of the row where the first digit leaves a small bin.
// * The list is compacted in row order by a block-wide prefix scan (two
//   16-bit counts packed in one word), so that among the keys equal to the
//   k-th the lowest columns are taken without atomics on order.
// * The k (key, column) pairs are sorted by a stable LSD radix sort on the
//   key (8-bit digits, a digit equal for every pair skips its pass): the
//   pairs arrive in column order within equal keys, so the result is in
//   (key, column) order.  In shared memory up to kSortCap pairs, else in
//   global scratch that the wrapper allocates.
// * Grid: one block per row when the rows fill the card; fewer rows are
//   split over a thread block cluster of 2, 4 or 8 blocks (the wrapper picks
//   the size), each counting its own stretch of the row.  The blocks add
//   their histograms through distributed shared memory and write their part
//   of the list into the first block's shared memory, which sorts it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                        // entries a thread per batch
constexpr int kBatch = kThreads * kItems;         // 8192
constexpr int kBins = 2048;                       // 11-bit digits
constexpr int kCopies = 4;
constexpr int kGatherCap = 6144;                  // bin entries kept in shared memory
constexpr int kSortCap = 8192;                    // pairs sorted in shared memory
constexpr int kMaxCluster = 8;

// shared memory, in bytes
constexpr size_t kOffHist4 = 0;                                   // [kBins][kCopies]
constexpr size_t kOffHist = kOffHist4 + size_t(kBins) * kCopies * 4;   // this block's
constexpr size_t kOffTotal = kOffHist + size_t(kBins) * 4;        // the cluster's
constexpr size_t kOffMisc = kOffTotal + size_t(kBins) * 4;
constexpr int kMiscWords = 256;
constexpr size_t kOffGather = kOffMisc + size_t(kMiscWords) * 4;
constexpr size_t kOffSort = kOffGather + size_t(kGatherCap) * 8;
// misc words
constexpr int kScanA = 0, kScanB = 16, kRed = 32, kSel = 48, kPub = 52;

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

// The sum of `x` over the block.  Two __syncthreads.
__device__ __forceinline__ uint32_t block_sum(uint32_t x, uint32_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(0xffffffffu, x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The row's live stretch [begin, end) of this block.
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

// Selection state, the same in every thread of the cluster (own* are this
// block's share).
struct State {
  uint32_t prefix = 0, pmask = 0;   // the digits fixed so far
  uint32_t less = 0;                // keys below the prefix's range
  uint32_t kk;                      // rank sought inside the range (1-based)
  uint32_t cnt;                     // keys inside the range
  uint32_t own_less = 0, own_in;
};

struct Shared {
  uint32_t* hist4;
  uint32_t* hist;
  uint32_t* total;
  uint32_t* misc;
  uint2* gather;
};

// Folds the copies, adds the cluster's histograms (this block's alone when
// `local`) and fixes the digit at `shift` (`width` bits) that holds the
// kk-th key.
__device__ void fix_digit(cg::cluster_group& cluster, const Shared& sh, State& st,
                          int shift, int width, bool local = false) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned C = cluster.num_blocks();
  __syncthreads();         // the pass's counts are in
  for (int bin = tid; bin < kBins; bin += kThreads) {
    uint4* h4 = reinterpret_cast<uint4*>(sh.hist4) + bin;
    const uint4 h = *h4;
    sh.hist[bin] = h.x + h.y + h.z + h.w;
    *h4 = make_uint4(0, 0, 0, 0);
  }
  const uint32_t* total = sh.hist;
  if (local) {
    __syncthreads();
  } else {
    cluster.sync();
    for (int bin = tid; bin < kBins; bin += kThreads) {
      uint32_t s = 0;
      for (unsigned r = 0; r < C; ++r) s += cluster.map_shared_rank(sh.hist, r)[bin];
      sh.total[bin] = s;
    }
    cluster.sync();        // peers have read this block's hist
    total = sh.total;
  }
  // the bin holding the kk-th key: thread t owns bins 4t .. 4t + 3
  const uint4 c = reinterpret_cast<const uint4*>(total)[tid];
  const uint32_t cs[4] = {c.x, c.y, c.z, c.w};
  const uint32_t s = c.x + c.y + c.z + c.w;
  uint32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  uint32_t* red = sh.misc + kRed;
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  uint32_t run = incl - s;
  for (int w = 0; w < warp; ++w) run += red[w];
  if (run < st.kk && st.kk <= run + s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (st.kk <= run + cs[j]) {
        sh.misc[kSel] = 4 * tid + j;
        sh.misc[kSel + 1] = run;
        break;
      }
      run += cs[j];
    }
  }
  __syncthreads();
  const uint32_t b = sh.misc[kSel], below = sh.misc[kSel + 1];
  // this block's keys below the bin, and in it
  const uint4 h = reinterpret_cast<const uint4*>(sh.hist)[tid];
  const uint32_t hs[4] = {h.x, h.y, h.z, h.w};
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (uint32_t(4 * tid + j) < b) mine += hs[j];
  const uint32_t own_below = block_sum(mine, red);
  st.own_less += own_below;
  st.own_in = sh.hist[b];
  st.less += below;
  st.kk -= below;
  st.cnt = total[b];
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
      if ((u & st.pmask) == st.prefix) count(sh.hist4, u, shift, lane);
    }
  }
}

__device__ void gather_histogram(const Shared& sh, const State& st, int n, int shift) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const uint32_t u = sh.gather[j].x;
    if ((u & st.pmask) == st.prefix) count(sh.hist4, u, shift, lane);
  }
}

constexpr int kRuns = 32, kRunLen = 64;
constexpr int kSamples = kRuns * kRunLen;         // 2048: 4 a thread

// The r-th smallest (1-based) of kSamples keys read in kRuns runs of
// kRunLen columns spread evenly over the live columns, selected by this
// block alone: every block of the cluster reads the same keys and finds
// the same bound.  The keys live in the gather buffer meanwhile.
__device__ uint32_t sample_bound(cg::cluster_group& cluster, const RowPart& part,
                                 const Shared& sh, int n_valid, uint32_t r) {
  uint32_t* keys = reinterpret_cast<uint32_t*>(sh.gather);
  const int tid = threadIdx.x, lane = tid & 31;
  constexpr int kPerRun = kThreads / kRuns;
  const int run = tid / kPerRun;
  const int at = int((long long)run * (n_valid - kRunLen) / (kRuns - 1)) +
                 4 * (tid % kPerRun);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    keys[4 * tid + j] = order_bits(__ldg(part.row + at + j), part.largest);
  __syncthreads();
  State s;
  s.kk = r;
  s.cnt = kSamples;
  s.own_in = 0;
  for (int level = 0; level <= 2; ++level) {
    for (int j = tid; j < kSamples; j += kThreads) {
      const uint32_t u = keys[j];
      if ((u & s.pmask) == s.prefix) count(sh.hist4, u, digit_shift(level), lane);
    }
    fix_digit(cluster, sh, s, digit_shift(level), digit_width(level), true);
  }
  return s.prefix;
}

// Gathers this block's keys at or below `bound` into the gather buffer in
// row order (the first kGatherCap of them); returns how many there are.
__device__ uint32_t row_gather_le(const RowPart& part, const Shared& sh, uint32_t bound) {
  const int nb = part.batches();
  uint32_t run = 0;
  float nxt[kItems];
  if (nb > 0) part.load(0, nxt);
  for (int b = 0; b < nb; ++b) {
    float cur[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) cur[i] = nxt[i];
    if (b + 1 < nb) part.load(b + 1, nxt);
    const int i0 = part.first(b);
    uint32_t f = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i0 + i >= part.end) break;
      if (order_bits(cur[i], part.largest) <= bound) f |= 1u << i;
    }
    if (!__syncthreads_or(f)) continue;
    uint32_t tot;
    uint32_t r = run + scan_pair(__popc(f), sh.misc + ((b & 1) ? kScanB : kScanA), tot);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (f >> i & 1u) {
        if (r < uint32_t(kGatherCap))
          sh.gather[r] = make_uint2(order_bits(cur[i], part.largest), i0 + i);
        ++r;
      }
    }
    run += tot & 0xffffu;
  }
  return run;
}

// Where the pairs of a compaction go.  Keys below the range (`a`) take
// list slots a_base + their rank; keys in it (`b`) either are ties of a
// fully fixed key (slot b_base + rank while the rank is below `take`) or
// are gathered into this block's shared memory.
struct Sink {
  uint2* list;
  uint2* gather;
  uint32_t a_run, b_run;            // this block's first ranks
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
                                    sh.misc + ((b & 1) ? kScanB : kScanA), tot);
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
      const uint32_t u = sh.gather[i0 + i].x;
      if (u < st.prefix) fa |= 1u << i;
      else if (u == st.prefix) fb |= 1u << i;
    }
    if (!__syncthreads_or(fa | fb)) continue;
    uint32_t tot;
    const uint32_t excl = scan_pair(__popc(fa) | (__popc(fb) << 16),
                                    sh.misc + ((b & 1) ? kScanB : kScanA), tot);
    uint32_t ra = sink.a_run + (excl & 0xffffu), rb = sink.b_run + (excl >> 16);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if ((fa | fb) >> i & 1u) {
        const uint2 e = sh.gather[i0 + i];
        if (fa >> i & 1u) sink.put_a(ra++, e.x, int(e.y));
        else sink.put_b(rb++, e.x, int(e.y));
      }
    }
    sink.a_run += tot & 0xffffu;
    sink.b_run += tot >> 16;
  }
}

// Stable LSD radix sort of n (key, column) pairs on the key, 8-bit digits;
// `scr` holds kWarps * 256 + 512 words.  Returns the buffer holding the
// result (a or b).
__device__ uint2* lsd_sort(uint2* a, uint2* b, int n, uint32_t* scr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* wcnt = scr;                       // [kWarps][256]
  uint32_t* base = scr + kWarps * 256;        // [256]
  uint32_t* cnt = base + 256;                 // [256]
  for (int shift = 0; shift < 32; shift += 8) {
    if (tid < 256) cnt[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) atomicAdd(&cnt[(a[i].x >> shift) & 255u], 1u);
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
      const uint32_t d = valid ? (e.x >> shift) & 255u : 256u;
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

__global__ void __launch_bounds__(kThreads, 2)
topk_select_kernel(const float* __restrict__ dist, float* __restrict__ out_v,
                   int* __restrict__ out_i, uint2* __restrict__ scratch, int N, int k,
                   int n_valid, int largest, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x / C;
  Shared sh;
  sh.hist4 = reinterpret_cast<uint32_t*>(smem + kOffHist4);
  sh.hist = reinterpret_cast<uint32_t*>(smem + kOffHist);
  sh.total = reinterpret_cast<uint32_t*>(smem + kOffTotal);
  sh.misc = reinterpret_cast<uint32_t*>(smem + kOffMisc);
  sh.gather = reinterpret_cast<uint2*>(smem + kOffGather);
  // the (key, column) list: the first block's shared memory, or scratch
  uint2* list = k <= kSortCap
                    ? cluster.map_shared_rank(reinterpret_cast<uint2*>(smem + kOffSort), 0)
                    : scratch + row * 2 * size_t(k);

  const float* rowp = dist + row * size_t(N);
  const int seg = ((n_valid + int(C) - 1) / int(C) + kItems - 1) / kItems * kItems;
  RowPart part;
  part.row = rowp;
  part.begin = min(int(rank) * seg, n_valid);
  part.end = min(part.begin + seg, n_valid);
  part.vec = vec;
  part.largest = largest;

  for (int j = tid; j < kBins * kCopies; j += kThreads) sh.hist4[j] = 0;
  __syncthreads();
  uint32_t* pub = sh.misc + kPub;
  State st;
  st.kk = uint32_t(k);
  int level = -1, n = 0;                    // n: this block's gathered keys
  bool gathered = false;
  uint32_t less_row = 0;
  // the sampled bound: rank r among the samples puts about 2k plus a
  // margin of the row's keys below it, if they fit the cluster's buffers
  const long long r = (2LL * k * kSamples + n_valid - 1) / n_valid + 16;
  if (n_valid >= 4 * kSamples && r <= kSamples / 4 &&
      r * n_valid <= (long long)kGatherCap * C * kSamples / 2) {
    const uint32_t bound = sample_bound(cluster, part, sh, n_valid, uint32_t(r));
    const uint32_t own = row_gather_le(part, sh, bound);
    if (tid == 0) pub[4] = own;
    cluster.sync();
    uint32_t total = 0, most = 0;
    for (unsigned q = 0; q < C; ++q) {
      const uint32_t c = cluster.map_shared_rank(pub, q)[4];
      total += c;
      most = max(most, c);
    }
    if (total >= uint32_t(k) && most <= uint32_t(kGatherCap)) {
      gathered = true;
      n = int(own);
      st.cnt = total;
    }
  }
  if (!gathered) {                          // radix select over the row
    st.cnt = uint32_t(n_valid);
    st.own_in = uint32_t(part.end - part.begin);
    for (level = 0;; ++level) {
      row_histogram(part, sh, st, digit_shift(level));
      fix_digit(cluster, sh, st, digit_shift(level), digit_width(level));
      if (level == 2 || st.cnt <= uint32_t(kGatherCap)) break;
    }
    const bool fixed = level == 2;
    if (tid == 0) { pub[0] = st.own_less; pub[1] = st.own_in; }
    cluster.sync();
    uint32_t off_a = 0, off_b = 0;
    for (unsigned q = 0; q < rank; ++q) {
      const uint32_t* p = cluster.map_shared_rank(pub, q);
      off_a += p[0];
      off_b += p[1];
    }
    less_row = st.less;
    Sink sink;
    sink.list = list;
    sink.gather = sh.gather;
    sink.a_run = off_a;
    sink.b_run = fixed ? off_b : 0u;
    sink.b_base = less_row;
    sink.take = st.kk;
    sink.ties = fixed;
    row_compact(part, sh, st, sink);
    gathered = !fixed;
    n = int(st.own_in);
  }
  if (gathered) {                           // finish on the gathered keys
    __syncthreads();
    st.own_less = 0;
    for (++level; level <= 2; ++level) {
      gather_histogram(sh, st, n, digit_shift(level));
      fix_digit(cluster, sh, st, digit_shift(level), digit_width(level));
    }
    if (tid == 0) { pub[2] = st.own_less; pub[3] = st.own_in; }
    cluster.sync();
    uint32_t off_a = 0, off_b = 0;
    for (unsigned q = 0; q < rank; ++q) {
      const uint32_t* p = cluster.map_shared_rank(pub, q);
      off_a += p[2];
      off_b += p[3];
    }
    Sink sink;
    sink.list = list;
    sink.gather = sh.gather;
    sink.a_run = less_row + off_a;
    sink.b_run = off_b;
    sink.b_base = st.less;
    sink.take = st.kk;
    sink.ties = true;
    gather_compact(sh, st, n, sink);
  }
  cluster.sync();                          // the whole list is written
  if (rank != 0) return;
  const uint2* sorted = lsd_sort(list, list + k, k, sh.hist4);
  const size_t o = row * size_t(k);
  for (int j = tid; j < k; j += kThreads) {
    const uint2 e = sorted[j];
    out_i[o + j] = int(e.y);
    out_v[o + j] = rowp[e.y];
  }
}

}  // namespace

// dist (M, N) float32 row-major; out_v (M, k) float32, out_i (M, k) int32;
// scratch: M * 2k (key, column) pairs of 8 bytes when k > 8192, else
// nullptr.  1 <= k <= n_valid <= N; cluster 1, 2, 4 or 8 blocks a row.
// Returns a cudaError_t code.
extern "C" int c4cam_topk_select(const float* dist, float* out_v, int* out_i,
                                 void* scratch, int M, int N, int k, int n_valid,
                                 int largest, int cluster, void* stream) {
  if (M <= 0 || N <= 0 || k < 1 || n_valid < k || n_valid > N ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) ||
      (k > kSortCap && scratch == nullptr) ||
      (long long)M * cluster > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int vec = (reinterpret_cast<uintptr_t>(dist) % 16 == 0) && (N % 4 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(M * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, topk_select_kernel, dist, out_v, out_i,
                           static_cast<uint2*>(scratch), N, k, n_valid, largest, vec);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
