// hdc_encode: record-based HDC hypervector encoding, bit-sliced (sm_90a).
//
// Replaces the TPU kernel `hdc_encode_pallas` (src/repro/kernels/hdc_encode.py,
// body `_encode_kernel`).  For level ids q (M, F), keys (F, H) and levels
// (L, H) with cells in {-1, 0, +1} it writes
//
//     out[m, h] = sum_f keys[f, h] * levels[q[m, f], h] >= 0 ? +1.f : -1.f
//
// as float32 (M, H).  The TPU kernel sums L one-hot matrix products because
// its matrix unit cannot gather; here the cells are bits.  Keys and levels
// arrive as 32-dim words of two bit planes (`hdc_encode.hdc_planes`):
// sign (bit = 1 for -1) and care (bit = 1 for a nonzero cell), with one
// extra all-zero level row L.  A product keys * levels is -1 exactly where
// neg = (sk ^ sl) & (ck & cl) is set and +1 where the care bits are set
// and neg is not, so the sum is  care_count - 2 * neg_count  per dim and
// the sign is +1 where  2 * neg_count <= care_count  (a zero sum, F even,
// gives +1 as the reference's bundle does).  Every count is an exact
// integer: the result is bit-identical to the reference.  An id outside
// [0, L), and a feature past F, reads the zero row: it adds nothing.
//
// Counting.  A thread owns one word (32 dims) of 4 query rows and keeps per
// row the counts as bit planes: plane b holds bit b of every dim's count.
// Each group of 16 features goes through a carry-save tree of full adders
// (sum = a ^ b ^ c and carry = majority, one LOP3 each) into planes 0..3,
// and the tree's carry of weight 16 ripples into planes 4..kPlanes-1 by half
// adders.  The sign is a bit-sliced compare from the top plane down.  Two
// routes, by what the planes' builder found:
//
// * no zero cell (the item memory's keys and levels are +-1): care is all
//   ones, so care_count is the number of in-range ids of the row, counted
//   while the ids are staged, and neg is one LOP3: sk ^ sl where every id of
//   the stage is in range (the sign words alone are read), (sk ^ sl) & cl
//   otherwise (cl masks the zero row).  Per 16 (row, feature, word) steps:
//   16 for neg, 15 full adders (30 LOP3), 2 (kPlanes - 4) for the ripple: at
//   F < 1024 (kPlanes 10) 58 logical operations, 3.625 a step.
// * zero cells: care = ck & cl and neg = (sk ^ sl) & care (2 LOP3), and
//   care counted the same way: 7.25 a step at kPlanes 10.
//
// Bound on an H100 SXM: the no-zero route's 3.625 logical operations per
// (row, feature, word) at 64 per clock per SM (CUDA C++ Programming Guide,
// compute capability 9.0: 32-bit AND, OR, XOR) x 132 SMs x 1.98 GHz; at the
// HDC/MNIST-8k test set (10,000 x 784 x 256 words) 0.435 ms, against 0.10 ms
// to read the int32 ids and write the 328 MB float32 output at 3.35 TB/s.
// (The earlier gather form's basis, four int8 products per IDP4A, was
// 0.960 ms.)  The design keeps the operands of the inner loop on chip: a
// block owns 32 words (1024 dims) of 32 queries, two blocks an SM; the
// level planes of its words (all L + 1 rows, as (sign, care) pairs and as
// sign words) sit in shared memory, and the ids (as byte offsets of their
// level row) and key planes stream through it 64 features at a time, the
// next stage copied by cp.async while this one is counted.  A warp owns 4
// queries and a lane one word; per (row, feature) a lane reads four ids at
// once (one broadcast 16-byte load) and one level word of its own, and the
// key planes of a feature stay in registers across the rows.  The output is
// written as float4 stores of 512 contiguous bytes a warp, each lane taking
// its words' sign masks by shuffle.
//
// Size limits lifted (the reference's encode has none):
// * rows: the row blocks run over gridDim.y and gridDim.z (65,535 each), so
//   any int M fits one launch; a block past M exits before its first
//   barrier.
// * features: F >= 2^16 counts in 32 bit planes (kPlanes 32, any int F),
//   compiled at one block an SM so the counters may take up to 255
//   registers.
// * levels: where the (L + 1) x 32 level words of a block do not fit in
//   shared memory beside the stages (more than 476 levels), the inner loop
//   reads them from global memory (the table stays in L2) through the
//   read-only path; the staged ids then hold level-row indices, not byte
//   offsets.
// Each route counts the same integers: every one is bit-identical to the
// reference.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 32;      // words per block: a lane each
constexpr int kChunkF = 64;     // features per shared-memory stage
constexpr int kGroup = 16;      // features per carry-save tree
constexpr int kRows = 4;        // query rows a warp owns
constexpr int kBlockM = kWarps * kRows;

// three-input logic: f(a, b, c) for the truth table `lut` of a = 0xF0,
// b = 0xCC, c = 0xAA
template <int kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
}
constexpr int kXor3 = 0x96;       // a ^ b ^ c
constexpr int kMaj = 0xE8;        // at least two of a, b, c
constexpr int kXorAnd = 0x28;     // (a ^ b) & c

// full adder: p + x + y = sum + 2 carry, bitwise; p takes the sum
__device__ __forceinline__ uint32_t fa(uint32_t& p, uint32_t x, uint32_t y) {
  const uint32_t carry = lop3<kMaj>(p, x, y);
  p = lop3<kXor3>(p, x, y);
  return carry;
}

// Add the 16 words `x` (bit i of each one dim) to the bit-sliced counts
// `planes`.
template <int kPlanes>
__device__ __forceinline__ void add16(uint32_t (&planes)[kPlanes],
                                      const uint32_t (&x)[kGroup]) {
  uint32_t c1[8], c2[4], c3[2];
#pragma unroll
  for (int i = 0; i < 8; ++i) c1[i] = fa(planes[0], x[2 * i], x[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c2[i] = fa(planes[1], c1[2 * i], c1[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) c3[i] = fa(planes[2], c2[2 * i], c2[2 * i + 1]);
  uint32_t carry = fa(planes[3], c3[0], c3[1]);
#pragma unroll
  for (int b = 4; b < kPlanes; ++b) {        // half adders
    const uint32_t next = planes[b] & carry;
    planes[b] ^= carry;
    carry = next;
  }
}

// Asynchronous 4- and 8-byte copies from device to shared memory; with
// `ok` false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok,
                                         int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 8 : 0) : "memory");
}

// Shared memory of a block, in bytes: two stages of key planes, the raw
// ids of the next stage, the current stage's ids as byte offsets of their
// level row, a count per query, then the level planes.
constexpr int kKeyStage = kChunkF * kWords * 8;
constexpr int kIdStage = kBlockM * kChunkF * 4;
constexpr int kLevelsAt = 2 * kKeyStage + 2 * kIdStage + kBlockM * 4;

// kCare: the zero-cell route (care counted); kPlanes: count bits, F <
// 2^kPlanes; kGlobal: the level planes are read from global memory.
template <bool kCare, int kPlanes, bool kGlobal>
__global__ void __launch_bounds__(kThreads, kPlanes > 16 ? 1 : 2)
hdc_encode_kernel(const int* __restrict__ q, const uint2* __restrict__ key_planes,
                  const uint2* __restrict__ level_planes, float* __restrict__ out,
                  int M, int F, int H, int W, int L) {
  constexpr int kIds = kBlockM * kChunkF / kThreads;     // copied by a thread
  constexpr int kKeys = kChunkF * kWords / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* k_s = reinterpret_cast<uint2*>(smem);             // [2][64 x 32]
  int* raw_s = reinterpret_cast<int*>(smem + 2 * kKeyStage);
  int* q_s = raw_s + kBlockM * kChunkF;
  int* bad_s = q_s + kBlockM * kChunkF;                    // ids outside [0, L)
  uint2* l_pair = reinterpret_cast<uint2*>(smem + kLevelsAt);   // (L + 1) x 32
  uint32_t* l_sign = reinterpret_cast<uint32_t*>(l_pair + (L + 1) * kWords);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = (blockIdx.y + blockIdx.z * gridDim.y) * kBlockM;
  if (m0 >= M) return;                       // block-uniform, before barriers
  const int w0 = blockIdx.x * kWords;

  // the next stage's ids and key planes are copied while this one is counted
  auto issue = [&](int f0, int stage) {
#pragma unroll
    for (int j = 0; j < kIds; ++j) {
      const int i = tid + j * kThreads;
      const int m = m0 + i / kChunkF, f = f0 + i % kChunkF;
      const bool ok = m < M && f < F;
      cp_async(raw_s + i, ok ? q + size_t(m) * F + f : q, ok, 4);
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int i = tid + j * kThreads;
      const int f = f0 + i / kWords, w = w0 + i % kWords;
      const bool ok = f < F && w < W;
      cp_async(k_s + stage * kChunkF * kWords + i,
               ok ? key_planes + size_t(f) * W + w : key_planes, ok, 8);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // a thread's own copied ids -> byte offsets of their level row; returns
  // whether one of them was outside [0, L)
  auto offsets = [&](int f0) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    int bad = 0;
#pragma unroll
    for (int j = 0; j < kIds; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunkF, f = f0 + i % kChunkF;
      int v = raw_s[i];
      if (m0 + r >= M || f >= F) {
        v = L;
      } else if (static_cast<unsigned>(v) >= static_cast<unsigned>(L)) {
        if constexpr (!kCare) atomicAdd(&bad_s[r], 1);
        bad = 1;
        v = L;
      }
      q_s[i] = kGlobal ? v : v * kWords * int(sizeof(uint2));
    }
    return bad;
  };

  issue(0, 0);
  if constexpr (!kGlobal) {
    for (int i = tid; i < (L + 1) * kWords; i += kThreads) {
      const int l = i / kWords, w = w0 + i % kWords;
      const uint2 v = w < W ? level_planes[size_t(l) * W + w] : make_uint2(0u, 0u);
      l_pair[i] = v;
      l_sign[i] = v.x;
    }
  }
  if (tid < kBlockM) bad_s[tid] = 0;
  __syncthreads();

  uint32_t neg[kRows][kPlanes], care[kCare ? kRows : 1][kPlanes];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int b = 0; b < kPlanes; ++b) {
      neg[r][b] = 0u;
      if constexpr (kCare) care[r][b] = 0u;
    }

  const unsigned char* pair_lane = reinterpret_cast<const unsigned char*>(l_pair + lane);
  const unsigned char* sign_lane = reinterpret_cast<const unsigned char*>(l_sign + lane);
  // the global route's column of this lane (a lane past W reads a real
  // word; its output is never written)
  const uint2* g_lane = level_planes + min(w0 + lane, W - 1);
  const int f_pad = (F + kGroup - 1) / kGroup * kGroup;
  // no zero cell and every id of the stage in range: sign words suffice
  bool fast = !__syncthreads_or(offsets(0)) && !kCare;
  for (int f0 = 0, stage = 0; f0 < f_pad; f0 += kChunkF, stage ^= 1) {
    const bool more = f0 + kChunkF < f_pad;
    if (more) issue(f0 + kChunkF, stage ^ 1);
    const uint2* keys = k_s + stage * kChunkF * kWords;
    const int groups = min(kChunkF, f_pad - f0) / kGroup;
    for (int g = 0; g < groups; ++g) {
      uint32_t ks[kGroup], kc[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const uint2 k = keys[(g * kGroup + i) * kWords + lane];
        ks[i] = k.x;
        kc[i] = k.y;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int4* ids = reinterpret_cast<const int4*>(
            q_s + (warp * kRows + r) * kChunkF + g * kGroup);
        int off[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup / 4; ++j) {
          const int4 v = ids[j];
          off[4 * j] = v.x; off[4 * j + 1] = v.y; off[4 * j + 2] = v.z; off[4 * j + 3] = v.w;
        }
        uint32_t x[kGroup], y[kGroup];
        if (fast) {
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            if constexpr (kGlobal)
              x[i] = ks[i] ^ __ldg(reinterpret_cast<const unsigned int*>(
                                 g_lane + size_t(off[i]) * W));
            else
              x[i] = ks[i] ^ *reinterpret_cast<const uint32_t*>(sign_lane + (off[i] >> 1));
          }
        } else {
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const uint2 lv = kGlobal ? __ldg(g_lane + size_t(off[i]) * W)
                                     : *reinterpret_cast<const uint2*>(pair_lane + off[i]);
            if constexpr (kCare) {
              y[i] = kc[i] & lv.y;
              x[i] = lop3<kXorAnd>(ks[i], lv.x, y[i]);
            } else {
              x[i] = lop3<kXorAnd>(ks[i], lv.x, lv.y);
            }
          }
        }
        add16<kPlanes>(neg[r], x);
        if constexpr (kCare) add16<kPlanes>(care[kCare ? r : 0], y);
      }
    }
    if (more) {
      __syncthreads();                     // every warp is done with q_s
      fast = !__syncthreads_or(offsets(f0 + kChunkF)) && !kCare;
    }
  }

  // ---- signs, then 32 floats a word ----
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + warp * kRows + r;
    if (m >= M) break;                                  // warp-uniform
    uint32_t lt = 0u, eq = ~0u;                         // bitwise compare
    if constexpr (kCare) {
      // 2 neg <= care, from bit kPlanes down: bit b of 2 neg is bit b - 1
#pragma unroll
      for (int b = kPlanes; b >= 0; --b) {
        const uint32_t a = b > 0 ? neg[r][b - 1] : 0u;
        const uint32_t c = b < kPlanes ? care[kCare ? r : 0][b] : 0u;
        lt |= eq & ~a & c;
        eq &= ~(a ^ c);
      }
    } else {
      // neg <= floor(in-range ids / 2)
      const int t = (F - bad_s[warp * kRows + r]) >> 1;
#pragma unroll
      for (int b = kPlanes - 1; b >= 0; --b) {
        const uint32_t tb = (t >> b) & 1 ? ~0u : 0u;
        lt |= eq & ~neg[r][b] & tb;
        eq &= ~(neg[r][b] ^ tb);
      }
    }
    const uint32_t pos = lt | eq;                       // bit set: +1
    float* orow = out + size_t(m) * H;
#pragma unroll
    for (int s = 0; s < kWords / 4; ++s) {
      // lanes 8 u .. 8 u + 7 write word 4 s + u, 16 bytes each
      const uint32_t p = __shfl_sync(0xffffffffu, pos, 4 * s + lane / 8);
      const int sub = 4 * (lane % 8);
      const int h = (w0 + 4 * s + lane / 8) * 32 + sub;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __uint_as_float(0xBF800000u ^ (((p >> (sub + e)) & 1u) << 31));
      if ((H & 3) == 0 && h + 3 < H) {
        *reinterpret_cast<float4*>(orow + h) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (h + e < H) orow[h + e] = v[e];
      }
    }
  }
}

template <bool kCare, int kPlanes, bool kGlobal>
int launch(const int* q, const uint2* kp, const uint2* lp, float* out, int M, int F,
           int H, int W, int L, cudaStream_t s) {
  auto kernel = hdc_encode_kernel<kCare, kPlanes, kGlobal>;
  const long long dyn =
      kLevelsAt +
      (kGlobal ? 0LL : (L + 1LL) * kWords * int(sizeof(uint2) + sizeof(uint32_t)));
  if (dyn > 232448) return int(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dyn));
  if (e != cudaSuccess) return int(e);
  // row blocks over y, then z: 65,535 x 65,535 blocks of 32 rows
  const long long rblocks = (M + kBlockM - 1) / kBlockM;
  const unsigned gy = unsigned(rblocks < 65535 ? rblocks : 65535);
  const dim3 grid((W + kWords - 1) / kWords, gy, unsigned((rblocks + gy - 1) / gy));
  kernel<<<grid, kThreads, int(dyn), s>>>(q, kp, lp, out, M, F, H, W, L);
  return int(cudaGetLastError());
}

template <bool kCare>
int launch_planes(const int* q, const uint2* kp, const uint2* lp, float* out, int M,
                  int F, int H, int W, int L, int global_levels, cudaStream_t s) {
  if (global_levels) {
    if (F < (1 << 16)) return launch<kCare, 16, true>(q, kp, lp, out, M, F, H, W, L, s);
    return launch<kCare, 32, true>(q, kp, lp, out, M, F, H, W, L, s);
  }
  if (F < (1 << 8)) return launch<kCare, 8, false>(q, kp, lp, out, M, F, H, W, L, s);
  if (F < (1 << 10)) return launch<kCare, 10, false>(q, kp, lp, out, M, F, H, W, L, s);
  if (F < (1 << 12)) return launch<kCare, 12, false>(q, kp, lp, out, M, F, H, W, L, s);
  if (F < (1 << 16)) return launch<kCare, 16, false>(q, kp, lp, out, M, F, H, W, L, s);
  return launch<kCare, 32, false>(q, kp, lp, out, M, F, H, W, L, s);
}

}  // namespace

// q (M, F) int32; key_planes (F, W, 2) and level_planes (L + 1, W, 2)
// int32 (sign, care) words, row-major, W = ceil(H / 32), bits past H and
// level row L zero; out (M, H) float32.  care: 0 when no cell of keys or
// levels is zero.  global_levels: read the level planes from global memory
// (when they do not fit in shared memory).  Returns a cudaError_t code.
extern "C" int c4cam_hdc_encode(const int* q, const int* key_planes,
                                const int* level_planes, float* out, int M, int F,
                                int H, int W, int L, int care, int global_levels,
                                void* stream) {
  if (M <= 0 || F <= 0 || H <= 0 || L <= 0 || W != (H + 31) / 32)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint2* kp = reinterpret_cast<const uint2*>(key_planes);
  const uint2* lp = reinterpret_cast<const uint2*>(level_planes);
  return care ? launch_planes<true>(q, kp, lp, out, M, F, H, W, L, global_levels, s)
              : launch_planes<false>(q, kp, lp, out, M, F, H, W, L, global_levels, s);
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
