// slstm_scan (X1): the sLSTM recurrence over a whole sequence in one
// launch (sm_90a).
//
// Replaces no TPU kernel: the reference runs the recurrence as its `step`
// (src/repro/models/xlstm.py:197) under `lax.scan` (:213), and the port's
// eager counterpart (`slstm_scan.slstm_scan_reference`, the plain version)
// launches about 15 kernels a position.  Per position t, for each batch
// row, with h, c, n, m the carried state (each (B, D) float32):
//
//   g = pre_t + h @ wh                  (pre (B, S, 4D), wh (D, 4D) float32)
//   z, i, f, o = the four D-wide column blocks of g
//   logf = logsigmoid(f);  m_t = max(logf + m, i)
//   c = exp(logf + m - m_t) c + exp(i - m_t) tanh(z)
//   n = exp(logf + m - m_t) n + exp(i - m_t)
//   h = sigmoid(o) c / max(|n|, 1);  m = m_t
//
// writing every h into hs (B, S, D) and the final state.  h @ wh is a
// float32 FMA product (no TF32, as the reference's parity paths ask);
// each elementwise step rounds as PyTorch's eager operations round (no
// contraction into FMAs), with the same logsigmoid, sigmoid and exp.
//
// Bound on an H100 SXM: the recurrence is serial in t, so its least time
// is S steps of one step's latency; its bytes (pre read once, hs written
// once) and its 8 B D^2 S FLOP are far below that at D 768.  The design
// makes a step as short a chain as it can:
//
// * A warp a hidden unit.  Block g's eight warps own the units
//   [8 g, 8 g + 8); lane l of a warp holds, in registers for the whole
//   launch, the unit's four columns of wh (z, i, f, o) at the rows
//   k = l + 32 m.  A step's product is then 4 independent FMA chains of
//   D / 32 a lane and row, with h read from shared memory, and a warp
//   reduction (a reduce-scatter by shuffles: the 4 R sums of a pass over
//   the 32 lanes) leaves each gate sum in a lane; no shared-memory partial
//   sums and no block barrier between the product and the gates.
// * A flagged hand-off instead of a grid barrier, as NCCL's LL protocol
//   does: a new h leaves as one aligned 64-bit store of (value, tag t + 1)
//   into a double buffer of words (step t writes buffer t & 1), and the
//   block that needs it polls the words with relaxed loads until their
//   tags say t + 1.  One L2 round trip replaces the barrier plus the h
//   load.  A tag never matches a word of an earlier launch, layer call or
//   graph replay: the wrapper zeroes the words on its stream before each
//   launch (a fill a CUDA graph records), and tags start at 1.  The double
//   buffer is free to rewrite: a block writes step t + 1's words only
//   after it has read every block's step t words, which those blocks wrote
//   only after reading step t - 1's.
// * One block barrier a pass: the polled h goes into a shared-memory
//   double buffer the warps read; the next step's pre values are loaded
//   right after a step's are used, so their latency hides behind the
//   hand-off.
// * Batch 1, the prefill's shape, runs slstm_scan1_kernel: one row, the
//   gate lane's c, n and m in registers, nothing read from shared memory
//   between the product and the publish.  Other batches run
//   slstm_scan_kernel in passes of 8 rows, the state in shared memory.
//
// Co-residency is what the polling needs: the launch is cooperative
// (cudaLaunchAttributeCooperative), which fails rather than deadlocks
// when the grid cannot be resident at once; it also captures in CUDA
// graphs.  The float32 sums run in another order than the plain loop's
// (X1_TOL holds them).  Offsets are 64-bit: pre at 524,288 positions
// holds 1.6e9 elements.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kUnits = 8;                 // hidden units a block owns
constexpr int kThreads = 32 * kUnits;     // a warp a unit
constexpr int kMaxBatch = 64;
constexpr int kMaxD = 1024;
constexpr int kRows = 8;                  // batch rows a pass of the batched kernel holds
constexpr int kPoll = 8;                  // words a thread polls at once
constexpr unsigned kPollLimit = 1u << 26; // polls of one word before a trap

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// (value, tag) as one 64-bit word: the tag in the high half
__device__ __forceinline__ unsigned long long pack(float h, unsigned int tag) {
  return (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(h);
}

// n words from `src` into `dst` as floats, each once its tag is `tag`:
// a thread polls kPoll words at a time, their loads issued together.  A
// word still not there after kPollLimit polls (about a minute) traps: a launch
// fails rather than hangs.
__device__ __forceinline__ void poll_words(const unsigned long long* src, float* dst, int n,
                                           unsigned int tag) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kPoll * kThreads) {
    unsigned int pending = 0;
#pragma unroll
    for (int u = 0; u < kPoll; ++u)
      if (e0 + u * kThreads < n) pending |= 1u << u;
    for (unsigned polls = 0; pending; ++polls) {
      if (polls == kPollLimit) __trap();
      unsigned long long w[kPoll];
#pragma unroll
      for (int u = 0; u < kPoll; ++u)
        if (pending & (1u << u)) w[u] = ld_word(src + e0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < kPoll; ++u)
        if ((pending & (1u << u)) && static_cast<unsigned int>(w[u] >> 32) == tag) {
          dst[e0 + u * kThreads] = __uint_as_float(static_cast<unsigned int>(w[u]));
          pending &= ~(1u << u);
        }
    }
  }
}

// Reduce-scatter of kV values over the warp's 32 lanes (kV a power of 2
// up to 32): returns the warp's sum of value lane / (32 / kV), in a fixed
// order.  Each halving step hands half of the lane's values to its
// partner and keeps the other half; past kV / 2 steps the rest is a
// butterfly.
template <int kV>
__device__ __forceinline__ float reduce_scatter(float (&v)[kV], int lane) {
  int n = kV;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (n > 1) {
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < kV / 2; ++i) {
        if (i < n / 2) {
          const float send = upper ? v[i] : v[i + n / 2];
          const float keep = upper ? v[i + n / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
  return v[0];
}

// Dynamic shared memory of a launch: the pass's h rows, double-buffered,
// and (batched) the c, n, m state of the block's units.
size_t smem_bytes(int rows, int batch, int d) {
  return sizeof(float) * (size_t(2) * rows * d + (batch > 1 ? size_t(3) * batch * kUnits : 0));
}

// Batch 2 to 64 in passes of kRows rows.  kKpl: rows of wh a lane holds
// (k = lane + 32 m, m < kKpl, kKpl >= D / 32).
template <int kKpl>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const float* __restrict__ pre, const float* __restrict__ wh,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ hs, float* __restrict__ h_out,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, unsigned long long* words,
                  float* __restrict__ snap, int64_t snap_t, int batch, int64_t seq,
                  int d) {
  constexpr int kR = kRows, kV = 4 * kR, kSpread = 32 / kV;
  constexpr int kMaxPass = kMaxBatch / kR;
  extern __shared__ __align__(16) float smem[];
  float* hsm = smem;                                  // [2][kR][d]
  float* cs = hsm + 2 * kR * d;                       // [batch][kUnits]
  float* ns = cs + batch * kUnits;
  float* ms = ns + batch * kUnits;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.x * kUnits + warp;
  const bool live = unit < d;
  const int64_t d4 = 4 * int64_t(d);
  float wr[4][kKpl];
#pragma unroll
  for (int m = 0; m < kKpl; ++m) {
    const int k = lane + 32 * m;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wr[q][m] = (live && k < d) ? wh[int64_t(k) * d4 + int64_t(q) * d + unit] : 0.f;
  }
  for (int e = tid; e < batch * kUnits; e += kThreads) {
    const int r = e / kUnits, u = blockIdx.x * kUnits + e % kUnits;
    if (u >= d) continue;
    cs[e] = c0[int64_t(r) * d + u];
    ns[e] = n0[int64_t(r) * d + u];
    ms[e] = m0[int64_t(r) * d + u];
  }
  // after the reduction this lane holds gate ql of the pass's row rl; the
  // lanes of gate 0 (one per row) run the gates
  const int j = lane / kSpread, ql = j / kR, rl = j % kR;
  const bool gate_lane = lane % kSpread == 0 && ql == 0 && live;
  const int n_pass = (batch + kR - 1) / kR;
  float pv[kMaxPass];
  auto load_pre = [&](int64_t t, int g) {
    const int r = g * kR + rl;
    pv[g] = (live && r < batch)
        ? pre[(int64_t(r) * seq + t) * d4 + int64_t(ql) * d + unit] : 0.f;
  };
#pragma unroll
  for (int g = 0; g < kMaxPass; ++g)
    if (g < n_pass) load_pre(0, g);
  const int64_t plane = int64_t(batch) * d;
  int buf = 0;

  for (int64_t t = 0; t < seq; ++t) {
#pragma unroll
    for (int g = 0; g < kMaxPass; ++g) {
      if (g >= n_pass) break;
      const int r0 = g * kR, nr = min(kR, batch - r0);
      float* hp = hsm + buf * kR * d;
      buf ^= 1;
      if (t == 0) {
        for (int e = tid; e < nr * d; e += kThreads) hp[e] = h0[int64_t(r0) * d + e];
      } else {
        poll_words(words + ((t - 1) & 1) * plane + int64_t(r0) * d, hp, nr * d,
                   unsigned(t));
      }
      __syncthreads();
      float acc[kR][4];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll
      for (int m = 0; m < kKpl; ++m) {
        const int k = lane + 32 * m;
        if (k < d) {
#pragma unroll
          for (int r = 0; r < kR; ++r)
            if (r < nr) {
              const float hv = hp[r * d + k];
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(hv, wr[q][m], acc[r][q]);
            }
        }
      }
      float v[kV];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q * kR + r] = acc[r][q];
      const float gsum = __fadd_rn(pv[g], reduce_scatter<kV>(v, lane));
      if (t + 1 < seq) load_pre(t + 1, g);
      const float z = __shfl_sync(0xffffffffu, gsum, (0 * kR + rl) * kSpread);
      const float ig = __shfl_sync(0xffffffffu, gsum, (1 * kR + rl) * kSpread);
      const float fg = __shfl_sync(0xffffffffu, gsum, (2 * kR + rl) * kSpread);
      const float og = __shfl_sync(0xffffffffu, gsum, (3 * kR + rl) * kSpread);
      const int r = r0 + rl;
      if (gate_lane && rl < nr) {
        const int e = r * kUnits + warp;
        const float logf_ = log_sigmoid(fg);
        const float lm = __fadd_rn(logf_, ms[e]);
        const float m_t = fmaxf(lm, ig);
        const float isc = expf(__fsub_rn(ig, m_t));
        const float fsc = expf(__fsub_rn(lm, m_t));
        const float c = __fadd_rn(__fmul_rn(fsc, cs[e]), __fmul_rn(isc, tanhf(z)));
        const float n = __fadd_rn(__fmul_rn(fsc, ns[e]), isc);
        const float h = __fdiv_rn(__fmul_rn(sigmoid(og), c), fmaxf(fabsf(n), 1.f));
        const int64_t at = int64_t(r) * d + unit;
        if (t + 1 < seq) st_word(words + (t & 1) * plane + at, pack(h, unsigned(t + 1)));
        cs[e] = c;
        ns[e] = n;
        ms[e] = m_t;
        hs[(int64_t(r) * seq + t) * d + unit] = h;
        if (t + 1 == seq) h_out[at] = h;
        if (t + 1 == snap_t) {         // the state entering position snap_t
          snap[at] = h;
          snap[plane + at] = c;
          snap[2 * plane + at] = n;
          snap[3 * plane + at] = m_t;
        }
      }
    }
  }
  __syncthreads();                 // the gate lanes' last state
  for (int e = tid; e < batch * kUnits; e += kThreads) {
    const int r = e / kUnits, u = blockIdx.x * kUnits + e % kUnits;
    if (u >= d) continue;
    c_out[int64_t(r) * d + u] = cs[e];
    n_out[int64_t(r) * d + u] = ns[e];
    m_out[int64_t(r) * d + u] = ms[e];
  }
}

// Batch 1, the prefill's shape: the kernel above with one row a pass and
// no pass loop, the gate lane's c, n and m in registers (the step's
// critical path reads no shared memory after the product).
template <int kKpl>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan1_kernel(const float* __restrict__ pre, const float* __restrict__ wh,
                   const float* __restrict__ h0, const float* __restrict__ c0,
                   const float* __restrict__ n0, const float* __restrict__ m0,
                   float* __restrict__ hs, float* __restrict__ h_out,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, unsigned long long* words,
                   float* __restrict__ snap, int64_t snap_t, int64_t seq, int d) {
  constexpr int kSpread = 8;                          // lanes a gate's sum
  extern __shared__ __align__(16) float smem[];       // [2][d]: h
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.x * kUnits + warp;
  const bool live = unit < d;
  const int64_t d4 = 4 * int64_t(d);
  float wr[4][kKpl];
#pragma unroll
  for (int m = 0; m < kKpl; ++m) {
    const int k = lane + 32 * m;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wr[q][m] = (live && k < d) ? wh[int64_t(k) * d4 + int64_t(q) * d + unit] : 0.f;
  }
  const int ql = lane / kSpread;                      // the gate this lane sums
  const bool gate_lane = lane == 0 && live;
  float cs = 0.f, ns = 0.f, ms = 0.f, h = 0.f;
  if (gate_lane) {
    cs = c0[unit];
    ns = n0[unit];
    ms = m0[unit];
  }
  float pv = live ? pre[int64_t(ql) * d + unit] : 0.f;
  int buf = 0;
  for (int64_t t = 0; t < seq; ++t) {
    float* hp = smem + buf * d;
    buf ^= 1;
    if (t == 0) {
      for (int e = tid; e < d; e += kThreads) hp[e] = h0[e];
    } else {
      poll_words(words + ((t - 1) & 1) * int64_t(d), hp, d, unsigned(t));
    }
    __syncthreads();
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < kKpl; ++m) {
      const int k = lane + 32 * m;
      if (k < d) {
        const float hv = hp[k];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = fmaf(hv, wr[q][m], v[q]);
      }
    }
    const float gsum = __fadd_rn(pv, reduce_scatter<4>(v, lane));
    if (t + 1 < seq) pv = live ? pre[(t + 1) * d4 + int64_t(ql) * d + unit] : 0.f;
    const float z = __shfl_sync(0xffffffffu, gsum, 0);
    const float ig = __shfl_sync(0xffffffffu, gsum, kSpread);
    const float fg = __shfl_sync(0xffffffffu, gsum, 2 * kSpread);
    const float og = __shfl_sync(0xffffffffu, gsum, 3 * kSpread);
    if (gate_lane) {
      const float logf_ = log_sigmoid(fg);
      const float lm = __fadd_rn(logf_, ms);
      const float m_t = fmaxf(lm, ig);
      const float isc = expf(__fsub_rn(ig, m_t));
      const float fsc = expf(__fsub_rn(lm, m_t));
      cs = __fadd_rn(__fmul_rn(fsc, cs), __fmul_rn(isc, tanhf(z)));
      ns = __fadd_rn(__fmul_rn(fsc, ns), isc);
      ms = m_t;
      h = __fdiv_rn(__fmul_rn(sigmoid(og), cs), fmaxf(fabsf(ns), 1.f));
      if (t + 1 < seq) st_word(words + (t & 1) * int64_t(d) + unit, pack(h, unsigned(t + 1)));
      hs[t * d + unit] = h;
      if (t + 1 == snap_t) {         // the state entering position snap_t
        snap[unit] = h;
        snap[d + unit] = cs;
        snap[2 * d + unit] = ns;
        snap[3 * d + unit] = ms;
      }
    }
  }
  if (gate_lane) {
    h_out[unit] = h;
    c_out[unit] = cs;
    n_out[unit] = ns;
    m_out[unit] = ms;
  }
}

// The flagged hand-off alone, `steps` times, over the scan's grid and
// footprint: each unit's gate lanes publish a word a row and step, every
// block polls all of them into shared memory: a step's serial floor.
template <int kR>
__global__ void __launch_bounds__(kThreads, 1)
slstm_handoff_kernel(unsigned long long* words, int batch, int64_t steps, int d) {
  constexpr int kV = 4 * kR, kSpread = 32 / kV;
  constexpr int kMaxPass = kR == 1 ? 1 : kMaxBatch / kR;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * kUnits + warp;
  const int j = lane / kSpread, rl = j % kR;
  const bool gate_lane = lane % kSpread == 0 && j / kR == 0 && unit < d;
  const int n_pass = (batch + kR - 1) / kR;
  const int64_t plane = int64_t(batch) * d;
  int buf = 0;
  for (int64_t t = 0; t < steps; ++t) {
#pragma unroll
    for (int g = 0; g < kMaxPass; ++g) {
      if (g >= n_pass) break;
      const int r0 = g * kR, nr = min(kR, batch - r0);
      float* hp = smem + buf * kR * d;
      buf ^= 1;
      if (t > 0)
        poll_words(words + ((t - 1) & 1) * plane + int64_t(r0) * d, hp, nr * d,
                   unsigned(t));
      __syncthreads();
      if (gate_lane && rl < nr && t + 1 < steps) {
        const float h = t > 0 ? hp[rl * d + unit] : 0.f;
        st_word(words + (t & 1) * plane + int64_t(r0 + rl) * d + unit,
                pack(h, unsigned(t + 1)));
      }
    }
  }
}

// The earlier design's grid barrier, kept as a probe: all blocks arrive before any
// leaves (`target` grows by gridDim.x a step; the counter is zeroed by the
// wrapper), one release increment and acquire polling by thread 0.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" : : "l"(counter) : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// The barrier alone, `steps` times, over the scan's grid: the serial
// floor of the barrier design, for the scan's bound.
__global__ void __launch_bounds__(kThreads, 1)
slstm_barrier_kernel(unsigned int* counter, int64_t steps) {
  for (int64_t t = 0; t < steps; ++t) grid_barrier(counter, unsigned(t + 1) * gridDim.x);
}

// A bit per device: whether `Kernel`'s shared-memory limit is raised there.
template <auto Kernel>
std::atomic<uint64_t>& smem_ready() {
  static std::atomic<uint64_t> ready{0};
  return ready;
}

// Raises `Kernel`'s shared-memory limit to `limit` bytes (once a device)
// and launches it cooperatively on `grid` blocks: the runtime refuses
// (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be resident at
// once.
template <auto Kernel, typename... Args>
int launch_resident(size_t limit, int grid, size_t smem, void* stream, Args... args) {
  std::atomic<uint64_t>& ready = smem_ready<Kernel>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(limit));
    if (err != cudaSuccess) return int(err);
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// the most shared memory a launch of this file's kernels asks for
const size_t kSmemLimit = smem_bytes(kRows, kMaxBatch, kMaxD);

bool bad_shape(int batch, long long steps, int d) {
  const int grid = (d + kUnits - 1) / kUnits;
  return batch <= 0 || batch > kMaxBatch || steps <= 0 || d <= 0 || d > kMaxD ||
         uint64_t(steps) >= (uint64_t(1) << 32) || grid <= 0;
}

}  // namespace

// pre (batch, seq, 4d), wh (d, 4d), h0 / c0 / n0 / m0 and the outputs
// h / c / n / m (batch, d), hs (batch, seq, d): float32, contiguous.
// words: 2 * batch * d zeroed uint64 of scratch (the hand-off).  snap
// (4 * batch * d floats) receives h, c, n, m entering position snap_t,
// 1 <= snap_t <= seq; without one, snap is null and snap_t 0.  Returns a
// cudaError_t.
extern "C" int c4cam_slstm_scan(const float* pre, const float* wh, const float* h0,
                                const float* c0, const float* n0, const float* m0,
                                float* hs, float* h_out, float* c_out, float* n_out,
                                float* m_out, unsigned long long* words, float* snap,
                                long long snap_t, int batch, long long seq, int d,
                                void* stream) {
  if (bad_shape(batch, seq, d) || (snap == nullptr) != (snap_t < 1 || snap_t > seq))
    return int(cudaErrorInvalidValue);
  const int grid = (d + kUnits - 1) / kUnits;
  const int kpl = (d + 31) / 32 <= 8 ? 8 : (d + 31) / 32 <= 16 ? 16
                : (d + 31) / 32 <= 24 ? 24 : 32;
  // batch 1 on slstm_scan1_kernel, any other batch on slstm_scan_kernel,
  // each at the fewest rows of wh a lane that cover d
#define C4CAM_SCAN(kKpl)                                                                    \
  (batch == 1                                                                              \
       ? launch_resident<slstm_scan1_kernel<kKpl>>(                                         \
             kSmemLimit, grid, smem_bytes(1, 1, d), stream, pre, wh, h0, c0, n0, m0, hs,    \
             h_out, c_out, n_out, m_out, words, snap, int64_t(snap_t), int64_t(seq), d)     \
       : launch_resident<slstm_scan_kernel<kKpl>>(                                          \
             kSmemLimit, grid, smem_bytes(kRows, batch, d), stream, pre, wh, h0, c0, n0,    \
             m0, hs, h_out, c_out, n_out, m_out, words, snap, int64_t(snap_t), batch,       \
             int64_t(seq), d))
  switch (kpl) {
    case 8: return C4CAM_SCAN(8);
    case 16: return C4CAM_SCAN(16);
    case 24: return C4CAM_SCAN(24);
    default: return C4CAM_SCAN(32);
  }
#undef C4CAM_SCAN
}

// slstm_handoff_kernel over the grid and footprint of a scan at (batch,
// d), cooperative; words: 2 * batch * d zeroed uint64.
extern "C" int c4cam_slstm_handoff(unsigned long long* words, long long steps, int batch,
                                   int d, void* stream) {
  if (bad_shape(batch, steps, d)) return int(cudaErrorInvalidValue);
  const int grid = (d + kUnits - 1) / kUnits;
  if (batch == 1)
    return launch_resident<slstm_handoff_kernel<1>>(kSmemLimit, grid, smem_bytes(1, batch, d),
                                                    stream, words, batch, int64_t(steps), d);
  return launch_resident<slstm_handoff_kernel<kRows>>(kSmemLimit, grid,
                                                      smem_bytes(kRows, batch, d), stream, words,
                                                      batch, int64_t(steps), d);
}

// slstm_barrier_kernel over the grid of a scan at d, cooperative;
// counter: one zeroed uint32.
extern "C" int c4cam_slstm_barrier(unsigned int* counter, long long steps, int batch, int d,
                                   void* stream) {
  if (bad_shape(batch, steps, d)) return int(cudaErrorInvalidValue);
  const int grid = (d + kUnits - 1) / kUnits;
  if (uint64_t(steps) * uint64_t(grid) >= (uint64_t(1) << 32))
    return int(cudaErrorInvalidValue);
  return launch_resident<slstm_barrier_kernel>(kSmemLimit, grid, smem_bytes(1, batch, d),
                                               stream, counter, int64_t(steps));
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
