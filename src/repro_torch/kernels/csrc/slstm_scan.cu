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
// once) and its 8 B D^2 S FLOP are far below that at D 768.  The design:
// a grid of co-resident blocks, block g owning the hidden units
// [8 g, 8 g + 8) and the 32 columns of wh they need (D x 32 float32 in
// shared memory, read from device memory once a launch: 96 KB at D 768),
// so the only traffic a step is the previous h (B x D float32, read from
// L2) and the grid-wide barrier that publishes the new one.  h lives in a
// double-buffered device array: step t reads buffer (t - 1) & 1 and
// writes buffer t & 1, and one barrier a step orders both.  Co-residency
// is what the barrier needs: the launch is cooperative
// (cudaLaunchAttributeCooperative), which fails rather than deadlocks when
// the grid cannot be resident at once; it also captures in CUDA graphs.
// The next step's pre values are loaded into registers before the
// barrier, so their latency hides behind it; a thread issues its loads
// of h together and its products eight k at a time, and the barrier is
// one release increment and acquire loads (no fences).  A position takes
// 4.15 us at batch 1 and D 768 over 524,288 positions, the barrier alone
// 0.95 us, on an H100 80GB HBM3 at 700 W (chip_smoke.py long_500k; 11.0
// us with a load and a product at a time and fenced atomics).
//
// Offsets are 64-bit: pre at 524,288 positions holds 1.6e9 elements.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kUnits = 8;                 // hidden units a block owns
constexpr int kCols = 4 * kUnits;         // their z, i, f, o columns
constexpr int kSlices = 8;                // k-slices of the product
constexpr int kThreads = kCols * kSlices; // 256
constexpr int kRows = 8;                  // batch rows a product pass holds
constexpr int kMaxBatch = 64;             // kRows x the registers of pre
constexpr int kMaxD = 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// All blocks of the grid arrive before any leaves; `target` is the count
// of arrivals the barrier waits for (it grows by gridDim.x a step, so the
// counter, zeroed by the wrapper, is never reset inside the launch).  The
// block's writes reach the other blocks through thread 0's release
// increment (cumulative over what the block barrier ordered before it)
// and their acquire load; the readers load h with ld.global.cg, past L1.
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

size_t smem_bytes(int batch, int d) {
  return sizeof(float) * (size_t(d) * kCols          // wh's columns
                          + size_t(kRows) * d         // a pass's h rows
                          + size_t(kSlices) * kRows * kCols  // partial sums
                          + size_t(batch) * kCols     // gate values
                          + size_t(3) * batch * kUnits);  // c, n, m
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const float* __restrict__ pre, const float* __restrict__ wh,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ hs, float* __restrict__ h_out,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, float* hbuf, unsigned int* counter,
                  float* __restrict__ snap, int64_t snap_t, int batch, int64_t seq,
                  int d) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                                   // [d][kCols]
  float* hprev = w + size_t(d) * kCols;              // [kRows][d]
  float* part = hprev + size_t(kRows) * d;           // [kSlices][kRows][kCols]
  float* gate = part + kSlices * kRows * kCols;      // [batch][kCols]
  float* cs = gate + batch * kCols;                  // [batch][kUnits]
  float* ns = cs + batch * kUnits;
  float* ms = ns + batch * kUnits;

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kUnits;
  const int64_t d4 = 4 * int64_t(d);
  // column c of the block: gate c / kUnits, unit u0 + c % kUnits
  auto wh_col = [&](int c) -> int64_t {
    return int64_t(c / kUnits) * d + u0 + (c % kUnits);
  };
  for (int e = tid; e < d * kCols; e += kThreads) {
    const int k = e / kCols, c = e % kCols;
    w[e] = u0 + c % kUnits < d ? wh[int64_t(k) * d4 + wh_col(c)] : 0.f;
  }
  for (int e = tid; e < batch * kUnits; e += kThreads) {
    const int r = e / kUnits, unit = u0 + e % kUnits;
    if (unit >= d) continue;
    cs[e] = c0[int64_t(r) * d + unit];
    ns[e] = n0[int64_t(r) * d + unit];
    ms[e] = m0[int64_t(r) * d + unit];
  }
  // the thread that sums column (tid % kCols) of row (tid / kCols + kRows g)
  const int col = tid % kCols, slice = tid / kCols;
  const bool col_live = u0 + col % kUnits < d;
  const int64_t gcol = wh_col(col);
  const int n_pass = (batch + kRows - 1) / kRows;
  float pv[kMaxBatch / kRows];
  auto load_pre = [&](int64_t t) {
#pragma unroll
    for (int g = 0; g < kMaxBatch / kRows; ++g) {
      const int r = g * kRows + slice;
      pv[g] = (g < n_pass && r < batch && col_live)
          ? pre[(int64_t(r) * seq + t) * d4 + gcol] : 0.f;
    }
  };
  load_pre(0);
  __syncthreads();

  for (int64_t t = 0; t < seq; ++t) {
    const float* src = t == 0 ? h0 : hbuf + ((t - 1) & 1) * int64_t(batch) * d;
#pragma unroll
    for (int g = 0; g < kMaxBatch / kRows; ++g) {
      if (g >= n_pass) break;
      const int r0 = g * kRows, nr = min(kRows, batch - r0), n_h = nr * d;
      const float* hsrc = src + int64_t(r0) * d;
      // the pass's h rows: a thread's loads issued together (one L2 trip)
      for (int e0 = tid; e0 < n_h; e0 += 4 * kThreads) {
        float hv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kThreads;
          hv[u] = e < n_h ? __ldcg(hsrc + e) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e0 + u * kThreads < n_h) hprev[e0 + u * kThreads] = hv[u];
      }
      __syncthreads();
      // the slice's k = slice, slice + 8, ... in order, eight at a time
      float acc[kRows] = {};
      int k = slice;
      for (; k + 7 * kSlices < d; k += 8 * kSlices) {
        float wv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) wv[u] = w[(k + u * kSlices) * kCols + col];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nr) {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              acc[r] = fmaf(hprev[r * d + k + u * kSlices], wv[u], acc[r]);
          }
      }
      for (; k < d; k += kSlices) {
        const float wv = w[k * kCols + col];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nr) acc[r] = fmaf(hprev[r * d + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[(slice * kRows + r) * kCols + col] = acc[r];
      __syncthreads();
      if (slice < nr) {      // thread (slice, col) sums row r0 + slice
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kSlices; ++q) s += part[(q * kRows + slice) * kCols + col];
        gate[(r0 + slice) * kCols + col] = __fadd_rn(pv[g], s);
      }
      __syncthreads();
    }
    float* hnext = hbuf + (t & 1) * int64_t(batch) * d;
    for (int e = tid; e < batch * kUnits; e += kThreads) {
      const int r = e / kUnits, u = e % kUnits, unit = u0 + u;
      if (unit >= d) continue;
      const float* gr = gate + r * kCols;
      const float z = gr[u], ig = gr[kUnits + u], fg = gr[2 * kUnits + u],
                  og = gr[3 * kUnits + u];
      const float logf_ = log_sigmoid(fg);
      const float m = ms[e];
      const float lm = __fadd_rn(logf_, m);
      const float m_t = fmaxf(lm, ig);
      const float isc = expf(__fsub_rn(ig, m_t));
      const float fsc = expf(__fsub_rn(lm, m_t));
      const float c = __fadd_rn(__fmul_rn(fsc, cs[e]), __fmul_rn(isc, tanhf(z)));
      const float n = __fadd_rn(__fmul_rn(fsc, ns[e]), isc);
      const float h = __fdiv_rn(__fmul_rn(sigmoid(og), c), fmaxf(fabsf(n), 1.f));
      cs[e] = c;
      ns[e] = n;
      ms[e] = m_t;
      hnext[int64_t(r) * d + unit] = h;
      hs[(int64_t(r) * seq + t) * d + unit] = h;
      if (t + 1 == seq) h_out[int64_t(r) * d + unit] = h;
      if (t + 1 == snap_t) {         // the state entering position snap_t
        const int64_t plane = int64_t(batch) * d, at = int64_t(r) * d + unit;
        snap[at] = h;
        snap[plane + at] = c;
        snap[2 * plane + at] = n;
        snap[3 * plane + at] = m_t;
      }
    }
    if (t + 1 < seq) {
      load_pre(t + 1);
      grid_barrier(counter, unsigned(t + 1) * gridDim.x);
    }
  }
  for (int e = tid; e < batch * kUnits; e += kThreads) {
    const int r = e / kUnits, unit = u0 + e % kUnits;
    if (unit >= d) continue;
    c_out[int64_t(r) * d + unit] = cs[e];
    n_out[int64_t(r) * d + unit] = ns[e];
    m_out[int64_t(r) * d + unit] = ms[e];
  }
}

// The barrier alone, `steps` times, over the scan's grid and footprint
// (the same blocks an SM): a step's serial floor, for the scan's bound.
__global__ void __launch_bounds__(kThreads, 1)
slstm_barrier_kernel(unsigned int* counter, int64_t steps) {
  for (int64_t t = 0; t < steps; ++t) grid_barrier(counter, unsigned(t + 1) * gridDim.x);
}

// Sets the kernels' shared-memory limit (once a device) and launches
// `kernel` cooperatively on `grid` blocks: the runtime refuses
// (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be resident at
// once.
template <typename... Params, typename... Args>
int launch_resident(void (*kernel)(Params...), int grid, size_t smem, void* stream,
                    Args... args) {
  static std::atomic<uint64_t> ready{0};     // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_bytes(kMaxBatch, kMaxD)));
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// pre (batch, seq, 4d), wh (d, 4d), h0 / c0 / n0 / m0 and the outputs
// h / c / n / m (batch, d), hs (batch, seq, d): float32, contiguous.
// hbuf: 2 * batch * d floats of scratch; counter: one zeroed uint32.
// snap (4 * batch * d floats) receives h, c, n, m entering position
// snap_t, 1 <= snap_t <= seq; without one, snap is null and snap_t 0.
// Returns a cudaError_t.
extern "C" int c4cam_slstm_scan(const float* pre, const float* wh, const float* h0,
                                const float* c0, const float* n0, const float* m0,
                                float* hs, float* h_out, float* c_out, float* n_out,
                                float* m_out, float* hbuf, unsigned int* counter,
                                float* snap, long long snap_t, int batch, long long seq,
                                int d, void* stream) {
  if (batch <= 0 || batch > kMaxBatch || seq <= 0 || d <= 0 || d > kMaxD ||
      (snap == nullptr) != (snap_t < 1 || snap_t > seq))
    return int(cudaErrorInvalidValue);
  const int grid = (d + kUnits - 1) / kUnits;
  if (uint64_t(seq) * uint64_t(grid) >= (uint64_t(1) << 32))
    return int(cudaErrorInvalidValue);
  return launch_resident(slstm_scan_kernel, grid, smem_bytes(batch, d), stream,
                         pre, wh, h0, c0, n0, m0, hs, h_out, c_out, n_out, m_out, hbuf,
                         counter, snap, int64_t(snap_t), batch, int64_t(seq), d);
}

// slstm_barrier_kernel over the grid and footprint of a scan at (batch,
// d), cooperative; counter: one zeroed uint32.
extern "C" int c4cam_slstm_barrier(unsigned int* counter, long long steps, int batch, int d,
                                   void* stream) {
  if (batch <= 0 || batch > kMaxBatch || steps <= 0 || d <= 0 || d > kMaxD)
    return int(cudaErrorInvalidValue);
  const int grid = (d + kUnits - 1) / kUnits;
  if (uint64_t(steps) * uint64_t(grid) >= (uint64_t(1) << 32))
    return int(cudaErrorInvalidValue);
  return launch_resident(slstm_barrier_kernel, grid, smem_bytes(batch, d), stream,
                         counter, int64_t(steps));
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
