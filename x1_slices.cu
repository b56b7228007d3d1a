// X1's step in pieces: stripped copies of the sLSTM recurrence kernel, for
// x1_slices.py (not built by the package, not a launch of X1).
//
// `old_kernel<kStage>` is the earlier grid-barrier design (one block per
// 8 hidden units, wh's 32 columns in shared memory, 8 k-slices of the
// product summed in shared memory, the gates on batch x 8 threads):
//   1 the barrier alone, 2 + the h load, 3 + the product, 4 + the slice
//   sum, 5 the whole step.
// `new_kernel<kKpl, kStage>` is the flagged hand-off design of
// src/repro_torch/kernels/csrc/slstm_scan.cu at batch 1 (a warp a unit,
// wh in registers, a warp reduction, 64-bit (value, tag) words):
//   1 the hand-off alone (publish, poll, block barrier), 2 + the product,
//   3 + the warp reduction and the gather of the four gates, 4 the whole
//   step.
// A stage short of the whole step publishes a value taken from its last
// piece, so each piece stays on the chain the next step waits for.
#include "slstm_scan.cu"

namespace {

constexpr int kOldCols = 4 * kUnits;          // a block's z, i, f, o columns
constexpr int kOldSlices = 8;
constexpr int kOldRows = 8;

size_t old_smem_bytes(int batch, int d) {
  return sizeof(float) * (size_t(d) * kOldCols + size_t(kOldRows) * d +
                          size_t(kOldSlices) * kOldRows * kOldCols + size_t(batch) * kOldCols +
                          size_t(3) * batch * kUnits);
}

template <int kStage>
__global__ void __launch_bounds__(kThreads, 1)
old_kernel(const float* __restrict__ pre, const float* __restrict__ wh,
           const float* __restrict__ h0, const float* __restrict__ c0,
           const float* __restrict__ n0, const float* __restrict__ m0,
           float* __restrict__ hs, float* hbuf, unsigned int* counter, int batch,
           int64_t seq, int d) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* hprev = w + size_t(d) * kOldCols;
  float* part = hprev + size_t(kOldRows) * d;
  float* gate = part + kOldSlices * kOldRows * kOldCols;
  float* cs = gate + batch * kOldCols;
  float* ns = cs + batch * kUnits;
  float* ms = ns + batch * kUnits;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kUnits;
  const int64_t d4 = 4 * int64_t(d);
  auto wh_col = [&](int c) -> int64_t {
    return int64_t(c / kUnits) * d + u0 + (c % kUnits);
  };
  for (int e = tid; e < d * kOldCols; e += kThreads) {
    const int k = e / kOldCols, c = e % kOldCols;
    w[e] = u0 + c % kUnits < d ? wh[int64_t(k) * d4 + wh_col(c)] : 0.f;
  }
  for (int e = tid; e < batch * kUnits; e += kThreads) {
    const int r = e / kUnits, unit = u0 + e % kUnits;
    if (unit >= d) continue;
    cs[e] = c0[int64_t(r) * d + unit];
    ns[e] = n0[int64_t(r) * d + unit];
    ms[e] = m0[int64_t(r) * d + unit];
  }
  const int col = tid % kOldCols, slice = tid / kOldCols;
  const bool col_live = u0 + col % kUnits < d;
  const int64_t gcol = wh_col(col);
  const int n_pass = (batch + kOldRows - 1) / kOldRows;
  float pv[kMaxBatch / kOldRows];
  auto load_pre = [&](int64_t t) {
#pragma unroll
    for (int g = 0; g < kMaxBatch / kOldRows; ++g) {
      const int r = g * kOldRows + slice;
      pv[g] = (g < n_pass && r < batch && col_live)
          ? pre[(int64_t(r) * seq + t) * d4 + gcol] : 0.f;
    }
  };
  load_pre(0);
  __syncthreads();
  for (int64_t t = 0; t < seq; ++t) {
    const float* src = t == 0 ? h0 : hbuf + ((t - 1) & 1) * int64_t(batch) * d;
    if constexpr (kStage >= 2) {
#pragma unroll
      for (int g = 0; g < kMaxBatch / kOldRows; ++g) {
        if (g >= n_pass) break;
        const int r0 = g * kOldRows, nr = min(kOldRows, batch - r0), n_h = nr * d;
        const float* hsrc = src + int64_t(r0) * d;
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
        if constexpr (kStage >= 3) {
          float acc[kOldRows] = {};
          int k = slice;
          for (; k + 7 * kOldSlices < d; k += 8 * kOldSlices) {
            float wv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) wv[u] = w[(k + u * kOldSlices) * kOldCols + col];
#pragma unroll
            for (int r = 0; r < kOldRows; ++r)
              if (r < nr) {
#pragma unroll
                for (int u = 0; u < 8; ++u)
                  acc[r] = fmaf(hprev[r * d + k + u * kOldSlices], wv[u], acc[r]);
              }
          }
          for (; k < d; k += kOldSlices) {
            const float wv = w[k * kOldCols + col];
#pragma unroll
            for (int r = 0; r < kOldRows; ++r)
              if (r < nr) acc[r] = fmaf(hprev[r * d + k], wv, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < kOldRows; ++r) part[(slice * kOldRows + r) * kOldCols + col] = acc[r];
          __syncthreads();
          if constexpr (kStage >= 4) {
            if (slice < nr) {
              float s = 0.f;
#pragma unroll
              for (int q = 0; q < kOldSlices; ++q)
                s += part[(q * kOldRows + slice) * kOldCols + col];
              gate[(r0 + slice) * kOldCols + col] = __fadd_rn(pv[g], s);
            }
            __syncthreads();
          }
        }
      }
    }
    float* hnext = hbuf + (t & 1) * int64_t(batch) * d;
    for (int e = tid; e < batch * kUnits; e += kThreads) {
      const int r = e / kUnits, u = e % kUnits, unit = u0 + u;
      if (unit >= d) continue;
      float h;
      if constexpr (kStage == 5) {
        const float* gr = gate + r * kOldCols;
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
        h = __fdiv_rn(__fmul_rn(sigmoid(og), c), fmaxf(fabsf(n), 1.f));
        cs[e] = c;
        ns[e] = n;
        ms[e] = m_t;
      } else if constexpr (kStage == 4) {
        h = gate[r * kOldCols + u];
      } else if constexpr (kStage == 3) {
        h = part[r % kOldRows * kOldCols + u];
      } else if constexpr (kStage == 2) {
        h = hprev[(r % kOldRows) * d + unit];
      } else {
        h = 0.f;
      }
      hnext[int64_t(r) * d + unit] = h;
      hs[(int64_t(r) * seq + t) * d + unit] = h;
    }
    if (t + 1 < seq) {
      load_pre(t + 1);
      grid_barrier(counter, unsigned(t + 1) * gridDim.x);
    }
  }
}

template <int kKpl, int kStage>
__global__ void __launch_bounds__(kThreads, 1)
new_kernel(const float* __restrict__ pre, const float* __restrict__ wh,
           const float* __restrict__ h0, const float* __restrict__ c0,
           const float* __restrict__ n0, const float* __restrict__ m0,
           float* __restrict__ hs, unsigned long long* words, int64_t seq, int d) {
  constexpr int kR = 1, kV = 4, kSpread = 8;
  extern __shared__ __align__(16) float smem[];
  float* hsm = smem;
  float* cs = hsm + 2 * kR * d;
  float* ns = cs + kUnits;
  float* ms = ns + kUnits;
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
  if (tid < kUnits && blockIdx.x * kUnits + tid < d) {
    const int u = blockIdx.x * kUnits + tid;
    cs[tid] = c0[u];
    ns[tid] = n0[u];
    ms[tid] = m0[u];
  }
  const int j = lane / kSpread, ql = j / kR, rl = j % kR;
  const bool gate_lane = lane % kSpread == 0 && ql == 0 && live;
  float pv = live ? pre[int64_t(ql) * d + unit] : 0.f;
  int buf = 0;
  for (int64_t t = 0; t < seq; ++t) {
    float* hp = hsm + buf * kR * d;
    buf ^= 1;
    if (t == 0) {
      for (int e = tid; e < d; e += kThreads) hp[e] = h0[e];
    } else {
      poll_words(words + ((t - 1) & 1) * int64_t(d), hp, d, unsigned(t));
    }
    __syncthreads();
    float h = hp[unit < d ? unit : 0];
    if constexpr (kStage >= 2) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < kKpl; ++m) {
        const int k = lane + 32 * m;
        if (k < d) {
          const float hv = hp[k];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(hv, wr[q][m], acc[q]);
        }
      }
      h = acc[0];
      if constexpr (kStage >= 3) {
        float v[kV] = {acc[0], acc[1], acc[2], acc[3]};
        const float gsum = __fadd_rn(pv, reduce_scatter<kV>(v, lane));
        if (t + 1 < seq) pv = live ? pre[(t + 1) * d4 + int64_t(ql) * d + unit] : 0.f;
        const float z = __shfl_sync(0xffffffffu, gsum, (0 * kR + rl) * kSpread);
        const float ig = __shfl_sync(0xffffffffu, gsum, (1 * kR + rl) * kSpread);
        const float fg = __shfl_sync(0xffffffffu, gsum, (2 * kR + rl) * kSpread);
        const float og = __shfl_sync(0xffffffffu, gsum, (3 * kR + rl) * kSpread);
        h = __fadd_rn(__fadd_rn(z, ig), __fadd_rn(fg, og));
        if constexpr (kStage >= 4) {
          if (gate_lane) {
            const int e = warp;
            const float logf_ = log_sigmoid(fg);
            const float lm = __fadd_rn(logf_, ms[e]);
            const float m_t = fmaxf(lm, ig);
            const float isc = expf(__fsub_rn(ig, m_t));
            const float fsc = expf(__fsub_rn(lm, m_t));
            const float c = __fadd_rn(__fmul_rn(fsc, cs[e]), __fmul_rn(isc, tanhf(z)));
            const float n = __fadd_rn(__fmul_rn(fsc, ns[e]), isc);
            h = __fdiv_rn(__fmul_rn(sigmoid(og), c), fmaxf(fabsf(n), 1.f));
            cs[e] = c;
            ns[e] = n;
            ms[e] = m_t;
          }
        }
      }
    }
    if (gate_lane) {
      if (t + 1 < seq) st_word(words + (t & 1) * int64_t(d) + unit, pack(h, unsigned(t + 1)));
      hs[t * d + unit] = h;
    }
  }
}

template <auto Kernel, typename... Args>
int launch_plain_coop(int grid, size_t smem, void* stream, Args... args) {
  return launch_resident<Kernel>(old_smem_bytes(kMaxBatch, kMaxD), grid, smem, stream,
                                 args...);
}

}  // namespace

// The barrier design through stage `stage` (1..5): batch rows of pre (batch,
// seq, 4d) and the state, hs (batch, seq, d); hbuf 2 * batch * d floats,
// counter one zeroed uint32.
extern "C" int x1s_old(int stage, const float* pre, const float* wh, const float* h0,
                       const float* c0, const float* n0, const float* m0, float* hs,
                       float* hbuf, unsigned int* counter, int batch, long long seq, int d,
                       void* stream) {
  if (bad_shape(batch, seq, d)) return int(cudaErrorInvalidValue);
  const int grid = (d + kUnits - 1) / kUnits;
  const size_t smem = old_smem_bytes(batch, d);
  const int64_t s = seq;
  switch (stage) {
    case 1: return launch_plain_coop<old_kernel<1>>(grid, smem, stream, pre, wh, h0, c0, n0, m0, hs, hbuf, counter, batch, s, d);
    case 2: return launch_plain_coop<old_kernel<2>>(grid, smem, stream, pre, wh, h0, c0, n0, m0, hs, hbuf, counter, batch, s, d);
    case 3: return launch_plain_coop<old_kernel<3>>(grid, smem, stream, pre, wh, h0, c0, n0, m0, hs, hbuf, counter, batch, s, d);
    case 4: return launch_plain_coop<old_kernel<4>>(grid, smem, stream, pre, wh, h0, c0, n0, m0, hs, hbuf, counter, batch, s, d);
    case 5: return launch_plain_coop<old_kernel<5>>(grid, smem, stream, pre, wh, h0, c0, n0, m0, hs, hbuf, counter, batch, s, d);
    default: return int(cudaErrorInvalidValue);
  }
}

// The hand-off design at batch 1 through stage `stage` (1..4); words
// 2 * d zeroed uint64.
extern "C" int x1s_new(int stage, const float* pre, const float* wh, const float* h0,
                       const float* c0, const float* n0, const float* m0, float* hs,
                       unsigned long long* words, long long seq, int d, void* stream) {
  if (bad_shape(1, seq, d) || d > 32 * 32) return int(cudaErrorInvalidValue);
  const int grid = (d + kUnits - 1) / kUnits;
  const size_t smem = smem_bytes(1, 1, d) + sizeof(float) * 3 * kUnits;   // + c, n, m
  const int64_t s = seq;
  const bool wide = d > 32 * 24;
#define X1S_NEW(kpl, st) \
  launch_plain_coop<new_kernel<kpl, st>>(grid, smem, stream, pre, wh, h0, c0, n0, m0, hs, words, s, d)
  switch (stage) {
    case 1: return wide ? X1S_NEW(32, 1) : X1S_NEW(24, 1);
    case 2: return wide ? X1S_NEW(32, 2) : X1S_NEW(24, 2);
    case 3: return wide ? X1S_NEW(32, 3) : X1S_NEW(24, 3);
    case 4: return wide ? X1S_NEW(32, 4) : X1S_NEW(24, 4);
    default: return int(cudaErrorInvalidValue);
  }
#undef X1S_NEW
}
