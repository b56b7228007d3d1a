// hdc_encode: record-based HDC hypervector encoding (sm_90a).
//
// Replaces the TPU kernel `hdc_encode_pallas` (src/repro/kernels/hdc_encode.py,
// body `_encode_kernel`).  For level ids q (M, F), keys (F, H) and levels
// (L, H) it writes
//
//     out[m, h] = sum_f keys[f, h] * levels[q[m, f], h] >= 0 ? +1.f : -1.f
//
// as float32 (M, H).  The TPU kernel sums L one-hot matrix products because
// its matrix unit cannot gather; here the gather form is computed directly.
// Contract: keys and levels hold int8 cells in {-1, 0, +1} (row stride
// `width` bytes, a multiple of 4, zero past H), so every sum is an exact
// int32 and a zero sum (F even) gives +1, as the reference's bundle does.  An
// id outside [0, L), a feature f >= F and a query m >= M all read a zero row
// of levels: they add nothing, as a missed one-hot adds nothing there.
//
// Bound on an H100 SXM: M*F*H int8 bind-and-add steps, four to an IDP4A,
// at 64 integer multiply-add class instructions per clock per SM (CUDA C++
// Programming Guide, compute capability 9.0) x 132 SMs x 1.98 GHz; at the
// HDC/MNIST-8k test set (10,000 x 784 x 8192) 0.96 ms, against 0.10 ms to
// move the int32 ids and write the 328 MB float32 output at 3.35 TB/s: the
// function is instruction-bound.  The design keeps every operand of the
// inner loop in shared memory and registers: a block owns 64 queries x 128
// dims, stages its slice of all L levels once (plus the zero row), and
// streams F in chunks of 64 features (ids and int8 keys); a warp owns 8
// queries, a thread 4 consecutive dims packed as one int8x4 word, so one
// 32-bit shared load gives four level cells.  The four cells of a word
// belong to four dims, whose sums must stay apart, so `__dp4a` takes a key
// word masked to one byte and adds one product per instruction: a quarter
// of the IDP4A rate the bound counts.  Packing four features of one dim
// into a word needs a gather of four level rows per word; a bit-sliced XOR
// form (32 dims per LOP3, carry-save counters) is the way past this and is
// later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockM = 64;     // queries per block (8 warps x 8)
constexpr int kRowsPerWarp = 8;
constexpr int kBlockH = 128;    // dims per block: 32 lanes x 4
constexpr int kWords = kBlockH / 4;
constexpr int kChunkF = 64;     // features per shared-memory stage
constexpr int kStaticSmem = kBlockM * kChunkF * 4 + kChunkF * kBlockH;

__global__ void __launch_bounds__(kThreads)
hdc_encode_kernel(const int* __restrict__ q, const int* __restrict__ keys,
                  const int* __restrict__ levels, float* __restrict__ out,
                  int M, int F, int H, int width_words, int L) {
  __shared__ int q_s[kBlockM * kChunkF];   // level id, or L for a zero row
  __shared__ int k_s[kChunkF * kWords];    // int8x4 key words
  extern __shared__ int l_s[];             // (L + 1) x kWords level words

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kBlockM;
  const int w0 = blockIdx.x * kWords;      // first key/level word of the block

  for (int i = tid; i < (L + 1) * kWords; i += kThreads) {
    const int l = i / kWords, w = w0 + i % kWords;
    l_s[i] = (l < L && w < width_words) ? levels[size_t(l) * width_words + w] : 0;
  }

  int acc[kRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int f0 = 0; f0 < F; f0 += kChunkF) {
    __syncthreads();                       // the previous chunk is consumed
    for (int i = tid; i < kBlockM * kChunkF; i += kThreads) {
      const int r = i / kChunkF, c = i % kChunkF;
      const int m = m0 + r, f = f0 + c;
      int v = (m < M && f < F) ? q[size_t(m) * F + f] : L;
      if (static_cast<unsigned>(v) >= static_cast<unsigned>(L)) v = L;
      q_s[i] = v;
    }
    for (int i = tid; i < kChunkF * kWords; i += kThreads) {
      const int r = i / kWords, w = w0 + i % kWords;
      const int f = f0 + r;
      k_s[i] = (f < F && w < width_words) ? keys[size_t(f) * width_words + w] : 0;
    }
    __syncthreads();

    const int nf = min(kChunkF, F - f0);
    const int* qrow = q_s + warp * kRowsPerWarp * kChunkF;
    for (int c = 0; c < nf; ++c) {
      const int kw = k_s[c * kWords + lane];
      const int k0 = kw & 0xff, k1 = kw & 0xff00;
      const int k2 = kw & 0xff0000, k3 = kw & static_cast<int>(0xff000000u);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int lw = l_s[qrow[i * kChunkF + c] * kWords + lane];
        acc[i][0] = __dp4a(k0, lw, acc[i][0]);
        acc[i][1] = __dp4a(k1, lw, acc[i][1]);
        acc[i][2] = __dp4a(k2, lw, acc[i][2]);
        acc[i][3] = __dp4a(k3, lw, acc[i][3]);
      }
    }
  }

  const int h = blockIdx.x * kBlockH + 4 * lane;
  const bool vec4 = (H & 3) == 0 && h + 3 < H;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int m = m0 + warp * kRowsPerWarp + i;
    if (m >= M) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = acc[i][j] >= 0 ? 1.f : -1.f;
    float* orow = out + size_t(m) * H;
    if (vec4) {
      *reinterpret_cast<float4*>(orow + h) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (h + j < H) orow[h + j] = v[j];
    }
  }
}

}  // namespace

// q (M, F) int32; keys (F, width) and levels (L, width) int8 cells in
// {-1, 0, +1}, row-major, width a multiple of 4 with zero columns past H;
// out (M, H) float32.  Returns a cudaError_t code.
extern "C" int c4cam_hdc_encode(const int* q, const signed char* keys,
                                const signed char* levels, float* out, int M,
                                int F, int H, int width, int L, void* stream) {
  if (M <= 0 || F <= 0 || H <= 0 || L <= 0 || width < H || width % 4)
    return int(cudaErrorInvalidValue);
  const int dyn = (L + 1) * kBlockH;
  if (kStaticSmem + dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hdc_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid((width + kBlockH - 1) / kBlockH, (M + kBlockM - 1) / kBlockM);
  hdc_encode_kernel<<<grid, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      q, reinterpret_cast<const int*>(keys), reinterpret_cast<const int*>(levels),
      out, M, F, H, width / 4, L);
  return int(cudaGetLastError());
}

extern "C" const char* c4cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
