// Fused ReLU-FFN with dead-block skip, for Hopper (sm_90a):
//   out = relu(x @ W_up) @ W_down,   x f32[M,d], W_up f32[d,f], W_down f32[f,d].
//
// Replaces: src/repro/kernels/relu_ffn.py `_relu_ffn_kernel` (body) and
// `relu_ffn` (wrapper) — the Pallas kernel whose sequential grid walks
// d_ff blocks, computes the block's hidden activation in VMEM and runs
// the down-projection MAC only when the block has a live (> 0) value.
//
// What bounds it on this card: at the nectar prefill widths (M <= 200,
// d 128, f 640) bytes — W_up and W_down, 640 KB together, are read once
// for 2*M*d*f*2 flops, and at M = 8 that is 8 flops per byte, below the
// f32 ridge (~20 flop/byte); from M ~ 40 up, operations. Either way the
// weights sit in L2 at nectar widths and a call is a few microseconds of
// work. At llama widths (d 2048, f 8192, 64 MB per weight) the weight
// bytes bound small M.
//
// What the design does about it:
//  * Pass 1: one thread block per (d_ff block of kBF = 128, M tile of
//    kBM = 16 rows). It computes the tile's hidden block h = relu(x W_up)
//    into shared memory (x staged in kKC-wide chunks, W_up read coalesced
//    along f), and when every value of h is <= 0 it skips the down MAC and
//    writes nothing: the Pallas `@pl.when(max(h) > 0)`. Otherwise it
//    writes its partial h @ W_down[block] for the tile's rows to scratch.
//  * Pass 2 sums the live partials of each output element in d_ff-block
//    order. CUDA blocks run in no order, so the Pallas VMEM accumulator
//    carried across grid steps becomes this fixed-order second pass: no
//    float atomics, and the same inputs give the same bits every run.
//  * Any f: the last d_ff block is a tail (columns >= f count as h = 0);
//    the Pallas wrapper asserts f % block_f == 0 instead.
// A simple kernel first: f32 CUDA-core FMAs, no tensor cores, no cp.async.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 16;      // rows of x per tile
constexpr int kBF = 128;     // hidden units per d_ff block
constexpr int kKC = 32;      // depth of one staged x chunk
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBM * kBF / kThreads;   // 8

__global__ void __launch_bounds__(kThreads)
relu_ffn_blocks(const float* __restrict__ x, const float* __restrict__ w_up,
                const float* __restrict__ w_down, float* __restrict__ partial,
                int* __restrict__ live, int M, int d, int f) {
  __shared__ float x_s[kBM][kKC];
  __shared__ float h_s[kBM][kBF];
  const int fb = blockIdx.x, mt = blockIdx.y;
  const int f0 = fb * kBF, m0 = mt * kBM;
  const int tid = threadIdx.x;
  const int c = tid % kBF;                       // hidden unit of this thread
  const int r0 = (tid / kBF) * kRowsPerThread;   // its first row in the tile
  const bool col_ok = f0 + c < f;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kKC) {
    for (int i = tid; i < kBM * kKC; i += kThreads) {
      const int m = i / kKC, kk = i % kKC;
      x_s[m][kk] = (m0 + m < M && k0 + kk < d)
                       ? x[(size_t)(m0 + m) * d + k0 + kk] : 0.f;
    }
    __syncthreads();
    const int nk = min(kKC, d - k0);
    for (int kk = 0; kk < nk; ++kk) {
      const float w = col_ok ? w_up[(size_t)(k0 + kk) * f + f0 + c] : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(x_s[r0 + i][kk], w, acc[i]);
    }
    __syncthreads();
  }
  int any_live = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const float h = acc[i] > 0.f ? acc[i] : 0.f;
    any_live |= h > 0.f;
    h_s[r0 + i][c] = h;
  }
  // the sparse-accelerator skip: an all-zero hidden block -> no down MAC
  const int block_live = __syncthreads_or(any_live);
  if (tid == 0) live[fb * gridDim.y + mt] = block_live;
  if (!block_live) return;

  const int nj = min(kBF, f - f0);
  const int nm = min(kBM, M - m0);
  for (int col = tid; col < d; col += kThreads) {
    float o[kBM];
#pragma unroll
    for (int m = 0; m < kBM; ++m) o[m] = 0.f;
    for (int j = 0; j < nj; ++j) {
      const float w = w_down[(size_t)(f0 + j) * d + col];
#pragma unroll
      for (int m = 0; m < kBM; ++m) o[m] = fmaf(h_s[m][j], w, o[m]);
    }
#pragma unroll
    for (int m = 0; m < kBM; ++m)
      if (m < nm) partial[((size_t)fb * M + m0 + m) * d + col] = o[m];
  }
}

__global__ void relu_ffn_reduce(const float* __restrict__ partial,
                                const int* __restrict__ live,
                                float* __restrict__ out, int M, int d,
                                int n_fb, int n_mt) {
  const size_t total = (size_t)M * d;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int mt = (int)(i / d) / kBM;
    float s = 0.f;
    for (int fb = 0; fb < n_fb; ++fb)          // fixed order: deterministic
      if (live[fb * n_mt + mt]) s += partial[(size_t)fb * total + i];
    out[i] = s;
  }
}

}  // namespace

// x f32[M,d]; w_up f32[d,f]; w_down f32[f,d]; out f32[M,d]; partial
// f32[n_fb,M,d] and live i32[n_fb,n_mt] scratch (n_fb = ceil(f / kBF),
// n_mt = ceil(M / kBM)). All contiguous, on the current device. Launches
// both passes; returns the first cudaError_t (0 = success).
extern "C" int relu_ffn_f32(const float* x, const float* w_up,
                            const float* w_down, float* out, float* partial,
                            int* live, int M, int d, int f, void* stream) {
  if (M <= 0 || d <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_fb = (f + kBF - 1) / kBF;
  const int n_mt = (M + kBM - 1) / kBM;
  relu_ffn_blocks<<<dim3(n_fb, n_mt), kThreads, 0, st>>>(
      x, w_up, w_down, partial, live, M, d, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)M * d;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  relu_ffn_reduce<<<blocks, 256, 0, st>>>(partial, live, out, M, d, n_fb,
                                          n_mt);
  return (int)cudaGetLastError();
}
