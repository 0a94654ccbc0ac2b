// NMCE W8A8 matmul, for Hopper (sm_90a):
//   out = float(x_q @ w_q) * x_scale * w_scale
//   x_q i8[M,K], w_q i8[K,N], x_scale f32[M], w_scale f32[N], out f32[M,N].
//
// Replaces: src/repro/kernels/nmce_matvec.py `_nmce_kernel` (body) and
// `nmce_matmul` (wrapper) — the Pallas kernel that keeps the int8
// activation block stationary in VMEM, streams int8 weight blocks past it
// with int32 accumulation, and fuses the dequant into its epilogue.
// `saturate_int16` clips each 64-wide K chunk (the NMCE's 64-byte vector
// register) to int16 before the cross-chunk sum.
//
// What bounds it on this card: bytes. At decode M (8 rows) each int8
// weight byte feeds 2*M = 16 integer operations, far below the int8
// tensor-core ridge (1,979 TOPS over 3.35 TB/s, ~590 op/byte), so the
// least time is the K*N weight bytes over the memory rate.
//
// What the design does about it:
//  * One warp owns 128 output columns (4 adjacent columns per lane) and
//    32-bit loads of a weight row put 128 contiguous bytes on the bus per
//    warp instruction. Four rows' words are transposed in registers with
//    __byte_perm so that each word holds 4 consecutive K values of one
//    column, and __dp4a multiplies them with 4 K values of an x row:
//    int8 x int8 -> int32, exact.
//  * The K loop walks 64-wide chunks, the NMCE vector register: a chunk's
//    dot is complete before it joins the running sum, so the int16 clip
//    of `saturate_int16` costs one clamp per chunk. K past the end is
//    zero (the reference pads K to a multiple of 64 the same way).
//  * The kWarps warps of a block take interleaved chunks of K for the
//    same 128 columns and add their int32 sums in shared memory in warp
//    order. Integer sums are exact in any order; the epilogue then
//    computes float(acc) * x_scale * w_scale left to right, as the
//    reference does, so the result is bit-equal to it.
// A simple kernel first: no tensor cores (mma.sync on s8), no cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;          // output columns per block (4 per lane)
constexpr int kBM = 8;              // rows of x per block
constexpr int kChunk = 64;          // NMCE_VREG_BYTES
constexpr int kWords = kChunk / 4;  // 32-bit words of one x chunk row

template <bool kSaturate>
__global__ void __launch_bounds__(kThreads)
nmce_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale,
                   float* __restrict__ out, int M, int K, int N) {
  __shared__ int x_s[kWarps][kBM][kWords];
  __shared__ int red[kWarps][kBM][kCols];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kCols + lane * 4;   // this lane's 4 columns
  const int m0 = blockIdx.y * kBM;
  const bool col_ok = n0 < N;                     // N % 4 == 0: all 4 or none

  int acc[kBM][4];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  const int n_chunks = (K + kChunk - 1) / kChunk;
  for (int ch = warp; ch < n_chunks; ch += kWarps) {
    const int k0 = ch * kChunk;
    // the chunk's x rows as packed words (K % 4 == 0: a word is all in or
    // all past K)
    for (int i = lane; i < kBM * kWords; i += 32) {
      const int m = i / kWords, k = k0 + 4 * (i % kWords);
      x_s[warp][m][i % kWords] =
          (m0 + m < M && k < K)
              ? *reinterpret_cast<const int*>(x + (size_t)(m0 + m) * K + k)
              : 0;
    }
    __syncwarp();
    int part[kBM][4];
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[m][j] = 0;
#pragma unroll 4
    for (int q = 0; q < kWords; ++q) {
      const int k = k0 + 4 * q;
      int r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = (col_ok && k < K)
                   ? *reinterpret_cast<const int*>(w + (size_t)(k + i) * N + n0)
                   : 0;
      // 4x4 byte transpose: c[j] holds w[k..k+3][n0+j]
      const int t0 = __byte_perm(r[0], r[1], 0x5140);
      const int t1 = __byte_perm(r[0], r[1], 0x7362);
      const int t2 = __byte_perm(r[2], r[3], 0x5140);
      const int t3 = __byte_perm(r[2], r[3], 0x7362);
      const int c[4] = {__byte_perm(t0, t2, 0x5410),
                        __byte_perm(t0, t2, 0x7632),
                        __byte_perm(t1, t3, 0x5410),
                        __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
        const int xv = x_s[warp][m][q];
#pragma unroll
        for (int j = 0; j < 4; ++j) part[m][j] = __dp4a(xv, c[j], part[m][j]);
      }
    }
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[m][j] += kSaturate ? min(max(part[m][j], -32768), 32767)
                               : part[m][j];
    __syncwarp();
  }

#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = tid; i < kBM * kCols; i += kThreads) {
    const int m = i / kCols, col = i % kCols;
    const int n = blockIdx.x * kCols + col;
    if (m0 + m >= M || n >= N) continue;
    int s = 0;
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp][m][col];
    // the reference's epilogue, left to right: (acc * x_scale) * w_scale
    const float y = __fmul_rn(__int2float_rn(s), x_scale[m0 + m]);
    out[(size_t)(m0 + m) * N + n] = __fmul_rn(y, w_scale[n]);
  }
}

}  // namespace

// x_q i8[M,K] and w_q i8[K,N] with K % 4 == 0, N % 4 == 0 and 4-byte
// aligned bases; x_scale f32[M]; w_scale f32[N]; out f32[M,N]. All
// contiguous, on the current device. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int nmce_matmul_i8(const int8_t* x_q, const int8_t* w_q,
                              const float* x_scale, const float* w_scale,
                              float* out, int M, int K, int N,
                              int saturate_int16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, (M + kBM - 1) / kBM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (saturate_int16)
    nmce_matmul_kernel<true><<<grid, kThreads, 0, st>>>(
        x_q, w_q, x_scale, w_scale, out, M, K, N);
  else
    nmce_matmul_kernel<false><<<grid, kThreads, 0, st>>>(
        x_q, w_q, x_scale, w_scale, out, M, K, N);
  return (int)cudaGetLastError();
}
