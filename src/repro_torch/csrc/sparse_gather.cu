// Activation-sparse gathered down-projection, for Hopper (sm_90a):
//   out[b] = sum_j h[b, j] * W_down[idx[b, j]],  idx == d_ff = empty slot.
//
// Replaces: src/repro/kernels/sparse_ffn.py `_sparse_kernel` (body) and
// `sparse_gather_matvec` (wrapper) — the Pallas kernel whose index map
// DMAs only the active rows of W_down, one grid step per active row.
//
// What bounds it on this card: bytes. Each valid slot reads one W_down row
// (4*d bytes) for 2*d flops, 0.5 flop per byte, far below the f32 ridge
// (~20 flop/byte). The least time is the distinct active rows' bytes over
// the memory rate, and reaching it takes many independent row loads in
// flight on every SM. At nectar widths W_down (320 KB) sits in L2 and a
// launch is a few microseconds of work: there the length of each thread's
// chain of dependent loads is what costs.
//
// What the design does about it:
//  * Grid (row b, column tile of 32 float4 = 128 floats of d, k-split).
//    The host picks the k-split from B, d and k and the card's SM count so
//    that a few rows of a wide layer still launch several CTAs per SM.
//  * 8 warps per CTA: lane l owns float4 column l of the tile (a gathered
//    row is read as 512 contiguous bytes per warp), warp w takes the
//    split's slots w, w+8, ...; no thread walks more than a split's k/8
//    slots. Each thread issues kUnroll independent row loads before their
//    FMAs, so the loads do not wait on one another.
//  * The split's k values of h and idx are staged in shared memory once.
//    The sentinel index d_ff is skipped inside the kernel: no zero row is
//    concatenated onto W_down (the Pallas wrapper copies W_down to append
//    one on every call).
//  * Deterministic sums, no float atomics: the warps' partials are summed
//    in shared memory in warp order; with a k-split each CTA writes its
//    partial and sparse_gather_combine sums them in split order.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;              // independent row loads in flight
constexpr int kTile = 32;               // float4 columns per CTA

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// grid (B, ceil(d4 / kTile), n_split); `per` slots per split.
__global__ void __launch_bounds__(kThreads)
sparse_gather_kernel(const float* __restrict__ h, const int* __restrict__ idx,
                     const float4* __restrict__ w, float4* __restrict__ out,
                     float4* __restrict__ part, int k, int d_ff, int d4,
                     int per) {
  extern __shared__ float4 smem4[];
  float4* red_s = smem4;                                 // [kWarps][kTile]
  float* h_s = reinterpret_cast<float*>(red_s + kWarps * kTile);
  int* idx_s = reinterpret_cast<int*>(h_s + per);
  const int b = blockIdx.x, split = blockIdx.z;
  const int B = gridDim.x, n_split = gridDim.z;
  const int j0 = split * per;
  const int n = min(k, j0 + per) - j0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    h_s[j] = h[(size_t)b * k + j0 + j];
    idx_s[j] = idx[(size_t)b * k + j0 + j];
  }
  __syncthreads();

  const int col = blockIdx.y * kTile + lane;
  const bool col_ok = col < d4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int jb = warp; jb < n; jb += kWarps * kUnroll) {
    float4 wv[kUnroll];
    float hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {        // all loads first
      const int j = jb + kWarps * u;
      const int row = j < n ? idx_s[j] : -1;
      const bool ok = col_ok && row >= 0 && row < d_ff;   // sentinel: skip
      hv[u] = ok ? h_s[j] : 0.f;
      wv[u] = ok ? __ldg(&w[(size_t)row * d4 + col])
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {        // then their FMAs, in order
      acc.x = fmaf(hv[u], wv[u].x, acc.x);
      acc.y = fmaf(hv[u], wv[u].y, acc.y);
      acc.z = fmaf(hv[u], wv[u].z, acc.z);
      acc.w = fmaf(hv[u], wv[u].w, acc.w);
    }
  }
  red_s[warp * kTile + lane] = acc;
  __syncthreads();
  if (warp != 0 || !col_ok) return;
  float4 sum = red_s[lane];
#pragma unroll
  for (int v = 1; v < kWarps; ++v) add4(sum, red_s[v * kTile + lane]);
  if (n_split == 1)
    out[(size_t)b * d4 + col] = sum;
  else
    part[((size_t)split * B + b) * d4 + col] = sum;
}

// out[b] = sum over splits, in split order, of part[split][b].
__global__ void __launch_bounds__(256)
sparse_gather_combine(const float4* __restrict__ part,
                      float4* __restrict__ out, int B, int d4, int n_split) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t n = (size_t)B * d4;
  if (i >= n) return;
  float4 sum = part[i];
  for (int s = 1; s < n_split; ++s) add4(sum, part[(size_t)s * n + i]);
  out[i] = sum;
}

}  // namespace

// h f32[B,k]; idx i32[B,k]; w_down f32[d_ff,d] with d % 4 == 0 and a
// 16-byte aligned base; out f32[B,d]; with n_split > 1 the scratch part
// f32[n_split,B,d] (unused, and may be null, when n_split == 1). The k
// slots are cut into n_split splits of ceil(k / n_split) slots, none
// empty. All contiguous, on the current device. Launches the main kernel
// and, when n_split > 1, the combine pass. Returns the cudaError_t of the
// launches (0 = success).
extern "C" int sparse_gather_matvec_f32(const float* h, const int* idx,
                                        const float* w_down, float* out,
                                        float* part, int B, int k, int d_ff,
                                        int d, int n_split, void* stream) {
  if (B <= 0 || k <= 0 || d_ff <= 0 || d <= 0 || d % 4 != 0 ||
      n_split <= 0 || n_split > 65535 ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (k + n_split - 1) / n_split;
  if ((n_split - 1) * per >= k) return (int)cudaErrorInvalidValue;
  const int d4 = d / 4;
  const int n_tiles = (d4 + kTile - 1) / kTile;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float4) * kWarps * kTile +
                      (size_t)per * (sizeof(float) + sizeof(int));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sparse_gather_kernel<<<dim3(B, n_tiles, n_split), kThreads, smem, st>>>(
      h, idx, reinterpret_cast<const float4*>(w_down),
      reinterpret_cast<float4*>(out), reinterpret_cast<float4*>(part), k,
      d_ff, d4, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const size_t n = (size_t)B * d4;
  sparse_gather_combine<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
      B, d4, n_split);
  return (int)cudaGetLastError();
}
