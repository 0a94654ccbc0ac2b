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
// the memory rate; at the nectar widths W_down (320 KB) sits in L2 and a
// launch is a few microseconds of work, so launch latency bounds it.
//
// What the design does about it:
//  * One thread block per row b. The row's k values of h and idx are
//    staged in shared memory once; threads span d with 16-byte float4
//    loads, neighbouring threads on neighbouring addresses, so every
//    gathered W_down row is read as whole contiguous segments.
//  * The sentinel index d_ff is skipped inside the kernel: no zero row is
//    concatenated onto W_down (the Pallas wrapper copies W_down to append
//    one on every call).
//  * f32 accumulation in registers, one pass over the k slots.
// A simple kernel first: no cp.async staging of rows, no reuse of rows
// shared by several batch rows.

#include <cuda_runtime.h>

namespace {

__global__ void sparse_gather_kernel(const float* __restrict__ h,
                                     const int* __restrict__ idx,
                                     const float4* __restrict__ w,
                                     float4* __restrict__ out, int k,
                                     int d_ff, int d4) {
  extern __shared__ unsigned char smem_raw[];
  float* h_s = reinterpret_cast<float*>(smem_raw);
  int* idx_s = reinterpret_cast<int*>(h_s + k);
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    h_s[j] = h[(size_t)b * k + j];
    idx_s[j] = idx[(size_t)b * k + j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d4; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < k; ++j) {
      const int row = idx_s[j];
      if (row < 0 || row >= d_ff) continue;   // empty slot: no row to read
      const float hv = h_s[j];
      const float4 wv = __ldg(&w[(size_t)row * d4 + c]);
      acc.x = fmaf(hv, wv.x, acc.x);
      acc.y = fmaf(hv, wv.y, acc.y);
      acc.z = fmaf(hv, wv.z, acc.z);
      acc.w = fmaf(hv, wv.w, acc.w);
    }
    out[(size_t)b * d4 + c] = acc;
  }
}

}  // namespace

// h f32[B,k]; idx i32[B,k]; w_down f32[d_ff,d] with d % 4 == 0 and a
// 16-byte aligned base; out f32[B,d]. All contiguous, on the current
// device. Returns the cudaError_t of the launch (0 = success).
extern "C" int sparse_gather_matvec_f32(const float* h, const int* idx,
                                        const float* w_down, float* out,
                                        int B, int k, int d_ff, int d,
                                        void* stream) {
  if (B <= 0 || k <= 0 || d_ff <= 0 || d <= 0 || d % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int d4 = d / 4;
  const int threads = d4 >= 256 ? 256 : ((d4 + 31) / 32) * 32;
  const size_t smem = (size_t)k * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  sparse_gather_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      h, idx, reinterpret_cast<const float4*>(w_down),
      reinterpret_cast<float4*>(out), k, d_ff, d4);
  return (int)cudaGetLastError();
}
