// GQA flash-decode over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn.py `_decode_kernel` (body) and
// `decode_attention` (wrapper) — the Pallas kernel whose sequential grid
// axis streams every block_s-wide KV block of the S-long cache and masks
// positions >= kv_len.
//
// What bounds it on this card: bytes. Each visible key costs 4*Dh*G flops
// against 2*Dh K/V elements (G = Hq/Kv query heads share them), a few
// flops per byte, far below the f32 ridge (67 TFLOP/s over 3.35 TB/s, ~20
// flop/byte). The least time is the K/V bytes of the visible positions
// over the memory rate; at nectar widths the whole cache sits in the 50 MB
// L2 and launch latency bounds a call.
//
// What the design does about it:
//  * One thread block per (row b, KV head): the G query heads of that KV
//    head read each K/V row once. The Pallas grid streams all S positions
//    and masks the tail; here the loop stops at n = min(kv_len[b], S), so
//    an idle slot whose kv_len ran past S (the slot engine decodes every
//    slot, and its writes there drop) reads exactly S rows and no further.
//  * The block's warps split the visible keys into 32-key chunks (chunk c
//    goes to warp c % kWarps). A warp stages its chunk's K and V rows in
//    its own shared memory with coalesced loads (bf16 is widened to f32
//    there), lane t scores key t, and the warp keeps its own f32 online
//    softmax (m, l, acc). The warps' states merge in fixed warp order at
//    the end, so the result does not change from run to run.
//  * kv_len <= 0 masks every position, which in the reference turns every
//    score into the same -1e30 and the softmax into a mean over all S
//    positions; the kernel reproduces that by scoring all S keys as 0.
// A simple kernel first: no TMA, no tensor cores, no split of one row's
// keys across thread blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;             // keys per warp chunk: one per lane

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared memory, per block:
//   q_s   [G][DH]                   queries scaled by Dh^-0.5
//   per warp w:
//     k_s [kChunk][DH + 1]          padded: lane t reads row t conflict-free
//     v_s [kChunk][DH]
//     acc [G][DH], m [G], l [G]
template <int DH>
__host__ __device__ constexpr size_t warp_floats(int G) {
  return (size_t)kChunk * (DH + 1) + (size_t)kChunk * DH +
         (size_t)G * DH + 2 * (size_t)G;
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out,
                        int S, int Hq, int Kv, float scale) {
  constexpr int KP = DH + 1;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* wbase = q_s + (size_t)G * DH + (size_t)warp * warp_floats<DH>(G);
  float* k_s = wbase;
  float* v_s = k_s + kChunk * KP;
  float* acc_s = v_s + kChunk * DH;
  float* m_s = acc_s + G * DH;
  float* l_s = m_s + G;

  for (int i = tid; i < G * DH; i += kThreads)
    q_s[i] = q[((size_t)b * Hq + kvh * G) * DH + i] * scale;
  for (int i = lane; i < G * DH; i += 32) acc_s[i] = 0.f;
  for (int g = lane; g < G; g += 32) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int L = kv_len[b];
  const bool uniform = L <= 0;          // every position masked: a mean
  const int n = uniform ? S : min(L, S);
  const size_t row_stride = (size_t)Kv * DH;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)kvh * DH;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)kvh * DH;

  for (int t0 = warp * kChunk; t0 < n; t0 += kWarps * kChunk) {
    // stage this chunk's rows; rows past n are zeros (0 * p stays finite)
    for (int i = lane; i < kChunk * DH; i += 32) {
      const int t = i / DH, d = i % DH;
      float kv = 0.f, vv = 0.f;
      if (t0 + t < n) {
        kv = to_f32(kb[(size_t)(t0 + t) * row_stride + d]);
        vv = to_f32(vb[(size_t)(t0 + t) * row_stride + d]);
      }
      k_s[t * KP + d] = kv;
      v_s[t * DH + d] = vv;
    }
    __syncwarp();
    const bool valid = t0 + lane < n;
    for (int g = 0; g < G; ++g) {
      float s = -INFINITY;
      if (valid) {
        if (uniform) {
          s = 0.f;
        } else {
          const float* qr = q_s + g * DH;
          const float* kr = k_s + lane * KP;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot;
        }
      }
      const float cmax = warp_max(s);            // finite: lane 0 is valid
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, cmax);
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m_old - m_new);    // 0 on the warp's 1st chunk
      const float psum = warp_sum(p);
#pragma unroll
      for (int c = 0; c < DH / 32; ++c) {
        const int d = lane + 32 * c;
        float a = acc_s[g * DH + d] * corr;
#pragma unroll 8
        for (int t = 0; t < kChunk; ++t)
          a = fmaf(__shfl_sync(0xffffffffu, p, t), v_s[t * DH + d], a);
        acc_s[g * DH + d] = a;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the warps' softmax states in warp order
  const float* w0 = q_s + (size_t)G * DH;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH;
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      const float* ms = w0 + w * warp_floats<DH>(G) + kChunk * KP +
                        kChunk * DH + G * DH;
      m = fmaxf(m, ms[g]);
    }
    float l = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* as = w0 + w * warp_floats<DH>(G) + kChunk * KP +
                        kChunk * DH;
      const float mw = as[G * DH + g];
      if (mw == -INFINITY) continue;             // this warp saw no key
      const float f = expf(mw - m);
      l = fmaf(as[G * DH + G + g], f, l);
      a = fmaf(as[i], f, a);
    }
    out[((size_t)b * Hq + kvh * G) * DH + i] = a / fmaxf(l, 1e-30f);
  }
}

template <int DH, typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* kv_len, float* out, int B, int S, int Hq,
                   int Kv, float scale, cudaStream_t stream) {
  const int G = Hq / Kv;
  const size_t smem =
      sizeof(float) * ((size_t)G * DH + kWarps * warp_floats<DH>(G));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<DH, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_attention_kernel<DH, T><<<dim3(Kv, B), kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), kv_len, out, S,
      Hq, Kv, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const float* q, const void* k, const void* v, const int* kv_len,
             float* out, int B, int S, int Hq, int Kv, int Dh, float scale,
             void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || Hq % Kv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32:
      return (int)launch<32, T>(q, k, v, kv_len, out, B, S, Hq, Kv, scale,
                                st);
    case 64:
      return (int)launch<64, T>(q, k, v, kv_len, out, B, S, Hq, Kv, scale,
                                st);
    case 128:
      return (int)launch<128, T>(q, k, v, kv_len, out, B, S, Hq, Kv, scale,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q f32[B,Hq,Dh]; k, v [B,S,Kv,Dh] in f32 (_f32) or bf16 (_bf16); kv_len
// i32[B]; out f32[B,Hq,Dh]. All contiguous, on the current device.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* kv_len,
                                    float* out, int B, int S, int Hq, int Kv,
                                    int Dh, float scale, void* stream) {
  return dispatch<float>(q, k, v, kv_len, out, B, S, Hq, Kv, Dh, scale,
                         stream);
}

extern "C" int decode_attention_bf16(const float* q, const void* k,
                                     const void* v, const int* kv_len,
                                     float* out, int B, int S, int Hq,
                                     int Kv, int Dh, float scale,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, kv_len, out, B, S, Hq, Kv, Dh,
                                 scale, stream);
}
