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
// over the memory rate, and reaching it takes many loads in flight on
// every SM; at nectar widths the whole cache sits in the 50 MB L2 and the
// serial chain of one row's loads is what costs.
//
// What the design does about it:
//  * The visible positions [0, n) of a row, n = min(kv_len, S), are cut
//    into chunks of KC keys (32 at Dh 32, 16 at Dh 64, 8 at Dh 128). The
//    chunks of one (row b, KV head) are dealt out round-robin over
//    n_split CTAs (chunk c goes to CTA c % n_split) and, inside a CTA,
//    over its 4 warps, so a short context and a long one both spread over
//    every split. The host picks n_split from S, B*Kv and the SM count
//    (`decode_attn.decode_plan`), never from kv_len, so no device->host
//    sync is added. Each CTA writes its partial (m, l, acc) and
//    decode_attention_combine merges them in split order; with
//    n_split == 1 the CTA writes the output itself.
//  * K/V chunks are staged through a two-stage ring per warp with 16-byte
//    cp.async: the next chunk loads while the current one is scored.
//    Positions past n are zero-filled by the copy (src-size 0) and masked.
//    bf16 rows are copied as they are (8 values per copy) and widened to
//    f32 when read from shared memory.
//  * All G query heads of a KV head (up to 16 per CTA; more take more
//    CTAs) are scored in one pass over a chunk: Dh/32 lanes share a key,
//    every lane scores its key against all the CTA's heads from shared
//    queries, and the heads' max/sum reductions interleave. In P·V each
//    lane owns 4 output dims of one key group for every head: no shuffle
//    per FMA.
//  * kv_len <= 0 masks every position, which in the reference turns every
//    score into the same -1e30 and the softmax into a mean over all S
//    positions; the kernel reproduces that by scoring all S keys as 0.
//    kv_len > S (an idle slot of the slot engine) reads exactly S rows.
//  * f32 softmax and sums, no atomics, fixed warp and split order: the
//    same inputs give the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 16;                 // query heads per CTA at most

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void fma4(float p, float4 v, float4& a) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

__device__ __forceinline__ void scale4(float c, float4& a) {
  a.x *= c;
  a.y *= c;
  a.z *= c;
  a.w *= c;
}

// Four consecutive cache values from shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// 16-byte async copy global -> shared; when !valid nothing is read and the
// 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Geometry of one warp's ring, for head dim DH and cache type T.
template <int DH, typename T>
struct Geo {
  static constexpr int LPK = DH / 32;            // lanes sharing one key
  static constexpr int KC = 32 / LPK;            // keys per chunk
  static constexpr int VE = 16 / (int)sizeof(T); // values per 16-byte copy
  static constexpr int KS = DH + VE * LPK;       // padded K row (values)
  static constexpr int NG = DH / 4;              // 4-value groups of a row
  static constexpr int KQ = 32 / NG;             // key groups in P·V
  static constexpr int KPG = KC / KQ;            // keys per key group
  static constexpr int STAGE = KC * (KS + DH) * (int)sizeof(T);   // bytes
};

// Shared memory of one CTA, in bytes: the queries [RM][DH] f32, then per
// warp a two-stage ring (K [KC][KS], V [KC][DH] in T) and P [RM][KC] f32.
template <int DH, int RM, typename T>
__host__ __device__ constexpr size_t warp_bytes() {
  return 2 * (size_t)Geo<DH, T>::STAGE + 4 * (size_t)RM * Geo<DH, T>::KC;
}
template <int DH, int RM, typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return 4 * (size_t)RM * DH + kWarps * warp_bytes<DH, RM, T>();
}

// Grid (n_split, Kv * n_gt, B): CTA (split, kvh * n_gt + gt, b) takes
// query heads [gt*RM, gt*RM + RM) of KV head kvh, n_gt = ceil(G / RM).
template <int DH, int RM, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, float* __restrict__ part_o,
                        float* __restrict__ part_ml, int B, int S, int Hq,
                        int Kv, int n_split, float scale) {
  using G_ = Geo<DH, T>;
  constexpr int LPK = G_::LPK, KC = G_::KC, VE = G_::VE, KS = G_::KS;
  constexpr int NG = G_::NG, KPG = G_::KPG;
  constexpr int CPR = DH / VE;                   // 16-byte copies per row
  const int G = Hq / Kv;
  const int n_gt = (G + RM - 1) / RM;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_gt, g0 = (blockIdx.y % n_gt) * RM;
  const int R = min(RM, G - g0);                 // this CTA's query heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* q_s = reinterpret_cast<float*>(smem);   // [RM][DH]
  char* wbase = smem + 4 * RM * DH + warp * warp_bytes<DH, RM, T>();
  float* p_s = reinterpret_cast<float*>(wbase + 2 * G_::STAGE);  // [RM][KC]

  const int L = kv_len[b];
  const bool uniform = L <= 0;          // every position masked: a mean
  const int n = uniform ? S : min(L, S);
  const int n_chunks = (n + KC - 1) / KC;
  const size_t row_stride = (size_t)Kv * DH;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)kvh * DH;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)kvh * DH;
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * G + g0;

  // stage chunk c (KC keys) into the warp's stage s
  auto stage = [&](int c, int s) {
    T* k_st = reinterpret_cast<T*>(wbase + s * G_::STAGE);
    T* v_st = k_st + KC * KS;
    for (int i = lane; i < KC * CPR; i += 32) {
      const int t = i / CPR, g = i % CPR;
      const int p = c * KC + t;
      const bool ok = p < n;
      const size_t off = ok ? (size_t)p * row_stride + VE * g : 0;
      cp_async16(k_st + t * KS + VE * g, kb + off, ok);
      cp_async16(v_st + t * DH + VE * g, vb + off, ok);
    }
  };

  // this warp's chunks: c = split + n_split * (warp + kWarps * i)
  const int c0 = split + n_split * warp;
  const int cstep = n_split * kWarps;
  float m[RM], lsum[RM];
  float4 acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = -INFINITY;
    lsum[r] = 0.f;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int kt = lane / LPK, kh = lane % LPK;   // score: key, Dh part
  const int dg = lane % NG, kq = lane / NG;     // P·V: 4-value group, keys

  for (int s = 0; s < 2; ++s) {                 // prologue: two chunks
    const int c = c0 + s * cstep;
    if (c < n_chunks) stage(c, s);
    cp_async_commit();
  }
  // the queries load while the first chunks are in flight
  for (int i = tid; i < RM * DH; i += kThreads) {
    const int r = i / DH;
    q_s[i] = r < R ? q[head0 * DH + i] * scale : 0.f;
  }
  __syncthreads();
  int it = 0;
  for (int c = c0; c < n_chunks; c += cstep, ++it) {
    const T* k_st = reinterpret_cast<const T*>(wbase + (it & 1) * G_::STAGE);
    const T* v_st = k_st + KC * KS;
    cp_async_wait<1>();
    __syncwarp();

    const int p = c * KC + kt;
    const bool vis = p < n;
    float sc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) sc[r] = 0.f;
    if (!uniform) {
      const T* kr = k_st + kt * KS;
#pragma unroll
      for (int i = 0; i < CPR / LPK; ++i) {
        const int e = VE * (kh + LPK * i);       // first value of the copy
#pragma unroll
        for (int h = 0; h < VE / 4; ++h) {
          const float4 kv = load4(kr + e + 4 * h);
#pragma unroll
          for (int r = 0; r < RM; ++r)
            sc[r] = dot4(*reinterpret_cast<const float4*>(
                             q_s + r * DH + e + 4 * h),
                         kv, sc[r]);
        }
      }
    }
    float corr[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
      const float s_r = vis ? sc[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s_r));   // finite: key 0
      corr[r] = expf(m[r] - m_new);             // 0 on the first chunk
      const float pr = vis ? expf(s_r - m_new) : 0.f;
      m[r] = m_new;
      lsum[r] = fmaf(lsum[r], corr[r], kh == 0 ? pr : 0.f);
      if (kh == 0) p_s[r * KC + kt] = pr;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RM; ++r) scale4(corr[r], acc[r]);
#pragma unroll
    for (int u = 0; u < KPG; ++u) {
      const int t = kq * KPG + u;
      const float4 vv = load4(v_st + t * DH + 4 * dg);
#pragma unroll
      for (int r = 0; r < RM; ++r) fma4(p_s[r * KC + t], vv, acc[r]);
    }
    __syncwarp();                               // stage and p_s consumed
    const int cn = c + 2 * cstep;
    if (cn < n_chunks) stage(cn, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this warp's state: l summed over lanes, acc summed over key groups
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    lsum[r] = warp_sum(lsum[r]);
#pragma unroll
    for (int o = NG; o < 32; o <<= 1) {
      acc[r].x += __shfl_xor_sync(0xffffffffu, acc[r].x, o);
      acc[r].y += __shfl_xor_sync(0xffffffffu, acc[r].y, o);
      acc[r].z += __shfl_xor_sync(0xffffffffu, acc[r].z, o);
      acc[r].w += __shfl_xor_sync(0xffffffffu, acc[r].w, o);
    }
  }
  __syncwarp();
  // the warp's ring now holds its state: acc [RM][DH], m [RM], l [RM]
  float* wa = reinterpret_cast<float*>(wbase);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (kq == 0) *reinterpret_cast<float4*>(wa + r * DH + 4 * dg) = acc[r];
    if (lane == 0) {
      wa[RM * DH + r] = m[r];
      wa[RM * DH + RM + r] = lsum[r];
    }
  }
  __syncthreads();

  // merge the warps in warp order
  const float* w0 = reinterpret_cast<const float*>(smem + 4 * RM * DH);
  constexpr size_t WSTRIDE = warp_bytes<DH, RM, T>() / 4;
  const size_t rows = (size_t)B * Hq;
  for (int i = tid; i < R * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, w0[w * WSTRIDE + RM * DH + r]);
    float l = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float* ws = w0 + w * WSTRIDE;
        const float mw = ws[RM * DH + r];
        if (mw == -INFINITY) continue;          // this warp saw no key
        const float f = expf(mw - mx);
        l = fmaf(ws[RM * DH + RM + r], f, l);
        a = fmaf(ws[r * DH + d], f, a);
      }
    }
    const size_t row = head0 + r;
    if (n_split == 1) {
      out[row * DH + d] = a / fmaxf(l, 1e-30f);
    } else {
      part_o[((size_t)split * rows + row) * DH + d] = a;
      if (d == 0) {
        part_ml[((size_t)split * rows + row) * 2] = mx;
        part_ml[((size_t)split * rows + row) * 2 + 1] = l;
      }
    }
  }
}

// Merge the n_split partial states of every (row, head) in split order,
// one output value a thread; the loads of kBatch splits are in flight at
// once and merge into a running (max, sum, acc).
constexpr int kBatch = 8;

__global__ void __launch_bounds__(256)
decode_attention_combine(const float* __restrict__ part_o,
                         const float* __restrict__ part_ml,
                         float* __restrict__ out, int rows, int Dh,
                         int n_split) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * Dh) return;
  const size_t row = i / Dh;
  float mx = -INFINITY, l = 0.f, a = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kBatch) {
    float ms[kBatch], ls[kBatch], os[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ms[u] = -INFINITY;
      if (s0 + u < n_split) {
        const size_t base = (size_t)(s0 + u) * rows + row;
        ms[u] = part_ml[base * 2];
        ls[u] = part_ml[base * 2 + 1];
        os[u] = part_o[base * Dh + i % Dh];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (ms[u] == -INFINITY) continue;         // this split saw no key
      const float m_new = fmaxf(mx, ms[u]);
      const float c_old = expf(mx - m_new), c_new = expf(ms[u] - m_new);
      l = fmaf(l, c_old, ls[u] * c_new);
      a = fmaf(a, c_old, os[u] * c_new);
      mx = m_new;
    }
  }
  out[i] = a / fmaxf(l, 1e-30f);
}

struct Args {
  const float* q;
  const void *k, *v;
  const int* kv_len;
  float *out, *part_o, *part_ml;
  int B, S, Hq, Kv, n_split;
  float scale;
};

template <int DH, int RM, typename T>
cudaError_t run(const Args& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH, RM, T>();
  auto kernel = decode_attention_kernel<DH, RM, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int G = a.Hq / a.Kv;
  const dim3 grid(a.n_split, a.Kv * ((G + RM - 1) / RM), a.B);
  kernel<<<grid, kThreads, smem, st>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.kv_len,
      a.out, a.part_o, a.part_ml, a.B, a.S, a.Hq, a.Kv, a.n_split, a.scale);
  return cudaGetLastError();
}

template <int DH, typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int G = a.Hq / a.Kv;
  cudaError_t e;
  if (G == 1)
    e = run<DH, 1, T>(a, st);
  else if (G <= 4)
    e = run<DH, 4, T>(a, st);
  else if (G <= 8)
    e = run<DH, 8, T>(a, st);
  else
    e = run<DH, kMaxRows, T>(a, st);
  if (e != cudaSuccess || a.n_split == 1) return e;
  const int rows = a.B * a.Hq;
  const size_t n = (size_t)rows * DH;
  decode_attention_combine<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part_o, a.part_ml, a.out, rows, DH, a.n_split);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int Dh, void* stream) {
  if (a.B <= 0 || a.B > 65535 || a.S <= 0 || a.Kv <= 0 ||
      a.Hq % a.Kv != 0 || a.n_split <= 0 ||
      (a.n_split > 1 && (a.part_o == nullptr || a.part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32:
      return (int)launch<32, T>(a, st);
    case 64:
      return (int)launch<64, T>(a, st);
    case 128:
      return (int)launch<128, T>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q f32[B,Hq,Dh]; k, v [B,S,Kv,Dh] in f32 (_f32) or bf16 (_bf16), 16-byte
// aligned; kv_len i32[B]; out f32[B,Hq,Dh]; with n_split > 1 the scratch
// part_o f32[n_split,B,Hq,Dh] and part_ml f32[n_split,B,Hq,2] (unused, and
// may be null, when n_split == 1). All contiguous, on the current device.
// Launches the main kernel and, when n_split > 1, the combine pass.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* kv_len,
                                    float* out, float* part_o,
                                    float* part_ml, int B, int S, int Hq,
                                    int Kv, int Dh, int n_split, float scale,
                                    void* stream) {
  const Args a{q, k, v, kv_len, out, part_o, part_ml,
               B, S, Hq, Kv, n_split, scale};
  return dispatch<float>(a, Dh, stream);
}

extern "C" int decode_attention_bf16(const float* q, const void* k,
                                     const void* v, const int* kv_len,
                                     float* out, float* part_o,
                                     float* part_ml, int B, int S, int Hq,
                                     int Kv, int Dh, int n_split,
                                     float scale, void* stream) {
  const Args a{q, k, v, kv_len, out, part_o, part_ml,
               B, S, Hq, Kv, n_split, scale};
  return dispatch<__nv_bfloat16>(a, Dh, stream);
}
