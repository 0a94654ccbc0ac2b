// Paged attention through block tables, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn.py `_paged_attn_kernel` (body)
// and `paged_attention` (wrapper) — the Pallas kernel whose sequential grid
// axis walks one row's table entries with the online softmax in VMEM.
//
// What bounds it on this card: bytes. Every key costs 4*Dh flops against
// 2*Dh*4 bytes of K and V (0.5 flop per byte per query row), far below the
// f32 ridge of the H100 (67 TFLOP/s over 3.35 TB/s, ~20 flop/byte), so the
// least time is the KV bytes the rows' causal contexts hold over the
// memory rate. At the nectar widths the whole pool sits in the 50 MB L2 and
// a launch is a few microseconds of work: there launch latency bounds it.
//
// What the design does about it:
//  * One thread block per (row b, KV head). All S*G query rows that share
//    the head read each K/V block from device memory once, staged in
//    shared memory. CUDA blocks run in no order, so the Pallas grid axis
//    over table entries becomes a loop inside the block.
//  * The loop stops at the block that holds the last causal position
//    lens[b]+S-1 and skips entries outside [0, n_blocks) (the sentinel
//    n_blocks) without dereferencing them: both only ever hold positions
//    past every query's causal limit.
//  * f32 online softmax (m, l, acc) in shared memory, one warp per query
//    row: lane t scores key t of the block, the probabilities are
//    broadcast by shuffles, lane d accumulates output dims d, d+32, ...
//    A row with no visible key in a block skips it (the `alive` guard);
//    the last divide is by max(l, 1e-30), so an IDLE row whose table is
//    all sentinels gives finite zeros.
// A simple kernel first: no TMA, no tensor cores, no cp.async pipeline.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlockTokens = 32;   // one key per lane of a warp

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens,
                       float* __restrict__ out,
                       int S, int Hq, int Kv, int n_blocks, int bs, int MB,
                       float scale) {
  constexpr int KP = DH + 1;   // padded K rows: lane t reads row t without
                               // shared-memory bank conflicts
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Kv;
  const int R = S * G;         // query rows that share this KV head
  extern __shared__ float smem[];
  float* q_s = smem;                        // [R][DH], scaled by Dh^-0.5
  float* acc_s = q_s + R * DH;              // [R][DH]
  float* m_s = acc_s + R * DH;              // [R]
  float* l_s = m_s + R;                     // [R]
  float* k_s = l_s + R;                     // [kMaxBlockTokens][KP]
  float* v_s = k_s + kMaxBlockTokens * KP;  // [kMaxBlockTokens][DH]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int L = lens[b];

  // row r = j*G + g holds query j of head kvh*G + g
  for (int i = tid; i < R * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int j = r / G, g = r % G;
    q_s[i] = q[(((size_t)b * S + j) * Hq + kvh * G + g) * DH + d] * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int n_m = min(MB, (L + S - 1) / bs + 1);
  for (int m = 0; m < n_m; ++m) {
    const int blk = tables[(size_t)b * MB + m];
    if (blk < 0 || blk >= n_blocks) continue;   // sentinel: never read
    __syncthreads();                            // previous block consumed
    for (int i = tid; i < bs * DH; i += kThreads) {
      const int t = i / DH, d = i % DH;
      const size_t src = (((size_t)blk * bs + t) * Kv + kvh) * DH + d;
      k_s[t * KP + d] = k_pool[src];
      v_s[t * DH + d] = v_pool[src];
    }
    __syncthreads();
    const int kpos = m * bs + lane;
    for (int r = warp; r < R; r += kWarps) {
      const bool vis = lane < bs && kpos <= L + r / G;
      float s = -INFINITY;
      if (vis) {
        const float* qr = q_s + r * DH;
        const float* kr = k_s + lane * KP;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      const float bmax = warp_max(s);
      if (bmax == -INFINITY) continue;          // warp-uniform: no visible key
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, bmax);
      const float p = vis ? expf(s - m_new) : 0.f;
      const float corr = expf(m_old - m_new);   // 0 on the row's first block
      const float psum = warp_sum(p);
#pragma unroll
      for (int c = 0; c < DH / 32; ++c) {
        const int d = lane + 32 * c;
        float a = acc_s[r * DH + d] * corr;
        for (int t = 0; t < bs; ++t)
          a = fmaf(__shfl_sync(0xffffffffu, p, t), v_s[t * DH + d], a);
        acc_s[r * DH + d] = a;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + psum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < R * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int j = r / G, g = r % G;
    out[(((size_t)b * S + j) * Hq + kvh * G + g) * DH + d] =
        acc_s[i] / fmaxf(l_s[r], 1e-30f);
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* tables, const int* lens, float* out, int B,
                   int S, int Hq, int Kv, int n_blocks, int bs, int MB,
                   float scale, cudaStream_t stream) {
  const int R = S * (Hq / Kv);
  const size_t smem = sizeof(float) *
      (2 * (size_t)R * DH + 2 * (size_t)R +
       (size_t)kMaxBlockTokens * (DH + 1) + (size_t)kMaxBlockTokens * DH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<DH><<<dim3(Kv, B), kThreads, smem, stream>>>(
      q, k_pool, v_pool, tables, lens, out, S, Hq, Kv, n_blocks, bs, MB,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q f32[B,S,Hq,Dh]; k_pool, v_pool f32[n_blocks,bs,Kv,Dh]; tables
// i32[B,MB]; lens i32[B]; out f32[B,S,Hq,Dh]. All contiguous, on the
// current device. Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool, const int* tables,
                                   const int* lens, float* out, int B, int S,
                                   int Hq, int Kv, int Dh, int n_blocks,
                                   int bs, int MB, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Kv <= 0 || Hq % Kv != 0 || bs <= 0 ||
      bs > kMaxBlockTokens || MB <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32:
      return (int)launch<32>(q, k_pool, v_pool, tables, lens, out, B, S, Hq,
                             Kv, n_blocks, bs, MB, scale, st);
    case 64:
      return (int)launch<64>(q, k_pool, v_pool, tables, lens, out, B, S, Hq,
                             Kv, n_blocks, bs, MB, scale, st);
    case 128:
      return (int)launch<128>(q, k_pool, v_pool, tables, lens, out, B, S, Hq,
                              Kv, n_blocks, bs, MB, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
