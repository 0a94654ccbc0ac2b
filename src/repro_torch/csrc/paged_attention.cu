// Paged attention through block tables, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attn.py `_paged_attn_kernel` (body)
// and `paged_attention` (wrapper) — the Pallas kernel whose sequential grid
// axis walks one row's table entries with the online softmax in VMEM.
//
// What bounds it on this card. Few query rows per KV head (decode, S*G
// small): bytes. Every key costs 4*Dh flops per query row against 2*Dh*4
// bytes of K and V, far below the f32 ridge of the H100 (67 TFLOP/s over
// 3.35 TB/s, ~20 flop/byte): the least time is the K/V bytes the causal
// contexts hold over the memory rate, and reaching it takes many loads in
// flight on every SM. Many query rows (a prefill chunk of a GQA model,
// S*G >= 16): f32 operations, 4*Dh flops per (row, key) on CUDA cores.
// At nectar widths the pool sits in the 50 MB L2 and a launch is a few
// microseconds of work: there the serial chain of loads is what costs.
//
// What the design does about it:
//  * The context is split into chunks of kc consecutive positions (any
//    block_size: a chunk may span several table entries; a key's entry is
//    position / bs). The chunks of one (row b, KV head) are dealt out in a
//    fixed order over n_split CTAs (flash-decoding) and, in the rows
//    kernel, over the CTA's warps: chunk c goes to CTA c % n_split. The
//    host picks n_split from MB (the table width) and the card's SM count,
//    never from lens, so no device->host sync is added. Each CTA writes
//    its partial (m, l, acc) and paged_attention_combine merges them in
//    split order; with n_split == 1 the CTA writes the output itself.
//  * K/V chunks are staged through a two-stage shared-memory ring with
//    16-byte cp.async: the next chunk loads while the current one is
//    scored. Positions past the rows' causal limit, past MB, or in a
//    sentinel table entry are zero-filled by the copy (src-size 0) and
//    never dereferenced; they are masked out of the softmax. f32 pools
//    copy 4 values and bf16 pools 8 values a copy; bf16 is widened to f32
//    when read from shared memory (exactly), so both types share the f32
//    arithmetic below.
//  * Rows kernel (S*G < 16): 4 warps per CTA, each with its own ring and
//    its own f32 online softmax for all S*G rows, merged in fixed warp
//    order at the end. In the score every lane works: max(1, Dh/32) lanes
//    share a key (a 32-key chunk at Dh 16 and 32, 16 at Dh 64, 8 at Dh
//    128; at Dh 16 a lane holds its key's whole row of 16 values), so a
//    block of 16 tokens no longer masks half the warp. In P·V each lane
//    owns 4 output dims of one key group (8 groups of 4 keys at Dh 16);
//    no shuffle per FMA.
//  * Tile kernel (S*G >= 16): a CTA takes a tile of 32 or 64 query rows
//    of one KV head (the tiles split across CTAs, so no shared-memory cap
//    on S*G), 128 threads as 16 row groups x 8 key groups. Each thread
//    computes a (rows/16) x 4 micro-tile of scores from float4 shared
//    loads (queries staged once, K rows padded for conflict-free reads),
//    the softmax reduces over the 8 lanes of a row group by shuffles, and
//    P·V uses the same tiling: each thread owns (rows/16) x (Dh/8)
//    outputs (float4s 32 floats apart, or at Dh 16 one float2). The query
//    tile stays in shared memory, not registers: (rows/16) rows of Dh
//    floats per thread would not fit the register file at Dh 128.
//  * Head dims 16, 32, 64 and 128 (every d_head a config of the repo
//    uses); the host entry refuses any other.
//  * f32 arithmetic throughout, no tensor cores (TF32 would not hold
//    1e-4), no float atomics: the same inputs give the same bits every
//    run. The last divide is by max(l, 1e-30), so an IDLE row
//    (all-sentinel table) gives exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileChunk = 32;              // keys per chunk, tile kernel
constexpr int kTilePS = kTileChunk + 8;     // padded P row (floats)
constexpr size_t kSmemLimit = 232448;       // bytes one block may use

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

// Four (two) consecutive pool values from shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// Where each chunk's keys come from. tbl_s holds the row's first n_ent
// table entries; position p is valid iff its entry is one of them and not
// a sentinel.
template <typename T>
struct Ctx {
  const T* k_pool;
  const T* v_pool;
  const int* tbl_s;
  int n_ent, n_blocks, bs, Kv, kvh;
};

template <int DH, typename T>
__device__ __forceinline__ bool key_src(const Ctx<T>& c, int p,
                                        size_t* off) {
  const int e = p / c.bs;
  if (e >= c.n_ent) return false;
  const int blk = c.tbl_s[e];
  if (blk < 0 || blk >= c.n_blocks) return false;
  *off = (((size_t)blk * c.bs + (p - e * c.bs)) * c.Kv + c.kvh) * DH;
  return true;
}

// Stage chunk `chunk` (KC keys) into k_st [KC][KS] and v_st [KC][DH]
// (values of T), 16-byte copies spread over `nthr` threads of index `t0`.
template <int DH, int KC, int KS, typename T>
__device__ __forceinline__ void stage_chunk(const Ctx<T>& c, int chunk,
                                            T* k_st, T* v_st, int t0,
                                            int nthr) {
  constexpr int VE = 16 / (int)sizeof(T);       // values per copy
  constexpr int CPR = DH / VE;                  // copies per row
  for (int i = t0; i < KC * CPR; i += nthr) {
    const int t = i / CPR, g = i % CPR;
    size_t off = 0;
    const bool ok = key_src<DH>(c, chunk * KC + t, &off);
    cp_async16(k_st + t * KS + VE * g, c.k_pool + off + VE * g, ok);
    cp_async16(v_st + t * DH + VE * g, c.v_pool + off + VE * g, ok);
  }
}

__device__ __forceinline__ void load_table(int* tbl_s, const int* tables,
                                           int b, int MB, int n_ent) {
  for (int e = threadIdx.x; e < n_ent; e += blockDim.x)
    tbl_s[e] = tables[(size_t)b * MB + e];
}

// Geometry of the rows kernel's per-warp ring (see the header), for head
// dim DH and pool type T.
template <int DH, typename T>
struct RowsGeo {
  static constexpr int LPK = DH >= 32 ? DH / 32 : 1;  // lanes sharing a key
  static constexpr int KC = 32 / LPK;                 // keys per chunk
  static constexpr int VE = 16 / (int)sizeof(T);      // values per copy
  static constexpr int KS = DH + VE * LPK;            // padded K row
  static constexpr int NG = DH / 4;                   // 4-value groups
  static constexpr int KQ = 32 / NG;                  // key groups in P·V
  static constexpr int KPG = KC / KQ;                 // keys per key group
  static constexpr int CPR = DH / VE;                 // copies per row
  static constexpr int STAGE = KC * (KS + DH) * (int)sizeof(T);   // bytes
};

__host__ __device__ constexpr int table_floats(int MB) {
  return (MB + 3) / 4 * 4;
}

// Per warp: the two-stage ring, then P [RM][KC] f32.
template <int DH, int RM, typename T>
__host__ __device__ constexpr size_t rows_warp_bytes() {
  using G = RowsGeo<DH, T>;
  return 2 * (size_t)G::STAGE + 4 * (size_t)RM * G::KC;
}

// The table, the queries [RM][DH] f32, then kWarps warps' rings.
template <int DH, int RM, typename T>
__host__ __device__ constexpr size_t rows_smem_bytes(int MB) {
  return 4 * (size_t)table_floats(MB) + 4 * (size_t)RM * DH +
         kWarps * rows_warp_bytes<DH, RM, T>();
}

// Rows kernel: grid (n_split, Kv, B); S*G = R <= RM rows per KV head.
template <int DH, int RM, typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel_rows(const float* __restrict__ q,
                            const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ lens,
                            float* __restrict__ out,
                            float* __restrict__ part_o,
                            float* __restrict__ part_ml, int B, int S, int Hq,
                            int Kv, int n_blocks, int bs, int MB, int n_split,
                            float scale) {
  using Geo = RowsGeo<DH, T>;
  constexpr int LPK = Geo::LPK, KC = Geo::KC, KS = Geo::KS, NG = Geo::NG;
  constexpr int KPG = Geo::KPG, VE = Geo::VE, CPR = Geo::CPR;
  constexpr size_t WBYTES = rows_warp_bytes<DH, RM, T>();
  // after the loop the warp's ring holds its acc [RM][DH], m and l
  static_assert(WBYTES >= 4 * ((size_t)RM * DH + 2 * RM),
                "a warp's ring must hold its final state");
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Kv;
  const int R = S * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  int* tbl_s = reinterpret_cast<int*>(smem);
  float* q_s = reinterpret_cast<float*>(smem) + table_floats(MB);  // [RM][DH]
  char* wbase = reinterpret_cast<char*>(q_s + RM * DH) + warp * WBYTES;
  float* p_s = reinterpret_cast<float*>(wbase + 2 * Geo::STAGE);  // [RM][KC]

  const int L = lens[b];
  const int last = L + S - 1;                  // last visible position
  const int n_ent = min(MB, last / bs + 1);
  const int n_chunks = min((MB * bs + KC - 1) / KC, last / KC + 1);
  load_table(tbl_s, tables, b, MB, n_ent);
  for (int i = tid; i < RM * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float v = 0.f;
    if (r < R)
      v = q[(((size_t)b * S + r / G) * Hq + kvh * G + r % G) * DH + d] *
          scale;
    q_s[i] = v;
  }
  __syncthreads();

  const Ctx<T> ctx{k_pool, v_pool, tbl_s, n_ent, n_blocks, bs, Kv, kvh};
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
    if (c < n_chunks) {
      T* k_st = reinterpret_cast<T*>(wbase + s * Geo::STAGE);
      stage_chunk<DH, KC, KS>(ctx, c, k_st, k_st + KC * KS, lane, 32);
    }
    cp_async_commit();
  }
  int it = 0;
  for (int c = c0; c < n_chunks; c += cstep, ++it) {
    T* k_st = reinterpret_cast<T*>(wbase + (it & 1) * Geo::STAGE);
    T* v_st = k_st + KC * KS;
    cp_async_wait<1>();
    __syncwarp();

    const int p = c * KC + kt;
    size_t off;
    const bool key_ok = key_src<DH>(ctx, p, &off);
    float sc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) sc[r] = 0.f;
    const T* kr = k_st + kt * KS;
#pragma unroll
    for (int i = 0; i < CPR / LPK; ++i) {
      const int e = VE * (kh + LPK * i);        // first value of the copy
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
    float corr[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
      const bool vis = key_ok && r < R && p <= L + r / G;
      const float s_r = vis ? sc[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s_r));
      float pr = 0.f;
      corr[r] = 1.f;
      if (m_new != -INFINITY) {                 // warp-uniform
        corr[r] = expf(m[r] - m_new);           // 0 on the first live chunk
        pr = vis ? expf(s_r - m_new) : 0.f;
      }
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
      const float4 v = load4(v_st + t * DH + 4 * dg);
#pragma unroll
      for (int r = 0; r < RM; ++r) fma4(p_s[r * KC + t], v, acc[r]);
    }
    __syncwarp();                               // stage and p_s consumed
    const int cn = c + 2 * cstep;
    if (cn < n_chunks)
      stage_chunk<DH, KC, KS>(ctx, cn, k_st, v_st, lane, 32);
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
  float* wm = wa + RM * DH;
  float* wl = wm + RM;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (kq == 0) *reinterpret_cast<float4*>(wa + r * DH + 4 * dg) = acc[r];
    if (lane == 0) {
      wm[r] = m[r];
      wl[r] = lsum[r];
    }
  }
  __syncthreads();

  // merge the warps in warp order
  const float* w0 = q_s + RM * DH;
  constexpr size_t WSTRIDE = WBYTES / 4;
  const int rows = B * S * Hq;
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
    const size_t row = ((size_t)b * S + r / G) * Hq + kvh * G + r % G;
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

template <int DH, int RPT, typename T>
struct TileGeo {
  static constexpr int RT = 16 * RPT;           // query rows per tile
  static constexpr int KC = kTileChunk;
  static constexpr int VE = 16 / (int)sizeof(T);
  static constexpr int KS = DH + VE;            // padded K row (values)
  static constexpr int QS = DH + 4;             // padded Q row (floats)
  static constexpr int STAGE = KC * (KS + DH) * (int)sizeof(T);   // bytes
  // P·V: float4 outputs of a row per thread (DH >= 32), one float2 at 16
  static constexpr int NC = DH >= 32 ? DH / 32 : 1;
};

// The table, the query tile [RT][QS] f32, the ring, P [RT][kTilePS] f32.
template <int DH, int RPT, typename T>
__host__ __device__ constexpr size_t tile_smem_bytes(int MB) {
  using G = TileGeo<DH, RPT, T>;
  return 4 * (size_t)table_floats(MB) + 4 * (size_t)G::RT * G::QS +
         2 * (size_t)G::STAGE + 4 * (size_t)G::RT * kTilePS;
}

// P·V operand c2 of thread tk in a V row: 4 values at 4*tk + 32*c2, or
// at Dh 16 two values at 2*tk (the upper two lanes of the float4 zero).
template <int DH, typename T>
__device__ __forceinline__ float4 v_part(const T* row, int tk, int c2) {
  if constexpr (DH >= 32) {
    return load4(row + 4 * tk + 32 * c2);
  } else {
    const float2 h = load2(row + 2 * tk);
    return make_float4(h.x, h.y, 0.f, 0.f);
  }
}

template <int DH>
__device__ __forceinline__ void store_part(float* row, int tk, int c2,
                                           float4 a) {
  if constexpr (DH >= 32)
    *reinterpret_cast<float4*>(row + 4 * tk + 32 * c2) = a;
  else
    *reinterpret_cast<float2*>(row + 2 * tk) = make_float2(a.x, a.y);
}

// Tile kernel: grid (n_split, Kv * n_rt, B); a tile of RT = 16*RPT query
// rows of one KV head.
template <int DH, int RPT, typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel_tile(const float* __restrict__ q,
                            const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ lens,
                            float* __restrict__ out,
                            float* __restrict__ part_o,
                            float* __restrict__ part_ml, int B, int S, int Hq,
                            int Kv, int n_blocks, int bs, int MB, int n_split,
                            float scale) {
  using Geo = TileGeo<DH, RPT, T>;
  constexpr int RT = Geo::RT, KC = Geo::KC, KS = Geo::KS, QS = Geo::QS;
  constexpr int NG = DH / 4, NC = Geo::NC;
  const int G = Hq / Kv;
  const int R = S * G;
  const int n_rt = (R + RT - 1) / RT;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_rt, r0 = (blockIdx.y % n_rt) * RT;
  const int tid = threadIdx.x;
  const int tk = tid & 7, tr = tid >> 3;        // key group, row group

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  int* tbl_s = reinterpret_cast<int*>(smem);
  float* q_s = reinterpret_cast<float*>(smem) + table_floats(MB);  // [RT][QS]
  char* ring = reinterpret_cast<char*>(q_s + RT * QS);  // 2 x (K, V)
  float* p_s = reinterpret_cast<float*>(ring + 2 * Geo::STAGE);

  const int L = lens[b];
  const int last = L + (min(r0 + RT, R) - 1) / G;   // the tile's last key
  const int n_ent = min(MB, last / bs + 1);
  const int n_chunks = min((MB * bs + KC - 1) / KC, last / KC + 1);
  load_table(tbl_s, tables, b, MB, n_ent);
  for (int i = tid; i < RT * DH; i += kThreads) {
    const int rl = i / DH, d = i % DH, r = r0 + rl;
    float v = 0.f;
    if (r < R)
      v = q[(((size_t)b * S + r / G) * Hq + kvh * G + r % G) * DH + d] *
          scale;
    q_s[rl * QS + d] = v;
  }
  __syncthreads();

  const Ctx<T> ctx{k_pool, v_pool, tbl_s, n_ent, n_blocks, bs, Kv, kvh};
  float m[RPT], lsum[RPT];
  float4 acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int lim[RPT];                                 // last key each row sees
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + tr + 16 * i;
    lim[i] = r < R ? L + r / G : -1;
  }

  for (int s = 0; s < 2; ++s) {
    const int c = split + s * n_split;
    if (c < n_chunks) {
      T* k_st = reinterpret_cast<T*>(ring + s * Geo::STAGE);
      stage_chunk<DH, KC, KS>(ctx, c, k_st, k_st + KC * KS, tid, kThreads);
    }
    cp_async_commit();
  }
  int it = 0;
  for (int c = split; c < n_chunks; c += n_split, ++it) {
    T* k_st = reinterpret_cast<T*>(ring + (it & 1) * Geo::STAGE);
    T* v_st = k_st + KC * KS;
    cp_async_wait<1>();
    __syncthreads();

    float sc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[i][u] = 0.f;
#pragma unroll 8
    for (int g = 0; g < NG; ++g) {
      float4 kv[4], qv[RPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kv[u] = load4(k_st + (tk + 8 * u) * KS + 4 * g);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (tr + 16 * i) * QS +
                                                 4 * g);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[i][u] = dot4(qv[i], kv[u], sc[i][u]);
    }
    bool key_ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      size_t off;
      key_ok[u] = key_src<DH>(ctx, c * KC + tk + 8 * u, &off);
    }
    float corr[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool vis = key_ok[u] && c * KC + tk + 8 * u <= lim[i];
        sc[i][u] = vis ? sc[i][u] : -INFINITY;
        mx = fmaxf(mx, sc[i][u]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = 1.f;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float pr = 0.f;
        if (m_new != -INFINITY && sc[i][u] != -INFINITY)
          pr = expf(sc[i][u] - m_new);
        ps += pr;
        p_s[(tr + 16 * i) * kTilePS + tk + 8 * u] = pr;
      }
      if (m_new != -INFINITY) corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      lsum[i] = fmaf(lsum[i], corr[i], ps);
    }
    __syncthreads();                            // p_s complete

#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) scale4(corr[i], acc[i][c2]);
#pragma unroll 4
    for (int t = 0; t < KC; ++t) {
      float4 v[NC];
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2)
        v[c2] = v_part<DH>(v_st + t * DH, tk, c2);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pr = p_s[(tr + 16 * i) * kTilePS + t];
#pragma unroll
        for (int c2 = 0; c2 < NC; ++c2) fma4(pr, v[c2], acc[i][c2]);
      }
    }
    __syncthreads();                            // stage and p_s consumed
    const int cn = c + 2 * n_split;
    if (cn < n_chunks)
      stage_chunk<DH, KC, KS>(ctx, cn, k_st, v_st, tid, kThreads);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const int rows = B * S * Hq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], o);
    const int r = r0 + tr + 16 * i;
    if (r >= R) continue;
    const size_t row = ((size_t)b * S + r / G) * Hq + kvh * G + r % G;
    if (n_split == 1) {
      const float den = fmaxf(lsum[i], 1e-30f);
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) {
        const float4 a = acc[i][c2];
        store_part<DH>(out + row * DH, tk, c2,
                       make_float4(a.x / den, a.y / den, a.z / den,
                                   a.w / den));
      }
    } else {
      const size_t base = (size_t)split * rows + row;
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2)
        store_part<DH>(part_o + base * DH, tk, c2, acc[i][c2]);
      if (tk == 0) {
        part_ml[base * 2] = m[i];
        part_ml[base * 2 + 1] = lsum[i];
      }
    }
  }
}

// Merge the n_split partial states of every (row, head) in split order.
__global__ void __launch_bounds__(256)
paged_attention_combine(const float* __restrict__ part_o,
                        const float* __restrict__ part_ml,
                        float* __restrict__ out, int rows, int Dh,
                        int n_split) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * Dh) return;
  const size_t row = i / Dh;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, part_ml[((size_t)s * rows + row) * 2]);
  float l = 0.f, a = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const size_t base = (size_t)s * rows + row;
      const float ms = part_ml[base * 2];
      if (ms == -INFINITY) continue;            // this split saw no key
      const float f = expf(ms - mx);
      l = fmaf(part_ml[base * 2 + 1], f, l);
      a = fmaf(part_o[base * Dh + i % Dh], f, a);
    }
  }
  out[i] = a / fmaxf(l, 1e-30f);
}

struct Args {
  const float* q;
  const void *k_pool, *v_pool;
  const int *tables, *lens;
  float *out, *part_o, *part_ml;
  int B, S, Hq, Kv, n_blocks, bs, MB, n_split;
  float scale;
};

template <typename T, typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                cudaStream_t st) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, st>>>(
      a.q, static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      a.tables, a.lens, a.out, a.part_o, a.part_ml, a.B, a.S, a.Hq, a.Kv,
      a.n_blocks, a.bs, a.MB, a.n_split, a.scale);
  return cudaGetLastError();
}

template <int DH, typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int R = a.S * (a.Hq / a.Kv);
  cudaError_t e;
  if (R >= 16) {
    if (R <= 32) {
      e = run<T>(paged_attention_kernel_tile<DH, 2, T>,
                 dim3(a.n_split, a.Kv * ((R + 31) / 32), a.B),
                 tile_smem_bytes<DH, 2, T>(a.MB), a, st);
    } else {
      e = run<T>(paged_attention_kernel_tile<DH, 4, T>,
                 dim3(a.n_split, a.Kv * ((R + 63) / 64), a.B),
                 tile_smem_bytes<DH, 4, T>(a.MB), a, st);
    }
  } else if (R == 1) {
    e = run<T>(paged_attention_kernel_rows<DH, 1, T>,
               dim3(a.n_split, a.Kv, a.B), rows_smem_bytes<DH, 1, T>(a.MB),
               a, st);
  } else if (R <= 4) {
    e = run<T>(paged_attention_kernel_rows<DH, 4, T>,
               dim3(a.n_split, a.Kv, a.B), rows_smem_bytes<DH, 4, T>(a.MB),
               a, st);
  } else {
    e = run<T>(paged_attention_kernel_rows<DH, 16, T>,
               dim3(a.n_split, a.Kv, a.B), rows_smem_bytes<DH, 16, T>(a.MB),
               a, st);
  }
  if (e != cudaSuccess || a.n_split == 1) return e;
  const int rows = a.B * a.S * a.Hq;
  const size_t n = (size_t)rows * DH;
  paged_attention_combine<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.part_o, a.part_ml, a.out, rows, DH, a.n_split);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int Dh, void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.Kv <= 0 || a.Hq % a.Kv != 0 || a.bs <= 0 ||
      a.MB <= 0 || a.n_blocks <= 0 || a.n_split <= 0 || a.B > 65535 ||
      (a.n_split > 1 && (a.part_o == nullptr || a.part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16:
      return (int)launch<16, T>(a, st);
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

// q f32[B,S,Hq,Dh]; k_pool, v_pool [n_blocks,bs,Kv,Dh] in f32 (_f32) or
// bf16 (_bf16), 16-byte aligned; tables i32[B,MB]; lens i32[B]; out
// f32[B,S,Hq,Dh]; with n_split > 1 the scratch part_o
// f32[n_split,B,S,Hq,Dh] and part_ml f32[n_split,B,S,Hq,2] (unused, and
// may be null, when n_split == 1). All contiguous, on the current device.
// Dh is 16, 32, 64 or 128. Launches the main kernel and, when
// n_split > 1, the combine pass. Returns the cudaError_t of the launches
// (0 = success).
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool, const int* tables,
                                   const int* lens, float* out, float* part_o,
                                   float* part_ml, int B, int S, int Hq,
                                   int Kv, int Dh, int n_blocks, int bs,
                                   int MB, int n_split, float scale,
                                   void* stream) {
  const Args a{q, k_pool, v_pool, tables, lens, out, part_o, part_ml,
               B, S, Hq, Kv, n_blocks, bs, MB, n_split, scale};
  return dispatch<float>(a, Dh, stream);
}

extern "C" int paged_attention_bf16(const float* q, const void* k_pool,
                                    const void* v_pool, const int* tables,
                                    const int* lens, float* out,
                                    float* part_o, float* part_ml, int B,
                                    int S, int Hq, int Kv, int Dh,
                                    int n_blocks, int bs, int MB,
                                    int n_split, float scale, void* stream) {
  const Args a{q, k_pool, v_pool, tables, lens, out, part_o, part_ml,
               B, S, Hq, Kv, n_blocks, bs, MB, n_split, scale};
  return dispatch<__nv_bfloat16>(a, Dh, stream);
}
