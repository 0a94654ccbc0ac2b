// Fused ReLU-FFN with dead-block skip, for Hopper (sm_90a):
//   out = relu(x @ W_up) @ W_down,   x f32[M,d], W_up f32[d,f], W_down f32[f,d].
//
// Replaces: src/repro/kernels/relu_ffn.py `_relu_ffn_kernel` (body) and
// `relu_ffn` (wrapper) — the Pallas kernel whose sequential grid walks
// d_ff blocks, computes the block's hidden activation in VMEM and runs
// the down-projection MAC only when the block has a live (> 0) value.
//
// What bounds it on this card: for small M, bytes — W_up and W_down are
// read once for 4*M*d*f flops, M/2 flops per byte of weights against the
// f32 ridge of ~20 flop/byte (67 TFLOP/s over 3.35 TB/s): at llama3.2-1b
// widths (d 2048, f 8192, 64 MB per weight) and M = 32 the weight bytes
// bound a call at 0.040 ms and the f32 flops at 0.032 ms, so both have to
// run near their rates at once. From M ~ 40 up, operations. At nectar
// widths (d 128, f 640) the weights sit in L2 and a call is a few
// microseconds of work spread over as many SMs as it can fill.
//
// What the design does about it:
//  * d_ff is cut into blocks of kBF = 64 hidden units, the skip unit, and
//    the blocks into n_split contiguous ranges of `bps` blocks; M into
//    row tiles of BM = 16, 32 or 64 rows. The host picks BM and n_split
//    from the shapes and the SM count (`relu_ffn.ffn_plan`): one row tile
//    for M <= 64, so every weight byte is read once; enough splits to fill
//    the card. Grid (n_split, row tiles).
//  * A CTA computes the hidden blocks h = relu(x W_up[:, block]) of up to
//    hb blocks of its range at a time into shared memory. A block whose
//    every value is <= 0 is dead: the Pallas `@pl.when(max(h) > 0)`. It
//    then streams the W_down rows of the live blocks only, column tile by
//    column tile, and adds h @ W_down into its output: the output itself
//    when n_split == 1, else its own slice of the [n_split, M, d] partials
//    (scratch bounded by the split, not by the number of blocks). A
//    combine pass sums the slices of the live splits in a fixed order.
//  * Both products are [BM x 64] tiles of depth 64 fed through a 4-stage
//    shared-memory ring by the Tensor Memory Accelerator: one thread
//    starts a 2-D bulk copy per 32-column box of the x, W_up or W_down
//    tile (tensor maps built on the host), completing on the stage's
//    mbarrier; boxes past an edge of the array are zero-filled by the
//    copy. Staging the same tiles with 16-byte cp.async copies from every
//    thread stalled the issuing warps about as long as a tile's products
//    took (clock64 stamps), and the two added up. The boxes are 128-byte
//    swizzled (16-byte chunk c of row r stored at chunk c ^ (r % 8)), so
//    the fragment loads below hit distinct banks.
//  * A [32 x 64] tile is too small for 256 threads to keep f32 FMAs fed
//    from shared memory (FFMA on (BM/8) x 4 micro-tiles was bound by its
//    shared-memory loads), so the products run on the tensor cores: each
//    of the 8 warps owns a (16*MI) x (8*NI) sub-tile over the whole depth
//    and runs mma.sync m16n8k8 TF32 in the 3xTF32 scheme: every f32
//    operand is split into a TF32 high part and the rest, and a*b =
//    hi*hi + (lo*hi + hi*lo) in two sets of f32 accumulators (two
//    independent chains of mma), which keeps f32 accuracy (the dropped
//    lo*lo term and lo's unread bits are ~2^-21 of the product). TF32
//    alone (10-bit mantissa) would not.
//  * No float atomics, fixed orders: the same inputs give the same bits
//    every run. Any f: the last d_ff block may be a tail. The tensor maps
//    need rows of a multiple of 16 bytes: the wrapper pads d and f to
//    multiples of 4 with zeros where they are not.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBF = 64;         // hidden units per d_ff block: the skip unit
constexpr int kBK = 64;         // depth of one staged tile
constexpr int kBN = 64;         // output columns of one tile
constexpr int kBox = 32;        // columns of one TMA box (128 bytes)
constexpr int kStages = 4;

// Layout of a [BM x 64] tile over the 8 warps: WM x WN warps, each owning
// MI x NI mma tiles of 16 x 8. A stage holds the weight tile (two boxes of
// [64][32]) and the x tile (two boxes of [BM][32]), 1024-byte aligned.
template <int BM>
struct Tile {
  static constexpr int WM = BM == 16 ? 1 : 2;
  static constexpr int WN = 8 / WM;
  static constexpr int MI = BM / (16 * WM);
  static constexpr int NI = kBN / (8 * WN);
  static constexpr int W = kBK * kBN;           // floats of a weight tile
  static constexpr int A = BM * kBK;            // floats of an x tile
  static constexpr int STAGE = W + A;
  static constexpr int H = BM * kBF;            // floats of a hidden block
};

// Shared memory of one CTA in bytes: alignment slack, the ring, hb hidden
// blocks and an mbarrier per stage.
template <int BM>
__host__ __device__ constexpr size_t smem_bytes(int hb) {
  return 1024 + 4 * ((size_t)kStages * Tile<BM>::STAGE +
                     (size_t)hb * Tile<BM>::H) +
         8 * kStages;
}

// Float offset of element (r, c) of a [rows][64] tile held as two
// 128-byte-swizzled boxes of [rows][32] (box_floats = rows * 32).
__device__ __forceinline__ int swz(int r, int c, int box_floats) {
  return (c >> 5) * box_floats + r * kBox +
         ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// The barrier's one arrival for this phase, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Box {c0, c1} (column, row) of tensor map `tm` into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* tm,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Order the CTA's earlier shared-memory accesses (made visible to this
// thread by a barrier) before its later TMA writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits; round half
// away from zero on the magnitude, by an integer add and a mask: two
// instructions, where cvt.rna.tf32.f32 takes four with its Inf/NaN
// handling), lo the exact f32 rest, of which the mma reads the top 19 bits
// (~2^-21 x lost). Finite inputs only: an Inf or NaN does not survive it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A lane's fixed part of its fragment offsets in swizzled tiles (see
// swz): its A rows r (r % 8 == g for all of them) with the chunk swizzle
// q ^ g of each chunk q, and its B columns c for rows t and t + 4 of each
// group of 8 (the rows' swizzle then depends on t only). Inside the depth
// loop every fragment address is one of these plus a constant.
template <int MI, int NI>
struct Frag {
  int a_row[MI][2];   // rows r0 + 16*mi + g + 8*hr: r * 32 + t
  int a_x[8];         // chunk q of such a row: (q ^ g) * 4
  int b_col[NI][2];   // column c0 + 8*ni + g in rows t + 4*h
  __device__ __forceinline__ Frag(int r0, int c0, int g, int t) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        a_row[mi][hr] = (r0 + 16 * mi + g + 8 * hr) * kBox + t;
#pragma unroll
    for (int q = 0; q < 8; ++q) a_x[q] = (q ^ g) << 2;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b_col[ni][h] = swz(t + 4 * h, c0 + 8 * ni + g, kBK * kBox);
  }
};

// acc += A[rows][0, 64) @ B[0, 64)[cols] in 3xTF32: A a swizzled
// [rows][64] tile of a_box floats a box, B a swizzled [64][64] tile, the
// lane's offsets in fr. acc[0] takes hi*hi, acc[1] the two small terms.
// Fragments as the PTX ISA lays out m16n8k8 (g = lane / 4, t = lane % 4).
template <int MI, int NI, int A_BOX>
__device__ __forceinline__ void mac(float (&acc)[2][MI][NI][4],
                                    const float* a, const float* b,
                                    const Frag<MI, NI>& fr) {
#pragma unroll
  for (int k = 0; k < kBK; k += 8) {
    const float* ak = a + (k >> 5) * A_BOX;     // the box of columns k..k+7
    const int q = (k & 31) >> 2;                // their first chunk
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      split(ak[fr.a_row[mi][0] + fr.a_x[q]], ah[mi][0], al[mi][0]);
      split(ak[fr.a_row[mi][1] + fr.a_x[q]], ah[mi][1], al[mi][1]);
      split(ak[fr.a_row[mi][0] + fr.a_x[q + 1]], ah[mi][2], al[mi][2]);
      split(ak[fr.a_row[mi][1] + fr.a_x[q + 1]], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      split(b[fr.b_col[ni][0] + k * kBox], bh[ni][0], bl[ni][0]);
      split(b[fr.b_col[ni][1] + k * kBox], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        mma_tf32(acc[0][mi][ni], ah[mi], bh[ni]);
        mma_tf32(acc[1][mi][ni], al[mi], bh[ni]);
        mma_tf32(acc[1][mi][ni], ah[mi], bl[ni]);
      }
  }
}

// Run T tiles through the ring: fetch(i, stage) starts tile i's copies
// (thread 0 only), consume(i, stage) uses it. All threads call it with the
// same T. Bit s of `phase` is the parity stage s's mbarrier completes next.
template <typename Fetch, typename Consume>
__device__ __forceinline__ void pipeline(int T, Fetch fetch, Consume consume,
                                         uint64_t* bars, unsigned& phase) {
  const bool leader = threadIdx.x == 0;
  if (leader) fence_proxy_async();
  for (int s = 0; s < kStages - 1 && s < T; ++s)
    if (leader) fetch(s, s);
  for (int i = 0; i < T; ++i) {
    const int s = i % kStages;
    while (!mbar_try(bars + s, (phase >> s) & 1u)) {
    }
    phase ^= 1u << s;
    __syncthreads();            // tile i landed; tile i-1's stage is free
    const int nx = i + kStages - 1;
    if (leader && nx < T) {
      fence_proxy_async();
      fetch(nx, nx % kStages);
    }
    consume(i, s);
  }
  __syncthreads();              // the ring is free for the next pipeline
}

__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
  for (int i = 0; i < n; ++i) mask &= mask - 1;   // drop the n lowest
  return __ffs(mask) - 1;
}

// Grid (n_split, ceil(M / BM)). Split s owns d_ff blocks
// [s*bps, min(n_fb, (s+1)*bps)), in groups of hb (<= 32) at a time.
// Tensor maps: x [M][d] boxes [BM][32]; w_up [d][f] and w_down [f][d]
// boxes [64][32]; all 128-byte swizzled.
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
relu_ffn_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_up,
                const __grid_constant__ CUtensorMap tm_down,
                float* __restrict__ out, float* __restrict__ partial,
                int* __restrict__ live, int M, int d, int f, int bps,
                int hb) {
  using TL = Tile<BM>;
  constexpr int MI = TL::MI, NI = TL::NI;
  const int split_ = blockIdx.x, mt = blockIdx.y, n_split = gridDim.x;
  const int m0 = mt * BM;
  const int n_fb = (f + kBF - 1) / kBF;
  const int fb_lo = split_ * bps, fb_hi = min(n_fb, fb_lo + bps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp / TL::WN) * 16 * MI;      // the warp's sub-tile
  const int c0 = (warp % TL::WN) * 8 * NI;
  const Frag<MI, NI> fr(r0, c0, g, t);
  const int n_kt = (d + kBK - 1) / kBK;
  const int n_ct = (d + kBN - 1) / kBN;
  float* dst = n_split == 1 ? out : partial + (size_t)split_ * M * d;

  // the ring starts 1024-byte aligned (the swizzle's period); pointer
  // arithmetic on the shared array keeps the loads shared-memory loads
  extern __shared__ __align__(1024) float smem_f[];
  float* ring = smem_f + ((1024u - (smem_u32(smem_f) & 1023u)) & 1023u) / 4;
  float* h_s = ring + kStages * TL::STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(h_s + hb * TL::H);
  unsigned phase = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s, 1);
    fence_mbar_init();
  }
  __syncthreads();

  float acc[2][MI][NI][4];
  auto zero = [&] {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[0][mi][ni][e] = acc[1][mi][ni][e] = 0.f;
  };
  // the tile's result: the small terms added to hi*hi, in that order
  auto sum = [&](int mi, int ni, int e) {
    return acc[0][mi][ni][e] + acc[1][mi][ni][e];
  };

  bool written = false;                          // CTA-uniform
  for (int g0 = fb_lo; g0 < fb_hi; g0 += hb) {
    const int nb = min(hb, fb_hi - g0);
    unsigned live_mask = 0;                      // CTA-uniform

    // up: tile i = (block j, depth tile kt), j < nb
    auto fetch_up = [&](int i, int s) {
      float* w_st = ring + s * TL::STAGE;
      float* x_st = w_st + TL::W;
      const int k0 = (i % n_kt) * kBK, f0 = (g0 + i / n_kt) * kBF;
      mbar_expect(bars + s, 4u * TL::STAGE);
      tma_load(w_st, &tm_up, f0, k0, bars + s);
      tma_load(w_st + kBK * kBox, &tm_up, f0 + kBox, k0, bars + s);
      tma_load(x_st, &tm_x, k0, m0, bars + s);
      tma_load(x_st + BM * kBox, &tm_x, k0 + kBox, m0, bars + s);
    };
    auto consume_up = [&](int i, int s) {
      const float* w_st = ring + s * TL::STAGE;
      const int j = i / n_kt, kt = i % n_kt;
      if (kt == 0) zero();
      mac<MI, NI, BM * kBox>(acc, w_st + TL::W, w_st, fr);
      if (kt == n_kt - 1) {
        int any = 0;
        float* hb_s = h_s + j * TL::H;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float2 h =
                  make_float2(fmaxf(sum(mi, ni, 2 * hf), 0.f),
                              fmaxf(sum(mi, ni, 2 * hf + 1), 0.f));
              any |= (h.x > 0.f) | (h.y > 0.f);
              *reinterpret_cast<float2*>(
                  hb_s + swz(r0 + 16 * mi + g + 8 * hf, c0 + 8 * ni + 2 * t,
                             BM * kBox)) = h;
            }
        // the sparse-accelerator skip: an all-zero hidden block is dead
        if (__syncthreads_or(any)) live_mask |= 1u << j;
      }
    };
    pipeline(nb * n_kt, fetch_up, consume_up, bars, phase);

    const int nl = __popc(live_mask);
    if (nl == 0) continue;                       // no down MAC at all

    // down: tile i = (column tile ct, live block jj): the block's 64 rows
    auto fetch_dn = [&](int i, int s) {
      float* w_st = ring + s * TL::STAGE;
      const int ct = i / nl, row0 = (g0 + nth_bit(live_mask, i % nl)) * kBF;
      mbar_expect(bars + s, 4u * TL::W);
      tma_load(w_st, &tm_down, ct * kBN, row0, bars + s);
      tma_load(w_st + kBK * kBox, &tm_down, ct * kBN + kBox, row0, bars + s);
    };
    auto consume_dn = [&](int i, int s) {
      const int ct = i / nl, jj = i % nl;
      if (jj == 0) zero();
      mac<MI, NI, BM * kBox>(acc, h_s + nth_bit(live_mask, jj) * TL::H,
                             ring + s * TL::STAGE, fr);
      if (jj < nl - 1) return;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = m0 + r0 + 16 * mi + g + 8 * hf;
            const int col = ct * kBN + c0 + 8 * ni + 2 * t;
            if (row >= M || col >= d) continue;   // d % 4 == 0: col + 1 < d
            float2* o = reinterpret_cast<float2*>(dst + (size_t)row * d + col);
            float2 v =
                make_float2(sum(mi, ni, 2 * hf), sum(mi, ni, 2 * hf + 1));
            if (written) v = make_float2(o->x + v.x, o->y + v.y);
            *o = v;
          }
    };
    pipeline(n_ct * nl, fetch_dn, consume_dn, bars, phase);
    written = true;
  }

  if (n_split == 1) {
    if (!written) {                              // every block was dead
      for (int e = tid; e < BM * d; e += kThreads) {
        const int row = m0 + e / d;
        if (row < M) out[(size_t)row * d + e % d] = 0.f;
      }
    }
  } else if (tid == 0) {
    live[split_ * gridDim.y + mt] = written;
  }
}

// out = the live splits' partials summed in a fixed order (0 if none),
// d % 4 == 0: a CTA takes 32 float4 columns of the output and 8 groups of
// splits; each thread sums its group's splits in split order, kBatch
// loads in flight, and the first group adds the 8 group sums in group
// order.
constexpr int kCombineCols = 32;
constexpr int kCombineGroups = 8;
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kCombineCols * kCombineGroups)
relu_ffn_combine(const float* __restrict__ partial,
                 const int* __restrict__ live, float* __restrict__ out,
                 int M, int d, int n_split, int n_mt, int bm) {
  __shared__ float4 red[kCombineGroups][kCombineCols];
  const size_t total = (size_t)M * d;
  const int lane = threadIdx.x % kCombineCols;
  const int grp = threadIdx.x / kCombineCols;
  const size_t i0 = 4 * ((size_t)blockIdx.x * kCombineCols + lane);
  const int per = (n_split + kCombineGroups - 1) / kCombineGroups;
  const int s_lo = grp * per, s_hi = min(n_split, s_lo + per);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (i0 < total) {                          // d % 4 == 0: one row
    const int mt = (int)(i0 / d) / bm;
    for (int s0 = s_lo; s0 < s_hi; s0 += kBatch) {
      float4 p[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        ok[u] = s0 + u < s_hi && live[(s0 + u) * n_mt + mt];
        if (ok[u])
          p[u] = *reinterpret_cast<const float4*>(partial + (s0 + u) * total +
                                                  i0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!ok[u]) continue;
        v[0] += p[u].x;
        v[1] += p[u].y;
        v[2] += p[u].z;
        v[3] += p[u].w;
      }
    }
  }
  red[grp][lane] = make_float4(v[0], v[1], v[2], v[3]);
  __syncthreads();
  if (grp != 0 || i0 >= total) return;
  float4 o = red[0][lane];
  for (int q = 1; q < kCombineGroups; ++q) {  // fixed order
    const float4 r = red[q][lane];
    o = make_float4(o.x + r.x, o.y + r.y, o.z + r.z, o.w + r.w);
  }
  *reinterpret_cast<float4*>(out + i0) = o;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through cudaGetDriverEntryPoint
// (no -lcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of the row-major f32 array [rows][cols] in boxes of
// [box_rows][32], 128-byte swizzled, zeros past its edges.
bool encode(CUtensorMap* tm, const float* base, int rows, int cols,
            int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM>
cudaError_t launch(const float* x, const float* w_up, const float* w_down,
                   float* out, float* partial, int* live, int M, int d,
                   int f, int n_split, int bps, int hb, cudaStream_t st) {
  const size_t smem = smem_bytes<BM>(hb);
  CUtensorMap tm_x, tm_up, tm_down;
  if (!encode(&tm_x, x, M, d, BM) || !encode(&tm_up, w_up, d, f, kBK) ||
      !encode(&tm_down, w_down, f, d, kBF))
    return cudaErrorInvalidValue;
  const cudaError_t e0 = cudaFuncSetAttribute(
      relu_ffn_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e0 != cudaSuccess) return e0;
  const int n_mt = (M + BM - 1) / BM;
  relu_ffn_kernel<BM><<<dim3(n_split, n_mt), kThreads, smem, st>>>(
      tm_x, tm_up, tm_down, out, partial, live, M, d, f, bps, hb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  const size_t cols = ((size_t)M * d + 3) / 4;
  relu_ffn_combine<<<(unsigned)((cols + kCombineCols - 1) / kCombineCols),
                     kCombineCols * kCombineGroups, 0, st>>>(
      partial, live, out, M, d, n_split, n_mt, BM);
  return cudaGetLastError();
}

}  // namespace

// x f32[M,d]; w_up f32[d,f]; w_down f32[f,d]; out f32[M,d]; d and f
// multiples of 4 and the bases 16-byte aligned (the tensor maps' rule);
// with n_split > 1 the scratch partial f32[n_split,M,d] and live
// i32[n_split,ceil(M/bm)] (unused, and may be null, when n_split == 1).
// bm in {16,32,64}; split s owns d_ff blocks of 64 [s*bps, (s+1)*bps),
// hb (1..256/bm) of them at a time. All contiguous, on the current device.
// Launches the main kernel and, when n_split > 1, the combine pass.
// Returns the first cudaError_t (0 = success).
extern "C" int relu_ffn_f32(const float* x, const float* w_up,
                            const float* w_down, float* out, float* partial,
                            int* live, int M, int d, int f, int bm,
                            int n_split, int bps, int hb, void* stream) {
  const int n_fb = (f + kBF - 1) / kBF;
  if (M <= 0 || d <= 0 || f <= 0 || d % 4 || f % 4 || n_split <= 0 ||
      bps <= 0 || hb <= 0 || hb > 32 || hb * bm > 256 ||
      (n_split - 1) * bps >= n_fb || n_split * bps < n_fb ||
      (M + bm - 1) / bm > 65535 ||
      (n_split > 1 && (partial == nullptr || live == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16:
      return (int)launch<16>(x, w_up, w_down, out, partial, live, M, d, f,
                             n_split, bps, hb, st);
    case 32:
      return (int)launch<32>(x, w_up, w_down, out, partial, live, M, d, f,
                             n_split, bps, hb, st);
    case 64:
      return (int)launch<64>(x, w_up, w_down, out, partial, live, M, d, f,
                             n_split, bps, hb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
