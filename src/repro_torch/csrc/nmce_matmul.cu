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
// What bounds it on this card: bytes. At decode M (8-32 rows) each int8
// weight byte feeds 2*M integer operations, far below the int8
// tensor-core ridge (1,979 TOPS over 3.35 TB/s, ~590 op/byte), so the
// least time is the K*N weight bytes over the memory rate. Reaching it
// takes every SM streaming with tens of KB in flight, and nothing else on
// the critical path: clock64 stamps showed the x rows' loads, queued
// behind the weights' and then waited on, taking half of a call. At nectar
// widths (80-256 KB of weights) a call is a few microseconds of launch
// and latency whatever the design.
//
// What the design does about it:
//  * A CTA owns 128 output columns, all M rows up to 64 (the stationary
//    v1Reg; above 64, tiles of 64 rows) and a range of whole 64-wide K
//    chunks, so the int16 clip stays per chunk. The host sizes the split
//    of K from the shapes and the SM count (`nmce_matvec.nmce_plan`): as
//    many CTAs as one wave of one CTA per SM holds, none for small
//    weights. Grid (column tiles, splits, row tiles); every weight byte is
//    read by one CTA only.
//  * The CTA's x rows over its K range sit in shared memory for the whole
//    call (rows padded by 16 bytes, so a fragment load touches 32 banks);
//    rows past M are never loaded and read as zero. Their cp.async copies
//    are issued first, so that they do not queue behind the weights'.
//  * One producer warp streams the weights through an 8-stage ring of
//    [64][128] int8 tiles with full and empty mbarriers: one 2-D TMA
//    tensor copy per tile (128-byte swizzle, zero fill past K and N) where
//    N % 16 == 0 and the base is 16-byte aligned; else its 32 lanes issue
//    4-byte cp.async copies into the same swizzled layout and the full
//    barrier counts their completions (cp.async.mbarrier.arrive.noinc).
//    Eight consumer warps take every other chunk, four warps of 32
//    columns each, and free a stage as soon as its fragments are in
//    registers; no CTA-wide barrier in the loop.
//  * The products run on the int8 tensor cores, mma.sync m16n8k32 s8. The
//    B fragment wants 4 consecutive K values of one column per register,
//    and w_q is N-contiguous: ldmatrix .trans (16-bit elements) gives a
//    lane two K rows of two columns per register, the rows chosen through
//    the lanes' row addresses so that one __byte_perm of two such
//    registers makes a column's 4 consecutive K values. 2 ldmatrix and 8
//    byte permutes per 32 K x 32 columns, where 4-byte loads and a 4x4
//    byte transpose took 8 loads and 16 permutes (2-way bank conflicts
//    either way).
//  * With `saturate_int16` a chunk's two k32 products go into their own
//    accumulator, which is clamped to int16 two values at a time (one
//    cvt.pack.sat.s16.s32) and added to the running sum (__dp2a_lo) while
//    the next chunk's fragments load; without it the products accumulate
//    directly. int32, exact.
//  * The two consumer groups' sums meet in shared memory. One split
//    writes the output itself: float(acc) * x_scale * w_scale left to
//    right (__fmul_rn), as the reference does. Several write int32
//    partials and a combine pass sums them in split order and applies the
//    same epilogue. Integer sums are exact in any order, so the result is
//    bit-equal to the plain version and to itself on every relaunch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kColWarps = 4;               // consumer warps across the
constexpr int kPhases = 2;                 // columns, each taking every
constexpr int kConsumers = 32 * kColWarps * kPhases;   // 2nd chunk; and
constexpr int kThreads = kConsumers + 32;  // one producer warp
constexpr int kBN = 128;                   // output columns of a CTA
constexpr int kChunk = 64;                 // NMCE_VREG_BYTES: K rows a tile
constexpr int kStages = 8;
constexpr int kTile = kChunk * kBN;        // bytes of a weight tile
constexpr int kXPad = 16;                  // bytes added to an x row

// Dynamic shared memory: alignment slack, the ring, a full and an empty
// mbarrier per stage and `rows` x rows of `cps` chunks.
__host__ __device__ constexpr size_t smem_bytes(int rows, int cps) {
  return 1024 + (size_t)kStages * kTile + 16 * kStages +
         (size_t)rows * ((size_t)cps * kChunk + kXPad);
}

// Byte offset of element (r, c) of a [64][128] tile stored 128-byte
// swizzled: 16-byte chunk q of row r at chunk q ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBN + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
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

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Box {c0, c1} (column, row) of tensor map `tm` into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load(int8_t* dst, const CUtensorMap* tm,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes from src to dst, or 4 zero bytes when `bytes` is 0.
__device__ __forceinline__ void cp_async4(int8_t* dst, const int8_t* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes from src to dst, zero-filled past the first `bytes`.
__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Close this thread's group of cp.async copies; wait for its groups.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a (16 x 32, row) * b (32 x 8, col), s8 in, s32 out.
__device__ __forceinline__ void mma_s8_first(int (&d)[4], const int (&a)[4],
                                             const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(0));
}

// hi and lo clamped to int16 and packed: lo in bits 0-15, hi in 16-31.
__device__ __forceinline__ int pack_sat16(int hi, int lo) {
  int d;
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;\n" : "=r"(d) : "r"(hi), "r"(lo));
  return d;
}

// d[q] = this lane's part of 8x8 b16 matrix q, transposed: lane 8q + r
// gives the address of row r of matrix q (16 bytes). Lane (g, t) gets
// bytes 2g, 2g+1 of rows 2t and 2t+1: [r2t[2g], r2t[2g+1], r2t1[2g],
// r2t1[2g+1]].
__device__ __forceinline__ void ldsm_x4_trans(int (&d)[4], const int8_t* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_u32(row))
      : "memory");
}

// One arrival on `bar` (no bytes expected).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Barrier 1 over the consumer warps only (the producer warp may be gone).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// the reference's epilogue, left to right: (acc * x_scale) * w_scale
__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// Grid (ceil(N/128), n_split, row tiles of 16*MT). Split s owns K chunks
// [s*cps, min(n_ch, (s+1)*cps)). Consumer warp w computes columns n0 +
// 32(w % 4) + [0, 32) for all 16*MT rows over the chunks i of the split
// with i % kPhases == w / 4. The last warp produces: it keeps the ring
// full. Full barrier s completes when tile i (i % kStages == s) landed,
// empty barrier s when its consumers are done with it.
//
// B fragments: ldmatrix .trans of four [8 K][16 N] byte blocks at column
// half C gives lane (g, t) K rows 2t, 2t+1 of block q at columns C+2g,
// C+2g+1. Block q holds K rows 4u + 2(q & 1) + e (u = 0..3, e = 0, 1) of
// the step's half q >> 1, so one __byte_perm of the words of blocks 0 and
// 1 keeps column C+2g+p (p = 0, 1) with K rows 4t..4t+3: b0 of n8 tile
// (C, p), whose column g is C+2g+p; blocks 2 and 3 give its b1. x rows
// are padded by 16 bytes, so the A fragments' loads hit 32 banks.
template <int MT, bool kSat, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
nmce_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale, float* __restrict__ out,
                   int* __restrict__ partial, int M, int K, int N, int cps) {
  const int n0 = blockIdx.x * kBN, split = blockIdx.y;
  const int m0 = blockIdx.z * 16 * MT;
  const int n_ch = (K + kChunk - 1) / kChunk;
  const int c_lo = split * cps;
  const int T = min(n_ch, c_lo + cps) - c_lo;    // this split's chunks
  const int rows = min(16 * MT, M - m0);
  const int x_stride = cps * kChunk + kXPad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the ring starts 1024-byte aligned (the swizzle's period)
  extern __shared__ __align__(1024) int8_t smem[];
  int8_t* ring = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kTile);
  uint64_t* empty = full + kStages;
  int8_t* x_s = reinterpret_cast<int8_t*>(empty + kStages);
  const bool producer = warp == kConsumers / 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kTma ? 1 : 32);
      mbar_init(empty + s, kColWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // tile i of this split (K rows [64(c_lo+i), +64), columns [n0, n0+128))
  // into stage i % kStages: by lane 0 (TMA) or by every lane (cp.async)
  // of the producer warp
  auto fetch = [&](int i) {
    const int s = i % kStages;
    int8_t* dst = ring + s * kTile;
    const int k0 = (c_lo + i) * kChunk;
    if constexpr (kTma) {
      if (lane != 0) return;
      mbar_expect(full + s, kTile);
      tma_load(dst, &tm_w, n0, k0, full + s);
    } else {
      for (int e = lane; e < kTile / 4; e += 32) {
        const int r = e / (kBN / 4), c = 4 * (e % (kBN / 4));
        const bool ok = k0 + r < K && n0 + c < N;   // N % 4 == 0
        cp_async4(dst + swz(r, c), ok ? w + (size_t)(k0 + r) * N + n0 + c : w,
                  ok ? 4 : 0);
      }
      cp_async_arrive(full + s);
    }
  };
  // x rows [m0, m0 + rows) over the split's K range, zeros past K:
  // 16-byte copies where rows and base allow them, else 4-byte ones (K %
  // 4 == 0). They go first, so that they do not queue behind the ring's.
  if (K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int kw = cps * kChunk / 16;
    for (int e = tid; e < rows * kw; e += kThreads) {
      const int r = e / kw, c = 16 * (e % kw);
      const int k = c_lo * kChunk + c;
      cp_async16(x_s + r * x_stride + c,
                 k < K ? x + (size_t)(m0 + r) * K + k : x, k < K ? 16 : 0);
    }
  } else {
    const int kw = cps * kChunk / 4;
    for (int e = tid; e < rows * kw; e += kThreads) {
      const int r = e / kw, c = 4 * (e % kw);
      const int k = c_lo * kChunk + c;
      cp_async4(x_s + r * x_stride + c,
                k < K ? x + (size_t)(m0 + r) * K + k : x, k < K ? 4 : 0);
    }
  }
  cp_async_commit();
  if (producer)                   // the first tiles fly while x lands
    for (int i = 0; i < kStages && i < T; ++i) fetch(i);
  cp_async_wait();
  __syncthreads();

  if (producer) {                 // keep the ring full, then leave
    for (int i = kStages; i < T; ++i) {
      const int s = i % kStages;
      while (!mbar_try(empty + s, ((i / kStages) - 1) & 1)) {
      }
      fetch(i);
    }
    return;
  }

  const int cb = (warp % kColWarps) * 32;        // the warp's columns
  const int ph = warp / kColWarps;               // and its chunk phase
  int acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

  // with saturate_int16, chunk i's sum is clamped and added while chunk
  // i + kPhases's fragments load, so no warp waits on its last mma; two
  // sums at a time: one cvt.pack.sat clamps both to int16, and __dp2a_lo
  // adds the low or the high half (times 1, the other times 0) to acc
  int part[MT][4][4];
  auto saturate_into_acc = [&] {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int p = pack_sat16(part[mi][j][e + 1], part[mi][j][e]);
          acc[mi][j][e] = __dp2a_lo(p, 0x0001, acc[mi][j][e]);
          acc[mi][j][e + 1] = __dp2a_lo(p, 0x0100, acc[mi][j][e + 1]);
        }
  };

  for (int i = ph; i < T; i += kPhases) {
    const int s = i % kStages;
    while (!mbar_try(full + s, (i / kStages) & 1)) {
    }
    const int8_t* wt = ring + s * kTile;
    int b[2][4][2];                            // [k32 step][n8 tile 2c + p]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int d[4];
        ldsm_x4_trans(d, wt + swz(32 * h + 16 * (lane >> 4) +
                                      4 * ((lane >> 1) & 3) +
                                      2 * ((lane >> 3) & 1) + (lane & 1),
                                  cb + 16 * c));
        b[h][2 * c][0] = __byte_perm(d[0], d[1], 0x6420);
        b[h][2 * c + 1][0] = __byte_perm(d[0], d[1], 0x7531);
        b[h][2 * c][1] = __byte_perm(d[2], d[3], 0x6420);
        b[h][2 * c + 1][1] = __byte_perm(d[2], d[3], 0x7531);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);     // the stage may refill
    int a[2][MT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r0 = 16 * mi + g, r1 = r0 + 8;
        const int kl = i * kChunk + 32 * h + 4 * t;
        const int8_t* x0 = x_s + r0 * x_stride + kl;
        const int8_t* x1 = x_s + r1 * x_stride + kl;
        a[h][mi][0] = r0 < rows ? *reinterpret_cast<const int*>(x0) : 0;
        a[h][mi][1] = r1 < rows ? *reinterpret_cast<const int*>(x1) : 0;
        a[h][mi][2] = r0 < rows ? *reinterpret_cast<const int*>(x0 + 16) : 0;
        a[h][mi][3] = r1 < rows ? *reinterpret_cast<const int*>(x1 + 16) : 0;
      }
    if constexpr (kSat) {
      if (i != ph) saturate_into_acc();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (!kSat)
            mma_s8(acc[mi][j], a[h][mi], b[h][j]);
          else if (h == 0)
            mma_s8_first(part[mi][j], a[h][mi], b[h][j]);
          else
            mma_s8(part[mi][j], a[h][mi], b[h][j]);
        }
  }
  if constexpr (kSat) {
    if (ph < T) saturate_into_acc();
  }

  // the later phases add their sums to phase 0's through the ring, which
  // no copy writes any more
  int* red = reinterpret_cast<int*>(ring);
  static_assert(MT * 16 * kColWarps * 32 * 4 <= kStages * kTile, "ring");
  for (int p = 1; p < kPhases; ++p) {
    consumer_sync(kConsumers);
    if (ph == p) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((mi * 16 + j * 4 + e) * kColWarps + warp % kColWarps) * 32 +
                lane] = acc[mi][j][e];
    }
    consumer_sync(kConsumers);
    if (ph == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][j][e] +=
                red[((mi * 16 + j * 4 + e) * kColWarps + warp) * 32 + lane];
    }
  }
  if (ph != 0) return;

  // lane (g, t) holds rows g and g + 8 of each m16 tile; n8 tiles (C, 0)
  // and (C, 1) give it columns C + 4t + [0, 4): tile p's accumulators
  // 2hr and 2hr + 1 are columns C + 4t + p and C + 4t + 2 + p of row
  // g + 8hr
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * mi + g + 8 * hr;
      if (r >= rows) continue;
      const int row = m0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n0 + cb + 16 * c + 4 * t;
        if (col >= N) continue;                 // N % 4 == 0: all 4 in
        const int v[4] = {acc[mi][2 * c][2 * hr], acc[mi][2 * c + 1][2 * hr],
                          acc[mi][2 * c][2 * hr + 1],
                          acc[mi][2 * c + 1][2 * hr + 1]};
        if (gridDim.y == 1) {
          const float xs = x_scale[row];
          const float4 ws = *reinterpret_cast<const float4*>(w_scale + col);
          *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
              make_float4(dequant(v[0], xs, ws.x), dequant(v[1], xs, ws.y),
                          dequant(v[2], xs, ws.z), dequant(v[3], xs, ws.w));
        } else {
          *reinterpret_cast<int4*>(partial + ((size_t)split * M + row) * N +
                                   col) = make_int4(v[0], v[1], v[2], v[3]);
        }
      }
    }
}

// out = the epilogue of the splits' int32 partials summed in split order;
// a thread takes 4 columns of one row (N % 4 == 0), kBatch loads in
// flight.
constexpr int kCombineThreads = 256;
constexpr int kBatch = 4;

__global__ void __launch_bounds__(kCombineThreads)
nmce_matmul_combine(const int* __restrict__ partial,
                    const float* __restrict__ x_scale,
                    const float* __restrict__ w_scale, float* __restrict__ out,
                    int M, int N, int n_split) {
  const size_t total = (size_t)M * N;
  const size_t i0 = 4 * ((size_t)blockIdx.x * kCombineThreads + threadIdx.x);
  if (i0 >= total) return;
  int v[4] = {0, 0, 0, 0};
  for (int s0 = 0; s0 < n_split; s0 += kBatch) {
    int4 p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s0 + u < n_split)
        p[u] = *reinterpret_cast<const int4*>(partial + (s0 + u) * total + i0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s0 + u >= n_split) continue;
      v[0] += p[u].x;
      v[1] += p[u].y;
      v[2] += p[u].z;
      v[3] += p[u].w;
    }
  }
  const int row = (int)(i0 / N), col = (int)(i0 % N);
  const float xs = x_scale[row];
  const float4 ws = *reinterpret_cast<const float4*>(w_scale + col);
  *reinterpret_cast<float4*>(out + i0) =
      make_float4(dequant(v[0], xs, ws.x), dequant(v[1], xs, ws.y),
                  dequant(v[2], xs, ws.z), dequant(v[3], xs, ws.w));
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

// A map of the row-major int8 array w [K][N] in boxes of [64][128],
// 128-byte swizzled, zeros past its edges.
bool encode(CUtensorMap* tm, const int8_t* w, int K, int N) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)kBN, (cuuint32_t)kChunk};
  const cuuint32_t elem[2] = {1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const int8_t *x, *w;
  const float *x_scale, *w_scale;
  float* out;
  int* partial;
  int M, K, N, n_split, cps;
  cudaStream_t st;
};

template <int MT, bool kSat, bool kTma>
cudaError_t launch(const Args& a) {
  CUtensorMap tm;       // unread on the cp.async path
  memset(&tm, 0, sizeof(tm));
  if (kTma && !encode(&tm, a.w, a.K, a.N)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(min(a.M, 16 * MT), a.cps);
  auto kernel = nmce_matmul_kernel<MT, kSat, kTma>;
  const cudaError_t e0 = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e0 != cudaSuccess) return e0;
  const dim3 grid((a.N + kBN - 1) / kBN, a.n_split,
                  (a.M + 16 * MT - 1) / (16 * MT));
  kernel<<<grid, kThreads, smem, a.st>>>(tm, a.x, a.w, a.x_scale, a.w_scale,
                                         a.out, a.partial, a.M, a.K, a.N,
                                         a.cps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  const size_t quads = (size_t)a.M * a.N / 4;
  nmce_matmul_combine<<<(unsigned)((quads + kCombineThreads - 1) /
                                   kCombineThreads),
                        kCombineThreads, 0, a.st>>>(
      a.partial, a.x_scale, a.w_scale, a.out, a.M, a.N, a.n_split);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mt(const Args& a, bool sat, bool tma) {
  if (sat)
    return tma ? launch<MT, true, true>(a) : launch<MT, true, false>(a);
  return tma ? launch<MT, false, true>(a) : launch<MT, false, false>(a);
}

}  // namespace

// x_q i8[M,K] and w_q i8[K,N] with K % 4 == 0, N % 4 == 0 and 4-byte
// aligned bases; x_scale f32[M]; w_scale f32[N]; out f32[M,N]; with
// n_split > 1 the scratch partial i32[n_split,M,N] (unused, and may be
// null, when n_split == 1). Split s owns K chunks of 64 [s*cps,
// (s+1)*cps). use_tma needs N % 16 == 0 and a 16-byte aligned w_q. All
// contiguous, on the current device. Launches the main kernel and, when
// n_split > 1, the combine pass. Returns the first cudaError_t (0 =
// success).
extern "C" int nmce_matmul_i8(const int8_t* x_q, const int8_t* w_q,
                              const float* x_scale, const float* w_scale,
                              float* out, int* partial, int M, int K, int N,
                              int saturate_int16, int n_split, int cps,
                              int use_tma, void* stream) {
  const int n_ch = (K + kChunk - 1) / kChunk;
  const int mt = M >= 64 ? 4 : (M + 15) / 16;
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0 ||
      n_split <= 0 || cps <= 0 || n_split > 65535 ||
      (n_split - 1) * cps >= n_ch || n_split * cps < n_ch ||
      (M + 16 * mt - 1) / (16 * mt) > 65535 ||
      smem_bytes(M < 64 ? M : 64, cps) > 232448 ||
      (n_split > 1 && partial == nullptr) ||
      (use_tma && (N % 16 != 0 || reinterpret_cast<uintptr_t>(w_q) % 16)))
    return (int)cudaErrorInvalidValue;
  const Args a{x_q, w_q, x_scale, w_scale, out, partial,
               M, K, N, n_split, cps, static_cast<cudaStream_t>(stream)};
  const bool sat = saturate_int16 != 0, tma = use_tma != 0;
  switch (mt) {
    case 1:
      return (int)launch_mt<1>(a, sat, tma);
    case 2:
      return (int)launch_mt<2>(a, sat, tma);
    case 3:
      return (int)launch_mt<3>(a, sat, tma);
    default:
      return (int)launch_mt<4>(a, sat, tma);
  }
}
