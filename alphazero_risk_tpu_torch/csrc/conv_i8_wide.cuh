// The wide design of K1 (conv_i8.cu) for launches whose batch fills the
// card: C = 256, persistent blocks of one producer warpgroup and two
// consumer warpgroups, in clusters that share the weight.
//
// Tiles.  A tile is 64 rows (board cells, M = B * 42 in all) x all 256
// output channels, multiplied by one consumer warpgroup as m64n256k32 (128
// int32 accumulators a thread), so every A fragment that ldmatrix brings
// from a halo plane serves all 256 channels, and each board's plane is
// staged once per 64-byte chunk of K (the 64-channel tiles of conv_tc.cuh
// stage it four times).  64 rows span at most 3 boards, whose planes a
// tile stages.  Block b walks the tiles b, b + gridDim.x, ...; one block
// per SM (its shared memory), as many as fit (blocks()).
//
// Producer.  One thread of warpgroup 2 keeps two rings in flight by TMA,
// each slot with a full and an empty mbarrier: the weight ring (kWStages
// slices of one tap x 64 bytes of K x 256 channels, 16 KB, read from the
// K-major packed weight [3, 3, Cout, Cin] by a 2-D tensor map with the 64B
// swizzle, which is wgmma's K-major layout) and the plane ring (kPStages
// chunks of three halo planes: a 4-D tensor map over q [B, 7, 6, C] whose
// box of 7 x 9 positions from (x, y) = (-1, -1) lands each board as
// pos(y, x) = 8 + 7y + x, the zero column and rows filled by the TMA's
// out-of-bounds zeros).  With a residual it also prefetches each tile's
// residual rows into L2.  setmaxnreg gives its warpgroup's registers to
// the consumers (40 against 232 a thread).
//
// Clusters of kCluster blocks.  Every tile reads the whole weight (590 KB)
// in the same order, so the blocks of a cluster step through the weight
// ring together: each block's producer loads 1/kCluster of a slice and
// multicasts it to all of them, and a slot is refilled once the consumers
// of every block have released it.  A slice read from L2 then serves
// kCluster tiles: at B=1,024, 672 tiles x 590 KB = 396 MB of L2 reads a
// conv, over kCluster.
//
// Consumers.  Warpgroup wg takes the block's tiles k = wg, wg + 2, ...;
// each waits on the full barriers and runs ldmatrix and wgmma only (one
// group per tap, two wgmmas of 32 bytes of K; A in two register sets, so
// the next tap's ldmatrix runs while a group multiplies), and releases a
// weight slice once the group that read it has retired and a plane once
// its last ldmatrix is done.  No __syncthreads runs after the set-up.  The
// two warpgroups' main loops take turns (ping-pong, named barriers), so
// one's epilogue runs under the other's wgmmas.
//
// The epilogue is K1's (conv_i8.cu) in the same order, on the scale
// products s * ws and the bias staged once in shared memory, specialised
// for the outputs that exist; the int8 output leaves in 8-byte stores.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "conv_tc.cuh"

// Internal linkage, as conv_i8.cu's kernels: libraries built from other
// copies of these sources may share a process.
namespace {
namespace wide {

using namespace tc;

constexpr int kC = 256;                      // channels: the only width
constexpr int kTileRows = 64;                // a tile: 64 rows x 256
constexpr int kTileBoards = 3;               // the most boards it spans
constexpr int kConsumers = 256;              // two warpgroups
// and the producer warpgroup, of which one thread works: setmaxnreg moves
// registers between whole warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kChunks = kC / kRowBytes;      // 64 bytes of K each
constexpr int kTaps = 9;
constexpr int kSliceBytes = kC * kRowBytes;  // one tap of one chunk: 16 KB
constexpr int kBoxBytes = 9 * 7 * kRowBytes; // a board's TMA box: 63 positions
constexpr int kPlaneBytes = kTileBoards * kPlane * kRowBytes;   // 12 KB
constexpr int kWStages = 11;
constexpr int kPStages = 3;
constexpr int kEpiCols = 4;                  // epilogue column groups a part
// Blocks a cluster: each block's producer loads 1/kCluster of every weight
// slice and multicasts it to all blocks of its cluster, so a slice read
// from L2 serves kCluster tiles.
constexpr int kCluster = 4;
// Shared memory from the 1024-aligned base: the weight ring, the plane
// ring, s * ws and the bias (f32 [256] each), the barriers.
constexpr int kPOff = kWStages * kSliceBytes;
constexpr int kEpiOff = kPOff + kPStages * kPlaneBytes;
constexpr int kBarOff = kEpiOff + 2 * kC * 4;
constexpr int kSmem = kBarOff + 2 * (kWStages + kPStages + 1) * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Arrive on the barrier at the same offset in every block of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    asm volatile(
        "{\n.reg .b32 remote;\n"
        "mapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
        :: "r"(bar), "r"(r) : "memory");
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// A TMA load of a 2-D box to the same offset in each block of the cluster
// in `mask`, each block's barrier at `bar`'s offset counting the bytes.
__device__ __forceinline__ void tma_load_2d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(p), "r"(bytes) : "memory");
}

// D (64 x 256 int32, the warpgroup's accumulators) (+)= A (64 x 32 s8, the
// warps' fragments) * B (the K-major descriptor's 256 x 32 s8); D is
// overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Accumulators 16 P .. 16 P + 15: an epilogue part's four column groups.
template <int P>
__device__ __forceinline__ void take_part(int (&av)[4 * kEpiCols],
                                          const int (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 4 * kEpiCols; ++i) av[i] = acc[P * 4 * kEpiCols + i];
}

// The epilogue of a tile, in the order of _trunk_xla_int8 (conv_i8.cu):
//   v = acc * (s * ws) + b; [v = v + x;] v = max(v, 0)
//   q_next = clip(rint(v * (1 / s_next)), -127, 127)
// on this thread's rows re and re + 8 (those below M).  Which of the
// residual and the three outputs exist is a template argument (RES, H, Q,
// ACC), so that the body has no branch but the rows' store predicates.  It
// runs as a loop over eight parts of four column groups, each part's
// accumulators copied out by constant indices (registers), its loads
// issued together, then its arithmetic, then its stores.
template <bool RES, bool H, bool Q, bool ACC>
__device__ __forceinline__ void epilogue_body(
    const float* __restrict__ residual, float* __restrict__ out_h,
    int8_t* __restrict__ out_q, int32_t* __restrict__ out_acc,
    const int (&acc)[128], const float* s_sw, const float* s_bias,
    float inv_next, int re, int M, int lane) {
  const bool ok[2] = {re < M, re + 8 < M};
#pragma unroll 1
  for (int part = 0; part < kC / 8 / kEpiCols; ++part) {
    int av[4 * kEpiCols];
    switch (part) {
#define AZ_TAKE(P) case P: take_part<P>(av, acc); break;
      AZ_TAKE(0) AZ_TAKE(1) AZ_TAKE(2) AZ_TAKE(3)
      AZ_TAKE(4) AZ_TAKE(5) AZ_TAKE(6) default: take_part<7>(av, acc);
#undef AZ_TAKE
    }
    const int n0 = part * kEpiCols * 8 + 2 * (lane & 3);
    // every load of the part before any store: the compiler may not move
    // a load past a store it cannot prove apart
    float2 sw[kEpiCols], bb[kEpiCols], rv[kEpiCols][2];
#pragma unroll
    for (int jj = 0; jj < kEpiCols; ++jj) {
      sw[jj] = *reinterpret_cast<const float2*>(s_sw + n0 + jj * 8);
      bb[jj] = *reinterpret_cast<const float2*>(s_bias + n0 + jj * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rv[jj][h] = make_float2(0.0f, 0.0f);
        if (RES && ok[h])
          rv[jj][h] = *reinterpret_cast<const float2*>(
              residual + static_cast<int64_t>(re + 8 * h) * kC + n0 +
              jj * 8);
      }
    }
    float2 v[kEpiCols][2];
    char2 qq[kEpiCols][2];
#pragma unroll
    for (int jj = 0; jj < kEpiCols; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = static_cast<float>(av[4 * jj + 2 * h]) * sw[jj].x +
                   bb[jj].x;
        float v1 = static_cast<float>(av[4 * jj + 2 * h + 1]) * sw[jj].y +
                   bb[jj].y;
        if (RES) {
          v0 = v0 + rv[jj][h].x;
          v1 = v1 + rv[jj][h].y;
        }
        v[jj][h] = make_float2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        // clip, then round to nearest even: the same as rint, then clip
        // (the bounds are integers), in one conversion
        qq[jj][h].x = static_cast<signed char>(__float2int_rn(
            fminf(fmaxf(v[jj][h].x * inv_next, -127.0f), 127.0f)));
        qq[jj][h].y = static_cast<signed char>(__float2int_rn(
            fminf(fmaxf(v[jj][h].y * inv_next, -127.0f), 127.0f)));
      }
#pragma unroll
    for (int jj = 0; jj < kEpiCols; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        const int64_t o = static_cast<int64_t>(re + 8 * h) * kC + n0 +
                          jj * 8;
        if (ACC)
          *reinterpret_cast<int2*>(out_acc + o) =
              make_int2(av[4 * jj + 2 * h], av[4 * jj + 2 * h + 1]);
        if (H) *reinterpret_cast<float2*>(out_h + o) = v[jj][h];
      }
    if (Q) {
      // the four lanes of a row hold 2 bytes of each of the part's four
      // column groups: two exchanges give lane p the 8 bytes of group p,
      // one 8-byte store in place of four 2-byte ones
      const int p = lane & 3;
      const int g0 = part * kEpiCols;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[kEpiCols];
#pragma unroll
        for (int jj = 0; jj < kEpiCols; ++jj)
          b[jj] = static_cast<uint8_t>(qq[jj][h].x) |
                  static_cast<uint32_t>(static_cast<uint8_t>(qq[jj][h].y))
                      << 8;
        // with lane p ^ 1: keep the groups whose parity is p's
        const uint32_t send = (p & 1) ? b[0] | b[2] << 16 : b[1] | b[3] << 16;
        const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 1);
        // 4 bytes of groups (p & 1) and (p & 1) + 2, at column 4 * (p >> 1)
        const uint32_t ca = (p & 1) ? (got & 0xffffu) | b[1] << 16
                                    : b[0] | got << 16;
        const uint32_t cb = (p & 1) ? (got >> 16) | b[3] << 16
                                    : b[2] | (got & 0xffff0000u);
        // with lane p ^ 2: keep group p
        const uint32_t mine = p < 2 ? ca : cb;
        const uint32_t other = __shfl_xor_sync(0xffffffffu, p < 2 ? cb : ca,
                                               2);
        const uint2 row8 = p < 2 ? make_uint2(mine, other)
                                 : make_uint2(other, mine);
        if (ok[h])
          *reinterpret_cast<uint2*>(
              out_q + static_cast<int64_t>(re + 8 * h) * kC +
              (g0 + p) * 8) = row8;
      }
    }
  }
}

// The body for the outputs that exist: the flags become template arguments
// one at a time.
template <bool... F>
__device__ __forceinline__ void epilogue(
    const float* residual, float* out_h, int8_t* out_q, int32_t* out_acc,
    const int (&acc)[128], const float* s_sw, const float* s_bias,
    float inv_next, int re, int M, int lane) {
  constexpr int n = sizeof...(F);
  if constexpr (n == 4) {
    epilogue_body<F...>(residual, out_h, out_q, out_acc, acc, s_sw, s_bias,
                        inv_next, re, M, lane);
  } else {
    const bool f = n == 0 ? residual != nullptr
                 : n == 1 ? out_h != nullptr
                 : n == 2 ? out_q != nullptr : out_acc != nullptr;
    if (f)
      epilogue<F..., true>(residual, out_h, out_q, out_acc, acc, s_sw,
                           s_bias, inv_next, re, M, lane);
    else
      epilogue<F..., false>(residual, out_h, out_q, out_acc, acc, s_sw,
                            s_bias, inv_next, re, M, lane);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_i8_kernel_wide(__grid_constant__ const CUtensorMap q_map,
                       __grid_constant__ const CUtensorMap w_map,
                       const float* __restrict__ ws,
                       const float* __restrict__ bias,
                       const float* __restrict__ s_ptr,
                       const float* __restrict__ residual,
                       const float* __restrict__ inv_next_ptr,
                       float* __restrict__ out_h, int8_t* __restrict__ out_q,
                       int32_t* __restrict__ out_acc, int B) {
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x;
  const int M = B * kCells;
  const int n_tiles = (M + kTileRows - 1) / kTileRows;
  // block b takes tiles b, b + gridDim.x, ...: its k-th is tile k * gridDim.x
  // + b.  The blocks of a cluster walk as many tiles as its first one (a
  // tile past the last multiplies stale planes and writes nothing), so
  // that they stay in step on the multicast weight ring.
  const int rank = static_cast<int>(cluster_rank());
  const int n_slots = (n_tiles - (blockIdx.x - rank) + gridDim.x - 1) /
                      gridDim.x;
  const uint32_t base = aligned_base(smem);
  char* gbase = smem + (base - smem_u32(smem));
  float* s_sw = reinterpret_cast<float*>(gbase + kEpiOff);
  float* s_bias = s_sw + kC;
  const uint32_t wfull = base + kBarOff;
  const uint32_t wempty = wfull + 8 * kWStages;
  const uint32_t pfull = wempty + 8 * kWStages;
  const uint32_t pempty = pfull + 8 * kPStages;
  // turn[wg]: the other consumer warpgroup's main loop is issued
  const uint32_t turn = pempty + 8 * kPStages;
  auto wslot = [&](int i) { return base + i * kSliceBytes; };
  auto pslot = [&](int i) { return base + kPOff + i * kPlaneBytes; };

  if (tid < kC) {
    s_sw[tid] = *s_ptr * ws[tid];
    s_bias[tid] = bias[tid];
  }
  // plane position 63 (read by cell (6, 5)'s tap (+1, +1)) lies past the
  // TMA box: zero it once in every plane
  if (tid < kPStages * kTileBoards * 4)
    reinterpret_cast<uint4*>(gbase + kPOff + (tid >> 2) * kPlane * kRowBytes +
                             kBoxBytes)[tid & 3] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int i = 0; i < kWStages; ++i) {
      mbar_init(wfull + 8 * i, 1);
      mbar_init(wempty + 8 * i, kCluster * 4);
    }
    for (int i = 0; i < kPStages; ++i) {
      mbar_init(pfull + 8 * i, 1);
      mbar_init(pempty + 8 * i, 4);
    }
    mbar_init(turn, 4);
    mbar_init(turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the other blocks' barriers are set up before any arrives on them
  cluster_sync();

  if (tid >= kConsumers) {
    // the producer: for each tile, the planes of chunk c, then its nine
    // weight slices; each slot once the consumers have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != kConsumers) return;
    int ws_i = 0, wph = 0, ps_i = 0, pph = 0;
    for (int k = 0; k < n_slots; ++k) {
      const int r0 = (k * gridDim.x + blockIdx.x) * kTileRows;
      const int rows = max(0, min(kTileRows, M - r0));
      const int b0 = r0 / kCells;
      const int boards = rows ? (r0 + rows - 1) / kCells - b0 + 1 : 0;
      if (residual && rows)
        prefetch_l2(residual + static_cast<int64_t>(r0) * kC,
                    rows * kC * 4);
      for (int c = 0; c < kChunks; ++c) {
        mbar_wait(pempty + 8 * ps_i, pph ^ 1);
        mbar_expect_tx(pfull + 8 * ps_i, boards * kBoxBytes);
        for (int bb = 0; bb < boards; ++bb)
          tma_load_4d(pslot(ps_i) + bb * kPlane * kRowBytes, &q_map,
                      pfull + 8 * ps_i, c * kRowBytes, -1, -1, b0 + bb);
        if (++ps_i == kPStages) ps_i = 0, pph ^= 1;
        for (int tap = 0; tap < kTaps; ++tap) {
          mbar_wait(wempty + 8 * ws_i, wph ^ 1);
          mbar_expect_tx(wfull + 8 * ws_i, kSliceBytes);
          tma_load_2d_multicast(
              wslot(ws_i) + rank * (kSliceBytes / kCluster), &w_map,
              wfull + 8 * ws_i, c * kRowBytes,
              tap * kC + rank * (kC / kCluster), (1u << kCluster) - 1);
          if (++ws_i == kWStages) ws_i = 0, wph ^= 1;
        }
      }
    }
    // stay until every block of the cluster has released each slice: the
    // other blocks' consumers arrive on this block's barriers
    for (int i = 0; i < kWStages; ++i) {
      mbar_wait(wempty + 8 * ws_i, wph ^ 1);
      if (++ws_i == kWStages) ws_i = 0, wph ^= 1;
    }
    return;
  }

  // the consumers: warpgroup wg takes the block's tiles k = wg, wg + 2, ...
  // in ping-pong: their main loops take turns (the turn barriers), and one's
  // epilogue runs under the other's wgmmas.  The turns also keep each wait
  // on a ring slot within one phase of the slot's last completed one, which
  // a parity wait needs: tile k - 1's slices have all arrived when tile k's
  // main loop starts.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const float inv_next = inv_next_ptr ? *inv_next_ptr : 0.0f;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  // A fragments: set i & 1 feeds the wgmmas of tap i of a chunk pair
  uint32_t a[2][2][4] = {};
  int turns = 0;

  for (int k = wg; k < n_slots; k += 2) {
    const int r0 = (k * gridDim.x + blockIdx.x) * kTileRows;
    const int b0 = r0 / kCells;
    // this lane's row for ldmatrix; rows past M read a cell whose nine taps
    // stay inside the tile's first plane, and are never written
    int ra = r0 + (warp & 3) * 16 + (lane & 15);
    if (ra >= M) ra = b0 * kCells + 20;
    const int arow = (ra / kCells - b0) * kPlane + cell_pos(ra % kCells);
    // this tile's place in the rings
    int g = k * kChunks * kTaps;
    int ws_i = g % kWStages, wph = (g / kWStages) & 1;
    int ps_i = (k * kChunks) % kPStages, pph = (k * kChunks / kPStages) & 1;
    int prev = 0;
    if (k > 0) {
      mbar_wait(turn + 8 * wg, turns & 1);
      ++turns;
    }
    for (int c2 = 0; c2 < kChunks; c2 += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mbar_wait(pfull + 8 * ps_i, pph);
        const uint32_t sA = pslot(ps_i);
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          const int i = u * kTaps + tap;
          mbar_wait(wfull + 8 * ws_i, wph);
          const uint32_t sB = wslot(ws_i);
          // the group that read set i & 1 has retired (the wait below)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            ldsm_x4(sA + sw64(arow + tap_shift(tap / 3 - 1, tap % 3 - 1),
                              2 * ks + (lane >> 4)),
                    a[i & 1][ks]);
          pin(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            wgmma_s8_n256(acc, a[i & 1][ks],
                          smem_desc(sB + ks * 32, 512, kSwizzle64),
                          (c2 | u | tap | ks) != 0);
          wgmma_commit();
          // retire the tap before this one: its slice is read no more and
          // set (i + 1) & 1 is free again
          wgmma_wait<1>();
          pin(a[(i + 1) & 1]);
          pin(acc);
          if ((c2 | u | tap) != 0 && lane == 0)
            mbar_arrive_cluster(wempty + 8 * prev);
          prev = ws_i;
          if (++ws_i == kWStages) ws_i = 0, wph ^= 1;
        }
        // this chunk's A is in registers
        if (lane == 0) mbar_arrive(pempty + 8 * ps_i);
        if (++ps_i == kPStages) ps_i = 0, pph ^= 1;
      }
    }
    // the other warpgroup's main loop may start: this one's wgmmas are
    // issued, and its slices have all arrived
    if (k + 1 < n_slots && lane == 0) mbar_arrive(turn + 8 * (1 - wg));
    wgmma_wait<0>();
    pin(a);
    pin(acc);
    if (lane == 0) mbar_arrive_cluster(wempty + 8 * prev);

    epilogue<>(residual, out_h, out_q, out_acc, acc, s_sw, s_bias, inv_next,
               r0 + (warp & 3) * 16 + (lane >> 2), M, lane);
  }
}

// The driver's tensor-map encoder, through the runtime (no link to
// libcuda).  Null when the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &got);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &got);
#endif
    if (got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// An int8 tensor map with the 64B swizzle (wgmma's, and the halo planes').
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                   int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
            const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tiles of a launch over B boards.
inline int tiles(int B) { return (B * kCells + kTileRows - 1) / kTileRows; }

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Whether a launch over B boards and C channels takes this design: C = 256
// and a tile for every SM of the current card.
inline bool takes(int B, int C) {
  return C == kC && tiles(B) >= sm_count();
}

// The cluster shape of the launch.
inline cudaLaunchConfig_t launch_config(cudaLaunchAttribute* at, int grid,
                                        cudaStream_t stream) {
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = kCluster;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// The most clusters that fit on the current card at once (0 on an error).
inline int max_clusters() {
  static int clusters = -1;
  if (clusters < 0) {
    clusters = 0;
    if (cudaFuncSetAttribute(conv3x3_i8_kernel_wide,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess)
      return 0;
    cudaLaunchAttribute at;
    const cudaLaunchConfig_t cfg = launch_config(
        &at, kCluster * (sm_count() / kCluster), nullptr);
    if (cudaOccupancyMaxActiveClusters(
            &clusters, conv3x3_i8_kernel_wide, &cfg) != cudaSuccess)
      clusters = 0;
  }
  return clusters;
}

// The persistent blocks of a launch over B boards: two tiles a block at
// least, whole clusters, as many as fit on the card at once.
inline int blocks(int B) {
  int groups = ((tiles(B) + 1) / 2 + kCluster - 1) / kCluster;
  const int most = max_clusters();
  if (groups > most) groups = most;
  return kCluster * groups;
}

inline int launch(const void* q, const void* wk, const void* ws,
                  const void* bias, const void* s_ptr, const void* residual,
                  const void* inv_next_ptr, void* out_h, void* out_q,
                  void* out_acc, int B, cudaStream_t stream) {
  const int grid = blocks(B);
  if (!grid) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = launch_config(&at, grid, stream);
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  // q [B, 7, 6, C] as (C bytes, x, y, board); the box is a board's 64
  // bytes of K over x = -1..5 and y = -1..7
  CUtensorMap q_map, w_map;
  const cuuint64_t q_dims[4] = {kC, 6, 7, static_cast<cuuint64_t>(B)};
  const cuuint64_t q_strides[3] = {kC, 6 * kC, kCells * kC};
  const cuuint32_t q_box[4] = {kRowBytes, 7, 9, 1};
  // wk [3, 3, Cout, Cin] as (Cin bytes, tap * Cout + n); the box is one
  // tap's 64 bytes of K for this block's 256 / kCluster output channels,
  // multicast to the cluster
  const cuuint64_t w_dims[2] = {kC, 9 * kC};
  const cuuint64_t w_strides[1] = {kC};
  const cuuint32_t w_box[2] = {kRowBytes, kC / kCluster};
  if (!encode(fn, &q_map, q, 4, q_dims, q_strides, q_box) ||
      !encode(fn, &w_map, wk, 2, w_dims, w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, conv3x3_i8_kernel_wide, q_map, w_map,
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(s_ptr), static_cast<const float*>(residual),
      static_cast<const float*>(inv_next_ptr), static_cast<float*>(out_h),
      static_cast<int8_t*>(out_q), static_cast<int32_t*>(out_acc), B);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
}  // namespace
