// K4's stem design: the network's first conv, bf16 3x3 SAME from the input
// features (Cin <= 16) to 256 channels, for launches whose batch fills the
// card.  conv_bf16.cu is K4's tiled design, which every other launch takes.
//
// Replaces: alphazero_risk_tpu/models/fast_infer.py, `_stem` (an XLA bf16
// conv with preferred_element_type=float32, the bias and the ReLU around
// it) and the int8 trunk's quantization of its output, as conv_bf16.cu does
// for smaller batches.  fast_infer.conv3x3_bf16 launches this design where
// the input is f32 with Cin <= 16, there is no residual, Cout = 256 and
// tiles of 64 rows give every SM one (stem_wide; B >= 200 on an H100).
//
// Computes v = relu(conv(bf16(x), w) + bias) with
//   x     [M, Cin] f32 NHWC (M = B*42), rounded to bf16 (round to nearest
//         even, as `.to(torch.bfloat16)` does) and zero-padded to 16
//         channels as it is staged,
//   w     [3, 3, Cin, 256] bf16 HWIO, bias [256] f32,
// and writes v as f32 (out), as bf16 rounded to nearest even (out_bf), and
// as the int8 trunk's first input clip(rint(v * inv_s), -127, 127) (out_q,
// inv_s the 0-d inverse scale on the device): any of them, the same values
// as conv_bf16.cu's.  Products of two bf16 values are exact in float32; the
// sums run in another order than the tiled design's.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): a row reads 4 Cin
// bytes and writes 256 x 4 (f32) + 256 (int8) bytes, so at B=4,096 the
// stem of the int8 trunk moves 229 MB, 68.4 us, against 12.7 GFLOP of
// products with K padded to 144 (12.8 us): bound by its bytes, 77% of them
// the f32 output.  The design keeps those stores flowing:
//
// Tiles.  A tile is 64 rows (board cells) x all 256 output channels, one
// wgmma m64n256k16 (bf16 -> f32, 128 accumulators a thread) per tap: K is 9
// taps x 16 channels.  64 rows span at most 3 boards.
//
// Blocks.  One persistent block per SM of two warpgroups, each walking its
// own tiles (tile (2k + wg) * gridDim.x + blockIdx.x in its k-th turn) with
// no block-wide barrier after the set-up, so that one warpgroup's
// multiplies and stores overlap the other's.
//
// The weight.  [3, 3, 16, 256] bf16, 72 KB, is copied once a block by
// cp.async into shared memory as stored (MN-major: each input channel's
// 256 output channels contiguous, in atoms of 64 channels x 8 input
// channels under the 128B swizzle, wgmma's transposed B) and stays there:
// input channels past Cin are zero-filled.
//
// The features.  Each warpgroup copies the f32 rows of its next tile's
// boards (contiguous in x) by 8-byte cp.async into a staging buffer while
// the current tile multiplies and stores, then rounds them to bf16 into
// its halo planes (conv_tc.cuh's: 64 positions a board, the zero column and
// rows around the 7x6 board, so that a tap is a row offset), 32 bytes a
// position.  The A fragments come from the planes by ldmatrix at the taps'
// row offsets, all nine before the nine wgmmas.
//
// Epilogue.  In eight parts of 32 channels: bias and ReLU in registers,
// then the f32 box (64 rows x 128 bytes, 128B swizzle), the bf16 box (64 x
// 64 bytes, 64B swizzle) and the int8 box (64 x 32 bytes; the codes of a
// row's four lanes gathered by two exchanges into 8-byte writes, as
// conv_i8_wide.cuh does) of an epilogue slot in shared memory; after a
// proxy fence and the warpgroup's barrier one thread stores the boxes by
// TMA, one bulk group a part, their lines the first the L2 evicts.  The
// int8 codes are rounded on the FP32 pipe (code()).  A warpgroup has
// kSlots slots, and a slot is written again only once the stores of kSlots
// parts ago have read it, so the stores drain while the next parts and the
// next tile are computed.
// The tensor maps clip rows past M; they are encoded once per (outputs, M)
// on the host and kept.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mutex>

#include "conv_tc.cuh"

// Internal linkage: libraries built from other copies of these sources may
// share a process.
namespace {
namespace stem {

using namespace tc;

constexpr int kC = 256;                      // output channels
constexpr int kK = 16;                       // input channels, zero-padded
constexpr int kTaps = 9;
constexpr int kTileRows = 64;
constexpr int kTileBoards = 3;               // the most boards a tile spans
constexpr int kWGs = 2;
constexpr int kThreads = 128 * kWGs;
constexpr int kPos = kK * 2;                 // bytes of a plane position
constexpr int kTapBytes = kK * kC * 2;       // one tap's weight: 8 KB
constexpr int kPartCols = 32;                // channels an epilogue part
constexpr int kParts = kC / kPartCols;
// epilogue slots a warpgroup; at least two, so that the barrier that ends a
// part orders the slot's next writes after its stores' reads
constexpr int kSlots = 4;
static_assert(kSlots >= 2 && kParts % kSlots == 0, "epilogue slots");
constexpr int kHBox = kTileRows * kPartCols * 4;      // f32: 8 KB
constexpr int kBBox = kTileRows * kPartCols * 2;      // bf16: 4 KB
constexpr int kQBox = kTileRows * kPartCols;          // int8: 2 KB
constexpr int kPlaneBytes = kTileBoards * kPlane * kPos;
constexpr int kRawBytes = 8192;              // a tile's f32 rows, staged
static_assert(kTileBoards * kCells * kK * 4 <= kRawBytes, "staging");
// Shared memory from the 1024-aligned base: the weight (9 x 8 KB), the
// slots' f32, bf16 and int8 boxes (warpgroup 0's first), the halo planes
// and the staging buffers of the two warpgroups, the bias: 219,136 bytes
// with the alignment's slack, of the 232,448 a block may have.
constexpr int kHOff = kTaps * kTapBytes;
constexpr int kBOff = kHOff + kWGs * kSlots * kHBox;
constexpr int kQOff = kBOff + kWGs * kSlots * kBBox;
constexpr int kPOff = kQOff + kWGs * kSlots * kQBox;
constexpr int kROff = kPOff + kWGs * kPlaneBytes;
constexpr int kBiasOff = kROff + kWGs * kRawBytes;
constexpr int kSmem = kBiasOff + kC * 4 + 1024;
static_assert(kSmem <= 232448, "more shared memory than a block may have");

// 8-byte asynchronous copy global -> shared (through L1).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(src));
}

// An L2 policy under which the lines a store writes are the first to
// leave: the outputs are read again only by the trunk's convs, after more
// than the L2 holds has been written (B=4,096: 220 MB), and the stores
// drain faster so (B=4,096: 85 against 93 us).
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// A TMA store of a 2-D box from this block under the L2 policy, in the
// thread's open bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the N newest of the thread's bulk groups have read
// their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Wait until the thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The named barrier of warpgroup wg (barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Byte offset of half h (8 channels) of plane position p: the halves swap
// every four positions, so that the eight rows of an ldmatrix fall in
// distinct banks.
__device__ __forceinline__ uint32_t pl(int p, int h) {
  return p * kPos + (((p >> 2) ^ h) & 1) * 16;
}

// The int8 code of v at the inverse scale inv, clip(rint(v * inv), -127,
// 127) with one rounded product (no contraction) and rint's half to even,
// in the low byte of the result (two's complement): adding 1.5 * 2^23 to
// the clipped product rounds it to an integer, half to even, in the low
// bits of the sum's significand.  On the FP32 pipe: rint and a conversion
// take the conversion pipe, a sixteenth of its rate.
__device__ __forceinline__ uint32_t code(float v, float inv) {
  const float y = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(y, 12582912.0f));
}

// The byte offset in a tap's weight of output channels n .. n + 7 of input
// channel k: four atoms of 64 channels along N (1 KB apart), two groups of
// 8 input channels along K (4 KB apart), each atom's rows in the 128B
// swizzle.
__device__ __forceinline__ uint32_t w_off(int k, int n) {
  return (k >> 3) * 4096 + (n >> 6) * 1024 + sw128(k & 7, (n >> 3) & 7);
}

// wgmma's descriptor of one tap's weight (w_off's layout): MN-major under
// the 128B swizzle, LBO the stride between atoms along N, SBO between the
// groups of 8 rows along K.
__device__ __forceinline__ uint64_t w_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(4096 >> 4) << 32) |
         (static_cast<uint64_t>(kSwizzle128) << 62);
}

// D (64 x 256 f32, the warpgroup's accumulators) (+)= A (64 x 16 bf16, the
// warps' fragments) * B (the descriptor's 16 x 256, read transposed); D is
// overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
      "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "
      "%101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Which outputs exist is a template argument (H: f32, BF: bf16, Q: int8),
// so that the epilogue has no branch on them.
template <bool H, bool BF, bool Q>
__global__ void __launch_bounds__(kThreads, 1)
stem_bf16_kernel(__grid_constant__ const CUtensorMap h_map,
                 __grid_constant__ const CUtensorMap b_map,
                 __grid_constant__ const CUtensorMap q_map,
                 const float* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ inv_ptr, int B, int Cin) {
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int wt = tid & 127;
  const bool elected = wt == 0;
  const int M = B * kCells;
  const int n_tiles = (M + kTileRows - 1) / kTileRows;
  const uint32_t base = aligned_base(smem);
  char* gbase = smem + (base - smem_u32(smem));
  float* s_bias = reinterpret_cast<float*>(gbase + kBiasOff);
  char* planes = gbase + kPOff + wg * kPlaneBytes;
  const uint32_t planes_u = base + kPOff + wg * kPlaneBytes;
  const float* raw = reinterpret_cast<const float*>(gbase + kROff +
                                                    wg * kRawBytes);
  const uint32_t raw_u = base + kROff + wg * kRawBytes;
  auto tile_of = [&](int k) {
    return (2 * k + wg) * static_cast<int>(gridDim.x) +
           static_cast<int>(blockIdx.x);
  };
  // the first board of tile t and how many boards it spans
  auto boards_of = [&](int t, int& b0) {
    const int r0 = t * kTileRows;
    b0 = r0 / kCells;
    return (min(r0 + kTileRows, M) - 1) / kCells - b0 + 1;
  };
  // this thread's share of the copies of tile t's f32 rows: its boards'
  // rows are contiguous in x, 168 Cin bytes a board (a multiple of 8)
  auto stage = [&](int t) {
    int b0;
    const int nb = boards_of(t, b0);
    const char* src = reinterpret_cast<const char*>(
        x + static_cast<int64_t>(b0) * kCells * Cin);
    const int n = nb * kCells * Cin / 2;
    for (int i = wt; i < n; i += 128) cp_async8(raw_u + i * 8, src + i * 8);
  };

  // the weight, once: 16-byte pieces of 8 output channels of one input
  // channel, zeros past Cin
  for (int e = tid; e < kTaps * kK * (kC / 8); e += kThreads) {
    const int t = e / (kK * (kC / 8));
    const int r = e - t * (kK * (kC / 8));
    const int k = r / (kC / 8);
    const int n = (r - k * (kC / 8)) * 8;
    const bool ok = k < Cin;
    const __nv_bfloat16* src =
        ok ? w + (static_cast<int64_t>(t) * Cin + k) * kC + n : w;
    cp_async16(base + t * kTapBytes + w_off(k, n), src, ok ? 16 : 0);
  }
  s_bias[tid] = bias[tid];
  // the planes' padding positions are never written again
  for (int i = wt; i < kPlaneBytes / 16; i += 128)
    reinterpret_cast<uint4*>(planes)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tile_of(0) < n_tiles) stage(tile_of(0));
  cp_async_commit();
  cp_async_wait<0>();
  // the weight, written by cp.async, is read by wgmma (the async proxy)
  fence_proxy_async();
  __syncthreads();

  const float inv = Q ? *inv_ptr : 0.0f;
  const uint64_t policy = evict_first();
  char* hbox = gbase + kHOff + wg * kSlots * kHBox;
  char* bbox = gbase + kBOff + wg * kSlots * kBBox;
  char* qbox = gbase + kQOff + wg * kSlots * kQBox;
  // this thread's rows of a tile: rl and rl + 8
  const int rl = (warp & 3) * 16 + (lane >> 2);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  uint32_t a[kTaps][4];

  for (int k = 0;; ++k) {
    const int t = tile_of(k);
    if (t >= n_tiles) break;
    const int r0 = t * kTileRows;
    int b0;
    const int nb = boards_of(t, b0);
    if (k > 0) {
      cp_async_wait<0>();
      wg_sync(wg);
    }
    // the staged rows into the planes, rounded to bf16, 8 channels (16
    // bytes) a piece, zeros past Cin
    for (int e = wt; e < nb * kCells * 2; e += 128) {
      const int bb = e / (kCells * 2);
      const int rem = e - bb * (kCells * 2);
      const int cell = rem >> 1;
      const int h = rem & 1;
      const float* src = raw + (bb * kCells + cell) * Cin;
      uint32_t pk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = h * 8 + 2 * j;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            c < Cin ? src[c] : 0.0f, c + 1 < Cin ? src[c + 1] : 0.0f);
        pk[j] = *reinterpret_cast<const uint32_t*>(&v);
      }
      *reinterpret_cast<uint4*>(planes + pl(bb * kPlane + cell_pos(cell),
                                            h)) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
    wg_sync(wg);
    // the next tile's rows, while this one multiplies and stores
    if (tile_of(k + 1) < n_tiles) stage(tile_of(k + 1));
    cp_async_commit();

    // this lane's row for ldmatrix; rows past M read a cell whose nine
    // taps stay inside the first board's plane, and are never stored
    int ra = r0 + (warp & 3) * 16 + (lane & 15);
    if (ra >= M) ra = b0 * kCells + 20;
    const int pos = (ra / kCells - b0) * kPlane + cell_pos(ra % kCells);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
      ldsm_x4(planes_u + pl(pos + tap_shift(tap / 3 - 1, tap % 3 - 1),
                            lane >> 4),
              a[tap]);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
      wgmma_bf16_n256(acc, a[tap], w_desc(base + tap * kTapBytes), tap);
    wgmma_commit();
    wgmma_wait<0>();
    pin(a);
    pin(acc);

    // Epilogue, in the order of the plain version:
    //   v = acc + bias; v = max(v, 0); q = clip(rint(v * inv_s), -127, 127)
    // this thread's f32 pairs in a box: rows rl and rl + 8, whose 128B
    // swizzle phase is lane >> 2; 16-byte chunk 2 jj + ((lane & 3) >> 1) of
    // column group jj, at byte 8 (lane & 1)
    const int cq = (lane & 3) >> 1;
    const int b8 = (lane & 1) * 8;
    const int p = lane & 3;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int j = part % kSlots;
      char* hb = hbox + j * kHBox;
      char* bb = bbox + j * kBBox;
      char* qb = qbox + j * kQBox;
      const int n0 = part * kPartCols + 2 * p;
      float2 v[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 bs = *reinterpret_cast<const float2*>(s_bias + n0 +
                                                           jj * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * part + 4 * jj + 2 * h;
          v[jj][h] = make_float2(fmaxf(acc[i] + bs.x, 0.0f),
                                 fmaxf(acc[i + 1] + bs.y, 0.0f));
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (H)
            *reinterpret_cast<float2*>(hb + sw128(rl + 8 * h, 2 * jj + cq) +
                                       b8) = v[jj][h];
          if (BF)
            *reinterpret_cast<__nv_bfloat162*>(
                bb + sw64(rl + 8 * h, jj) + 4 * p) =
                __floats2bfloat162_rn(v[jj][h].x, v[jj][h].y);
        }
      if (Q) {
        // the four lanes of a row hold 2 bytes of each of the part's four
        // column groups: two exchanges give lane p the 8 bytes of group p
        // (conv_i8_wide.cuh's, its masks and shifts as byte permutes: lo
        // and hi are a word's low and high 16 bits)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // group jj's two codes in the low 16 bits of b[jj]
          uint32_t b[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            b[jj] = __byte_perm(code(v[jj][h].x, inv),
                                code(v[jj][h].y, inv), 0x0040);
          // with lane p ^ 1: keep the groups whose parity is p's
          const uint32_t send = (p & 1) ? __byte_perm(b[0], b[2], 0x5410)
                                        : __byte_perm(b[1], b[3], 0x5410);
          const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 1);
          // 4 bytes of groups (p & 1) and (p & 1) + 2, at column 4 (p >> 1):
          // lo(got) | lo(b1) << 16 or lo(b0) | lo(got) << 16, and
          // hi(got) | lo(b3) << 16 or lo(b2) | hi(got) << 16
          const uint32_t ca = (p & 1) ? __byte_perm(got, b[1], 0x5410)
                                      : __byte_perm(b[0], got, 0x5410);
          const uint32_t cb = (p & 1) ? __byte_perm(got, b[3], 0x5432)
                                      : __byte_perm(b[2], got, 0x7610);
          // with lane p ^ 2: keep group p
          const uint32_t mine = p < 2 ? ca : cb;
          const uint32_t other =
              __shfl_xor_sync(0xffffffffu, p < 2 ? cb : ca, 2);
          *reinterpret_cast<uint2*>(qb + (rl + 8 * h) * kPartCols + p * 8) =
              p < 2 ? make_uint2(mine, other) : make_uint2(other, mine);
        }
      }
      // the boxes are written by every thread of the warpgroup
      fence_proxy_async();
      wg_sync(wg);
      if (elected) {
        if (H)
          tma_store_2d(&h_map, smem_u32(hb), part * kPartCols, r0, policy);
        if (BF)
          tma_store_2d(&b_map, smem_u32(bb), part * kPartCols, r0, policy);
        if (Q)
          tma_store_2d(&q_map, smem_u32(qb), part * kPartCols, r0, policy);
        bulk_commit();
        // the slot of the part after next may be written once the next
        // barrier is passed: its last stores, kSlots parts before it, have
        // read it
        bulk_wait_read<kSlots - 2>();
      }
    }
  }
  // the last stores are complete before the block's shared memory goes
  if (elected) bulk_wait();
}

// The driver's tensor-map encoder, through the runtime (no link to
// libcuda).  Null when the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
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

// An output's tensor map over [M, 256]: a box is one part of a tile, 32
// channels x 64 rows, in the swizzle of its shared-memory box.  Rows past M
// are not stored.  True for an absent output (its map is never read).
bool encode_out(EncodeTiled fn, CUtensorMap* map, const void* ptr, int M,
                CUtensorMapDataType type, int elem,
                CUtensorMapSwizzle swizzle) {
  if (!ptr) return true;
  const cuuint64_t dims[2] = {kC, static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kC) * elem};
  const cuuint32_t box[2] = {kPartCols, kTileRows};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of one launch's outputs, kept by (outputs, M): a map
// depends on nothing else, so the stems of a batch size, which write the
// same buffers call after call, encode theirs once.
struct Maps {
  const void* out;
  const void* out_bf;
  const void* out_q;
  int M;
  CUtensorMap h, b, q;
};

constexpr int kKept = 16;

int maps_for(const void* out, const void* out_bf, const void* out_q, int M,
             Maps* got) {
  static std::mutex mu;
  static Maps kept[kKept];
  static int n_kept = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_kept; ++i) {
    const Maps& m = kept[i];
    if (m.out == out && m.out_bf == out_bf && m.out_q == out_q && m.M == M) {
      *got = m;
      return 0;
    }
  }
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  Maps m = {out, out_bf, out_q, M, {}, {}, {}};
  if (!encode_out(fn, &m.h, out, M, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_out(fn, &m.b, out_bf, M, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_out(fn, &m.q, out_q, M, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  kept[next] = m;
  next = (next + 1) % kKept;
  if (n_kept < kKept) ++n_kept;
  *got = m;
  return 0;
}

// A launch's operands besides its tensor maps.
struct Args {
  const void* x;
  const void* w;
  const void* bias;
  const void* inv_s;
  int B, Cin, grid;
  cudaStream_t stream;
};

template <bool H, bool BF, bool Q>
int launch(const Maps& m, const Args& a) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        stem_bf16_kernel<H, BF, Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  stem_bf16_kernel<H, BF, Q><<<a.grid, kThreads, kSmem, a.stream>>>(
      m.h, m.b, m.q, static_cast<const float*>(a.x),
      static_cast<const __nv_bfloat16*>(a.w),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.inv_s),
      a.B, a.Cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stem
}  // namespace

// x [M, Cin] f32 (1 <= Cin <= 16), w [3, 3, Cin, 256] bf16, bias [256] f32,
// inv_s -> the int8 output's inverse scale (f32 on the device; required
// with out_q, else unread); out [M, 256] f32, out_bf [M, 256] bf16 and
// out_q [M, 256] int8, at least one of them.  M = B*42; every pointer
// 16-byte aligned.  Launches one block per SM (fewer where there are fewer
// tiles of 64 rows) on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int az_stem_bf16(const void* x, const void* w, const void* bias,
                            const void* inv_s, void* out, void* out_bf,
                            void* out_q, int M, int Cin, int Cout,
                            void* stream) {
  using namespace stem;
  if (M < 0 || M % kCells || Cin < 1 || Cin > kK || Cout != kC ||
      !(out || out_bf || out_q) || (out_q && !inv_s))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  Maps m;
  const int err = maps_for(out, out_bf, out_q, M, &m);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (M + kTileRows - 1) / kTileRows;
  const int grid = tiles < sms ? tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {x, w, bias, inv_s, M / kCells, Cin, grid, s};
  switch ((out ? 4 : 0) | (out_bf ? 2 : 0) | (out_q ? 1 : 0)) {
    case 1: return launch<false, false, true>(m, a);
    case 2: return launch<false, true, false>(m, a);
    case 3: return launch<false, true, true>(m, a);
    case 4: return launch<true, false, false>(m, a);
    case 5: return launch<true, false, true>(m, a);
    case 6: return launch<true, true, false>(m, a);
    default: return launch<true, true, true>(m, a);
  }
}
