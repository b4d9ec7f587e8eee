// Shared pieces of the tensor-core 3x3 SAME convolutions on the 7x6 board:
// K1 (conv_i8.cu, int8 wgmma m64n64k32) and K4 (conv_bf16.cu, bf16 wgmma
// m64n64k16).  Both are implicit GEMMs: M = B*42 board cells, N = Cout,
// K = 9 taps * Cin.
//
// Tiles.  A block owns whole boards and 64 output channels.  Its warpgroups
// each compute MT tiles of 64 rows x 64 with one wgmma per tile and 32
// bytes of K.  Two shapes (Tile below): 2 warpgroups x 1 tile = 128 rows, 3
// boards (small batches: many blocks), and 2 warpgroups x 2 tiles = 256
// rows, 6 boards (large batches).  Each block reads the weights of its 64
// channels once from L2, so the rows it owns set the products per weight
// byte: the large shape does twice as many.  Its buffers (99 KB) let two
// blocks share an SM, so that one block's barrier and copies overlap the
// other's wgmmas (a 512-row shape, one block per SM, measured slower).  The
// launcher picks the shape from the batch and the card's SM count
// (conv_boards).  K advances in chunks of 64 bytes of input channels (32
// bf16 or 64 int8 values).
//
// A through a halo plane, from registers.  For each chunk, each board's
// activations are staged once into a zero-padded plane of 64 positions x 64
// bytes: the board is laid out 7 positions wide (6 cells and one zero
// column, which is also the left neighbour of the next row's first cell)
// between a zero row above and one below, plus one zero position in front:
//     pos(y, x) = 8 + 7*y + x,  tap (dy, dx) reads pos + 7*dy + dx,
// always inside 0..63.  `ldmatrix` takes one row address per lane, so a tap
// is an offset added to each lane's row and the SAME padding costs nothing;
// the fragments it returns are wgmma's A operand in registers.  A is read
// from device memory once per chunk, not once per tap.
//
// B from shared memory.  The (chunk, kernel row) slice of the weights
// (three taps of 64 bytes of K x 64) is one stage of a kStages-deep ring
// filled by cp.async, each tap in one of wgmma's swizzled canonical forms so
// that the tensor cores read it without bank conflicts: int8 K-major (each
// output channel's 64 bytes of K in one row, 16-byte chunks XOR-ed with bits
// 1-2 of the row: the 64B swizzle; the weight is packed K-major at fold
// time), bf16 MN-major (each input channel's 64 output channels, 128 bytes,
// in one row, chunks XOR-ed with the row's low 3 bits: the 128B swizzle; the
// HWIO weight as stored, transposed by the instruction).  The halo planes
// are double-buffered: the next chunk's load while the current one is
// multiplied.  One cp.async group and one __syncthreads per (chunk, kernel
// row) step.
//
// Overlap of the tensor cores with the loads.  One wgmma group per (tap,
// 32 bytes of K); its A fragments come from one of two register sets, so
// the next group's ldmatrix fills the other set while it runs, and each
// group waits only for the one before it (wgmma.wait_group 1).  The group
// left in flight crosses the next step's barrier, so the ring is refilled
// kStages - 2 steps ahead: the stage being refilled was last read two steps
// back, by a group that has retired.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tc {

constexpr int kCells = 42;      // 7 x 6 board
constexpr int kPlane = 64;      // plane positions per board
constexpr int kRowBytes = 64;   // bytes of K per chunk
constexpr int kBN = 64;         // output channels per block
constexpr int kStages = 4;      // weight ring depth (steps)
constexpr int kAhead = kStages - 2;   // steps a weight stage is loaded ahead
constexpr int kRowTaps = 3;     // taps per step: one row of the kernel
constexpr int kSteps = 3;       // steps per chunk
constexpr int kSlice = kBN * kRowBytes;               // one tap's weights
constexpr int kStage = kRowTaps * kSlice;             // one step's weights

// A block shape: NWG warpgroups, each MT tiles of 64 rows.
template <int NWG, int MT>
struct Tile {
  static constexpr int kMT = MT;
  static constexpr int kThreads = NWG * 128;
  static constexpr int kRows = NWG * MT * 64;
  static constexpr int kBoards = kRows / kCells;        // 3 or 6
  // blocks an SM should hold (512 threads' worth): ptxas keeps a thread to
  // 128 registers
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kABuf = kBoards * kPlane * kRowBytes;
  // two halo plane sets and the weight ring, and room to align them to
  // 1024 bytes (the 128B swizzle's atom)
  static constexpr int kSmem = 2 * kABuf + kStages * kStage + 1024;
};
using Small = Tile<2, 1>;       // 128 rows, 3 boards, 256 threads
using Large = Tile<2, 2>;       // 256 rows, 6 boards

// Boards per block of a launch over B boards and Cout output channels: the
// large shape where it still gives every SM of the current card a block,
// else the small one (twice the blocks).
inline int conv_boards(int B, int Cout) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int large_blocks = (B + Large::kBoards - 1) / Large::kBoards *
                           (Cout / kBN);
  return large_blocks >= sms ? Large::kBoards : Small::kBoards;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; bytes past `src_bytes` are
// zero-filled (src_bytes 0 writes 16 zeros and reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads shared memory
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, LBO and SBO in
// 16-byte units, and the swizzle mode (1: 128B, 2: 64B).  For both of the
// layouts here SBO is the stride between groups of 8 rows and LBO is not
// used (one swizzle atom spans the tile's other dimension).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

constexpr uint32_t kSwizzle128 = 1;
constexpr uint32_t kSwizzle64 = 2;

// D (64 x 64, the warpgroup's accumulators) += A (64 x 16 bf16 or 64 x 32
// s8, the warps' fragments) * B (the descriptor's tile).  bf16 B is read
// MN-major (transposed), s8 B K-major.
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of 64-byte rows
// (two rows per 128-byte bank line), XOR-swizzled so that eight
// consecutive rows fall in distinct banks: the 64B swizzle of wgmma (for a
// tile on a 512-byte boundary), also used for the halo planes read by
// ldmatrix.
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// ... of 128-byte rows: wgmma's 128B swizzle (on a 1024-byte boundary).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ int cell_pos(int cell) {
  return 8 + 7 * (cell / 6) + cell % 6;
}

// The plane offset of tap (dy + 1, dx + 1).
__device__ __forceinline__ int tap_shift(int dy, int dx) {
  return 7 * dy + dx;
}

// The plane row (board * kPlane + position) whose data lane `lane` hands
// to ldmatrix for tile `mt` of its warpgroup: warp q of warpgroup g owns
// rows 16q..16q+15 of the warpgroup's tiles (as wgmma's A fragment wants),
// tile mt covering block rows (g * MT + mt) * 64 ..; lanes 0-15 give the
// warp's rows 0-15 (K bytes 0-15 of a step), lanes 16-31 the same rows (K
// bytes 16-31).  Padding rows past the block's boards read a cell whose
// nine taps stay inside board 0's plane; their outputs are never written.
template <class T>
__device__ __forceinline__ int a_row(int tid, int mt) {
  const int warp = tid >> 5;
  int r = ((warp >> 2) * T::kMT + mt) * 64 + (warp & 3) * 16 + (tid & 15);
  if (r >= T::kBoards * kCells) r = 20;
  return (r / kCells) * kPlane + cell_pos(r % kCells);
}

// The block row of accumulator half h (rows +0 / +8) of tile mt.
template <class T>
__device__ __forceinline__ int d_row(int tid, int mt, int h) {
  const int warp = tid >> 5;
  return ((warp >> 2) * T::kMT + mt) * 64 + (warp & 3) * 16 +
         ((tid & 31) >> 2) + 8 * h;
}

// Copy one chunk of the halo planes (64 bytes per cell) by cp.async, for
// the `boards` boards of the block that exist.  `row_of(board, cell)` is
// the global address of the cell's chunk; `bytes` how many of its 64 bytes
// lie inside Cin (the rest is zero-filled).
template <class T, class RowOf>
__device__ __forceinline__ void load_planes_async(uint32_t sA, int tid,
                                                  int boards, RowOf row_of,
                                                  int bytes) {
  for (int e = tid; e < boards * kCells * 4; e += T::kThreads) {
    const int b = e / (kCells * 4);
    const int rem = e - b * (kCells * 4);
    const int cell = rem >> 2;
    const int ch = rem & 3;
    const int n = min(max(bytes - ch * 16, 0), 16);
    const char* src = row_of(b, cell) + (n ? ch * 16 : 0);
    cp_async16(sA + sw64(b * kPlane + cell_pos(cell), ch), src, n);
  }
}

// Zero both halo plane sets at `planes`: the padding positions are never
// written again.
template <class T>
__device__ __forceinline__ void zero_planes(char* planes, int tid) {
  uint4* p = reinterpret_cast<uint4*>(planes);
  for (int i = tid; i < 2 * T::kABuf / 16; i += T::kThreads)
    p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Pin a value to its register at this point: a wgmma reads its A fragment
// from registers, and writes its accumulators, asynchronously, so neither
// may be moved or reused between the issue and the wait.
__device__ __forceinline__ void pin(uint32_t& v) {
  asm volatile("" : "+r"(v) :: "memory");
}
__device__ __forceinline__ void pin(int& v) {
  asm volatile("" : "+r"(v) :: "memory");
}
__device__ __forceinline__ void pin(float& v) {
  asm volatile("" : "+f"(v) :: "memory");
}
template <class V, int N>
__device__ __forceinline__ void pin(V (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(v[i]);
}

// The main loop shared by both kernels: steps i = chunk * 3 + kernel row
// over `n_chunks` chunks, each step the three taps of one kernel row.
// load_a(c, sA) issues the copies of chunk c's halo planes, at the first
// step of chunk c - 1 (their rows come from device memory); load_b(i, sB)
// those of step i's three weight slices, kAhead steps ahead.
// mma(acc[mt], a, sB, ks) issues one wgmma: tile mt's A fragments `a` times
// the 32 bytes of K number ks of the tap slice at sB.  Leaves every wgmma
// retired and `acc` final.  `base` (the block's buffers) is aligned to 1024
// bytes.
template <class T, class V, class LoadA, class LoadB, class Mma>
__device__ __forceinline__ void pipeline(uint32_t base, int tid, int n_chunks,
                                         V (&acc)[T::kMT][kBN / 2],
                                         LoadA load_a, LoadB load_b, Mma mma) {
  constexpr int MT = T::kMT;
  const int n_steps = n_chunks * kSteps;
  const int lane = tid & 31;
  auto plane = [&](int c) { return base + (c & 1) * T::kABuf; };
  auto stage = [&](int i) {
    return base + 2 * T::kABuf + (i % kStages) * kStage;
  };
  int arow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) arow[mt] = a_row<T>(tid, mt);
  // two sets of A fragments: set ks feeds the groups of K bytes 32*ks..
  uint32_t a[2][MT][4] = {};

  load_a(0, plane(0));
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_steps) load_b(s, stage(s));
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    const int c = i / kSteps;
    const int row = i - c * kSteps;
    // chunk c - 1's planes are no longer read (A is in registers): fill
    // them with chunk c + 1
    if (row == 0 && c + 1 < n_chunks) load_a(c + 1, plane(c + 1));
    if (i + kAhead < n_steps) load_b(i + kAhead, stage(i + kAhead));
    cp_async_commit();
    const uint32_t sA = plane(c), sB = stage(i);
#pragma unroll
    for (int tt = 0; tt < kRowTaps; ++tt) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        // the group that read set ks has retired (the wait below, one group
        // ago)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(sA + sw64(arow[mt] + tap_shift(row - 1, tt - 1),
                            2 * ks + (lane >> 4)),
                  a[ks][mt]);
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma(acc[mt], a[ks][mt], sB + tt * kSlice, ks);
        wgmma_commit();
        // retire the group before this one: set ks ^ 1 is free again
        wgmma_wait<1>();
        pin(a[ks ^ 1]);
        pin(acc);
      }
    }
  }
  wgmma_wait<0>();
  pin(a);
  pin(acc);
}

// The shared-memory address of the block's buffers: the dynamic shared
// memory rounded up to 1024 bytes.
__device__ __forceinline__ uint32_t aligned_base(const char* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

}  // namespace tc
