// K1: int8 3x3 SAME convolution on the 7x6 board with a fused epilogue, on
// the tensor cores (wgmma s8 -> s32), in two designs chosen by the
// launch's shape.
//
// Replaces: alphazero_risk_tpu/models/fast_infer.py, `_conv_i8` (an XLA
// int8 x int8 -> int32 conv) together with the elementwise work around it in
// `_trunk_xla_int8`: dequantize (acc * (s * ws) + b), the residual add, the
// ReLU and the requantization of the next conv's input
// (clip(rint(h * (1/s_next)), -127, 127)).  Both stay as they are there.
//
// Bound on an H100 (1,979 TOP/s int8 dense, 3.35 TB/s): one conv at C=256
// is 2*M*9*256^2 operations; the conv_b epilogue moves M*C*(1+4+4+1) bytes
// plus the 0.6 MB weight.  At B=64 (M=2,688): 3.17 GOP, 1.6 us, against
// 7.5 MB, 2.2 us.  At B=1,024: 50.7 GOP, 25.6 us, against 110 MB, 33 us
// (conv_a moves 22.6 MB: its int8 work bounds it).  A third bound is L2:
// every tile streams the whole weight (590 KB at C=256) from L2, so the
// rows a weight slice serves set the L2 bytes a conv reads.
//
// The wide design (conv_i8_wide.cuh) takes a launch where C=256 and its
// tiles of 64 rows give every SM of the card one (ceil(42 B / 64) >= SMs:
// B >= 200 on an H100's 132 SMs): tiles of 64 rows x all 256 output
// channels, m64n256k32 per consumer warpgroup, so each A fragment serves
// every output channel and each board's halo plane is staged once per
// chunk; a producer warpgroup feeds a TMA weight ring and a TMA plane ring
// through mbarriers; persistent blocks, one per SM, in clusters of 4 that
// share each weight slice by multicast (a slice read from L2 serves 4
// tiles: 99 MB of L2 weight reads a conv at B=1,024, against 396 MB
// unshared; 30 such clusters fit on an H100, 120 blocks); two consumer
// warpgroups in ping-pong, so that one's epilogue runs under the other's
// wgmmas; the epilogue's residual in, and its h and q_next out, by TMA
// through shared memory.  On an H100 what is left is the epilogue's own
// work, which slows the other warpgroup's wgmmas while it runs.
//
// The tiled design (conv_tc.cuh, which K4 shares) for smaller batches and
// for C = 64 or 128: board-aligned tiles with each board's zero-padded
// halo plane staged once per 64-channel chunk by cp.async, a chunk ahead;
// the nine taps as row offsets of ldmatrix, whose fragments are wgmma's A
// in registers; the weight's (chunk, kernel row) slices through a 4-stage
// cp.async ring into wgmma's K-major 64B-swizzled layout.  One wgmma group
// per (tap, 32 channels), its A fragments in one of two register sets, so
// the next group's ldmatrix runs while it multiplies.  64 output channels
// per block; 3 boards on 2 warpgroups for small batches, 6 boards on 2
// warpgroups of two tiles (twice the products per weight byte read from
// L2, two blocks per SM) for large ones (the launcher chooses from the SM
// count).
//
// Both: wgmma s8 takes K-major operands only (no transpose for 8-bit
// data), so the weight comes packed at fold time as [3, 3, Cout, Cin]
// (fast_infer.pack_trunk_wq).  The int32 sums are exact (|acc| <=
// 127*127*9*C < 2^31) in any order.  The epilogue runs on the accumulators
// in registers, in the order of `_trunk_xla_int8`, compiled without FMA
// contraction (--fmad=false) so that it rounds like the plain PyTorch
// version; the int32 tensor never reaches device memory unless asked for.

#include <cstdint>
#include <cuda_runtime.h>

#include "conv_tc.cuh"
#include "conv_i8_wide.cuh"

namespace {

using namespace tc;

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
conv3x3_i8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wk,
                  const float* __restrict__ ws, const float* __restrict__ bias,
                  const float* __restrict__ s_ptr,
                  const float* __restrict__ residual,
                  const float* __restrict__ inv_next_ptr,
                  float* __restrict__ out_h, int8_t* __restrict__ out_q,
                  int32_t* __restrict__ out_acc, int B, int C) {
  constexpr int MT = T::kMT;
  extern __shared__ __align__(1024) char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int board0 = blockIdx.x * T::kBoards;
  const int boards = min(T::kBoards, B - board0);
  const int n0 = blockIdx.y * kBN;

  const uint32_t base = aligned_base(smem);
  char* planes = smem + (base - smem_u32(smem));
  zero_planes<T>(planes, tid);
  __syncthreads();

  int acc[MT][kBN / 2] = {};

  auto load_a = [&](int c, uint32_t sA) {
    const int k0 = c * kRowBytes;
    const char* qc = reinterpret_cast<const char*>(q);
    load_planes_async<T>(
        sA, tid, boards,
        [&](int b, int cell) {
          return qc + (static_cast<int64_t>(board0 + b) * kCells + cell) * C
                 + k0;
        },
        kRowBytes);
  };

  auto load_b = [&](int i, uint32_t sB) {
    const int c = i / kSteps;
    const int k0 = c * kRowBytes;
    // weight slices of the three taps of kernel row i % 3: 64 output
    // channels x 64 input channels each, each 16-byte piece 16 input
    // channels of one output channel
    for (int e = tid; e < kRowTaps * kBN * 4; e += T::kThreads) {
      const int tt = e / (kBN * 4);
      const int r = e - tt * (kBN * 4);
      const int t = (i - c * kSteps) * 3 + tt;
      const int n = r >> 2;
      const int kc = r & 3;
      cp_async16(sB + tt * kSlice + sw64(n, kc),
                 wk + (static_cast<int64_t>(t) * C + n0 + n) * C + k0 +
                     kc * 16,
                 16);
    }
  };

  auto mma = [](int (&d)[kBN / 2], const uint32_t (&a)[4], uint32_t sB,
                int ks) {
    // 32 bytes of K of the K-major 64B-swizzled slice
    wgmma_s8_n64(d, a, smem_desc(sB + ks * 32, 512, kSwizzle64));
  };

  pipeline<T>(base, tid, C / kRowBytes, acc, load_a, load_b, mma);
  // Epilogue, in the order of _trunk_xla_int8:
  //   v = acc * (s * ws) + b; [v = v + x;] v = max(v, 0)
  //   q_next = clip(rint(v * (1 / s_next)), -127, 127)
  const float s = *s_ptr;
  const float inv_next = inv_next_ptr ? *inv_next_ptr : 0.0f;
  const int rows = boards * kCells;
  const int64_t m0 = static_cast<int64_t>(board0) * kCells;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * (lane & 3);
    const float sw[2] = {s * ws[n], s * ws[n + 1]};
    const float bb[2] = {bias[n], bias[n + 1]};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = d_row<T>(tid, mt, h);
        if (r >= rows) continue;
        const int64_t o = (m0 + r) * C + n;
        const int a0 = acc[mt][4 * j + 2 * h];
        const int a1 = acc[mt][4 * j + 2 * h + 1];
        if (out_acc)
          *reinterpret_cast<int2*>(out_acc + o) = make_int2(a0, a1);
        float v[2] = {static_cast<float>(a0) * sw[0] + bb[0],
                      static_cast<float>(a1) * sw[1] + bb[1]};
        if (residual) {
          const float2 rr = *reinterpret_cast<const float2*>(residual + o);
          v[0] = v[0] + rr.x;
          v[1] = v[1] + rr.y;
        }
        v[0] = fmaxf(v[0], 0.0f);
        v[1] = fmaxf(v[1], 0.0f);
        if (out_h)
          *reinterpret_cast<float2*>(out_h + o) = make_float2(v[0], v[1]);
        if (out_q) {
          char2 qq;
          qq.x = static_cast<signed char>(
              fminf(fmaxf(rintf(v[0] * inv_next), -127.0f), 127.0f));
          qq.y = static_cast<signed char>(
              fminf(fmaxf(rintf(v[1] * inv_next), -127.0f), 127.0f));
          *reinterpret_cast<char2*>(out_q + o) = qq;
        }
      }
    }
  }
}

template <class T>
int launch(const void* q, const void* wk, const void* ws, const void* bias,
           const void* s_ptr, const void* residual, const void* inv_next_ptr,
           void* out_h, void* out_q, void* out_acc, int B, int C,
           cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_i8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  dim3 grid((B + T::kBoards - 1) / T::kBoards, C / kBN);
  conv3x3_i8_kernel<T><<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(wk),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(s_ptr), static_cast<const float*>(residual),
      static_cast<const float*>(inv_next_ptr), static_cast<float*>(out_h),
      static_cast<int8_t*>(out_q), static_cast<int32_t*>(out_acc), B, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [M, C] int8 (NHWC, M = B*42), wk [3, 3, C(out), C(in)] int8 (K-major,
// pack_trunk_wq), ws / bias [C] f32, s_ptr -> the activation scale of q (f32
// on the device).  residual [M, C] f32 or null; inv_next_ptr -> 1/s_next or
// null (required with out_q).  Any of out_h [M, C] f32, out_q [M, C] int8,
// out_acc [M, C] int32 may be null.  C a multiple of 64; every pointer
// 16-byte aligned.  Launches the wide design where az_conv3x3_i8_wide(B,
// C) (min(tiles, SMs) blocks over ceil(B / 3) tiles), else ceil(B /
// boards) x C/64 blocks of az_conv3x3_i8_boards(B, C) boards each, on
// `stream`, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int az_conv3x3_i8(const void* q, const void* wk, const void* ws,
                             const void* bias, const void* s_ptr,
                             const void* residual, const void* inv_next_ptr,
                             void* out_h, void* out_q, void* out_acc, int M,
                             int C, void* stream) {
  const int B = M / kCells;
  if (M % kCells || C % kBN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide::takes(B, C))
    return wide::launch(q, wk, ws, bias, s_ptr, residual, inv_next_ptr,
                        out_h, out_q, out_acc, B, s);
  return conv_boards(B, C) == Large::kBoards
             ? launch<Large>(q, wk, ws, bias, s_ptr, residual, inv_next_ptr,
                             out_h, out_q, out_acc, B, C, s)
             : launch<Small>(q, wk, ws, bias, s_ptr, residual, inv_next_ptr,
                             out_h, out_q, out_acc, B, C, s);
}

// Boards per block of a launch over B boards and C output channels on the
// current card (3 or 6; 0 in the wide design, whose tiles are 64 rows).
extern "C" int az_conv3x3_i8_boards(int B, int C) {
  return wide::takes(B, C) ? 0 : conv_boards(B, C);
}

// 1 where a launch over B boards and C output channels on the current card
// takes the wide design, else 0.
extern "C" int az_conv3x3_i8_wide(int B, int C) {
  return wide::takes(B, C) ? 1 : 0;
}

// The blocks such a launch runs: the wide design's persistent blocks, or
// the tiled design's one block a tile.
extern "C" int az_conv3x3_i8_blocks(int B, int C) {
  if (wide::takes(B, C)) return wide::blocks(B);
  const int per = conv_boards(B, C);
  return (B + per - 1) / per * (C / kBN);
}
