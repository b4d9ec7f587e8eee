// K4: bf16 3x3 SAME convolution on the 7x6 board with a fused epilogue, on
// the tensor cores (wgmma m64n64k16 bf16 -> f32).
//
// Replaces: alphazero_risk_tpu/models/fast_infer.py, `_stem` and
// `_trunk_xla_bf16` (XLA bf16 convs with preferred_element_type=float32 and
// the bias / residual / ReLU elementwise work around them), the same
// convs inside `calibrate_trunk`, and the int8 trunk's quantization of the
// stem's output in `_trunk_xla_int8`.
//
// Computes v = relu(conv(bf16(x), w) + bias [+ residual]) with
//   x        [M, Cin] NHWC (M = B*42), f32 (rounded to bf16 here,
//            round-to-nearest-even as `.to(torch.bfloat16)` does) or bf16,
//   w        [3, 3, Cin, Cout] bf16 HWIO, read as stored (wgmma's
//            MN-major B),
//   bias     [Cout] f32, residual [M, Cout] f32 or null,
// and writes v as f32 (out), as bf16 rounded to nearest even (out_bf, the
// next conv's input: JAX rounds each conv's input to bf16), and/or as the
// int8 trunk's first input, clip(rint(v * inv_s), -127, 127) rounded half
// to even (out_q, with inv_s the 0-d inverse scale of the first int8 conv's
// input, on the device: what K1's epilogue does for the convs after it, so
// the stem's output needs no quantizing pass of its own).
// Products of two bf16 values are exact in float32; the sums run in another
// order than any other conv's.
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at B=64, C=256 one
// conv is 2*2688*2304*256 = 3.17 GFLOP, 3.2 us, and moves 1.4 MB in (bf16
// x) + 1.2 MB weights + 1.4-4.1 MB out (bf16 and/or f32, f32 residual):
// about 1-2 us.  At B=1024 it is 50.7 GFLOP, 51 us, against 20-67 MB,
// 6-20 us: bound by the operations at both sizes.  The stem (Cin=13) is
// bound by its bytes: at B=1024 2.2 MB in and 44 MB out as f32, 11 MB more
// with the int8 output (13.8 us, 17.1 us with it).
//
// Design (conv_tc.cuh): board-aligned tiles with each board's zero-padded
// halo plane staged once per 32-channel chunk by cp.async, a chunk ahead;
// the nine taps as row offsets of ldmatrix, whose fragments are wgmma's A
// in registers; the HWIO weights' (chunk, kernel row) slices through a
// 4-stage cp.async ring into wgmma's MN-major 128B-swizzled layout, taken
// as stored; one wgmma group per (tap, 16 channels), its A fragments in one
// of two register sets, so the next group's ldmatrix runs while it
// multiplies.  64 output channels per block; 3 boards on 2 warpgroups for
// small batches, 6 boards on 2 warpgroups of two tiles (twice the products
// per weight byte read from L2, two blocks per SM) for large ones (the
// launcher chooses from the SM count).  An f32 input (the stem's
// features, Cin=13) is rounded while it is staged, with zeros past Cin.
// The epilogue adds the bias and the residual and applies the ReLU in
// registers, and writes 8 bytes (f32) and 4 bytes (bf16) per lane and row;
// the int8 codes of four column groups leave, after two exchanges in a
// row's four lanes, as one 8-byte store a lane and row (as K1's wide
// design stores them), so that each store instruction fills whole 32-byte
// sectors.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_tc.cuh"

namespace {

using namespace tc;

constexpr int kKC = 32;   // input channels per chunk (64 bytes of bf16)

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
conv3x3_bf16_kernel(const void* __restrict__ x, int x_bf16,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ residual,
                    const float* __restrict__ inv_ptr,
                    float* __restrict__ out,
                    __nv_bfloat16* __restrict__ out_bf,
                    int8_t* __restrict__ out_q, int B, int Cin, int Cout) {
  constexpr int MT = T::kMT;
  extern __shared__ __align__(1024) char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int board0 = blockIdx.x * T::kBoards;
  const int boards = min(T::kBoards, B - board0);
  const int n0 = blockIdx.y * kBN;
  const int n_chunks = (Cin + kKC - 1) / kKC;

  const uint32_t base = aligned_base(smem);
  char* planes = smem + (base - smem_u32(smem));
  zero_planes<T>(planes, tid);
  __syncthreads();

  float acc[MT][kBN / 2] = {};

  auto load_a = [&](int c, uint32_t sA) {
    const int k0 = c * kKC;
    if (x_bf16) {
      const char* xb = static_cast<const char*>(x);
      load_planes_async<T>(
          sA, tid, boards,
          [&](int b, int cell) {
            return xb + ((static_cast<int64_t>(board0 + b) * kCells + cell)
                             * Cin + k0) * 2;
          },
          (Cin - k0) * 2);
    } else {
      // f32 input: round to bf16 while staging, zeros past Cin
      const float* xf = static_cast<const float*>(x);
      for (int e = tid; e < boards * kCells * 4; e += T::kThreads) {
        const int b = e / (kCells * 4);
        const int rem = e - b * (kCells * 4);
        const int cell = rem >> 2;
        const int ch = rem & 3;
        const float* src =
            xf + (static_cast<int64_t>(board0 + b) * kCells + cell) * Cin;
        uint32_t pk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + ch * 8 + 2 * j;
          const float lo = k < Cin ? src[k] : 0.0f;
          const float hi = k + 1 < Cin ? src[k + 1] : 0.0f;
          const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
          pk[j] = *reinterpret_cast<const uint32_t*>(&v);
        }
        *reinterpret_cast<uint4*>(planes + (sA - base) +
                                  sw64(b * kPlane + cell_pos(cell), ch)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
    }
  };

  auto load_b = [&](int i, uint32_t sB) {
    const int c = i / kSteps;
    const int k0 = c * kKC;
    // weight slices of the three taps of kernel row i % 3: 32 input
    // channels x 64 output channels each, each 16-byte piece 8 output
    // channels of one input channel
    for (int e = tid; e < kRowTaps * kKC * (kBN / 8); e += T::kThreads) {
      const int tt = e / (kKC * (kBN / 8));
      const int r = e - tt * (kKC * (kBN / 8));
      const int t = (i - c * kSteps) * 3 + tt;
      const int k = r / (kBN / 8);
      const int g = r - k * (kBN / 8);
      const bool ok = k0 + k < Cin;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<int64_t>(t) * Cin + k0 + k) * Cout + n0 +
                   g * 8
             : w;
      cp_async16(sB + tt * kSlice + sw128(k, g), src, ok ? 16 : 0);
    }
  };

  auto mma = [](float (&d)[kBN / 2], const uint32_t (&a)[4], uint32_t sB,
                int ks) {
    // 16 input channels (rows) of the MN-major 128B-swizzled slice
    wgmma_bf16_n64(d, a, smem_desc(sB + ks * 2048, 1024, kSwizzle128));
  };

  pipeline<T>(base, tid, n_chunks, acc, load_a, load_b, mma);
  // Epilogue, in the order of the plain version:
  //   v = acc + bias; [v = v + residual;] v = max(v, 0)
  //   q = clip(rint(v * inv_s), -127, 127)
  const float inv = out_q ? *inv_ptr : 0.0f;
  const int rows = boards * kCells;
  const int64_t m0 = static_cast<int64_t>(board0) * kCells;
  // this lane's int8 codes of four column groups, two channels (16 bits) a
  // group, two groups a word (the even one low), zero on rows past the
  // block's
  uint32_t qw[MT][2][2] = {};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * (lane & 3);
    const float2 bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = d_row<T>(tid, mt, h);
        if (r >= rows) continue;
        const int64_t o = (m0 + r) * Cout + n;
        float v0 = acc[mt][4 * j + 2 * h] + bb.x;
        float v1 = acc[mt][4 * j + 2 * h + 1] + bb.y;
        if (residual) {
          const float2 rr = *reinterpret_cast<const float2*>(residual + o);
          v0 = v0 + rr.x;
          v1 = v1 + rr.y;
        }
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
        if (out) *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        if (out_bf)
          *reinterpret_cast<__nv_bfloat162*>(out_bf + o) =
              __floats2bfloat162_rn(v0, v1);
        if (out_q) {
          // one rounded product each (no contraction), then rint and clip
          // as K1 does
          const int q0 = static_cast<int>(fminf(
              fmaxf(rintf(__fmul_rn(v0, inv)), -127.0f), 127.0f));
          const int q1 = static_cast<int>(fminf(
              fmaxf(rintf(__fmul_rn(v1, inv)), -127.0f), 127.0f));
          qw[mt][h][(j >> 1) & 1] |=
              static_cast<uint32_t>((q0 & 0xff) | (q1 & 0xff) << 8)
              << (16 * (j & 1));
        }
      }
    }
    if (out_q && (j & 3) == 3) {
      // groups g0 .. g0 + 3: lane p of a row holds 2 bytes of each; two
      // exchanges give it the 8 bytes of group g0 + p (conv_i8_wide.cuh)
      const int p = lane & 3;
      const int g0 = j - 3;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t b0 = qw[mt][h][0] & 0xffffu, b1 = qw[mt][h][0] >> 16;
          const uint32_t b2 = qw[mt][h][1] & 0xffffu, b3 = qw[mt][h][1] >> 16;
          qw[mt][h][0] = qw[mt][h][1] = 0;
          // with lane p ^ 1: keep the groups whose parity is p's
          const uint32_t send = (p & 1) ? b0 | b2 << 16 : b1 | b3 << 16;
          const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 1);
          // 4 bytes of groups (p & 1) and (p & 1) + 2, at column
          // 4 * (p >> 1)
          const uint32_t ca = (p & 1) ? (got & 0xffffu) | b1 << 16
                                      : b0 | got << 16;
          const uint32_t cb = (p & 1) ? (got >> 16) | b3 << 16
                                      : b2 | (got & 0xffff0000u);
          // with lane p ^ 2: keep group p
          const uint32_t mine = p < 2 ? ca : cb;
          const uint32_t other =
              __shfl_xor_sync(0xffffffffu, p < 2 ? cb : ca, 2);
          const int r = d_row<T>(tid, mt, h);
          if (r < rows)
            *reinterpret_cast<uint2*>(out_q + (m0 + r) * Cout + n0 +
                                      (g0 + p) * 8) =
                p < 2 ? make_uint2(mine, other) : make_uint2(other, mine);
        }
      }
    }
  }
}

template <class T>
int launch(const void* x, int x_bf16, const void* w, const void* bias,
           const void* residual, const void* inv_ptr, void* out,
           void* out_bf, void* out_q, int B, int Cin, int Cout,
           cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  dim3 grid((B + T::kBoards - 1) / T::kBoards, Cout / kBN);
  conv3x3_bf16_kernel<T><<<grid, T::kThreads, T::kSmem, stream>>>(
      x, x_bf16, static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<const float*>(inv_ptr), static_cast<float*>(out),
      static_cast<__nv_bfloat16*>(out_bf), static_cast<int8_t*>(out_q), B,
      Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, Cin] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1; Cin % 8 == 0), w [3, 3,
// Cin, Cout] bf16, bias [Cout] f32, residual [M, Cout] f32 or null, inv_s
// -> the int8 output's inverse scale (f32 on the device; required with
// out_q, else unread); out [M, Cout] f32, out_bf [M, Cout] bf16 and out_q
// [M, Cout] int8, any of them may be null.  M = B*42;
// Cout a multiple of 64; every pointer 16-byte aligned.  Launches
// ceil(B / boards) x Cout/64 blocks of az_conv3x3_bf16_boards(B, Cout)
// boards each on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int az_conv3x3_bf16(const void* x, const void* w, const void* bias,
                               const void* residual, const void* inv_s,
                               void* out, void* out_bf, void* out_q, int M,
                               int Cin, int Cout, int x_bf16, void* stream) {
  const int B = M / kCells;
  if (M % kCells || Cout % kBN || (x_bf16 && Cin % 8) || (out_q && !inv_s))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return conv_boards(B, Cout) == Large::kBoards
             ? launch<Large>(x, x_bf16, w, bias, residual, inv_s, out,
                             out_bf, out_q, B, Cin, Cout, s)
             : launch<Small>(x, x_bf16, w, bias, residual, inv_s, out,
                             out_bf, out_q, B, Cin, Cout, s);
}

// Boards per block of a launch over B boards and Cout output channels on
// the current card (3 or 12).
extern "C" int az_conv3x3_bf16_boards(int B, int Cout) {
  return conv_boards(B, Cout);
}
