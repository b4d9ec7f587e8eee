// K4: bf16 3x3 SAME convolution on the 7x6 board with a fused epilogue.
//
// Replaces: alphazero_risk_tpu/models/fast_infer.py, `_stem` and
// `_trunk_xla_bf16` (XLA bf16 convs with preferred_element_type=float32 and
// the bias / residual / ReLU elementwise work around them), and the same
// convs inside `calibrate_trunk`.
//
// Computes out = relu(conv(bf16(x), w) + bias [+ residual]) with
//   x        [M, Cin]  f32 NHWC (M = B*42), rounded to bf16 here
//            (round-to-nearest-even, what `.to(torch.bfloat16)` does),
//   w        [3, 3, Cin, Cout] bf16 HWIO, read as stored,
//   bias     [Cout] f32, residual [M, Cout] f32 or null, out [M, Cout] f32.
// Products of two bf16 values are exact in float32, so the result differs
// from any other float32-accumulating conv only by the order of the sums.
//
// Bound on an H100: at the main path's trunk shape (B=64, Cin=Cout=256) one
// conv is 2*2688*2304*256 = 3.17 GFLOP, 3.2 us at the bf16 tensor-core
// peak, and moves 9.4 MB (x, residual, out in f32, w in bf16), 2.8 us at
// 3.35 TB/s: about balanced.  The stem (Cin=13) is bytes-bound, under 1 us.
// This kernel reaches neither: it multiplies on the CUDA cores in float32.
//
// Design: an implicit GEMM (M board cells, N = Cout, K = 9 taps * Cin).  One
// 256-thread block computes a 64 x 64 output tile; K advances 16 input
// channels of one tap at a time through shared memory, with zeros past Cin
// (the stem's 13 channels) and outside the board (SAME padding).  Each
// thread accumulates a 4 x 4 sub-tile in float32 and applies the epilogue to
// it in registers.  Moving the product to wgmma is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // board cells per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 16;       // input channels per step
constexpr int kThreads = 256;
constexpr int kCells = 42;    // 7 x 6 board

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const float* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ residual,
                    float* __restrict__ out, int M, int Cin, int Cout) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      // A tile: 64 cells x 16 channels; 16 consecutive threads read the 16
      // channels of one cell.
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int row = e / kBK;
        const int k = e % kBK;
        const int p = m0 + row;
        const int c = c0 + k;
        float val = 0.0f;
        if (p < M && c < Cin) {
          const int b = p / kCells;
          const int cell = p % kCells;
          const int y = cell / 6 + dy;
          const int xx = cell % 6 + dx;
          if (y >= 0 && y < 7 && xx >= 0 && xx < 6) {
            const float v =
                x[(static_cast<int64_t>(b) * kCells + y * 6 + xx) * Cin + c];
            val = __bfloat162float(__float2bfloat16_rn(v));
          }
        }
        As[k][row] = val;
      }
      // B tile: 16 channels x 64 output channels.
#pragma unroll
      for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int k = e / kBN;
        const int col = e % kBN;
        const int c = c0 + k;
        float val = 0.0f;
        if (c < Cin) {
          val = __bfloat162float(
              w[(static_cast<int64_t>(tap) * Cin + c) * Cout + n0 + col]);
        }
        Bs[k][col] = val;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue, in the order of the plain version:
  //   v = acc + bias; [v = v + residual;] v = max(v, 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + ty * 4 + i;
    if (p >= M) continue;
    const int64_t o = static_cast<int64_t>(p) * Cout + n0 + tx * 4;
    const float4 b4 = *reinterpret_cast<const float4*>(bias + n0 + tx * 4);
    float v[4] = {acc[i][0] + b4.x, acc[i][1] + b4.y, acc[i][2] + b4.z,
                  acc[i][3] + b4.w};
    if (residual) {
      const float4 r4 = *reinterpret_cast<const float4*>(residual + o);
      v[0] += r4.x;
      v[1] += r4.y;
      v[2] += r4.z;
      v[3] += r4.w;
    }
    float4 o4;
    o4.x = fmaxf(v[0], 0.0f);
    o4.y = fmaxf(v[1], 0.0f);
    o4.z = fmaxf(v[2], 0.0f);
    o4.w = fmaxf(v[3], 0.0f);
    *reinterpret_cast<float4*>(out + o) = o4;
  }
}

}  // namespace

// x [M, Cin] f32, w [3, 3, Cin, Cout] bf16, bias [Cout] f32, residual
// [M, Cout] f32 or null, out [M, Cout] f32.  Cout must be a multiple of 64;
// Cin is free.  Launches on `stream` and returns cudaGetLastError().
extern "C" int az_conv3x3_bf16(const void* x, const void* w, const void* bias,
                               const void* residual, void* out, int M,
                               int Cin, int Cout, void* stream) {
  dim3 grid((M + kBM - 1) / kBM, Cout / kBN);
  conv3x3_bf16_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<float*>(out), M, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
