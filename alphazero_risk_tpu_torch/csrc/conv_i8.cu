// K1: int8 3x3 SAME convolution on the 7x6 board with a fused epilogue.
//
// Replaces: alphazero_risk_tpu/models/fast_infer.py, `_conv_i8` (an XLA
// int8 x int8 -> int32 conv) together with the elementwise work around it in
// `_trunk_xla_int8`: dequantize (acc * (s * ws) + b), the residual add, the
// ReLU and the requantization of the next conv's input
// (clip(rint(h * (1/s_next)), -127, 127)).
//
// Bound on an H100: at the flagship shape (B=1024, C=256) one conv is
// 2*1024*42*9*256^2 = 50.7 GOP, 26 us at the dense int8 tensor-core peak;
// the conv_b epilogue moves ~110 MB (int8 in, f32 residual in, f32 and int8
// out), 33 us at 3.35 TB/s.  So the work is about balanced between the
// two at that shape, and this kernel is bound by neither: it runs on the
// CUDA cores (__dp4a), far below the tensor-core rate.
//
// Design: an implicit GEMM (M = B*42 board cells, N = C output channels,
// K = 9 taps * C input channels).  One 256-thread block computes a 64 x 64
// output tile; K advances 64 input channels of one tap at a time through
// shared memory.  The A tile is gathered straight from the NHWC activation
// (zeros outside the board give the SAME padding); the B tile is read from
// the HWIO weight and packed four input channels to a 32-bit word, the
// layout __dp4a consumes.  Each thread accumulates a 4 x 4 sub-tile in
// int32, which is exact (|acc| <= 127*127*9*C).  The epilogue runs on the
// accumulators in registers, so the int32 tensor never reaches device
// memory.  The float epilogue is compiled without FMA contraction
// (--fmad=false) so that it rounds like the plain PyTorch version.
// Moving the product to int8 mma.sync / wgmma is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // board cells per block
constexpr int kBN = 64;       // output channels per block
constexpr int kKW = 16;       // 32-bit words of K per step (64 channels)
constexpr int kThreads = 256;
constexpr int kCells = 42;    // 7 x 6 board

__global__ void __launch_bounds__(kThreads)
conv3x3_i8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                  const float* __restrict__ ws, const float* __restrict__ bias,
                  const float* __restrict__ s_ptr,
                  const float* __restrict__ residual,
                  const float* __restrict__ inv_next_ptr,
                  float* __restrict__ out_h, int8_t* __restrict__ out_q,
                  int32_t* __restrict__ out_acc, int M, int C) {
  __shared__ int As[kKW][kBM + 4];
  __shared__ int Bs[kKW][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += 4 * kKW) {
      // A tile: 64 rows x 16 words; 16 consecutive threads read one row.
#pragma unroll
      for (int r = 0; r < (kBM * kKW) / kThreads; ++r) {
        const int wi = tid + r * kThreads;
        const int row = wi / kKW;
        const int kw = wi % kKW;
        const int p = m0 + row;
        int val = 0;
        if (p < M) {
          const int b = p / kCells;
          const int cell = p % kCells;
          const int y = cell / 6 + dy;
          const int x = cell % 6 + dx;
          if (y >= 0 && y < 7 && x >= 0 && x < 6) {
            val = *reinterpret_cast<const int*>(
                q + (static_cast<int64_t>(b) * kCells + y * 6 + x) * C + c0 +
                kw * 4);
          }
        }
        As[kw][row] = val;
      }
      // B tile: 16 words x 64 output channels, each word the 4 input
      // channels c0+4kw..c0+4kw+3 of one output channel.
#pragma unroll
      for (int r = 0; r < (kKW * kBN) / kThreads; ++r) {
        const int wi = tid + r * kThreads;
        const int kw = wi / kBN;
        const int col = wi % kBN;
        const int8_t* wp =
            w + (static_cast<int64_t>(tap) * C + c0 + kw * 4) * C + n0 + col;
        const uint32_t b0 = static_cast<uint8_t>(wp[0]);
        const uint32_t b1 = static_cast<uint8_t>(wp[C]);
        const uint32_t b2 = static_cast<uint8_t>(wp[2 * C]);
        const uint32_t b3 = static_cast<uint8_t>(wp[3 * C]);
        Bs[kw][col] = static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kKW; ++kw) {
        int a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kw][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[kw][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue, in the order of _trunk_xla_int8:
  //   v = acc * (s * ws) + b; [v = v + x;] v = max(v, 0)
  //   q_next = clip(rint(v * (1 / s_next)), -127, 127)
  const float s = *s_ptr;
  const float inv_next = inv_next_ptr ? *inv_next_ptr : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + ty * 4 + i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      const int64_t o = static_cast<int64_t>(p) * C + co;
      if (out_acc) out_acc[o] = acc[i][j];
      const float sw = s * ws[co];
      float v = static_cast<float>(acc[i][j]) * sw + bias[co];
      if (residual) v = v + residual[o];
      v = fmaxf(v, 0.0f);
      if (out_h) out_h[o] = v;
      if (out_q) {
        float r = rintf(v * inv_next);
        r = fminf(fmaxf(r, -127.0f), 127.0f);
        out_q[o] = static_cast<int8_t>(r);
      }
    }
  }
}

}  // namespace

// q [M, C] int8 (NHWC, M = B*42), w [3, 3, C, C] int8 (HWIO), ws / bias [C]
// f32, s_ptr -> the activation scale of q (f32 on the device).  residual
// [M, C] f32 or null; inv_next_ptr -> 1/s_next or null (required with
// out_q).  Any of out_h [M, C] f32, out_q [M, C] int8, out_acc [M, C] int32
// may be null.  C must be a multiple of 64.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int az_conv3x3_i8(const void* q, const void* w, const void* ws,
                             const void* bias, const void* s_ptr,
                             const void* residual, const void* inv_next_ptr,
                             void* out_h, void* out_q, void* out_acc, int M,
                             int C, void* stream) {
  dim3 grid((M + kBM - 1) / kBM, C / kBN);
  conv3x3_i8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(s_ptr), static_cast<const float*>(residual),
      static_cast<const float*>(inv_next_ptr), static_cast<float*>(out_h),
      static_cast<int8_t*>(out_q), static_cast<int32_t*>(out_acc), M, C);
  return static_cast<int>(cudaGetLastError());
}
