// block_matmul: C = A @ B with fp32 accuracy, batched over blockIdx.z.
//
// Replaces the TPU kernel `block_matmul` (src/repro/kernels/block_matmul.py,
// the 128^3-blocked MXU matmul behind `ops.matmul`, the StaGr aggregation
// backbone; pallas_call at :49). The TPU grid carried the K reduction in a
// VMEM accumulator across sequential grid steps; here each block loops
// over K itself with the sum in registers, so blocks run in any order.
//
// The product runs on the TF32 tensor cores as 3xTF32 (tc_gemm_tile.cuh):
// three TF32 products per fp32 product keep fp32 accuracy. It sums in
// another order than cuBLAS's fp32 kernel and no longer equals it bit for
// bit.
//
// Bound at the serving shapes (B = 4 graphs, N = 3072): the aggregation
// Â @ H reads 4*N*N bytes of Â per graph (37.7 MB, 11 us at 3.35 TB/s) and
// does 2*N*N*128 flops, three times over on the tensor cores (7.2 GFLOP of
// TF32, 15 us at 495 TFLOP/s), so it is compute-bound; so is the combine
// X @ W.
#include "tc_gemm_tile.cuh"

namespace gcn_port {
namespace tc {

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemm_3xtf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K,
                       long long stride_a, long long stride_b) {
  A += blockIdx.z * stride_a;
  B += blockIdx.z * stride_b;
  C += blockIdx.z * (long long)M * N;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[kMT][kNT][4] = {};
  mma_tile<VEC, VEC>(A, B, M, N, K, K, row0, col0, acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / kWN) * (kBM / kWM);
  const int wn = (warp % kWN) * (kBN / kWN);
  const int g = lane / 4, t = lane % 4;

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        if (c < N) C[(long long)r * N + c] = acc[i][j][2 * h];
        if (c + 1 < N) C[(long long)r * N + c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// Launch one batched product on `stream`; returns cudaGetLastError().
// 16-byte copies of both operands where both allow them.
static inline cudaError_t launch_gemm_3xtf32(const float* A, const float* B,
                                             float* C, int batch, int M, int N,
                                             int K, long long stride_a,
                                             long long stride_b,
                                             cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  return copies16(A, K) && copies16(B, N)
             ? launch_ring<&gemm_3xtf32_kernel<true>>(
                   grid, stream, A, B, C, M, N, K, stride_a, stride_b)
             : launch_ring<&gemm_3xtf32_kernel<false>>(
                   grid, stream, A, B, C, M, N, K, stride_a, stride_b);
}

}  // namespace tc
}  // namespace gcn_port

// a: (batch, m, k) with batch stride `stride_a` elements (0 = broadcast),
// b: (batch, k, n) with batch stride `stride_b` (0 = broadcast),
// c: (batch, m, n) contiguous; `device` is the CUDA ordinal the operands
// and `stream` live on. Returns cudaGetLastError() after the launch.
extern "C" int block_matmul_f32(const float* a, const float* b, float* c,
                                int batch, int m, int n, int k,
                                int stride_a, int stride_b, int device,
                                void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)gcn_port::tc::launch_gemm_3xtf32(
      a, b, c, batch, m, n, k, (long long)stride_a, (long long)stride_b,
      (cudaStream_t)stream);
}
