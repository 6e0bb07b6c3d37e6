// block_matmul: C = A @ B with fp32 accuracy, batched over blockIdx.z.
//
// Replaces the TPU kernel `block_matmul` (src/repro/kernels/block_matmul.py,
// the 128^3-blocked MXU matmul behind `ops.matmul`, the StaGr aggregation
// backbone; pallas_call at :49). The TPU grid carried the K reduction in a
// VMEM accumulator across sequential grid steps; here each block loops
// over K itself with the sum in registers, so blocks run in any order.
//
// The product runs on the TF32 tensor cores as 3xTF32 (tc_gemm_tile.cuh's
// gemm_3xtf32_kernel, without its epilogue): three TF32 products per fp32
// product keep fp32 accuracy. It sums in another order than cuBLAS's fp32
// kernel and no longer equals it bit for bit.
//
// Bound at the serving shapes (B = 4 graphs, N = 3072): the aggregation
// Â @ H reads 4*N*N bytes of Â per graph (37.7 MB, 11 us at 3.35 TB/s) and
// does 2*N*N*128 flops, three times over on the tensor cores (7.2 GFLOP of
// TF32, 15 us at 495 TFLOP/s), so it is compute-bound; so is the combine
// X @ W.
#include "tc_gemm_tile.cuh"

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
