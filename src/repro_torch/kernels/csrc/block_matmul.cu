// block_matmul: C = A @ B with fp32 accumulation, batched over blockIdx.z.
//
// Replaces the TPU kernel `block_matmul` (src/repro/kernels/block_matmul.py,
// the 128^3-blocked MXU matmul behind `ops.matmul`, the StaGr aggregation
// backbone). The TPU grid carried the K reduction in a VMEM accumulator
// across sequential grid steps; here each block loops over K itself with
// the sum in registers, so blocks run in any order (gemm_tile.cuh).
//
// Bound at the serving shapes (B = 4 graphs, N = 3072): the aggregation
// Â @ H reads 4*N*N bytes of Â per graph (37.7 MB, 11 us at 3.35 TB/s) but
// does 2*N*N*128 flops (2.4 GFLOP, 36 us at the 67 TFLOP/s fp32 peak), so
// it is compute-bound; so is the combine X @ W.
#include "gemm_tile.cuh"

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
  return (int)gcn_port::launch_gemm_f32(
      a, b, nullptr, c, batch, m, n, k, (long long)stride_a,
      (long long)stride_b, gcn_port::kActNone, (cudaStream_t)stream);
}
