// fused_gcn_dense: out = act(Â @ (X @ W) + b), fp32, batched over graphs.
//
// Replaces the TPU kernel `fused_gcn_dense` (src/repro/kernels/
// fused_layers.py). That kernel fills a full-height H = X @ W strip in VMEM
// only at row-block i == 0 and every later row block reads it, which needs
// the TPU's in-order grid. A CUDA grid runs its blocks in no order, so this
// port splits the layer into two launches inside one call, on one stream:
//
//   1. combine:   H[z] = X[z] @ W      W broadcast (batch stride 0), into a
//                                      scratch the wrapper allocates
//                                      (N x 128 fp32 per graph: 6.3 MB at
//                                      B = 4, N = 3072, so H round-trips
//                                      through the 50 MB L2, not VMEM)
//   2. aggregate: out[z] = act(Â[z] @ H[z] + b), bias and activation fused
//                 into the store (the EPI option).
//
// Both run block_matmul's kernel, 3xTF32 on the TF32 tensor cores
// (tc_gemm_tile.cuh's gemm_3xtf32_kernel): fp32 accuracy, summed in
// another order than the plain version's two cuBLAS products. No block
// depends on another block of the same launch; the stream orders the
// aggregate after the combine.
//
// Bound at the padded serving widths (B = 4, N = 3072, Fin 1536 -> 128,
// then 128 -> 128): four products, 24.6 GFLOP a batch, against 0.40 GB
// of operands read and outputs written once (Â once a layer: 0.12 ms at
// 3.35 TB/s). As three TF32 products each at 495 TFLOP/s that is 0.1489
// ms, operations-bound; on fp32 FMA (67 TFLOP/s) 0.3666 ms.
#include "tc_gemm_tile.cuh"

// adj: (batch, n, n); x: (batch, n, fin); w: (fin, o); bias: (o,);
// h: (batch, n, o) scratch; out: (batch, n, o). All contiguous fp32, on
// CUDA ordinal `device` with `stream`. act: 0 none, 1 relu, 2 elu. Returns
// the first error, else cudaGetLastError() after the second launch.
extern "C" int fused_gcn_dense_f32(const float* adj, const float* x,
                                   const float* w, const float* bias,
                                   float* h, float* out, int batch, int n,
                                   int fin, int o, int act, int device,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = gcn_port::tc::launch_gemm_3xtf32(x, w, h, batch, n, o, fin,
                                         (long long)n * fin, 0LL, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gcn_port::tc::launch_gemm_3xtf32<true>(
      adj, h, out, batch, n, o, n, (long long)n * n, (long long)n * o, s,
      bias, act);
}
