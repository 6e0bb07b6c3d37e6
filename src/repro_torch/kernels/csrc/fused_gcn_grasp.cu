// fused_gcn_grasp: out = act(Â @ (X @ W) + b) with Â in the GraSp compacted
// form, fp32, batched over graphs.
//
// Replaces the TPU kernel `fused_gcn_grasp` (src/repro/kernels/
// fused_layers.py). That kernel builds the full-height H = X @ W strip in
// VMEM during the first steps of row block i == 0, and every later row
// block reads it: the TPU's in-order grid. A CUDA grid runs its blocks in
// no order, so, as fused_gcn_dense does, this port runs two launches inside
// one call, on one stream:
//
//   1. combine:   H[z] = X[z] @ W     into a scratch the wrapper allocates
//                                     (n x 128 fp32 per graph: 6.3 MB at
//                                     B = 4, n = 3072, so L2 resident), on
//                                     block_matmul's 3xTF32 kernel
//                                     (tc_gemm_tile.cuh, no epilogue)
//   2. aggregate: the block-sparse walk of bsr_tile.cuh over H[z], each
//                 entry 3xTF32 on the same tile's mma_tile, with bias and
//                 activation fused into the store.
//
// Bound: the combine's flops (2*n*Fin*128 per graph, Fin = 1536 on layer
// 1) outweigh the sparse aggregation's at the serving widths, so the
// layer is operations-bound. For chip_smoke.py's 3072 batch of clustered
// graphs (both layers, real blocks only): 0.0282 ms as three TF32
// products each at 495 TFLOP/s, 0.0695 ms on fp32 FMA at 67 TFLOP/s. Both
// launches run on the TF32 tensor cores.
#include "bsr_tile.cuh"

// blocks/block_cols/counts as bitmap_spmm_f32, for a square Â of n = rb*128
// rows; x: (batch, n, fin); w: (fin, o); bias: (o,); h: (batch, n, o)
// scratch; out: (batch, n, o). act: 0 none, 1 relu, 2 elu. Returns the
// first error, else cudaGetLastError() after the second launch.
extern "C" int fused_gcn_grasp_f32(const float* blocks, const int* block_cols,
                                   const int* counts, const float* x,
                                   const float* w, const float* bias,
                                   float* h, float* out, int batch, int rb,
                                   int max_nnz, int fin, int o, int act,
                                   int device, void* stream) {
  using namespace gcn_port::tc;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = rb * kBlock;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_3xtf32(x, w, h, batch, n, o, fin, (long long)n * fin,
                           0LL, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bsr_spmm<true>(blocks, block_cols, counts, h, bias, out,
                                    batch, rb, max_nnz, n, o, act, s);
}
