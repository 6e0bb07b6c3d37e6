// fused_gcn_dense: out = act(Â @ (X @ W) + b), fp32, batched over graphs.
//
// Replaces the TPU kernel `fused_gcn_dense` (src/repro/kernels/
// fused_layers.py). That kernel fills a full-height H = X @ W strip in VMEM
// only at row-block i == 0 and every later row block reads it, which needs
// the TPU's in-order grid. A CUDA grid runs its blocks in no order, so this
// port splits the layer into two launches inside one call, on one stream:
//
//   1. combine:   H[z] = X[z] @ W      into a scratch tensor the wrapper
//                                      allocates (N x 128 fp32 per graph:
//                                      1.5 MB at N = 3072, so H round-trips
//                                      through the 50 MB L2, not VMEM)
//   2. aggregate: out[z] = act(Â[z] @ H[z] + b), bias and activation fused
//                 into the store (gemm_tile.cuh epilogue).
//
// No block depends on another block of the same launch; the stream orders
// the aggregate after the combine.
//
// Bound: the memory floor is Â's bytes (4*N*N per graph, 37.7 MB at
// N = 3072: 11 us at 3.35 TB/s). At the padded serving widths the fp32
// flops are the larger floor: 2*N*N*128 + 2*N*1536*128 per graph for
// layer 1 (3.6 GFLOP, 54 us at the 67 TFLOP/s fp32 peak), so this fp32
// SIMT version is compute-bound.
#include "gemm_tile.cuh"

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
  err = gcn_port::launch_gemm_f32(
      x, w, nullptr, h, batch, n, o, fin, (long long)n * fin, 0LL,
      gcn_port::kActNone, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gcn_port::launch_gemm_f32(
      adj, h, bias, out, batch, n, o, n, (long long)n * n,
      (long long)n * o, act, s);
}
