// gat_attention: the fused GAT attention of one layer, fp32, batched over
// graphs (blockIdx.z): per head, softmax over the masked, leaky-ReLU'd
// broadcast sum of the alpha terms, times H. No epilogue.
//
// Replaces the TPU kernel `gat_attention` (src/repro/kernels/
// gat_attention.py:42), which holds a (bm, n) score strip per head in VMEM
// and, under its (head, row block) grid, reads the bias strip once per
// head. Here the attention body of gat_tile.cuh walks the columns with an
// online softmax, runs P.H on the TF32 tensor cores (3xTF32, mma.sync)
// and reads the bias once for up to 8 heads through a cp.async ring.
//
// Bound, per 4-graph batch at n = 3072 (H100 SXM: 3.35 TB/s HBM, 495
// TFLOP/s TF32, about 4.2e12 expf a second on the SFUs: 132 SMs x 16 a
// clock x 1.98 GHz):
//   bias bytes     B*n*n*4, read once           151 MB   45 us
//   expf           H*B*n*n                      302 M    72 us (H = 8)
//   product flops  3 x 2*H*B*n*n*F on TF32      14.5 G   29 us (F = 8)
// so layer 1 (8 heads of 8) is bound by its expf and layer 2 (1 head of 7:
// 38 M expf) by its bias bytes. The design and what it does about each
// bound is in gat_tile.cuh.
#include "gat_tile.cuh"

// h: (batch, n, heads, f); alpha_dst, alpha_src: (batch, n, heads); bias:
// (batch, n, n); out: (batch, n, heads, f). All contiguous fp32, on CUDA
// ordinal `device` with `stream`. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for f > 64.
extern "C" int gat_attention_f32(const float* h, const float* alpha_dst,
                                 const float* alpha_src, const float* bias,
                                 float* out, int batch, int n, int heads,
                                 int f, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)gcn_port::gat::launch_attention(
      h, alpha_dst, alpha_src, bias, nullptr, out, batch, n, heads, f,
      gcn_port::kActNone, (cudaStream_t)stream);
}
