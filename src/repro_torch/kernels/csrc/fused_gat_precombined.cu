// fused_gat_precombined: act(attention(h, alpha) + b), fp32, batched over
// graphs, for the QuantGr GAT tiers: h comes from the int8 combine outside
// (int8_matmul on the card), alpha from the einsum beside it.
//
// Replaces the TPU kernel `fused_gat_precombined` (src/repro/kernels/
// fused_layers.py:394): the `gat_attention` grid with the bias and
// activation folded into its store. Here it is the tensor-core attention
// body of gat_tile.cuh with the same epilogue (activation.cuh; ELU as
// expm1f), so the bias is read once for up to 8 heads instead of once per
// head.
//
// Bound: as gat_attention's (see gat_attention.cu): per 4-graph batch at
// n = 3072, layer 1 (8 heads of 8) by its 302 M expf, 72 us, and layer 2
// (1 head of 7) by its 151 MB of bias, 45 us.
#include "gat_tile.cuh"

// h: (batch, n, heads, f); alpha_dst, alpha_src: (batch, n, heads); bias:
// (batch, n, n); b: (heads, f); out: (batch, n, heads, f). All contiguous
// fp32, on CUDA ordinal `device` with `stream`. act: 0 none, 1 relu, 2 elu.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for f > 64.
extern "C" int fused_gat_precombined_f32(const float* h,
                                         const float* alpha_dst,
                                         const float* alpha_src,
                                         const float* bias, const float* b,
                                         float* out, int batch, int n,
                                         int heads, int f, int act,
                                         int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)gcn_port::gat::launch_attention(
      h, alpha_dst, alpha_src, bias, b, out, batch, n, heads, f, act,
      (cudaStream_t)stream);
}
