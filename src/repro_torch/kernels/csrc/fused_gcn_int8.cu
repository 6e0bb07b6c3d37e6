// fused_gcn_int8: the QuantGr GCN layer, batched over graphs:
//
//   Hq  = q(float(q(X, x_scale) @ Wq) * sw, h_scale)        (s8)
//   out = act(float(Aq @ Hq) * (a_scale[row] * h_scale) + b)  (f32)
//
// with q(v, s) = clamp(rint(v / s), -127, 127) and sw = x_scale * w_scale.
//
// Replaces the TPU kernel `fused_gcn_int8` (src/repro/kernels/
// fused_layers.py). That kernel fills a full-height int8 Hq strip in VMEM
// only at row-block i == 0 and every later row block reads it, which needs
// the TPU's in-order grid. A CUDA grid runs its blocks in no order, so this
// port splits the layer into two launches inside one call, on one stream,
// as fused_gcn_dense does:
//
//   1. combine:   Hq[z] from X[z] and Wq — X quantized on load, the s8
//                 dot, dequantized by sw and re-quantized by h_scale in the
//                 store, into an int8 scratch the wrapper allocates. The
//                 store writes it K-major for the aggregate, (O, ldk) per
//                 graph with ldk = n rounded up to 16 (1.5 MB at B = 4,
//                 N = 3072, so Hq round-trips through the 50 MB L2, not
//                 VMEM);
//   2. aggregate: out[z] = act(Aq[z] @ Hq[z] ...) with the per-row dequant,
//                 bias and activation fused into the store; both operands
//                 stream into shared memory by 16-byte cp.async copies.
//
// No block depends on another block of the same launch; the stream orders
// the aggregate after the combine. The scales stay in device memory, so
// the call never waits on the host.
//
// Bound at the serving shapes: bytes. Layer 1 reads 75.5 MB of fp32 X plus
// the 37.7 MB Aq (about 35.8 us at 3.35 TB/s), layer 2 about 15.0 us. Both
// launches run the s8 tensor-core tile (igemm_tile.cuh), one block across
// the whole 128-wide output, so X and Aq are read once.
#include "igemm_tile.cuh"

// x: (batch, n, fin) f32; wq: (fin, o) s8; sw: (o,) f32; x_scale, h_scale:
// one f32 each; aq: (batch, n, n) s8; a_scale: (batch, n) f32; bias: (o,);
// hq: (batch, o, ldk) s8 scratch, ldk a multiple of 16 and >= n; out:
// (batch, n, o) f32. All contiguous, on
// CUDA ordinal `device` with `stream`. act: 0 none, 1 relu, 2 elu. Returns
// the first error, else cudaGetLastError() after the second launch.
extern "C" int fused_gcn_int8_f32(const float* x, const int8_t* wq,
                                  const float* sw, const float* x_scale,
                                  const float* h_scale, const int8_t* aq,
                                  const float* a_scale, const float* bias,
                                  int8_t* hq, float* out, int batch, int n,
                                  int fin, int o, int ldk, int act,
                                  int device, void* stream) {
  using namespace gcn_port::i8;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const EpilogueArgs combine{sw, nullptr, x_scale, h_scale,
                             gcn_port::kActNone, ldk};
  err = launch_igemm<kBRowMajor, kEpiRequant>(x, wq, 0, hq, batch, n, o, fin,
                                              (long long)n * fin, 0LL,
                                              combine, s);
  if (err != cudaSuccess) return (int)err;
  const EpilogueArgs aggregate{bias, a_scale, nullptr, h_scale, act, 0};
  return (int)launch_igemm<kBKMajor, kEpiAggregate>(
      aq, hq, ldk, out, batch, n, o, n, (long long)n * n, (long long)o * ldk,
      aggregate, s);
}
