// fused_gat_full: the whole fp32 GAT layer, batched over graphs:
// H = X @ W, alpha_src/dst = H . a_src/dst per head, then act(attention +
// b).
//
// Replaces the TPU kernel `fused_gat_full` (src/repro/kernels/
// fused_layers.py). That kernel fills its H, alpha_src and alpha_dst VMEM
// scratch only at row block i == 0 and every later row block reads them:
// the TPU's in-order grid. A CUDA grid runs its blocks in no order, so, as
// fused_gcn_dense does, this port runs two launches inside one call, on
// one stream:
//
//   1. combine: H[z] = X[z] @ W on gemm_tile.cuh's 64x64 fp32 tile, with W
//               read as (fin, heads*f); each block's columns are whole
//               heads (64 / f of them), so its store also reduces
//               alpha_src and alpha_dst per head over f from the tile in
//               shared memory. H and the alpha terms go to scratch the
//               wrapper allocates (n*heads*(f+2) floats per graph: 0.8 MB
//               at n = 3072, 8 heads of 8, so L2 resident).
//   2. attend:  the attention body of gat_tile.cuh with + b[head] and the
//               activation (activation.cuh; ELU as expm1f) in its store.
//
// Bound, per 4-graph batch at n = 3072: the attention as gat_attention's
// (layer 1: 302 M expf and 4.8 GFLOP, about 72 us; layer 2: 151 MB of
// bias, 45 us) plus the combine's 2*B*n*fin*heads*f flops (layer 1: fin =
// 1433, 64 columns: 2.3 GFLOP, 34 us at the 67 TFLOP/s fp32 rate).
#include "gat_tile.cuh"
#include "gemm_tile.cuh"

namespace gcn_port {
namespace gat {

// x: (batch, n, fin); w: (fin, heads*f); a_src, a_dst: (heads, f); h:
// (batch, n, heads*f); alpha_src, alpha_dst: (batch, n, heads). Grid
// (ceil(heads / (64 / f)), ceil(n / 64), batch).
static __global__ void __launch_bounds__(gcn_port::kThreads)
combine_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ a_src,
               const float* __restrict__ a_dst, float* __restrict__ h,
               float* __restrict__ alpha_src, float* __restrict__ alpha_dst,
               int n, int fin, int heads, int f) {
  __shared__ TileSmem ts;
  __shared__ float tile[kBM][kBN + 1];
  const int hf = heads * f;
  const int hpt = kBN / f;                     // whole heads per block
  const int head0 = blockIdx.x * hpt;
  const int nh = min(hpt, heads - head0);
  const int col0 = head0 * f, width = nh * f;
  const int row0 = blockIdx.y * kBM;
  const int z = blockIdx.z;
  x += (long long)z * n * fin;
  h += (long long)z * n * hf;
  alpha_src += (long long)z * n * heads;
  alpha_dst += (long long)z * n * heads;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  mac_tile(x, w, n, hf, fin, row0, col0, ts, acc);

  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int rl = ty * kTM + i, r = row0 + rl;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int cl = tx * kTN + j;
      tile[rl][cl] = acc[i][j];
      if (r < n && cl < width) h[(long long)r * hf + col0 + cl] = acc[i][j];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kBM * nh; p += kThreads) {
    const int rl = p / nh, k = p % nh, r = row0 + rl;
    if (r >= n) continue;
    const float* as_v = a_src + (head0 + k) * f;
    const float* ad_v = a_dst + (head0 + k) * f;
    float ss = 0.f, sd = 0.f;
    for (int q = 0; q < f; ++q) {
      const float v = tile[rl][k * f + q];
      ss = fmaf(v, as_v[q], ss);
      sd = fmaf(v, ad_v[q], sd);
    }
    alpha_src[(long long)r * heads + head0 + k] = ss;
    alpha_dst[(long long)r * heads + head0 + k] = sd;
  }
}

}  // namespace gat
}  // namespace gcn_port

// x: (batch, n, fin); w: (fin, heads, f); a_src, a_dst, b: (heads, f);
// bias: (batch, n, n); h: (batch, n, heads, f), alpha_src, alpha_dst:
// (batch, n, heads) scratch; out: (batch, n, heads, f). All contiguous
// fp32, on CUDA ordinal `device` with `stream`. act: 0 none, 1 relu, 2 elu.
// Returns the first error, else cudaGetLastError() after the second
// launch; cudaErrorInvalidValue for f > 64.
extern "C" int fused_gat_full_f32(const float* x, const float* w,
                                  const float* a_src, const float* a_dst,
                                  const float* bias, const float* b,
                                  float* h, float* alpha_src,
                                  float* alpha_dst, float* out, int batch,
                                  int n, int fin, int heads, int f, int act,
                                  int device, void* stream) {
  using namespace gcn_port;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f < 1 || f > gat::kMaxF || heads < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int hpt = kBN / f;
  const dim3 grid((heads + hpt - 1) / hpt, (n + kBM - 1) / kBM, batch);
  gat::combine_kernel<<<grid, kThreads, 0, s>>>(
      x, w, a_src, a_dst, h, alpha_src, alpha_dst, n, fin, heads, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gat::launch_attention(h, alpha_dst, alpha_src, bias, b, out,
                                    batch, n, heads, f, act, s);
}
