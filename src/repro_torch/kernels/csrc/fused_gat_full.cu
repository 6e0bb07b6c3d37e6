// fused_gat_full: the whole fp32 GAT layer, batched over graphs:
// H = X @ W, alpha_src/dst = H . a_src/dst per head, then act(attention +
// b).
//
// Replaces the TPU kernel `fused_gat_full` (src/repro/kernels/
// fused_layers.py:334). That kernel fills its H, alpha_src and alpha_dst
// VMEM scratch only at row block i == 0 and every later row block reads
// them: the TPU's in-order grid. A CUDA grid runs its blocks in no order,
// so, as fused_gcn_dense does, this port runs two launches inside one
// call, on one stream:
//
//   1. combine: H[z] = X[z] @ W on tc_gemm_tile.cuh's 3xTF32 tile (the
//               main loop `mma_tile` that block_matmul runs), with W read
//               as (fin, heads*f); each block's columns are whole heads
//               (64 / f of them), so its store also reduces alpha_src and
//               alpha_dst per head over f from the tile in shared memory.
//               H and the alpha terms go to scratch the wrapper allocates
//               (n*heads*(f+2) floats per graph: 0.8 MB at n = 3072, 8
//               heads of 8, so L2 resident).
//   2. attend:  the tensor-core attention body of gat_tile.cuh with
//               + b[head] and the activation (activation.cuh; ELU as
//               expm1f) in its store.
//
// Bound, per 4-graph batch at n = 3072: the attention as gat_attention's
// (layer 1: 302 M expf, 72 us; layer 2: 151 MB of bias, 45 us) plus the
// combine's 2*B*n*fin*heads*f flops (layer 1: fin = 1433, 64 columns: 2.3
// GFLOP, 14 us as three TF32 products at 495 TFLOP/s, 34 us on fp32 FMA).
#include "gat_tile.cuh"

namespace gcn_port {
namespace gat {

// x: (batch, n, fin); w: (fin, heads*f); a_src, a_dst: (heads, f); h:
// (batch, n, heads*f); alpha_src, alpha_dst: (batch, n, heads). Grid
// (ceil(heads / (64 / f)), ceil(n / 64), batch), tc::kSmemBytes of
// dynamic shared memory. VX, VW: 16-byte copies of x and of w.
template <bool VX, bool VW>
__global__ void __launch_bounds__(tc::kThreads)
combine_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ a_src,
               const float* __restrict__ a_dst, float* __restrict__ h,
               float* __restrict__ alpha_src, float* __restrict__ alpha_dst,
               int n, int fin, int heads, int f) {
  extern __shared__ __align__(16) float smem[];
  const int hf = heads * f;
  const int hpt = tc::kBN / f;                 // whole heads per block
  const int head0 = blockIdx.x * hpt;
  const int nh = min(hpt, heads - head0);
  const int col0 = head0 * f, width = nh * f;
  const int row0 = blockIdx.y * tc::kBM;
  const int z = blockIdx.z;
  x += (long long)z * n * fin;
  h += (long long)z * n * hf;
  alpha_src += (long long)z * n * heads;
  alpha_dst += (long long)z * n * heads;

  float acc[tc::kMT][tc::kNT][4] = {};
  tc::mma_tile<VX, VW>(x, w, n, hf, fin, fin, row0, col0, acc);
  __syncthreads();                             // the ring becomes the tile

  float (*tile)[tc::kBN + 1] =
      reinterpret_cast<float (*)[tc::kBN + 1]>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / tc::kWN) * (tc::kBM / tc::kWM);
  const int wn = (warp % tc::kWN) * (tc::kBN / tc::kWN);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < tc::kMT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = wm + 16 * i + 8 * hh + g, r = row0 + rl;
#pragma unroll
      for (int j = 0; j < tc::kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cl = wn + 8 * j + 2 * t + c;
          const float v = acc[i][j][2 * hh + c];
          tile[rl][cl] = v;
          if (r < n && cl < width) h[(long long)r * hf + col0 + cl] = v;
        }
    }
  __syncthreads();
  for (int p = threadIdx.x; p < tc::kBM * nh; p += tc::kThreads) {
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

// Launch the combine on `stream`; returns cudaGetLastError(). 16-byte
// copies of X where its rows allow them, and of W where its rows and each
// block's first column (64 / f * f) do.
static inline cudaError_t launch_combine(const float* x, const float* w,
                                         const float* a_src,
                                         const float* a_dst, float* h,
                                         float* alpha_src, float* alpha_dst,
                                         int batch, int n, int fin, int heads,
                                         int f, cudaStream_t stream) {
  const int hpt = tc::kBN / f;
  const dim3 grid((heads + hpt - 1) / hpt, (n + tc::kBM - 1) / tc::kBM,
                  batch);
  const bool vx = tc::copies16(x, fin);
  const bool vw = tc::copies16(w, heads * f) && hpt * f % 4 == 0;
#define GAT_COMBINE(VX, VW)                                                 \
  tc::launch_ring<&combine_kernel<VX, VW>>(grid, stream, x, w, a_src, a_dst,\
                                           h, alpha_src, alpha_dst, n, fin, \
                                           heads, f)
  return vx ? (vw ? GAT_COMBINE(true, true) : GAT_COMBINE(true, false))
            : (vw ? GAT_COMBINE(false, true) : GAT_COMBINE(false, false));
#undef GAT_COMBINE
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
  err = gat::launch_combine(x, w, a_src, a_dst, h, alpha_src, alpha_dst,
                            batch, n, fin, heads, f, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gat::launch_attention(h, alpha_dst, alpha_src, bias, b, out,
                                    batch, n, heads, f, act, s);
}
