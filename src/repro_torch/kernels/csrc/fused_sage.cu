// fused_sage: out = act(X @ W_self + AGG @ W_neigh + b), fp32, batched over
// graphs, with AGG the mean aggregation M @ X (M holds 1/deg) or the GrAx3
// masked max of the pooled features.
//
// Replaces the TPU kernel `fused_sage` (src/repro/kernels/fused_layers.py).
// That kernel zeroes a (bm, Fin) aggregation buffer in VMEM at
// (j == 0, k == 0), fills it only while j == 0 and reads it back in the
// store of every output strip j, which needs the TPU's in-order grid; at
// layer 1 the buffer (64 x 1536 x 4 B = 393 KB) would not fit a block's
// 227 KB either. A CUDA grid runs its blocks in no order, so this port
// splits the layer into two launches inside one call, on one stream:
//
//   1. aggregate: AGG[z] = the row walk of sage_walk.cuh over (mask, xk)
//                 into an N x Fin scratch tensor the wrapper allocates
//                 (70 MB per 4 x 3072 batch at Fin = 1433: past L2);
//   2. combine:   out[z] = act(X[z] @ W_self + AGG[z] @ W_neigh + b), two
//                 K loops of gemm_tile.cuh's `mac_tile` into one
//                 accumulator, bias and activation in `store_tile`.
//
// The mean aggregation is a walk too, not the dense tile: M has the same
// <= max_neighbors + 1 entries per row as the sample mask, and a dense
// M @ X at 1536 wide is 1.16e11 flop per batch (about 1.7 ms at the
// 67 TFLOP/s fp32 peak), where the walk reads M once.
//
// Bound per 4 x 3072 batch at layer 1: the mask (151 MB) and the features
// (X, and the pooled features for max) read once, 0.067-0.088 ms at
// 3.35 TB/s; the combine's 4.5e9 flop take 0.067 ms at 67 TFLOP/s.
#include "gemm_tile.cuh"
#include "sage_walk.cuh"

namespace {

__global__ void __launch_bounds__(gcn_port::kThreads)
sage_combine_kernel(const float* __restrict__ x, const float* __restrict__ agg,
                    const float* __restrict__ w_self,
                    const float* __restrict__ w_neigh,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int n, int fin, int o, int act) {
  __shared__ gcn_port::TileSmem s;
  const long long z = blockIdx.z;
  x += z * n * (long long)fin;
  agg += z * n * (long long)fin;
  out += z * n * (long long)o;
  const int row0 = blockIdx.y * gcn_port::kBM;
  const int col0 = blockIdx.x * gcn_port::kBN;
  float acc[gcn_port::kTM][gcn_port::kTN];
#pragma unroll
  for (int i = 0; i < gcn_port::kTM; ++i)
#pragma unroll
    for (int j = 0; j < gcn_port::kTN; ++j) acc[i][j] = 0.f;
  gcn_port::mac_tile(x, w_self, n, o, fin, row0, col0, s, acc);
  gcn_port::mac_tile(agg, w_neigh, n, o, fin, row0, col0, s, acc);
  gcn_port::store_tile(out, bias, n, o, row0, col0, acc, act);
}

}  // namespace

// mask: (batch, n, n); xk, x: (batch, n, fin); w_self, w_neigh: (fin, o);
// bias: (o,); agg: (batch, n, fin) scratch; out: (batch, n, o). All
// contiguous fp32, on CUDA ordinal `device` with `stream`. is_max: 0 mean,
// 1 max. act: 0 none, 1 relu, 2 elu. Returns the first error, else
// cudaGetLastError() after the second launch.
extern "C" int fused_sage_f32(const float* mask, const float* xk,
                              const float* x, const float* w_self,
                              const float* w_neigh, const float* bias,
                              float* agg, float* out, int batch, int n,
                              int fin, int o, int is_max, int act, int device,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = gcn_port::sage::launch_walk(mask, xk, agg, batch, n, fin,
                                    is_max != 0, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((o + gcn_port::kBN - 1) / gcn_port::kBN,
                  (n + gcn_port::kBM - 1) / gcn_port::kBM, batch);
  sage_combine_kernel<<<grid, gcn_port::kThreads, 0, s>>>(
      x, agg, w_self, w_neigh, bias, out, n, fin, o, act);
  return (int)cudaGetLastError();
}
