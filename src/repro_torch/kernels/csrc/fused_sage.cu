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
//                 into an N x ldg scratch tensor the wrapper allocates,
//                 ldg = Fin rounded up to 4 (70 MB per 4 x 3072 batch at
//                 Fin = 1433: past L2); the walk writes Fin columns a row;
//   2. combine:   out[z] = act(X[z] @ W_self + AGG[z] @ W_neigh + b) on
//                 the 3xTF32 tensor-core tile of tc_gemm_tile.cuh: two
//                 K loops of `mma_tile` into one accumulator, bias and
//                 activation in the store. X at Fin = 1433 streams by
//                 4-byte copies (its rows are not 16-byte aligned), AGG
//                 by 16-byte copies (its rows are); the pad columns of
//                 AGG are never read.
//
// The mean aggregation is a walk too, not the dense tile: M has the same
// <= max_neighbors + 1 entries per row as the sample mask, and a dense
// M @ X at 1536 wide is 1.16e11 flop per batch (about 1.7 ms at the
// 67 TFLOP/s fp32 peak), where the walk reads M once.
//
// Bound per 4 x 3072 batch at layer 1: the mask (151 MB) and the features
// (X, and the pooled features for max) read once, 0.067-0.088 ms at
// 3.35 TB/s; the combine's 4.5e9 flop take 0.027 ms as three TF32
// products at 495 TFLOP/s (0.067 ms on fp32 FMA). At O = 64 one 64 x 64
// block spans the output width: 48 x 4 = 192 blocks of 128 threads on
// 132 SMs, at most two an SM (the combine takes about 230 registers a
// thread), so 60 SMs run two blocks and 72 one.
//
// Compile-time switches exist only to time the parts (the `[breakdown]`
// step of chip_smoke.py builds the other settings under build/); the
// library ships the defaults. SAGE_WALK 0 and SAGE_COMBINE 0 leave out
// that launch; SAGE_SELF_LOOP 0 and SAGE_NEIGH_LOOP 0 leave out the X or
// the AGG K loop of the combine; SAGE_SPLIT 1 runs the two K loops in
// blocks of their own (twice the grid), each storing its own product: the
// time of a split-K without its reduction.
#ifndef SAGE_WALK
#define SAGE_WALK 1
#endif
#ifndef SAGE_COMBINE
#define SAGE_COMBINE 1
#endif
#ifndef SAGE_SELF_LOOP
#define SAGE_SELF_LOOP 1
#endif
#ifndef SAGE_NEIGH_LOOP
#define SAGE_NEIGH_LOOP 1
#endif
#ifndef SAGE_SPLIT
#define SAGE_SPLIT 0
#endif

#include "activation.cuh"
#include "sage_walk.cuh"
#include "tc_gemm_tile.cuh"

namespace gcn_port {
namespace sage {

// x: (batch, n, fin); agg: (batch, n, ldg); w_self, w_neigh: (fin, o);
// bias: (o,); out: (batch, n, o). Grid (ceil(o / 64), ceil(n / 64),
// batch), tc::kSmemBytes of dynamic shared memory. VX: 16-byte copies of
// x; VW: of both weights. AGG always takes 16-byte copies, the last of a
// row reading only the columns before fin.
template <bool VX, bool VW>
__global__ void __launch_bounds__(tc::kThreads)
combine_kernel(const float* __restrict__ x, const float* __restrict__ agg,
               const float* __restrict__ w_self,
               const float* __restrict__ w_neigh,
               const float* __restrict__ bias, float* __restrict__ out,
               int n, int fin, int ldg, int o, int act) {
#if SAGE_SPLIT
  const long long z = blockIdx.z / 2;
  const bool self = blockIdx.z % 2 == 0, neigh = !self;
#else
  const long long z = blockIdx.z;
  const bool self = SAGE_SELF_LOOP, neigh = SAGE_NEIGH_LOOP;
#endif
  x += z * n * fin;
  agg += z * n * ldg;
  out += z * n * o;
  const int row0 = blockIdx.y * tc::kBM, col0 = blockIdx.x * tc::kBN;
  float acc[tc::kMT][tc::kNT][4] = {};
  if (self)
    tc::mma_tile<VX, VW>(x, w_self, n, o, fin, fin, row0, col0, acc);
  __syncthreads();                        // the ring is staged anew
  if (neigh)
    tc::mma_tile<true, VW, true>(agg, w_neigh, n, o, fin, ldg, row0, col0,
                                 acc);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / tc::kWN) * (tc::kBM / tc::kWM);
  const int wn = (warp % tc::kWN) * (tc::kBN / tc::kWN);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < tc::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + 16 * i + g + 8 * h;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < tc::kNT; ++j)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int c = col0 + wn + 8 * j + 2 * t + c2;
          if (c < o)
            out[(long long)r * o + c] =
                apply_activation(acc[i][j][2 * h + c2] + bias[c], act);
        }
    }
}

// Launch the combine on `stream`; returns cudaGetLastError(). 16-byte
// copies of X where its rows allow them, and of the weights where theirs
// do.
static inline cudaError_t launch_combine(const float* x, const float* agg,
                                         const float* w_self,
                                         const float* w_neigh,
                                         const float* bias, float* out,
                                         int batch, int n, int fin, int ldg,
                                         int o, int act,
                                         cudaStream_t stream) {
  const dim3 grid((o + tc::kBN - 1) / tc::kBN, (n + tc::kBM - 1) / tc::kBM,
                  batch * (SAGE_SPLIT ? 2 : 1));
  const bool vx = tc::copies16(x, fin);
  const bool vw = tc::copies16(w_self, o) && tc::copies16(w_neigh, o);
#define SAGE_COMBINE_RING(VX, VW)                                        \
  tc::launch_ring<&combine_kernel<VX, VW>>(grid, stream, x, agg, w_self, \
                                           w_neigh, bias, out, n, fin,   \
                                           ldg, o, act)
  return vx ? (vw ? SAGE_COMBINE_RING(true, true)
                  : SAGE_COMBINE_RING(true, false))
            : (vw ? SAGE_COMBINE_RING(false, true)
                  : SAGE_COMBINE_RING(false, false));
#undef SAGE_COMBINE_RING
}

}  // namespace sage
}  // namespace gcn_port

// mask: (batch, n, n); xk, x: (batch, n, fin); w_self, w_neigh: (fin, o);
// bias: (o,); agg: (batch, n, ldg) scratch, ldg >= fin a multiple of 4,
// 16-byte aligned; out: (batch, n, o). All contiguous fp32, on CUDA
// ordinal `device` with `stream`. is_max: 0 mean, 1 max. act: 0 none,
// 1 relu, 2 elu. Returns the first error, else cudaGetLastError() after
// the second launch; cudaErrorInvalidValue for a scratch it cannot take.
extern "C" int fused_sage_f32(const float* mask, const float* xk,
                              const float* x, const float* w_self,
                              const float* w_neigh, const float* bias,
                              float* agg, float* out, int batch, int n,
                              int fin, int ldg, int o, int is_max, int act,
                              int device, void* stream) {
  using namespace gcn_port;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ldg < fin || !tc::copies16(agg, ldg)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#if SAGE_WALK
  err = sage::launch_walk(mask, xk, agg, batch, n, n, fin, ldg, is_max != 0,
                          s);
  if (err != cudaSuccess) return (int)err;
#endif
#if SAGE_COMBINE
  err = sage::launch_combine(x, agg, w_self, w_neigh, bias, out, batch, n,
                             fin, ldg, o, act, s);
#endif
  return (int)err;
}
