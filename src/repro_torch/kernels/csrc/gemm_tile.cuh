// Shared fp32 SIMT GEMM tile of the port's block-sparse walk (sm_90a),
// the one user being bsr_tile.cuh (`bitmap_spmm` and the aggregate of
// `fused_gcn_grasp`):
//
//   acc += A @ B over one 64 x 64 tile of C, then C = act(acc + bias)
//
// A 256-thread block owns a 64x64 tile of C and walks K in 16-deep slabs
// staged through shared memory; every thread keeps a 4x4 fp32 accumulator
// in registers (full fp32 FMA, no TF32, so results hold the reference's
// fp32 numerics up to summation order). Ragged edges are masked on load
// and store, so any M, N, K works. The K walk (`mac_tile`) and the
// epilogue (`store_tile`) are device functions, so the block-sparse walk
// runs the same slab arithmetic once per block entry and one store at
// the end.
//
// Bound: a 128 x 128 block of Â times 128 rows of H does F/2 flops per
// byte of Â, far above the card's 20 flops per byte at fp32 for F >= 128,
// so at the serving widths the tile is compute-bound on fp32 outside the
// tensor cores (67 TFLOP/s on an H100 SXM). The dense products of the
// port's GCN layers run on the 3xTF32 tile (tc_gemm_tile.cuh) instead.
#pragma once

#include <cuda_runtime.h>

#include "activation.cuh"

namespace gcn_port {

constexpr int kBM = 64;                           // tile rows of C
constexpr int kBN = 64;                           // tile cols of C
constexpr int kBK = 16;                           // K slab per stage
constexpr int kTM = 4;                            // rows per thread
constexpr int kTN = 4;                            // cols per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kApad = 4;                          // As row pad: keeps float4
                                                  // reads aligned, cuts the
                                                  // transposed-store conflicts

// The tile's shared-memory staging: one K slab of A (K-major) and of B.
struct TileSmem {
  __align__(16) float As[kBK][kBM + kApad];
  __align__(16) float Bs[kBK][kBN];
};

// acc += A[row0:row0+64, 0:K] @ B[0:K, col0:col0+64] for row-major A (M x K)
// and B (K x N), walking K in 16-deep slabs; out-of-range rows, columns and
// K are read as 0. Every thread of the block calls it (it synchronises).
__device__ __forceinline__ void mac_tile(const float* __restrict__ A,
                                         const float* __restrict__ B, int M,
                                         int N, int K, int row0, int col0,
                                         TileSmem& s,
                                         float (&acc)[kTM][kTN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A slab: 64 rows x 16 cols, read along rows, stored transposed so the
    // inner loop reads 4 consecutive rows of one k as one float4
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gc = k0 + c;
      s.As[c][r] = (gr < M && gc < K) ? A[(long long)gr * K + gc] : 0.f;
    }
    // B slab: 16 rows x 64 cols, coalesced along N
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int gr = k0 + r, gc = col0 + c;
      s.Bs[r][c] = (gr < K && gc < N) ? B[(long long)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s.As[k][ty * kTM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s.Bs[k][tx * kTN]);
      const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// C[row0:row0+64, col0:col0+64] = act(acc + bias) for row-major C (M x N),
// bias (N,) or null; out-of-range rows and columns are not written.
__device__ __forceinline__ void store_tile(float* __restrict__ C,
                                           const float* __restrict__ bias,
                                           int M, int N, int row0, int col0,
                                           const float (&acc)[kTM][kTN],
                                           int act) {
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c >= N) continue;
      const float z = acc[i][j] + (bias != nullptr ? bias[c] : 0.f);
      C[(long long)r * N + c] = apply_activation(z, act);
    }
  }
}

}  // namespace gcn_port
