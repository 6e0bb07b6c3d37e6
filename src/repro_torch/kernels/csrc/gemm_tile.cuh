// Shared fp32 SIMT GEMM tile for the port's GCN kernels (sm_90a).
//
//   C[z] = act(A[z] @ B[z] + bias)      z = blockIdx.z, row-major operands
//
// One 256-thread block owns a 64x64 tile of C and walks K in 16-deep slabs
// staged through shared memory; every thread keeps a 4x4 fp32 accumulator
// in registers (full fp32 FMA, no TF32, so results hold the reference's
// fp32 numerics up to summation order). Ragged edges are masked on load
// and store, so any M, N, K works; the wrappers still pad to 128 as the
// reference's `ops._pad2` does. A batch stride of 0 broadcasts an operand
// (the weight matrix of a combine pass). The K walk (`mac_tile`) and the
// epilogue (`store_tile`) are device functions, so the block-sparse walk
// of `bsr_tile.cuh` runs the same slab arithmetic once per block entry.
//
// Bound: at the serving shapes every product here is compute-bound on
// fp32 outside the tensor cores (67 TFLOP/s on an H100 SXM): the
// aggregation Â @ H does 2*N*N*O flops over 4*N*N bytes of Â, i.e. O/2
// flops per byte, far above the card's 20 flops per byte at fp32. This
// first version keeps the simple shared-memory tile; tensor-core (3xTF32
// or wgmma) variants are later work.
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

static __global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ C,
                int M, int N, int K, long long stride_a, long long stride_b,
                long long stride_c, int act) {
  __shared__ TileSmem s;
  A += blockIdx.z * stride_a;
  B += blockIdx.z * stride_b;
  C += blockIdx.z * stride_c;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  mac_tile(A, B, M, N, K, blockIdx.y * kBM, blockIdx.x * kBN, s, acc);
  // epilogue: bias + activation fused into the store
  store_tile(C, bias, M, N, blockIdx.y * kBM, blockIdx.x * kBN, acc, act);
}

// Launch one batched product on `stream`; returns cudaGetLastError().
static inline cudaError_t launch_gemm_f32(
    const float* A, const float* B, const float* bias, float* C, int batch,
    int M, int N, int K, long long stride_a, long long stride_b, int act,
    cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(
      A, B, bias, C, M, N, K, stride_a, stride_b, (long long)M * N, act);
  return cudaGetLastError();
}

}  // namespace gcn_port
