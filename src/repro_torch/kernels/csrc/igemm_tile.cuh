// Shared int8 GEMM tile for the port's QuantGr kernels (sm_90a).
//
//   acc[z] = A[z] @ B[z]     s8 x s8 -> exact s32, z = blockIdx.z
//
// then one of three fused epilogues (`Epilogue`). One 256-thread block owns
// a 64x64 tile of the output and walks K in 32-deep slabs staged through
// shared memory as packed 32-bit words: four consecutive K of one A row, or
// of one B column (B is transposed on the store), per word. Every thread
// keeps a 4x4 s32 accumulator and adds four products per `__dp4a`. Ragged
// edges are masked on load and store, so any M, N, K works; the wrappers
// still pad to 128 as the reference's `ops._pad2` does. A batch stride of 0
// broadcasts an operand (the weights of a combine).
//
// A may be float32 instead of int8: it is then quantized on load by a
// scale in device memory (the QuantGr combine quantizes X this way, so the
// int8 X never reaches device memory).
//
// Numerics: the products are exact integers. Every rounding step is the
// plain PyTorch versions' own, one IEEE operation at a time: x / scale by
// `__fdiv_rn` (never a reciprocal multiply), `rintf` (half to even, like
// `torch.round`), clamp to +-127 before the narrowing, s32 -> f32 by
// `__int2float_rn`, and `__fmul_rn` / `__fadd_rn` so nvcc cannot contract
// the epilogue into an FMA that eager PyTorch does not take. The kernels
// therefore equal their plain versions bit for bit.
//
// Bound: at the serving shapes these products are bound by bytes at the
// card's int8 tensor-core rate (1,979 TOP/s against 3.35 TB/s). This first
// version issues `__dp4a` on the SIMT cores instead, whose rate is far
// lower, so it sits well above that bound; an `mma`/`wgmma` s8 tile is
// later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "activation.cuh"

namespace gcn_port {
namespace i8 {

constexpr int kBM = 64;                           // tile rows of the output
constexpr int kBN = 64;                           // tile cols of the output
constexpr int kBK = 32;                           // K per slab
constexpr int kKW = kBK / 4;                      // packed words per slab
constexpr int kTM = 4;                            // rows per thread
constexpr int kTN = 4;                            // cols per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kApad = 4;  // As row pad: int4 reads stay aligned and the
                          // transposed store is free of bank conflicts

enum Epilogue {
  kEpiScale = 0,      // out f32 = float(acc) * col[n]          (int8_matmul)
  kEpiRequant = 1,    // out s8 = q(float(acc) * col[n], h_scale)   (combine)
  kEpiAggregate = 2,  // out f32 = act(float(acc) * (row[m] * h_scale)
                      //              + col[n])                 (aggregate)
};

struct EpilogueArgs {
  const float* col;      // kEpiScale, kEpiRequant: sw[N];
                         // kEpiAggregate: bias[N]
  const float* row;      // kEpiAggregate: a_scale (batch, M), batch stride M
  const float* x_scale;  // float A only: the scalar A is quantized by
  const float* h_scale;  // kEpiRequant, kEpiAggregate: scalar
  int act;               // kEpiAggregate: Activation
};

// clamp(rint(v / scale), -127, 127), the plain versions' rounding rule
__device__ __forceinline__ int quantize_s8(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (int)((unsigned)(b0 & 0xff) | ((unsigned)(b1 & 0xff) << 8) |
               ((unsigned)(b2 & 0xff) << 16) | ((unsigned)(b3 & 0xff) << 24));
}

// A[r, k..k+3] of a row-major (M, K) int8 matrix as one word, zeros past
// the edges. `vec`: K % 4 == 0 and the rows are word aligned.
__device__ __forceinline__ int load_a_word(const int8_t* A, int r, int k,
                                           int M, int K, bool vec, float) {
  if (r >= M || k >= K) return 0;
  const int8_t* p = A + (long long)r * K + k;
  if (vec) return *reinterpret_cast<const int*>(p);
  int b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = (k + j < K) ? (int)p[j] : 0;
  return pack4(b[0], b[1], b[2], b[3]);
}

// The same four K of a float32 A, quantized by `sx` on load. `vec`:
// K % 4 == 0 and the rows are 16-byte aligned.
__device__ __forceinline__ int load_a_word(const float* A, int r, int k,
                                           int M, int K, bool vec, float sx) {
  if (r >= M || k >= K) return 0;
  const float* p = A + (long long)r * K + k;
  float v[4];
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (k + j < K) ? p[j] : 0.f;
  }
  return pack4(quantize_s8(v[0], sx), quantize_s8(v[1], sx),
               quantize_s8(v[2], sx), quantize_s8(v[3], sx));
}

template <typename TA, int kEpi>
static __global__ void __launch_bounds__(kThreads)
igemm_kernel(const TA* __restrict__ A, const int8_t* __restrict__ B,
             void* __restrict__ C, int M, int N, int K, long long stride_a,
             long long stride_b, int vec_a, EpilogueArgs e) {
  __shared__ __align__(16) int As[kKW][kBM + kApad];  // A words, K-major
  __shared__ __align__(16) int Bs[kKW][kBN];          // B words, K-major

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int z = blockIdx.z;
  A += z * stride_a;
  B += z * stride_b;
  const float sx = e.x_scale != nullptr ? *e.x_scale : 1.f;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A slab: 64 rows x 8 words, read along rows, stored K-major
#pragma unroll
    for (int i = 0; i < (kBM * kKW) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kKW, w = idx % kKW;
      As[w][r] = load_a_word(A, row0 + r, k0 + 4 * w, M, K, vec_a != 0, sx);
    }
    // B slab: 8 words x 64 cols; each word gathers four K of one column,
    // neighbouring threads read neighbouring columns (coalesced bytes)
#pragma unroll
    for (int i = 0; i < (kKW * kBN) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int w = idx / kBN, c = idx % kBN;
      const int gc = col0 + c, gk = k0 + 4 * w;
      int b[4] = {0, 0, 0, 0};
      if (gc < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) b[j] = B[(long long)(gk + j) * N + gc];
      }
      Bs[w][c] = pack4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kKW; ++w) {
      const int4 a4 = *reinterpret_cast<const int4*>(&As[w][ty * kTM]);
      const int4 b4 = *reinterpret_cast<const int4*>(&Bs[w][tx * kTN]);
      const int a[kTM] = {a4.x, a4.y, a4.z, a4.w};
      const int b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, fused into the store
  const float sh = e.h_scale != nullptr ? *e.h_scale : 1.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= M) continue;
    float rs = 0.f;
    if constexpr (kEpi == kEpiAggregate)
      rs = __fmul_rn(e.row[(long long)z * M + r], sh);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c >= N) continue;
      const long long o = ((long long)z * M + r) * N + c;
      const float f = __int2float_rn(acc[i][j]);
      if constexpr (kEpi == kEpiScale) {
        static_cast<float*>(C)[o] = __fmul_rn(f, e.col[c]);
      } else if constexpr (kEpi == kEpiRequant) {
        static_cast<int8_t*>(C)[o] =
            (int8_t)quantize_s8(__fmul_rn(f, e.col[c]), sh);
      } else {
        static_cast<float*>(C)[o] =
            apply_activation(__fadd_rn(__fmul_rn(f, rs), e.col[c]), e.act);
      }
    }
  }
}

// Launch one batched product on `stream`; returns cudaGetLastError().
template <int kEpi, typename TA>
static inline cudaError_t launch_igemm(const TA* A, const int8_t* B, void* C,
                                       int batch, int M, int N, int K,
                                       long long stride_a, long long stride_b,
                                       const EpilogueArgs& e,
                                       cudaStream_t stream) {
  const int vec_a = (K % 4 == 0) && (stride_a % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(A) % (4 * sizeof(TA)) == 0);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  igemm_kernel<TA, kEpi><<<grid, kThreads, 0, stream>>>(
      A, B, C, M, N, K, stride_a, stride_b, vec_a, e);
  return cudaGetLastError();
}

}  // namespace i8
}  // namespace gcn_port
