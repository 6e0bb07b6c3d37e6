// fp32 GEMM on the TF32 tensor cores with fp32 accuracy (3xTF32), for
// `block_matmul`, both launches of `fused_gcn_dense`, both launches of
// `fused_gcn_grasp` and `bitmap_spmm` (the GraSp walk of bsr_tile.cuh),
// and the combines of `fused_gat_full` and `fused_sage` (sm_90a):
//
//   C[z] = A[z] @ B[z]               z = blockIdx.z, row-major fp32 operands
//   C[z] = act(A[z] @ B[z] + bias)   with the EPI option
//
// The block's main loop is the device function `mma_tile`. The batched
// GEMM kernel `gemm_3xtf32_kernel` runs it once a block, and
// `launch_gemm_3xtf32` launches it: block_matmul without EPI, the GCN
// layers' combines without EPI and fused_gcn_dense's aggregate with it.
// fused_gat_full and fused_sage call `mma_tile` from kernels of their own
// (fused_sage twice, into one accumulator), as does the GraSp walk (once a
// block entry, into one accumulator, stored by `store_tile`), which
// `launch_ring` launches with the ring's shared memory; the GAT attention
// body (gat_tile.cuh) takes the split_tf32, mma_tf32 and cp.async helpers.
//
// 3xTF32: each operand element x is split into big = tf32(x) (round to
// nearest, ties away, to 10 mantissa bits: the bits cvt.rna.tf32.f32
// gives, computed with an integer add and mask, since the conversion runs
// on the card's slower conversion pipe) and small = tf32(x - big); each
// product accumulates a_small*b_big + a_big*b_small +
// a_big*b_big, the small terms first (as CUTLASS's 3xTF32 does). The
// dropped a_small*b_small is below 2^-22 of a product. The product is
// mma.sync m16n8k8 tf32: B is (K x N) with N contiguous, and wgmma takes
// TF32 operands K-major only, so a wgmma version would first need B
// transposed; that is later work.
//
// The tensor cores truncate as they accumulate, so a chain of products
// through one accumulator loses more than fp32's round-to-nearest, and
// the more the longer K is. So each 16-deep
// piece of K (six products) starts from 0 in a fresh fragment, which is
// added in fp32 to a partial sum, which goes to the total every 128 of K
// (a blocked sum). That keeps the error at or below cuBLAS's fp32 SIMT
// kernel on the serving products and the card tests' shapes.
//
// One 128-thread block owns a 64 x 64 tile of C: 4 warps as 2 x 2, each
// 32 x 32 (2 x 4 m16n8 fragments). K walks in 32-deep slabs through a
// 3-stage cp.async ring (cp.async.wait_group), so the copies of the next
// two slabs overlap the products of this one. Each warp splits the
// fragments it loads. Shared rows are padded (A by 4 floats, B by 8) so
// the fragment loads hit 32 banks. Ragged edges are zero-filled on load
// and masked on store, so any M, N, K works. 16-byte copies need
// 16-byte-aligned rows: where A's row pitch or N (for B) is not a multiple
// of 4, or a base is not 16-byte aligned, the same kernel is instantiated
// with 4-byte copies of that operand. A's pitch may exceed K (a scratch
// padded to 16-byte rows, whose pad mma_tile's PA option never reads).
// A batch stride of 0 broadcasts an operand.
//
// Three compile-time switches exist only to time the tile's parts (the
// `[breakdown]` step of chip_smoke.py builds the other settings under
// build/); the library ships the defaults. TC_GEMM_PRODUCTS 1 keeps only
// a_big*b_big; TC_GEMM_SPLIT 0 passes each fp32 element to the tensor
// cores as it is (they read its top 19 bits) instead of splitting it;
// TC_SPLIT_INT 0 rounds with cvt.rna.tf32.f32 itself (the same bits).
#pragma once

#ifndef TC_GEMM_PRODUCTS
#define TC_GEMM_PRODUCTS 3
#endif
#ifndef TC_GEMM_SPLIT
#define TC_GEMM_SPLIT 1
#endif
#ifndef TC_SPLIT_INT
#define TC_SPLIT_INT 1
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "activation.cuh"

namespace gcn_port {
namespace tc {

constexpr int kBM = 64, kBN = 64;          // block tile of C
constexpr int kWM = 2, kWN = 2;            // warps along M and N
constexpr int kThreads = 32 * kWM * kWN;
constexpr int kMT = kBM / kWM / 16;        // m16 fragments per warp
constexpr int kNT = kBN / kWN / 8;         // n8 fragments per warp
constexpr int kBK = 32;                    // K slab per stage
constexpr int kChain = 16;                 // K per fresh tensor-core chain
constexpr int kFlush = 128;                // K per partial sum
constexpr int kStages = 3;
constexpr int kAStride = kBK + 4;          // floats per A row in shared
constexpr int kBStride = kBN + 8;          // floats per B row in shared
constexpr int kStageFloats = kBM * kAStride + kBK * kBStride;
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 55,296
static_assert(kBM * kBK / 4 % kThreads == 0 && kBK * kBN / 4 % kThreads == 0,
              "every thread copies whole 16-byte chunks of each slab");
static_assert(kFlush % kBK == 0 && kBK % kChain == 0 && kChain % 8 == 0,
              "chains and partial sums cover whole slabs");

// Copy `bytes` (4 or 16) from global src to shared dst, reading only the
// first `src_bytes` of them (0 reads nothing) and zero-filling the rest.
__device__ __forceinline__ void cp_async_part(float* dst, const float* src,
                                              int bytes, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, int bytes) {
  cp_async_part(dst, src, bytes, valid ? bytes : 0);   // 0 read: zero-fill
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tf32(x) as cvt.rna.tf32.f32 computes it, in two integer operations:
// half of the last kept bit added to the magnitude, the 13 dropped bits
// cleared (a carry moves into the exponent, as rounding up does)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
#if TC_SPLIT_INT
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
#else
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
#endif
}

// big = tf32(x), small = tf32(x - big); both as tf32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
#if TC_GEMM_SPLIT
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
#else
  big = small = __float_as_uint(x);
#endif
}

// c += a b on one m16n8k8 tf32 fragment
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the (64 x 32) A slab and (32 x 64) B slab at k0; out-of-range
// elements are zero-filled. A's rows lie lda >= K floats apart. VA, VB:
// 16-byte copies of A (lda a multiple of 4, A 16-byte aligned, and K a
// multiple of 4 unless PA) and of B (N and col0 multiples of 4, B
// aligned), else 4-byte copies. PA: a 16-byte copy of A that crosses K
// reads the columns before K and zero-fills the rest, so the columns from
// K to lda (a scratch's pad) are never read; without it the copies cost
// no bounds arithmetic.
template <bool VA, bool VB, bool PA = false>
__device__ __forceinline__ void load_slab(const float* __restrict__ A,
                                          const float* __restrict__ B, int M,
                                          int N, int K, int lda, int row0,
                                          int col0, int k0, float* stage) {
  constexpr int W = VA ? 4 : 1;             // floats per copy of A
  constexpr int WB = VB ? 4 : 1;            // ... and of B
  const int tid = threadIdx.x;
  float* as = stage;
  float* bs = stage + kBM * kAStride;
#pragma unroll
  for (int i = 0; i < kBM * kBK / W / kThreads; ++i) {
    const int id = tid + i * kThreads;
    const int r = id / (kBK / W), c = (id % (kBK / W)) * W;
    const int gr = row0 + r, gc = k0 + c;
    const bool ok = gr < M && gc < K;
    cp_async_part(as + r * kAStride + c,
                  ok ? A + (long long)gr * lda + gc : A, 4 * W,
                  !ok ? 0 : PA ? 4 * min(W, K - gc) : 4 * W);
  }
#pragma unroll
  for (int i = 0; i < kBK * kBN / WB / kThreads; ++i) {
    const int id = tid + i * kThreads;
    const int r = id / (kBN / WB), c = (id % (kBN / WB)) * WB;
    const int gr = k0 + r, gc = col0 + c;
    const bool ok = gr < K && gc < N;
    cp_async(bs + r * kBStride + c, ok ? B + (long long)gr * N + gc : B, ok,
             4 * WB);
  }
}

// The block's 64 x 64 tile of A @ B at (row0, col0), added to `acc`: each
// warp its 32 x 32 as kMT x kNT m16n8 fragments (rows wm + 16 i + g (+ 8),
// columns wn + 8 j + 2 t (+ 1)), with the ring in the kernel's dynamic
// shared memory (kSmemBytes). A and B are one product's operands,
// row-major, (M x K) with rows lda apart and (K x N); VA, VB, PA as
// load_slab's. The caller zeroes `acc` before its first product; a second
// product goes on from the first's total, its own partial sums flushed
// into it every kFlush of its K. Ends with every copy landed; the caller
// syncs before it reuses the shared memory.
template <bool VA, bool VB, bool PA = false>
__device__ __forceinline__ void mma_tile(const float* __restrict__ A,
                                         const float* __restrict__ B, int M,
                                         int N, int K, int lda, int row0,
                                         int col0,
                                         float (&acc)[kMT][kNT][4]) {
  extern __shared__ __align__(16) float smem[];      // [kStages] slabs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / kWN) * (kBM / kWM);         // the warp's tile
  const int wn = (warp % kWN) * (kBN / kWN);
  const int g = lane / 4, t = lane % 4;

  // acc: the total; mid: the partial sum of the current kFlush of K
  float mid[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mid[i][j][e] = 0.f;
  const int slabs = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs)
      load_slab<VA, VB, PA>(A, B, M, N, K, lda, row0, col0, s * kBK,
                            smem + s * kStageFloats);
    cp_async_commit();                     // one group per slab, even empty
  }
  for (int ks = 0; ks < slabs; ++ks) {
    cp_async_wait<kStages - 2>();          // slab ks has landed
    __syncthreads();                       // ... for every thread, and
                                           // slab ks - 1 is consumed
    const int next = ks + kStages - 1;
    if (next < slabs)
      load_slab<VA, VB, PA>(A, B, M, N, K, lda, row0, col0, next * kBK,
                            smem + (next % kStages) * kStageFloats);
    cp_async_commit();
    const float* a_s = smem + (ks % kStages) * kStageFloats;
    const float* b_s = a_s + kBM * kAStride;
#pragma unroll
    for (int kc = 0; kc < kBK; kc += kChain) {
      float part[kMT][kNT][4];             // this chain, from 0
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int k8 = kc; k8 < kc + kChain; k8 += 8) {
        uint32_t a_big[kMT][4], a_small[kMT][4], b_big[kNT][2],
            b_small[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* p = a_s + (wm + 16 * i + g) * kAStride + k8 + t;
          split_tf32(p[0], a_big[i][0], a_small[i][0]);
          split_tf32(p[8 * kAStride], a_big[i][1], a_small[i][1]);
          split_tf32(p[4], a_big[i][2], a_small[i][2]);
          split_tf32(p[8 * kAStride + 4], a_big[i][3], a_small[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* p = b_s + (k8 + t) * kBStride + wn + 8 * j + g;
          split_tf32(p[0], b_big[j][0], b_small[j][0]);
          split_tf32(p[4 * kBStride], b_big[j][1], b_small[j][1]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
#if TC_GEMM_PRODUCTS == 3
            mma_tf32(part[i][j], a_small[i], b_big[j]);
            mma_tf32(part[i][j], a_big[i], b_small[j]);
#endif
            mma_tf32(part[i][j], a_big[i], b_big[j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mid[i][j][e] += part[i][j][e];
    }
    if ((ks + 1) % (kFlush / kBK) == 0 || ks + 1 == slabs) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] += mid[i][j][e];
            mid[i][j][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();
}

// Whether Kernel has opted in to the ring's kSmemBytes of shared memory.
// A static variable template: internal linkage, so each library built
// from this header opts its own kernels in (a static local of a launcher
// template would be one GNU-unique symbol across every such library in a
// process, and a second library would launch without opting in).
template <auto Kernel>
static bool g_sized = false;

// Launch Kernel, whose blocks run mma_tile, with the ring's shared memory
// on `stream`; returns cudaGetLastError().
template <auto Kernel, class... Args>
cudaError_t launch_ring(dim3 grid, cudaStream_t stream, Args... args) {
  if (!g_sized<Kernel>) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    g_sized<Kernel> = true;
  }
  Kernel<<<grid, kThreads, kSmemBytes, stream>>>(args...);
  return cudaGetLastError();
}

// Whether a row-major operand at p with rows of `cols` floats may be
// staged with 16-byte copies (mma_tile's VA, VB): its rows and base on
// 16-byte boundaries.
static inline bool copies16(const float* p, long long cols) {
  return cols % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One output element as the store writes it: v, or with EPI
// act(v + bias[c]) (activation.cuh), the plain versions' order.
template <bool EPI>
__device__ __forceinline__ float epilogue(float v,
                                          const float* __restrict__ bias,
                                          int c, int act) {
  if constexpr (EPI)
    return apply_activation(v + bias[c], act);
  else
    return v;
}

// C[row0:row0+64, col0:col0+64] = epilogue<EPI>(acc) for row-major C
// (M x N), from mma_tile's fragment layout; rows and columns out of range
// are not written.
template <bool EPI>
__device__ __forceinline__ void store_tile(float* __restrict__ C, int M,
                                           int N, int row0, int col0,
                                           const float (&acc)[kMT][kNT][4],
                                           const float* __restrict__ bias,
                                           int act) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / kWN) * (kBM / kWM);
  const int wn = (warp % kWN) * (kBN / kWN);
  const int g = lane / 4, t = lane % 4;

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        if (c < N)
          C[(long long)r * N + c] =
              epilogue<EPI>(acc[i][j][2 * h], bias, c, act);
        if (c + 1 < N)
          C[(long long)r * N + c + 1] =
              epilogue<EPI>(acc[i][j][2 * h + 1], bias, c + 1, act);
      }
    }
}

// C[z] = A[z] @ B[z] (M x K times K x N, both row-major, A's rows K
// apart), with EPI act(... + bias); one block a 64 x 64 tile of C. VEC:
// 16-byte copies of both operands. static: each library that includes
// this header keeps its own instantiations.
template <bool VEC, bool EPI = false>
static __global__ void __launch_bounds__(kThreads)
    gemm_3xtf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K,
                       long long stride_a, long long stride_b,
                       const float* __restrict__ bias, int act) {
  A += blockIdx.z * stride_a;
  B += blockIdx.z * stride_b;
  C += blockIdx.z * (long long)M * N;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[kMT][kNT][4] = {};
  mma_tile<VEC, VEC>(A, B, M, N, K, K, row0, col0, acc);
  store_tile<EPI>(C, M, N, row0, col0, acc, bias, act);
}

// Launch one batched product on `stream`; returns cudaGetLastError().
// A batch stride of 0 broadcasts an operand; C is (batch, M, N)
// contiguous. 16-byte copies of both operands where both allow them.
// EPI: the store adds bias (N,) and applies act (activation.cuh codes).
template <bool EPI = false>
static inline cudaError_t launch_gemm_3xtf32(
    const float* A, const float* B, float* C, int batch, int M, int N, int K,
    long long stride_a, long long stride_b, cudaStream_t stream,
    const float* bias = nullptr, int act = kActNone) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  return copies16(A, K) && copies16(B, N)
             ? launch_ring<&gemm_3xtf32_kernel<true, EPI>>(
                   grid, stream, A, B, C, M, N, K, stride_a, stride_b, bias,
                   act)
             : launch_ring<&gemm_3xtf32_kernel<false, EPI>>(
                   grid, stream, A, B, C, M, N, K, stride_a, stride_b, bias,
                   act);
}

}  // namespace tc
}  // namespace gcn_port
