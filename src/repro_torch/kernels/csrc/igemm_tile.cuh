// Shared int8 GEMM tile for the port's QuantGr kernels (sm_90a), on the s8
// tensor cores:
//
//   acc[z] = A[z] @ B[z]     s8 x s8 -> exact s32, z = blockIdx.z
//
// then one of three fused epilogues (`Epilogue`). One 256-thread block owns
// a 64 x 128 tile of the output: the whole width of every product here
// (the widths are padded to 128), so each A panel is read from device
// memory once. Eight warps as 2 x 4, each 32 x 32 (2 x 4 m16n8 fragments),
// run `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (SASS
// `IMMA.16832.S8.S8`) on 64-deep slabs of K.
//
// Pipeline. Every slab streams into a ring of shared memory by 16-byte
// `cp.async` copies, issued kStages - 1 slabs ahead (4 stages, 3 with a
// float32 A), with one barrier a slab. An operand the tensor cores cannot
// take as it lies is converted in shared memory one slab ahead, into one
// of two buffers, while the copies of the later slabs are in flight:
//   * a row-major B (K x N, as `int8_matmul`'s callers give it): each
//     thread reads four K rows of four columns, turns the 4 x 4 bytes with
//     `__byte_perm` into the four columns' words of four K (`transpose4`)
//     and stores them in one 16-byte store;
//   * a float32 A (the QuantGr combine's X): each thread reads float4s and
//     stores them quantized by x_scale, four K to a word. The int8 X never
//     reaches device memory, and X is read once.
// An int8 A and a K-major B (N x ldb, K contiguous: the scratch Hq of
// fused_gcn_int8, which its combine stores K-major) go to the tensor cores
// from the ring as they landed.
//
// Shared layout. An mma fragment register is four consecutive K of one A
// row or one B column, so the tensor cores read packed 32-bit words of
// four K:
//   * A, and a K-major B: one row (of A) or column (of B) per 20 words, 16
//     words of K and 4 of padding, so rows start 16-byte aligned and lanes
//     (g, t) = (lane / 4, lane % 4), which read word t of row g, hit 32
//     different banks;
//   * a converted row-major B: one row per four K, 128 words of columns and
//     8 of padding (lanes read word g of row t: banks 8t + g).
//
// Edges. Rows past M, columns past N and K past K are zero-filled, so any
// M, N, K works. 16-byte copies need 16-byte rows: where an operand's rows
// are not (K % 16 for an int8 A, K % 4 for a float32 A, N % 16 for a
// row-major B) or its base is not 16-byte aligned, the same slabs are
// filled by plain loads and stores instead, which wait for their data. A
// K-major B must have a pitch ldb that is a multiple of 16; the bytes of
// its rows past K may never have been written, and they meet A's zeros (an
// integer product, so 0 whatever they hold). A batch stride of 0
// broadcasts an operand (the weights of a combine, which stay in L2).
//
// Numerics: the products are exact integers and s32 sums are exact in any
// order while K * 127^2 <= 2^31 - 1 (the wrappers' `check_accumulator`:
// the tensor cores wrap, they do not saturate). Every rounding step is the
// plain PyTorch versions' own, one IEEE operation at a time: x / scale by
// `__fdiv_rn` (never a reciprocal multiply), `rintf` (half to even, like
// `torch.round`), clamp to +-127 before the narrowing, s32 -> f32 by
// `__int2float_rn`, and `__fmul_rn` / `__fadd_rn` so nvcc cannot contract
// the epilogue into an FMA that eager PyTorch does not take. The kernels
// therefore equal their plain versions bit for bit.
//
// Bound: at the serving shapes these products are bound by bytes at the
// card's int8 tensor-core rate (1,979 TOP/s against 3.35 TB/s). That rate
// is `wgmma`'s, which takes s8 operands from shared memory K-major only;
// `mma.sync` reaches a fraction of it, and this tile stops there.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"

namespace gcn_port {
namespace i8 {

constexpr int kBM = 64;                    // output rows per block
constexpr int kBN = 128;                   // output columns per block
constexpr int kBK = 64;                    // K per slab
constexpr int kKW = kBK / 4;               // words of K per slab row
constexpr int kWM = 2, kWN = 4;            // warps along M and N
constexpr int kThreads = 32 * kWM * kWN;   // 256
constexpr int kMT = kBM / kWM / 16;        // m16 fragments per warp
constexpr int kNT = kBN / kWN / 8;         // n8 fragments per warp
constexpr int kRowWords = kKW + 4;         // A, K-major B: words per row
constexpr int kColWords = kBN + 8;         // converted B: words per 4 K

enum AKind {
  kAS8 = 0,   // int8 (M, K)
  kAF32 = 1,  // float32 (M, K), quantized by x_scale as it is converted
};
enum BKind {
  kBRowMajor = 0,  // (K, N), N contiguous: transposed as it is converted
  kBKMajor = 1,    // (N, ldb), K contiguous, ldb % 16 == 0
};
enum Epilogue {
  kEpiScale = 0,      // out f32 = float(acc) * col[n]          (int8_matmul)
  kEpiRequant = 1,    // out s8 = q(float(acc) * col[n], h_scale), stored
                      // K-major for the aggregate: out[n * ld_t + m]
                      //                                        (combine)
  kEpiAggregate = 2,  // out f32 = act(float(acc) * (row[m] * h_scale)
                      //              + col[n])                 (aggregate)
};

struct EpilogueArgs {
  const float* col;      // kEpiScale, kEpiRequant: sw[N];
                         // kEpiAggregate: bias[N]
  const float* row;      // kEpiAggregate: a_scale (batch, M), batch stride M
  const float* x_scale;  // kAF32 only: the scalar A is quantized by
  const float* h_scale;  // kEpiRequant, kEpiAggregate: scalar
  int act;               // kEpiAggregate: Activation
  int ld_t;              // kEpiRequant: bytes per output column (>= M)
};

// clamp(rint(v / scale), -127, 127), the plain versions' rounding rule.
// 0 / scale is +-0 exactly for a finite nonzero scale, and rounds to 0; so
// does (scale / 4) / scale = 0.25, which `__fdiv_rn` computes on its fast
// path, while its operand check (FCHK) sends a 0 dividend down the slow
// one. Most of a citation graph's features are 0, so a zero divides
// scale / 4 instead: the same quotient after rint, a select and not a
// branch.
__device__ __forceinline__ int quantize_s8(float v, float scale) {
  const bool zero = v == 0.f && scale != 0.f && fabsf(scale) < INFINITY;
  const float q = rintf(__fdiv_rn(zero ? 0.25f * scale : v, scale));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (int)((unsigned)(b0 & 0xff) | ((unsigned)(b1 & 0xff) << 8) |
               ((unsigned)(b2 & 0xff) << 16) | ((unsigned)(b3 & 0xff) << 24));
}

// r[i] holds four columns of K row i (byte j = column j); returns in c[j]
// the four K of column j (byte i = K row i): a 4 x 4 byte transpose
__device__ __forceinline__ void transpose4(const int r[4], int c[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = (int)__byte_perm(t0, t2, 0x5410);
  c[1] = (int)__byte_perm(t0, t2, 0x7632);
  c[2] = (int)__byte_perm(t1, t3, 0x5410);
  c[3] = (int)__byte_perm(t1, t3, 0x7632);
}

// 16 bytes from global memory to shared memory; `bytes` of them read (the
// rest zero-filled), 0 for none
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The A fragment of one m16n8k32 product from a packed slab: four 8 x 16
// byte matrices (rows 0-7 and 8-15, K 0-15 and 16-31), lane l giving the
// address of row l % 8 of matrix l / 8, lane (g, t) receiving word t of
// row g of each: the 32-bit reads of a[0..3] in one instruction
__device__ __forceinline__ void ldmatrix_x4(int a[4], const int* row) {
  const uint32_t p = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(p));
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulated
__device__ __forceinline__ void mma_s8(int d[4], const int a[4],
                                       const int b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block's shared memory and its staging. The ring holds kStages slabs
// of A and B as they arrive: an int8 A as packed rows of 20 words, a
// float32 A as rows of 64 floats, a row-major B as 64 rows of 128 bytes, a
// K-major B as packed columns of 20 words. Then two buffers of converted
// slabs: A packed (float32 A only) and B in rows of four K (row-major B
// only). Sizes in 32-bit words.
template <int kA, int kB, bool kCopyA, bool kCopyB>
struct Tile {
  static constexpr int kStages = kA == kAF32 ? 3 : 4;
  static constexpr int kARing = kA == kAF32 ? kBM * kBK : kBM * kRowWords;
  static constexpr int kBRing = kB == kBRowMajor ? kBK * kBN / 4
                                                 : kBN * kRowWords;
  static constexpr int kStage = kARing + kBRing;
  static constexpr int kAConv = kA == kAF32 ? kBM * kRowWords : 0;
  static constexpr int kBConv = kB == kBRowMajor ? kKW * kColWords : 0;
  static constexpr int kConv = kAConv + kBConv;
  // int8_matmul 70,656 bytes, the combine 101,376, the aggregate 61,440:
  // two blocks an SM
  static constexpr int kSmemBytes = 4 * (kStages * kStage + 2 * kConv);
  static_assert(kARing % 4 == 0 && kBRing % 4 == 0 && kAConv % 4 == 0 &&
                    kBConv % 4 == 0,
                "every region starts 16-byte aligned");

  int* smem;
  const void* A;
  const int8_t* B;
  int M, N, K, ldb, row0, col0;
  float sx;             // kAF32: x_scale

  __device__ __forceinline__ int* a_ring(int slab) const {
    return smem + (slab % kStages) * kStage;
  }
  __device__ __forceinline__ int* b_ring(int slab) const {
    return a_ring(slab) + kARing;
  }
  __device__ __forceinline__ int* a_conv(int slab) const {
    return smem + kStages * kStage + (slab % 2) * kConv;
  }
  __device__ __forceinline__ int* b_conv(int slab) const {
    return a_conv(slab) + kAConv;
  }
  // the slab's A and B as the tensor cores read them
  __device__ __forceinline__ const int* a_words(int slab) const {
    return kA == kAF32 ? a_conv(slab) : a_ring(slab);
  }
  __device__ __forceinline__ const int* b_words(int slab) const {
    return kB == kBRowMajor ? b_conv(slab) : b_ring(slab);
  }

  // Start slab `slab`'s way into its ring stage: 16-byte copies, or plain
  // loads and stores where the rows do not allow them.
  __device__ __forceinline__ void fill(int slab, int tid) const {
    const int k0 = slab * kBK;
    int* as = a_ring(slab);
    int* bs = b_ring(slab);
    if constexpr (kA == kAS8) {
      const int8_t* a = static_cast<const int8_t*>(A);
      if constexpr (kCopyA) {  // 64 rows x 4 copies
        const int r = tid / 4, ch = tid % 4;
        const int gr = row0 + r, gk = k0 + 16 * ch;
        const bool ok = gr < M && gk < K;
        cp_async16(&as[r * kRowWords + 4 * ch],
                   ok ? a + (long long)gr * K + gk : a, ok ? 16 : 0);
      } else {       // 64 rows x 16 words, byte by byte
#pragma unroll
        for (int i = 0; i < kBM * kKW / kThreads; ++i) {
          const int q = tid + i * kThreads;
          const int r = q / kKW, w = q % kKW;
          const int gr = row0 + r, gk = k0 + 4 * w;
          int b[4] = {0, 0, 0, 0};
          if (gr < M) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (gk + e < K) b[e] = a[(long long)gr * K + gk + e];
          }
          as[r * kRowWords + w] = pack4(b[0], b[1], b[2], b[3]);
        }
      }
    } else {         // 64 rows x 16 float4
      const float* a = static_cast<const float*>(A);
      float* af = reinterpret_cast<float*>(as);
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
        const int q = tid + i * kThreads;
        const int r = q / (kBK / 4), c = 4 * (q % (kBK / 4));
        const int gr = row0 + r, gk = k0 + c;
        const bool ok = gr < M && gk < K;
        if constexpr (kCopyA) {
          cp_async16(&af[r * kBK + c], ok ? a + (long long)gr * K + gk : a,
                     ok ? 16 : 0);
        } else {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (gr < M) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (gk + e < K) v[e] = a[(long long)gr * K + gk + e];
          }
          *reinterpret_cast<float4*>(&af[r * kBK + c]) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    if constexpr (kB == kBRowMajor) {
      if constexpr (kCopyB) {  // 64 rows x 8 copies of 16 columns
#pragma unroll
        for (int i = 0; i < kBK * kBN / 16 / kThreads; ++i) {
          const int q = tid + i * kThreads;
          const int r = q / (kBN / 16), ch = q % (kBN / 16);
          const int gk = k0 + r, gc = col0 + 16 * ch;
          const bool ok = gk < K && gc < N;
          cp_async16(&bs[r * (kBN / 4) + 4 * ch],
                     ok ? B + (long long)gk * N + gc : B, ok ? 16 : 0);
        }
      } else {       // 64 rows x 32 words, byte by byte
#pragma unroll
        for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
          const int q = tid + i * kThreads;
          const int r = q / (kBN / 4), w = q % (kBN / 4);
          const int gk = k0 + r, gc = col0 + 4 * w;
          int b[4] = {0, 0, 0, 0};
          if (gk < K) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (gc + e < N) b[e] = B[(long long)gk * N + gc + e];
          }
          bs[r * (kBN / 4) + w] = pack4(b[0], b[1], b[2], b[3]);
        }
      }
    } else {         // 128 columns x 4 copies of 16 K
#pragma unroll
      for (int i = 0; i < kBN * kKW / 4 / kThreads; ++i) {
        const int q = tid + i * kThreads;
        const int n = q / 4, ch = q % 4;
        const int gn = col0 + n, gk = k0 + 16 * ch;
        const bool ok = gn < N && gk < K;
        cp_async16(&bs[n * kRowWords + 4 * ch],
                   ok ? B + (long long)gn * ldb + gk : B, ok ? 16 : 0);
      }
    }
  }

  // Convert slab `slab`, landed in its ring stage, for the tensor cores.
  __device__ __forceinline__ void convert(int slab, int tid) const {
    if constexpr (kA == kAF32) {
      const int k0 = slab * kBK;
      const float* af = reinterpret_cast<const float*>(a_ring(slab));
      int* ac = a_conv(slab);
#pragma unroll
      for (int i = 0; i < kBM * kKW / kThreads; ++i) {
        const int q = tid + i * kThreads;
        const int r = q / kKW, w = q % kKW;
        const float4 v = *reinterpret_cast<const float4*>(&af[r * kBK + 4 * w]);
        // only real elements are quantized: K and rows past the edge are 0
        // exactly, whatever x_scale is
        const int n = row0 + r < M ? K - (k0 + 4 * w) : 0;
        ac[r * kRowWords + w] = pack4(n > 0 ? quantize_s8(v.x, sx) : 0,
                                      n > 1 ? quantize_s8(v.y, sx) : 0,
                                      n > 2 ? quantize_s8(v.z, sx) : 0,
                                      n > 3 ? quantize_s8(v.w, sx) : 0);
      }
    }
    if constexpr (kB == kBRowMajor) {
      const int* bs = b_ring(slab);
      int* bc = b_conv(slab);
#pragma unroll
      for (int i = 0; i < kKW * kBN / 4 / kThreads; ++i) {
        const int q = tid + i * kThreads;
        const int kw = q / (kBN / 4), cw = q % (kBN / 4);
        int r[4], c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = bs[(4 * kw + j) * (kBN / 4) + cw];
        transpose4(r, c);
        *reinterpret_cast<int4*>(&bc[kw * kColWords + 4 * cw]) =
            make_int4(c[0], c[1], c[2], c[3]);
      }
    }
  }
};

template <int kA, int kB, int kEpi, bool kCopyA, bool kCopyB>
static __global__ void __launch_bounds__(kThreads, 2)
igemm_kernel(const void* __restrict__ A, const int8_t* __restrict__ B,
             void* __restrict__ C, int M, int N, int K, long long stride_a,
             long long stride_b, int ldb, EpilogueArgs e) {
  extern __shared__ __align__(16) int smem[];
  using T = Tile<kA, kB, kCopyA, kCopyB>;
  constexpr int S = T::kStages;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;           // the fragments' lane map
  const int wm = warp / kWN, wn = warp % kWN;
  const int z = blockIdx.z;
  const T st{smem,
             static_cast<const char*>(A) +
                 z * stride_a * (kA == kAF32 ? 4 : 1),
             B + z * stride_b, M, N, K, ldb, (int)blockIdx.y * kBM,
             (int)blockIdx.x * kBN, e.x_scale != nullptr ? *e.x_scale : 1.f};

  // the A row whose address this lane gives ldmatrix: row lane % 8 of
  // matrix lane / 8 (rows + 8 for matrices 1 and 3; K + 16 for 2 and 3,
  // as a word offset of 4 below)
  int a_row[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
    a_row[i] = wm * 32 + i * 16 + lane % 8 + 8 * ((lane / 8) % 2);
  const int a_word = 4 * (lane / 16);
  // the fragments this warp owns that hold any real output
  bool live_m[kMT], live_n[kNT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) live_m[i] = st.row0 + wm * 32 + i * 16 < M;
#pragma unroll
  for (int j = 0; j < kNT; ++j) live_n[j] = st.col0 + wn * 32 + j * 8 < N;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // prologue: slabs 0 .. S - 2 on their way, slab 0 converted
  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) st.fill(s, tid);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();                  // slab 0 has landed
  __syncthreads();
  if (nk > 0) st.convert(0, tid);

  for (int s = 0; s < nk; ++s) {
    cp_async_wait<S - 3>();                // slab s + 1 has landed
    __syncthreads();   // slab s is converted and s + 1 visible, and no warp
                       // reads slab s - 1's stage or buffer any more
    if (s + S - 1 < nk) st.fill(s + S - 1, tid);
    cp_async_commit();
    if (s + 1 < nk) st.convert(s + 1, tid);

    const int* As = st.a_words(s);
    const int* Bs = st.b_words(s);
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const int kw = kk * 8 + t;           // this lane's first K word
      int a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(a[i], &As[a_row[i] * kRowWords + kk * 8 + a_word]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = wn * 32 + j * 8 + g;
        if constexpr (kB == kBKMajor) {
          b[j][0] = Bs[n * kRowWords + kw];
          b[j][1] = Bs[n * kRowWords + kw + 4];
        } else {
          b[j][0] = Bs[kw * kColWords + n];
          b[j][1] = Bs[(kw + 4) * kColWords + n];
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          if (live_m[i] && live_n[j]) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue, fused into the store: c0, c1 at row g, columns 2t, 2t + 1 of
  // the fragment; c2, c3 eight rows below
  const float sh = e.h_scale != nullptr ? *e.h_scale : 1.f;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = st.row0 + wm * 32 + i * 16 + g + 8 * h;
      if (r >= M) continue;
      float rs = 0.f;
      if constexpr (kEpi == kEpiAggregate)
        rs = __fmul_rn(e.row[(long long)z * M + r], sh);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = st.col0 + wn * 32 + j * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float f = __int2float_rn(acc[i][j][2 * h + u]);
          if (c + u >= N) {
            v[u] = 0.f;
          } else if constexpr (kEpi == kEpiAggregate) {
            v[u] = apply_activation(__fadd_rn(__fmul_rn(f, rs), e.col[c + u]),
                                    e.act);
          } else {
            v[u] = __fmul_rn(f, e.col[c + u]);
          }
        }
        if constexpr (kEpi == kEpiRequant) {
          int8_t* out = static_cast<int8_t*>(C) + (long long)z * N * e.ld_t;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (c + u < N)
              out[(long long)(c + u) * e.ld_t + r] =
                  (int8_t)quantize_s8(v[u], sh);
        } else {
          float* out = static_cast<float*>(C) + ((long long)z * M + r) * N;
          if (c + 1 < N && N % 2 == 0) {
            *reinterpret_cast<float2*>(out + c) = make_float2(v[0], v[1]);
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if (c + u < N) out[c + u] = v[u];
          }
        }
      }
    }
  }
}

// Whether Kernel has opted in to its shared memory. A static variable
// template: internal linkage, so each library built from this header opts
// its own kernels in (as tc_gemm_tile.cuh's g_sized).
template <auto Kernel>
static bool g_opted_in = false;

template <int kA, int kB, int kEpi, bool kCopyA, bool kCopyB>
static inline cudaError_t launch_tile(dim3 grid, cudaStream_t stream,
                                      const void* A, const int8_t* B,
                                      void* C, int M, int N, int K,
                                      long long stride_a, long long stride_b,
                                      int ldb, const EpilogueArgs& e) {
  constexpr auto kernel = igemm_kernel<kA, kB, kEpi, kCopyA, kCopyB>;
  constexpr int bytes = Tile<kA, kB, kCopyA, kCopyB>::kSmemBytes;
  if (!g_opted_in<kernel>) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    g_opted_in<kernel> = true;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(A, B, C, M, N, K, stride_a,
                                            stride_b, ldb, e);
  return cudaGetLastError();
}

// Launch one batched product on `stream`; returns cudaGetLastError(). A is
// int8 or float32, B row-major (kBRowMajor: ldb is ignored) or K-major with
// pitch ldb (kBKMajor: ldb, stride_b and B 16-byte aligned). Strides are
// in elements. Each operand is staged by 16-byte copies where its rows
// and base allow them (the kernel is instantiated for both).
template <int kB, int kEpi, typename TA>
static inline cudaError_t launch_igemm(const TA* A, const int8_t* B,
                                       int ldb, void* C, int batch, int M,
                                       int N, int K, long long stride_a,
                                       long long stride_b,
                                       const EpilogueArgs& e,
                                       cudaStream_t stream) {
  const auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  constexpr int kA = sizeof(TA) == 4 ? kAF32 : kAS8;
  constexpr int per_copy = 16 / (int)sizeof(TA);   // elements a copy moves
  const bool copy_a =
      K % per_copy == 0 && stride_a % per_copy == 0 && aligned16(A);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  const auto go = [&](auto ca, auto cb) {
    return launch_tile<kA, kB, kEpi, decltype(ca)::value,
                       decltype(cb)::value>(grid, stream, A, B, C, M, N, K,
                                            stride_a, stride_b, ldb, e);
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if constexpr (kB == kBKMajor) {      // a K-major B takes only copies
    if (ldb % 16 != 0 || stride_b % 16 != 0 || !aligned16(B) || ldb < K)
      return cudaErrorInvalidValue;
    return copy_a ? go(Yes{}, Yes{}) : go(No{}, Yes{});
  } else {
    const bool copy_b = N % 16 == 0 && stride_b % 16 == 0 && aligned16(B);
    if (copy_a) return copy_b ? go(Yes{}, Yes{}) : go(Yes{}, No{});
    return copy_b ? go(No{}, Yes{}) : go(No{}, No{});
  }
}

}  // namespace i8
}  // namespace gcn_port
