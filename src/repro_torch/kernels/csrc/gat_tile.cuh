// Shared GAT attention body of the port's three GAT kernels (sm_90a), with
// the product on the TF32 tensor cores:
//
//   out[z, i, hd, :] = act( sum_j softmax_j(s[i, j]) * h[z, j, hd, :]
//                           + b[hd, :] )
//   s[i, j] = leaky_0.2(alpha_dst[z, i, hd] + alpha_src[z, j, hd])
//             + bias[z, i, j]                       (bias: 0 or -1e9)
//
// It replaces the body of three TPU kernels: `gat_attention`
// (src/repro/kernels/gat_attention.py:42), `fused_gat_full`
// (fused_layers.py:334) and `fused_gat_precombined` (fused_layers.py:394).
// Each holds one head's (bm, n) score strip in VMEM (1.5 MB at bm = 128,
// n = 3072) and re-reads the bias strip once per head. A block here has at
// most 227 KB of shared memory, so the strip is never formed: the columns
// are walked with an online softmax, and the bias is read once per group
// of up to 8 heads. h is read in its (n, heads, f) layout with f and heads
// as runtime ints: nothing is padded to the TPU's 128 lanes.
//
// Bound, per 4-graph batch at n = 3072 (H100 SXM): the bias is 151 MB, 45
// us at 3.35 TB/s; layer 1 (8 heads of 8) takes 302 M expf, 72 us on the
// SFUs (132 SMs x 16 a clock x 1.98 GHz), and 4.8 GFLOP of P.H, 29 us as
// three TF32 products at 495 TFLOP/s. So layer 1 is bound by its expf and
// layer 2 (1 head of 7) by its bias bytes. What holds layer 1 instead is
// dispatching the arithmetic each score takes (score, max, exponential,
// sum, the TF32 split), not one pipe's peak: the mma.sync products take a
// sixth of its time and the exponentials a twentieth (chip_smoke.py's
// `[breakdown]`). The SIMT body this replaced spent its time on
// shared-memory reads: one thread per (row, head) read f floats of h for
// every column. Here each h element read serves 32 rows.
//
// Design. A warp owns 16 * MT rows (MT = 2 m16 fragments for f <= 16,
// else 1) and one head. Its lane (g = lane / 4, t = lane % 4) computes
// the scores of its own A-fragment entries in registers: rows g and g + 8
// of each fragment, and tile columns 2t and 2t + 1 of each k8 step as the
// fragment's k = t and k = t + 4. B takes h's columns in the same order,
// so the product is unchanged, and the bias of a lane is one 8-byte load.
// A block is 8 warps: its heads (up to 8, and up to 128 floats of h per
// column) times column splits, so a one-head layer still has 8 warps at
// work (heads x splits short of 8 leave warps that only copy). The splits
// take disjoint columns of each tile and are merged at the end through
// shared memory, as partial softmax states. Per softmax step (32 columns
// where f <= 16 and no splits, else 16) the running max of each row is
// reduced over the lane's quad with shuffles; the fp32 sum and the fp32
// accumulator are rescaled; p = 2^((s - m) log2 e) (ex2.approx; the
// max-subtracted score is scaled, so an all -1e9 row gets exactly 1 per
// column). Each p and h element is split big/small (tc_gemm_tile.cuh's
// split_tf32) and fed to three m16n8k8 products per (k8, fragment, n8
// fragment of the head), small terms first. Each 16-column chain starts
// from 0 in a fresh fragment and is added in fp32 to the accumulator (the
// tensor cores truncate as they accumulate). A head of f <= 8 is one n8
// fragment, its columns past f zero in shared memory and never stored.
//
// Staging: the bias tile (16 * MT rows x TW columns), alpha_src (heads of
// the block x TW) and h (TW columns x the block's heads) go through a
// cp.async ring, so the copies of the next tiles overlap this tile's math:
// 2 stages of 128 columns with 32-column steps (fewer barriers), else 3
// of 16 columns a split (at least 32) with 16-column steps.
// Copies are 16 bytes where the row stride and base allow it (bias:
// n % 4 == 0; h: f % 4 == 0), else 4 bytes; rows and columns past n are
// zero-filled. Each thread's bias and alpha_src copies sit at a fixed
// column of every tile. Rows are padded so that fragment reads hit
// distinct banks: the bias row stride is 8 (mod 32) floats, the h row
// stride 4 (mod 8). Shared memory is sized at launch.
//
// Occupancy (ptxas -v, 256-thread blocks at most 128 registers, 2 blocks
// an SM): layer 1 (f = 8, 32-column steps) 127 registers and 113 KB of
// shared memory a block, layer 2 (f = 7, one head) 115 registers and 72
// KB: 16 warps an SM. A 4 x 3072 batch is 384 blocks of 32 rows, about
// 1.5 waves of 264.
//
// Arithmetic, as the reference: e = alpha_dst[i] + alpha_src[j]; leaky as
// max(e, 0.2f * e) (the same value as e >= 0 ? e : 0.2f * e); + bias. The
// mask is -1e9, not -inf: a padded row (no self-loop, all its bias -1e9)
// gets uniform weights, finite, never NaN. Only columns past n (a ragged
// tile) are dropped, as -inf, and a step of columns all past n is
// skipped. The result is acc / max(l, 1e-12).
//
// Two compile-time switches exist only to time the body's parts (the
// `[breakdown]` step of chip_smoke.py builds them under build/); the
// libraries ship the defaults. GAT_PRODUCTS 1 keeps only p_big * h_big;
// GAT_EXP 0 replaces each exponential by a multiply.
#pragma once

#ifndef GAT_PRODUCTS
#define GAT_PRODUCTS 3
#endif
#ifndef GAT_EXP
#define GAT_EXP 1
#endif

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"
#include "tc_gemm_tile.cuh"

namespace gcn_port {
namespace gat {

constexpr int kWarps = 8;                  // warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;              // per SM: at most 128 registers
constexpr int kMaxHF = 128;                // floats of a head group's h row
constexpr int kMaxF = 64;                  // widest head the kernels take
constexpr float kSlope = 0.2f;             // leaky_relu negative slope
constexpr float kLog2e = 1.4426950408889634f;

// m16 fragments (16 rows each) of a warp for NF n8 fragments a head
template <int NF>
__host__ __device__ constexpr int frags_m() {
  return NF <= 2 ? 2 : 1;
}

// Heads per block and column splits per head for a head width f.
__host__ __device__ inline int heads_per_block(int heads, int f) {
  const int hb = kMaxHF / f < kWarps ? kMaxHF / f : kWarps;
  return heads < hb ? heads : hb;
}
__host__ __device__ inline int column_splits(int hb) {
  int s = 1;
  while (2 * s * hb <= kWarps) s *= 2;
  return s;
}

// A block's tiling for `heads` heads of width f, nf n8 fragments a head,
// `rows` rows, softmax steps of `chunk` columns and tiles of at least
// `tw_min` columns; sizes in floats.
struct Geometry {
  int hb, splits;     // heads of a block, column splits of each head
  int tw;             // columns per staged tile
  int sb, sh;         // row strides of the bias and h tiles
  int stage;          // one ring stage: bias, h, alpha_src
  __host__ __device__ Geometry(int heads, int f, int nf, int rows, int chunk,
                               int tw_min) {
    hb = heads_per_block(heads, f);
    splits = column_splits(hb);
    tw = chunk * splits > tw_min ? chunk * splits : tw_min;
    sb = tw + 8;                           // 8 (mod 32): tw is a 32-multiple
    sh = ((hb - 1) * f + 8 * nf + 3) / 4 * 4;   // every fragment column
    if (sh % 8 == 0) sh += 4;              // 4 (mod 8)
    stage = rows * sb + tw * sh + hb * tw;
  }
};

// The partial softmax state a column split hands over: m and l of each
// (m fragment, row half), then the accumulator fragments.
template <int MT, int NF>
__host__ __device__ constexpr int state_floats() {
  return 4 * MT + 4 * MT * NF;
}

// A thread's share of the copies of a (rows x q) grid: elements tid,
// tid + kThreads, ... at (i / q, i % q), stepped without dividing.
struct Walk {
  int r, c, dr, dc, q;
  __device__ Walk(int tid, int q_)
      : r(tid / q_), c(tid % q_), dr(kThreads / q_), dc(kThreads % q_),
        q(q_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= q) {
      c -= q;
      ++r;
    }
  }
};

// 2^(x log2 e): the softmax's exponential (0 at x = -inf)
__device__ __forceinline__ float softmax_exp(float x) {
  float y = x * kLog2e;
#if GAT_EXP
  asm("ex2.approx.ftz.f32 %0, %0;\n" : "+f"(y));
#endif
  return y;
}

__device__ __forceinline__ float score(float ad, float as, float bias) {
  float e = ad + as;
  e = fmaxf(e, kSlope * e);                // leaky_relu
  return e + bias;
}

// h: (batch, n, heads, f); alpha_dst, alpha_src: (batch, n, heads); bias:
// (batch, n, n); b: (heads, f) or null; out: (batch, n, heads, f). Grid
// (ceil(n / (16 MT)), ceil(heads / hb), batch), kThreads threads; NF * 8
// >= f; softmax steps of CHUNK columns; a STAGES-deep ring. vec_bias,
// vec_h: 16-byte copies of the bias and h tiles.
template <int NF, int CHUNK, int TW_MIN, int STAGES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_kernel(const float* __restrict__ h,
                 const float* __restrict__ alpha_dst,
                 const float* __restrict__ alpha_src,
                 const float* __restrict__ bias, const float* __restrict__ b,
                 float* __restrict__ out, int n, int heads, int f, int act,
                 bool vec_bias, bool vec_h) {
  constexpr int MT = frags_m<NF>();        // m16 fragments of a warp
  constexpr int kRows = 16 * MT;           // rows of a block
  static_assert(CHUNK % tc::kChain == 0, "a softmax step is whole chains");
  extern __shared__ __align__(16) float smem[];
  const Geometry geo(heads, f, NF, kRows, CHUNK, TW_MIN);
  const int hf = heads * f;
  const int head0 = blockIdx.y * geo.hb;
  const int nh = min(geo.hb, heads - head0);   // heads of this block
  const int gw = nh * f;                       // floats of its h rows
  const int z = blockIdx.z;
  h += (long long)z * n * hf;
  alpha_dst += (long long)z * n * heads;
  alpha_src += (long long)z * n * heads;
  bias += (long long)z * n * n;
  out += (long long)z * n * hf;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hd = warp % geo.hb;            // head within the block
  const int split = warp / geo.hb;         // column split
  // warp-uniform; warps past hb * splits only copy
  const bool active = hd < nh && split < geo.splits;
  const int head = head0 + hd;
  const int row0 = blockIdx.x * kRows;
  const int wc = geo.tw / geo.splits;      // a split's columns of a tile

  // this thread's copies of every tile: the bias at column cb of rows rb,
  // rb + rs, ... (kThreads is a multiple of tw / wb), alpha_src at column
  // ja of heads ka, ka + ks, ..., h by a Walk over (tw x gw / wh)
  const int wb = vec_bias ? 4 : 1, wh = vec_h ? 4 : 1;
  const int qb = geo.tw / wb;
  const int cb = tid % qb * wb, rb = tid / qb, rs = kThreads / qb;
  const int ja = tid % geo.tw, ka = tid / geo.tw, ks = kThreads / geo.tw;
  const Walk walk_h(tid, gw / wh);
  const float* bias_t = bias + (long long)(row0 + rb) * n + cb;
  const float* hg = h + head0 * f;
  const float* ag = alpha_src + head0;
  auto load = [&](int c0, float* st) {
    float* bs = st + rb * geo.sb + cb;
    float* hs = st + kRows * geo.sb;
    float* as = hs + geo.tw * geo.sh;
    const bool cb_in = c0 + cb < n;
    const float* src = bias_t + c0;
    for (int r = row0 + rb; r < row0 + kRows; r += rs) {
      const bool ok = cb_in && r < n;
      tc::cp_async(bs, ok ? src : bias, ok, 4 * wb);
      src += (long long)rs * n;
      bs += rs * geo.sb;
    }
    for (Walk w = walk_h; w.r < geo.tw; w.next()) {
      const int c = w.c * wh, gc = c0 + w.r;
      const bool ok = gc < n;
      tc::cp_async(hs + w.r * geo.sh + c,
                   ok ? hg + (long long)gc * hf + c : h, ok, 4 * wh);
    }
    const bool ja_in = c0 + ja < n;
    const float* asrc = ag + (long long)(c0 + ja) * heads;
    for (int k = ka; k < nh; k += ks)
      tc::cp_async(as + k * geo.tw + ja, ja_in ? asrc + k : alpha_src,
                   ja_in, 4);
  };

  // h columns past the block's heads: zero in every stage (never copied)
  for (int s = 0; s < STAGES; ++s) {
    float* hs = smem + s * geo.stage + kRows * geo.sb;
    const int pad = geo.sh - gw;
    for (int i = tid; i < geo.tw * pad; i += kThreads)
      hs[i / pad * geo.sh + gw + i % pad] = 0.f;
  }

  // online-softmax state of rows 16 i + 8 hh + g; the accumulator as C
  // fragments (elements 2 hh, 2 hh + 1 of fragment [i][nf] in row half hh)
  float m[MT][2], l[MT][2], ad[MT][2], acc[MT][NF][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * i + 8 * hh + g;
      m[i][hh] = -INFINITY;
      l[i][hh] = 0.f;
      ad[i][hh] = active && row < n
                      ? alpha_dst[(long long)row * heads + head] : 0.f;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        acc[i][nf][2 * hh] = acc[i][nf][2 * hh + 1] = 0.f;
    }

  // one softmax step over the CHUNK columns at tile column cw; ragged:
  // some of them lie past n (a compile-time flag, so full steps test
  // nothing)
  auto step = [&](auto ragged, const float* bs, const float* hs,
                  const float* as, int base, int cw) {
    constexpr bool kRagged = decltype(ragged)::value;
    // scores in A-fragment order: [i][k8][a0..a3]
    float s[MT][CHUNK / 8][4], mx[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) mx[i][0] = mx[i][1] = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < CHUNK / 8; ++kk) {
      const int cl = cw + 8 * kk + 2 * t;  // k = t; cl + 1: k = t + 4
      const float2 as2 = *reinterpret_cast<const float2*>(as + cl);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 bv = *reinterpret_cast<const float2*>(
              bs + (16 * i + 8 * hh + g) * geo.sb + cl);
          float v0 = score(ad[i][hh], as2.x, bv.x);
          float v1 = score(ad[i][hh], as2.y, bv.y);
          if (kRagged) {
            v0 = base + cl < n ? v0 : -INFINITY;
            v1 = base + cl + 1 < n ? v1 : -INFINITY;
          }
          s[i][kk][hh] = v0;
          s[i][kk][2 + hh] = v1;
          mx[i][hh] = fmaxf(mx[i][hh], fmaxf(v0, v1));
        }
    }
    // the row's max over the quad; rescale its sum and accumulator
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = mx[i][hh];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float mn = fmaxf(m[i][hh], v);
        const float sc = softmax_exp(m[i][hh] - mn);   // 0 at the start
        l[i][hh] *= sc;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          acc[i][nf][2 * hh] *= sc;
          acc[i][nf][2 * hh + 1] *= sc;
        }
        m[i][hh] = mn;
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][kk][e] = softmax_exp(s[i][kk][e] - m[i][e & 1]);
          l[i][e & 1] += s[i][kk][e];
        }
    // P.H: chains of 16 columns from 0, three TF32 products per pair
#pragma unroll
    for (int kc = 0; kc < CHUNK / 8; kc += tc::kChain / 8) {
      float part[MT][NF][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][nf][e] = 0.f;
#pragma unroll
      for (int kk = kc; kk < kc + tc::kChain / 8; ++kk) {
        uint32_t p_big[MT][4], p_small[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tc::split_tf32(s[i][kk][e], p_big[i][e], p_small[i][e]);
        const float* hp = hs + (cw + 8 * kk + 2 * t) * geo.sh + hd * f + g;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          uint32_t h_big[2], h_small[2];
          tc::split_tf32(hp[8 * nf], h_big[0], h_small[0]);
          tc::split_tf32(hp[geo.sh + 8 * nf], h_big[1], h_small[1]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
#if GAT_PRODUCTS == 3
            tc::mma_tf32(part[i][nf], p_small[i], h_big);
            tc::mma_tf32(part[i][nf], p_big[i], h_small);
#endif
            tc::mma_tf32(part[i][nf], p_big[i], h_big);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nf][e] += part[i][nf][e];
    }
  };

  const int tiles = (n + geo.tw - 1) / geo.tw;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s * geo.tw, smem + s * geo.stage);
    tc::cp_async_commit();                 // one group per tile, even empty
  }
  for (int it = 0; it < tiles; ++it) {
    tc::cp_async_wait<STAGES - 2>();       // tile it has landed
    __syncthreads();                       // ... for every thread, and
                                           // tile it - 1 is consumed
    const int next = it + STAGES - 1;
    if (next < tiles)
      load(next * geo.tw, smem + next % STAGES * geo.stage);
    tc::cp_async_commit();
    if (!active) continue;
    const float* bs = smem + it % STAGES * geo.stage;
    const float* hs = bs + kRows * geo.sb;
    const float* as = hs + geo.tw * geo.sh + hd * geo.tw;
    const int base = it * geo.tw;
    for (int cw = split * wc; cw < (split + 1) * wc; cw += CHUNK) {
      if (base + cw + CHUNK <= n)
        step(std::false_type{}, bs, hs, as, base, cw);
      else if (base + cw < n)
        step(std::true_type{}, bs, hs, as, base, cw);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                         // the ring is free

  // merge the column splits of each head into split 0's state
  constexpr int kState = state_floats<MT, NF>();
  if (geo.splits > 1) {
    if (active && split > 0) {
      float* p = smem + ((split - 1) * geo.hb + hd) * kState * 32 + lane;
      int q = 0;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          p[32 * q++] = m[i][hh];
          p[32 * q++] = l[i][hh];
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[32 * q++] = acc[i][nf][e];
    }
    __syncthreads();
    if (active && split == 0) {
      for (int s2 = 1; s2 < geo.splits; ++s2) {
        const float* p =
            smem + ((s2 - 1) * geo.hb + hd) * kState * 32 + lane;
        int q = 0;
        float w1[MT][2], w2[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float m2 = p[32 * q++], l2 = p[32 * q++];
            const float mn = fmaxf(m[i][hh], m2);
            w1[i][hh] = m[i][hh] == -INFINITY ? 0.f
                                              : softmax_exp(m[i][hh] - mn);
            w2[i][hh] = m2 == -INFINITY ? 0.f : softmax_exp(m2 - mn);
            l[i][hh] = l[i][hh] * w1[i][hh] + l2 * w2[i][hh];
            m[i][hh] = mn;
          }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][nf][e] = acc[i][nf][e] * w1[i][e >> 1] +
                              p[32 * q++] * w2[i][e >> 1];
      }
    }
  }
  if (!active || split != 0) return;

  // the row sums over the quad, then the store (+ b, activation)
  float denom[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = l[i][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      denom[i][hh] = fmaxf(v, 1e-12f);
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * i + 8 * hh + g;
      if (row >= n) continue;
      float* o = out + (long long)row * hf + head * f;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = 8 * nf + 2 * t + c;
          if (q >= f) continue;
          float v = acc[i][nf][2 * hh + c] / denom[i][hh];
          if (b != nullptr) v = v + b[head * f + q];
          o[q] = apply_activation(v, act);
        }
    }
}

// Bytes of shared memory each instantiation has opted in to. A static
// variable template: internal linkage, so each library built from this
// header opts its own kernels in (a static local of the launcher would be
// one GNU-unique symbol across every such library in a process).
template <int NF, int CHUNK, int TW_MIN, int STAGES>
static size_t g_smem = 0;

template <int NF, int CHUNK, int TW_MIN, int STAGES>
cudaError_t launch_with(const float* h, const float* alpha_dst,
                        const float* alpha_src, const float* bias,
                        const float* b, float* out, int batch, int n,
                        int heads, int f, int act, cudaStream_t stream) {
  constexpr int MT = frags_m<NF>();
  constexpr int kRows = 16 * MT;
  const Geometry geo(heads, f, NF, kRows, CHUNK, TW_MIN);
  const int ring = STAGES * geo.stage;
  const int merge = (geo.splits - 1) * geo.hb * 32 * state_floats<MT, NF>();
  const size_t bytes = 4 * (size_t)(ring > merge ? ring : merge);
  size_t& sized = g_smem<NF, CHUNK, TW_MIN, STAGES>;
  if (bytes > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<NF, CHUNK, TW_MIN, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    sized = bytes;
  }
  const bool vec_bias =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const bool vec_h = f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const dim3 grid((n + kRows - 1) / kRows, (heads + geo.hb - 1) / geo.hb,
                  batch);
  attention_kernel<NF, CHUNK, TW_MIN, STAGES>
      <<<grid, kThreads, bytes, stream>>>(
      h, alpha_dst, alpha_src, bias, b, out, n, heads, f, act, vec_bias,
      vec_h);
  return cudaGetLastError();
}

// The body for NF n8 fragments a head: heads without column splits take
// 32-column softmax steps in 128-column tiles through a 2-stage ring
// where the registers allow (NF <= 2); the rest 16-column steps through
// a 3-stage ring.
template <int NF>
cudaError_t launch_nf(const float* h, const float* alpha_dst,
                      const float* alpha_src, const float* bias,
                      const float* b, float* out, int batch, int n, int heads,
                      int f, int act, cudaStream_t stream) {
  if constexpr (NF <= 2) {
    if (column_splits(heads_per_block(heads, f)) == 1)
      return launch_with<NF, 32, 128, 2>(h, alpha_dst, alpha_src, bias, b,
                                         out, batch, n, heads, f, act,
                                         stream);
  }
  return launch_with<NF, 16, 32, 3>(h, alpha_dst, alpha_src, bias, b, out,
                                    batch, n, heads, f, act, stream);
}

// Launch the attention body on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head width outside 1..kMaxF.
static inline cudaError_t launch_attention(
    const float* h, const float* alpha_dst, const float* alpha_src,
    const float* bias, const float* b, float* out, int batch, int n,
    int heads, int f, int act, cudaStream_t stream) {
  if (f < 1 || f > kMaxF || heads < 1) return cudaErrorInvalidValue;
  if (f <= 8)
    return launch_nf<1>(h, alpha_dst, alpha_src, bias, b, out, batch, n,
                           heads, f, act, stream);
  if (f <= 16)
    return launch_nf<2>(h, alpha_dst, alpha_src, bias, b, out, batch, n,
                           heads, f, act, stream);
  if (f <= 32)
    return launch_nf<4>(h, alpha_dst, alpha_src, bias, b, out, batch, n,
                           heads, f, act, stream);
  return launch_nf<8>(h, alpha_dst, alpha_src, bias, b, out, batch, n,
                         heads, f, act, stream);
}

}  // namespace gat
}  // namespace gcn_port
