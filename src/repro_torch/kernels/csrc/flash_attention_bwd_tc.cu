// flash_attention_bwd, tensor-core route: the gradient of flash_attention
// for bf16 operands at head dim 64, 96 or 128, on Hopper's wgmma and TMA.
// Given q (B, Sq, H, D), k and v (B, Skv, KV, D) and dout (B, Sq, H, D),
// it writes dq, dk and dv in bf16, dk and dv summed over the query heads
// of each KV head's group, with every option the forward takes (causal,
// sliding window, tanh softcap, scale, q_offset, Sq != Skv). fp32 (every
// D) and bf16 at D 32 keep the SIMT kernels of flash_attention_bwd.cu.
//
// Replaces no TPU kernel. The reference differentiates its attention by
// autodiff of the pure-JAX `chunked_attention` (src/repro/nn/attention.py)
// and its Pallas `flash_attention` has no VJP; its oracle here is
// `ref.flash_attention_bwd_ref`, autograd through `flash_attention_ref`.
//
// Math, per query head h, row i and key j, with raw = scale * q_i . k_j,
// s = cap * tanh(raw / cap) (or raw), s = -1e9 where the mask drops the
// key, P = softmax_j(s) (the forward's):
//   dP_ij = dout_i . v_j,   Delta_i = dout_i . O_i,
//   dS_ij = P_ij (dP_ij - Delta_i) (1 - tanh^2(raw / cap)), 0 if masked,
//   dq_i = scale sum_j dS_ij k_j,   dk_j = scale sum_{h in group, i} dS_ij q_i,
//   dv_j = sum_{h in group, i} P_ij dout_i.
// A row that no key may reach (a window past Skv) has P = 1 / Skv on every
// key and passes it to dv, as the plain version does.
//
// Design. Two launches on one stream, one warpgroup (128 threads) a CTA,
// every product wgmma m64n64k16 bf16 -> fp32 in one of the two forms of
// sm90_tc.cuh; every tile comes by TMA with the 128-byte swizzle.
//  1. dq_kernel, one CTA per (64-row q tile, head, batch), the heaviest
//     causal q tiles launched first. Q and dout are loaded once; the K and
//     V tiles (64 keys) stream through a 2-stage mbarrier ring, twice:
//     - pass 1 is the forward's main loop: S = Q K^T (ss), the online
//       softmax, O += P V (rs_t, P rounded to bf16 as the forward rounds
//       it). It ends in each row's max m, 1 / l and Delta = dout . O with O
//       the fp32 output before rounding (from the stored bf16 output Delta
//       nearly doubles dq's error against float64), written to `stats`
//       (3, B, H, Sq rounded up to 64) for launch 2; rows past Sq get 0s.
//     - pass 2: S = Q K^T and dP = dout V^T (ss, one commit group), P from
//       the row's m and 1 / l, dS in fp32, then dQ += dS K (rs_t, K
//       MN-major as V is in the forward; dS as a bf16 pair, see below).
//     A product design with dq summed from launch 2 by atomics would skip
//     pass 1's second product and pass 2's S, but would make the result
//     depend on the order the CTAs finish; this one gives each output one
//     owner CTA, so two calls are bit-equal.
//  2. dkv_kernel, one cluster of C CTAs per (64-key tile, KV head,
//     batch), key tile 0 (the heaviest under a causal mask) launched
//     first; C is the largest divisor of the GQA group up to 8, and rank r
//     of the cluster takes the r-th C-th of the group's query heads. K and
//     V are loaded once; for each of its query heads and each q tile that
//     may reach the keys (and the tiles of rows that no key may reach), Q,
//     dout and the rows' stats come through the ring, and:
//       S^T = K Q^T, dP^T = V dout^T (ss, one commit group);
//       P^T from the stats, dS^T in fp32, in registers;
//       dV += P^T dout (rs_t, P^T rounded to bf16 as the plain version's
//       weights are), dK += dS^T Q (rs_t, dS^T as a bf16 pair).
//     dK and dV stay in registers (2 x D / 2 floats a thread). At the end
//     the ranks above 0 leave their fp32 sums in their shared memory, and
//     rank 0 adds them in rank order through the cluster's distributed
//     shared memory, then scales and stores once. No atomics, and a fixed
//     order of the sums. One CTA per key tile walking the whole group
//     (the SIMT kernel's layout, and this kernel's first form) left SmolLM's key
//     tile 0 with 48 q tiles to walk against an average of 17, and took
//     0.200 ms of the call's 0.280 on an H100; the cluster cuts that walk
//     to 16 and triples the CTAs (576 at SmolLM's shape).
//  dS as a bf16 pair. The plain backward keeps dS in fp32 (it rounds dP
//  to bf16 instead). dS rounded once to bf16 before dQ and dK met the bar
//  (twice the plain version's error against float64) on most shapes but
//  not all: at gemma2's heads (B 2, S 200, 32/16 heads of 128, window 64,
//  softcap 50) dq erred 2.43 x the plain version's on an H100, and a
//  float32 emulation of that rounding on the same inputs gave the same
//  2.632e-2. So dS goes into both products as hi = bf16(dS) and lo =
//  bf16(dS - hi), two products each (the emulation: 0.72 x).
//  So the backward runs 11 products (Q K^T three times, dout V^T twice,
//  P V once more in pass 1, dS K and dS^T Q twice) where 5 would do; at
//  SmolLM's shape the 11 take 0.027 ms at the tensor cores' peak. The
//  rows' stats come into shared memory by ordinary loads one iteration
//  ahead (double-buffered).
//  Head dim 96 runs on the D 128 layout, as the forward's: the tensor maps
//  have an inner extent of 96, TMA zero-fills the 32 columns past it, the
//  products over D take the 6 k-steps of the real columns, and the three
//  products whose N is D (dV, dK, dQ) run both 64-column boxes: a third
//  more of their work and of shared memory than a true 96 (wgmma's N = 96
//  with a 64-byte-swizzled 32-column box) would take, for one layout and
//  one code path.
//
// Bound (H100 SXM): q, k, v, dout read once and dq, dk, dv written once at
// 3.35 TB/s, or the five products at 2 D operations each per reachable
// (row, key) pair at the 989 TFLOP/s of the bf16 tensor cores. What is in
// the way here: the 11 products, one warpgroup per CTA that waits for each
// product group (the SMs' other CTAs fill the gaps), the exp and the
// softcap's tanh on the SFUs, and under a causal mask the first key tiles,
// which walk every q tile.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "sm90_tc.cuh"

namespace lm_port {
namespace flash_bwd_tc {

using namespace sm90;
namespace cg = cooperative_groups;

constexpr int kRows = 64;                  // q rows or keys of a tile (m64)
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kThreads = 128;              // one warpgroup
constexpr float kMasked = -1e9f;           // the forward's NEG_INF

struct Opts {
  float scale, cap;
  int causal, window, q_offset;
};

// Shared memory of both kernels: two resident 64-row tiles (Q and dout in
// dq_kernel, K and V in dkv_kernel), a 2-stage ring of two more (K and V;
// Q and dout), the rows' stats (2 buffers of m, 1 / l, Delta) and the
// mbarriers. D is the layout's head dim (64 or 128).
template <int D>
struct Layout {
  static constexpr int kDBoxes = D / kBox;        // 64-column boxes of D
  static constexpr int kTile = kRows * D * 2;     // one 64-row bf16 tile
  static constexpr int kRes0 = 0;
  static constexpr int kRes1 = kTile;
  static constexpr int kRing0 = 2 * kTile;        // + stage * kTile
  static constexpr int kRing1 = 4 * kTile;        // + stage * kTile
  static constexpr int kStats = 6 * kTile;        // 2 x 3 x 64 floats
  static constexpr int kBar = kStats + 2 * 3 * kRows * 4;   // 3 mbarriers
  static constexpr int kBytes = kBar + 64 + 1024;           // + alignment
};

// One 64-row tile of a rank-4 map (all D / 64 boxes) into `dst`.
template <int NB>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int head, int row,
                                          int batch) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
    tma_load(dst + c * kRows * kBoxRowBytes, m, bar, c * kBox, head, row,
             batch);
}

// d = A B^T over the DR / 16 k-steps of the real columns, A and B 64-row
// tiles in shared memory (K-major: D is contiguous in each).
template <int DR>
__device__ __forceinline__ void mm_abt(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < DR / 16; ++ks) {
    const uint32_t off = (ks / 4) * kRows * kBoxRowBytes + (ks % 4) * 32;
    wgmma_ss(d, make_desc(a + off, 16, 1024), make_desc(b + off, 16, 1024),
             ks > 0);
  }
}

// d[c] += P B[:, 64c : 64c + 64] for each box c: P (64 x 64) the m64
// accumulator fragment as the A fragment, rounded to bf16 or, with SPLIT,
// as the bf16 pair hi = bf16(P), lo = bf16(P - hi), lo's product first
// (P to about 16 bits for two products); B a 64-row tile in shared memory
// read MN-major (its rows are the k dimension).
template <int NB, bool SPLIT = false>
__device__ __forceinline__ void mm_pb(float (&d)[NB][32], const float (&p)[32],
                                      uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = p[8 * ks + 2 * i], x1 = p[8 * ks + 2 * i + 1];
      hi[i] = pack_bf16(x0, x1);
      if constexpr (SPLIT) {
        const float2 h = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hi[i]));
        lo[i] = pack_bf16(x0 - h.x, x1 - h.y);
      }
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      // 16 rows of 128 bytes: 8-row groups 1024 bytes apart (both offsets,
      // so the MN-major descriptor reads them either way)
      const uint64_t db = make_desc(
          b + c * kRows * kBoxRowBytes + ks * 16 * kBoxRowBytes, 1024, 1024);
      if constexpr (SPLIT) wgmma_rs_t(d[c], lo, db);
      wgmma_rs_t(d[c], hi, db);
    }
  }
}

// The score of (query position qpos, key) from its raw product, as the
// forward computes it (scaled after the product, capped, masked to -1e9 as
// a number), and in *dcap the cap's derivative, 0 where the mask drops the
// key.
__device__ __forceinline__ float score(float dot, const Opts& o, float* dcap) {
  float sc = dot * o.scale;
  float deriv = 1.f;
  if (o.cap > 0.f) {
    const float t = tanhf(sc / o.cap);
    sc = t * o.cap;
    deriv = 1.f - t * t;
  }
  *dcap = deriv;
  return sc;
}
__device__ __forceinline__ bool allowed(int qpos, int key, const Opts& o) {
  return (!o.causal || key <= qpos) && (o.window <= 0 || key > qpos - o.window);
}

__device__ __forceinline__ void init_bars(uint32_t bar0) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

template <int DR, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const __nv_bfloat16* __restrict__ dout,
              __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
              int batch, int sq, int sq_pad, int skv, int heads,
              int kv_heads, Opts o) {
  using L = Layout<D>;
  constexpr int NB = L::kDBoxes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_addr = base + L::kRes0, do_addr = base + L::kRes1;
  const uint32_t bar_res = base + L::kBar, bar_ring = bar_res + 8;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hd = blockIdx.x, bz = blockIdx.y;
  const int kh = hd / (heads / kv_heads);
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heaviest first

  // the keys some row of this tile may reach (the forward's tile skip)
  const int rows = min(kRows, sq - r0);
  const int q_lo = o.q_offset + r0, q_hi = q_lo + rows - 1;
  int k_lo = 0, k_hi = skv - 1;
  const bool unreachable_row = o.window > 0 && q_hi - o.window + 1 > skv - 1;
  if (!unreachable_row) {
    if (o.causal) k_hi = min(k_hi, q_hi);
    if (o.window > 0) k_lo = max(0, q_lo - o.window + 1);
  }
  const int t_lo = k_lo / kRows, n_tiles = k_hi / kRows - t_lo + 1;

  // iteration i (of 2 n_tiles: the two passes) reads key tile
  // t_lo + i % n_tiles from stage i % 2
  auto load_kv = [&](int i) {
    const int stage = i % 2;
    const uint32_t bar = bar_ring + 8 * stage;
    const int j0 = (t_lo + i % n_tiles) * kRows;
    mbar_expect_tx(bar, 2 * L::kTile);
    load_tile<NB>(base + L::kRing0 + stage * L::kTile, &tk, bar, kh, j0, bz);
    load_tile<NB>(base + L::kRing1 + stage * L::kTile, &tv, bar, kh, j0, bz);
  };
  init_bars(bar_res);
  if (tid == 0) {
    mbar_expect_tx(bar_res, 2 * L::kTile);
    load_tile<NB>(q_addr, &tq, bar_res, hd, r0, bz);
    load_tile<NB>(do_addr, &tdo, bar_res, hd, r0, bz);
    load_kv(0);
  }

  // this thread's rows of the m64 fragment: ra and ra + 8
  const int ra = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qpos[2] = {q_lo + ra, q_lo + ra + 8};
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[NB][32], s[32], dp[32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;

  mbar_wait(bar_res, 0);
  // ---- pass 1: the forward's online softmax, O in fp32
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % 2;
    if (tid == 0) load_kv(i + 1);          // pass 2 follows: always a next
    mbar_wait(bar_ring + 8 * stage, (i / 2) & 1);
    const uint32_t k_addr = base + L::kRing0 + stage * L::kTile;
    const uint32_t v_addr = base + L::kRing1 + stage * L::kTile;
    const int j0 = (t_lo + i) * kRows;

    wgmma_fence();
    mm_abt<DR>(s, q_addr, k_addr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool edge = unreachable_row || j0 + kRows > skv ||
                      (o.causal && j0 + kRows - 1 > q_lo) ||
                      (o.window > 0 && j0 <= q_hi - o.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      const int key = j0 + 8 * (e >> 2) + cq + (e & 1);
      float dcap;
      float sc = score(s[e], o, &dcap);
      if (edge) {
        sc = allowed(qpos[r], key, o) ? sc : kMasked;
        sc = key < skv ? sc : -INFINITY;
      }
      s[e] = sc;
      mx[r] = fmaxf(mx[r], sc);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      const float p = expf(s[e] - m[r]);
      l[r] += p;
      s[e] = p;
    }
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];

#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
    wgmma_fence();
    mm_pb<NB>(acc, s, v_addr);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
    __syncthreads();                       // this stage is free for a reload
  }

  // ---- the rows' stats: m, 1 / l, Delta = dout . O / l
  float inv_l[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv_l[r] = 1.f / fmaxf(l[r], 1e-12f);
    const int qi = r0 + ra + 8 * r;
    float part = 0.f;
    if (qi < sq) {
      const __nv_bfloat16* row = dout + (((size_t)bz * sq + qi) * heads + hd) * DR;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c * kBox + 8 * j >= DR) continue;    // the zero-filled columns
          const int e = 4 * j + 2 * r;
          const float2 g = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + c * kBox +
                                                       8 * j + cq));
          part = fmaf(g.x, acc[c][e], fmaf(g.y, acc[c][e + 1], part));
        }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta[r] = part * inv_l[r];
    if (lane % 4 == 0) {
      const size_t plane = (size_t)batch * heads * sq_pad;
      const size_t at = ((size_t)bz * heads + hd) * sq_pad + qi;
      const bool valid = qi < sq;
      stats[at] = valid ? m[r] : 0.f;
      stats[plane + at] = valid ? inv_l[r] : 0.f;
      stats[2 * plane + at] = valid ? delta[r] : 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;   // from here on: dq's sum

  // ---- pass 2: dq = scale * sum_j dS_ij k_j over the same tiles
  for (int i = n_tiles; i < 2 * n_tiles; ++i) {
    const int stage = i % 2;
    if (tid == 0 && i + 1 < 2 * n_tiles) load_kv(i + 1);
    mbar_wait(bar_ring + 8 * stage, (i / 2) & 1);
    const uint32_t k_addr = base + L::kRing0 + stage * L::kTile;
    const uint32_t v_addr = base + L::kRing1 + stage * L::kTile;
    const int j0 = (t_lo + i - n_tiles) * kRows;

    wgmma_fence();
    mm_abt<DR>(s, q_addr, k_addr);
    mm_abt<DR>(dp, do_addr, v_addr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = unreachable_row || j0 + kRows > skv ||
                      (o.causal && j0 + kRows - 1 > q_lo) ||
                      (o.window > 0 && j0 <= q_hi - o.window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      const int key = j0 + 8 * (e >> 2) + cq + (e & 1);
      float dcap;
      const float sc = score(s[e], o, &dcap);
      const float p = expf(sc - m[r]) * inv_l[r];
      s[e] = edge && !(allowed(qpos[r], key, o) && key < skv)
                 ? 0.f                                // no score gradient
                 : p * (dp[e] - delta[r]) * dcap;     // dS
    }

#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
    wgmma_fence();
    mm_pb<NB, true>(acc, s, k_addr);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
    __syncthreads();
  }

  // ---- dq in bf16, rows < Sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + ra + 8 * r;
    if (qi >= sq) continue;
    __nv_bfloat16* row = dq + (((size_t)bz * sq + qi) * heads + hd) * DR;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c * kBox + 8 * j >= DR) continue;
        const int e = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(row + c * kBox + 8 * j + cq) =
            __floats2bfloat162_rn(acc[c][e] * o.scale,
                                  acc[c][e + 1] * o.scale);
      }
  }
}

template <int DR, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int batch, int sq, int sq_pad,
               int skv, int heads, int kv_heads, int csz, Opts o) {
  using L = Layout<D>;
  constexpr int NB = L::kDBoxes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_addr = base + L::kRes0, v_addr = base + L::kRes1;
  const uint32_t bar_res = base + L::kBar, bar_ring = bar_res + 8;
  float* st_smem = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::kStats);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // a cluster of csz CTAs shares the key tile; rank r takes the r-th
  // share of the GQA group's query heads
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int kvh = blockIdx.x / csz, bz = blockIdx.y;
  const int my_heads = heads / kv_heads / csz;
  const int h0 = kvh * (heads / kv_heads) + rank * my_heads;
  const int j0 = blockIdx.z * kRows;       // key tile 0, the heaviest, first
  const int j1 = min(j0 + kRows, skv) - 1;

  // the q rows that some key of this tile may reach, [i_lo, i_hi], and
  // from i_un on the rows that no key may reach (they average every key);
  // as q tiles: [qa, qb) then [qc, n_qt)
  const int n_qt = sq_pad / kRows;
  const int i_lo = o.causal ? max(0, j0 - o.q_offset) : 0;
  const int i_hi = o.window > 0 ? min(sq - 1, j1 + o.window - 1 - o.q_offset)
                                : sq - 1;
  const int i_un = o.window > 0 ? max(0, skv + o.window - 1 - o.q_offset)
                                : sq;
  int qa = 0, qb = 0;
  if (i_lo <= i_hi) {
    qa = i_lo / kRows;
    qb = i_hi / kRows + 1;
  }
  const int qc = i_un < sq ? max(qb, i_un / kRows) : n_qt;   // i_un > i_lo
  const int n_visit = (qb - qa) + max(0, n_qt - qc);
  const int n_iter = my_heads * n_visit;
  // iteration it: query head h0 + it / n_visit, q tile tile_of(it)
  auto tile_of = [&](int it) {
    const int t = it % n_visit;
    return t < qb - qa ? qa + t : qc + t - (qb - qa);
  };
  auto head_of = [&](int it) { return h0 + it / n_visit; };
  auto load_q = [&](int it) {
    const int stage = it % 2;
    const uint32_t bar = bar_ring + 8 * stage;
    mbar_expect_tx(bar, 2 * L::kTile);
    load_tile<NB>(base + L::kRing0 + stage * L::kTile, &tq, bar, head_of(it),
                  tile_of(it) * kRows, bz);
    load_tile<NB>(base + L::kRing1 + stage * L::kTile, &tdo, bar,
                  head_of(it), tile_of(it) * kRows, bz);
  };
  const size_t plane = (size_t)batch * heads * sq_pad;
  auto load_stats = [&](int it) {          // into buffer it % 2
    const float* src =
        stats + ((size_t)bz * heads + head_of(it)) * sq_pad + tile_of(it) * kRows;
    float* dst = st_smem + (it % 2) * 3 * kRows;
    for (int e = tid; e < 3 * kRows; e += kThreads)
      dst[e] = src[(e / kRows) * plane + e % kRows];
  };

  init_bars(bar_res);
  if (tid == 0) {
    mbar_expect_tx(bar_res, 2 * L::kTile);
    load_tile<NB>(k_addr, &tk, bar_res, kvh, j0, bz);
    load_tile<NB>(v_addr, &tv, bar_res, kvh, j0, bz);
    if (n_iter > 0) load_q(0);
  }
  if (n_iter > 0) load_stats(0);
  __syncthreads();

  // this thread's keys of the m64 fragment: ra and ra + 8
  const int ra = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int keys[2] = {j0 + ra, j0 + ra + 8};
  float dka[NB][32], dva[NB][32], s[32], dp[32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[c][e] = dva[c][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;

  mbar_wait(bar_res, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % 2;
    if (it + 1 < n_iter) {
      if (tid == 0) load_q(it + 1);
      load_stats(it + 1);                  // read after this iteration's sync
    }
    mbar_wait(bar_ring + 8 * stage, (it / 2) & 1);
    const uint32_t q_addr = base + L::kRing0 + stage * L::kTile;
    const uint32_t do_addr = base + L::kRing1 + stage * L::kTile;
    const float* st = st_smem + stage * 3 * kRows;   // m, 1 / l, Delta
    const int qpos0 = o.q_offset + tile_of(it) * kRows;

    // S^T = K Q^T and dP^T = V dout^T
    wgmma_fence();
    mm_abt<DR>(s, k_addr, q_addr);
    mm_abt<DR>(dp, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = j0 + kRows > skv ||
                      (o.causal && j0 + kRows - 1 > qpos0) ||
                      (o.window > 0 && j0 <= qpos0 + kRows - 1 - o.window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = keys[(e >> 1) & 1];
      const int col = 8 * (e >> 2) + cq + (e & 1);   // the q row in the tile
      float dcap;
      float sc = score(s[e], o, &dcap);
      float p;
      if (edge && !(allowed(qpos0 + col, key, o) && key < skv)) {
        // a dropped key: P only in a row that no key may reach (m = -1e9),
        // and never past Skv; no score gradient
        p = key < skv ? expf(kMasked - st[col]) * st[kRows + col] : 0.f;
        dcap = 0.f;
      } else {
        p = expf(sc - st[col]) * st[kRows + col];
      }
      s[e] = p;
      dp[e] = p * (dp[e] - st[2 * kRows + col]) * dcap;   // dS^T
    }

    // dV += P^T dout, dK += dS^T Q
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      fence_regs(dva[c]);
      fence_regs(dka[c]);
    }
    wgmma_fence();
    mm_pb<NB>(dva, s, do_addr);
    mm_pb<NB, true>(dka, dp, q_addr);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      fence_regs(dva[c]);
      fence_regs(dka[c]);
    }
    __syncthreads();                       // stage and stats buffer free
  }

  // ---- the cluster's sum: rank 0 adds the other ranks' fp32 dK and dV in
  // rank order, read from their shared memory (the ring, free now: 4 tiles
  // of 64 x D bf16 hold a thread's D / 2 floats of each, 128 threads)
  if (csz > 1) {
    constexpr int kAcc = NB * 32;
    float* red = reinterpret_cast<float*>(
        smem_raw + (base - smem_u32(smem_raw)) + L::kRing0);
    static_assert(2 * kAcc * kThreads * 4 <= L::kStats - L::kRing0,
                  "dK and dV fit the ring");
    if (rank > 0) {
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          red[(c * 32 + e) * kThreads + tid] = dka[c][e];
          red[(kAcc + c * 32 + e) * kThreads + tid] = dva[c][e];
        }
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < csz; ++r) {
        const float* src = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            dka[c][e] += src[(c * 32 + e) * kThreads + tid];
            dva[c][e] += src[(kAcc + c * 32 + e) * kThreads + tid];
          }
      }
    }
    cluster.sync();                        // the ranks' memory stays till read
    if (rank > 0) return;
  }

  // ---- dk (times scale) and dv in bf16, keys < Skv
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= skv) continue;
    const size_t at = (((size_t)bz * skv + keys[r]) * kv_heads + kvh) * DR;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c * kBox + 8 * j >= DR) continue;
        const int e = 4 * j + 2 * r;
        const int col = c * kBox + 8 * j + cq;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
            __floats2bfloat162_rn(dka[c][e] * o.scale,
                                  dka[c][e + 1] * o.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(dva[c][e], dva[c][e + 1]);
      }
  }
}

// --------------------------------------------------------------- the host
struct Maps {
  CUtensorMap q, k, v, dout;
};

// Whether each kernel has opted in to more than 48 KB of shared memory,
// one slot per instantiation (by DR: 64, 96, 128 -> 0, 1, 2).
static bool g_sized[3] = {false, false, false};

template <int DR, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int batch, int sq, int skv, int heads,
                   int kv_heads, const Opts& o, cudaStream_t stream) {
  using L = Layout<D>;
  constexpr int kSlot = DR / 32 - 2;
  static_assert(DR % 32 == 0 && kSlot >= 0 && kSlot < 3 && DR <= D,
                "head dim 64, 96 or 128");
  cudaError_t err = cudaSuccess;
  if (!g_sized[kSlot]) {
    err = cudaFuncSetAttribute(dq_kernel<DR, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkv_kernel<DR, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::kBytes);
    if (err != cudaSuccess) return err;
    g_sized[kSlot] = true;
  }
  Maps m;
  err = encode(&m.q, q, batch, sq, heads, DR, kRows);
  if (err == cudaSuccess) err = encode(&m.dout, dout, batch, sq, heads, DR, kRows);
  if (err == cudaSuccess) err = encode(&m.k, k, batch, skv, kv_heads, DR, kRows);
  if (err == cudaSuccess) err = encode(&m.v, v, batch, skv, kv_heads, DR, kRows);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kRows - 1) / kRows, n_kt = (skv + kRows - 1) / kRows;
  const int sq_pad = n_qt * kRows;
  dq_kernel<DR, D><<<dim3(heads, batch, n_qt), kThreads, L::kBytes, stream>>>(
      m.q, m.k, m.v, m.dout, (const __nv_bfloat16*)dout, (__nv_bfloat16*)dq,
      stats, batch, sq, sq_pad, skv, heads, kv_heads, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the cluster: the largest divisor of the GQA group up to kMaxCluster
  const int group = heads / kv_heads;
  int csz = 1;
  for (int c = kMaxCluster; c > 1 && csz == 1; --c)
    if (group % c == 0) csz = c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kv_heads * csz, batch, n_kt);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csz;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dkv_kernel<DR, D>, m.q, m.k, m.v, m.dout,
                           (const float*)stats, (__nv_bfloat16*)dk,
                           (__nv_bfloat16*)dv, batch, sq, sq_pad, skv, heads,
                           kv_heads, csz, o);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace flash_bwd_tc
}  // namespace lm_port

// q, dout, dq: (batch, sq, heads, head_dim); k, v, dk, dv: (batch, skv,
// kv_heads, head_dim); all contiguous bf16 with 16-byte-aligned base
// addresses, on CUDA ordinal `device` with `stream`; stats: (3, batch,
// heads, sq rounded up to 64) fp32 scratch. sq and skv >= 1. `window` 0
// means none, `softcap` 0 none. Returns cudaGetLastError() after the
// launches, or an error for a head_dim other than 64, 96 or 128 or a
// tensor map the driver refuses.
extern "C" int flash_attention_bwd_tc(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      void* dq, void* dk, void* dv,
                                      void* stats, int batch, int sq, int skv,
                                      int heads, int kv_heads, int head_dim,
                                      int causal, int window, int q_offset,
                                      float scale, float softcap, int device,
                                      void* stream) {
  using namespace lm_port::flash_bwd_tc;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const Opts o{scale, softcap, causal, window, q_offset};
  float* st = (float*)stats;
  switch (head_dim) {
    case 64:
      return (int)launch<64, 64>(q, k, v, dout, dq, dk, dv, st, batch, sq,
                                 skv, heads, kv_heads, o, s);
    case 96:
      return (int)launch<96, 128>(q, k, v, dout, dq, dk, dv, st, batch, sq,
                                  skv, heads, kv_heads, o, s);
    case 128:
      return (int)launch<128, 128>(q, k, v, dout, dq, dk, dv, st, batch, sq,
                                   skv, heads, kv_heads, o, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
