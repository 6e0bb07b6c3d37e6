// flash_attention, tensor-core route: GQA attention of the LM prefill for
// bf16 operands at head dim 64, 96 or 128, fp32 softmax statistics and
// accumulator, on Hopper's wgmma and TMA:
//   out[b, i, h, :] = sum_j softmax_j(s[i, j]) * v[b, j, h / group, :]
//   s[i, j] = cap(scale * q[b, i, h, :] . k[b, j, h / group, :]), masked
// with -1e9 where key j lies past the causal frontier (j > q_offset + i) or
// outside the window (j <= q_offset + i - window); keys past Skv are never
// counted.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_flash_kernel`, pallas_call at :113) on the bf16
// serving path; fp32 (and head dim 32) keep the SIMT kernel of
// flash_attention.cu. The TPU kernel carries the accumulator and running
// statistics in VMEM across an in-order KV grid axis; here the KV sweep is
// a loop inside one CTA per (64-row q tile, head, batch).
//
// Design. One warpgroup (128 threads) per CTA.
//  - Q (64 x D) is loaded once by TMA into shared memory with the 128-byte
//    swizzle; K and V tiles (128 keys at D 64, 64 at D 128) come through a
//    2-stage ring, each stage a TMA load whose completion is reported to
//    the stage's mbarrier. The next tile's load is issued before the
//    current tile's products. A box is at most 64 bf16 wide under the
//    128-byte swizzle, so a D 128 tile is two 64-column boxes, and the
//    wgmma descriptors step from one box to the next.
//  - S = Q K^T is wgmma m64n64k16 bf16 -> fp32, both operands from shared
//    memory and K-major (D is contiguous in each): D/16 k-steps per 64
//    keys, the k-step advancing the descriptor 32 bytes inside the swizzle
//    row.
//  - The online softmax runs on the accumulator fragment: a thread holds
//    parts of rows r and r + 8; the row max finishes with two shuffles
//    across the quad. As the TPU kernel: scale after the product, then the
//    tanh cap, then the mask to -1e9 as a number; keys past Skv (which TMA
//    fills with zeros) are set to -inf; the running max starts at -1e9; l
//    adds the fp32 p, the accumulator p rounded to bf16 times v.
//  - O += P V is wgmma m64n64k16 with A = P in registers (the m64
//    accumulator fragment is the A-register fragment, so P never touches
//    shared memory) and B = the V tile, MN-major (D contiguous), so the
//    transpose bit is set. O is rescaled by exp(m_old - m_new) between
//    tiles, after wgmma.wait_group.
//  - Tile skip, as the SIMT kernel: a CTA visits only the key tiles that
//    some row of its tile may reach; a CTA holding a row that no key may
//    reach visits every tile, and that row averages every key. Only tiles
//    that cross the causal diagonal, the window edge or Skv are masked
//    element by element.
//  - Store: acc / max(l, 1e-12) in bf16, rows < Sq only; Sq and Skv are
//    taken as they are.
//  - Head dim 96 (Phi-3-vision) runs on the D 128 layout: the tensor maps
//    have an inner extent of 96, so the second 64-column box of each Q, K
//    and V tile reads 32 real columns and TMA fills the 32 past them with
//    zeros. S = Q K^T takes only the 6 k-steps of the real columns; P V
//    runs both boxes, and the epilogue stores 96 columns of each row. That
//    costs a third more P V work and shared memory than a true 96.
//
// Bound (H100 SXM): q, k, v read once and out written once at 3.35 TB/s,
// or 4 * D operations per reachable (row, key) pair at the 989 TFLOP/s of
// the bf16 tensor cores. Both products now run there; what is left in the
// way is the softmax between them (its expf on the SFUs) and one
// warpgroup per CTA that waits for each product: overlapping the softmax
// of one tile with the products of the next (two consumer warpgroups, a
// producer warp) is the step after this one. The GQA group's query heads
// each read their KV head's tiles, and L2 serves the re-reads.
#include <math.h>
#include <stdint.h>

#include "sm90_tc.cuh"

namespace lm_port {
namespace flash_tc {

using namespace sm90;

constexpr int kRows = 64;                  // q rows per CTA (one m64)
constexpr int kThreads = 128;              // one warpgroup
constexpr float kMasked = -1e9f;           // the TPU kernel's NEG_INF

// D: the head dim of the layout (64 or 128); KK: keys per tile (128 at D
// 64, 64 at D 128).
template <int D, int KK>
struct Layout {
  static constexpr int kDBoxes = D / kBox;        // 64-column boxes of D
  static constexpr int kKeyHalves = KK / 64;      // n64 products per tile
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = KK * D * 2;   // one of K or V
  static constexpr int kStages = 2;
  static constexpr int kQ = 0;                             // offsets from
  static constexpr int kK = kQBytes;                       // the 1024-aligned
  static constexpr int kV = kK + kStages * kTileBytes;     // base
  static constexpr int kBar = kV + kStages * kTileBytes;   // 3 mbarriers
  static constexpr int kBytes = kBar + 64 + 1024;          // + alignment
};

// DR: the operands' head dim (64, 96 or 128), D: the layout's (DR rounded
// up to a whole 64-column box).
template <int DR, int D, int KK>
__global__ void __launch_bounds__(kThreads)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, int sq, int skv,
                    int heads, int kv_heads, float scale, float cap,
                    int causal, int window, int q_offset) {
  using L = Layout<D, KK>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq_addr = base + L::kQ;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_kv0 = bar_q + 8;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hd = blockIdx.y, bz = blockIdx.z;
  const int kh = hd / (heads / kv_heads);
  const int r0 = blockIdx.x * kRows;

  // the keys some row of this tile may reach
  const int rows = min(kRows, sq - r0);
  const int q_lo = q_offset + r0, q_hi = q_lo + rows - 1;
  int k_lo = 0, k_hi = skv - 1;
  const bool unreachable_row = window > 0 && q_hi - window + 1 > skv - 1;
  if (!unreachable_row) {
    if (causal) k_hi = min(k_hi, q_hi);
    if (window > 0) k_lo = max(0, q_lo - window + 1);
  }
  const int t_lo = k_lo / KK, n_tiles = k_hi / KK - t_lo + 1;

  auto load_kv = [&](int i) {              // tile t_lo + i into its stage
    const int stage = i % L::kStages;
    const uint32_t bar = bar_kv0 + 8 * stage;
    const int j0 = (t_lo + i) * KK;
    mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kDBoxes; ++c) {
      const uint32_t off = stage * L::kTileBytes + c * KK * kBoxRowBytes;
      tma_load(base + L::kK + off, &tk, bar, c * kBox, kh, j0, bz);
      tma_load(base + L::kV + off, &tv, bar, c * kBox, kh, j0, bz);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) mbar_init(bar_kv0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kDBoxes; ++c)
      tma_load(sq_addr + c * kRows * kBoxRowBytes, &tq, bar_q, c * kBox, hd,
               r0, bz);
    load_kv(0);
  }

  // this thread's rows of the m64 fragment: ra and ra + 8
  const int ra = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qpos[2] = {q_lo + ra, q_lo + ra + 8};
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[L::kDBoxes][32];
#pragma unroll
  for (int c = 0; c < L::kDBoxes; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float s[L::kKeyHalves][32];
#pragma unroll
  for (int h = 0; h < L::kKeyHalves; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[h][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % L::kStages;
    if (tid == 0 && i + 1 < n_tiles) load_kv(i + 1);   // ahead of the math
    mbar_wait(bar_kv0 + 8 * stage, (i / L::kStages) & 1);
    const uint32_t k_addr = base + L::kK + stage * L::kTileBytes;
    const uint32_t v_addr = base + L::kV + stage * L::kTileBytes;
    const int j0 = (t_lo + i) * KK;

    // ---- S = Q K^T: per 64-key half, D/16 k-steps
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < L::kKeyHalves; ++h) {
#pragma unroll
      for (int ks = 0; ks < DR / 16; ++ks) {
        const int box = ks / 4, within = (ks % 4) * 32;
        const uint64_t da = make_desc(
            sq_addr + box * kRows * kBoxRowBytes + within, 16, 1024);
        const uint64_t db = make_desc(
            k_addr + box * KK * kBoxRowBytes + h * 64 * kBoxRowBytes + within,
            16, 1024);
        wgmma_ss(s[h], da, db, ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < L::kKeyHalves; ++h) fence_regs(s[h]);

    // ---- online softmax on the fragment
    const bool edge = unreachable_row || j0 + KK > skv ||
                      (causal && j0 + KK - 1 > q_lo) ||
                      (window > 0 && j0 <= q_hi - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int h = 0; h < L::kKeyHalves; ++h) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;            // row ra (0) or ra + 8 (1)
        const int key = j0 + 64 * h + 8 * (e >> 2) + cq + (e & 1);
        float sc = s[h][e] * scale;
        if (cap > 0.f) sc = tanhf(sc / cap) * cap;
        if (edge) {
          const bool allowed = (!causal || key <= qpos[r]) &&
                               (window <= 0 || key > qpos[r] - window);
          sc = allowed ? sc : kMasked;
          sc = key < skv ? sc : -INFINITY;
        }
        s[h][e] = sc;
        mx[r] = fmaxf(mx[r], sc);
      }
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
    for (int h = 0; h < L::kKeyHalves; ++h) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        const float p = expf(s[h][e] - m[r]);
        l[r] += p;
        s[h][e] = p;
      }
    }
#pragma unroll
    for (int c = 0; c < L::kDBoxes; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];

    // ---- O += P V: per 64-column box of D, KK/16 k-steps over the keys
#pragma unroll
    for (int c = 0; c < L::kDBoxes; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KK / 16; ++ks) {
      const int h = ks / 4, b8 = 8 * (ks % 4);
      const uint32_t a[4] = {pack_bf16(s[h][b8 + 0], s[h][b8 + 1]),
                             pack_bf16(s[h][b8 + 2], s[h][b8 + 3]),
                             pack_bf16(s[h][b8 + 4], s[h][b8 + 5]),
                             pack_bf16(s[h][b8 + 6], s[h][b8 + 7])};
#pragma unroll
      for (int c = 0; c < L::kDBoxes; ++c) {
        // 16 keys of 128-byte rows: 8-key groups 1024 bytes apart (both
        // offsets, so the MN-major descriptor reads them either way)
        const uint64_t db = make_desc(
            v_addr + c * KK * kBoxRowBytes + ks * 16 * kBoxRowBytes, 1024,
            1024);
        wgmma_rs_t(o[c], a, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < L::kDBoxes; ++c) fence_regs(o[c]);
    __syncthreads();                   // this stage is free for a reload
  }

  // ---- out = acc / max(l, 1e-12) in bf16, rows < Sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-12f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + ra + 8 * r;
    if (qi >= sq) continue;
    __nv_bfloat16* row = out + (((size_t)bz * sq + qi) * heads + hd) * DR;
#pragma unroll
    for (int c = 0; c < L::kDBoxes; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c * kBox + 8 * j >= DR) continue;      // the zero-filled columns
        const int e = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(row + c * kBox + 8 * j + cq) =
            __floats2bfloat162_rn(o[c][e] / l[r], o[c][e + 1] / l[r]);
      }
  }
}

// --------------------------------------------------------------- the host
struct Maps {
  CUtensorMap q, k, v;
};

template <int DR, int KK>
cudaError_t encode_maps(Maps* m, const void* q, const void* k, const void* v,
                        int batch, int sq, int skv, int heads, int kv_heads) {
  cudaError_t err = encode(&m->q, q, batch, sq, heads, DR, kRows);
  if (err == cudaSuccess) err = encode(&m->k, k, batch, skv, kv_heads, DR, KK);
  if (err == cudaSuccess) err = encode(&m->v, v, batch, skv, kv_heads, DR, KK);
  return err;
}

// Whether the kernel has opted in to more than 48 KB of shared memory, one
// slot per instantiation (by DR: 64, 96, 128 -> 0, 1, 2). Internal linkage
// on purpose: a static local of the template below would be one symbol
// (GNU unique) across every library in the process that instantiates it.
static bool g_sized[3] = {false, false, false};

template <int DR, int D, int KK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int sq, int skv, int heads, int kv_heads,
                   float scale, float cap, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  using L = Layout<D, KK>;
  constexpr int kSlot = DR / 32 - 2;
  static_assert(DR % 32 == 0 && kSlot >= 0 && kSlot < 3 && DR <= D,
                "head dim 64, 96 or 128");
  if (!g_sized[kSlot]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DR, D, KK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    g_sized[kSlot] = true;
  }
  Maps m;
  const cudaError_t err =
      encode_maps<DR, KK>(&m, q, k, v, batch, sq, skv, heads, kv_heads);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  flash_tc_kernel<DR, D, KK><<<grid, kThreads, L::kBytes, stream>>>(
      m.q, m.k, m.v, (__nv_bfloat16*)out, sq, skv, heads, kv_heads, scale,
      cap, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace flash_tc
}  // namespace lm_port

// q, out: (batch, sq, heads, head_dim); k, v: (batch, skv, kv_heads,
// head_dim); all contiguous bf16 with 16-byte-aligned base addresses, on
// CUDA ordinal `device` with `stream`. `window` 0 means none, `softcap` 0
// none. Returns cudaGetLastError() after the launch, or an error for a
// head_dim other than 64, 96 or 128 or a tensor map the driver refuses.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int sq, int skv, int heads,
                                      int kv_heads, int head_dim, int causal,
                                      int window, int q_offset, float scale,
                                      float softcap, int device,
                                      void* stream) {
  using namespace lm_port::flash_tc;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return (int)launch<64, 64, 128>(q, k, v, out, batch, sq, skv, heads,
                                      kv_heads, scale, softcap, causal,
                                      window, q_offset, s);
    case 96:
      return (int)launch<96, 128, 64>(q, k, v, out, batch, sq, skv, heads,
                                      kv_heads, scale, softcap, causal,
                                      window, q_offset, s);
    case 128:
      return (int)launch<128, 128, 64>(q, k, v, out, batch, sq, skv, heads,
                                       kv_heads, scale, softcap, causal,
                                       window, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
