// Shared GAT attention body for the port's three GAT kernels (sm_90a).
//
//   out[z, i, hd, :] = act( sum_j softmax_j(s[i, j]) * h[z, j, hd, :]
//                           + b[hd, :] )
//   s[i, j] = leaky_0.2(alpha_dst[z, i, hd] + alpha_src[z, j, hd])
//             + bias[z, i, j]                       (bias: 0 or -1e9)
//
// h is read in its (n, heads, f) layout, heads interleaved, with f and
// heads as runtime ints: nothing is padded to the TPU's 128 lanes.
//
// The TPU kernels hold one head's whole (bm, n) score strip in VMEM (1.5 MB
// at bm = 128, n = 3072); a block here has at most 227 KB of shared
// memory, so the strip is never formed. One 256-thread block owns a strip
// of 32 rows and a group of up to 8 heads, walks the n columns in tiles of
// 64, and stages each tile's bias (32 x 64), alpha_src and h rows in
// shared memory. Per (row, head) a thread keeps an online softmax in
// registers: a running max m, a running sum l and an f-wide accumulator,
// rescaled by expf(m_old - m_new) once per 8 columns; the result is
// acc / max(l, 1e-12). Eight thread slots serve each row: heads x column
// splits (one head per slot and no split at 8 heads; 8 splits of the
// columns at one head, merged at the end by warp shuffles), so a block
// stays 256 threads wide whatever the head count.
//
// Bias reads: the TPU grid (head, row block) re-reads the (bm, n) bias
// strip once per head, 8x the largest operand at 8 heads. Here the strip
// is read once per group of 8 heads: once per layer for heads <= 8.
//
// Arithmetic order, as the reference: e = alpha_dst[i] + alpha_src[j];
// leaky as e >= 0 ? e : 0.2f * e; + bias; then the max-subtracted expf.
// The mask is -1e9, not -inf: a padded row (no self-loop, all its bias
// -1e9) gets the reference's uniform weights, finite, never NaN. Only
// columns past n (a ragged tile) are dropped, as -inf, and a step whose
// columns all lie past n is skipped, so the running max is finite after
// the first real column.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "activation.cuh"

namespace gcn_port {
namespace gat {

constexpr int kRows = 32;                  // rows of a block's strip
constexpr int kSlots = 8;                  // thread slots per row
constexpr int kThreads = kRows * kSlots;   // 256
constexpr int kTJ = 64;                    // columns per staged tile
constexpr int kChunk = 8;                  // columns per online-softmax step
constexpr int kMaxHF = 128;                // floats of a head group's h row
constexpr int kMaxF = 64;                  // widest head the kernels take
constexpr float kSlope = 0.2f;             // leaky_relu negative slope

// Row strides are padded so that the column splits of one warp, which read
// columns s, s + splits, ..., fall in distinct banks: bias 72 = 8 (mod 32)
// apart per row, alpha_src 9 and h 129 = 1 (mod 32) apart per column.
struct Smem {                              // 44,288 bytes
  float bias[kRows][kTJ + 8];
  float a_src[kTJ][kSlots + 1];
  float h[kTJ][kMaxHF + 1];
};

// Heads per block and column splits per (row, head) for a head width f.
__host__ __device__ inline int heads_per_block(int heads, int f) {
  const int hb = kMaxHF / f < kSlots ? kMaxHF / f : kSlots;
  return heads < hb ? heads : hb;
}
__host__ __device__ inline int column_splits(int hb) {
  int s = 1;
  while (2 * s * hb <= kSlots) s *= 2;
  return s;
}

// One (row, head) partial softmax merged into another: max, rescaled sums.
template <int MF>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[MF],
                                      float m2, float l2,
                                      const float (&acc2)[MF]) {
  const float mn = fmaxf(m, m2);
  const float w1 = m == -INFINITY ? 0.f : expf(m - mn);
  const float w2 = m2 == -INFINITY ? 0.f : expf(m2 - mn);
  l = l * w1 + l2 * w2;
#pragma unroll
  for (int q = 0; q < MF; ++q) acc[q] = acc[q] * w1 + acc2[q] * w2;
  m = mn;
}

// h: (batch, n, heads, f); alpha_dst, alpha_src: (batch, n, heads); bias:
// (batch, n, n); b: (heads, f) or null; out: (batch, n, heads, f). Grid
// (ceil(n / 32), ceil(heads / hb), batch); MF >= f.
template <int MF>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ h,
                 const float* __restrict__ alpha_dst,
                 const float* __restrict__ alpha_src,
                 const float* __restrict__ bias, const float* __restrict__ b,
                 float* __restrict__ out, int n, int heads, int f, int act) {
  __shared__ Smem sm;
  const int hf = heads * f;
  const int hb = heads_per_block(heads, f);
  const int splits = column_splits(hb);
  const int head0 = blockIdx.y * hb;
  const int nh = min(hb, heads - head0);   // heads of this block
  const int gw = nh * f;                   // floats of its h rows
  const int z = blockIdx.z;
  h += (long long)z * n * hf;
  alpha_dst += (long long)z * n * heads;
  alpha_src += (long long)z * n * heads;
  bias += (long long)z * n * n;
  out += (long long)z * n * hf;

  const int tid = threadIdx.x;
  const int rloc = tid / kSlots;
  const int slot = tid % kSlots;
  const int s = slot / hb;                 // column split
  const int hd = slot % hb;                // head within the block
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + rloc;
  const bool active = s < splits && hd < nh && row < n;
  const int head = head0 + hd;
  const float ad = active ? alpha_dst[(long long)row * heads + head] : 0.f;

  float m = -INFINITY, l = 0.f, acc[MF];
#pragma unroll
  for (int q = 0; q < MF; ++q) acc[q] = 0.f;
  const int per_split = kTJ / splits;      // this thread's columns per tile

  for (int c0 = 0; c0 < n; c0 += kTJ) {
    for (int i = tid; i < kRows * kTJ; i += kThreads) {
      const int r = i / kTJ, c = i % kTJ;
      const int gr = row0 + r, gc = c0 + c;
      sm.bias[r][c] = (gr < n && gc < n) ? bias[(long long)gr * n + gc] : 0.f;
    }
    for (int i = tid; i < kTJ * nh; i += kThreads) {
      const int c = i / nh, k = i % nh, gc = c0 + c;
      sm.a_src[c][k] = gc < n ? alpha_src[(long long)gc * heads + head0 + k]
                              : 0.f;
    }
    for (int i = tid; i < kTJ * gw; i += kThreads) {
      const int c = i / gw, q = i % gw, gc = c0 + c;
      sm.h[c][q] = gc < n ? h[(long long)gc * hf + head0 * f + q] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int base = 0; base < per_split; base += kChunk) {
        float e[kChunk];
        float mc = -INFINITY;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int jl = s + splits * (base + u);
          float v = ad + sm.a_src[jl][hd];
          v = v >= 0.f ? v : kSlope * v;
          v = v + sm.bias[rloc][jl];
          e[u] = c0 + jl < n ? v : -INFINITY;
          mc = fmaxf(mc, e[u]);
        }
        if (mc == -INFINITY) continue;     // every column past n
        const float mn = fmaxf(m, mc);
        const float sc = expf(m - mn);     // 0 at the first step
        l *= sc;
#pragma unroll
        for (int q = 0; q < MF; ++q) acc[q] *= sc;
        m = mn;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int jl = s + splits * (base + u);
          const float p = expf(e[u] - mn);
          l += p;
          const float* hj = &sm.h[jl][hd * f];
#pragma unroll
          for (int q = 0; q < MF; ++q)
            if (q < f) acc[q] = fmaf(p, hj[q], acc[q]);
        }
      }
    }
    __syncthreads();
  }

  // merge the column splits of each (row, head): the partner of split s is
  // s + k, k * hb lanes further within the row's 8 slots
  for (int k = splits / 2; k >= 1; k /= 2) {
    const int delta = k * hb;
    const float m2 = __shfl_down_sync(0xffffffffu, m, delta);
    const float l2 = __shfl_down_sync(0xffffffffu, l, delta);
    float acc2[MF];
#pragma unroll
    for (int q = 0; q < MF; ++q)
      acc2[q] = __shfl_down_sync(0xffffffffu, acc[q], delta);
    if (s < k) merge<MF>(m, l, acc, m2, l2, acc2);
  }

  if (active && s == 0) {
    const float denom = fmaxf(l, 1e-12f);
    float* o = out + (long long)row * hf + head * f;
#pragma unroll
    for (int q = 0; q < MF; ++q) {
      if (q >= f) break;
      float v = acc[q] / denom;
      if (b != nullptr) v = v + b[head * f + q];
      o[q] = apply_activation(v, act);
    }
  }
}

// Launch the attention body on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head width above kMaxF.
static inline cudaError_t launch_attention(
    const float* h, const float* alpha_dst, const float* alpha_src,
    const float* bias, const float* b, float* out, int batch, int n,
    int heads, int f, int act, cudaStream_t stream) {
  if (f < 1 || f > kMaxF || heads < 1) return cudaErrorInvalidValue;
  const int hb = heads_per_block(heads, f);
  const dim3 grid((n + kRows - 1) / kRows, (heads + hb - 1) / hb, batch);
  if (f <= 8)
    attention_kernel<8><<<grid, kThreads, 0, stream>>>(
        h, alpha_dst, alpha_src, bias, b, out, n, heads, f, act);
  else if (f <= 16)
    attention_kernel<16><<<grid, kThreads, 0, stream>>>(
        h, alpha_dst, alpha_src, bias, b, out, n, heads, f, act);
  else if (f <= 32)
    attention_kernel<32><<<grid, kThreads, 0, stream>>>(
        h, alpha_dst, alpha_src, bias, b, out, n, heads, f, act);
  else
    attention_kernel<64><<<grid, kThreads, 0, stream>>>(
        h, alpha_dst, alpha_src, bias, b, out, n, heads, f, act);
  return cudaGetLastError();
}

}  // namespace gat
}  // namespace gcn_port
