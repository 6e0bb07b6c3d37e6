// flash_attention_bwd: the gradient of flash_attention. Given q (B, Sq, H,
// D), k and v (B, Skv, KV, D) and dout (B, Sq, H, D), bf16 or fp32, it
// writes dq, dk and dv in the operands' dtype, summing dk and dv over the
// query heads of each KV head's group, with every option the forward
// takes (causal, sliding window, tanh softcap, scale, q_offset, Sq != Skv).
//
// Replaces no TPU kernel. The reference differentiates its attention by
// autodiff of the pure-JAX `chunked_attention` (src/repro/nn/attention.py)
// and its Pallas `flash_attention` has no VJP; the port trains through its
// forward kernel, so the gradient needs a kernel of its own. Its oracle is
// `ref.flash_attention_bwd_ref`, autograd through `flash_attention_ref`.
//
// Math, per query head h, row i and key j, with raw = scale * q_i . k_j in
// fp32, s = cap * tanh(raw / cap) (or raw), s = -1e9 where the mask drops
// the key, P = softmax_j(s):
//   dP_ij = dout_i . v_j,   Delta_i = sum_j P_ij dP_ij,
//   dS_ij = P_ij (dP_ij - Delta_i) * (1 - tanh^2(raw / cap)), 0 if masked,
//   dq_i = scale * sum_j dS_ij k_j,   dk_j = scale * sum_{h in group, i}
//   dS_ij q_i,   dv_j = sum_{h in group, i} P_ij dout_i.
// A masked entry is -1e9 as a number before the softmax, so it gets no
// score gradient; a row that no key may reach (a window past Skv) has
// P = 1 / Skv on every key and passes that to dv, as the plain version does.
//
// Two launches on one stream, no atomics, so the result is deterministic:
//   A (dq_kernel): one CTA per (q tile, head, batch), LANES threads per q
//     row, each holding D / LANES of its row's q, dout and accumulator in
//     registers (a dot product is the lanes' partial sums added by
//     shuffles). Sweep 1 runs the forward's online softmax over the K/V
//     tiles the tile's rows may reach (the forward's tile skip) with an
//     fp32 output accumulator and p unrounded, and gives each row its max
//     m, 1 / l and Delta = dout . O_fp32 (not dout . out: the stored out is
//     rounded to bf16, and Delta from it nearly doubles the error of dq,
//     against a float64 oracle); the three go to `stats` (3, B, H, Sq)
//     fp32 for launch B. Sweep 2 walks the same tiles and accumulates dq.
//   B (dkv_kernel): one CTA per (key tile, KV head, batch), LANES threads
//     per key, holding k, v, dk and dv of its key in registers. It loops
//     over the group's query heads and the q tiles that reach the key tile
//     (and those of rows that no key may reach), staging Q, dout and the
//     rows' stats in shared memory, recomputes P and accumulates dk, dv.
// Operands are staged as fp32 (exact for bf16); every sum is fp32, and
// for fp32 operands blocked by tile (see kSplitSums).
//
// Bound (H100 SXM): q, k, v, dout read once and dq, dk, dv written once at
// 3.35 TB/s, or the five products (q k^T, dout v^T, P^T dout, dS^T q,
// dS k) at 2 D operations each per reachable (row, key) pair, on the bf16
// tensor cores (989 TFLOP/s) or, for this SIMT kernel's own ceiling, fp32
// FMA (67 TFLOP/s). This first design recomputes q k^T in all three
// sweeps, dout v^T in two and the output in sweep 1, and runs on no tensor
// core; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace lm_port {
namespace flash_bwd {

constexpr int kThreads = 256;
constexpr int kChunk = 16;                 // keys per online-softmax step
constexpr float kMasked = -1e9f;           // the forward's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// fp32 operands sum dq over each key tile, and dk and dv over each q tile,
// apart before adding the tile's sum to the total: a sequential fp32 sum
// over every key (or every row of the group's heads) lost to the plain
// version's blocked sums (dv at 2.26 x its error against float64, SmolLM's
// heads at S 200, on an H100). bf16 results round to bf16 at the end,
// which hides it.
template <typename T>
constexpr bool kSplitSums = sizeof(T) == 4;

// the sum of a value over the LANES consecutive threads of one row or key;
// every lane gets the same float
template <int LANES>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Opts {
  float scale, cap;
  int causal, window, q_offset;
};

// The score of (query position qpos, key) from its dot product, as the
// forward computes it (scaled after the product, capped, masked to -1e9),
// and in *dcap the cap's derivative, 0 where the mask drops the key.
__device__ __forceinline__ float score(float dot, int qpos, int key,
                                       const Opts& o, float* dcap) {
  float sc = dot * o.scale;
  float deriv = 1.f;
  if (o.cap > 0.f) {
    const float t = tanhf(sc / o.cap);
    sc = t * o.cap;
    deriv = 1.f - t * t;
  }
  const bool allowed = (!o.causal || key <= qpos) &&
                       (o.window <= 0 || key > qpos - o.window);
  *dcap = allowed ? deriv : 0.f;
  return allowed ? sc : kMasked;
}

// Stage `n` rows of a (B, S, heads, D) tensor, from row r0 of head hd, into
// shared memory as fp32; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int n, int r0, int s, int heads,
                                      int hd, int bz) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = r0 + e / D;
    dst[e] = r < s ? to_f(src[(((size_t)bz * s + r) * heads + hd) * D +
                              e % D])
                   : 0.f;
  }
}

template <typename T, int D, int LANES, int KK>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              T* __restrict__ dq, float* __restrict__ stats, int batch,
              int sq, int skv, int heads, int kv_heads, Opts o) {
  constexpr int ROWS = kThreads / LANES;
  constexpr int DPT = D / LANES;           // dims per thread
  constexpr bool kSplit = kSplitSums<T>;
  __shared__ float ks[KK * D];
  __shared__ float vs[KK * D];

  const int row = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int hd = blockIdx.y, bz = blockIdx.z;
  const int kh = hd / (heads / kv_heads);
  const int r0 = blockIdx.x * ROWS;
  const int qi = r0 + row;
  const bool valid = qi < sq;
  const int qpos = o.q_offset + qi;
  const size_t q_base =
      (((size_t)bz * sq + (valid ? qi : 0)) * heads + hd) * D;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? to_f(q[q_base + lane + LANES * i]) : 0.f;
    acc[i] = 0.f;
  }

  // the keys some row of this tile may reach (the forward's tile skip)
  const int rows = min(ROWS, sq - r0);
  const int q_lo = o.q_offset + r0, q_hi = q_lo + rows - 1;
  int k_lo = 0, k_hi = skv - 1;
  const bool unreachable_row = o.window > 0 && q_hi - o.window + 1 > skv - 1;
  if (!unreachable_row) {
    if (o.causal) k_hi = min(k_hi, q_hi);
    if (o.window > 0) k_lo = max(0, q_lo - o.window + 1);
  }

  // sweep 1: the online softmax, with the output in fp32 and p unrounded
  float m = kMasked, l = 0.f;
  for (int t = k_lo / KK; t <= k_hi / KK; ++t) {
    const int j0 = t * KK;
    __syncthreads();                       // the previous tile is consumed
    stage<T, D>(ks, k, KK, j0, skv, kv_heads, kh, bz);
    stage<T, D>(vs, v, KK, j0, skv, kv_heads, kh, bz);
    __syncthreads();
    for (int c = 0; c < KK && j0 + c < skv; c += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (c + jj) * D;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          part = fmaf(qr[i], kr[lane + LANES * i], part);
        part = lane_sum<LANES>(part);
        const int key = j0 + c + jj;
        float dcap;
        const float sc = score(part, qpos, key, o, &dcap);
        s[jj] = key < skv ? sc : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* vr = vs + (c + jj) * D;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          acc[i] = fmaf(s[jj], vr[lane + LANES * i], acc[i]);
      }
      m = m_new;
    }
  }
  const float inv_l = 1.f / fmaxf(l, 1e-12f);
  float dor[DPT];
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dor[i] = valid ? to_f(dout[q_base + lane + LANES * i]) : 0.f;
    delta = fmaf(dor[i], acc[i], delta);
    acc[i] = 0.f;                          // from here on: dq's sum
  }
  delta = lane_sum<LANES>(delta) * inv_l;
  if (valid && lane == 0) {
    const size_t plane = (size_t)batch * heads * sq;
    const size_t at = ((size_t)bz * heads + hd) * sq + qi;
    stats[at] = m;
    stats[plane + at] = inv_l;
    stats[2 * plane + at] = delta;
  }

  // sweep 2: dq = scale * sum_j dS_ij k_j over the same tiles
  for (int t = k_lo / KK; t <= k_hi / KK; ++t) {
    const int j0 = t * KK;
    __syncthreads();
    stage<T, D>(ks, k, KK, j0, skv, kv_heads, kh, bz);
    stage<T, D>(vs, v, KK, j0, skv, kv_heads, kh, bz);
    __syncthreads();
    const int n = min(KK, skv - j0);
    float tile[kSplit ? DPT : 1];
#pragma unroll
    for (int i = 0; i < (kSplit ? DPT : 1); ++i) tile[i] = 0.f;
    for (int c = 0; c < n; ++c) {
      const float* kr = ks + c * D;
      const float* vr = vs + c * D;
      float part = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        part = fmaf(qr[i], kr[lane + LANES * i], part);
        dp = fmaf(dor[i], vr[lane + LANES * i], dp);
      }
      part = lane_sum<LANES>(part);
      dp = lane_sum<LANES>(dp);
      float dcap;
      const float s = score(part, qpos, j0 + c, o, &dcap);
      const float ds = expf(s - m) * inv_l * (dp - delta) * dcap;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        if constexpr (kSplit)
          tile[i] = fmaf(ds, kr[lane + LANES * i], tile[i]);
        else
          acc[i] = fmaf(ds, kr[lane + LANES * i], acc[i]);
      }
    }
    if constexpr (kSplit) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += tile[i];
    }
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      dq[q_base + lane + LANES * i] = from_f<T>(acc[i] * o.scale);
  }
}

template <typename T, int D, int LANES, int QQ>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ stats, T* __restrict__ dk,
               T* __restrict__ dv, int batch, int sq, int skv, int heads,
               int kv_heads, Opts o) {
  constexpr int KEYS = kThreads / LANES;
  constexpr int DPT = D / LANES;
  constexpr bool kSplit = kSplitSums<T>;
  __shared__ float qs[QQ * D];
  __shared__ float dos[QQ * D];
  __shared__ float st[3 * QQ];             // m, 1 / l, Delta of the rows

  const int kj = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int kvh = blockIdx.y, bz = blockIdx.z;
  const int group = heads / kv_heads;
  const int j0 = blockIdx.x * KEYS;
  const int key = j0 + kj;
  const bool valid = key < skv;
  const size_t k_base =
      (((size_t)bz * skv + (valid ? key : 0)) * kv_heads + kvh) * D;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = valid ? to_f(k[k_base + lane + LANES * i]) : 0.f;
    vr[i] = valid ? to_f(v[k_base + lane + LANES * i]) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  // the q rows that some key of this tile may reach, [i_lo, i_hi], and
  // from i_un on the rows that no key may reach (they average every key)
  const int j1 = min(j0 + KEYS, skv) - 1;
  const int i_lo = o.causal ? max(0, j0 - o.q_offset) : 0;
  const int i_hi = o.window > 0 ? min(sq - 1, j1 + o.window - 1 - o.q_offset)
                                : sq - 1;
  const int i_un = o.window > 0 ? max(0, skv + o.window - 1 - o.q_offset)
                                : sq;
  const size_t plane = (size_t)batch * heads * sq;

  for (int hd = kvh * group; hd < (kvh + 1) * group; ++hd) {
    const size_t srow = ((size_t)bz * heads + hd) * sq;
    for (int r0 = 0; r0 < sq; r0 += QQ) {
      const int r1 = min(r0 + QQ, sq) - 1;
      if (!((r1 >= i_lo && r0 <= i_hi) || r1 >= i_un)) continue;
      __syncthreads();                     // the previous tile is consumed
      stage<T, D>(qs, q, QQ, r0, sq, heads, hd, bz);
      stage<T, D>(dos, dout, QQ, r0, sq, heads, hd, bz);
      for (int e = threadIdx.x; e < 3 * QQ; e += kThreads) {
        const int r = r0 + e % QQ;
        st[e] = r < sq ? stats[(e / QQ) * plane + srow + r] : 0.f;
      }
      __syncthreads();
      const int n = r1 - r0 + 1;
      float tk[kSplit ? DPT : 1], tv[kSplit ? DPT : 1];
#pragma unroll
      for (int i = 0; i < (kSplit ? DPT : 1); ++i) tk[i] = tv[i] = 0.f;
      for (int c = 0; c < n; ++c) {
        const float* qrow = qs + c * D;
        const float* drow = dos + c * D;
        float part = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          part = fmaf(qrow[lane + LANES * i], kr[i], part);
          dp = fmaf(drow[lane + LANES * i], vr[i], dp);
        }
        part = lane_sum<LANES>(part);
        dp = lane_sum<LANES>(dp);
        float dcap;
        const float s = score(part, o.q_offset + r0 + c, key, o, &dcap);
        const float p = expf(s - st[c]) * st[QQ + c];
        const float ds = p * (dp - st[2 * QQ + c]) * dcap;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          if constexpr (kSplit) {
            tv[i] = fmaf(p, drow[lane + LANES * i], tv[i]);
            tk[i] = fmaf(ds, qrow[lane + LANES * i], tk[i]);
          } else {
            dva[i] = fmaf(p, drow[lane + LANES * i], dva[i]);
            dka[i] = fmaf(ds, qrow[lane + LANES * i], dka[i]);
          }
        }
      }
      if constexpr (kSplit) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          dka[i] += tk[i];
          dva[i] += tv[i];
        }
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[k_base + lane + LANES * i] = from_f<T>(dka[i] * o.scale);
      dv[k_base + lane + LANES * i] = from_f<T>(dva[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int batch, int sq, int skv, int heads,
                   int kv_heads, const Opts& o, cudaStream_t stream) {
  // D >= 96: 8 lanes a row, 32 rows (keys) a CTA, so a thread holds at most
  // 16 floats of each of its row's vectors; 16 to 32 KB of staged tiles
  constexpr int LANES = D >= 96 ? 8 : 4;
  constexpr int TILE = kThreads / LANES;
  const dim3 grid_a((sq + TILE - 1) / TILE, heads, batch);
  dq_kernel<T, D, LANES, TILE><<<grid_a, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, stats,
      batch, sq, skv, heads, kv_heads, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_b((skv + TILE - 1) / TILE, kv_heads, batch);
  dkv_kernel<T, D, LANES, TILE><<<grid_b, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats, (T*)dk,
      (T*)dv, batch, sq, skv, heads, kv_heads, o);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, void* dq, void* dk,
                     void* dv, float* stats, int batch, int sq, int skv,
                     int heads, int kv_heads, const Opts& o,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, dout, dq, dk, dv, stats, batch, sq, skv,
                           heads, kv_heads, o, stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, dq, dk, dv, stats, batch, sq, skv,
                           heads, kv_heads, o, stream);
    case 96:
      return launch<T, 96>(q, k, v, dout, dq, dk, dv, stats, batch, sq, skv,
                           heads, kv_heads, o, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, dq, dk, dv, stats, batch, sq,
                            skv, heads, kv_heads, o, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash_bwd
}  // namespace lm_port

// q, dout, dq: (batch, sq, heads, head_dim); k, v, dk, dv: (batch, skv,
// kv_heads, head_dim); all contiguous, bf16 when `bf16` is 1 and fp32 when
// 0, on CUDA ordinal `device` with `stream`; stats: (3, batch, heads, sq)
// fp32 scratch. sq and skv >= 1. `window` 0 means none, `softcap` 0 none.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a head_dim other than 32, 64, 96 or 128.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout, void* dq,
                                   void* dk, void* dv, void* stats, int batch,
                                   int sq, int skv, int heads, int kv_heads,
                                   int head_dim, int bf16, int causal,
                                   int window, int q_offset, float scale,
                                   float softcap, int device, void* stream) {
  using namespace lm_port::flash_bwd;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const Opts o{scale, softcap, causal, window, q_offset};
  if (bf16)
    return (int)launch_d<__nv_bfloat16>(head_dim, q, k, v, dout, dq, dk, dv,
                                        (float*)stats, batch, sq, skv, heads,
                                        kv_heads, o, s);
  return (int)launch_d<float>(head_dim, q, k, v, dout, dq, dk, dv,
                              (float*)stats, batch, sq, skv, heads, kv_heads,
                              o, s);
}
