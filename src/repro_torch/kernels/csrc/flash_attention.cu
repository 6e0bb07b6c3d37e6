// flash_attention: GQA attention of the LM prefill, bf16 or fp32 operands,
// fp32 softmax statistics and accumulator:
//   out[b, i, h, :] = sum_j softmax_j(s[i, j]) * v[b, j, h / group, :]
//   s[i, j] = cap(scale * q[b, i, h, :] . k[b, j, h / group, :]), masked
// with -1e9 where key j lies past the causal frontier (j > q_offset + i) or
// outside the window (j <= q_offset + i - window); keys past Skv are never
// counted.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_flash_kernel`). That kernel walks a (B, H, Sq/bq,
// Skv/bk) grid in order, carries the (bq, D) accumulator and the running
// max and sum in VMEM across the KV sweep, and skips a block with
// `pl.when` when the mask clears it. Blocks here run in no order, so the KV
// sweep is a loop inside one CTA: one CTA per (q tile of 64 rows, head,
// batch), 256 threads, four per q row. Each thread keeps a quarter of its
// row's q and accumulator in registers (dims lane, lane + 4, ...), so a
// score is a quad's partial dot products summed by two shuffles, which
// leave the same float in all four lanes; each lane then runs the row's
// online softmax itself. K and V tiles (64 keys, 32 at D 96 and 128) are
// staged in shared memory as fp32, 16 to 32 KB, and read by every row of
// the CTA. The query head reads KV head h / group; nothing is repeated in
// memory. Sq and Skv are taken as they are: rows past Sq are not stored,
// keys past Skv weigh 0.
//
// Arithmetic, as the TPU kernel: scores in fp32 from exact products
// (bf16 x bf16 fits fp32), times `scale` after the product, tanh-capped,
// then masked to -1e9 as a number; the running max starts at -1e9; each
// 16-key step takes p = exp(s - m_new), rescales l and the accumulator by
// exp(m_old - m_new), adds p to l and p rounded to the operands' dtype
// times v to the accumulator; the result is acc / max(l, 1e-12) in the
// operands' dtype.
//
// Tile skip, as `pl.when(needed)`: a CTA visits only the key tiles that
// some row of its q tile may reach, from the window's start for its first
// row to the causal frontier of its last. One difference of definition:
// a row that no key may reach (a window entirely past Skv, possible only
// with q_offset or without causality) averages every key uniformly, as
// the -1e9 softmax of `flash_attention_ref` does, so a CTA holding such a
// row visits every tile. (The TPU kernel averages the keys of the blocks
// it happens to visit.)
//
// Bound (H100 SXM): q, k, v read once and out written once at 3.35 TB/s,
// or 4 * D operations per reachable (row, key) pair at the 989 TFLOP/s of
// the bf16 tensor cores. This SIMT kernel uses no tensor core: its own
// ceiling is the 67 TFLOP/s of fp32 FMA. wgmma and TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace lm_port {
namespace flash {

constexpr int kRows = 64;                  // q rows per CTA
constexpr int kLanes = 4;                  // threads per q row
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kChunk = 16;                 // keys per online-softmax step
constexpr float kMasked = -1e9f;           // the TPU kernel's NEG_INF

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

// T: float or __nv_bfloat16; D: head dim; KK: keys per staged tile.
template <typename T, int D, int KK>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int heads, int kv_heads, float scale, float cap,
                 int causal, int window, int q_offset) {
  constexpr int DPT = D / kLanes;          // dims per thread
  __shared__ float ks[KK * D];
  __shared__ float vs[KK * D];

  const int tid = threadIdx.x;
  const int row = tid / kLanes, lane = tid % kLanes;
  const int hd = blockIdx.y, bz = blockIdx.z;
  const int kh = hd / (heads / kv_heads);
  const int r0 = blockIdx.x * kRows;
  const int qi = r0 + row;
  const bool valid = qi < sq;
  const int qpos = q_offset + qi;
  const size_t q_base =
      (((size_t)bz * sq + (valid ? qi : 0)) * heads + hd) * D;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? to_f(q[q_base + lane + kLanes * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kMasked, l = 0.f;

  // the keys some row of this tile may reach
  const int rows = min(kRows, sq - r0);
  const int q_lo = q_offset + r0, q_hi = q_lo + rows - 1;
  int k_lo = 0, k_hi = skv - 1;
  const bool unreachable_row = window > 0 && q_hi - window + 1 > skv - 1;
  if (!unreachable_row) {
    if (causal) k_hi = min(k_hi, q_hi);
    if (window > 0) k_lo = max(0, q_lo - window + 1);
  }

  for (int t = k_lo / KK; t <= k_hi / KK; ++t) {
    const int j0 = t * KK;
    __syncthreads();                       // the previous tile is consumed
    for (int e = tid; e < KK * D; e += kThreads) {
      const int key = j0 + e / D;
      float kk = 0.f, vv = 0.f;
      if (key < skv) {
        const size_t off =
            (((size_t)bz * skv + key) * kv_heads + kh) * D + e % D;
        kk = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[e] = kk;
      vs[e] = vv;
    }
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
          part = fmaf(qr[i], kr[lane + kLanes * i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int key = j0 + c + jj;
        float sc = part * scale;
        if (cap > 0.f) sc = tanhf(sc / cap) * cap;
        const bool allowed = (!causal || key <= qpos) &&
                             (window <= 0 || key > qpos - window);
        sc = allowed ? sc : kMasked;
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
        const float p = to_f(from_f<T>(s[jj]));   // p.astype(v.dtype)
        const float* vr = vs + (c + jj) * D;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          acc[i] = fmaf(p, vr[lane + kLanes * i], acc[i]);
      }
      m = m_new;
    }
  }

  if (valid) {
    const float denom = fmaxf(l, 1e-12f);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      out[q_base + lane + kLanes * i] = from_f<T>(acc[i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int sq, int skv, int heads, int kv_heads,
                   float scale, float cap, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  constexpr int KK = D >= 96 ? 32 : 64;    // 16 to 32 KB of K and V tiles
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  flash_kernel<T, D, KK><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, skv, heads,
      kv_heads, scale, cap, causal, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, const void* q, const void* k,
                     const void* v, void* out, int batch, int sq, int skv,
                     int heads, int kv_heads, float scale, float cap,
                     int causal, int window, int q_offset,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, batch, sq, skv, heads, kv_heads,
                           scale, cap, causal, window, q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, sq, skv, heads, kv_heads,
                           scale, cap, causal, window, q_offset, stream);
    case 96:
      return launch<T, 96>(q, k, v, out, batch, sq, skv, heads, kv_heads,
                           scale, cap, causal, window, q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, sq, skv, heads, kv_heads,
                            scale, cap, causal, window, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace lm_port

// q, out: (batch, sq, heads, head_dim); k, v: (batch, skv, kv_heads,
// head_dim); all contiguous, bf16 when `bf16` is 1 and fp32 when 0, on CUDA
// ordinal `device` with `stream`. `window` 0 means none, `softcap` 0 none.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head_dim other than 32, 64, 96 or 128.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int sq, int skv, int heads, int kv_heads,
                                   int head_dim, int bf16, int causal,
                                   int window, int q_offset, float scale,
                                   float softcap, int device, void* stream) {
  using namespace lm_port::flash;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_d<__nv_bfloat16>(head_dim, q, k, v, out, batch, sq,
                                        skv, heads, kv_heads, scale, softcap,
                                        causal, window, q_offset, s);
  return (int)launch_d<float>(head_dim, q, k, v, out, batch, sq, skv, heads,
                              kv_heads, scale, softcap, causal, window,
                              q_offset, s);
}
