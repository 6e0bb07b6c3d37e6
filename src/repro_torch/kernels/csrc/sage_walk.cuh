// The SAGE row walk shared by sage_max and fused_sage (sm_90a).
//
//   out[z, i, f] = op_j over the set columns j of mask[z, i, :] of
//                  (mask[z, i, j], h[z, j, f]),  starting from 0
//
// with op = max(acc, m * h) (GrAx3 max; the TPU kernels' accumulator also
// starts at 0) or acc = fmaf(m, h, acc) (mean: the mask holds 1/deg). One
// warp owns one row. It scans the row 128 columns at a time (four
// coalesced loads a lane, then a ballot per 32 columns) and compacts the
// set columns and their values into its list in shared memory, in
// ascending column order. Then it walks the list for 128 features at a
// time, four independent accumulators a lane, its loads of h[j, :]
// coalesced along f. A row with more set columns than the list holds is
// walked in chunks: each later chunk resumes the accumulators from the
// row already stored, so the order of the operations is that of one
// ascending pass. A skipped column contributes m = 0: nothing to a max of
// finite values that starts at 0, an exact zero to a sum.
//
// Bound: the scan reads each mask entry once, 4*N*N bytes per graph
// (37.7 MB at N = 3072); the walk reads at most max_neighbors + 1 rows of
// h per real row, mostly from L2. So the mask's bytes bound the kernel,
// not its (data-dependent, small) arithmetic.
#pragma once

#include <cuda_runtime.h>

namespace gcn_port {
namespace sage {

constexpr int kWarps = 8;                    // rows per block, one per warp
constexpr int kThreads = 32 * kWarps;        // 256
constexpr int kListCap = 128;                // set columns a warp holds
constexpr int kScanGroups = 4;               // 32-column groups per step
constexpr int kStrip = 4;                    // features a lane per step

struct WarpList {
  int col[kListCap];
  float val[kListCap];
};

// Append the set columns of row m[0:n], from column `start` on, to the
// warp's list L in ascending order, until the row ends or the next
// 32-column group would overflow the list. Returns the column to resume
// from (n when the row is done); `count` gets the list's length. Every
// lane of the warp calls it; control flow is warp-uniform.
__device__ __forceinline__ int scan_row(const float* __restrict__ m, int n,
                                        int start, WarpList& L, int& count) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int c0 = start; c0 < n; c0 += 32 * kScanGroups) {
    float v[kScanGroups];
#pragma unroll
    for (int g = 0; g < kScanGroups; ++g) {
      const int c = c0 + 32 * g + lane;
      v[g] = c < n ? m[c] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kScanGroups; ++g) {
      const bool set = v[g] != 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, set);
      const int add = __popc(ballot);
      if (cnt + add > kListCap) {
        count = cnt;
        return c0 + 32 * g;
      }
      if (set) {
        const int pos = cnt + __popc(ballot & below);
        L.col[pos] = c0 + 32 * g + lane;
        L.val[pos] = v[g];
      }
      cnt += add;
    }
  }
  count = cnt;
  return n;
}

// Walk the warp's list over all f features of h (n x f, row-major) into
// out_row: from 0 when `first`, else on from the values out_row holds.
template <bool kMax>
__device__ __forceinline__ void walk_list(const WarpList& L, int count,
                                          const float* __restrict__ h, int f,
                                          float* __restrict__ out_row,
                                          bool first) {
  const int lane = threadIdx.x & 31;
  for (int f0 = 0; f0 < f; f0 += 32 * kStrip) {
    float acc[kStrip];
#pragma unroll
    for (int s = 0; s < kStrip; ++s) {
      const int ff = f0 + 32 * s + lane;
      acc[s] = (first || ff >= f) ? 0.f : out_row[ff];
    }
    for (int e = 0; e < count; ++e) {
      const float mv = L.val[e];
      const float* __restrict__ hr = h + (long long)L.col[e] * f;
#pragma unroll
      for (int s = 0; s < kStrip; ++s) {
        const int ff = f0 + 32 * s + lane;
        if (ff < f) {
          const float hv = hr[ff];
          acc[s] = kMax ? fmaxf(acc[s], mv * hv) : fmaf(mv, hv, acc[s]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kStrip; ++s) {
      const int ff = f0 + 32 * s + lane;
      if (ff < f) out_row[ff] = acc[s];
    }
  }
}

// mask: (batch, rows, n); h: (batch, n, f); out: (batch, rows, ldo),
// ldo >= f, of which each row's first f are written. rows == n for a
// graph's square mask; a shard's row block of a larger graph has rows <
// n. Grid (ceil(rows / kWarps), batch), kThreads threads.
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ mask, const float* __restrict__ h,
            float* __restrict__ out, int rows, int n, int f, int ldo) {
  __shared__ WarpList lists[kWarps];
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;                  // whole warps only; no barrier
  const long long z = blockIdx.y;
  const float* m = mask + (z * rows + row) * (long long)n;
  const float* hz = h + z * (long long)n * f;
  float* o = out + (z * rows + row) * (long long)ldo;
  WarpList& L = lists[warp];
  int start = 0;
  bool first = true;
  do {                                       // once for an empty row too
    int count;
    const int next = scan_row(m, n, start, L, count);
    __syncwarp();
    walk_list<kMax>(L, count, hz, f, o, first);
    __syncwarp();                            // the list is refilled next
    first = false;
    start = next;
  } while (start < n);
}

// Launch the walk on `stream` over a (rows, n) mask a graph, out's rows
// ldo floats apart; returns cudaGetLastError().
static inline cudaError_t launch_walk(const float* mask, const float* h,
                                      float* out, int batch, int rows, int n,
                                      int f, int ldo, bool is_max,
                                      cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps, batch);
  if (is_max)
    walk_kernel<true><<<grid, kThreads, 0, stream>>>(mask, h, out, rows, n,
                                                     f, ldo);
  else
    walk_kernel<false><<<grid, kThreads, 0, stream>>>(mask, h, out, rows, n,
                                                      f, ldo);
  return cudaGetLastError();
}

}  // namespace sage
}  // namespace gcn_port
