// Block-sparse aggregation over the GraSp compacted form (sm_90a):
//
//   out[z] = act(Â[z] @ H[z] + bias),  Â[z] given as its non-zero 128x128
//   blocks: blocks[z, i*max_nnz + k] sits at block column
//   block_cols[z, i, k], for k < counts[z, i]
//
// Grid (ceil(F/64), rb*128/64, B): each 256-thread block owns one 64x64
// output tile inside block row i and walks that row's list in order,
// k = 0 .. counts[z, i]-1, multiplying its 64-row slice of block k by the
// 128 rows of H the block's column names (`mac_tile` of gemm_tile.cuh: 8
// slabs of 16). Each entry's 128-deep product sums in registers of its
// own and is then added to the block's total (a blocked sum: one fp32
// chain over every entry's terms, 768 at 6 entries, lost up to three
// times the plain version's error against float64); the store adds the
// bias and the activation. Entries past counts[z, i] are never
// loaded or multiplied: the loop bound is the count. The counts and
// columns are read on the device, so a launch never waits on the host. A
// column outside [0, n_h/128) is skipped rather than read out of bounds.
//
// Bound: per batch the real blocks are read once (64 KB each) against
// 2*128*128*F flops each, F/2 flops per byte of Â, so at F >= 128 the
// fp32 SIMT rate bounds this walk.
#pragma once

#include "gemm_tile.cuh"

namespace gcn_port {

constexpr int kBlock = 128;                       // GraSp block edge

static __global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ blocks,
                const int* __restrict__ block_cols,
                const int* __restrict__ counts, const float* __restrict__ H,
                const float* __restrict__ bias, float* __restrict__ out,
                int rb, int max_nnz, int n_h, int F, int act) {
  __shared__ TileSmem s;
  const int z = blockIdx.z;
  const int i = (blockIdx.y * kBM) / kBlock;       // block row
  const int r0 = (blockIdx.y * kBM) % kBlock;      // tile rows within it
  const int col0 = blockIdx.x * kBN;
  const long long row_entry = (long long)z * rb + i;
  blocks += row_entry * max_nnz * kBlock * kBlock;
  block_cols += row_entry * max_nnz;
  H += (long long)z * n_h * F;
  out += row_entry * kBlock * F;
  const int count = min(max(counts[row_entry], 0), max_nnz);
  const int cb = n_h / kBlock;

  float acc[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) acc[a][b] = 0.f;
  for (int k = 0; k < count; ++k) {                // uniform over the block
    const int c = block_cols[k];
    if (c < 0 || c >= cb) continue;
    float part[kTM][kTN] = {};                     // this entry, from 0
    mac_tile(blocks + (long long)k * kBlock * kBlock,
             H + (long long)c * kBlock * F, kBlock, F, kBlock, r0, col0, s,
             part);
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTN; ++b) acc[a][b] += part[a][b];
  }
  store_tile(out, bias, kBlock, F, r0, col0, acc, act);
}

// Launch one batched block-sparse product on `stream`; returns
// cudaGetLastError().
static inline cudaError_t launch_bsr_spmm(
    const float* blocks, const int* block_cols, const int* counts,
    const float* H, const float* bias, float* out, int batch, int rb,
    int max_nnz, int n_h, int F, int act, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, rb * (kBlock / kBM), batch);
  bsr_spmm_kernel<<<grid, kThreads, 0, stream>>>(
      blocks, block_cols, counts, H, bias, out, rb, max_nnz, n_h, F, act);
  return cudaGetLastError();
}

}  // namespace gcn_port
