// Block-sparse aggregation over the GraSp compacted form, on the 3xTF32
// tile of tc_gemm_tile.cuh (sm_90a):
//
//   out[z] = act(Â[z] @ H[z] + bias),  Â[z] given as its non-zero 128x128
//   blocks: blocks[z, i*max_nnz + k] sits at block column
//   block_cols[z, i, k], for k < counts[z, i]
//
// Grid (ceil(F/64), rb*128/64, B): each 128-thread block owns one 64x64
// output tile inside block row i and walks that row's list in order,
// k = 0 .. counts[z, i]-1. Per entry, `mma_tile` multiplies the tile's 64
// rows of block k (128 deep) by the 128 rows of H the block's column
// names: 3xTF32 on mma.sync behind the tile's cp.async ring. The entry's
// K of 128 is the tile's kFlush, so each entry's product is summed in a
// partial sum of its own and then added to the block's total (one chain
// over the 768 terms of 6 entries loses up to three times the plain
// version's error against float64). The store adds the bias and the
// activation (epilogue<EPI>). Entries past counts[z, i] are never loaded
// or multiplied: the loop bound is the count. The counts and columns are
// read on the device, so a launch never waits on the host. A column
// outside [0, n_h/128) is skipped rather than read out of bounds.
//
// Bound: per batch the real blocks are read once (64 KB each) against
// 2*128*128*F flops each, F/2 flops per byte of Â. At the serving shapes
// (one entry a block row, F = 128) a block does one 64x64x128 product, so
// the latency of its ring's first slabs, not the card's rates, sets the
// pace; the bytes bound the work.
#pragma once

#include "tc_gemm_tile.cuh"

namespace gcn_port {
namespace tc {

constexpr int kBlock = 128;                       // GraSp block edge

// The blocks are copied 16 bytes at a time (rows of 128 floats, the base
// 16-byte aligned: the wrappers check it); VB: 16-byte copies of H
// (mma_tile's); EPI: the store adds bias and applies act. static, as
// gemm_3xtf32_kernel.
template <bool VB, bool EPI>
static __global__ void __launch_bounds__(kThreads)
    bsr_spmm_kernel(const float* __restrict__ blocks,
                    const int* __restrict__ block_cols,
                    const int* __restrict__ counts,
                    const float* __restrict__ H,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int rb, int max_nnz, int n_h, int F, int act) {
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

  float acc[kMT][kNT][4] = {};
  for (int k = 0; k < count; ++k) {                // uniform over the block
    const int c = block_cols[k];
    if (c < 0 || c >= cb) continue;
    mma_tile<true, VB>(blocks + (long long)k * kBlock * kBlock,
                       H + (long long)c * kBlock * F, kBlock, F, kBlock,
                       kBlock, r0, col0, acc);
    __syncthreads();                               // the ring is reused
  }
  store_tile<EPI>(out, kBlock, F, r0, col0, acc, bias, act);
}

// Launch one batched block-sparse product on `stream`; returns
// cudaGetLastError(). blocks 16-byte aligned; EPI: bias (F,) and act in
// the store.
template <bool EPI>
static inline cudaError_t launch_bsr_spmm(
    const float* blocks, const int* block_cols, const int* counts,
    const float* H, const float* bias, float* out, int batch, int rb,
    int max_nnz, int n_h, int F, int act, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, rb * (kBlock / kBM), batch);
  return copies16(H, F)
             ? launch_ring<&bsr_spmm_kernel<true, EPI>>(
                   grid, stream, blocks, block_cols, counts, H, bias, out, rb,
                   max_nnz, n_h, F, act)
             : launch_ring<&bsr_spmm_kernel<false, EPI>>(
                   grid, stream, blocks, block_cols, counts, H, bias, out, rb,
                   max_nnz, n_h, F, act);
}

}  // namespace tc
}  // namespace gcn_port
