// bitmap_spmm: Â @ H over the GraSp compacted form, fp32, batched over
// blockIdx.z.
//
// Replaces the TPU kernel `bitmap_spmm` (src/repro/kernels/bitmap_spmm.py):
// there the block columns sat in SMEM by scalar prefetch and steered the
// index maps of a (row block, F strip, entry) grid whose masked tail steps
// skipped the MAC under `pl.when`. Here each block loads its row's count and
// columns itself and loops over the real entries only (bsr_tile.cuh), each
// entry's product 3xTF32 on the TF32 tensor cores (tc_gemm_tile.cuh's
// mma_tile) and summed apart, then added to the total in registers, so
// blocks run in any order.
//
// Bound at the serving shapes (B = 4 clustered graphs at cap 3072, F = 128
// after padding): the bytes of the real blocks and the H rows they name.
#include "bsr_tile.cuh"

// blocks: (batch, rb*max_nnz, 128, 128); block_cols: (batch, rb, max_nnz)
// int32; counts: (batch, rb) int32; h: (batch, n_h, f); out: (batch,
// rb*128, f). All contiguous, on CUDA ordinal `device` with `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int bitmap_spmm_f32(const float* blocks, const int* block_cols,
                               const int* counts, const float* h, float* out,
                               int batch, int rb, int max_nnz, int n_h, int f,
                               int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)gcn_port::tc::launch_bsr_spmm<false>(
      blocks, block_cols, counts, h, nullptr, out, batch, rb, max_nnz, n_h,
      f, gcn_port::kActNone, (cudaStream_t)stream);
}
