// int8_matmul: out = float(A @ B) * sw[n], s8 x s8 -> s32, batched over
// blockIdx.z.
//
// Replaces the TPU kernel `int8_matmul` (src/repro/kernels/int8_matmul.py,
// the QuantGr INT8 datapath behind `ops.int8_matmul`). The TPU grid carried
// the K reduction in a VMEM s32 accumulator across sequential grid steps;
// here each block loops over K itself with the sum in registers, so blocks
// run in any order (igemm_tile.cuh). As in the TPU kernel, the per-tensor
// activation scale is folded into the per-column weight scales by the
// wrapper (sw = w_scale * x_scale), so the epilogue is one multiply.
//
// Bound at the serving shapes (B = 4 graphs, N = 3072, widths padded to
// 128): bytes. A batch's four products read and write about 124 MB (37 us
// at 3.35 TB/s), while their 24.5 GOP take 12.4 us at the 1,979 TOP/s int8
// tensor-core peak. Each Aq @ Hq reads the batch's 37.7 MB of int8 Aq and
// takes at least 13.6 us. The tile (igemm_tile.cuh) runs on the s8 tensor
// cores (mma.sync m16n8k32) with one block across the whole 128-wide
// output, so Aq and Xq are read once; B comes row-major, as the callers
// hold it, and is turned to K-major words as it is staged.
#include "igemm_tile.cuh"

// a: (batch, m, k) s8 with batch stride `stride_a` elements (0 = broadcast),
// b: (batch, k, n) s8 with batch stride `stride_b` (0 = broadcast),
// sw: (n,) f32; c: (batch, m, n) f32 contiguous. `device` is the CUDA
// ordinal the operands and `stream` live on. Returns cudaGetLastError()
// after the launch.
extern "C" int int8_matmul_s8(const int8_t* a, const int8_t* b,
                              const float* sw, float* c, int batch, int m,
                              int n, int k, int stride_a, int stride_b,
                              int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  using namespace gcn_port::i8;
  const EpilogueArgs e{sw, nullptr, nullptr, nullptr, gcn_port::kActNone, 0};
  return (int)launch_igemm<kBRowMajor, kEpiScale>(
      a, b, 0, c, batch, m, n, k, (long long)stride_a, (long long)stride_b,
      e, (cudaStream_t)stream);
}
