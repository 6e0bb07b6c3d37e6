// sage_max: GrAx3 SAGE-max aggregation, fp32, batched over graphs:
//   out[z, i, f] = max(0, max_j mask[z, i, j] * h[z, j, f]).
//
// Replaces the TPU kernel `sage_max` (src/repro/kernels/sage_max.py). That
// kernel walks a (N/bm, F/bf, N/bk) grid with a running max in VMEM and
// forms the (rows, bk, bf) product of every mask entry, set or not, in
// 32-row slabs: 1.45e10 multiply-max pairs per 3072-node graph at
// F = 1536. The sample mask has at most max_neighbors + 1 ones per real
// row, so this port walks only the set columns (sage_walk.cuh): one warp
// per row scans the row once and reads the h rows it names. F is taken as
// it is (1433 at layer 1), not padded to 128.
//
// Bound: the mask's bytes, 4*N*N per graph (151 MB per 4 x 3072 batch,
// about 0.045 ms at 3.35 TB/s), plus h and out once each.
//
// The mask may be rectangular: a shard's (rows, n) row block of a graph
// partitioned across shards, against the graph's whole (n, f) h. The walk
// is the same; only the grid covers `rows` rows.
#include "sage_walk.cuh"

// mask: (batch, rows, n); h: (batch, n, f); out: (batch, rows, f). All
// contiguous fp32, on CUDA ordinal `device` with `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int sage_max_f32(const float* mask, const float* h, float* out,
                            int batch, int rows, int n, int f, int device,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)gcn_port::sage::launch_walk(mask, h, out, batch, rows, n, f, f,
                                          true, (cudaStream_t)stream);
}
