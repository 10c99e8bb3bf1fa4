// The W4 GEMV that dequantizes its weight in bf16, for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute one function:
//  K8  paroquant_tpu/kernels/rot_matmul.py::rot_w4_matmul_mg (_kernel_dense_rot_mg)
//  K11 scripts/kernel_dma_pipeline.py::dma_rot_w4_matmul (_kernel_dma)
//
//   xr_g = bf16(bf16(x_g) @ bf16(M_g)^T),   w_g = bf16(bf16(q_g - z_g) * s_g)
//   out  = the f32 sum, over chunks of `chunk` groups in order, of each
//          chunk's f32 dot xr . w; in x's dtype
// with s and z rounded to bf16 (any of the four dtype codes) and no
// zero-point row sum. K8's chunk is its normalised groups_per_step (the last
// chunk may be shorter), K11's its Gb (a divisor of G).
//
// Bound on this card: at M <= 16 the weight stream, I*O/2 bytes of nibbles
// plus the scales, zeros and rotations, so HBM bandwidth. Design: the DQ
// variant of the one-launch kernel (one_launch.cuh, whose note says what it
// does about that bound): one launch a call, each block rotating x for its
// own groups, x, its rotation rows and the scale and zero words issued
// before the weight ring, and the group splits merged behind a counter by
// the last block, chunk by chunk in a fixed order, so that a call's bits do
// not depend on scheduling.

#include "one_launch.cuh"

using namespace paro;

// x [M, I] (f32 or bf16), rot [G, S, S] (f32 or bf16), qweight u8 [I/2, O]
// half-split, scales/zeros [G, O] of dtype codes sdt/zdt (0 f32, 1 bf16,
// 2 f16, 3 uint8), out [M, O] in x's dtype; chunks of `chunk` groups
// (1 <= chunk <= G), KS splits of gps groups that do not cross a chunk
// (one::call's limits), column tiles of cw * 128 columns (cw 1, 2 or 4), the
// scratch partial f32 [KS, M, O] (KS > 1) and counters int32, one per
// (column tile, row tile of one_launch.cuh's row_tile(M, S) rows), zero and
// left zero. Returns the first CUDA error (0 on success). Launches on
// `stream`, no sync.
extern "C" int paro_rot_w4_matmul_dq(const void* x, const void* rot, const void* qweight,
                                     const void* scales, const void* zeros, void* out,
                                     void* partial, void* counters, int M, int I, int S, int O,
                                     int KS, int gps, int chunk, int cw, int x_bf16, int rot_bf16,
                                     int sdt, int zdt, void* stream) {
  return (int)one::call<one::DQ>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                 1, &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, (cudaStream_t)stream,
                                 chunk, gps);
}
