// The rotated W4 linear with int8 activations (a8) for Hopper (sm_90a), in
// one launch.
//
// Replaces the a8 branch of paroquant_tpu/kernels/rot_matmul.py::rot_w4_matmul
// and ::merged_rot_w4_matmul (_kernel_dense_rot / _kernel_merged_rot with
// a8=True, _a8_quantize) at M <= 16 and S <= 256 (kernels/rot_matmul.py::
// rot_route; the three passes of rot_w4_matmul.cu take the rest). Per
// partition p and group g of S channels:
//
//   xr_g = f32(x_g in rot's dtype) @ M_{p,g}^T        (not rounded to bf16)
//   sx   = max|xr_g| / 127 (1 where that is 0),  xq = rint(xr_g / sx) (half to even)
//   out  = sum_g ((xq . q_g - sum(xq) z_g) s_g) sx    in x's dtype
//
// with the dot exact (an f32 FMA on integers, |xq . q| <= S 127 15 < 2^24),
// each group's epilogue rounded operation by operation in that order, the
// groups of a split added in order and the splits in split order.
//
// Bound on this card: the weight stream, I*O/2 bytes of nibbles plus the
// scales and zeros (Qwen3-0.6B's lm_head, 1024 x 151936: 77.8 MB), so HBM
// bandwidth. Design: the RA8 variant of the one-launch kernel (one_launch.cuh,
// whose note says what it does about that bound). Within one wave of two
// blocks an SM it is the ordinary one-launch grid; past one wave each block
// takes a split of groups and a run of column tiles of 512, rotates and
// quantizes its groups once, and streams the run back to back through its
// cp.async ring, so that the lm_head reads each group's rotation once a
// block instead of once a column tile. Its own translation unit: the W4A16
// instances of rot_w4_matmul.cu keep their code as it was.

#include "one_launch.cuh"

using namespace paro;

// x [M, I] (f32 or bf16), rot [P, G, S, S] (f32 or bf16), qweight u8 [I/2,
// O] half-split, scales/zeros [G, O] of dtype codes sdt/zdt (0 f32, 1 bf16,
// 2 f16, 3 uint8), out [M, O] in x's dtype; `splits` (host array of P ints)
// the partitions' column counts; 1 <= M <= 16, S <= 256; KS group splits of
// ceil(G / KS) groups each, column tiles of 512 (cw 4) in runs of tpb
// tiles of one partition; the scratch partial f32 [KS, M, O] (KS > 1) and
// counters int32, one per (row tile of one_launch.cuh's row_tile(M, S)
// rows, column tile), zero and left zero: the limits of one::call. Grid
// (runs, KS, row tiles): one launch. Returns the first CUDA error (0 on success). Launches
// on `stream`, no sync.
extern "C" int paro_rot_w4_matmul_ra8(const void* x, const void* rot, const void* qweight,
                                      const void* scales, const void* zeros, void* out,
                                      void* partial, void* counters, int M, int I, int S, int P,
                                      const int* splits, int KS, int cw, int tpb, int x_bf16,
                                      int rot_bf16, int sdt, int zdt, void* stream) {
  if (M > one::MAX_M || S > one::MAX_S) return (int)cudaErrorInvalidValue;
  return (int)one::call<one::RA8>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                  P, splits, KS, cw, x_bf16, rot_bf16, sdt, zdt,
                                  (cudaStream_t)stream, 0, 0, nullptr, nullptr, nullptr, 0, tpb);
}
