// The W4 GEMV design experiments of the TPU scripts, for Hopper (sm_90a).
//
// Replace the kernels of three scripts (formulas in ../w4_experiments.py;
// K11, scripts/kernel_dma_pipeline.py::dma_rot_w4_matmul, is the DQ variant
// of the one-launch kernel in rot_w4_dequant.cu):
//  K10 scripts/kernel_edge_test.py::rot_w4_matmul_b (_kernel_b): K1's math in
//      one launch, the zero-point term from the row sum of the unrounded
//      rotation; out in x's dtype.
//  K12 scripts/kernel_tune.py::rot_w4_matmul_v2 (_kernel_v2): the rotation
//      in f32 whatever rot's dtype, the row sum of the rounded xr, f32 out.
//  K13 scripts/kernel_w4a8_exp.py::w4a8_matmul (_w4a8_kernel): no rotation;
//      int8 activations per (row, group), an exact integer dot, summed over
//      the groups in order.
//
// Bound on this card: at the scripts' M = 1 to 32 and 4096 x 4096, the
// weight stream (I*O/2 bytes, plus scales, zeros and rotations), so HBM
// bandwidth. All three are variants of K1's one-launch kernel (one_launch.cuh,
// whose note says what bounds it and what it does about that): each block
// issues x and its scales and zeros (K10/K12: and its rotation rows) first
// and its weight slice through a 16-byte cp.async ring once x has landed,
// rotates (K13: quantizes) x for its own groups, and the group splits merge
// in split order behind a counter, so a call is one launch and its bits do
// not depend on scheduling. K10 takes the row sum of the f32 xr before
// rounding it, K12 rotates the unrounded f32 x and writes f32. K13 (A8)
// quantizes each (row, group) with one warp (rintf of x / sx, half to even,
// as jnp.round), takes the dot on f32 FMAs of the integer xq and the
// unscaled nibbles, which is exact, with each lane owning its columns over
// every byte-row, and applies (dot - sum(xq) z) (s sx) group by group in
// order; at M <= 32 an int8 mma tile of 16 rows would be mostly padding, and
// the dot is bound by the weight bytes, not by its multiply rate. At M > 8 a
// call runs ceil(M / 8) row tiles, past one wave where it must.

#include "one_launch.cuh"

using namespace paro;

// K10. x [M, I] (f32 or bf16), rot [G, S, S] (f32 or bf16), qweight u8
// [I/2, O] half-split, scales/zeros [G, O] of dtype codes sdt/zdt (0 f32,
// 1 bf16, 2 f16, 3 uint8), out [M, O] in x's dtype; KS group splits and
// column tiles of cw * 128 columns (cw 1, 2 or 4), the scratch partial
// f32 [KS, M, O] (KS > 1) and counters int32, one per (column tile, row
// tile of one_launch.cuh's row_tile(M, S) rows), zero and left zero: the
// limits of one::call. Returns the first CUDA error (0 on success). Launches
// on `stream`, no sync.
extern "C" int paro_rot_w4_matmul_b(const void* x, const void* rot, const void* qweight,
                                    const void* scales, const void* zeros, void* out,
                                    void* partial, void* counters, int M, int I, int S, int O,
                                    int KS, int cw, int x_bf16, int rot_bf16, int sdt, int zdt,
                                    void* stream) {
  return (int)one::call<one::B>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S, 1,
                                &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, (cudaStream_t)stream);
}

// K12: K10's operands, out f32 [M, O].
extern "C" int paro_rot_w4_matmul_v2(const void* x, const void* rot, const void* qweight,
                                     const void* scales, const void* zeros, void* out,
                                     void* partial, void* counters, int M, int I, int S, int O,
                                     int KS, int cw, int x_bf16, int rot_bf16, int sdt, int zdt,
                                     void* stream) {
  return (int)one::call<one::V2>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                 1, &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, (cudaStream_t)stream);
}

// K13: K10's operands without rot, out [M, O] in x's dtype, column tiles
// of cw * 128 columns with cw 2 or 4.
extern "C" int paro_w4a8_matmul(const void* x, const void* qweight, const void* scales,
                                const void* zeros, void* out, void* partial, void* counters,
                                int M, int I, int S, int O, int KS, int cw, int x_bf16, int sdt,
                                int zdt, void* stream) {
  return (int)one::call<one::A8>(x, nullptr, qweight, scales, zeros, out, partial, counters, M, I,
                                 S, 1, &O, KS, cw, x_bf16, 0, sdt, zdt, (cudaStream_t)stream);
}
