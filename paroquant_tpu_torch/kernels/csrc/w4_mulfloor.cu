// The W4 GEMV with the bf16 mul-floor unpack for Hopper (sm_90a), in one launch.
//
// Replaces scripts/kernel_unpack_exp.py::w4_matmul_mulfloor (_kernel_mulfloor)
// at M <= 16 (kernels/unpack_exp.py::unpack_route; the gemv of
// unpack_exp.cu takes the rest):
//
//   xr_g = bf16(x_g);  out = sum_g (xr_g . q_g - rowsum(xr_g) z_g) s_g   in x's dtype
//
// with the weight u8 [I/2, O] half-split, byte-row k of group g holding
// channel g S + k in its low nibble and g S + S/2 + k in its high one.
//
// Bound on this card: the weight stream, I*O/2 bytes of nibbles plus the
// scales and zeros, so HBM bandwidth. Design: the MF variant of the
// one-launch kernel (one_launch.cuh, whose note says what it does about that
// bound): K6's PL variant, its issue order, ring, plan, merge and
// zero-point correction, with the TPU body's unpack in place of PL's. Each
// pair of a lane's bytes becomes a bf16 pair f (exact for 0..255), then hi =
// floor(f * 0.0625) and lo = hi * -16 + f on bf16x2, all exact; the nibbles
// are PL's, and so are the output's bits. Its own translation unit: the
// instances of the other sources keep their code as it was.

#include "one_launch.cuh"

using namespace paro;

// x [M, I] (f32 or bf16), qweight u8 [I/2, O] half-split, scales/zeros
// [G, O] of dtype codes sdt/zdt (0 f32, 1 bf16, 2 f16, 3 uint8), out [M, O]
// in x's dtype; KS group splits and column tiles of cw * 128 columns (cw 1,
// 2 or 4), the scratch partial f32 [KS, M, O] (KS > 1) and counters int32,
// one per (column tile, row tile of one_launch.cuh's row_tile(M, S) rows),
// zero and left zero: the limits of one::call. Returns the first CUDA error
// (0 on success). Launches on `stream`, no sync.
extern "C" int paro_w4_mulfloor_one_launch(const void* x, const void* qweight, const void* scales,
                                           const void* zeros, void* out, void* partial,
                                           void* counters, int M, int I, int S, int O, int KS,
                                           int cw, int x_bf16, int sdt, int zdt, void* stream) {
  return (int)one::call<one::MF>(x, nullptr, qweight, scales, zeros, out, partial, counters, M, I,
                                 S, 1, &O, KS, cw, x_bf16, 0, sdt, zdt, (cudaStream_t)stream);
}
