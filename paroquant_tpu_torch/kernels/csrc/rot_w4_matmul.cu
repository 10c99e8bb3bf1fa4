// Rotated W4 linear for Hopper (sm_90a).
//
// Replaces paroquant_tpu/kernels/rot_matmul.py::rot_w4_matmul (_kernel_dense_rot)
// and ::merged_rot_w4_matmul (_kernel_merged_rot), both with their a8 branch.
// K1 is the case of one partition (P = 1).
//
//   xr_g[m]   = bf16(x_g[m] @ M_g^T)          M_g: group g's rotation, 1/channel_scale folded in
//   out[m, o] = sum_g (xr_g[m] . q_g[:, o] - rowsum(xr_g[m]) * z[g, o]) * s[g, o]
// and with a8, per (row, group):
//   sx = max|xr| / 127 (1 for an all-zero row),  xq = rint(xr / sx) (half to even),
//   out[m, o] = sum_g (xq_g[m] . q_g[:, o] - sum(xq_g[m]) * z[g, o]) * s[g, o] * sx
// with the int8 x nibble dot exact in int32. q_g is unpacked from the PARO-TPU
// half-split layout: byte row g*S/2+k holds channel g*S+k in its low nibble and
// channel g*S+S/2+k in its high nibble. The group size S is any even divisor
// of I (the TPU kernel tiles multiples of 128 and one group spanning the row);
// scales and zeros come in f32, bf16, f16 or uint8.
//
// Bound on this card: at decode (M <= 16) the weight stream, I*O/2 bytes of
// nibbles plus the scales and zeros, so HBM bandwidth; at the decode linears'
// 1-3 MB, the latency of a few dependent rounds of loads. Two routes, chosen
// by the wrapper from shapes alone (kernels/rot_matmul.py::rot_route):
//
// One launch (W4A16, M <= 16, S <= 256, the grid within one wave of blocks;
// one_launch.cuh, shared with K10/K12): one block per (column tile of 128,
// 256 or 512 columns, group split, row tile of at most 8 rows) puts its
// weight slice in flight through a cp.async ring, rotates x for its own
// groups, runs the dot and merges its group splits in split order behind a
// counter.
//
// Three passes (w4_passes.cuh; M > 16, S > 256, W4A16 shapes wider than one
// wave such as the lm_head, a8 with S not a multiple of 8; a8 at M <= 16
// and S <= 256 otherwise takes the RA8 variant of the one-launch kernel,
// rot_w4_a8.cu):
//  1. rotate pass, one block per (group, partition, 8-row tile). Each rotation
//     matrix is read once per call.
//  2. GEMV pass, one block per (128-column tile, group split, 8-row tile).
//     When the column tiles alone cannot fill the SMs, the groups are split
//     across blocks and a third pass sums the f32 partials in a fixed order,
//     so the result does not depend on scheduling.
// No tensor cores: at M <= 16 the dot is at most 0.2 GFLOP, well under a
// microsecond on the CUDA cores.

#include "one_launch.cuh"
#include "w4_passes.cuh"

using namespace paro;
using namespace paro::w4;

namespace {

template <typename XT>
cudaError_t run(const void* x, const void* rot, const void* qweight, const void* scales,
                const void* zeros, void* out, void* xr, void* xq, void* xsum, void* sx,
                void* partial, int M, int I, int S, int KS, const Parts& parts, int vec4,
                int rot_is_bf16, int a8, int sdt, int zdt, cudaStream_t st) {
  cudaError_t err = rot_is_bf16
      ? launch_rotate<XT, bf16>(x, rot, xr, xq, xsum, sx, M, I, S, parts.P, a8, st)
      : launch_rotate<XT, float>(x, rot, xr, xq, xsum, sx, M, I, S, parts.P, a8, st);
  if (err != cudaSuccess) return err;
  if (a8)
    return launch_gemv<XT, HALF_SPLIT_A8>(xr, xq, xsum, sx, qweight, scales, zeros, out, partial,
                                          M, I, S, KS, parts, vec4, sdt, zdt, st);
  return launch_gemv<XT, HALF_SPLIT>(xr, xq, xsum, sx, qweight, scales, zeros, out, partial,
                                     M, I, S, KS, parts, vec4, sdt, zdt, st);
}

}  // namespace

// x [M, I] (f32 or bf16), rot [P, G, S, S] (f32 or bf16), qweight u8
// [I/2, O], scales/zeros [G, O] of dtype codes sdt/zdt (0 f32, 1 bf16, 2 f16,
// 3 uint8), out [M, O] in x's dtype. Scratch from the caller: xr f32
// [P, M, I], xq int8 [P, M, I] (a8 only), xsum and sx f32 [P, M, G], partial
// f32 [KS, M, O] when KS > 1. `splits` (host array of P ints) are the
// partitions' column counts. Returns the first CUDA error (0 on success).
// Launches on `stream`, no sync.
extern "C" int paro_rot_w4_matmul(const void* x, const void* rot, const void* qweight,
                                  const void* scales, const void* zeros, void* out, void* xr,
                                  void* xq, void* xsum, void* sx, void* partial, int M, int I,
                                  int S, int P, const int* splits, int KS, int x_is_bf16,
                                  int rot_is_bf16, int a8, int sdt, int zdt, void* stream) {
  Parts parts;
  int vec4;
  if (bad_layout(M, I, S, KS, sdt, zdt) || !make_parts(P, splits, parts, vec4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16)
    return (int)run<bf16>(x, rot, qweight, scales, zeros, out, xr, xq, xsum, sx, partial, M, I, S,
                          KS, parts, vec4, rot_is_bf16, a8, sdt, zdt, st);
  return (int)run<float>(x, rot, qweight, scales, zeros, out, xr, xq, xsum, sx, partial, M, I, S,
                         KS, parts, vec4, rot_is_bf16, a8, sdt, zdt, st);
}

// The one-launch route (W4A16 only): the operands as paro_rot_w4_matmul's,
// 1 <= M <= 16, S <= 256; column tiles of cw * 128 columns (cw 1, 2 or 4),
// row tiles of MT = 1, 2, 4 or 8 rows (the least that holds M, at most 8);
// KS group splits of ceil(G / KS) groups each, every split non-empty and at
// most max_groups(MT, S, cw * 128) groups; partial f32 [KS, M, O] when KS > 1
// and counters int32, one per (column tile, row tile), zero (and left zero).
// Grid (column tiles, KS, row tiles): one launch. Returns the first CUDA error.
extern "C" int paro_rot_w4_matmul_one_launch(const void* x, const void* rot, const void* qweight,
                                             const void* scales, const void* zeros, void* out,
                                             void* partial, void* counters, int M, int I, int S,
                                             int P, const int* splits, int KS, int cw,
                                             int x_is_bf16, int rot_is_bf16, int sdt, int zdt,
                                             void* stream) {
  if (M > one::MAX_M || S > one::MAX_S) return (int)cudaErrorInvalidValue;
  return (int)one::call<one::K1>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                 P, splits, KS, cw, x_is_bf16, rot_is_bf16, sdt, zdt,
                                 (cudaStream_t)stream);
}
