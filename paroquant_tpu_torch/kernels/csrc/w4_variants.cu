// The W4 matmul variants of the kernel benchmarks, for Hopper (sm_90a).
//
// Replace four kernels of paroquant_tpu/kernels/rot_matmul.py:
//  K6 w4_matmul (_kernel_plain): no rotation.
//       xr_g = bf16(x_g);  out = sum_g (xr_g . q_g - rowsum(xr_g) * z_g) * s_g
//  K7 butterfly_w4_matmul (_kernel, _rotate_block_butterfly): xr_g = bf16 of
//       K butterfly Givens stages on x_g * inv_s, stage r pairing lane l with
//       l XOR d_r (d_r = 2^(r mod log2 S)): x[l] <- cos[r, l] x[l] + sin[r, l] x[l ^ d_r];
//       then K6's sum.
//  K8 rot_w4_matmul_mg (_kernel_dense_rot_mg): xr_g = bf16(bf16(x_g) @ bf16(M_g)^T),
//       the weight dequantized in bf16, w = bf16(bf16(q - z) * s) with bf16 s and z,
//       out = sum_g xr_g . w_g in f32, no zero-point correction. These passes
//       take K8's calls at M > 16 (rot_matmul.py::mg_route); the DQ variant of
//       the one-launch kernel (rot_w4_dequant.cu) takes the rest.
//  K9 rot_w4_matmul_i4 (_kernel_dense_rot_i4): K1's numerics on a weight whose
//       byte row k holds channel 2k in its low nibble and 2k + 1 in its high one.
//       These passes take K9's calls at M > 16 or S > 256 (rot_matmul.py::i4_route);
//       the I4 variant of the one-launch kernel takes the rest.
// K6, K7 and K9 take scales and zeros in f32, bf16, f16 or uint8 and convert
// them in the kernel; out is in x's dtype (f32 or bf16).
//
// Bound on this card: at the benchmarks' M = 1 the weight stream (I*O/2
// bytes, plus scales, zeros and, for K7, its tables, for K8/K9 the rotation
// matrices), so HBM bandwidth. Design: K7 at M <= 16 (where its tables fit a
// block, kernels/rot_matmul.py::bf_route) is the BF variant of the
// one-launch kernel (one_launch.cuh, whose note says what it does about that
// bound): one launch a call, each block running the K stages on x for its
// own groups in shared memory, its tables and x issued before the weight
// ring, the group splits merged behind a counter in split order. K9 at M <=
// 16 and S <= 256 is its I4 variant: K1's numerics in K10's issue order (x,
// the rotation rows and the scale and zero words before the weight ring),
// each block rotating x for its own groups and storing channel i of a group
// at pair slot i, where the interleaved byte-rows want it. The rest
// run K1's passes (w4_passes.cuh): K6 and K7 replace K1's rotate pass with
// prep_kernel below: one block per (group, 8-row tile) stages its rows in
// shared memory, a thread owns the pairs (l, l ^ d) of a stage so the stage
// updates in place, and the rows' bf16 values and their sums go to the GEMV
// pass. K8 is K1's rotate pass in bf16 with a GEMV mode that dequantizes the
// weight; K9 is K1 with a GEMV mode for the interleaved nibbles. No tensor
// cores, no TMA.

#include "one_launch.cuh"
#include "w4_passes.cuh"

using namespace paro;
using namespace paro::w4;

namespace {

constexpr int PREP_THREADS = 256;

// xr [M, I] f32 = bf16(stages(x * inv_s)) (inv_s may be null, K may be 0) and
// xsum [M, G], the row sums per group. Grid (G, ceil(M / rb)); dynamic shared
// memory [rb][S] f32. With K > 0 the group size S is a power of two.
template <typename XT>
__global__ void __launch_bounds__(PREP_THREADS) prep_kernel(
    const XT* __restrict__ x, const float* __restrict__ inv_s, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, float* __restrict__ xr_out, float* __restrict__ xsum_out,
    int M, int I, int S, int K, int rb) {
  extern __shared__ float xsm[];
  __shared__ float red[PREP_THREADS / 32];
  const int G = I / S;
  const int g = blockIdx.x, m0 = blockIdx.y * rb;
  const int nrows = min(rb, M - m0);
  const size_t col = (size_t)g * S;

  for (int e = threadIdx.x; e < rb * S; e += blockDim.x) {
    const int m = e / S, l = e - m * S;
    float v = 0.f;
    if (m < nrows) {
      v = to_f32(x[(size_t)(m0 + m) * I + col + l]);
      if (inv_s) v = __fmul_rn(v, inv_s[col + l]);
    }
    xsm[e] = v;
  }
  __syncthreads();

  if (K > 0) {
    int log_s = 0;
    while ((1 << log_s) < S) ++log_s;
    const int H = S / 2;
    for (int r = 0; r < K; ++r) {
      const int d = 1 << (r % log_s);
      const float* cr = cos_t + (size_t)r * I + col;
      const float* sr = sin_t + (size_t)r * I + col;
      for (int e = threadIdx.x; e < rb * H; e += blockDim.x) {
        const int m = e >> (log_s - 1), t = e & (H - 1);
        const int l = ((t & ~(d - 1)) << 1) | (t & (d - 1));  // bit d clear
        const int pr = l | d;
        float* row = xsm + m * S;
        const float a = row[l], b = row[pr];
        // products rounded apart, as the plain version computes them
        row[l] = __fadd_rn(__fmul_rn(cr[l], a), __fmul_rn(sr[l], b));
        row[pr] = __fadd_rn(__fmul_rn(cr[pr], b), __fmul_rn(sr[pr], a));
      }
      __syncthreads();
    }
  }

  for (int m = 0; m < nrows; ++m) {  // uniform across the block
    float s = 0.f;
    for (int l = threadIdx.x; l < S; l += blockDim.x) {
      const float v = round_to<bf16>(xsm[m * S + l]);
      xr_out[(size_t)(m0 + m) * I + col + l] = v;
      s += v;
    }
    s = block_sum(s, red);
    if (threadIdx.x == 0) xsum_out[(size_t)(m0 + m) * G + g] = s;
  }
}

// rows per prep block: 8, fewer where a group is wide (32 KB of rows at most,
// one row at least)
int prep_rows(int S) {
  const int rb = 8192 / S;
  return rb < 1 ? 1 : (rb > 8 ? 8 : rb);
}

template <typename XT>
cudaError_t launch_prep(const void* x, const void* inv_s, const void* cos_t, const void* sin_t,
                        void* xr, void* xsum, int M, int I, int S, int K, cudaStream_t st) {
  const int rb = prep_rows(S);
  const size_t smem = (size_t)rb * S * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(prep_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(I / S, (M + rb - 1) / rb);
  prep_kernel<XT><<<grid, PREP_THREADS, smem, st>>>(
      (const XT*)x, (const float*)inv_s, (const float*)cos_t, (const float*)sin_t, (float*)xr,
      (float*)xsum, M, I, S, K, rb);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t run_butterfly(const void* x, const void* inv_s, const void* cos_t, const void* sin_t,
                          int K, const void* qweight, const void* scales, const void* zeros,
                          void* out, void* xr, void* xsum, void* partial, int M, int I, int S,
                          int KS, const Parts& parts, int vec4, int sdt, int zdt, cudaStream_t st) {
  cudaError_t err = launch_prep<XT>(x, inv_s, cos_t, sin_t, xr, xsum, M, I, S, K, st);
  if (err != cudaSuccess) return err;
  return launch_gemv<XT, HALF_SPLIT>(xr, nullptr, xsum, nullptr, qweight, scales, zeros, out,
                                     partial, M, I, S, KS, parts, vec4, sdt, zdt, st);
}

template <typename XT>
cudaError_t run_dense(const void* x, const void* rot, const void* qweight, const void* scales,
                      const void* zeros, void* out, void* xr, void* xsum, void* partial, int M,
                      int I, int S, int KS, const Parts& parts, int vec4, int rot_is_bf16,
                      int sdt, int zdt, int interleaved, cudaStream_t st) {
  cudaError_t err = rot_is_bf16
      ? launch_rotate<XT, bf16>(x, rot, xr, nullptr, xsum, nullptr, M, I, S, 1, 0, st)
      : launch_rotate<XT, float>(x, rot, xr, nullptr, xsum, nullptr, M, I, S, 1, 0, st);
  if (err != cudaSuccess) return err;
  if (interleaved)
    return launch_gemv<XT, INTERLEAVED>(xr, nullptr, xsum, nullptr, qweight, scales, zeros, out,
                                        partial, M, I, S, KS, parts, vec4, sdt, zdt, st);
  return launch_gemv<XT, DEQUANT_BF16>(xr, nullptr, xsum, nullptr, qweight, scales, zeros, out,
                                       partial, M, I, S, KS, parts, vec4, sdt, zdt, st);
}

}  // namespace

// K6 (inv_s, cos_t and sin_t null, K = 0) and K7. x [M, I] (f32 or bf16),
// inv_s [I] f32, cos_t/sin_t [K, I] f32, qweight u8 [I/2, O] half-split,
// scales/zeros [G, O] of dtype codes sdt/zdt (0 f32, 1 bf16, 2 f16, 3 uint8),
// out [M, O] in x's dtype. Scratch: xr f32 [M, I], xsum f32 [M, G], partial
// f32 [KS, M, O] when KS > 1. Returns the first CUDA error (0 on success).
extern "C" int paro_butterfly_w4_matmul(const void* x, const void* inv_s, const void* cos_t,
                                        const void* sin_t, int K, const void* qweight,
                                        const void* scales, const void* zeros, void* out, void* xr,
                                        void* xsum, void* partial, int M, int I, int S, int O,
                                        int KS, int x_is_bf16, int sdt, int zdt, void* stream) {
  Parts parts;
  int vec4;
  if (bad_layout(M, I, S, KS, sdt, zdt) || !make_parts(1, &O, parts, vec4) || K < 0 ||
      (K > 0 && (S & (S - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16)
    return (int)run_butterfly<bf16>(x, inv_s, cos_t, sin_t, K, qweight, scales, zeros, out, xr,
                                    xsum, partial, M, I, S, KS, parts, vec4, sdt, zdt, st);
  return (int)run_butterfly<float>(x, inv_s, cos_t, sin_t, K, qweight, scales, zeros, out, xr,
                                   xsum, partial, M, I, S, KS, parts, vec4, sdt, zdt, st);
}

// K7 in one launch (the BF variant): K7's operands as above, the scratch
// partial f32 [KS, M, O] (KS > 1) and counters int32, one per (column tile,
// row tile of one_launch.cuh's row_tile(M, S) rows), zero and left zero;
// KS group splits and column tiles of cw * 128 columns, within the limits
// of one::call. Returns the first CUDA error (0 on success).
extern "C" int paro_butterfly_w4_one_launch(const void* x, const void* inv_s, const void* cos_t,
                                            const void* sin_t, int K, const void* qweight,
                                            const void* scales, const void* zeros, void* out,
                                            void* partial, void* counters, int M, int I, int S,
                                            int O, int KS, int cw, int x_is_bf16, int sdt, int zdt,
                                            void* stream) {
  return (int)one::call<one::BF>(x, nullptr, qweight, scales, zeros, out, partial, counters, M, I,
                                 S, 1, &O, KS, cw, x_is_bf16, 0, sdt, zdt, (cudaStream_t)stream, 0,
                                 0, inv_s, cos_t, sin_t, K);
}

// K9 in one launch (the I4 variant): K9's operands (below; qweight u8 [I/2,
// O] interleaved), the scratch partial f32 [KS, M, O] (KS > 1) and counters
// int32, one per (column tile, row tile of one_launch.cuh's row_tile(M, S)
// rows), zero and left zero; KS group splits and column tiles of cw * 128
// columns, within the limits of one::call. Returns the first CUDA error (0 on
// success).
extern "C" int paro_rot_w4_matmul_i4_one_launch(const void* x, const void* rot, const void* qweight,
                                                const void* scales, const void* zeros, void* out,
                                                void* partial, void* counters, int M, int I, int S,
                                                int O, int KS, int cw, int x_bf16, int rot_bf16,
                                                int sdt, int zdt, void* stream) {
  return (int)one::call<one::I4>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                 1, &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, (cudaStream_t)stream);
}

// K8 (interleaved = 0: half-split nibbles, bf16 rot, bf16 scales and zeros)
// and K9 (interleaved = 1). x [M, I] (f32 or bf16), rot [G, S, S] (f32 or
// bf16), qweight u8 [I/2, O], scales/zeros [G, O] (dtype codes as above), out
// [M, O] in x's dtype. Scratch as for K6.
extern "C" int paro_dense_rot_w4_variant(const void* x, const void* rot, const void* qweight,
                                         const void* scales, const void* zeros, void* out,
                                         void* xr, void* xsum, void* partial, int M, int I, int S,
                                         int O, int KS, int x_is_bf16, int rot_is_bf16, int sdt,
                                         int zdt, int interleaved, void* stream) {
  Parts parts;
  int vec4;
  if (bad_layout(M, I, S, KS, sdt, zdt) || !make_parts(1, &O, parts, vec4) ||
      (!interleaved && (!rot_is_bf16 || sdt != BF16 || zdt != BF16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16)
    return (int)run_dense<bf16>(x, rot, qweight, scales, zeros, out, xr, xsum, partial, M, I, S,
                                KS, parts, vec4, rot_is_bf16, sdt, zdt, interleaved, st);
  return (int)run_dense<float>(x, rot, qweight, scales, zeros, out, xr, xsum, partial, M, I, S, KS,
                               parts, vec4, rot_is_bf16, sdt, zdt, interleaved, st);
}
