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
//      int8 activations per (row, group), an exact int32 dot, summed over
//      the groups in order.
//
// Bound on this card: at the scripts' M = 1 to 32 and 4096 x 4096, the
// weight stream (I*O/2 bytes, plus scales, zeros and rotations), so HBM
// bandwidth. What each design does about it:
//  K10, K12 are variants of K1's one-launch kernel (one_launch.cuh, whose
//      note says what bounds it and what it does about that): each block
//      puts its weight slice in flight through a 16-byte cp.async ring first,
//      rotates x for its own groups, and the group splits merge in split
//      order behind a counter, so a call is one launch and its bits do not
//      depend on scheduling. K10 takes the row sum of the f32 xr before
//      rounding it, K12 rotates the unrounded f32 x and writes f32. At M > 8
//      a call runs ceil(M / 8) row tiles, past one wave where it must.
//  K13 one block per 32-column tile and 8 rows; each warp takes one group of
//      a round of 8, loads its first weight quads, quantizes the block's
//      rows of it into shared memory (rintf of x / sx, half to even, as
//      jnp.round) and runs the int8 x nibble dot with __dp4a on packed
//      quads (4 byte-rows transposed with byte permutes): at M <= 32 an mma
//      tile of 16 rows would be mostly padding, and the dot is bound by the
//      weight bytes, not by its multiply rate. The four quad lanes of a
//      column sum their int32 dots exactly, the epilogue forms
//      (dot - sum(xq) z) (s sx), and one thread per (row, column) adds the
//      round's groups in order, so the f32 sums follow the TPU kernel's.
// Simple and right first: no tensor cores, no TMA.

#include "one_launch.cuh"
#include "w4_passes.cuh"

using namespace paro;
using namespace paro::w4;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 32;                   // columns per block
constexpr int A8_ROWS = 8;                 // K13: rows per block (A8_ROWS * TILE == THREADS)
constexpr int A8_PF = 4;                   // K13: weight quads per lane loaded ahead of a group

__device__ __forceinline__ float load_x(const void* x, size_t i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(x)[i]) : static_cast<const float*>(x)[i];
}

__device__ __forceinline__ void store_y(void* out, size_t i, float v, int bf) {
  if (bf) static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(out)[i] = v;
}

// ---------------------------------------------------------------------------
// K13 w4a8_matmul
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t row_u32(const uint8_t* row, int c, int O, int vec4, bool ok) {
  if (!ok) return 0u;
  if (vec4) return *reinterpret_cast<const uint32_t*>(row + c);
  const uchar4 b = load4(row, c, O, 0);
  return (uint32_t)b.x | ((uint32_t)b.y << 8) | ((uint32_t)b.z << 16) | ((uint32_t)b.w << 24);
}

// Four byte-rows r0..r3 (4 columns each) -> per column j the packed bytes
// (r0[j], r1[j], r2[j], r3[j]).
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           int col[4]) {
  const uint32_t a = __byte_perm(r0, r1, 0x5140), b = __byte_perm(r2, r3, 0x5140);
  const uint32_t c = __byte_perm(r0, r1, 0x7362), d = __byte_perm(r2, r3, 0x7362);
  col[0] = (int)__byte_perm(a, b, 0x5410);
  col[1] = (int)__byte_perm(a, b, 0x7632);
  col[2] = (int)__byte_perm(c, d, 0x5410);
  col[3] = (int)__byte_perm(c, d, 0x7632);
}

__global__ void __launch_bounds__(THREADS) w4a8_kernel(
    const void* __restrict__ x, const uint8_t* __restrict__ qw, const void* __restrict__ scales,
    const void* __restrict__ zeros, void* __restrict__ out, int M, int I, int S, int O,
    int x_bf16, int sdt, int zdt, int vec4) {
  constexpr int BM = A8_ROWS;
  extern __shared__ __align__(16) uint8_t dsm[];
  float* contrib = reinterpret_cast<float*>(dsm);                // [NWARPS][BM][TILE]
  int8_t* xq_all = reinterpret_cast<int8_t*>(contrib + NWARPS * BM * TILE);  // [NWARPS][BM][S]
  const int G = I / S, HALF = S / 2, NQ = HALF / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane & 7, qd = lane >> 3;  // column lane, quad lane
  const int c = blockIdx.x * TILE + 4 * cl;
  const bool ok = c < O;
  const int m0 = blockIdx.y * BM, nrows = min(BM, M - m0);
  int8_t* xq = xq_all + warp * BM * S;
  float* cw = contrib + warp * BM * TILE;
  const int my_m = threadIdx.x / TILE, my_cc = threadIdx.x % TILE;  // the thread's output
  float tot = 0.f;

  for (int g0 = 0; g0 < G; g0 += NWARPS) {
    const int g = g0 + warp;
    if (g < G) {
      // the group's first A8_PF quads per lane, in flight through the quantization
      uint32_t pre[A8_PF][4];
#pragma unroll
      for (int r = 0; r < A8_PF; ++r) {
        const int qi = qd + 4 * r;
        const uint8_t* row = qw + ((size_t)g * HALF + 4 * qi) * O;
#pragma unroll
        for (int p = 0; p < 4; ++p) pre[r][p] = qi < NQ ? row_u32(row + p * (size_t)O, c, O, vec4, ok) : 0u;
      }
      // quantize the block's rows of group g (the warp's own)
      float sx[BM], qsum[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const size_t base = (size_t)(m0 + m) * I + (size_t)g * S;
        float amax = 0.f;
        if (m < nrows)
          for (int k = lane; k < S; k += 32) amax = fmaxf(amax, fabsf(load_x(x, base + k, x_bf16)));
        for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        sx[m] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
        int qs = 0;
        for (int k = lane; k < S; k += 32) {
          const int q = m < nrows ? (int)rintf(__fdiv_rn(load_x(x, base + k, x_bf16), sx[m])) : 0;
          xq[m * S + k] = (int8_t)q;
          qs += q;
        }
        for (int o = 16; o > 0; o >>= 1) qs += __shfl_xor_sync(0xffffffffu, qs, o);
        qsum[m] = (float)qs;
      }
      __syncwarp();

      // the exact dot: quads qd, qd + 4, ... of the half-group's byte-rows
      int acc[BM][4];
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0;
      auto quad = [&](const uint32_t b[4], int k) {
        int lo[4], hi[4];
        transpose4(b[0] & 0x0F0F0F0Fu, b[1] & 0x0F0F0F0Fu, b[2] & 0x0F0F0F0Fu, b[3] & 0x0F0F0F0Fu, lo);
        transpose4((b[0] >> 4) & 0x0F0F0F0Fu, (b[1] >> 4) & 0x0F0F0F0Fu, (b[2] >> 4) & 0x0F0F0F0Fu,
                   (b[3] >> 4) & 0x0F0F0F0Fu, hi);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const int xa = *reinterpret_cast<const int*>(xq + m * S + k);
          const int xb = *reinterpret_cast<const int*>(xq + m * S + HALF + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(hi[j], xb, __dp4a(lo[j], xa, acc[m][j]));
        }
      };
#pragma unroll
      for (int r = 0; r < A8_PF; ++r)
        if (qd + 4 * r < NQ) quad(pre[r], 4 * (qd + 4 * r));
      for (int qi = qd + 4 * A8_PF; qi < NQ; qi += 4) {
        const uint8_t* row = qw + ((size_t)g * HALF + 4 * qi) * O;
        uint32_t b[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) b[p] = row_u32(row + p * (size_t)O, c, O, vec4, ok);
        quad(b, 4 * qi);
      }
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 8);
          acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
        }

      // (dot - sum(xq) z) (s sx); quad lane qd writes rows qd and qd + 4
      float s4[4], z4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool okj = c + j < O;
        s4[j] = okj ? load_f32(scales, (size_t)g * O + c + j, sdt) : 0.f;
        z4[j] = okj ? load_f32(zeros, (size_t)g * O + c + j, zdt) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if ((m & 3) != qd) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cw[m * TILE + 4 * cl + j] = __fmul_rn(__fsub_rn((float)acc[m][j], __fmul_rn(qsum[m], z4[j])),
                                                __fmul_rn(s4[j], sx[m]));
      }
    }
    __syncthreads();
    for (int w = 0; w < NWARPS && g0 + w < G; ++w)  // the round's groups in order
      tot = __fadd_rn(tot, contrib[(w * BM + my_m) * TILE + my_cc]);
    __syncthreads();  // the next round overwrites contrib and xq
  }
  const int col = blockIdx.x * TILE + my_cc;
  if (m0 + my_m < M && col < O) store_y(out, (size_t)(m0 + my_m) * O + col, tot, x_bf16);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

constexpr size_t MAX_SMEM = 227 * 1024;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

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

// K13. x [M, I] (f32 or bf16), qweight u8 [I/2, O] half-split, scales/zeros
// [G, O] (dtype codes as above), group size S a multiple of 8; out [M, O]
// in x's dtype.
extern "C" int paro_w4a8_matmul(const void* x, const void* qweight, const void* scales,
                                const void* zeros, void* out, int M, int I, int S, int O,
                                int x_bf16, int sdt, int zdt, void* stream) {
  const size_t smem = (size_t)NWARPS * A8_ROWS * (TILE * sizeof(float) + S);
  if (bad_layout(M, I, S, 1, sdt, zdt) || O < 1 || S % 8 != 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(w4a8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec4 = O % 4 == 0 && (uintptr_t)qweight % 4 == 0;
  const dim3 grid((O + TILE - 1) / TILE, (M + A8_ROWS - 1) / A8_ROWS);
  w4a8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, (const uint8_t*)qweight, scales, zeros, out, M, I, S, O, x_bf16, sdt, zdt, vec4);
  return (int)cudaGetLastError();
}
