// The W4 GEMV design experiments of the TPU scripts, for Hopper (sm_90a).
//
// Replace the kernels of four scripts (formulas in ../w4_experiments.py):
//  K10 scripts/kernel_edge_test.py::rot_w4_matmul_b (_kernel_b): K1's math in
//      one launch, the zero-point term from the row sum of the unrounded
//      rotation; out in x's dtype.
//  K11 scripts/kernel_dma_pipeline.py::dma_rot_w4_matmul (_kernel_dma): the
//      weight dequantized in bf16, w = bf16(bf16(q - z) * s), streamed in
//      chunks of Gb groups through two shared-memory stages.
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
//  K11 one launch. A block owns a 32-column tile (128 blocks at O = 4096, one
//      wave on 132 SMs) and an M tile, and the blocks of a cluster of 8
//      column tiles share the rotation: block rank r rotates groups r, r + 8,
//      ... (its warps read rows of M_g whole, 16 lanes to a bf16 row) and
//      writes the bf16 values into every block's shared memory (distributed
//      shared memory). A first version that rotated every group in every
//      block was several times slower: each block then reads all of M_g
//      (1 MB at this shape) and waits on it group after group. After one
//      cluster barrier it streams the tile's strip in chunks of Gb groups
//      with cp.async.cg 16-byte copies (commit / wait groups) into two
//      stages, chunk c + 1 in flight while chunk c is dequantized and
//      consumed (the first chunk in flight through the rotation). Two stages
//      are Gb * S/2 byte-rows x 32 bytes (32 KB at Gb = 8, S = 128). The f32
//      sums stay in registers; no scratch in device memory, no second pass.
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

#include <cooperative_groups.h>

#include "one_launch.cuh"
#include "w4_passes.cuh"

namespace cg = cooperative_groups;
using namespace paro;
using namespace paro::w4;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 32;                   // columns per block
constexpr int LANES_C = TILE / 4;          // lanes across a tile, 4 columns each
constexpr int SLICES = THREADS / LANES_C;  // byte-row slices of a block
constexpr int CLUSTER = 8;                 // K11: column tiles sharing a rotation
constexpr int RV = 16;                     // 16-byte vectors of M_g in flight per thread
constexpr int A8_ROWS = 8;                 // K13: rows per block (A8_ROWS * TILE == THREADS)
constexpr int A8_PF = 4;                   // K13: weight quads per lane loaded ahead of a group

__device__ __forceinline__ float load_x(const void* x, size_t i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(x)[i]) : static_cast<const float*>(x)[i];
}

__device__ __forceinline__ void store_y(void* out, size_t i, float v, int bf) {
  if (bf) static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(out)[i] = v;
}

// xs[m][j] = bf16(x[m0 + m, g*S + j]) (0 for rows past nrows)
template <int BM>
__device__ __forceinline__ void stage_x(const void* x, int x_bf16, float* xs, int m0, int nrows,
                                        int I, int S, int g) {
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const size_t base = (size_t)m0 * I + (size_t)g * S + j;
    float v[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) v[m] = m < nrows ? round_to<bf16>(load_x(x, base + (size_t)m * I, x_bf16)) : 0.f;
#pragma unroll
    for (int m = 0; m < BM; ++m) xs[m * S + j] = v[m];
  }
}

// acc[m] = sum_j xs[m][j] * bf16(R_i[j]), R_i one row of M_g (S values of
// RT); RV vectors of the row in flight at once where `vec`
template <typename RT, int BM>
__device__ __forceinline__ void rot_row(const RT* __restrict__ Ri, const float* xs, int S, int vec,
                                        float acc[BM]) {
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;
  int j = 0;
  if (vec) {
    constexpr int VEC = 16 / sizeof(RT);
    const uint4* R4 = reinterpret_cast<const uint4*>(Ri);
    for (; j + RV * VEC <= S; j += RV * VEC) {
      uint4 w[RV];
#pragma unroll
      for (int v = 0; v < RV; ++v) w[v] = __ldg(R4 + j / VEC + v);
#pragma unroll
      for (int v = 0; v < RV; ++v) {
        const RT* h = reinterpret_cast<const RT*>(&w[v]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float r = round_to<bf16>(to_f32(h[e]));
          const int jj = j + v * VEC + e;
#pragma unroll
          for (int m = 0; m < BM; ++m) acc[m] = fmaf(xs[m * S + jj], r, acc[m]);
        }
      }
    }
  }
  for (; j < S; ++j) {
    const float r = round_to<bf16>(to_f32(Ri[j]));
#pragma unroll
    for (int m = 0; m < BM; ++m) acc[m] = fmaf(xs[m * S + j], r, acc[m]);
  }
}

// The rows of M_g read by whole warps, coalesced: `lpr` lanes share a row
// (16 bytes each, lpr = S * sizeof(RT) / 16 dividing 32), RB rows per lane
// in flight; each lane dots its slice of the row with the staged rows, and
// the lpr lanes add their parts by shuffles. The row's first lane stores
// the rounded value.
template <typename RT, int BM, typename Store>
__device__ __forceinline__ void rotate_rows_warp(const RT* __restrict__ rot_g, const float* xs,
                                                 Store store, int S, int lpr) {
  constexpr int VEC = 16 / sizeof(RT);
  constexpr int RB = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr, sub = lane / lpr, l = lane % lpr;
  const int step = NWARPS * rpw;  // rows per block step
  for (int i0 = warp * rpw + sub; i0 - sub < S; i0 += step * RB) {  // warp-uniform bound
    uint4 w[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r * step;
      w[r] = i < S ? __ldg(reinterpret_cast<const uint4*>(rot_g + (size_t)i * S) + l)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r * step;
      float rv[VEC];
      const RT* h = reinterpret_cast<const RT*>(&w[r]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) rv[e] = round_to<bf16>(to_f32(h[e]));
      float acc[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float4* x4 = reinterpret_cast<const float4*>(xs + m * S + l * VEC);
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 v = x4[q];
          a = fmaf(v.x, rv[4 * q], a);
          a = fmaf(v.y, rv[4 * q + 1], a);
          a = fmaf(v.z, rv[4 * q + 2], a);
          a = fmaf(v.w, rv[4 * q + 3], a);
        }
        acc[m] = a;
      }
      for (int o = lpr / 2; o > 0; o >>= 1)
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
      if (l == 0 && i < S) {
#pragma unroll
        for (int m = 0; m < BM; ++m) store(m, i, round_to<bf16>(acc[m]));
      }
    }
  }
}

// store(m, i, bf16(xs[m] . bf16(M_g[i]))) for the group's S channels. lpr >
// 0: rows read by warps (rotate_rows_warp); else each thread takes whole
// rows, read as vectors where `vec`.
template <typename RT, int BM, typename Store>
__device__ __forceinline__ void rotate_group(const RT* __restrict__ rot_g, const float* xs,
                                             Store store, int S, int vec, int lpr) {
  if (lpr > 0) {
    rotate_rows_warp<RT, BM>(rot_g, xs, store, S, lpr);
    return;
  }
  for (int i0 = 0; i0 < S; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    if (i >= S) continue;
    float acc[BM];
    rot_row<RT, BM>(rot_g + (size_t)i * S, xs, S, vec, acc);
#pragma unroll
    for (int m = 0; m < BM; ++m) store(m, i, round_to<bf16>(acc[m]));
  }
}

// Shared memory of K11, byte offsets from the dynamic base.
//   stage  the two weight stages [2][Gb * S/2][TILE] bytes (16-byte aligned, first)
//   xr     the rotated rows, bf16 [BM][G][S + 2] (the pad spreads groups over banks)
//   xs     one group of x, f32 [BM][S]
//   red    the tile's partial sums, f32 [NWARPS][BM][TILE]
//   sz     the bf16-rounded scales and zeros of a chunk, f32 [Gb][2][TILE]
struct Smem {
  size_t stage, xr, xs, red, sz, total;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Smem smem_layout(int BM, int G, int S, int Gb) {
  Smem L;
  L.stage = 0;
  L.xr = L.stage + align16((size_t)2 * Gb * (S / 2) * TILE);
  L.xs = L.xr + align16((size_t)BM * G * (S + 2) * sizeof(bf16));
  L.red = L.xs + align16((size_t)BM * S * sizeof(float));
  L.sz = L.red + align16((size_t)NWARPS * BM * TILE * sizeof(float));
  L.total = L.sz + align16((size_t)Gb * 2 * TILE * sizeof(float));
  return L;
}

// The cluster's shared rotation: block rank r rotates groups r, r + CLUSTER,
// ... of x's rows [m0, m0 + BM) (x and M_g rounded to bf16) and writes each
// bf16 value into every block's xr. The caller syncs the cluster before
// (every block has started) and after (every write has landed).
template <typename RT, int BM>
__device__ __forceinline__ void cluster_rotate(const void* x, int x_bf16, const RT* __restrict__ rot,
                                               uint8_t* dsm, const Smem& L, int m0, int nrows,
                                               int I, int S, int vec, int lpr) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = I / S, LDG = S + 2;
  float* xs = reinterpret_cast<float*>(dsm + L.xs);
  bf16* xr_k[CLUSTER];
#pragma unroll
  for (int k = 0; k < CLUSTER; ++k)
    xr_k[k] = cluster.map_shared_rank(reinterpret_cast<bf16*>(dsm + L.xr), k);
  for (int g = (int)cluster.block_rank(); g < G; g += CLUSTER) {
    __syncthreads();  // the previous group's readers of xs are done
    stage_x<BM>(x, x_bf16, xs, m0, nrows, I, S, g);
    __syncthreads();
    auto store = [&](int m, int i, float v) {
      const bf16 b = __float2bfloat16_rn(v);  // exact: v is bf16-rounded
      const size_t idx = ((size_t)m * G + g) * LDG + i;
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k) xr_k[k][idx] = b;
    };
    rotate_group<RT, BM>(rot + (size_t)g * S * S, xs, store, S, vec, lpr);
  }
}

// Sum the block's partials of its tile (the four slices of a warp by
// shuffles, then the warps in order) and store rows [m0, M) of it.
template <int BM>
__device__ __forceinline__ void store_tile(float tot[BM][4], float* red, void* out, int out_bf16,
                                           int m0, int M, int O) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = tot[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      tot[m][j] = v;
    }
  if (lane < LANES_C) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * BM + m) * TILE + 4 * lane + j] = tot[m][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * TILE; e += blockDim.x) {
    const int m = e / TILE, cc = e % TILE, col = blockIdx.x * TILE + cc;
    if (m0 + m >= M || col >= O) continue;
    float v = 0.f;
    for (int w = 0; w < NWARPS; ++w) v += red[(w * BM + m) * TILE + cc];
    store_y(out, (size_t)(m0 + m) * O + col, v, out_bf16);
  }
}

template <int BM>
__device__ __forceinline__ void zero_tot(float tot[BM][4]) {
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[m][j] = 0.f;
}

// ---------------------------------------------------------------------------
// K11 dma_rot_w4_matmul
// ---------------------------------------------------------------------------

// Byte-rows [ci * rows, (ci + 1) * rows) of the block's 32-column strip into
// dst[rows][TILE], columns past O zero-filled: 16-byte cp.async copies when
// `async16` (O a multiple of 16, the weight 16-byte aligned), else plain
// byte copies.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* __restrict__ qw, int ci,
                                           int rows, int O, int async16) {
  const int col0 = blockIdx.x * TILE;
  for (int e = threadIdx.x; e < 2 * rows; e += blockDim.x) {
    const int r = e >> 1, h = (e & 1) * 16;
    const uint8_t* row = qw + ((size_t)ci * rows + r) * O;
    uint8_t* d = dst + r * TILE + h;
    const int n = min(16, max(0, O - (col0 + h)));
    if (async16) {
      cp_async16(d, n > 0 ? row + col0 + h : row, n);
    } else {
      for (int k = 0; k < 16; ++k) d[k] = k < n ? row[col0 + h + k] : (uint8_t)0;
    }
  }
}

template <typename RT, int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS) dma_rot_w4_kernel(
    const void* __restrict__ x, const RT* __restrict__ rot, const uint8_t* __restrict__ qw,
    const void* __restrict__ scales, const void* __restrict__ zeros, void* __restrict__ out,
    int M, int I, int S, int O, int Gb, int x_bf16, int sdt, int zdt, int vec, int lpr,
    int async16) {
  extern __shared__ __align__(16) uint8_t dsm[];
  const int G = I / S, HALF = S / 2, LDG = S + 2, rows = Gb * HALF, n_chunks = G / Gb;
  const Smem L = smem_layout(BM, G, S, Gb);
  uint8_t* stage = dsm + L.stage;
  float* sz = reinterpret_cast<float*>(dsm + L.sz);
  const bf16* xr = reinterpret_cast<const bf16*>(dsm + L.xr);
  const int m0 = blockIdx.y * BM, nrows = min(BM, M - m0);
  const int lane_c = threadIdx.x % LANES_C, slice = threadIdx.x / LANES_C;
  const int c = blockIdx.x * TILE + 4 * lane_c;

  copy_chunk(stage, qw, 0, rows, O, async16);  // in flight through the rotation
  cp_async_commit();
  cg::this_cluster().sync();
  cluster_rotate<RT, BM>(x, x_bf16, rot, dsm, L, m0, nrows, I, S, vec, lpr);
  cg::this_cluster().sync();

  float tot[BM][4];
  zero_tot<BM>(tot);
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci > 0) __syncthreads();  // chunk ci - 1's readers of its stage and sz are done
    if (ci + 1 < n_chunks) copy_chunk(stage + ((ci + 1) & 1) * rows * TILE, qw, ci + 1, rows, O, async16);
    cp_async_commit();  // possibly empty, so that "all but the newest group" is chunk ci
    for (int e = threadIdx.x; e < Gb * 2 * TILE; e += blockDim.x) {
      const int gi = e / (2 * TILE), which = (e / TILE) & 1, col = blockIdx.x * TILE + e % TILE;
      const size_t idx = (size_t)(ci * Gb + gi) * O + col;
      sz[e] = col < O ? round_to<bf16>(which ? load_f32(zeros, idx, zdt) : load_f32(scales, idx, sdt)) : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();  // every thread's copies of chunk ci and the chunk's sz have landed
    if (c >= O) continue;
    const uint8_t* cur = stage + (ci & 1) * rows * TILE;
    for (int r = slice; r < rows; r += SLICES) {
      const int gi = r / HALF, kk = r - gi * HALF;
      const uchar4 b = *reinterpret_cast<const uchar4*>(cur + r * TILE + 4 * lane_c);
      const float* s = sz + gi * 2 * TILE + 4 * lane_c;
      const float* z = s + TILE;
      const int lo[4] = {b.x & 15, b.y & 15, b.z & 15, b.w & 15};
      const int hi[4] = {b.x >> 4, b.y >> 4, b.z >> 4, b.w >> 4};
      float wl[4], wh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wl[j] = round_to<bf16>(round_to<bf16>((float)lo[j] - z[j]) * s[j]);
        wh[j] = round_to<bf16>(round_to<bf16>((float)hi[j] - z[j]) * s[j]);
      }
      const bf16* xg = xr + (size_t)(ci * Gb + gi) * LDG;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xa = __bfloat162float(xg[(size_t)m * G * LDG + kk]);
        const float xb = __bfloat162float(xg[(size_t)m * G * LDG + HALF + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) tot[m][j] = fmaf(xb, wh[j], fmaf(xa, wl[j], tot[m][j]));
      }
    }
  }
  cp_async_wait<0>();
  store_tile<BM>(tot, reinterpret_cast<float*>(dsm + L.red), out, x_bf16, m0, M, O);
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

// lanes sharing a row of M_g in rotate_rows_warp (0: one thread per row)
template <typename RT>
int warp_lanes(int S, int vec) {
  const int n = (int)(S * sizeof(RT) / 16);
  return vec && n >= 1 && n <= 32 && (32 % n) == 0 ? n : 0;
}

// column tiles, rounded up to whole clusters (the extra blocks only rotate)
int cluster_tiles(int O) {
  const int n = (O + TILE - 1) / TILE;
  return (n + CLUSTER - 1) / CLUSTER * CLUSTER;
}

int dma_rows(int M) { return M == 1 ? 1 : 8; }

template <typename RT, int BM>
cudaError_t launch_dma(const void* x, const void* rot, const void* qw, const void* scales,
                       const void* zeros, void* out, int M, int I, int S, int O, int Gb,
                       int x_bf16, int sdt, int zdt, cudaStream_t st) {
  const int vec = (S * sizeof(RT)) % 16 == 0 && (uintptr_t)rot % 16 == 0;
  const int async16 = O % 16 == 0 && (uintptr_t)qw % 16 == 0;
  const size_t smem = smem_layout(BM, I / S, S, Gb).total;
  cudaError_t err = allow_smem(dma_rot_w4_kernel<RT, BM>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cluster_tiles(O), (M + BM - 1) / BM);
  dma_rot_w4_kernel<RT, BM><<<grid, THREADS, smem, st>>>(
      x, (const RT*)rot, (const uint8_t*)qw, scales, zeros, out, M, I, S, O, Gb, x_bf16, sdt, zdt,
      vec, warp_lanes<RT>(S, vec), async16);
  return cudaGetLastError();
}

template <typename RT>
cudaError_t dispatch_dma(const void* x, const void* rot, const void* qw, const void* scales,
                         const void* zeros, void* out, int M, int I, int S, int O, int Gb,
                         int x_bf16, int sdt, int zdt, cudaStream_t st) {
  if (dma_rows(M) == 1)
    return launch_dma<RT, 1>(x, rot, qw, scales, zeros, out, M, I, S, O, Gb, x_bf16, sdt, zdt, st);
  return launch_dma<RT, 8>(x, rot, qw, scales, zeros, out, M, I, S, O, Gb, x_bf16, sdt, zdt, st);
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

// K11: K10's operands (s and z rounded to bf16 in the kernel), Gb groups per
// streamed chunk, G a multiple of Gb; out [M, O] in x's dtype.
extern "C" int paro_dma_rot_w4_matmul(const void* x, const void* rot, const void* qweight,
                                      const void* scales, const void* zeros, void* out, int M,
                                      int I, int S, int O, int Gb, int x_bf16, int rot_bf16,
                                      int sdt, int zdt, void* stream) {
  if (bad_layout(M, I, S, 1, sdt, zdt) || O < 1 || Gb < 1 || (I / S) % Gb != 0 ||
      smem_layout(dma_rows(M), I / S, S, Gb).total > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rot_bf16)
    return (int)dispatch_dma<bf16>(x, rot, qweight, scales, zeros, out, M, I, S, O, Gb, x_bf16, sdt, zdt, st);
  return (int)dispatch_dma<float>(x, rot, qweight, scales, zeros, out, M, I, S, O, Gb, x_bf16, sdt, zdt, st);
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
