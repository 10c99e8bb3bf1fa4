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
// channel g*S+S/2+k in its high nibble. The group size S is a multiple of 128,
// at most MAX_S (the group sizes the TPU kernel tiles with more than one group).
//
// Bound on this card: at decode (M <= 16) the weight stream, I*O/2 bytes of
// nibbles plus 2*G*O*2 bytes of scales and zeros, so HBM bandwidth. Design:
//  1. rotate pass, one block of S threads per (group, partition, 8-row tile).
//     Each rotation matrix is read once per call. The TPU kernel recomputes
//     the rotation in every column block; at the 151936-wide lm_head a narrow
//     column tile would re-read rot from L2 about a thousand times.
//  2. GEMV pass, one block per (128-column tile, group split, 8-row tile).
//     The 8 warps split each group's S/2 byte-rows in batches of 64; a lane
//     owns 4 adjacent columns (a 4-byte load per byte-row, 128 contiguous
//     bytes per warp), and the registers are capped so that two blocks
//     share an SM. When the column tiles alone cannot fill the SMs, the
//     groups are split across blocks and a third pass sums the f32 partials
//     in a fixed order, so the result does not depend on scheduling.
// Both passes are compiled for each group size. Simple and right first: no
// tensor cores, no TMA; those belong to later work.

#include "common.cuh"

using paro::bf16;
using paro::from_f32;
using paro::round_to;
using paro::to_f32;

namespace {

constexpr int MAX_S = 512;  // largest group size (= rotation block)
constexpr int ROWS = 64;    // byte-rows per GEMV load batch (8 per warp)
constexpr int RM = 8;       // rows per rotate block
constexpr int TMB = 8;      // rows per GEMV block
constexpr int TILE_O = 128; // columns per GEMV block (32 lanes x 4)
constexpr int WARPS = 8;
constexpr int MAXP = 4;

struct Parts {
  int P;
  int offs[MAXP + 1];       // column offset of each partition
  int tile_base[MAXP + 1];  // first column tile of each partition
};

// sum / max of one value per thread over a block of NW warps
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) t += red[w];
  __syncthreads();
  return t;
}

template <int NW>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// Pass 1: xr (W4A16) or xq/sx (a8) for every (partition, row, group).
// x [M, I] in XT; rot [P, G, S, S] in RT (x is rounded to RT first, as the
// TPU kernel casts x to rot's dtype); outputs [P, M, I] and [P, M, G].
// One thread per channel of the group: blockDim.x == S.
template <typename XT, typename RT, bool A8, int S>
__global__ void __launch_bounds__(S) rotate_kernel(
    const XT* __restrict__ x, const RT* __restrict__ rot,
    float* __restrict__ xr_out, int8_t* __restrict__ xq_out,
    float* __restrict__ xsum_out, float* __restrict__ sx_out, int M, int I) {
  constexpr int NW = S / 32;
  const int G = I / S;
  const int g = blockIdx.x, p = blockIdx.y, m0 = blockIdx.z * RM;
  const int i = threadIdx.x;
  __shared__ float xs[RM][S];
  __shared__ float red[NW];

  for (int m = 0; m < RM; ++m)
    xs[m][i] = (m0 + m < M) ? round_to<RT>(to_f32(x[(size_t)(m0 + m) * I + g * S + i])) : 0.f;
  __syncthreads();
  float acc[RM];
#pragma unroll
  for (int m = 0; m < RM; ++m) acc[m] = 0.f;

  // thread i computes output channel i from row i of M_g, read as 16-byte
  // vectors, CHUNK elements' loads in flight at once (S / CHUNK is even)
  constexpr int VEC = 16 / sizeof(RT);
  constexpr int CHUNK = 64;
  const uint4* Ri = reinterpret_cast<const uint4*>(rot + (((size_t)p * G + g) * S + i) * S);
#pragma unroll 2
  for (int j0 = 0; j0 < S; j0 += CHUNK) {
    uint4 w[CHUNK / VEC];
#pragma unroll
    for (int v = 0; v < CHUNK / VEC; ++v) w[v] = Ri[j0 / VEC + v];
#pragma unroll
    for (int v = 0; v < CHUNK / VEC; ++v) {
      const RT* h = reinterpret_cast<const RT*>(&w[v]);
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const float r = to_f32(h[t]);
        const int j = j0 + v * VEC + t;
#pragma unroll
        for (int m = 0; m < RM; ++m) acc[m] = fmaf(xs[m][j], r, acc[m]);
      }
    }
  }

  for (int m = 0; m < RM; ++m) {
    if (m0 + m >= M) break;  // uniform across the block
    const size_t row = (size_t)p * M + m0 + m;
    if (A8) {
      const float amax = block_max<NW>(fabsf(acc[m]), red);
      const float sx = amax > 0.f ? amax / 127.f : 1.f;
      const int q = __float2int_rn(acc[m] / sx);
      xq_out[row * I + g * S + i] = (int8_t)q;
      const float qsum = block_sum<NW>((float)q, red);
      if (i == 0) {
        xsum_out[row * G + g] = qsum;
        sx_out[row * G + g] = sx;
      }
    } else {
      const float v = round_to<bf16>(acc[m]);
      xr_out[row * I + g * S + i] = v;
      const float s = block_sum<NW>(v, red);
      if (i == 0) xsum_out[row * G + g] = s;
    }
  }
}

// Pass 2: the dequantizing GEMV over the groups [ks*gps, (ks+1)*gps).
// Writes out[M, O] directly (partial == nullptr) or f32 partial[KS, M, O].
// The staged activations and the final cross-warp sum share shared memory.
template <int S>
union GemvSmem {
  float xs_f[TMB][S];    // W4A16
  int8_t xs_q[TMB][S];   // a8
  float red[WARPS][TMB][TILE_O];
};

template <typename OT, bool A8, int S>
__global__ void __launch_bounds__(WARPS * 32, 2) gemv_kernel(
    const float* __restrict__ xr, const int8_t* __restrict__ xq,
    const float* __restrict__ xsum, const float* __restrict__ sxv,
    const uint8_t* __restrict__ qw, const bf16* __restrict__ scales,
    const bf16* __restrict__ zeros, OT* __restrict__ out, float* __restrict__ partial,
    int M, int I, int O, int gps, Parts parts) {
  constexpr int HALF = S / 2;
  const int G = I / S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx = blockIdx.x, ks = blockIdx.y, m0 = blockIdx.z * TMB;
  int p = 0;
  while (p + 1 < parts.P && bx >= parts.tile_base[p + 1]) ++p;
  const int col0 = parts.offs[p] + (bx - parts.tile_base[p]) * TILE_O;
  const int col_end = parts.offs[p + 1];
  const int c = col0 + 4 * lane;
  const bool col_ok = c < col_end;  // every split is a multiple of 4 (wrapper checks)
  const int g_begin = ks * gps;
  const int g_end = min(G, g_begin + gps);

  __shared__ GemvSmem<S> sm;
  __shared__ float row_sum[TMB], row_sx[TMB];

  float tot[TMB][4];
#pragma unroll
  for (int m = 0; m < TMB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[m][j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    __syncthreads();
    for (int e = threadIdx.x; e < TMB * S; e += WARPS * 32) {
      const int m = e / S, k = e % S;
      const bool ok = m0 + m < M;
      const size_t idx = ((size_t)p * M + m0 + m) * I + g * S + k;
      if (A8) sm.xs_q[m][k] = ok ? xq[idx] : (int8_t)0;
      else sm.xs_f[m][k] = ok ? xr[idx] : 0.f;
    }
    if (threadIdx.x < TMB) {
      const int m = threadIdx.x;
      const bool ok = m0 + m < M;
      const size_t idx = ((size_t)p * M + m0 + m) * G + g;
      row_sum[m] = ok ? xsum[idx] : 0.f;
      row_sx[m] = (ok && A8) ? sxv[idx] : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;

    float s4[4], z4[4];
    {
      const bf16* sp = scales + (size_t)g * O + c;
      const bf16* zp = zeros + (size_t)g * O + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s4[j] = to_f32(sp[j]);
        z4[j] = to_f32(zp[j]);
      }
    }
    // the group's byte-rows in batches of ROWS, each batch's loads in flight at once
    uchar4 b[ROWS / WARPS];
    if (A8) {
      int acc[TMB][4];
#pragma unroll
      for (int m = 0; m < TMB; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0;
#pragma unroll
      for (int h0 = 0; h0 < HALF; h0 += ROWS) {
#pragma unroll
        for (int r = 0; r < ROWS / WARPS; ++r) {
          const int kk = h0 + warp + WARPS * r;
          b[r] = *reinterpret_cast<const uchar4*>(qw + (size_t)(g * HALF + kk) * O + c);
        }
#pragma unroll
        for (int r = 0; r < ROWS / WARPS; ++r) {
          const int kk = h0 + warp + WARPS * r;
          const int lo[4] = {b[r].x & 15, b[r].y & 15, b[r].z & 15, b[r].w & 15};
          const int hi[4] = {b[r].x >> 4, b[r].y >> 4, b[r].z >> 4, b[r].w >> 4};
#pragma unroll
          for (int m = 0; m < TMB; ++m) {
            const int xa = sm.xs_q[m][kk], xb = sm.xs_q[m][kk + HALF];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][j] += xa * lo[j] + xb * hi[j];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < TMB; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sc = s4[j] * row_sx[m];
          float v = (float)acc[m][j] * sc;
          if (warp == 0) v -= row_sum[m] * z4[j] * sc;
          tot[m][j] += v;
        }
    } else {
      float acc[TMB][4];
#pragma unroll
      for (int m = 0; m < TMB; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
#pragma unroll
      for (int h0 = 0; h0 < HALF; h0 += ROWS) {
#pragma unroll
        for (int r = 0; r < ROWS / WARPS; ++r) {
          const int kk = h0 + warp + WARPS * r;
          b[r] = *reinterpret_cast<const uchar4*>(qw + (size_t)(g * HALF + kk) * O + c);
        }
#pragma unroll
        for (int r = 0; r < ROWS / WARPS; ++r) {
          const int kk = h0 + warp + WARPS * r;
          const float lo[4] = {(float)(b[r].x & 15), (float)(b[r].y & 15),
                               (float)(b[r].z & 15), (float)(b[r].w & 15)};
          const float hi[4] = {(float)(b[r].x >> 4), (float)(b[r].y >> 4),
                               (float)(b[r].z >> 4), (float)(b[r].w >> 4)};
#pragma unroll
          for (int m = 0; m < TMB; ++m) {
            const float xa = sm.xs_f[m][kk], xb = sm.xs_f[m][kk + HALF];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xb, hi[j], fmaf(xa, lo[j], acc[m][j]));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < TMB; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = acc[m][j];
          if (warp == 0) v -= row_sum[m] * z4[j];
          tot[m][j] += v * s4[j];
        }
    }
  }

  __syncthreads();  // red reuses the activations' memory
#pragma unroll
  for (int m = 0; m < TMB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) sm.red[warp][m][4 * lane + j] = tot[m][j];
  __syncthreads();
  for (int e = threadIdx.x; e < TMB * TILE_O; e += WARPS * 32) {
    const int m = e / TILE_O, cc = e % TILE_O;
    const int col = col0 + cc;
    if (m0 + m >= M || col >= col_end) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += sm.red[w][m][cc];
    if (partial) partial[((size_t)ks * M + m0 + m) * O + col] = v;
    else out[(size_t)(m0 + m) * O + col] = from_f32<OT>(v);
  }
}

// Pass 3 (only when the groups were split): out = sum over splits, in order.
template <typename OT>
__global__ void reduce_kernel(const float* __restrict__ partial, OT* __restrict__ out,
                              int KS, size_t n) {
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < KS; ++k) v += partial[(size_t)k * n + idx];
    out[idx] = from_f32<OT>(v);
  }
}

template <typename XT, typename RT, bool A8, int S>
void rotate(dim3 grid, cudaStream_t st, const void* x, const void* rot, void* xr, void* xq,
            void* xsum, void* sx, int M, int I) {
  rotate_kernel<XT, RT, A8, S><<<grid, S, 0, st>>>(
      (const XT*)x, (const RT*)rot, (float*)xr, (int8_t*)xq, (float*)xsum, (float*)sx, M, I);
}

template <typename XT, typename RT, bool A8>
void rotate_s(int S, dim3 grid, cudaStream_t st, const void* x, const void* rot, void* xr,
              void* xq, void* xsum, void* sx, int M, int I) {
  switch (S) {  // the entry point admits only these
    case 128: rotate<XT, RT, A8, 128>(grid, st, x, rot, xr, xq, xsum, sx, M, I); break;
    case 256: rotate<XT, RT, A8, 256>(grid, st, x, rot, xr, xq, xsum, sx, M, I); break;
    case 384: rotate<XT, RT, A8, 384>(grid, st, x, rot, xr, xq, xsum, sx, M, I); break;
    default: rotate<XT, RT, A8, 512>(grid, st, x, rot, xr, xq, xsum, sx, M, I);
  }
}

template <typename XT, typename RT>
cudaError_t launch_rotate(const void* x, const void* rot, void* xr, void* xq, void* xsum,
                          void* sx, int M, int I, int S, int P, int a8, cudaStream_t st) {
  dim3 grid(I / S, P, (M + RM - 1) / RM);
  if (a8) rotate_s<XT, RT, true>(S, grid, st, x, rot, xr, xq, xsum, sx, M, I);
  else rotate_s<XT, RT, false>(S, grid, st, x, rot, xr, xq, xsum, sx, M, I);
  return cudaGetLastError();
}

template <typename OT, bool A8, int S>
void gemv(dim3 grid, cudaStream_t st, const void* xr, const void* xq, const void* xsum,
          const void* sx, const void* qw, const void* scales, const void* zeros, void* out,
          float* part, int M, int I, int O, int gps, const Parts& parts) {
  gemv_kernel<OT, A8, S><<<grid, WARPS * 32, 0, st>>>(
      (const float*)xr, (const int8_t*)xq, (const float*)xsum, (const float*)sx,
      (const uint8_t*)qw, (const bf16*)scales, (const bf16*)zeros, (OT*)out, part, M, I, O, gps,
      parts);
}

template <typename OT, bool A8>
void gemv_s(int S, dim3 grid, cudaStream_t st, const void* xr, const void* xq, const void* xsum,
            const void* sx, const void* qw, const void* scales, const void* zeros, void* out,
            float* part, int M, int I, int O, int gps, const Parts& parts) {
  switch (S) {  // the entry point admits only these
    case 128: gemv<OT, A8, 128>(grid, st, xr, xq, xsum, sx, qw, scales, zeros, out, part, M, I, O, gps, parts); break;
    case 256: gemv<OT, A8, 256>(grid, st, xr, xq, xsum, sx, qw, scales, zeros, out, part, M, I, O, gps, parts); break;
    case 384: gemv<OT, A8, 384>(grid, st, xr, xq, xsum, sx, qw, scales, zeros, out, part, M, I, O, gps, parts); break;
    default: gemv<OT, A8, 512>(grid, st, xr, xq, xsum, sx, qw, scales, zeros, out, part, M, I, O, gps, parts);
  }
}

template <typename OT>
cudaError_t launch_gemv(const void* xr, const void* xq, const void* xsum, const void* sx,
                        const void* qw, const void* scales, const void* zeros, void* out,
                        void* partial, int M, int I, int S, int O, int KS, const Parts& parts,
                        int n_tiles, int a8, cudaStream_t st) {
  const int G = I / S;
  const int gps = (G + KS - 1) / KS;
  dim3 grid(n_tiles, KS, (M + TMB - 1) / TMB);
  float* part = KS > 1 ? (float*)partial : nullptr;
  if (a8)
    gemv_s<OT, true>(S, grid, st, xr, xq, xsum, sx, qw, scales, zeros, out, part, M, I, O, gps, parts);
  else
    gemv_s<OT, false>(S, grid, st, xr, xq, xsum, sx, qw, scales, zeros, out, part, M, I, O, gps, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || KS == 1) return err;
  const size_t n = (size_t)M * O;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_kernel<OT><<<blocks, 256, 0, st>>>(part, (OT*)out, KS, n);
  return cudaGetLastError();
}

}  // namespace

// x [M, I] (f32 or bf16), rot [P, G, S, S] (f32 or bf16), qweight u8
// [I/2, O], scales/zeros bf16 [G, O], out [M, O] in x's dtype. Scratch from
// the caller: xr f32 [P, M, I] (W4A16) or xq int8 [P, M, I] (a8), xsum and sx
// f32 [P, M, G], partial f32 [KS, M, O] when KS > 1. `splits` (host array of
// P ints, each a multiple of 4) are the partitions' column counts.
// Returns the first CUDA error (0 on success). Launches on `stream`, no sync.
extern "C" int paro_rot_w4_matmul(const void* x, const void* rot, const void* qweight,
                                  const void* scales, const void* zeros, void* out, void* xr,
                                  void* xq, void* xsum, void* sx, void* partial, int M, int I,
                                  int S, int P, const int* splits, int KS, int x_is_bf16,
                                  int rot_is_bf16, int a8, void* stream) {
  if (P < 1 || P > MAXP || S < 128 || S > MAX_S || S % 128 != 0 || I % S != 0 || M < 1 || KS < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Parts parts;
  parts.P = P;
  parts.offs[0] = 0;
  parts.tile_base[0] = 0;
  for (int p = 0; p < P; ++p) {
    if (splits[p] % 4 != 0) return (int)cudaErrorInvalidValue;
    parts.offs[p + 1] = parts.offs[p] + splits[p];
    parts.tile_base[p + 1] = parts.tile_base[p] + (splits[p] + TILE_O - 1) / TILE_O;
  }
  for (int p = P + 1; p <= MAXP; ++p) parts.offs[p] = parts.tile_base[p] = 0;
  const int O = parts.offs[P];
  const int n_tiles = parts.tile_base[P];

  cudaError_t err;
  if (x_is_bf16 && rot_is_bf16) err = launch_rotate<bf16, bf16>(x, rot, xr, xq, xsum, sx, M, I, S, P, a8, st);
  else if (x_is_bf16) err = launch_rotate<bf16, float>(x, rot, xr, xq, xsum, sx, M, I, S, P, a8, st);
  else if (rot_is_bf16) err = launch_rotate<float, bf16>(x, rot, xr, xq, xsum, sx, M, I, S, P, a8, st);
  else err = launch_rotate<float, float>(x, rot, xr, xq, xsum, sx, M, I, S, P, a8, st);
  if (err != cudaSuccess) return (int)err;
  if (x_is_bf16)
    err = launch_gemv<bf16>(xr, xq, xsum, sx, qweight, scales, zeros, out, partial, M, I, S, O, KS,
                            parts, n_tiles, a8, st);
  else
    err = launch_gemv<float>(xr, xq, xsum, sx, qweight, scales, zeros, out, partial, M, I, S, O, KS,
                             parts, n_tiles, a8, st);
  return (int)err;
}
