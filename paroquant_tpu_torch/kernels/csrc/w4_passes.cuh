// The passes shared by the package's W4 matmuls (rot_w4_matmul.cu: K1, K2;
// w4_variants.cu: K6-K9).
//
//  rotate pass  xr_g = round(x_g @ M_g^T) per (partition, row, group), with the
//               row sums the zero-point correction needs, or the a8 branch's
//               int8 activations and per-(row, group) scales;
//  GEMV pass    out = sum over groups of the group's dot with the weight
//               nibbles, over 128-column tiles, the groups optionally split
//               across blocks;
//  reduce pass  the splits' f32 partials summed in a fixed order.
//
// The group size S is a runtime argument: any even S that divides I. The
// rotate pass stages the group's inputs in chunks of JC channels and each
// thread streams its rows of M_g (S x S, 2 MB of bf16 at S = 1024) from
// memory once; the GEMV pass stages a group's activations in chunks of CB
// byte-rows. So one instance serves every group layout, and a scale or zero
// dtype is a runtime code converted to f32 in the kernel, which reads the
// bytes of its storage dtype.

#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace paro {
namespace w4 {

constexpr int RM = 8;            // rows per rotate block
constexpr int ROT_THREADS = 256;
constexpr int JC = 512;          // input channels staged per rotate chunk
constexpr int TMB = 8;           // rows per GEMV block
constexpr int TILE_O = 128;      // columns per GEMV block (32 lanes x 4)
constexpr int WARPS = 8;
constexpr int ROWS = 64;         // byte-rows per GEMV load batch (8 per warp)
constexpr int CB = 256;          // byte-rows per staged GEMV chunk
constexpr int MAXP = 4;

// storage dtype codes of scales and zeros
enum DType { F32 = 0, BF16 = 1, F16 = 2, U8 = 3 };

// what the GEMV pass does with a byte-row
enum GemvMode {
  HALF_SPLIT = 0,   // nibbles of channels k, k + S/2; (xr.q - rowsum*z)*s   (K1, K2, K6, K7)
  HALF_SPLIT_A8,    // the same with int8 activations, *sx                   (K1, K2 a8)
  INTERLEAVED,      // nibbles of channels 2k, 2k + 1                        (K9)
  DEQUANT_BF16,     // w = bf16(bf16(q - z)*s) on the weight side, xr.w    (K8)
};

struct Parts {
  int P;
  int offs[MAXP + 1];       // column offset of each partition
  int tile_base[MAXP + 1];  // first column tile of each partition
};

__device__ __forceinline__ float load_f32(const void* p, size_t i, int dt) {
  switch (dt) {
    case F32: return static_cast<const float*>(p)[i];
    case BF16: return __bfloat162float(static_cast<const bf16*>(p)[i]);
    case F16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return (float)static_cast<const uint8_t*>(p)[i];
  }
}

// sum / max of one value per thread over the block (blockDim.x a multiple of 32)
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// Rotate pass. x [M, I] in XT; rot [P, G, S, S] in RT (x is rounded to RT
// first, as the TPU kernels cast x to rot's dtype). Writes xr f32 [P, M, I]
// (the bf16-rounded values; for a8 and S > blockDim.x the unrounded ones, as
// scratch), xsum
// [P, M, G], and for a8 xq int8 [P, M, I] and sx [P, M, G] with
// sx = max|xr| / 127 over the whole group (1 for an all-zero row) and
// xq = rint(xr / sx), half to even. Grid (G, P, ceil(M / RM)); thread t
// computes output channels t, t + blockDim.x, ... from rows of M_g read as
// 16-byte vectors where `vec` says they are aligned.
template <typename XT, typename RT, bool A8>
__global__ void __launch_bounds__(ROT_THREADS) rotate_kernel(
    const XT* __restrict__ x, const RT* __restrict__ rot, float* xr_out,
    int8_t* __restrict__ xq_out, float* __restrict__ xsum_out, float* __restrict__ sx_out,
    int M, int I, int S, int vec) {
  const int G = I / S;
  const int g = blockIdx.x, p = blockIdx.y, m0 = blockIdx.z * RM;
  const int nrows = min(RM, M - m0);
  const size_t row0 = (size_t)p * M + m0;
  __shared__ float xs[RM][JC];
  __shared__ float red[ROT_THREADS / 32];

  float part[RM];  // running bf16 sum (W4A16) or max |xr| (a8) of the thread's channels
  float own[RM];   // a8: the thread's last channel's xr (its only one when S <= blockDim.x)
#pragma unroll
  for (int m = 0; m < RM; ++m) part[m] = own[m] = 0.f;

  for (int i0 = 0; i0 < S; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool iv = i < S;
    const RT* Ri = rot + (((size_t)p * G + g) * S + (iv ? i : 0)) * S;
    float acc[RM];
#pragma unroll
    for (int m = 0; m < RM; ++m) acc[m] = 0.f;

    for (int j0 = 0; j0 < S; j0 += JC) {
      const int jn = min(JC, S - j0);
      __syncthreads();
      for (int jj = threadIdx.x; jj < jn; jj += blockDim.x) {  // the rows' loads in flight at once
        const XT* xp = x + (size_t)m0 * I + (size_t)g * S + j0 + jj;
        float v[RM];
#pragma unroll
        for (int m = 0; m < RM; ++m) v[m] = m < nrows ? round_to<RT>(to_f32(xp[(size_t)m * I])) : 0.f;
#pragma unroll
        for (int m = 0; m < RM; ++m) xs[m][jj] = v[m];
      }
      __syncthreads();
      if (!iv) continue;
      int jj = 0;
      if (vec) {  // 16 vectors' loads in flight at once
        constexpr int VEC = 16 / sizeof(RT);
        constexpr int CHUNK = 16 * VEC;
        const uint4* R4 = reinterpret_cast<const uint4*>(Ri + j0);
        for (; jj + CHUNK <= jn; jj += CHUNK) {
          uint4 w[CHUNK / VEC];
#pragma unroll
          for (int v = 0; v < CHUNK / VEC; ++v) w[v] = R4[jj / VEC + v];
#pragma unroll
          for (int v = 0; v < CHUNK / VEC; ++v) {
            const RT* h = reinterpret_cast<const RT*>(&w[v]);
#pragma unroll
            for (int t = 0; t < VEC; ++t) {
              const float r = to_f32(h[t]);
              const int j = jj + v * VEC + t;
#pragma unroll
              for (int m = 0; m < RM; ++m) acc[m] = fmaf(xs[m][j], r, acc[m]);
            }
          }
        }
      }
      for (; jj < jn; ++jj) {
        const float r = to_f32(Ri[j0 + jj]);
#pragma unroll
        for (int m = 0; m < RM; ++m) acc[m] = fmaf(xs[m][jj], r, acc[m]);
      }
    }

    if (iv) {
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        if (m < nrows) {
          const size_t idx = (row0 + m) * I + (size_t)g * S + i;
          if (A8) {
            if (S > (int)blockDim.x) xr_out[idx] = acc[m];  // else it stays in own[m]
            own[m] = acc[m];
            part[m] = fmaxf(part[m], fabsf(acc[m]));
          } else {
            const float v = round_to<bf16>(acc[m]);
            xr_out[idx] = v;
            part[m] += v;
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < RM; ++m) {
    if (m >= nrows) break;  // uniform across the block
    const size_t row = row0 + m;
    if (A8) {
      const float amax = block_max(part[m], red);
      const float sx = amax > 0.f ? amax / 127.f : 1.f;
      float qs = 0.f;
      for (int i = threadIdx.x; i < S; i += blockDim.x) {  // the channels this thread wrote
        const size_t idx = row * I + (size_t)g * S + i;
        const float v = S <= (int)blockDim.x ? own[m] : xr_out[idx];
        const int q = __float2int_rn(v / sx);
        xq_out[idx] = (int8_t)q;
        qs += (float)q;
      }
      const float qsum = block_sum(qs, red);
      if (threadIdx.x == 0) {
        xsum_out[row * G + g] = qsum;
        sx_out[row * G + g] = sx;
      }
    } else {
      const float s = block_sum(part[m], red);
      if (threadIdx.x == 0) xsum_out[row * G + g] = s;
    }
  }
}

// Four weight bytes at columns c..c+3 of one byte-row; past col_end they are
// 0. `vec4`: every partition's columns start and end on a multiple of 4, so
// one aligned 4-byte load reads them.
__device__ __forceinline__ uchar4 load4(const uint8_t* row, int c, int col_end, int vec4) {
  if (vec4) return *reinterpret_cast<const uchar4*>(row + c);
  uchar4 b;
  b.x = row[c];
  b.y = c + 1 < col_end ? row[c + 1] : 0;
  b.z = c + 2 < col_end ? row[c + 2] : 0;
  b.w = c + 3 < col_end ? row[c + 3] : 0;
  return b;
}

// GEMV pass over the groups [ks*gps, (ks+1)*gps). Writes out [M, O] directly
// (partial == nullptr) or f32 partial [KS, M, O]. One block per (128-column
// tile, group split, TMB-row tile): the 8 warps split each chunk's byte-rows
// in batches of 64, a lane owns 4 adjacent columns (128 contiguous bytes per
// warp and byte-row), and the registers are capped so that two blocks share
// an SM. W4A16 folds the group's scale into the nibbles (sum_k x_k (q_k s)
// - rowsum * z * s), so the sums over groups need no second accumulator; a8
// keeps the group's dot exact in int32. The staged activations and the final
// cross-warp sum share shared memory.
union GemvSmem {
  float xs_f[TMB][2 * CB];   // float activations of one chunk
  int8_t xs_q[TMB][2 * CB];  // a8
  float red[WARPS][TMB][TILE_O];
};

template <typename OT, int MODE>
__global__ void __launch_bounds__(WARPS * 32, 2) gemv_kernel(
    const float* __restrict__ xr, const int8_t* __restrict__ xq,
    const float* __restrict__ xsum, const float* __restrict__ sxv,
    const uint8_t* __restrict__ qw, const void* __restrict__ scales,
    const void* __restrict__ zeros, OT* __restrict__ out, float* __restrict__ partial,
    int M, int I, int S, int gps, int sdt, int zdt, int vec4, Parts parts) {
  constexpr bool Q8 = MODE == HALF_SPLIT_A8;
  const int HALF = S / 2;
  const int G = I / S;
  const int O = parts.offs[parts.P];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx = blockIdx.x, ks = blockIdx.y, m0 = blockIdx.z * TMB;
  int p = 0;
  while (p + 1 < parts.P && bx >= parts.tile_base[p + 1]) ++p;
  const int col0 = parts.offs[p] + (bx - parts.tile_base[p]) * TILE_O;
  const int col_end = parts.offs[p + 1];
  const int c = col0 + 4 * lane;
  const bool col_ok = c < col_end;
  const int g_begin = ks * gps;
  const int g_end = min(G, g_begin + gps);

  __shared__ GemvSmem sm;
  __shared__ float row_sum[TMB], row_sx[TMB];

  float tot[TMB][4];
#pragma unroll
  for (int m = 0; m < TMB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[m][j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    // the group's scales (and, for the weight-side dequant, zeros) of the
    // lane's columns, where the byte-rows need them; a8 reads them after
    float s4[4], z4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = !Q8 && c + j < col_end;
      s4[j] = ok ? load_f32(scales, (size_t)g * O + c + j, sdt) : 0.f;
      z4[j] = (ok && MODE == DEQUANT_BF16) ? load_f32(zeros, (size_t)g * O + c + j, zdt) : 0.f;
    }
    int acci[TMB][4];  // a8: the group's exact int32 dot
#pragma unroll
    for (int m = 0; m < TMB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acci[m][j] = 0;

    for (int c0 = 0; c0 < HALF; c0 += CB) {
      const int cn = min(CB, HALF - c0);
      __syncthreads();  // the previous chunk's (and group's) readers are done
      if (c0 == 0 && threadIdx.x < TMB) {
        const int m = threadIdx.x;
        const bool ok = m0 + m < M;
        const size_t idx = ((size_t)p * M + m0 + m) * G + g;
        row_sum[m] = (ok && MODE != DEQUANT_BF16) ? xsum[idx] : 0.f;
        row_sx[m] = (ok && Q8) ? sxv[idx] : 0.f;
      }
      // stage the chunk: slots [0, cn) and [CB, CB + cn) hold channels c0 + k
      // and S/2 + c0 + k of the group (half-split), or slots [0, 2 cn) hold
      // channels 2 c0 + k (interleaved); the TMB rows' loads in flight at once
      const size_t base = ((size_t)p * M + m0) * I + (size_t)g * S;
      const int nrows = min(TMB, M - m0);
      for (int k = threadIdx.x; k < 2 * cn; k += WARPS * 32) {
        int ch, slot;
        if (MODE == INTERLEAVED) {
          ch = 2 * c0 + k;
          slot = k;
        } else if (k < cn) {
          ch = c0 + k;
          slot = k;
        } else {
          ch = HALF + c0 + k - cn;
          slot = CB + k - cn;
        }
        if constexpr (Q8) {
          int8_t v[TMB];
#pragma unroll
          for (int m = 0; m < TMB; ++m) v[m] = m < nrows ? xq[base + (size_t)m * I + ch] : (int8_t)0;
#pragma unroll
          for (int m = 0; m < TMB; ++m) sm.xs_q[m][slot] = v[m];
        } else {
          float v[TMB];
#pragma unroll
          for (int m = 0; m < TMB; ++m) v[m] = m < nrows ? xr[base + (size_t)m * I + ch] : 0.f;
#pragma unroll
          for (int m = 0; m < TMB; ++m) sm.xs_f[m][slot] = v[m];
        }
      }
      __syncthreads();
      if (!col_ok) continue;

      // one batch of ROWS byte-rows; FULL: all in the chunk and 4-byte
      // aligned, so the loads go out unconditionally, all in flight at once
      auto batch = [&](auto full, const int h0) {
        constexpr bool FULL = decltype(full)::value;
        uchar4 b[ROWS / WARPS];
#pragma unroll
        for (int r = 0; r < ROWS / WARPS; ++r) {
          const int kk = h0 + warp + WARPS * r;
          const uint8_t* row = qw + (size_t)(g * HALF + c0 + kk) * O;
          if constexpr (FULL) b[r] = *reinterpret_cast<const uchar4*>(row + c);
          else b[r] = kk < cn ? load4(row, c, col_end, vec4) : make_uchar4(0, 0, 0, 0);
        }
#pragma unroll
        for (int r = 0; r < ROWS / WARPS; ++r) {
          const int kk = h0 + warp + WARPS * r;
          if (!FULL && kk >= cn) continue;
          const int sa = MODE == INTERLEAVED ? 2 * kk : kk;
          const int sb = MODE == INTERLEAVED ? 2 * kk + 1 : CB + kk;
          const int lo[4] = {b[r].x & 15, b[r].y & 15, b[r].z & 15, b[r].w & 15};
          const int hi[4] = {b[r].x >> 4, b[r].y >> 4, b[r].z >> 4, b[r].w >> 4};
          if constexpr (Q8) {
#pragma unroll
            for (int m = 0; m < TMB; ++m) {
              const int xa = sm.xs_q[m][sa], xb = sm.xs_q[m][sb];
#pragma unroll
              for (int j = 0; j < 4; ++j) acci[m][j] += xa * lo[j] + xb * hi[j];
            }
          } else {
            // the weight with its scale: q*s, or bf16(bf16(q - z)*s) for the weight-side
            // dequant (q - z rounded to bf16 first, as the TPU kernel's bf16 operands are)
            float wl[4], wh[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (MODE == DEQUANT_BF16) {
                wl[j] = round_to<bf16>(round_to<bf16>((float)lo[j] - z4[j]) * s4[j]);
                wh[j] = round_to<bf16>(round_to<bf16>((float)hi[j] - z4[j]) * s4[j]);
              } else {
                wl[j] = (float)lo[j] * s4[j];
                wh[j] = (float)hi[j] * s4[j];
              }
            }
#pragma unroll
            for (int m = 0; m < TMB; ++m) {
              const float xa = sm.xs_f[m][sa], xb = sm.xs_f[m][sb];
#pragma unroll
              for (int j = 0; j < 4; ++j) tot[m][j] = fmaf(xb, wh[j], fmaf(xa, wl[j], tot[m][j]));
            }
          }
        }
      };
      for (int h0 = 0; h0 < cn; h0 += ROWS) {
        if (vec4 && h0 + ROWS <= cn) batch(std::true_type{}, h0);
        else batch(std::false_type{}, h0);
      }
    }

    // the group's zero-point correction (and a8 scaling); warp 0 alone subtracts it
    if (MODE == DEQUANT_BF16 || !col_ok) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = c + j < col_end;
      z4[j] = ok ? load_f32(zeros, (size_t)g * O + c + j, zdt) : 0.f;
      if (Q8) s4[j] = ok ? load_f32(scales, (size_t)g * O + c + j, sdt) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < TMB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (Q8) {
          const float sc = s4[j] * row_sx[m];
          float v = (float)acci[m][j] * sc;
          if (warp == 0) v -= row_sum[m] * z4[j] * sc;
          tot[m][j] += v;
        } else {
          if (warp == 0) tot[m][j] -= row_sum[m] * z4[j] * s4[j];
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

// Reduce pass (only when the groups were split): out = sum over splits, in order.
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Partitions of `splits[0..P)` columns; false if P is out of range.
inline bool make_parts(int P, const int* splits, Parts& parts, int& vec4) {
  if (P < 1 || P > MAXP) return false;
  parts.P = P;
  parts.offs[0] = 0;
  parts.tile_base[0] = 0;
  vec4 = 1;
  for (int p = 0; p < P; ++p) {
    if (splits[p] < 1) return false;
    vec4 &= splits[p] % 4 == 0;
    parts.offs[p + 1] = parts.offs[p] + splits[p];
    parts.tile_base[p + 1] = parts.tile_base[p] + (splits[p] + TILE_O - 1) / TILE_O;
  }
  for (int p = P + 1; p <= MAXP; ++p) parts.offs[p] = parts.tile_base[p] = 0;
  return true;
}

template <typename XT, typename RT>
cudaError_t launch_rotate(const void* x, const void* rot, void* xr, void* xq, void* xsum,
                          void* sx, int M, int I, int S, int P, int a8, cudaStream_t st) {
  const dim3 grid(I / S, P, (M + RM - 1) / RM);
  const int threads = S < ROT_THREADS ? (S + 31) / 32 * 32 : ROT_THREADS;
  const int vec = (S * sizeof(RT)) % 16 == 0 && (uintptr_t)rot % 16 == 0;
  if (a8)
    rotate_kernel<XT, RT, true><<<grid, threads, 0, st>>>(
        (const XT*)x, (const RT*)rot, (float*)xr, (int8_t*)xq, (float*)xsum, (float*)sx, M, I, S, vec);
  else
    rotate_kernel<XT, RT, false><<<grid, threads, 0, st>>>(
        (const XT*)x, (const RT*)rot, (float*)xr, (int8_t*)xq, (float*)xsum, (float*)sx, M, I, S, vec);
  return cudaGetLastError();
}

// GEMV pass in KS group splits (then the reduce pass when KS > 1).
template <typename OT, int MODE>
cudaError_t launch_gemv(const void* xr, const void* xq, const void* xsum, const void* sx,
                        const void* qw, const void* scales, const void* zeros, void* out,
                        void* partial, int M, int I, int S, int KS, const Parts& parts,
                        int vec4, int sdt, int zdt, cudaStream_t st) {
  const int G = I / S;
  const int gps = (G + KS - 1) / KS;
  const dim3 grid(parts.tile_base[parts.P], KS, (M + TMB - 1) / TMB);
  float* part = KS > 1 ? (float*)partial : nullptr;
  gemv_kernel<OT, MODE><<<grid, WARPS * 32, 0, st>>>(
      (const float*)xr, (const int8_t*)xq, (const float*)xsum, (const float*)sx,
      (const uint8_t*)qw, scales, zeros, (OT*)out, part, M, I, S, gps, sdt, zdt, vec4, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || KS == 1) return err;
  const size_t n = (size_t)M * parts.offs[parts.P];
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_kernel<OT><<<blocks, 256, 0, st>>>(part, (OT*)out, KS, n);
  return cudaGetLastError();
}

// the shape checks every entry point makes
inline bool bad_layout(int M, int I, int S, int KS, int sdt, int zdt) {
  return M < 1 || S < 2 || S % 2 != 0 || I % S != 0 || KS < 1 || KS > I / S ||
         sdt < F32 || sdt > U8 || zdt < F32 || zdt > U8;
}

}  // namespace w4
}  // namespace paro
