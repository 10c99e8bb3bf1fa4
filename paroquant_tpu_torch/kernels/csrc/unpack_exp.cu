// The W4 unpack experiments for Hopper (sm_90a).
//
// Replace the five kernel bodies of scripts/kernel_unpack_exp.py, which
// measure what the nibble unpack costs in the W4 GEMV at M = 1, 4096 x 4096,
// groups of S = 128 (x [M, I]; s_g, z_g rows g of scales and zeros [G, O]
// in f32, bf16, f16 or uint8; xr_g = bf16(x_g), xsum_g = sum of xr_g in f32):
//
//  K18 stream_only (_kernel_stream): streams the half-split u8 [I/2, O]
//      weight in blocks of Gb groups (Gb S / 2 byte-rows) and returns f32
//      [1, O] = sum over g < G / Gb, in order, of (qw[g Gb S / 2, :] +
//      x[0, g S]), as the TPU kernel's block index maps give it; the last
//      G mod Gb groups are not read.
//  K19 w4_matmul_bitcast (_kernel_bitcast): the output-pair layout u8
//      [I, O/2], byte (i, j) holding columns 2j (low nibble) and 2j + 1.
//  K20 w4_matmul_mulfloor (_kernel_mulfloor), K21 w4_matmul_splitdot and
//      w4_matmul_splitdot_ce (_kernel_splitdot), K22 w4_matmul_i8
//      (_kernel_i8): the half-split layout u8 [I/2, O], byte-row k of group g
//      holding channel g S + k in its low nibble and g S + S/2 + k in its
//      high one.
//  K19-K22: out = sum over g of (acc_g - xsum_g * z_g) * s_g, acc_g the f32
//      dot of xr_g with the nibbles 0..15, rounded to x's dtype.
//
// At M <= 16, where one group fits a block, K19-K22 do not come here
// (kernels/unpack_exp.py::unpack_route): they run variants of the
// one-launch kernel, which keep the unpacks below on a 16-byte cp.async
// ring: K19 BC (w4_opair.cu), K20 MF (w4_mulfloor.cu), K22 WM
// (w4_wordmask.cu), and K21 K6's PL (w4_plain.cu), whose dot is the split
// dot below. This file's GEMV takes K19-K22 only above 16 rows, or where a
// group is too wide for a block.
//
// Each GEMV keeps its Pallas body's unpack strategy, translated for this card:
//  K21 splitdot: int mask and shift per byte (b & 0xF, (b >> 4) & 0xF), the
//      low nibbles against x[:S/2] of the group, the high ones against x[S/2:].
//  K20 mulfloor: the byte converted to bf16 (exact for 0..255), then on
//      bf16x2 pairs hi = floor(f * 0.0625) (__hmul2, h2floor) and
//      lo = f - 16 hi (__hfma2), all exact.
//  K22 i8: the mask and shift on whole 32-bit words (w & 0x0F0F0F0F,
//      (w >> 4) & 0x0F0F0F0F), four nibbles an instruction, then an int8 ->
//      float conversion per byte; no byte is widened before the mask.
//  K19 bitcast: the card has no u4 -> bf16 conversion, so its counterpart of
//      "the cast does the unpack" is the exponent-bias trick:
//      ((w >> 4 t) & 0x000F000F) | 0x43004300 is the bf16 pair 128 + n of
//      two nibbles (exact: the bf16 ulp at 128 is 1), and one __hsub2 of 128
//      yields them. A 32-bit word holds 8 columns of one input row; shift t
//      = 0..3 pairs columns (t, t + 4) of the word's 8, which costs one
//      shift and one and-or per pair (neighbouring columns 2j, 2j + 1 would
//      need a byte permute first).
//
// Bound on this card at 4096 x 4096, M = 1, g128, bf16 scales and zeros:
// bytes. K18 must read the 8,388,608-byte weight (2.50 us at 3.35 TB/s);
// K19-K22 also read 32 x 4096 x (2 + 2) bytes of scales and zeros (8,912,896
// bytes, 2.66 us). Design: one skeleton for all five, so that the GEMVs
// differ from each other only by the unpack and from the stream only by the
// arithmetic. A block of 8 warps owns a 512-byte tile of every byte-row: a
// lane loads 16 bytes of a byte-row with one 16-byte load (16 columns of
// the half-split layout, 32 of the output-pair one), the warps split the
// group's byte-rows and each sends 8 rows' loads before it uses them, so a
// thread keeps 128 bytes in flight; a group's first batch of loads goes out
// before its activations, scales and zeros are staged in shared memory, so
// the two wait together. The groups (K18: the blocks of Gb
// groups) are split across blocks until about two blocks per SM are
// resident (one group a block at 4096 x 4096); a GEMV's splits write f32
// partials that a second pass sums in split order (8 loads in flight a
// thread), and K18's blocks of the first split stage the first row of every
// block of groups in shared memory and sum them in order (so those bytes
// are read by them, the others by the streaming loads). K18's streaming loads are
// `asm volatile` 16-byte loads whose words are folded into a sink the
// compiler cannot prove dead, so none is removed. Each block of a GEMV
// takes one row of x (a block per row for M > 1, re-reading its tile of the
// weight from L2): the experiment is M = 1. Simple and right first: no TMA,
// no tensor cores.

#include "w4_passes.cuh"

using namespace paro;
using paro::w4::block_sum;
using paro::w4::load_f32;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VB = 16;            // bytes a lane loads from a byte-row
constexpr int TILE_B = 32 * VB;   // bytes of a byte-row a block owns
constexpr int RB = 8;             // byte-rows a warp loads before it uses them

enum Mode { MULFLOOR = 0, SPLITDOT = 1, I8 = 2, BITCAST = 3 };

// 16 bytes of a byte-row at byte c, zero past `end`; one 16-byte load where
// the row is 16-byte aligned (`vec`) and the bytes lie inside it
__device__ __forceinline__ uint4 load16(const uint8_t* row, int c, int end, int vec) {
  if (vec && c + VB <= end) return *reinterpret_cast<const uint4*>(row + c);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < VB; ++i)
    if (c + i < end) w[i >> 2] |= (uint32_t)row[c + i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the same through loads the compiler keeps whether or not the words are used
__device__ __forceinline__ uint4 load16_volatile(const uint8_t* row, int c, int end, int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec && c + VB <= end) {
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(row + c));
    return v;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < VB; ++i) {
    if (c + i >= end) break;
    uint32_t b;
    asm volatile("ld.global.u8 %0, [%1];" : "=r"(b) : "l"(row + c + i));
    w[i >> 2] |= b << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[16] += the 16 columns of one half-split byte-row: low nibbles times
// xa (channel k of the group), high nibbles times xb (channel S/2 + k)
template <int MODE>
__device__ __forceinline__ void fma_half_split(const uint4& v, float xa, float xb, float* acc) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = word(v, k);
    if constexpr (MODE == SPLITDOT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b = (w >> (8 * i)) & 0xFFu;
        acc[4 * k + i] = fmaf(xa, (float)(b & 0xFu), acc[4 * k + i]);
        acc[4 * k + i] = fmaf(xb, (float)((b >> 4) & 0xFu), acc[4 * k + i]);
      }
    } else if constexpr (MODE == I8) {
      const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[4 * k + i] = fmaf(xa, (float)(int8_t)(lo >> (8 * i)), acc[4 * k + i]);
        acc[4 * k + i] = fmaf(xb, (float)(int8_t)(hi >> (8 * i)), acc[4 * k + i]);
      }
    } else {  // MULFLOOR
      const __nv_bfloat162 sixteenth = __float2bfloat162_rn(0.0625f);
      const __nv_bfloat162 minus16 = __float2bfloat162_rn(-16.f);
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const __nv_bfloat162 f = __floats2bfloat162_rn((float)((w >> (8 * i)) & 0xFFu),
                                                       (float)((w >> (8 * i + 8)) & 0xFFu));
        const __nv_bfloat162 hi = h2floor(__hmul2(f, sixteenth));
        const __nv_bfloat162 lo = __hfma2(hi, minus16, f);
        const float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
        acc[4 * k + i] = fmaf(xb, h.x, fmaf(xa, l.x, acc[4 * k + i]));
        acc[4 * k + i + 1] = fmaf(xb, h.y, fmaf(xa, l.y, acc[4 * k + i + 1]));
      }
    }
  }
}

// acc[32] += the 32 columns of one output-pair byte-row times xv
__device__ __forceinline__ void fma_bitcast(const uint4& v, float xv, float* acc) {
  const __nv_bfloat162 bias = __float2bfloat162_rn(128.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = word(v, k);
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // columns (t, t + 4) of the word's 8
      const uint32_t bits = ((w >> (4 * t)) & 0x000F000Fu) | 0x43004300u;
      const __nv_bfloat162 n = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits), bias);
      const float2 f = __bfloat1622float2(n);
      acc[8 * k + t] = fmaf(xv, f.x, acc[8 * k + t]);
      acc[8 * k + t + 4] = fmaf(xv, f.y, acc[8 * k + t + 4]);
    }
  }
}

// K19-K22. Grid (tiles of TILE_B bytes of a byte-row, group splits, M).
// Writes out [M, O] (partial == nullptr) or f32 partial [KS, M, O].
// Dynamic shared memory: max(S + 2 TILE_C, WARPS TILE_C) floats.
template <typename XT, int MODE>
__global__ void __launch_bounds__(THREADS) gemv_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ qw, const void* __restrict__ scales,
    const void* __restrict__ zeros, XT* __restrict__ out, float* __restrict__ partial, int M,
    int I, int S, int O, int gps, int sdt, int zdt, int vec) {
  constexpr bool OPAIR = MODE == BITCAST;
  constexpr int NC = OPAIR ? 2 * VB : VB;  // columns a lane owns
  constexpr int TILE_C = 32 * NC;          // columns a block owns
  extern __shared__ float smem[];
  __shared__ float red[WARPS];
  float* xs = smem;         // [S] the group's bf16-rounded activations
  float* ss = xs + S;       // [NC][32] the group's scales: column lane * NC + j at j * 32 + lane
  float* zs = ss + TILE_C;  // [NC][32] its zeros
  float* part = smem;       // [WARPS][TILE_C] after the groups

  const int G = I / S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx = blockIdx.x, ks = blockIdx.y, m = blockIdx.z;
  const int row_bytes = OPAIR ? O / 2 : O;
  const int c = bx * TILE_B + lane * VB;  // the lane's first byte of a byte-row
  const int tile_col0 = bx * TILE_C;
  const int n_rows = OPAIR ? S : S / 2;   // byte-rows of a group
  const int g_begin = ks * gps, g_end = min(G, g_begin + gps);

  float tot[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) tot[j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    const uint8_t* grp = qw + (size_t)g * n_rows * row_bytes;
    uint4 v[RB];
    auto load_batch = [&](int h0) {  // the batch's loads in flight at once
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int kk = h0 + warp + WARPS * r;
        v[r] = kk < n_rows ? load16(grp + (size_t)kk * row_bytes, c, row_bytes, vec)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    load_batch(0);  // in flight while the activations, scales and zeros are staged
    __syncthreads();  // the previous group's readers of xs, ss, zs are done
    float s = 0.f;
    for (int k = threadIdx.x; k < S; k += THREADS) {
      const float xv = round_to<bf16>(to_f32(x[(size_t)m * I + (size_t)g * S + k]));
      xs[k] = xv;
      s += xv;
    }
    for (int e = threadIdx.x; e < TILE_C; e += THREADS) {
      const int col = tile_col0 + (e & 31) * NC + (e >> 5);
      const bool ok = col < O;
      ss[e] = ok ? load_f32(scales, (size_t)g * O + col, sdt) : 0.f;
      zs[e] = ok ? load_f32(zeros, (size_t)g * O + col, zdt) : 0.f;
    }
    const float xsum = block_sum(s, red);  // syncs: xs, ss, zs are complete

    float acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = 0.f;
    for (int h0 = 0; h0 < n_rows; h0 += WARPS * RB) {
      if (h0 > 0) load_batch(h0);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int kk = h0 + warp + WARPS * r;
        if (kk >= n_rows) break;
        if constexpr (OPAIR) fma_bitcast(v[r], xs[kk], acc);
        else fma_half_split<MODE>(v[r], xs[kk], xs[S / 2 + kk], acc);
      }
    }
    // (acc - xsum z) s: the warps' partial dots each times s, warp 0 subtracting xsum z s
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float sc = ss[j * 32 + lane];
      float t = acc[j] * sc;
      if (warp == 0) t -= xsum * zs[j * 32 + lane] * sc;
      tot[j] += t;
    }
  }

  __syncthreads();  // part reuses xs, ss, zs
#pragma unroll
  for (int j = 0; j < NC; ++j) part[warp * TILE_C + lane * NC + j] = tot[j];
  __syncthreads();
  for (int e = threadIdx.x; e < TILE_C; e += THREADS) {
    const int col = tile_col0 + e;
    if (col >= O) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += part[w * TILE_C + e];
    if (partial) partial[((size_t)ks * M + m) * O + col] = v;
    else out[(size_t)m * O + col] = from_f32<XT>(v);
  }
}

// the splits' partials summed in split order, 8 loads in flight at a time
template <typename XT>
__global__ void reduce_kernel(const float* __restrict__ partial, XT* __restrict__ out, int KS,
                              size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int k0 = 0; k0 < KS; k0 += 8) {
      float t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = k0 + k < KS ? partial[(size_t)(k0 + k) * n + i] : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k0 + k < KS) v += t[k];
    }
    out[i] = from_f32<XT>(v);
  }
}

constexpr int CH = 32;  // K18: blocks of groups whose first rows are staged at once

// K18. Grid (tiles of TILE_B bytes, splits of the NB = G / Gb blocks).
// Block (bx, ks) streams byte-rows 1 .. RG - 1 (RG = Gb S / 2) of its
// blocks' tile. The split-0 block then stages row 0 of every block (CH
// blocks at a time, all loads in flight at once) and x[0, g S] in shared
// memory, and each thread sums (row + x[0, g S]) of its two columns in g
// order into out [1, O] f32.
template <typename XT>
__global__ void __launch_bounds__(THREADS) stream_kernel(
    const XT* __restrict__ x, const uint8_t* __restrict__ qw, float* __restrict__ out,
    uint32_t* __restrict__ sink, uint32_t sink_key, int O, int S, int RG, int NB, int gps,
    int vec) {
  __shared__ uint4 rows[CH][32];
  __shared__ float xv[CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx = blockIdx.x, ks = blockIdx.y;
  const int c = bx * TILE_B + lane * VB;
  const int b_begin = ks * gps, b_end = min(NB, b_begin + gps);

  uint32_t fold = 0u;
  for (int gb = b_begin; gb < b_end; ++gb) {
    const uint8_t* blk = qw + (size_t)gb * RG * O;
    for (int h0 = 1; h0 < RG; h0 += WARPS * RB) {
      uint4 v[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int kk = h0 + warp + WARPS * r;
        v[r] = kk < RG ? load16_volatile(blk + (size_t)kk * O, c, O, vec) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) fold ^= v[r].x ^ v[r].y ^ v[r].z ^ v[r].w;
    }
  }
  if (fold == sink_key) *sink = fold;  // never proven dead: the loads stay

  if (ks != 0) return;
  const int b0 = bx * TILE_B + 2 * threadIdx.x;  // this thread's two columns
  float o0 = 0.f, o1 = 0.f;
  for (int c0 = 0; c0 < NB; c0 += CH) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < CH * 32; e += THREADS) {
      const int gb = c0 + e / 32;
      rows[e / 32][e % 32] = gb < NB ? load16(qw + (size_t)gb * RG * O, bx * TILE_B + (e % 32) * VB,
                                              O, vec)
                                     : make_uint4(0u, 0u, 0u, 0u);
    }
    if (threadIdx.x < CH) xv[threadIdx.x] = c0 + threadIdx.x < NB ? to_f32(x[(size_t)(c0 + threadIdx.x) * S]) : 0.f;
    __syncthreads();
    for (int i = 0; i < min(CH, NB - c0); ++i) {
      const uint8_t* r = reinterpret_cast<const uint8_t*>(rows[i]);
      const float a = (float)r[2 * threadIdx.x] + xv[i], b = (float)r[2 * threadIdx.x + 1] + xv[i];
      o0 = c0 + i == 0 ? a : o0 + a;
      o1 = c0 + i == 0 ? b : o1 + b;
    }
  }
  if (b0 < O) out[b0] = o0;
  if (b0 + 1 < O) out[b0 + 1] = o1;
}

int is_vec(const void* qw, int row_bytes) {
  return (uintptr_t)qw % 16 == 0 && row_bytes % 16 == 0;
}

template <typename XT, int MODE>
cudaError_t run_gemv(const void* x, const void* qw, const void* scales, const void* zeros,
                     void* out, void* partial, int M, int I, int S, int O, int KS, int sdt,
                     int zdt, cudaStream_t st) {
  const int row_bytes = MODE == BITCAST ? O / 2 : O;
  const int cols = MODE == BITCAST ? 2 * TILE_B : TILE_B;
  const int G = I / S;
  const int gps = (G + KS - 1) / KS;
  const int staged = S + 2 * cols;
  const size_t smem = sizeof(float) * (size_t)(staged > WARPS * cols ? staged : WARPS * cols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gemv_kernel<XT, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((row_bytes + TILE_B - 1) / TILE_B, KS, M);
  float* part = KS > 1 ? (float*)partial : nullptr;
  gemv_kernel<XT, MODE><<<grid, THREADS, smem, st>>>(
      (const XT*)x, (const uint8_t*)qw, scales, zeros, (XT*)out, part, M, I, S, O, gps, sdt, zdt,
      is_vec(qw, row_bytes));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || KS == 1) return err;
  const size_t n = (size_t)M * O;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_kernel<XT><<<blocks, 256, 0, st>>>(part, (XT*)out, KS, n);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t by_mode(int mode, const void* x, const void* qw, const void* scales,
                    const void* zeros, void* out, void* partial, int M, int I, int S, int O,
                    int KS, int sdt, int zdt, cudaStream_t st) {
  switch (mode) {
    case MULFLOOR:
      return run_gemv<XT, MULFLOOR>(x, qw, scales, zeros, out, partial, M, I, S, O, KS, sdt, zdt, st);
    case SPLITDOT:
      return run_gemv<XT, SPLITDOT>(x, qw, scales, zeros, out, partial, M, I, S, O, KS, sdt, zdt, st);
    case I8:
      return run_gemv<XT, I8>(x, qw, scales, zeros, out, partial, M, I, S, O, KS, sdt, zdt, st);
    case BITCAST:
      return run_gemv<XT, BITCAST>(x, qw, scales, zeros, out, partial, M, I, S, O, KS, sdt, zdt, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K19-K22. mode 0 mulfloor, 1 splitdot, 2 i8 (qw u8 [I/2, O] half-split),
// 3 bitcast (qw u8 [I, O/2] output pairs, O even). x [M, I] f32 or bf16;
// scales/zeros [G, O] of dtype codes sdt/zdt (0 f32, 1 bf16, 2 f16, 3 uint8);
// out [M, O] in x's dtype; partial f32 [KS, M, O] scratch when KS > 1 (the
// groups split KS ways). Returns the first CUDA error (0 on success).
extern "C" int paro_unpack_gemv(const void* x, const void* qw, const void* scales,
                                const void* zeros, void* out, void* partial, int mode, int M,
                                int I, int S, int O, int KS, int x_is_bf16, int sdt, int zdt,
                                void* stream) {
  if (M < 1 || S < 2 || S % 2 != 0 || I % S != 0 || O < 1 || KS < 1 || KS > I / S ||
      sdt < 0 || sdt > 3 || zdt < 0 || zdt > 3 || mode < 0 || mode > 3 ||
      (mode == BITCAST && O % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16)
    return (int)by_mode<bf16>(mode, x, qw, scales, zeros, out, partial, M, I, S, O, KS, sdt, zdt, st);
  return (int)by_mode<float>(mode, x, qw, scales, zeros, out, partial, M, I, S, O, KS, sdt, zdt, st);
}

// K18. x [M <= 16, I] f32 or bf16 (only x[0, g S] is read); qw u8 [I/2, O];
// out f32 [1, O]; G = I / S groups in NB = G / Gb blocks split KS ways;
// sink a 4-byte scratch word written only when the streamed words fold to
// sink_key. Returns the first CUDA error (0 on success).
extern "C" int paro_stream_only(const void* x, const void* qw, void* out, void* sink,
                                unsigned sink_key, int I, int S, int O, int Gb, int KS,
                                int x_is_bf16, void* stream) {
  if (S < 2 || S % 2 != 0 || I % S != 0 || O < 1 || Gb < 1 || I / S / Gb < 1 || KS < 1 ||
      KS > I / S / Gb)
    return (int)cudaErrorInvalidValue;
  const int NB = I / S / Gb, RG = Gb * S / 2;
  const int gps = (NB + KS - 1) / KS;
  const dim3 grid((O + TILE_B - 1) / TILE_B, KS);
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = is_vec(qw, O);
  if (x_is_bf16)
    stream_kernel<bf16><<<grid, THREADS, 0, st>>>((const bf16*)x, (const uint8_t*)qw, (float*)out,
                                                  (uint32_t*)sink, sink_key, O, S, RG, NB, gps, vec);
  else
    stream_kernel<float><<<grid, THREADS, 0, st>>>((const float*)x, (const uint8_t*)qw, (float*)out,
                                                   (uint32_t*)sink, sink_key, O, S, RG, NB, gps, vec);
  return (int)cudaGetLastError();
}
