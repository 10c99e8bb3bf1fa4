// The one-launch W4 GEMV for Hopper (sm_90a), shared by K1/K2's W4A16 decode
// route (rot_w4_matmul.cu), by K10/K12 and K13 (w4_experiments.cu), by K8/K11
// (rot_w4_dequant.cu) and by K7 and K9 (w4_variants.cu).
//
//   xr_g[m]   = bf16(x_g[m] @ M_g^T)
//   out[m, o] = sum_g (xr_g[m] . q_g[:, o] - rowsum_g[m] * z[g, o]) * s[g, o]
//
// Seven variants of that function, a template switch each (Variant):
//               x before the rotation   rowsum_g             out
//   K1          rounded to rot's dtype  of the bf16 xr_g     x's dtype
//   K10 (B)     rounded to rot's dtype  of the f32 xr_g      x's dtype
//   K12 (V2)    f32, not rounded        of the bf16 xr_g     f32
//   K8/K11 (DQ) rounded to bf16, M_g    none: the weight     x's dtype
//               rounded to bf16 too     is dequantized
//   K7 (BF)     f32, times inv_s; K     of the bf16 xr_g     x's dtype
//               butterfly stages, no M_g
//   K13 (A8)    no rotation: int8 per   sum(xq_g)            x's dtype
//               (row, group)
//   K9 (I4)     as K1, on a weight whose byte-row k of a group holds channels
//               2k and 2k + 1 (K1's: k and k + S/2)
// (K10 replaces scripts/kernel_edge_test.py::rot_w4_matmul_b, K12
// scripts/kernel_tune.py::rot_w4_matmul_v2, DQ both
// paroquant_tpu/kernels/rot_matmul.py::rot_w4_matmul_mg and
// scripts/kernel_dma_pipeline.py::dma_rot_w4_matmul, BF
// paroquant_tpu/kernels/rot_matmul.py::butterfly_w4_matmul, A8
// scripts/kernel_w4a8_exp.py::w4a8_matmul, I4
// paroquant_tpu/kernels/rot_matmul.py::rot_w4_matmul_i4.) I4 differs from K1
// only in where it stores a rotated channel: the dot reads xr as (low
// nibble, high nibble) pairs, one per byte-row, so K1 keeps channel i of a
// group at pair slot 2 (i mod S/2) + (i >= S/2) and I4 at slot i; it issues
// its loads in K10's order. DQ dequantizes the
// weight in bf16, w = bf16(bf16(q - z) * s) with s and z rounded to bf16,
// and sums xr_g . w_g in f32 over chunks of `chunk` groups (the last may be
// shorter): no split crosses a chunk, the splits of a chunk add in split
// order into its sum and the chunk sums add in chunk order, as the TPU
// kernels add each chunk's dot to their accumulator. Its bound is K10's
// (the weight stream); its dot spends three bf16x2 operations (one exact,
// two rounding) on the nibbles of one byte-row in two columns, where K10
// converts and scales each nibble in f32. BF's stage r sets lane l of a
// group to cos[r, l] x[l] + sin[r, l] x[l ^ d_r], d_r = 2^(r mod log2 S),
// the products rounded apart, from per-channel tables cos/sin [K, I] and
// inv_s [I] (f32). A8 quantizes x per (row, group): sx = max|x_g| / 127 (1
// where that is 0), xq = rint(x / sx) half to even, and forms
// (xq . q_g - sum(xq) z) (s sx) per group, the dot exact (an f32 FMA on
// integers: |xq . q| <= S 127 15 < 2^24 for every S up to 8192), the groups
// of a split added in order and the splits merged in split order (with one
// group a split, the TPU kernel's order).
//
// Bound on this card: at M <= 16 the weight stream, I*O/2 bytes of nibbles
// plus the scales and zeros, so HBM bandwidth; at 1-8 MB of weight, the
// latency of a few dependent rounds of loads. One block per (column tile of
// 128, 256 or 512 columns, group split, row tile of at most 8 rows), 256
// threads (K10/K12 at 4096 x 4096, M 1: 512 columns, 32 splits of one group,
// two blocks an SM):
//  1. K1 puts its weight slice in flight first: a ring of 8 stages of 4 KB in
//     shared memory, one 16-byte cp.async a thread a stage, up to 7 stages
//     (112 bytes a thread) ahead; the decode linears' slices (8-16 KB a
//     block) are wholly in flight at once.
//  2. Then x for its groups, the first batch of its rotation rows (16-byte
//     vectors, up to 256 bytes a thread) and its scales and zeros go out
//     together; in K1 at up to 4 rows the scales and zeros reach shared memory
//     only after the rotation, which does not wait for them. K10/K12 issue these
//     first and their weight (the whole ring at once) only once x has landed:
//     at 4096 x 4096 a load issued behind 8 MB of weight returns only after
//     most of it (globaltimer stamps on the card), and x, the rotation rows
//     and the scales and zeros are on the critical path. Their scales and
//     zeros travel as the aligned 32-bit words that hold them, one kind of
//     load whatever the dtype, converted once they have landed.
//     BF's tables (the block's slice of inv_s and its K rows of cos and sin)
//     and A8's nothing but x go out the same way, the tables as 16-byte
//     cp.async into shared memory ahead of the ring.
//  3. It rotates x for its groups itself: xr_g = bf16(x_g @ M_g^T) into shared
//     memory, each rotation row split over adjacent lanes, with rowsum(xr_g).
//     BF runs its K stages in place in shared memory instead (a thread owns
//     the pairs (l, l ^ d) of a stage, one barrier a stage), A8 quantizes each
//     (group, row) with one warp.
//     K10 stores the f32 value, takes the row sum of it and rounds it to bf16
//     in place in the same pass. The blocks of the other column tiles re-read
//     M_g from L2 (for K10/K12, sharing it among a thread-block cluster's
//     column tiles through distributed shared memory was slower on the card).
//  4. The dot on f32 FMAs over the ring, lane l of a warp on columns 4l..4l+3,
//     the scale folded into the nibbles; the zero-point correction once per
//     group. A8's warps each own 64 columns of a 512-column tile (two a
//     lane) over every byte-row, so that a group's integer dot is whole in
//     one lane and its epilogue is applied there when the rows pass to the
//     next group.
//  5. With the groups split (KS > 1) each block writes its f32 partial (16-byte
//     stores), arrives on its tile's counter, and the last to arrive sums the
//     KS partials in split order (each thread 4 columns, its KS 16-byte loads
//     in flight together; K10/K12 at one row a column pair and 32 partials),
//     writes out and resets the counter to 0: the same bits whichever
//     block is last. No block waits for another, so a grid of more than one
//     wave (K10/K12 at M > 16) is safe.
// Timed phase by phase on the card (globaltimer stamps), a K1 call at M 1
// after an L2 flush is a chain of about four dependent memory round trips: x
// and the rotation, the weight, the counter, the merge.
#pragma once

#include "w4_passes.cuh"

namespace paro {
namespace one {

using w4::Parts;
using w4::load_f32;

enum Variant { K1 = 0, B = 1, V2 = 2, DQ = 3, BF = 4, A8 = 5, I4 = 6 };

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int WARP_COLS = 128;   // columns of one warp: 32 lanes x 4
constexpr int STAGE = 4096;      // bytes per ring stage: one 16-byte piece a thread
constexpr int NST = 8;           // ring stages
constexpr int A8_TW = 512;       // A8's tile: 64 columns a warp, two a lane
// the limits kernels/rot_matmul.py::rot_route mirrors (ONE_LAUNCH_*); K1's
// entry point refuses a call outside them
constexpr int MAX_M = 16;        // rows a call (K1)
constexpr int MAX_S = 256;       // (K1)
constexpr int MAX_GROUPS = 16;   // groups per block
constexpr int X_FLOATS = 4096;   // x (and xr) a block keeps at two blocks an SM: groups * MT * S
constexpr int SZ_FLOATS = 2048;  // scales (and zeros) a block keeps: groups * tile width
constexpr size_t MAX_SMEM = 227 * 1024;  // shared memory a block can use

struct Args {
  const void* x;
  const void* rot;
  const uint8_t* qw;
  const void* scales;
  const void* zeros;
  void* out;
  float* partial;  // [KS, M, O] f32 when KS > 1
  int* counters;   // one per (column tile, row tile), zero between calls
  int M, I, S, gps, sdt, zdt;
  int chunk, spc;  // DQ: groups a chunk, splits a chunk (split ks lies in chunk ks / spc)
  int cw;     // column groups of warps: the tile is cw * 128 columns wide
  int vec16;  // every partition's columns start on a multiple of 16, qw 16-byte aligned
  int rvec;   // the rotation's rows (BF: its tables) are 16-byte aligned
  Parts parts;  // tile_base in tiles of cw * 128 columns
  const float* inv_s;  // BF: [I]
  const float* cos_t;  // BF: [K, I]
  const float* sin_t;  // BF: [K, I]
  int K;               // BF: butterfly stages
};

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// The aligned 32-bit word that holds element i of a dtype-code dt array
// (the word may reach up to 3 bytes past either end of the array: inside its
// allocation, which the caching allocator aligns to 512 bytes), and that
// element from it.
__device__ __forceinline__ const uint8_t* elem_addr(const void* p, size_t i, int dt) {
  return static_cast<const uint8_t*>(p) + i * (dt == w4::F32 ? 4 : dt == w4::U8 ? 1 : 2);
}
__device__ __forceinline__ uint32_t load_word(const void* p, size_t i, int dt) {
  return *reinterpret_cast<const uint32_t*>((uintptr_t)elem_addr(p, i, dt) & ~(uintptr_t)3);
}
__device__ __forceinline__ float word_f32(uint32_t w, const void* p, size_t i, int dt) {
  const uint32_t v = w >> (8 * ((uintptr_t)elem_addr(p, i, dt) & 3));
  switch (dt) {
    case w4::F32: return __uint_as_float(w);
    case w4::BF16: return __uint_as_float(v << 16);
    case w4::F16: return __half2float(__ushort_as_half((unsigned short)(v & 0xffffu)));
    default: return (float)(v & 0xffu);
  }
}

// The bf16 value of a rotation element as the variant uses it: DQ rounds M_g
// to bf16 whatever its dtype, the others take it as it is.
template <int VAR, typename RT>
__device__ __forceinline__ float rot_elem(RT v) {
  if constexpr (VAR == DQ && !std::is_same<RT, bf16>::value) return round_to<bf16>(to_f32(v));
  return to_f32(v);
}

// DQ's weight for a pair of nibbles (bits 0-3 and 16-19 of nib) of two
// columns sharing the bf16 pairs s2 and z2: w = bf16(bf16(q - z) * s), each
// operation rounding once (.rn keeps the compiler from contracting them).
// 0x4300 | q is the bf16 of 128 + q, so subtracting 128 gives q exactly.
__device__ __forceinline__ void dequant_pair(uint32_t nib, uint32_t s2, uint32_t z2, float& lo,
                                             float& hi) {
  uint32_t q, w;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(q) : "r"(nib | 0x43004300u), "r"(0x43004300u));
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(w) : "r"(q), "r"(z2));
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(w) : "r"(w), "r"(s2));
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// the merge's sums, split k's partial t in split order: DQ adds it into its
// chunk's sum cs and that into v after the chunk's last split (`left` counts
// the chunk's splits still to come, spc at the start); the others add it
// into v
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float2& a, float2 b) { a.x += b.x, a.y += b.y; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}
template <int VAR, typename T>
__device__ __forceinline__ void merge_add(T& v, T& cs, int& left, T t, int k, int KS, int spc) {
  if constexpr (VAR == DQ) {
    add_to(cs, t);
    if (--left == 0 || k + 1 == KS) {
      add_to(v, cs);
      cs = T{};
      left = spc;
    }
  } else {
    add_to(v, t);
  }
}

// rows per block for M rows of groups of S: the least of 1, 2, 4, 8 that
// holds M (at most 8), halved while one group of that many rows exceeds
// X_FLOATS (only K10/K12 take S > 512)
inline int row_tile(int M, int S) {
  int MT = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  while (MT > 1 && MT * S > X_FLOATS) MT /= 2;
  return MT;
}

// the most groups a block may take at MT rows and a tile of TW columns (0
// where one group of MT rows exceeds X_FLOATS: then it takes one group, in
// more shared memory than two blocks an SM leave)
inline int max_groups(int MT, int S, int TW) {
  int g = X_FLOATS / (MT * S);
  g = g < SZ_FLOATS / TW ? g : SZ_FLOATS / TW;
  return g < MAX_GROUPS ? g : MAX_GROUPS;
}

// the floats of a variant's tables for gps groups of MT rows: BF's inv_s, cos
// and sin rows [2K + 1][gps * S], A8's scales of x [gps][MT]; none elsewhere
__host__ __device__ inline int table_floats(int var, int MT, int S, int gps, int K) {
  return var == BF ? gps * S * (2 * K + 1) : var == A8 ? gps * MT : 0;
}

// dynamic shared memory, in floats after the ring: xr pairs [gps][MT][S/2][2]
// (A8: xq), x rounded to rot's dtype [gps][MT][S], scales and zeros [gps][TW],
// row sums [gps][MT], then `tab` floats of tables; the warps' sums
// [NWARPS][MT][128] reuse the whole of it at the end
struct Layout {
  int xr, xs, ss, zs, rsum, tb;  // float offsets from the end of the ring
  size_t bytes;
};

__host__ __device__ inline Layout layout(int MT, int S, int gps, int TW, int tab = 0) {
  Layout L;
  L.xr = 0;
  L.xs = L.xr + align4(gps * MT * S);
  L.ss = L.xs + align4(gps * MT * S);
  L.zs = L.ss + gps * TW;
  L.rsum = L.zs + gps * TW;
  L.tb = L.rsum + align4(gps * MT);
  const size_t body = (size_t)NST * STAGE + 4 * (size_t)(L.tb + align4(tab));
  const size_t red = 4 * (size_t)NWARPS * MT * WARP_COLS;
  L.bytes = body > red ? body : red;
  return L;
}

template <typename XT, typename RT, int MT, int VAR>
__global__ void __launch_bounds__(THREADS, 2) rot_w4_one_launch_kernel(const Args a) {
  using OT = typename std::conditional<VAR == V2, float, XT>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int S = a.S, HALF = S / 2, G = a.I / S, M = a.M;
  const int m0 = blockIdx.z * MT, Mb = min(MT, M - m0);  // the block's rows of x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TW = a.cw * WARP_COLS;   // tile width
  const int WPC = NWARPS / a.cw;     // warps per 128 columns
  const int CR = STAGE / TW;         // byte-rows per stage
  const Parts& parts = a.parts;
  const int O = parts.offs[parts.P];
  const int bx = blockIdx.x, ks = blockIdx.y;
  int p = 0;
  while (p + 1 < parts.P && bx >= parts.tile_base[p + 1]) ++p;
  const int col0 = parts.offs[p] + (bx - parts.tile_base[p]) * TW;
  const int col_end = parts.offs[p + 1];
  // the split's groups (DQ: within chunk ks / spc)
  const int chunk_of = VAR == DQ ? ks / a.spc : 0;
  const int g_begin = VAR == DQ ? chunk_of * a.chunk + (ks - chunk_of * a.spc) * a.gps : ks * a.gps;
  const int g_stop = VAR == DQ ? min(G, (chunk_of + 1) * a.chunk) : G;
  const int ng = min(g_stop, g_begin + a.gps) - g_begin;  // >= 1: every split is non-empty
  const int nrows = ng * HALF;                       // the block's byte-rows
  const int nchunks = (nrows + CR - 1) / CR;

  const Layout L = layout(MT, S, a.gps, TW, table_floats(VAR, MT, S, a.gps, a.K));
  uint8_t* ring = smem;
  float* fs = reinterpret_cast<float*>(smem + NST * STAGE);
  float* xr2 = fs + L.xr;
  float* xs = fs + L.xs;
  float* ss = fs + L.ss;
  float* zs = fs + L.zs;
  float* rsum = fs + L.rsum;
  float* tb = fs + L.tb;  // BF: inv_s, cos, sin rows [2K + 1][ng * S]; A8: sx [ng][MT]
  constexpr bool ROT = VAR == K1 || VAR == B || VAR == V2 || VAR == DQ || VAR == I4;  // a dense M_g

  // 1. the weight slice: stage c holds byte-rows [c*CR, (c+1)*CR) of the
  // block's rows; thread t copies 16 bytes of one row. K1 puts NST - 1
  // stages in flight first; the other variants fill the whole ring once x
  // has landed, their rotation rows (BF: tables) and scales and zeros in
  // flight (so that x and those do not queue behind 8 MB of weight at 4096 x
  // 4096)
  constexpr bool K1_ORDER = VAR == K1;
  constexpr int PRE = K1_ORDER ? NST - 1 : NST;
  const uint8_t* wbase = a.qw + (size_t)g_begin * HALF * O;
  const int wr = tid / (TW / 16), wc = col0 + (tid % (TW / 16)) * 16;
  auto issue = [&](int c) {
    if (c < nchunks) {
      uint8_t* dst = ring + (c % NST) * STAGE + tid * 16;
      const int r = c * CR + wr;
      if (a.vec16) {  // a piece lies wholly inside or wholly outside the columns
        const bool ok = r < nrows && wc < col_end;
        cp_async16(dst, ok ? wbase + (size_t)r * O + wc : a.qw, ok ? 16 : 0);
      } else {
        for (int b = 0; b < 16; ++b)
          dst[b] = r < nrows && wc + b < col_end ? wbase[(size_t)r * O + wc + b] : 0;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the waits uniform
  };

  if (K1_ORDER) {
#pragma unroll
    for (int c = 0; c < PRE; ++c) issue(c);
  }
  if constexpr (VAR == BF) {  // the tables, one cp.async group ahead of x and the ring
    const int seg = ng * S;   // floats of one table row for the block's groups
    const size_t g0 = (size_t)g_begin * S;
    auto row_of = [&](int t) {  // table row t: inv_s, then cos rows 0..K-1, then sin rows
      return (t == 0 ? a.inv_s : t <= a.K ? a.cos_t + (size_t)(t - 1) * a.I
                                         : a.sin_t + (size_t)(t - 1 - a.K) * a.I) + g0;
    };
    if (a.rvec) {
      const int per = seg / 4;
      for (int c = tid; c < (2 * a.K + 1) * per; c += THREADS) {
        const int t = c / per, o = 4 * (c - t * per);
        cp_async16(tb + t * seg + o, row_of(t) + o, 16);
      }
    } else {
      for (int e = tid; e < (2 * a.K + 1) * seg; e += THREADS) tb[e] = row_of(e / seg)[e % seg];
    }
    cp_async_commit();
  }

  // 2. in flight together: the first batch of the rotation's rows, x for the
  // block's groups and their scales and zeros. The rotation: R = ng * S rows
  // of M_{p,g}, each split over tpr adjacent lanes, 16-byte vectors apart
  const XT* x = static_cast<const XT*>(a.x);
  const RT* rot = static_cast<const RT*>(a.rot);
  constexpr int VEC = 16 / sizeof(RT);
  constexpr int BATCH = MT <= 2 ? 16 : MT <= 4 ? 8 : 4;  // vectors in flight a thread
  const int R = ng * S;
  int tpr = 1;
  while (tpr < 32 && 2 * tpr * R <= THREADS) tpr *= 2;
  const int RP = THREADS / tpr, qi = tid / tpr, h = tid % tpr;
  const int nv = S / VEC, nb = ((nv + tpr - 1) / tpr + BATCH - 1) / BATCH;
  const int nsteps = (R + RP - 1) / RP * nb;
  const RT* rot_p = rot + ((size_t)p * G + g_begin) * S * S;
  uint4 w[BATCH];
  auto fetch = [&](int step) {  // step: (row iteration, batch of its vectors)
    const int q = qi + step / nb * RP, v0 = h + tpr * BATCH * (step % nb);
    const uint4* R4 = reinterpret_cast<const uint4*>(rot_p + (size_t)(q < R ? q : 0) * S);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int v = v0 + tpr * u;
      w[u] = q < R && v < nv ? R4[v] : make_uint4(0, 0, 0, 0);
    }
  };
  // x [gl][m][j] = x[m0 + m, (g_begin + gl) S + j] (rounded to RT but in
  // K12), LD a thread in flight at a time (all of it at the decode shapes);
  // the first LD scales and zeros [gl][c] a thread of the tile's columns go
  // out with it and (K1, at up to 4 rows) reach shared memory after the
  // rotation, which does not need them. K1 converts each scale and zero as
  // it loads it; K10/K12 load the aligned 32-bit word that holds it, one
  // kind of load whatever its dtype, and convert it in store_sz, so that no
  // branch on the dtype waits for a load before x and the weight are out
  constexpr int LD = 4;
  const int nx = R * MT, nsz = ng * TW;
  float sv[LD], zv[LD];
  uint32_t sw[LD], zw[LD];
  auto sz_index = [&](int e) { return (size_t)(g_begin + e / TW) * O + col0 + e % TW; };
  auto load_sz = [&](int k0) {
#pragma unroll
    for (int k = 0; k < LD; ++k) {
      const int e = tid + (k0 + k) * THREADS;
      const bool ok = e < nsz && col0 + e % TW < col_end;
      const size_t idx = sz_index(e);
      if constexpr (K1_ORDER) {
        sv[k] = ok ? load_f32(a.scales, idx, a.sdt) : 0.f;
        zv[k] = ok ? load_f32(a.zeros, idx, a.zdt) : 0.f;
      } else {
        sw[k] = ok ? load_word(a.scales, idx, a.sdt) : 0u;
        zw[k] = ok ? load_word(a.zeros, idx, a.zdt) : 0u;
      }
    }
  };
  auto store_sz = [&](int k0) {
#pragma unroll
    for (int k = 0; k < LD; ++k) {
      const int e = tid + (k0 + k) * THREADS;
      if (e >= nsz) continue;
      if constexpr (K1_ORDER) {
        ss[e] = sv[k], zs[e] = zv[k];
      } else {
        const size_t idx = sz_index(e);
        ss[e] = word_f32(sw[k], a.scales, idx, a.sdt);
        zs[e] = word_f32(zw[k], a.zeros, idx, a.zdt);
      }
    }
  };
  for (int k0 = 0; k0 * THREADS < nx; k0 += LD) {
    XT xv[LD];
#pragma unroll
    for (int k = 0; k < LD; ++k) {
      const int e = tid + (k0 + k) * THREADS, m = e / S % MT;
      xv[k] = e < nx && m < Mb
          ? x[(size_t)(m0 + m) * a.I + (size_t)g_begin * S + e / (MT * S) * S + e % S]
          : from_f32<XT>(0.f);
    }
    if (k0 == 0) {
      if constexpr (ROT)
        if (a.rvec) fetch(0);
      load_sz(0);
    }
#pragma unroll
    for (int k = 0; k < LD; ++k)
      if (tid + (k0 + k) * THREADS < nx)
        xs[tid + (k0 + k) * THREADS] = VAR == V2 || VAR == BF || VAR == A8 ? to_f32(xv[k])
                                       : VAR == DQ ? round_to<bf16>(to_f32(xv[k]))
                                                   : round_to<RT>(to_f32(xv[k]));
  }
  // where the rotation needs the registers (K10/K12: also their words), at once
  if (MT >= 8 || !K1_ORDER) store_sz(0);
  __syncthreads();
  if (!K1_ORDER) {  // x has landed: now the weight (a loop, not unrolled: w is live)
#pragma unroll 1
    for (int c = 0; c < PRE; ++c) issue(c);
  }

  // 3. xr_g = bf16(x_g @ M_{p,g}^T) for the block's groups, into shared
  // memory (K10: the f32 value, rounded after its row sum; BF: the bf16 of
  // its butterfly stages; A8: xq_g, with sum(xq_g) and sx)
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  auto emit = [&](int q) {  // sum the row's lanes; channel i of group gl at pair slot (i mod S/2, i >= S/2) (I4: at slot i)
    for (int o = 1; o < tpr; o <<= 1)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
    if (h == 0 && q < R) {
      const int gl = q / S, i = q % S;
      float* dst;
      if constexpr (VAR == I4)
        dst = xr2 + (size_t)gl * MT * S + i;
      else
        dst = xr2 + (size_t)gl * MT * S + 2 * (i < HALF ? i : i - HALF) + (i >= HALF);
#pragma unroll
      for (int m = 0; m < MT; ++m) dst[m * S] = VAR == B ? acc[m] : round_to<bf16>(acc[m]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  };
  auto pair_slot = [&](int i) { return 2 * (i < HALF ? i : i - HALF) + (i >= HALF); };
  if constexpr (VAR == BF) {
    cp_async_wait<NST>();  // the tables' group, committed before the ring's NST
    __syncthreads();
    const int seg = ng * S;
    for (int e = tid; e < nx; e += THREADS)  // x * inv_s; e = (gl MT + m) S + j
      xs[e] = __fmul_rn(xs[e], tb[e / (MT * S) * S + e % S]);
    int log_s = 0;
    while ((1 << log_s) < S) ++log_s;
    for (int r = 0; r < a.K; ++r) {  // stage r on the pairs (l, l ^ d) of every row
      __syncthreads();
      const int d = 1 << (r % log_s);
      const float* cr = tb + (1 + r) * seg;
      const float* sr = tb + (1 + a.K + r) * seg;
      for (int e = tid; e < nx / 2; e += THREADS) {
        const int row = e / HALF, t = e - row * HALF;
        const int l = ((t & ~(d - 1)) << 1) | (t & (d - 1)), pr = l | d;  // bit d of l clear
        float* xrow = xs + (size_t)row * S;
        const float* c = cr + row / MT * S;
        const float* sn = sr + row / MT * S;
        const float u = xrow[l], v = xrow[pr];
        // products rounded apart, as the plain version computes them
        xrow[l] = __fadd_rn(__fmul_rn(c[l], u), __fmul_rn(sn[l], v));
        xrow[pr] = __fadd_rn(__fmul_rn(c[pr], v), __fmul_rn(sn[pr], u));
      }
    }
    __syncthreads();
    for (int e = tid; e < nx; e += THREADS)  // xr_g = bf16 of the stages, at its pair slot
      xr2[e - e % S + pair_slot(e % S)] = round_to<bf16>(xs[e]);
  } else if constexpr (VAR == A8) {
    for (int e = warp; e < ng * MT; e += NWARPS) {  // (group, row) e = gl MT + m, one warp
      const float* xrow = xs + (size_t)e * S;
      float amax = 0.f;
      for (int k = lane; k < S; k += 32) amax = fmaxf(amax, fabsf(xrow[k]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float sx = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
      float qs = 0.f;  // integers of at most 127 S: exact
      for (int k = lane; k < S; k += 32) {
        const float q = rintf(__fdiv_rn(xrow[k], sx));  // half to even, as jnp.round
        xr2[(size_t)e * S + pair_slot(k)] = q;
        qs += q;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) qs += __shfl_xor_sync(0xffffffffu, qs, o);
      if (lane == 0) rsum[e] = qs, tb[e] = sx;
    }
  } else if (a.rvec) {
    for (int step = 0; step < nsteps; ++step) {
      if (step > 0) fetch(step);
      const int q = qi + step / nb * RP, v0 = h + tpr * BATCH * (step % nb);
      const float* xg = xs + (size_t)(q < R ? q / S : 0) * MT * S;
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int v = v0 + tpr * u;
        if (v >= nv) break;  // w is 0 past the row's end or past R
        const RT* hv = reinterpret_cast<const RT*>(&w[u]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4* x4 = reinterpret_cast<const float4*>(xg + m * S + v * VEC);
#pragma unroll
          for (int t4 = 0; t4 < VEC / 4; ++t4) {
            const float4 xx = x4[t4];
            acc[m] = fmaf(xx.x, rot_elem<VAR>(hv[4 * t4]), acc[m]);
            acc[m] = fmaf(xx.y, rot_elem<VAR>(hv[4 * t4 + 1]), acc[m]);
            acc[m] = fmaf(xx.z, rot_elem<VAR>(hv[4 * t4 + 2]), acc[m]);
            acc[m] = fmaf(xx.w, rot_elem<VAR>(hv[4 * t4 + 3]), acc[m]);
          }
        }
      }
      if (step % nb == nb - 1) emit(q);
    }
  } else {  // rows not 16-byte aligned: element by element
    for (int q0 = 0; q0 < R; q0 += RP) {
      const int q = q0 + qi;
      if (q < R) {
        const RT* Ri = rot_p + (size_t)q * S;
        const float* xg = xs + (size_t)(q / S) * MT * S;
        for (int j = h; j < S; j += tpr) {
          const float r = rot_elem<VAR>(Ri[j]);
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m] = fmaf(xg[m * S + j], r, acc[m]);
        }
      }
      emit(q);
    }
  }
  if (MT < 8 && K1_ORDER) store_sz(0);
  for (int k0 = LD; k0 * THREADS < nsz; k0 += LD) {
    load_sz(k0);
    store_sz(k0);
  }
  __syncthreads();
  if constexpr (VAR == DQ) {  // DQ's scales and zeros as its dot reads them: for each 4 columns
    // the bf16 pairs (s0, s2), (s1, s3), (z0, z2), (z1, z3), in place of the f32 scales
    constexpr int NQ = SZ_FLOATS / 4 / THREADS;
    float4 sq[NQ], zq[NQ];
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int e = 4 * (tid + u * THREADS);
      if (e < nsz) {
        sq[u] = *reinterpret_cast<const float4*>(ss + e);
        zq[u] = *reinterpret_cast<const float4*>(zs + e);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int e = 4 * (tid + u * THREADS);
      if (e < nsz)
        *reinterpret_cast<uint4*>(ss + e) =
            make_uint4(pack_bf16(sq[u].x, sq[u].z), pack_bf16(sq[u].y, sq[u].w),
                       pack_bf16(zq[u].x, zq[u].z), pack_bf16(zq[u].y, zq[u].w));
    }
  }
  for (int e = warp; e < (VAR == DQ || VAR == A8 ? 0 : ng * MT); e += NWARPS) {  // rowsum_g per (group, row)
    float s = 0.f;
    for (int k = lane; k < S; k += 32) {
      float* v = xr2 + (size_t)e * S + k;
      s += *v;
      if (VAR == B) *v = round_to<bf16>(*v);  // the dot takes the bf16 xr
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rsum[e] = s;
  }

  // 4. the dot over the ring: the warps of column group cg = warp / WPC take
  // rows wi, wi + WPC, ... of each stage (wi = warp % WPC), lane l columns
  // cg * 128 + 4l .. + 3, every row of x at once. A8 (tiles of 512 columns,
  // 8 byte-rows a stage): every warp takes every row, lane l of warp w the
  // columns a8_c, a8_c + 1 (64 a warp); tot[m][j] the integer dot of group
  // a8_gl so far (exact in f32), tot[m][2 + j] the sum of the split's groups
  // before it; a8_k the row of the group that comes next
  const int cg = warp / WPC, wi = warp % WPC, c4 = cg * WARP_COLS + 4 * lane;
  float tot[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[m][j] = 0.f;
  const int a8_c = warp * (A8_TW / NWARPS) + 2 * lane;
  int a8_gl = 0, a8_k = 0;
  auto a8_close = [&](int gl) {  // group gl's (dot - sum(xq) z) (s sx), added in group order
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float s = ss[gl * A8_TW + a8_c + j], z = zs[gl * A8_TW + a8_c + j];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float e = __fmul_rn(__fsub_rn(tot[m][j], __fmul_rn(rsum[gl * MT + m], z)),
                                  __fmul_rn(s, tb[gl * MT + m]));
        tot[m][2 + j] = __fadd_rn(tot[m][2 + j], e);
        tot[m][j] = 0.f;
      }
    }
  };
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NST - 2>();  // stage c has landed (this thread's piece)
    __syncthreads();           // everyone's piece; stage c - 1's readers are done
    if (PRE == NST - 1 || c > 0) issue(c + NST - 1);
    const uint8_t* stage = ring + (c % NST) * STAGE;
    if constexpr (VAR == A8) {
#pragma unroll
      for (int rl = 0; rl < STAGE / A8_TW; ++rl) {  // the stage's byte-rows in order
        if (c * (STAGE / A8_TW) + rl >= nrows) break;
        const uint32_t b = *reinterpret_cast<const uint16_t*>(stage + rl * A8_TW + a8_c);
        const float lo[2] = {(float)(b & 15), (float)((b >> 8) & 15)};  // unscaled nibbles
        const float hi[2] = {(float)((b >> 4) & 15), (float)(b >> 12)};
        const float2* xv = reinterpret_cast<const float2*>(xr2 + (size_t)a8_gl * MT * S) + a8_k;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xx = xv[m * HALF];
#pragma unroll
          for (int j = 0; j < 2; ++j) tot[m][j] = fmaf(xx.y, hi[j], fmaf(xx.x, lo[j], tot[m][j]));
        }
        if (++a8_k == HALF) a8_close(a8_gl++), a8_k = 0;  // the group's last row
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < STAGE / WARP_COLS / NWARPS; ++rr) {  // CR / WPC rows a warp
        const int rl = wi + WPC * rr;
        const int r = c * CR + rl;
        if (r >= nrows) break;  // uniform across the warp
        const int gl = r / HALF, k = r - gl * HALF;
        float wl[4], wh[4];  // the weight of the row's low and high nibbles: q s, or DQ's w
        if constexpr (VAR == DQ) {
          const uint32_t b = *reinterpret_cast<const uint32_t*>(stage + rl * TW + c4);
          const uint4 sz = *reinterpret_cast<const uint4*>(ss + gl * TW + c4);
          dequant_pair(b & 0x000F000Fu, sz.x, sz.z, wl[0], wl[2]);
          dequant_pair((b >> 4) & 0x000F000Fu, sz.x, sz.z, wh[0], wh[2]);
          dequant_pair((b >> 8) & 0x000F000Fu, sz.y, sz.w, wl[1], wl[3]);
          dequant_pair((b >> 12) & 0x000F000Fu, sz.y, sz.w, wh[1], wh[3]);
        } else {
          const uchar4 b = *reinterpret_cast<const uchar4*>(stage + rl * TW + c4);
          const float4 s4 = *reinterpret_cast<const float4*>(ss + gl * TW + c4);
          wl[0] = (float)(b.x & 15) * s4.x, wl[1] = (float)(b.y & 15) * s4.y;
          wl[2] = (float)(b.z & 15) * s4.z, wl[3] = (float)(b.w & 15) * s4.w;
          wh[0] = (float)(b.x >> 4) * s4.x, wh[1] = (float)(b.y >> 4) * s4.y;
          wh[2] = (float)(b.z >> 4) * s4.z, wh[3] = (float)(b.w >> 4) * s4.w;
        }
        const float2* xv = reinterpret_cast<const float2*>(xr2 + (size_t)gl * MT * S) + k;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xx = xv[m * HALF];
#pragma unroll
          for (int j = 0; j < 4; ++j) tot[m][j] = fmaf(xx.y, wh[j], fmaf(xx.x, wl[j], tot[m][j]));
        }
      }
    }
  }
  cp_async_wait<0>();
  if (VAR != DQ && VAR != A8 && wi == 0) {  // the zero-point correction, once per group
    for (int gl = 0; gl < ng; ++gl) {
      const float4 s4 = *reinterpret_cast<const float4*>(ss + gl * TW + c4);
      const float4 z4 = *reinterpret_cast<const float4*>(zs + gl * TW + c4);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) tot[m][j] -= rsum[gl * MT + m] * zv[j] * sv[j];
    }
  }

  // 5. the sums of each column group's warps, in warp order (A8: each lane's
  // own columns, red [MT][A8_TW])
  __syncthreads();  // the ring and xr are free: red reuses them
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if constexpr (VAR == A8) {
      *reinterpret_cast<float2*>(red + m * A8_TW + a8_c) = make_float2(tot[m][2], tot[m][3]);
    } else {
      *reinterpret_cast<float4*>(red + (warp * MT + m) * WARP_COLS + 4 * lane) =
          make_float4(tot[m][0], tot[m][1], tot[m][2], tot[m][3]);
    }
  }
  __syncthreads();
  const int KS = gridDim.y;
  OT* out = static_cast<OT*>(a.out);
  const size_t MO = (size_t)M * O;
  // four adjacent columns of the tile: e4 = m * TW + c .. + 3; each warp's
  // sums add in warp order; with vec16 the four lie wholly inside or outside
  auto red4 = [&](int e4) {
    const int m = e4 / TW, cc = e4 % TW;
    if constexpr (VAR == A8) return *reinterpret_cast<const float4*>(red + m * TW + cc);
    const float* rp = red + ((cc / WARP_COLS) * WPC * MT + m) * WARP_COLS + cc % WARP_COLS;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w2 = 0; w2 < WPC; ++w2) {
      const float4 r = *reinterpret_cast<const float4*>(rp + w2 * MT * WARP_COLS);
      v.x += r.x, v.y += r.y, v.z += r.z, v.w += r.w;
    }
    return v;
  };
  auto store4 = [&](int m, int col, float4 v) {  // the columns of out below col_end
    OT* o = out + (size_t)(m0 + m) * O + col;
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < col_end) o[j] = from_f32<OT>(f[j]);
  };
  for (int e4 = 4 * tid; e4 < Mb * TW; e4 += 4 * THREADS) {
    const int m = e4 / TW, col = col0 + e4 % TW;
    if (col >= col_end) continue;
    const float4 v = red4(e4);
    if (KS == 1) {
      store4(m, col, v);
    } else if (a.vec16) {
      *reinterpret_cast<float4*>(a.partial + ks * MO + (size_t)(m0 + m) * O + col) = v;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && col + j < col_end; ++j)
        a.partial[ks * MO + (size_t)(m0 + m) * O + col + j] = f[j];
    }
  }
  if (KS == 1) return;

  // 6. every split of the tile has written its partial: the last block to
  // arrive sums them in split order and resets the counter
  __syncthreads();
  if (tid == 0) {  // after the barrier, one fence orders the block's partials before its arrival
    __threadfence();
    int* cnt = a.counters + blockIdx.z * gridDim.x + bx;
    last = atomicAdd(cnt, 1) == KS - 1;
    if (last) *cnt = 0;
  }
  __syncthreads();
  if (!last) return;
  if (MT <= 2 && Mb * TW <= THREADS) {  // a column a thread, up to 32 of its partials in flight
    const int m = tid / TW, col = col0 + tid % TW;
    if (m >= Mb || col >= col_end) return;
    const float* src = a.partial + (size_t)(m0 + m) * O + col;
    float v = 0.f, cs = 0.f;
    int left = a.spc;
    for (int k0 = 0; k0 < KS; k0 += 32) {
      float t[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) t[u] = k0 + u < KS ? __ldcg(src + (k0 + u) * MO) : 0.f;
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (k0 + u < KS) merge_add<VAR>(v, cs, left, t[u], k0 + u, KS, a.spc);
    }
    out[(size_t)(m0 + m) * O + col] = from_f32<OT>(v);
    return;
  }
  if (VAR != K1 && MT == 1 && TW <= 2 * THREADS && a.vec16) {  // a column pair a thread
    const int col = col0 + 2 * tid;
    if (2 * tid >= TW || col >= col_end) return;
    const float* src = a.partial + (size_t)m0 * O + col;
    float2 v = make_float2(0.f, 0.f), cs = v;
    int left = a.spc;
    for (int k0 = 0; k0 < KS; k0 += 32) {
      float2 t[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        t[u] = k0 + u < KS ? __ldcg(reinterpret_cast<const float2*>(src + (k0 + u) * MO))
                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (k0 + u < KS) merge_add<VAR>(v, cs, left, t[u], k0 + u, KS, a.spc);
    }
    out[(size_t)m0 * O + col] = from_f32<OT>(v.x);
    out[(size_t)m0 * O + col + 1] = from_f32<OT>(v.y);
    return;
  }
  constexpr int LB = MT <= 4 ? 16 : 8;  // partials in flight a thread
  for (int e4 = 4 * tid; e4 < Mb * TW; e4 += 4 * THREADS) {
    const int m = e4 / TW, col = col0 + e4 % TW;
    if (col >= col_end) continue;
    const float* src = a.partial + (size_t)(m0 + m) * O + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), cs = v;
    int left = a.spc;
    for (int k0 = 0; k0 < KS; k0 += LB) {
      float4 t[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const float* pk = src + (k0 + u) * MO;
        if (k0 + u >= KS) {
          t[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (a.vec16) {
          t[u] = __ldcg(reinterpret_cast<const float4*>(pk));
        } else {
          t[u].x = __ldcg(pk);
          t[u].y = col + 1 < col_end ? __ldcg(pk + 1) : 0.f;
          t[u].z = col + 2 < col_end ? __ldcg(pk + 2) : 0.f;
          t[u].w = col + 3 < col_end ? __ldcg(pk + 3) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < LB; ++u)
        if (k0 + u < KS) merge_add<VAR>(v, cs, left, t[u], k0 + u, KS, a.spc);
    }
    store4(m, col, v);
  }
}

template <typename XT, typename RT, int MT, int VAR>
cudaError_t launch_mt(const Args& a, int n_tiles, int KS, cudaStream_t st) {
  const auto kernel = rot_w4_one_launch_kernel<XT, RT, MT, VAR>;
  const size_t smem =
      layout(MT, a.S, a.gps, a.cw * WARP_COLS, table_floats(VAR, MT, a.S, a.gps, a.K)).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_tiles, KS, (a.M + MT - 1) / MT), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename XT, typename RT, int VAR>
cudaError_t launch(const Args& a, int MT, int n_tiles, int KS, cudaStream_t st) {
  switch (MT) {
    case 1: return launch_mt<XT, RT, 1, VAR>(a, n_tiles, KS, st);
    case 2: return launch_mt<XT, RT, 2, VAR>(a, n_tiles, KS, st);
    case 4: return launch_mt<XT, RT, 4, VAR>(a, n_tiles, KS, st);
    default: return launch_mt<XT, RT, 8, VAR>(a, n_tiles, KS, st);
  }
}

// One launch of variant VAR: x [M, I] (f32 or bf16), rot [P, G, S, S] (f32
// or bf16), qweight u8 [I/2, O] half-split (I4: interleaved), scales/zeros
// [G, O] of dtype codes sdt/zdt, out [M, O] (x's dtype; f32 for V2); column
// tiles of cw * 128 columns (cw 1, 2 or 4), row tiles of row_tile(M, S) rows; KS group
// splits of ceil(G / KS) groups each (DQ: each chunk of `chunk` groups,
// 1 <= chunk <= G, split into ceil(chunk / gps) splits of gps groups but
// the chunk's last, so KS = G / chunk * ceil(chunk / gps) + ceil((G mod
// chunk) / gps)), every split non-empty and at most max(1, max_groups)
// groups in at most MAX_SMEM bytes with the variant's tables; partial f32
// [KS, M, O] when KS > 1 and counters int32, one per (column tile, row
// tile), zero (and left zero). BF takes no rot but inv_s [I] and cos_t,
// sin_t [K, I] (f32; S a power of two where K > 0), A8 no rot; both one
// partition, and A8 tiles of A8_TW columns.
// Grid (column tiles, KS, row tiles). Returns the first CUDA error.
template <int VAR>
cudaError_t call(const void* x, const void* rot, const void* qweight, const void* scales,
                 const void* zeros, void* out, void* partial, void* counters, int M, int I,
                 int S, int P, const int* splits, int KS, int cw, int x_is_bf16, int rot_is_bf16,
                 int sdt, int zdt, cudaStream_t st, int chunk = 0, int gps_dq = 0,
                 const void* inv_s = nullptr, const void* cos_t = nullptr,
                 const void* sin_t = nullptr, int K = 0) {
  Parts parts;
  int vec4;
  if (w4::bad_layout(M, I, S, KS, sdt, zdt) || !w4::make_parts(P, splits, parts, vec4) ||
      (cw != 1 && cw != 2 && cw != 4) || ((VAR == BF || VAR == A8) && P != 1) ||
      (VAR == BF && (inv_s == nullptr || K < 0 ||
                     (K > 0 && ((S & (S - 1)) != 0 || cos_t == nullptr || sin_t == nullptr)))) ||
      (VAR == A8 && cw * WARP_COLS != A8_TW))
    return cudaErrorInvalidValue;
  const int MT = row_tile(M, S);
  const int TW = cw * WARP_COLS, G = I / S;
  int gps = (G + KS - 1) / KS, spc = KS;
  if (VAR == DQ) {
    gps = gps_dq;
    if (chunk < 1 || chunk > G || gps < 1 || gps > chunk) return cudaErrorInvalidValue;
    spc = (chunk + gps - 1) / gps;
    if (KS != G / chunk * spc + (G % chunk + gps - 1) / gps) return cudaErrorInvalidValue;
  } else if ((KS - 1) * gps >= G) {
    return cudaErrorInvalidValue;
  }
  const int gmax = max_groups(MT, S, TW);
  if (gps > (gmax > 1 ? gmax : 1) ||
      layout(MT, S, gps, TW, table_floats(VAR, MT, S, gps, K)).bytes > MAX_SMEM ||
      (KS > 1 && (partial == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  for (int p = 0; p < P; ++p) parts.tile_base[p + 1] = parts.tile_base[p] + (splits[p] + TW - 1) / TW;
  Args a;
  a.x = x;
  a.rot = rot;
  a.qw = static_cast<const uint8_t*>(qweight);
  a.scales = scales;
  a.zeros = zeros;
  a.out = out;
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.I = I;
  a.S = S;
  a.gps = gps;
  a.sdt = sdt;
  a.zdt = zdt;
  a.cw = cw;
  a.chunk = VAR == DQ ? chunk : G;
  a.spc = spc;
  a.vec16 = (uintptr_t)qweight % 16 == 0;
  for (int p = 0; p < P; ++p) a.vec16 &= splits[p] % 16 == 0;
  a.rvec = (S * (rot_is_bf16 ? 2 : 4)) % 16 == 0 && (uintptr_t)rot % 16 == 0;
  a.parts = parts;
  a.inv_s = static_cast<const float*>(inv_s);
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.K = K;
  const int n_tiles = parts.tile_base[P];
  if constexpr (VAR == BF || VAR == A8) {  // no rotation matrix: one instance per x dtype
    if (VAR == BF)
      a.rvec = S % 4 == 0 && ((uintptr_t)inv_s | (uintptr_t)cos_t | (uintptr_t)sin_t) % 16 == 0;
    return x_is_bf16 ? launch<bf16, float, VAR>(a, MT, n_tiles, KS, st)
                     : launch<float, float, VAR>(a, MT, n_tiles, KS, st);
  } else {
    if (x_is_bf16)
      return rot_is_bf16 ? launch<bf16, bf16, VAR>(a, MT, n_tiles, KS, st)
                         : launch<bf16, float, VAR>(a, MT, n_tiles, KS, st);
    return rot_is_bf16 ? launch<float, bf16, VAR>(a, MT, n_tiles, KS, st)
                       : launch<float, float, VAR>(a, MT, n_tiles, KS, st);
  }
}

}  // namespace one
}  // namespace paro
