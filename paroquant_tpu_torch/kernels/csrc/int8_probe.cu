// The int8 tensor-core probe, for Hopper (sm_90a).
//
// Replace the four kernels of scripts/kernel_int8_probe.py (formulas in
// ../int8_probe.py). The script asks whether the TPU's int8 matrix-unit path
// is usable for the W4 GEMV and whether it beats bf16; on this card the
// matrix unit is the tensor cores, so the dots run on mma.sync. No library
// call computes a product here.
//
// K14 narrow_cast replaces scripts/kernel_int8_probe.py:49 (probe_narrow_cast):
//     int32 [R, C] -> int8 (x & 15).
//     Bound: bytes (5 B per element); at the probe's 8 x 128 a few KB, so
//     its time is the launch and one dependent DRAM round. Design: one thread
//     per four elements, a 16-byte load, the mask and one packed 4-byte
//     store; scalar code for the tail of R * C and for an input that is not
//     16-byte aligned. At 4096 x 4096 (80 MB) that streams at more than half
//     the bound's rate (PERF.md §6), so nothing more is needed.
// K15 int8_dot replaces scripts/kernel_int8_probe.py:69 (probe_int8_dot) and
//     the int8 arm of :117 (bench_dots): int8 [M, K] @ int8 [K, N] -> int32,
//     exact.
// K16 fused_unpack_int8_dot replaces scripts/kernel_int8_probe.py:95
//     (probe_fused_unpack_int8_dot): x int8 [M, S] @ q, where byte-row r of
//     w uint8 [S/2, O] holds q[r] (low nibble) and q[r + S/2] (high nibble),
//     each minus 8 -> int32 [M, O], exact.
// K17 bf16_dot replaces the bf16 arm of scripts/kernel_int8_probe.py:117
//     (bench_dots): bf16 [M, K] @ bf16 [K, N] -> f32.
//
// Bound of K15-K17 on this card at the script's bench (M = 8, K = N = 4096):
// bytes. B alone is 16 MB (int8), 8 MB (K16's nibbles) or 32 MB (bf16),
// about 5.1, 2.5 and 10.1 us at 3.35 TB/s, against 0.14 / 0.27 us of
// tensor-core work; the TPU's argument for int8 (twice the bf16 matrix rate)
// does not reach a GEMV here.
// K15 and K17 stream B at the bound's rate in one launch, on one skeleton:
//  - They compute out^T = B^T A^T, so that the weight tile is the mma's
//    16-row operand and the rows of A fill its n8 side: at M = 8 no lane
//    multiplies padding. M up to 32 takes more n8 tiles (NM = 1, 2 or 4) of
//    the same B fragments; past 32 rows, row tiles on the grid.
//  - A block owns 128 columns of B and a range of K chunks; a ring of
//    stages of B (K17: 64 x 128 bf16, rows padded to 272 bytes; K15: 128 x
//    128 int8, 16 KB) plus the chunk's rows of A is filled by 16-byte
//    cp.async, three stages ahead: 48 KB of B in flight a block, where 3.35
//    TB/s times a microsecond of latency over 132 SMs asks for about 25 KB
//    an SM. The plans (kernels/int8_probe.py::bf16_plan, int8_plan) split K
//    so that the grid is one wave at one block an SM: at the bench 32
//    column tiles x 4 splits (K17 16 chunks a split, K15 8). For K17 that
//    beat 8 splits (two blocks an SM) and rings of 3, 6 and 8 stages or of
//    32- and 128-row stages, and 256-column tiles (PERF.md §6).
//  - K17's copies of B carry the L2 policy evict_first, so that they
//    replace each other in the L2 rather than what the L2 holds (after a
//    write, dirty lines whose eviction would cost a write each). K15's are
//    plain: with that policy K15 and another kernel's ring raised an
//    illegal instruction on this card (ROADMAP.md §B 4).
//  - K17: mma.sync.m16n8k16 bf16 x bf16 -> f32; B's [k][n] stage gives the
//    A fragments through ldmatrix.x4.trans, A's [m][k] rows the B fragments
//    through ldmatrix.x4 (two k16 steps a load).
//  - K15: mma.sync.m16n8k32 s8 x s8 -> s32, whose 16-row operand (.row)
//    wants four consecutive K bytes of one column of B in a register; no
//    instruction of sm_90a transposes bytes on the way in (ldmatrix.trans
//    moves 16-bit elements, wgmma takes s8 only K-major, TMA does not
//    transpose), so the stage keeps B as it lies, [k][n], and the
//    transposition happens on the way out. Four warps take 32 columns each
//    and two K halves of a stage (two k32 steps each). Lane (g, t) reads the
//    32-bit word g of its warp's columns (columns 4g .. 4g + 3) at k-rows 4t
//    .. 4t + 3 and 16 + 4t .. 16 + 4t + 3 of a step and byte-permutes each
//    four into four columns' k-quads (transpose4x4). The kernel writes out
//    itself, so the mma's rows may stand for B's columns in any order the
//    store undoes: columns 4g and 4g + 1 are rows g and g + 8 of one m16
//    tile, columns 4g + 2 and 4g + 3 of a second. A k32 step costs a lane 8
//    LDS.32 of B, 16 PRMT and 2 NM mma, and every byte read is used. A's
//    fragments are plain 32-bit reads of its staged [m][k] rows (padded by
//    16 bytes: conflict-free). In a B stage each row's 16-byte piece p lies
//    at p ^ 2 ((k >> 2) & 3), for the copy and the read alike, so that the
//    32 lanes' words fall on 32 banks. Each lane then holds four
//    neighbouring columns of each of its rows: the two K halves meet in
//    shared memory and leave as 16-byte stores.
//  - Each block writes its partial (f32 for K17, int32 for K15) where K is
//    split, arrives on its tile's counter, and the last to arrive sums the
//    partials in split order, writes out and resets the counter: one
//    launch, no memset, no atomics on out, the same bits whichever block is
//    last.
//  - Operands that are not 16-byte aligned, or whose rows are not a
//    multiple of 16 bytes, are loaded element by element into the ring;
//    ragged M, N and K are zero-filled in the stage and masked on the store.
// K16 (8 x 4096 -> 4096: 8 MB of w, 2.55 us) is a nibble instance of K15's
//  kernel (int8_stream_kernel<NM, true>), so each byte of w is read once:
//  - A ring stage holds 128 byte-rows [r0, r0 + 128) of w (the same swizzled
//    16 KB as K15's B) and x's rows twice: its columns [r0, r0 + 128) and
//    [S/2 + r0, S/2 + r0 + 128), seen as rows 2m and 2m + 1 of x [2M, S/2].
//  - A lane reads and transposes its B words as K15 does and unpacks each
//    column's k-quad after the transpose (the unpack is byte-wise, so it
//    commutes with it): __vsub4(c & 0x0F0F0F0F, 0x08080808) for the low
//    nibbles, the same of c >> 4 for the high; each word feeds two k32 steps,
//    one on each of x's column ranges.
//  - A byte-row past S/2 is zero-filled like any ragged row, and a zero byte
//    unpacks to q = -8, not 0: x's columns past S/2 are zero in both halves
//    of the stage, so those rows add nothing.
//  - Its plan (kernels/int8_probe.py::fused_plan) is K15's over S/2 byte-rows;
//    its merge is K15's. x's 16-byte copies need S % 32 == 0 (the second
//    half starts at S/2) and an aligned x; otherwise element by element.

#include "common.cuh"

using namespace paro;

namespace {

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

__global__ void narrow_cast_kernel(const int32_t* __restrict__ x, uint8_t* __restrict__ out,
                                   long long n, int vec) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (vec && i + 4 <= n) {
    const int4 v = *reinterpret_cast<const int4*>(x + i);
    const uint32_t p = (uint32_t)(v.x & 15) | ((uint32_t)(v.y & 15) << 8) |
                       ((uint32_t)(v.z & 15) << 16) | ((uint32_t)(v.w & 15) << 24);
    *reinterpret_cast<uint32_t*>(out + i) = p;
  } else {
    for (long long j = i; j < n && j < i + 4; ++j) out[j] = (uint8_t)(x[j] & 15);
  }
}

__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// The byte loads, byte transpose and s8 mma of K15 and K16
// ---------------------------------------------------------------------------

// 16 bytes of A's row m from column k into w[4] (zero beyond M and K); K15
// and K16 load unaligned rows of both operands this way.
__device__ __forceinline__ void load_a8(const uint8_t* __restrict__ A, int m, int k, int M, int K,
                                        bool vec, uint32_t w[4]) {
  if (m >= M) {
    w[0] = w[1] = w[2] = w[3] = 0;
    return;
  }
  const uint8_t* row = A + (size_t)m * K;
  if (vec && k + 16 <= K) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + k);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k + 4 * c + j;
      if (col < K) word |= (uint32_t)row[col] << (8 * j);
    }
    w[c] = word;
  }
}

// Rows r[0..3] of a 4 x 4 byte block -> its columns: byte i of column j is
// byte j of row i.
__device__ __forceinline__ void transpose4x4(const uint32_t r[4], uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

// 8 bf16 of row r (of `cols` columns) from column c into the 16 bytes at dst,
// element by element (zero beyond `rows` and `cols`).
__device__ __forceinline__ void load8_bf16(const bf16* __restrict__ X, int r, int c, int rows,
                                           int cols, bf16* dst) {
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j] = (r < rows && c + j < cols) ? X[(size_t)r * cols + c + j] : zero;
}

// cp_async16 with the L2 policy evict_first: B is read once, so its lines
// leave the L2 before anything else does
__device__ __forceinline__ void cp_async16_evict_first(void* smem_dst, const void* src,
                                                       int src_bytes, uint64_t policy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(d),
               "l"(src), "r"(src_bytes), "l"(policy));
}

constexpr int BF_THREADS = 256;          // eight warps
constexpr int BF_TN = 128;               // columns of B a block takes: 16 a warp
constexpr int BF_BK = 64;                // K rows a ring stage
constexpr int BF_NST = 4;                // ring stages
constexpr int BF_SB = BF_TN + 8;         // shared row stride of B in bf16 (272 bytes)
constexpr int BF_SA = BF_BK + 8;         // shared row stride of A in bf16 (144 bytes)
constexpr int BF_RS = BF_TN + 4;         // row stride of the f32 tile staged for the stores
constexpr int BF_LB = 8;                 // partials in flight a thread in the merge

// bytes of one ring stage for NM n8 tiles of A's rows: B's 64 x 128 and A's 8 NM x 64
__host__ __device__ constexpr int bf_stage(int nm) { return 2 * (BF_BK * BF_SB + 8 * nm * BF_SA); }

// grid (column tiles of 128, K splits of `per` chunks of 64, row tiles of 8 NM
// rows). With K split, block (x, y, z) writes its partial to part[y] [M, NP]
// (NP = 128 gridDim.x) and the last block of (x, z) to arrive on its counter
// sums the gridDim.y partials in split order into out and resets the counter.
template <int NM>
__global__ void __launch_bounds__(BF_THREADS, 2) bf16_dot_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out,
    float* __restrict__ part, int* __restrict__ counters, int M, int K, int N, int per,
    int vec_a, int vec_b, int vec_out) {
  constexpr int MB = 8 * NM;  // rows of A a block takes
  constexpr int STAGE = bf_stage(NM);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BF_TN, ks = blockIdx.y, m0 = blockIdx.z * MB;
  const int KS = gridDim.y, NP = gridDim.x * BF_TN;
  const int c0 = ks * per, nc = min((K + BF_BK - 1) / BF_BK, c0 + per) - c0;  // >= 1

  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  // chunk c of the split into stage c % BF_NST: B's rows [k0, k0 + 64) of the
  // tile's columns (1024 pieces of 16 bytes, four a thread), then A's rows
  // [m0, m0 + MB) of the same K range (MB * 8 pieces); zero outside M, K, N
  auto issue = [&](int c) {
    if (c < nc) {
      const int k0 = (c0 + c) * BF_BK;
      bf16* sb = reinterpret_cast<bf16*>(smem + (c % BF_NST) * STAGE);
      bf16* sa = sb + BF_BK * BF_SB;
#pragma unroll
      for (int i = 0; i < BF_BK * BF_TN / 8 / BF_THREADS; ++i) {
        const int piece = tid + i * BF_THREADS, r = piece >> 4, cc = (piece & 15) * 8;
        const int k = k0 + r, n = n0 + cc;
        bf16* dst = sb + r * BF_SB + cc;
        if (vec_b) {  // N a multiple of 8: a piece lies wholly inside or outside
          const bool ok = k < K && n < N;
          cp_async16_evict_first(dst, ok ? B + (size_t)k * N + n : B, ok ? 16 : 0, policy);
        } else {
          load8_bf16(B, k, n, K, N, dst);
        }
      }
      for (int piece = tid; piece < MB * BF_BK / 8; piece += BF_THREADS) {
        const int r = piece / (BF_BK / 8), kk = piece % (BF_BK / 8) * 8;
        const int m = m0 + r, k = k0 + kk;
        bf16* dst = sa + r * BF_SA + kk;
        if (vec_a) {  // K a multiple of 8
          const bool ok = m < M && k < K;
          cp_async16(dst, ok ? A + (size_t)m * K + k : A, ok ? 16 : 0);
        } else {
          load8_bf16(A, m, k, M, K, dst);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the waits uniform
  };

#pragma unroll
  for (int c = 0; c < BF_NST - 1; ++c) issue(c);
  // ldmatrix rows: the mma's A operand (B^T, 16 columns x 16 k) by .trans,
  // matrix i = lane >> 3 holding columns + 8 (i & 1) and k + 8 (i >> 1); its B
  // operand (A^T) from A's rows 8j + (lane & 7), k + 8 (lane >> 3): the b0, b1
  // of two k16 steps
  const int fa_k = ((lane >> 4) & 1) * 8 + (lane & 7), fa_n = warp * 16 + ((lane >> 3) & 1) * 8;
  const int fb_m = lane & 7, fb_k = (lane >> 3) * 8;
  float acc[NM][4];
#pragma unroll
  for (int j = 0; j < NM; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<BF_NST - 2>();  // chunk c has landed (this thread's pieces)
    __syncthreads();              // everyone's; chunk c - 1's readers are done
    issue(c + BF_NST - 1);
    const bf16* sb = reinterpret_cast<const bf16*>(smem + (c % BF_NST) * STAGE);
    const bf16* sa = sb + BF_BK * BF_SB;
#pragma unroll
    for (int h = 0; h < BF_BK / 32; ++h) {
      uint32_t fb[NM][4];
#pragma unroll
      for (int j = 0; j < NM; ++j) ldmatrix_x4(fb[j], sa + (8 * j + fb_m) * BF_SA + 32 * h + fb_k);
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        uint32_t fa[4];
        ldmatrix_x4_trans(fa, sb + (32 * h + 16 * s2 + fa_k) * BF_SB + fa_n);
#pragma unroll
        for (int j = 0; j < NM; ++j)
          mma_bf16(acc[j], fa[0], fa[1], fa[2], fa[3], fb[j][2 * s2], fb[j][2 * s2 + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tile [MB][BF_RS] f32 reuses it

  // acc[j] holds out^T[column warp * 16 + g (+ 8 for 2, 3)][row 8j + 2t (+ 1 for 1, 3)]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    const int m = 8 * j + 2 * t, n = warp * 16 + g;
    red[m * BF_RS + n] = acc[j][0];
    red[(m + 1) * BF_RS + n] = acc[j][1];
    red[m * BF_RS + n + 8] = acc[j][2];
    red[(m + 1) * BF_RS + n + 8] = acc[j][3];
  }
  __syncthreads();
  const int Mb = min(MB, M - m0);
  auto store4 = [&](int m, int col, float4 v) {  // out's columns below N
    float* o = out + (size_t)(m0 + m) * N + col;
    if (vec_out && col + 4 <= N) {
      *reinterpret_cast<float4*>(o) = v;
      return;
    }
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) o[j] = f[j];
  };
  for (int e4 = 4 * tid; e4 < Mb * BF_TN; e4 += 4 * BF_THREADS) {
    const int m = e4 / BF_TN, cc = e4 % BF_TN;
    const float4 v = *reinterpret_cast<const float4*>(red + m * BF_RS + cc);
    if (KS == 1) {
      if (n0 + cc < N) store4(m, n0 + cc, v);
    } else {  // the partial's rows are NP wide: every 16-byte store aligned
      *reinterpret_cast<float4*>(part + ((size_t)ks * M + m0 + m) * NP + n0 + cc) = v;
    }
  }
  if (KS == 1) return;

  // every split of the tile has written its partial: the last block to
  // arrive sums them in split order and resets the counter
  __syncthreads();
  if (tid == 0) {  // after the barrier, one fence orders the block's partials before its arrival
    __threadfence();
    int* cnt = counters + blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(cnt, 1) == KS - 1;
    if (last) *cnt = 0;
  }
  __syncthreads();
  if (!last) return;
  const size_t MNP = (size_t)M * NP;
  for (int e4 = 4 * tid; e4 < Mb * BF_TN; e4 += 4 * BF_THREADS) {
    const int m = e4 / BF_TN, col = n0 + e4 % BF_TN;
    if (col >= N) continue;
    const float* src = part + (size_t)(m0 + m) * NP + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < KS; k0 += BF_LB) {
      float4 p[BF_LB];
#pragma unroll
      for (int u = 0; u < BF_LB; ++u)
        p[u] = k0 + u < KS ? __ldcg(reinterpret_cast<const float4*>(src + (k0 + u) * MNP))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < BF_LB; ++u)
        if (k0 + u < KS) v.x += p[u].x, v.y += p[u].y, v.z += p[u].z, v.w += p[u].w;
    }
    store4(m, col, v);
  }
}

template <int NM>
int launch_bf16(const void* a, const void* b, void* out, void* part, void* counters, int M, int K,
                int N, int per, int split, int vec_a, int vec_b, int vec_out, cudaStream_t st) {
  const auto kernel = bf16_dot_kernel<NM>;
  const int smem = BF_NST * bf_stage(NM);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BF_TN - 1) / BF_TN, split, (M + 8 * NM - 1) / (8 * NM));
  kernel<<<grid, BF_THREADS, smem, st>>>((const bf16*)a, (const bf16*)b, (float*)out,
                                         (float*)part, (int*)counters, M, K, N, per, vec_a,
                                         vec_b, vec_out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K15 and K16
// ---------------------------------------------------------------------------

constexpr int I8_THREADS = 256;          // eight warps: four column groups x two K halves
constexpr int I8_TN = 128;               // columns of B a block takes: 32 a column group
constexpr int I8_BK = 128;               // K rows a ring stage: four k32 steps, two a K half
constexpr int I8_NST = 4;                // ring stages
constexpr int I8_SA = I8_BK + 16;        // shared row stride of A in bytes (144)
constexpr int I8_RS = I8_TN + 4;         // row stride of the int32 tile staged for the stores
constexpr int I8_LB = 8;                 // partials in flight a thread in the merge

// bytes of one ring stage for NM n8 tiles of A's rows: B's 128 x 128 and A's 8 NM x 128
// (NIB, K16: two such rows a row of x, one for each half of its columns)
__host__ __device__ constexpr int i8_stage(int nm, bool nib = false) {
  return I8_BK * I8_TN + (nib ? 2 : 1) * 8 * nm * I8_SA;
}

// four bytes' low (h = 0) or high (h = 1) nibbles as int8, each minus 8
__device__ __forceinline__ uint32_t nibbles_s8(uint32_t c, int h) {
  return __vsub4((c >> (4 * h)) & 0x0F0F0F0Fu, 0x08080808u);
}

// byte offset in a B stage of the 16-byte piece p (of 8) of the stage's k-row
// r: the piece index XOR 2 ((r >> 2) & 3), so that a k32 step's fragment
// reads of the 32 lanes fall on 32 banks
__device__ __forceinline__ int i8_swizzle(int r, int p) {
  return r * I8_TN + ((p ^ (((r >> 2) & 3) << 1)) << 4);
}

// grid (column tiles of 128, K splits of `per` chunks of 128, row tiles of
// 8 NM rows). With K split, block (x, y, z) writes its int32 partial to
// part[y] [M, NP] (NP = 128 gridDim.x) and the last block of (x, z) to
// arrive on its counter sums the gridDim.y partials in split order into out
// and resets the counter. NIB (K16): A is x int8 [M, 2K] and B is w uint8
// [K, N], whose byte-row r holds the dot's rows r (low nibbles) and K + r
// (high), each minus 8.
template <int NM, bool NIB = false>
__global__ void __launch_bounds__(I8_THREADS, 2) int8_stream_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ B, int* __restrict__ out,
    int* __restrict__ part, int* __restrict__ counters, int M, int K, int N, int per, int vec_a,
    int vec_b, int vec_out) {
  constexpr int MB = 8 * NM;  // rows of A a block takes
  constexpr int STAGE = i8_stage(NM, NIB);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp & 3, kh = warp >> 2;  // the warp's 32 columns and K half of a stage
  const int n0 = blockIdx.x * I8_TN, ks = blockIdx.y, m0 = blockIdx.z * MB;
  const int KS = gridDim.y, NP = gridDim.x * I8_TN;
  const int c0 = ks * per, nc = min((K + I8_BK - 1) / I8_BK, c0 + per) - c0;  // >= 1

  // chunk c of the split into stage c % I8_NST: B's rows [k0, k0 + 128) of
  // the tile's columns (1024 pieces of 16 bytes, four a thread, at their
  // swizzled places), then A's rows [m0, m0 + MB) of the same K range (MB * 8
  // pieces; NIB: x's rows [m0, m0 + MB) as rows 2m of x [2M, K], then as rows
  // 2m + 1, 2 MB * 8 pieces); zero outside M, K, N
  auto issue = [&](int c) {
    if (c < nc) {
      const int k0 = (c0 + c) * I8_BK;
      unsigned char* sb = smem + (c % I8_NST) * STAGE;
      unsigned char* sa = sb + I8_BK * I8_TN;
#pragma unroll
      for (int i = 0; i < I8_BK * I8_TN / 16 / I8_THREADS; ++i) {
        const int piece = tid + i * I8_THREADS, r = piece >> 3, p = piece & 7;
        const int k = k0 + r, n = n0 + 16 * p;
        unsigned char* dst = sb + i8_swizzle(r, p);
        if (vec_b) {  // N a multiple of 16: a piece lies wholly inside or outside
          const bool ok = k < K && n < N;
          cp_async16(dst, ok ? B + (size_t)k * N + n : B, ok ? 16 : 0);
        } else {  // B's row k from column n, byte by byte
          load_a8(B, k, n, K, N, 0, reinterpret_cast<uint32_t*>(dst));
        }
      }
      if constexpr (NIB) {  // x's columns past K are zero in both halves: B's zero rows are q = -8
        for (int piece = tid; piece < 2 * MB * I8_BK / 16; piece += I8_THREADS) {
          const int r = piece >> 3, kk = (piece & 7) * 16;
          const int m = m0 + r % MB, k = k0 + kk, xr = 2 * m + r / MB;  // x's half r / MB
          unsigned char* dst = sa + r * I8_SA + kk;
          if (vec_a) {  // K a multiple of 16
            const bool ok = m < M && k < K;
            cp_async16(dst, ok ? A + (size_t)xr * K + k : A, ok ? 16 : 0);
          } else {
            load_a8(A, xr, k, 2 * M, K, 0, reinterpret_cast<uint32_t*>(dst));
          }
        }
      } else {
        for (int piece = tid; piece < MB * I8_BK / 16; piece += I8_THREADS) {
          const int r = piece >> 3, kk = (piece & 7) * 16;
          const int m = m0 + r, k = k0 + kk;
          unsigned char* dst = sa + r * I8_SA + kk;
          if (vec_a) {  // K a multiple of 16
            const bool ok = m < M && k < K;
            cp_async16(dst, ok ? A + (size_t)m * K + k : A, ok ? 16 : 0);
          } else {
            load_a8(A, m, k, M, K, 0, reinterpret_cast<uint32_t*>(dst));
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the waits uniform
  };

#pragma unroll
  for (int c = 0; c < I8_NST - 1; ++c) issue(c);
  // lane (g, t) reads word g of its warp's 32 columns (columns 4g .. 4g + 3)
  // at k-rows 4t + i and 16 + 4t + i of a k32 step; all eight rows share the
  // swizzle 2t, so the word's byte offset in a row is fixed
  const int wb = (((2 * cg + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
  int acc[2][NM][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NM; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0;
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<I8_NST - 2>();  // chunk c has landed (this thread's pieces)
    __syncthreads();              // everyone's; chunk c - 1's readers are done
    issue(c + I8_NST - 1);
    const unsigned char* sb = smem + (c % I8_NST) * STAGE;
    const unsigned char* sa = sb + I8_BK * I8_TN;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int kb = 32 * (2 * kh + s);  // the k32 step's first row in the stage
      uint32_t lo[4], hi[4], cl[4], ch[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = *reinterpret_cast<const uint32_t*>(sb + (kb + 4 * t + i) * I8_TN + wb);
        hi[i] = *reinterpret_cast<const uint32_t*>(sb + (kb + 16 + 4 * t + i) * I8_TN + wb);
      }
      transpose4x4(lo, cl);  // cl[j]: column 4g + j at k 4t .. 4t + 3
      transpose4x4(hi, ch);  // ch[j]: the same at k 16 + 4t .. 16 + 4t + 3
      if constexpr (NIB) {  // the low nibbles against x's first half, the high against its second
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t ql[4], qh[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ql[i] = nibbles_s8(cl[i], h), qh[i] = nibbles_s8(ch[i], h);
#pragma unroll
          for (int j = 0; j < NM; ++j) {
            const unsigned char* ra = sa + (h * MB + 8 * j + g) * I8_SA + kb + 4 * t;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ra);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ra + 16);
            mma_s8(acc[0][j], ql[0], ql[1], qh[0], qh[1], b0, b1);
            mma_s8(acc[1][j], ql[2], ql[3], qh[2], qh[3], b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NM; ++j) {
          const unsigned char* ra = sa + (8 * j + g) * I8_SA + kb + 4 * t;  // A's row 8j + g
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ra);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ra + 16);
          mma_s8(acc[0][j], cl[0], cl[1], ch[0], ch[1], b0, b1);  // rows g, g + 8: columns 4g, 4g + 1
          mma_s8(acc[1][j], cl[2], cl[3], ch[2], ch[3], b0, b1);  // columns 4g + 2, 4g + 3
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tile [MB][I8_RS] int32 reuses it

  // acc[h][j] holds out^T[column 4g + 2h (+ 1 for 2, 3)][row 8j + 2t (+ 1 for
  // 1, 3)] of the warp's 32: a lane has four neighbouring columns of each of
  // its rows. The second K half adds its sums to the first's.
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (kh == half) {
#pragma unroll
      for (int j = 0; j < NM; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int4* p = reinterpret_cast<int4*>(red + (8 * j + 2 * t + e) * I8_RS + 32 * cg + 4 * g);
          int4 v = make_int4(acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]);
          if (half == 1) {
            const int4 o = *p;
            v.x += o.x, v.y += o.y, v.z += o.z, v.w += o.w;
          }
          *p = v;
        }
    }
    __syncthreads();
  }
  const int Mb = min(MB, M - m0);
  auto store4 = [&](int m, int col, int4 v) {  // out's columns below N
    int* o = out + (size_t)(m0 + m) * N + col;
    if (vec_out && col + 4 <= N) {
      *reinterpret_cast<int4*>(o) = v;
      return;
    }
    const int f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) o[j] = f[j];
  };
  for (int e4 = 4 * tid; e4 < Mb * I8_TN; e4 += 4 * I8_THREADS) {
    const int m = e4 / I8_TN, cc = e4 % I8_TN;
    const int4 v = *reinterpret_cast<const int4*>(red + m * I8_RS + cc);
    if (KS == 1) {
      if (n0 + cc < N) store4(m, n0 + cc, v);
    } else {  // the partial's rows are NP wide: every 16-byte store aligned
      *reinterpret_cast<int4*>(part + ((size_t)ks * M + m0 + m) * NP + n0 + cc) = v;
    }
  }
  if (KS == 1) return;

  // every split of the tile has written its partial: the last block to
  // arrive sums them in split order and resets the counter
  __syncthreads();
  if (tid == 0) {  // after the barrier, one fence orders the block's partials before its arrival
    __threadfence();
    int* cnt = counters + blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(cnt, 1) == KS - 1;
    if (last) *cnt = 0;
  }
  __syncthreads();
  if (!last) return;
  const size_t MNP = (size_t)M * NP;
  for (int e4 = 4 * tid; e4 < Mb * I8_TN; e4 += 4 * I8_THREADS) {
    const int m = e4 / I8_TN, col = n0 + e4 % I8_TN;
    if (col >= N) continue;
    const int* src = part + (size_t)(m0 + m) * NP + col;
    int4 v = make_int4(0, 0, 0, 0);
    for (int k0 = 0; k0 < KS; k0 += I8_LB) {
      int4 p[I8_LB];
#pragma unroll
      for (int u = 0; u < I8_LB; ++u)
        p[u] = k0 + u < KS ? __ldcg(reinterpret_cast<const int4*>(src + (k0 + u) * MNP))
                           : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < I8_LB; ++u)
        if (k0 + u < KS) v.x += p[u].x, v.y += p[u].y, v.z += p[u].z, v.w += p[u].w;
    }
    store4(m, col, v);
  }
}

template <int NM, bool NIB>
int launch_i8(const void* a, const void* b, void* out, void* part, void* counters, int M, int K,
              int N, int per, int split, int vec_a, int vec_b, int vec_out, cudaStream_t st) {
  const auto kernel = int8_stream_kernel<NM, NIB>;
  const int smem = I8_NST * i8_stage(NM, NIB);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + I8_TN - 1) / I8_TN, split, (M + 8 * NM - 1) / (8 * NM));
  kernel<<<grid, I8_THREADS, smem, st>>>((const uint8_t*)a, (const uint8_t*)b, (int*)out,
                                         (int*)part, (int*)counters, M, K, N, per, vec_a, vec_b,
                                         vec_out);
  return (int)cudaGetLastError();
}

// the K split: chunks of bk, `per` to a block, `split` blocks covering them
// all; grid.y and grid.z stay within 65535
bool bad_split(int M, int K, int N, int bk, int per, int split) {
  if (M < 1 || K < 1 || N < 1 || per < 1 || split < 1 || split > 65535) return true;
  const int n_chunks = (K + bk - 1) / bk;
  return (long long)(split - 1) * per >= n_chunks || (long long)split * per < n_chunks;
}

}  // namespace

// K14. x int32 [n] -> out int8 [n]: x & 15.
extern "C" int paro_narrow_cast(const void* x, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long threads = (n + 3) / 4;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  const int vec = aligned16(x) && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  narrow_cast_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (uint8_t*)out, n, vec);
  return (int)cudaGetLastError();
}

// K15. a int8 [M, K], b int8 [K, N] -> out int32 [M, N]; blocks of `rows`
// rows of a (8, 16 or 32) and 128 columns of b, the K range in `split`
// blocks of `per` chunks of 128; with split > 1 the scratch part int32
// [split, M, 128 ceil(N / 128)] and counters int32, one per (column tile, row
// tile), zero and left zero. Returns the first CUDA error (0 on success).
extern "C" int paro_int8_dot(const void* a, const void* b, void* out, void* part, void* counters,
                             int M, int K, int N, int per, int split, int rows, void* stream) {
  if ((rows != 8 && rows != 16 && rows != 32) || bad_split(M, K, N, I8_BK, per, split) ||
      (M + rows - 1) / rows > 65535 || (split > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int vec_a = K % 16 == 0 && aligned16(a), vec_b = N % 16 == 0 && aligned16(b);
  const int vec_out = N % 4 == 0 && aligned16(out);
  const auto launch =
      rows == 8 ? launch_i8<1, false> : rows == 16 ? launch_i8<2, false> : launch_i8<4, false>;
  return launch(a, b, out, part, counters, M, K, N, per, split, vec_a, vec_b, vec_out,
                (cudaStream_t)stream);
}

// K16. x int8 [M, S], w uint8 [S/2, O] (S even) -> out int32 [M, O]; K15's
// launch over the S/2 byte-rows of w: blocks of `rows` rows of x and 128
// columns of w, the byte-rows in `split` blocks of `per` chunks of 128, and
// part and counters as K15's. Returns the first CUDA error (0 on success).
extern "C" int paro_fused_unpack_int8_dot(const void* x, const void* w, void* out, void* part,
                                          void* counters, int M, int S, int O, int per, int split,
                                          int rows, void* stream) {
  const int K = S / 2;
  if (S % 2 != 0 || (rows != 8 && rows != 16 && rows != 32) ||
      bad_split(M, K, O, I8_BK, per, split) || (M + rows - 1) / rows > 65535 || M > (1 << 29) ||
      (split > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int vec_a = K % 16 == 0 && aligned16(x), vec_b = O % 16 == 0 && aligned16(w);
  const int vec_out = O % 4 == 0 && aligned16(out);
  const auto launch =
      rows == 8 ? launch_i8<1, true> : rows == 16 ? launch_i8<2, true> : launch_i8<4, true>;
  return launch(x, w, out, part, counters, M, K, O, per, split, vec_a, vec_b, vec_out,
                (cudaStream_t)stream);
}

// An empty kernel on the stream: the launch floor that chip_smoke.py times.
extern "C" int paro_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// K17. a bf16 [M, K], b bf16 [K, N] -> out f32 [M, N]; blocks of `rows` rows
// of a (8, 16 or 32) and 128 columns of b, the K range in `split` blocks of
// `per` chunks of 64; with split > 1 the scratch part f32 [split, M, 128
// ceil(N / 128)] and counters int32, one per (column tile, row tile), zero
// and left zero. Returns the first CUDA error (0 on success).
extern "C" int paro_bf16_dot(const void* a, const void* b, void* out, void* part, void* counters,
                             int M, int K, int N, int per, int split, int rows, void* stream) {
  if ((rows != 8 && rows != 16 && rows != 32) || bad_split(M, K, N, BF_BK, per, split) ||
      (M + rows - 1) / rows > 65535 || (split > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int vec_a = K % 8 == 0 && aligned16(a), vec_b = N % 8 == 0 && aligned16(b);
  const int vec_out = N % 4 == 0 && aligned16(out);
  const auto launch = rows == 8 ? launch_bf16<1> : rows == 16 ? launch_bf16<2> : launch_bf16<4>;
  return launch(a, b, out, part, counters, M, K, N, per, split, vec_a, vec_b, vec_out,
                (cudaStream_t)stream);
}
