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
//     any time is launch cost. Design: one thread per four elements, a
//     16-byte load, the mask and one packed 4-byte store; scalar code for the
//     tail of R * C and for an input that is not 16-byte aligned.
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
// bytes. B alone is 16 MB (int8) or 32 MB (bf16), about 5.1 and 10.1 us at
// 3.35 TB/s, against 0.14 / 0.27 us of tensor-core work; the TPU's argument
// for int8 (twice the bf16 matrix rate) does not reach a GEMV here. What the
// design does about it:
//  - A block owns a 16-row tile (one mma tile; M is padded to it with zeros,
//    so at M = 8 half the tile is padding) and 64 columns, 16 per warp (two
//    n8 tiles). B is the stream: 16-byte loads, each thread four rows, and
//    the K range is split across blocks (grid.z) so that about 8 blocks per
//    SM keep loads in flight even where the columns alone make 64 blocks.
//    The int8 partials meet through int32 atomicAdd into a zeroed output
//    (exact, the same in any order); the bf16 partials go to scratch and a
//    second pass sums them in split order, so a run gives the same bits
//    every time.
//  - K15/K16 use mma.sync.m16n8k32 s8 x s8 -> s32. Its B operand (.col)
//    wants each column's four K bytes in one register, and B lies [K, N] with
//    N contiguous; ldmatrix.trans moves only 16-bit elements, so each thread
//    transposes its 4 x 16 byte block with __byte_perm on the way into shared
//    memory, stored [n][k] with a padded row (36 words) that makes the
//    fragment reads conflict-free. K16 builds the same tile from the nibbles:
//    row k < S/2 from the low nibbles of byte-row k, row k >= S/2 from the
//    high nibbles of byte-row k - S/2, minus 8 per byte (__vsub4).
//  - K17 uses mma.sync.m16n8k16 bf16 x bf16 -> f32, B staged [k][n] as it
//    lies (rows padded to 144 bytes) and read with ldmatrix.x4.trans.
//  - Ragged M, N and K are zero-filled in shared memory and masked on the
//    store; inputs that are not 16-byte aligned, or whose rows are not a
//    multiple of 16 bytes, are loaded byte by byte.
// Simple and right first: no wgmma, no TMA, no cp.async pipeline.

#include "common.cuh"

using namespace paro;

namespace {

constexpr int THREADS = 128;       // four warps
constexpr int BM = 16;             // rows per block: one mma tile
constexpr int BN = 64;             // columns per block: 16 per warp
constexpr int BK8 = 128;           // K15/K16: K bytes per stage, four m16n8k32 steps
constexpr int SW = BK8 / 4 + 4;    // K15/K16: shared row stride in 32-bit words
constexpr int BK16 = 64;           // K17: K elements per stage, four m16n8k16 steps
constexpr int SH = BK16 + 8;       // K17: shared row stride of A in bf16 (144 bytes)
constexpr int SHB = BN + 8;        // K17: shared row stride of B in bf16 (144 bytes)

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

// ---------------------------------------------------------------------------
// K15 / K16
// ---------------------------------------------------------------------------

// 16 bytes of A's row m from column k into w[4] (zero beyond M and K).
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

// 16 bytes of B's logical row k from column n into w[4] (zero beyond K and N).
// NIB: the row is unpacked from the nibbles of w uint8 [K/2, N] (h = K/2).
template <bool NIB>
__device__ __forceinline__ void load_b8(const uint8_t* __restrict__ B, int k, int n, int K, int N,
                                        int h, bool vec, uint32_t w[4]) {
  if (k >= K) {
    w[0] = w[1] = w[2] = w[3] = 0;
    return;
  }
  int src = k, shift = 0;
  if (NIB && k >= h) {
    src = k - h;
    shift = 4;
  }
  const uint8_t* row = B + (size_t)src * N;
  if (vec && n + 16 <= N) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + n);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    if (NIB) {
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = __vsub4((w[c] >> shift) & 0x0F0F0F0Fu, 0x08080808u);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n + 4 * c + j;
      if (col < N) {
        uint32_t b = row[col];
        if (NIB) b = (((b >> shift) & 15u) - 8u) & 0xFFu;
        word |= b << (8 * j);
      }
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

// grid (N tiles, M tiles, K splits); block z sums K chunks [z*per, (z+1)*per).
// split > 1: out is zeroed beforehand and the partials are added with atomics.
template <bool NIB>
__global__ void __launch_bounds__(THREADS) int8_dot_kernel(
    const uint8_t* __restrict__ A, const uint8_t* __restrict__ B, int* __restrict__ out, int M,
    int K, int N, int per, int vec_a, int vec_b) {
  __shared__ uint32_t sA[BM][SW];  // [m][k/4]
  __shared__ uint32_t sB[BN][SW];  // [n][k/4]: each column's K bytes together
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_chunks = (K + BK8 - 1) / BK8;
  const int c_end = min(n_chunks, (int)(blockIdx.z + 1) * per);
  const int h = K / 2;
  // loaders: A, 16 rows x 8 pieces of 16 bytes; B, 32 quads of rows x 4 pieces of 16 columns
  const int a_row = tid >> 3, a_k = (tid & 7) * 16;
  const int b_cq = tid & 3, b_kq = tid >> 2;
  int acc[2][4] = {};

  for (int c = blockIdx.z * per; c < c_end; ++c) {
    const int k0 = c * BK8;
    uint32_t wa[4];
    load_a8(A, m0 + a_row, k0 + a_k, M, K, vec_a, wa);
#pragma unroll
    for (int i = 0; i < 4; ++i) sA[a_row][a_k / 4 + i] = wa[i];
    uint32_t rows[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      load_b8<NIB>(B, k0 + 4 * b_kq + r, n0 + 16 * b_cq, K, N, h, vec_b, rows[r]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // columns 4q..4q+3 of this thread's 16
      const uint32_t r4[4] = {rows[0][q], rows[1][q], rows[2][q], rows[3][q]};
      uint32_t col[4];
      transpose4x4(r4, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) sB[16 * b_cq + 4 * q + j][b_kq] = col[j];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK8 / 32; ++ks) {
      const int w0 = ks * 8;
      const uint32_t a0 = sA[g][w0 + t], a1 = sA[g + 8][w0 + t];
      const uint32_t a2 = sA[g][w0 + 4 + t], a3 = sA[g + 8][w0 + 4 + t];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = warp * 16 + j * 8 + g;
        mma_s8(acc[j], a0, a1, a2, a3, sB[n][w0 + t], sB[n][w0 + 4 + t]);
      }
    }
    __syncthreads();
  }
  const bool atomic = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + (i >= 2 ? 8 : 0);
      const int n = n0 + warp * 16 + j * 8 + 2 * t + (i & 1);
      if (m < M && n < N) {
        if (atomic) atomicAdd(out + (size_t)m * N + n, acc[j][i]);
        else out[(size_t)m * N + n] = acc[j][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

// 8 bf16 of row r (of `cols` columns) from column c into the 16 bytes at dst
// (zero beyond `rows` and `cols`).
__device__ __forceinline__ void load8_bf16(const bf16* __restrict__ X, int r, int c, int rows,
                                           int cols, bool vec, bf16* dst) {
  if (r < rows && vec && c + 8 <= cols) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(X + (size_t)r * cols + c);
    return;
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j] = (r < rows && c + j < cols) ? X[(size_t)r * cols + c + j] : zero;
}

// grid (N tiles, M tiles, K splits). split > 1: block z writes its partial
// sums to part[z] [M, N]; bf16_combine adds them in order.
__global__ void __launch_bounds__(THREADS) bf16_dot_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out,
    float* __restrict__ part, int M, int K, int N, int per, int vec_a, int vec_b) {
  __shared__ __align__(16) bf16 sA[BM][SH];    // [m][k]
  __shared__ __align__(16) bf16 sB[BK16][SHB];  // [k][n], as B lies
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_chunks = (K + BK16 - 1) / BK16;
  const int c_end = min(n_chunks, (int)(blockIdx.z + 1) * per);
  const int a_row = tid >> 3, a_k = (tid & 7) * 8;
  // ldmatrix.x4.trans: lane l gives row (l & 7) of matrix l >> 3, which is
  // k 0-7 / 8-15 (bit 0) of n 0-7 / 8-15 (bit 1) of this warp's 16 columns
  const int l_k = ((lane >> 3) & 1) * 8 + (lane & 7), l_n = warp * 16 + (lane >> 4) * 8;
  float acc[2][4] = {};

  for (int c = blockIdx.z * per; c < c_end; ++c) {
    const int k0 = c * BK16;
    load8_bf16(A, m0 + a_row, k0 + a_k, M, K, vec_a, &sA[a_row][a_k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 64 rows x 8 pieces of 8 columns
      const int idx = tid + i * THREADS, r = idx >> 3, cc = (idx & 7) * 8;
      load8_bf16(B, k0 + r, n0 + cc, K, N, vec_b, &sB[r][cc]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK16 / 16; ++ks) {
      const int k = ks * 16;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(&sA[g][k + 2 * t]);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(&sA[g + 8][k + 2 * t]);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(&sA[g][k + 8 + 2 * t]);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(&sA[g + 8][k + 8 + 2 * t]);
      uint32_t b[4];
      ldmatrix_x4_trans(b, &sB[k + l_k][l_n]);
      mma_bf16(acc[0], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(acc[1], a0, a1, a2, a3, b[2], b[3]);
    }
    __syncthreads();
  }
  float* dst = gridDim.z > 1 ? part + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + (i >= 2 ? 8 : 0);
      const int n = n0 + warp * 16 + j * 8 + 2 * t + (i & 1);
      if (m < M && n < N) dst[(size_t)m * N + n] = acc[j][i];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in split order
__global__ void bf16_combine(const float* __restrict__ part, float* __restrict__ out,
                             long long n, int split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int z = 1; z < split; ++z) s += part[(size_t)z * n + i];
  out[i] = s;
}

// the K split: chunks of bk, `per` to a block, `split` blocks covering them
// all; grid.y and grid.z stay within 65535
bool bad_split(int M, int K, int N, int bk, int per, int split) {
  if (M < 1 || K < 1 || N < 1 || per < 1 || split < 1 || split > 65535 ||
      (M + BM - 1) / BM > 65535)
    return true;
  const int n_chunks = (K + bk - 1) / bk;
  return (long long)(split - 1) * per >= n_chunks || (long long)split * per < n_chunks;
}

dim3 tile_grid(int M, int N, int split) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, split);
}

template <bool NIB>
int launch_int8(const void* a, const void* b, void* out, int M, int K, int N, int per, int split,
                int vec_a, int vec_b, cudaStream_t st) {
  if (split > 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  int8_dot_kernel<NIB><<<tile_grid(M, N, split), THREADS, 0, st>>>(
      (const uint8_t*)a, (const uint8_t*)b, (int*)out, M, K, N, per, vec_a, vec_b);
  return (int)cudaGetLastError();
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

// K15. a int8 [M, K], b int8 [K, N] -> out int32 [M, N]; the K range in
// `split` blocks of `per` chunks of 128.
extern "C" int paro_int8_dot(const void* a, const void* b, void* out, int M, int K, int N, int per,
                             int split, void* stream) {
  if (bad_split(M, K, N, BK8, per, split)) return (int)cudaErrorInvalidValue;
  return launch_int8<false>(a, b, out, M, K, N, per, split, K % 16 == 0 && aligned16(a),
                            N % 16 == 0 && aligned16(b), (cudaStream_t)stream);
}

// K16. x int8 [M, S], w uint8 [S/2, O] (S even) -> out int32 [M, O]; the
// split as K15's.
extern "C" int paro_fused_unpack_int8_dot(const void* x, const void* w, void* out, int M, int S,
                                          int O, int per, int split, void* stream) {
  if (S % 2 != 0 || bad_split(M, S, O, BK8, per, split)) return (int)cudaErrorInvalidValue;
  return launch_int8<true>(x, w, out, M, S, O, per, split, S % 16 == 0 && aligned16(x),
                           O % 16 == 0 && aligned16(w), (cudaStream_t)stream);
}

// K17. a bf16 [M, K], b bf16 [K, N] -> out f32 [M, N]; the K range in
// `split` blocks of `per` chunks of 64, partials in part f32 [split, M, N]
// (unused when split is 1).
extern "C" int paro_bf16_dot(const void* a, const void* b, void* out, void* part, int M, int K,
                             int N, int per, int split, void* stream) {
  if (bad_split(M, K, N, BK16, per, split)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bf16_dot_kernel<<<tile_grid(M, N, split), THREADS, 0, st>>>(
      (const bf16*)a, (const bf16*)b, (float*)out, (float*)part, M, K, N, per,
      K % 8 == 0 && aligned16(a), N % 8 == 0 && aligned16(b));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long n = (long long)M * N;
  bf16_combine<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)part, (float*)out, n,
                                                            split);
  return (int)cudaGetLastError();
}
