// Flash prefill attention for Hopper (sm_90a).
//
// Replaces paroquant_tpu/kernels/attention.py::flash_attention (_flash_kernel).
// q [B, Hq, T, D], k/v [B, Hkv, S, D] (head-major, the KV cache layout),
// kv_lens [B] and q_offset [B] int32 read from device memory, so one build
// serves every chunk offset. Query row t of batch b sits at absolute position
// q_offset[b] + t; key s is valid when s < kv_lens[b], s <= that position
// (causal) and s > position - window (sliding window, when window > 0).
// Scores are scaled, optionally tanh-softcapped, and reduced with an online
// softmax in f32. GQA maps query head h to kv head h / (Hq / Hkv). A row with
// no valid key returns 0. Head dims: any D that is a multiple of 8 from 8 to
// 256, as the TPU kernel takes, in four buckets DB = 32, 64, 128 and 256; a
// D inside a bucket bounds the loops at run time, and D equal to its bucket
// takes an instance with D fixed at compile time.
//
// The live key tiles of a block's 64 query rows are [lo, hi) in tiles of 64
// keys, hi = min(kv_len, S, last row's position + 1) (causal) and lo = first
// row's position - window + 1 (window): the counterpart of the Pallas
// index-map clamp, mirrored in kernels/attention.py::flash_live_tiles, which
// the CPU tests hold to the mask. The tensor-core kernel walks exactly those
// tiles (none when hi <= lo: its rows give 0), the SIMT kernel the same
// whenever one is live. Skipping a fully masked tile leaves the online
// softmax unchanged.
//
// bf16 q/k/v: the tensor-core kernel (flash_mma_kernel). Bound on the H100
// at Qwen3-0.6B's 512-token prefill (B 1, Hq 16, Hkv 8, D 128): bytes, 6.3 MB
// of q, k, v and o (1.88 us at 3.35 TB/s), just above the operations (4 D
// flops a valid (query, key) pair, 1.1 GFLOP: 1.09 us at 989 TFLOP/s bf16).
// Neither sets the time: each warp's chain of dependent steps per tile
// does (scores, row maxima across lanes, exponentials, the PV product), so
// the design keeps that chain short and the tensor cores fed. QK and PV run
// on mma.sync.m16n8k16 bf16 x bf16 -> f32 (HMMA), flash-attention-2 style:
// each warp owns 16 query rows; Q's A fragments come from a staged tile by
// ldmatrix, once, into registers (DB <= 128) or per k-step from shared
// memory (DB 256, where 16 rows x 256 dims of f32 O take 128 registers a
// lane); K's B fragments by ldmatrix and V's by ldmatrix.trans. Score
// accumulators stay in registers, where the scale (in log2 units, for
// ex2.approx on the MUFU unit), softcap and mask apply: four unrolled
// bodies (softcap or not, mask or not) chosen per tile, so an interior tile
// spends no instruction on the mask and a call without softcap none on
// tanh. The mask applies only on a tile that crosses, for the warp's rows,
// the causal diagonal, the window's lower edge or kv_len, and a warp skips
// a tile in which none of its rows has a valid key. The online softmax runs
// across the 4 lanes of a row with __shfl_xor_sync (a row with no valid key
// yet subtracts 0, so its masked scores give 2^-1e30 = 0 without a select);
// P is packed to bf16 straight into the PV product's A fragments; O stays
// in registers across tiles and is divided by max(l, 1e-30) on the way out.
// Rounding P to bf16 is the one numerical departure from the TPU kernel's
// f32 P: a relative error of at most 2^-9 per probability while l sums the
// f32 probabilities, so an output row is off by at most 2^-9 of
// sum p |v| / l (random rows land near 1e-3 of their scale), under the
// per-row TOL_KERNEL of 2e-2 that chip_smoke.py holds the kernel to.
//
// K and V come through a cp.async ring: tiles of 64 keys copied in 16-byte
// pieces, in bf16, MSTAGES steps ahead, so the next tiles' copies are in
// flight while the current one is scored. Rows at or past min(kv_len, S)
// and the pieces of the padding [D, dp) (D not a multiple of 16; dp the
// next multiple) are zero-filled by the copy's src-size-0 form, never read.
// A row of a multiple of 128 bytes is XOR-swizzled in 16-byte pieces, any
// other padded by 16 bytes, so the 8 rows an ldmatrix reads hit distinct
// banks. The grid is one-dimensional and runs over the q tiles from the
// last: under the causal rule the last tiles walk the most keys, so they
// start first. Where the grid has at most one block per SM and D <= 128,
// a block has two key groups of 4 warps (KG 2), each walking every other
// tile of the range with its own slots of the ring, merged in a fixed order
// at the end: the longest block's chain of tiles halves and each SM
// sub-partition runs two warps. Otherwise one group (KG 1: with more blocks
// than SMs two blocks share an SM at D <= 128, and KG 1 alone fits D 256).
// No atomics: the same inputs give the same bits. Shared memory: (64 + 2 *
// 64 * MSTAGES * KG) rows of dp bf16 (+ 16 bytes when not swizzled):
// 147,456 B at D 128 and KG 2, 81,920 B at KG 1, 163,840 B at D 256.
//
// f32 q/k/v, and f32 q over bf16 k/v (the hybrid models' f32 residual
// stream over a bf16 cache, as JAX's kernel casts each block to f32): the
// SIMT kernel (flash_kernel), f32 arithmetic throughout and no TF32; k/v
// are widened to f32 as they land in shared memory, the output is f32. One block per (q tile of 64 rows, head, batch), 256 threads; a
// thread keeps the output dims tx + 16 c (c < DB / 16) of its rows in
// registers (the dims tx + 16 c >= D of a ragged last half-tile are masked).
// Shared memory is sized by the runtime D: 4 B * (64 (D+1) + 64 (D+1) + 64 D
// + 64 * 65 + 192), 214,528 B (209.5 KiB) at D = 256, under the 232,448 B a
// block can use.

#include "common.cuh"

using paro::bf16;
using paro::from_f32;
using paro::to_f32;

namespace {

constexpr int TQ = 64;
constexpr int TK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)TQ * (D + 1) + TK * (D + 1) + (size_t)TK * D + TQ * (TK + 1) + 3 * TQ);
}

// T: q's and o's type, KV: k's and v's; DB: the head-dim bucket (a multiple
// of 16); EXACT: D == DB, fixed at compile time
template <typename T, typename KV, int DB, bool EXACT>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    T* __restrict__ o, const int* __restrict__ kv_lens, const int* __restrict__ q_off,
    int Hq, int Hkv, int T_, int S_, int d_rt, float scale, float softcap, int window, int causal) {
  constexpr int NC = DB / 16;  // output dims per thread and row
  const int D = EXACT ? DB : d_rt;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [TQ][D+1]
  float* Ks = Qs + TQ * (D + 1);    // [TK][D+1]
  float* Vs = Ks + TK * (D + 1);    // [TK][D]
  float* Ps = Vs + TK * D;          // [TQ][TK+1]
  float* m_s = Ps + TQ * (TK + 1);  // [TQ] running max
  float* l_s = m_s + TQ;            // [TQ] running denominator
  float* a_s = l_s + TQ;            // [TQ] rescale of this step

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kv_len = min(kv_lens[b], S_);
  const int qo = q_off[b];
  const int q0 = iq * TQ;
  const int q_first = qo + q0;
  const int q_last = qo + min(q0 + TQ, T_) - 1;

  const T* qp = q + ((size_t)b * Hq + h) * (size_t)T_ * D;
  const KV* kp = k + ((size_t)b * Hkv + hk) * (size_t)S_ * D;
  const KV* vp = v + ((size_t)b * Hkv + hk) * (size_t)S_ * D;

  for (int e = tid; e < TQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qs[r * (D + 1) + d] = (q0 + r < T_) ? to_f32(qp[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  if (tid < TQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  // live key range: [lo, hi)
  int hi = kv_len;
  if (causal) hi = min(hi, q_last + 1);
  const int lo = window > 0 ? max(q_first - window + 1, 0) : 0;
  const int jk_lo = lo / TK;
  const int jk_hi = hi > 0 ? (hi + TK - 1) / TK : 0;

  for (int jk = jk_lo; jk < jk_hi; ++jk) {
    const int k0 = jk * TK;
    __syncthreads();
    for (int e = tid; e < TK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < S_;
      Ks[r * (D + 1) + d] = ok ? to_f32(kp[(size_t)(k0 + r) * D + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(vp[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, key columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, kc = tx + 16 * j;
        const int kpos = k0 + kc, qpos = q_first + r;
        float val = s[i][j] * scale;
        if (softcap > 0.f) val = tanhf(val / softcap) * softcap;
        bool valid = kpos < kv_len;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        Ps[r * (TK + 1) + kc] = valid ? val : NEG_INF;
      }
    __syncthreads();

    // online softmax statistics: 4 adjacent lanes per row
    {
      const int r = tid >> 2, part = tid & 3;
      float* prow = Ps + r * (TK + 1) + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float sv = prow[c];
        const float pv = sv == NEG_INF ? 0.f : expf(sv - m_new);
        prow[c] = pv;
        sum += pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V: rows ty*4 + i, dims tx + 16*c (< D)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (TK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (!EXACT && d >= D) break;  // the ragged half-tile: uniform in c per thread
        const float vv = Vs[j * D + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

  T* op = o + ((size_t)b * Hq + h) * (size_t)T_ * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= T_) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (EXACT || d < D) op[(size_t)(q0 + r) * D + d] = from_f32<T>(acc[i][c] / l);
    }
  }
}

template <typename T, typename KV, int DB, bool EXACT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_lens,
                   const int* q_off, int B, int Hq, int Hkv, int T_, int S_, int D, float scale,
                   float softcap, int window, int causal, cudaStream_t st) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, KV, DB, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + TQ - 1) / TQ, Hq, B);
  flash_kernel<T, KV, DB, EXACT><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const KV*)k, (const KV*)v, (T*)o, kv_lens, q_off, Hq, Hkv, T_, S_, D, scale,
      softcap, window, causal);
  return cudaGetLastError();
}

// the smallest bucket that holds D; its exact instance when D fills it
template <typename T, typename KV>
cudaError_t by_dim(const void* q, const void* k, const void* v, void* o, const int* kl,
                   const int* qo, int B, int Hq, int Hkv, int T_, int S_, int D, float scale,
                   float softcap, int window, int causal, cudaStream_t st) {
#define PARO_FLASH_BUCKET(DB)                                                                     \
  if (D <= DB)                                                                                    \
    return D == DB ? launch<T, KV, DB, true>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale,   \
                                             softcap, window, causal, st)                         \
                   : launch<T, KV, DB, false>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale,  \
                                              softcap, window, causal, st);
  PARO_FLASH_BUCKET(32)
  PARO_FLASH_BUCKET(64)
  PARO_FLASH_BUCKET(128)
  PARO_FLASH_BUCKET(256)
#undef PARO_FLASH_BUCKET
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 q/k/v: the tensor-core kernel
// ---------------------------------------------------------------------------

using paro::cp_async16;
using paro::cp_async_commit;
using paro::cp_async_wait;
using paro::ldmatrix_x4;
using paro::ldmatrix_x4_trans;
using paro::mma_bf16;
using paro::pack_bf16;

constexpr int MQ = 64;      // query rows per block: 16 per warp of a key group
constexpr int MK = 64;      // keys per tile
constexpr int MSTAGES = 2;  // steps of tiles in flight in the ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block can use on the H100

// One bf16 row of Q, K or V in shared memory: D zero-padded to dp, a
// multiple of 16; a row of a multiple of 128 bytes XOR-swizzled in 16-byte
// pieces (piece c of row r at c ^ (r & 7)), any other padded by 16 bytes.
struct Rows {
  int dp, bytes;
  bool swz;
};

__host__ __device__ inline Rows rows_of(int D) {
  Rows R;
  R.dp = (D + 15) / 16 * 16;
  R.swz = R.dp * 2 % 128 == 0;
  R.bytes = R.dp * 2 + (R.swz ? 0 : 16);
  return R;
}

// the byte offset of byte x of row `row`
__device__ __forceinline__ int at(const Rows& R, int row, int x) {
  return row * R.bytes + (R.swz ? ((((x >> 4) ^ (row & 7)) << 4) | (x & 15)) : x);
}

// Q's MQ rows, then the ring of MSTAGES * KG slots of a K and a V tile; after
// the last tile the ring holds the second key group's partials (KG 2)
size_t mma_smem(int D, int kg) {
  const size_t ring = (size_t)rows_of(D).bytes * 2 * MK * MSTAGES * kg;
  const size_t part = kg > 1 ? (size_t)4 * (D / 8 + 2) * 32 * 16 : 0;
  return (size_t)rows_of(D).bytes * MQ + (ring > part ? ring : part);
}

// 2^x on the MUFU unit (ex2.approx: relative error below 2^-22; a result
// below 2^-126 flushes to 0, so 2^NEG_INF is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A warp's 16 x 64 scores in log2 units: times mul (CAP: tanh(s * mul) *
// cap_l2, the softcap) and, on a tile the mask can bite (EDGE), NEG_INF
// where the key is not valid for the row; mx takes the lane's row maxima.
// Lane element (j, e) is row qpos[e >> 1], key key0 + 8 j + (e & 1).
template <bool CAP, bool EDGE>
__device__ __forceinline__ void to_logits(float (&sc)[MK / 8][4], float (&mx)[2], float mul,
                                          float cap_l2, int key0, const int (&qpos)[2],
                                          int kv_end, int causal, int window) {
#pragma unroll
  for (int j = 0; j < MK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = CAP ? tanhf(sc[j][e] * mul) * cap_l2 : sc[j][e] * mul;
      if (EDGE) {
        const int key = key0 + j * 8 + (e & 1), qq = qpos[e >> 1];
        const bool ok = key < kv_end && (!causal || key <= qq) && (window <= 0 || key > qq - window);
        x = ok ? x : NEG_INF;
      }
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
}

// DB: the head-dim bucket; EXACT: D == DB; KG: key groups of 4 warps
template <int DB, bool EXACT, int KG>
__global__ void __launch_bounds__(128 * KG, 1) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, const int* __restrict__ kv_lens, const int* __restrict__ q_off,
    int B, int Hq, int Hkv, int T_, int S_, int d_rt, float scale, float softcap, int window,
    int causal) {
  constexpr int NTHREADS = 128 * KG;
  constexpr int NT = DB / 8;        // n-tiles of 8 output dims
  constexpr int KS = DB / 16;       // k-steps of 16 dims
  constexpr bool QREG = DB <= 128;  // Q's A fragments held in registers
  constexpr int SLOTS = MSTAGES * KG;
  const int D = EXACT ? DB : d_rt;
  const Rows R = rows_of(D);
  extern __shared__ __align__(128) unsigned char smem_mma[];
  unsigned char* Qs = smem_mma;
  unsigned char* ring = smem_mma + MQ * R.bytes;

  // the q tiles from the last: the causal tail's blocks walk the most keys
  const int per_tile = Hq * B, nq = (T_ + MQ - 1) / MQ;
  const int iq = nq - 1 - (int)(blockIdx.x / per_tile);
  const int hb = blockIdx.x % per_tile, h = hb % Hq, b = hb / Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 3, grp = warp >> 2;  // the warp's 16 rows, its key group
  const int g = lane >> 2, t4 = lane & 3;
  const int kv_end = max(min(kv_lens[b], S_), 0);
  const int q0 = iq * MQ, q_rows = min(MQ, T_ - q0);
  const int q_first = q_off[b] + q0, q_last = q_first + q_rows - 1;
  // the live key tiles [t_lo, t_lo + n_tiles) (attention.py::flash_live_tiles)
  const int hi = causal ? min(kv_end, q_last + 1) : kv_end;
  const int lo = window > 0 ? max(q_first - window + 1, 0) : 0;
  const int t_lo = lo / MK, n_tiles = hi > lo ? (hi + MK - 1) / MK - t_lo : 0;

  const bf16* qp = q + (((size_t)b * Hq + h) * T_ + q0) * D;
  const bf16* kp = k + ((size_t)b * Hkv + hk) * (size_t)S_ * D;
  const bf16* vp = v + ((size_t)b * Hkv + hk) * (size_t)S_ * D;
  bf16* op = o + (((size_t)b * Hq + h) * T_ + q0) * D;

  if (n_tiles == 0) {  // no row of this tile has a valid key: the output is 0
    for (int e = tid; e < q_rows * (D / 8); e += NTHREADS)
      reinterpret_cast<uint4*>(op)[e] = make_uint4(0, 0, 0, 0);
    return;
  }

  // rows [row0, row0 + rows) of src into dst in 16-byte pieces; rows at or
  // past n_rows and the pieces of the padding [D, dp) are zero-filled, not read
  const int pieces = R.dp / 8, live = D / 8;
  auto stage = [&](unsigned char* dst, const bf16* src, int row0, int rows, int n_rows) {
    for (int e = tid; e < rows * pieces; e += NTHREADS) {
      const int r = e / pieces, c = e - r * pieces;
      const bool in = row0 + r < n_rows && c < live;
      cp_async16(dst + at(R, r, c * 16), in ? src + (size_t)(row0 + r) * D + c * 8 : src,
                 in ? 16 : 0);
    }
  };
  auto slot = [&](int i) { return ring + (size_t)(i % SLOTS) * 2 * MK * R.bytes; };
  auto issue = [&](int i) {  // tile i of the range: its K, then its V
    if (i >= n_tiles) return;
    const int k0 = (t_lo + i) * MK;
    stage(slot(i), kp, k0, MK, kv_end);
    stage(slot(i) + MK * R.bytes, vp, k0, MK, kv_end);
  };
  // step s takes tiles s * KG + [0, KG), tile s * KG + grp for this warp
  stage(Qs, qp, 0, MQ, q_rows);
  for (int s = 0; s < MSTAGES; ++s) {
    for (int j = 0; j < KG; ++j) issue(s * KG + j);
    cp_async_commit();
  }

  const int r0 = mt * 16;  // the warp's first row in the tile
  const bool has_rows = r0 < q_rows;
  const int w_first = q_first + r0, w_last = q_first + min(r0 + 16, q_rows) - 1;
  const int qpos[2] = {w_first + g, w_first + g + 8};  // the lane's rows g and g + 8
  // ldmatrix lanes: Q's A fragment (rows r0 + [0, 16), pieces 2 ks + [0, 2)), K's B
  // fragments of key n-tiles (nk, nk + 1), V's of dim n-tiles (n, n + 1)
  const int qa_row = r0 + ((lane >> 3) & 1) * 8 + (lane & 7), qa_half = lane >> 4;
  const int kb_key = (lane >> 4) * 8 + (lane & 7), kb_half = (lane >> 3) & 1;
  const int vb_key = ((lane >> 3) & 1) * 8 + (lane & 7), vb_n = lane >> 4;
  const float sl2 = scale * LOG2E, cap_l2 = softcap * LOG2E, inv_cap = softcap > 0.f ? scale / softcap : 0.f;

  float acc[NT][4], m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[QREG ? KS : 1][4];

  const int n_steps = (n_tiles + KG - 1) / KG;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<MSTAGES - 1>();  // step s (and Q) has landed
    __syncthreads();               // ... for every thread
    if constexpr (QREG) {
      if (s == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          if (EXACT || ks * 16 < R.dp) ldmatrix_x4(qf[ks], Qs + at(R, qa_row, (2 * ks + qa_half) * 16));
      }
    }
    const int i = s * KG + grp, k0 = (t_lo + i) * MK;
    // a tile in which some row of this warp has a valid key
    const bool live_tile = has_rows && i < n_tiles && k0 < kv_end && (!causal || k0 <= w_last) &&
                           (window <= 0 || k0 + MK - 1 > w_first - window);
    if (live_tile) {
      // the mask can bite: the tile crosses kv_len, the diagonal or the window's edge
      const bool edge = k0 + MK > kv_end || (causal && k0 + MK - 1 > w_first) ||
                        (window > 0 && k0 <= w_last - window);
      const unsigned char* Kt = slot(i);
      const unsigned char* Vt = Kt + MK * R.bytes;

      // S = Q K^T: 16 rows x 64 keys in registers
      float sc[MK / 8][4];
#pragma unroll
      for (int j = 0; j < MK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (!EXACT && ks * 16 >= R.dp) break;
        uint32_t a[4];
        if constexpr (QREG) {
          a[0] = qf[ks][0], a[1] = qf[ks][1], a[2] = qf[ks][2], a[3] = qf[ks][3];
        } else {
          ldmatrix_x4(a, Qs + at(R, qa_row, (2 * ks + qa_half) * 16));
        }
#pragma unroll
        for (int nk = 0; nk < MK / 8; nk += 2) {
          uint32_t bk[4];
          const int key = nk * 8 + kb_key;
          ldmatrix_x4(bk, Kt + at(R, key, (2 * ks + kb_half) * 16));
          mma_bf16(sc[nk], a[0], a[1], a[2], a[3], bk[0], bk[1]);
          mma_bf16(sc[nk + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
        }
      }

      // scale (log2 units), softcap, mask; the online softmax of rows g, g + 8
      float mx[2] = {NEG_INF, NEG_INF};
      const int key0 = k0 + 2 * t4;
      if (softcap > 0.f) {
        if (edge)
          to_logits<true, true>(sc, mx, inv_cap, cap_l2, key0, qpos, kv_end, causal, window);
        else
          to_logits<true, false>(sc, mx, inv_cap, cap_l2, key0, qpos, kv_end, causal, window);
      } else if (edge) {
        to_logits<false, true>(sc, mx, sl2, 0.f, key0, qpos, kv_end, causal, window);
      } else {
        to_logits<false, false>(sc, mx, sl2, 0.f, key0, qpos, kv_end, causal, window);
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_r[hh], mx[hh]);
        alpha[hh] = ex2(m_r[hh] - m_new);
        m_r[hh] = m_new;
        // a row with no valid key yet: every score is NEG_INF and 2^(NEG_INF - 0) = 0
        m_use[hh] = m_new == NEG_INF ? 0.f : m_new;
        l_r[hh] *= alpha[hh];  // the lane's share of l; the quad's sum comes at the end
      }
#pragma unroll
      for (int j = 0; j < MK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[j][e] - m_use[e >> 1]);
          l_r[e >> 1] += p;
          sc[j][e] = p;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V: the score accumulators are P's A fragments, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk) {
        const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        const int key = kk * 16 + vb_key;
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (!EXACT && n * 8 >= D) break;
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + at(R, key, (n + vb_n) * 16));
          mma_bf16(acc[n], a0, a1, a2, a3, bv[0], bv[1]);
          mma_bf16(acc[n + 1], a0, a1, a2, a3, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // step s's slots are free
    for (int j = 0; j < KG; ++j) issue((s + MSTAGES) * KG + j);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 1);
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 2);
  }

  if constexpr (KG == 2) {
    // the second key group's (m, l, O) through the ring, lane by lane, then
    // merged into the first group's registers: m = max, w = 2^(m_k - m)
    __syncthreads();
    float4* part = reinterpret_cast<float4*>(ring);                 // [4][D / 8][32]
    float2* ml = reinterpret_cast<float2*>(part + 4 * (D / 8) * 32);  // [4][2][32]
    if (grp == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (EXACT || n * 8 < D)
          part[(mt * (D / 8) + n) * 32 + lane] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      ml[(mt * 2) * 32 + lane] = make_float2(m_r[0], l_r[0]);
      ml[(mt * 2 + 1) * 32 + lane] = make_float2(m_r[1], l_r[1]);
    }
    __syncthreads();
    if (grp == 1) return;
    float w0[2], w1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 x = ml[(mt * 2 + hh) * 32 + lane];
      const float m = fmaxf(m_r[hh], x.x);
      w0[hh] = ex2(m_r[hh] - m);
      w1[hh] = ex2(x.x - m);
      l_r[hh] = w0[hh] * l_r[hh] + w1[hh] * x.y;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (EXACT || n * 8 < D) {
        const float4 y = part[(mt * (D / 8) + n) * 32 + lane];
        acc[n][0] = w0[0] * acc[n][0] + w1[0] * y.x;
        acc[n][1] = w0[0] * acc[n][1] + w1[0] * y.y;
        acc[n][2] = w0[1] * acc[n][2] + w1[1] * y.z;
        acc[n][3] = w0[1] * acc[n][3] + w1[1] * y.w;
      }
  }

  // the output from registers: rows r0 + g and r0 + g + 8, dims n * 8 + 2 t4 + [0, 2)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= q_rows) continue;
    const float den = fmaxf(l_r[hh], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (!EXACT && n * 8 >= D) break;
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r * D + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * hh] / den, acc[n][2 * hh + 1] / den);
    }
  }
}

template <int DB, bool EXACT, int KG>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, const int* kv_lens,
                       const int* q_off, int B, int Hq, int Hkv, int T_, int S_, int D,
                       float scale, float softcap, int window, int causal, cudaStream_t st) {
  const size_t smem = mma_smem(D, KG);
  const long long blocks = (long long)((T_ + MQ - 1) / MQ) * Hq * B;
  if (smem > SMEM_LIMIT || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<DB, EXACT, KG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  flash_mma_kernel<DB, EXACT, KG><<<(unsigned)blocks, 128 * KG, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, kv_lens, q_off, B, Hq, Hkv, T_,
      S_, D, scale, softcap, window, causal);
  return cudaGetLastError();
}

// *kg: two key groups where the grid has at most one block per SM of the
// current device and D <= 128 (the ring of 2 x 2 slots fits), else one
cudaError_t key_groups(int B, int Hq, int T_, int D, int* kg) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (long long)((T_ + MQ - 1) / MQ) * Hq * B;
  *kg = D <= 128 && blocks <= sms ? 2 : 1;
  return err;
}

template <int KG>
cudaError_t mma_by_dim(const void* q, const void* k, const void* v, void* o, const int* kl,
                       const int* qo, int B, int Hq, int Hkv, int T_, int S_, int D, float scale,
                       float softcap, int window, int causal, cudaStream_t st) {
#define PARO_FLASH_MMA(DB)                                                                        \
  if (D <= DB)                                                                                    \
    return D == DB ? launch_mma<DB, true, KG>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale,  \
                                              softcap, window, causal, st)                        \
                   : launch_mma<DB, false, KG>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale, \
                                               softcap, window, causal, st);
  PARO_FLASH_MMA(32)
  PARO_FLASH_MMA(64)
  PARO_FLASH_MMA(128)
  if constexpr (KG == 1) {
    PARO_FLASH_MMA(256)
  }
#undef PARO_FLASH_MMA
  return cudaErrorInvalidValue;
}

}  // namespace

// Key groups the bf16 kernel takes for this shape on the current device (1
// or 2), -1 when the device cannot be queried.
extern "C" int paro_flash_key_groups(int B, int Hq, int T_, int D) {
  int kg = 0;
  return key_groups(B, Hq, T_, D, &kg) == cudaSuccess ? kg : -1;
}

// q/o [B, Hq, T, D], k/v [B, Hkv, S, D], contiguous (bf16: 16-byte aligned);
// kind 0: all f32, 1: all bf16, 2: f32 q/o over bf16 k/v. kv_lens and q_off
// int32 [B] on the device. D is a multiple of 8 from 8 to 256. softcap <= 0
// and window <= 0 mean none. Returns the first CUDA error (0 on success).
extern "C" int paro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    const void* kv_lens, const void* q_off, int kind, int B,
                                    int Hq, int Hkv, int T_, int S_, int D, float scale,
                                    float softcap, int window, int causal, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || B < 1 || T_ < 1 || S_ < 1 || D < 8 || D > 256 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* kl = (const int*)kv_lens;
  const int* qo = (const int*)q_off;
  if (kind == 0)
    return (int)by_dim<float, float>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale, softcap,
                                     window, causal, st);
  if (kind == 2)
    return (int)by_dim<float, bf16>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale, softcap,
                                    window, causal, st);
  if (kind != 1) return (int)cudaErrorInvalidValue;
  int kg = 0;
  const cudaError_t err = key_groups(B, Hq, T_, D, &kg);
  if (err != cudaSuccess) return (int)err;
  return (int)(kg == 2 ? mma_by_dim<2>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale, softcap,
                                       window, causal, st)
                       : mma_by_dim<1>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, D, scale, softcap,
                                       window, causal, st));
}
