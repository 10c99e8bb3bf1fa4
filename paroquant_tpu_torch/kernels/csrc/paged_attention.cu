// Paged decode (K4) and paged speculative-verify (K5) attention for Hopper (sm_90a).
//
// Replaces paroquant_tpu/kernels/attention.py::paged_decode_attention
// (_paged_decode_kernel) and ::paged_window_attention_kernel
// (_paged_window_kernel). Both launchers share one device routine: K4 is the
// W = 1 case whose lengths include the current token, K5 takes a window of W
// queries per slot whose lengths exclude the window.
//
// q [B, W, Hq, D] (K4: [B, Hq, D]); pools k/v [P, ps, Hkv, D] of f32, bf16
// or int8, with per-(token, head) dequant scales ks/vs [P, Hkv, ps] f32 (the
// page size last, as the JAX pool keeps them) when int8; page_table [B, maxP]
// and lens [B] int32 in device memory. Query row (w, g) of kv head hk is head
// hk * grp + g at absolute position base + w, where base = lens[b] - 1 (K4)
// or lens[b] (K5). Key position s is valid when s <= that position and, with
// a sliding window, s > position - window. Scores are (q . k) * ks * scale,
// tanh-softcapped before the mask, reduced with an online softmax in f32; vs
// multiplies the probabilities before the PV product, as in the TPU kernel.
// The output is acc / max(l, 1e-30) in q's dtype, so a slot with no valid key
// (K4 with lens[b] == 0) gives 0.
//
// One block per (kv head, slot, chunk of query rows). The block reads
// lens[b] and the slot's page ids itself (the counterpart of the Pallas
// scalar prefetch) and walks only the live pages, min(ceil((base + W) / ps),
// maxP) of them (the TPU kernel's index-map clamp): one build serves every
// length, and no host sync is needed. The query rows of a chunk share every
// K/V tile read. Pages wholly before a sliding window are skipped: a fully
// masked tile leaves the online softmax unchanged.
//
// Head dims and rows: any D that is a multiple of 8 from 8 to 256 and any
// number R = W * grp of query rows per kv head, as the TPU kernels take. A
// block keeps its rows' queries, probabilities and accumulators in shared
// memory, 4 B * (2 R D + 64 (D+1) + 64 D + 67 R + 128) (smem_bytes), so
// the rows are split into chunks of at most 64 that fit the 232,448 B a
// block can use (at most 43 rows at D = 256, where 64 rows would take
// 280 KB), one grid dimension over the chunks. Each chunk walks the slot's
// live pages itself: with C chunks the slot's K/V rows are read C times,
// the reads after the first mostly from L2 (the chunks of a slot run side
// by side), so a split costs up to (C - 1) times the K/V bytes of L2
// traffic and C times the per-tile scoring overhead. D = 64 and 128 take
// instances with D fixed at compile time; any other D one with D read at
// run time. Pool rows are read as 16-byte vectors (8 bytes for an int8
// pool whose D is not a multiple of 16).
//
// Bound on the H100: bytes. Each live K/V row of the slot's kv head is read
// once (plus its two f32 scales with int8); the arithmetic is 4 * W * grp * D
// operations per key row, far below the memory line. This first kernel loads
// each tile with plain vector loads into shared memory and computes in f32
// on the SIMT units; with one block per (slot, kv head), B * Hkv = 64 blocks
// fill half of the 132 SMs at Qwen3-0.6B's B = 8. A split over pages,
// cp.async/TMA double buffering and mma.sync for K5's rows are later work.

#include "common.cuh"

using paro::bf16;
using paro::from_f32;
using paro::to_f32;

namespace {

constexpr int THREADS = 128;
constexpr int TK_MAX = 64;    // key rows per tile (min(ps, 64))
constexpr int MAX_ROWS = 64;  // query rows per block (per chunk)
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block can use on the H100
constexpr float NEG_INF = -1e30f;

size_t smem_bytes(int R, int D) {
  // Qs [R][D], Ks [TK][D+1], Vs [TK][D], Ps [R][TK], Acc [R][D], m/l/alpha [R], ks/vs [TK]
  return sizeof(float) * ((size_t)R * D + TK_MAX * (D + 1) + TK_MAX * D + (size_t)R * TK_MAX +
                          (size_t)R * D + 3 * R + 2 * TK_MAX);
}

// rows per chunk: the fewest chunks of at most MAX_ROWS rows that fit shared
// memory, balanced
int chunk_rows(int R, int D) {
  int cap = MAX_ROWS;
  while (cap > 1 && smem_bytes(cap, D) > SMEM_LIMIT) --cap;
  const int n = (R + cap - 1) / cap;
  return (R + n - 1) / n;
}

// one vector of N elements of a pool row -> f32 in shared memory
template <typename T, int N>
struct Vec;
template <>
struct Vec<float, 4> {
  __device__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};
template <>
struct Vec<bf16, 8> {
  __device__ static void load(const bf16* src, float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
  }
};
template <>
struct Vec<int8_t, 16> {
  __device__ static void load(const int8_t* src, float* dst) {
    const int4 v = *reinterpret_cast<const int4*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = (float)c[i];
  }
};
template <>
struct Vec<int8_t, 8> {  // D a multiple of 8 but not of 16: rows are 8-byte aligned
  __device__ static void load(const int8_t* src, float* dst) {
    const int2 v = *reinterpret_cast<const int2*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = (float)c[i];
  }
};

// the tile's K and V rows [tk][D] -> Ks [tk][D+1], Vs [tk][D] in f32, VN elements a load
template <typename TKV, int VN>
__device__ __forceinline__ void load_tile(const TKV* kbase, const TKV* vbase, size_t row_stride,
                                          int tk, int D, float* Ks, float* Vs) {
  for (int c = threadIdx.x; c < tk * (D / VN); c += THREADS) {
    const int t = c / (D / VN), d0 = (c % (D / VN)) * VN;
    float buf[VN];
    Vec<TKV, VN>::load(kbase + t * row_stride + d0, buf);
#pragma unroll
    for (int i = 0; i < VN; ++i) Ks[t * (D + 1) + d0 + i] = buf[i];
    Vec<TKV, VN>::load(vbase + t * row_stride + d0, buf);
#pragma unroll
    for (int i = 0; i < VN; ++i) Vs[t * D + d0 + i] = buf[i];
  }
}

// DC: D fixed at compile time (64, 128), or 0 for a D read at run time
template <typename TQ, typename TKV, int DC>
__global__ void __launch_bounds__(THREADS) paged_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, TQ* __restrict__ o,
    const int* __restrict__ table, const int* __restrict__ lens, int W, int Hq, int Hkv,
    int d_rt, int ps, int maxP, int rows_per_chunk, int lens_include_current, float scale,
    float softcap, int window) {
  extern __shared__ float smem[];
  const int D = DC > 0 ? DC : d_rt;
  const int grp = Hq / Hkv;
  // this block's query rows: r0 + [0, R) of the kv head's W * grp
  const int r0 = blockIdx.z * rows_per_chunk;
  const int R = min(rows_per_chunk, W * grp - r0);
  float* Qs = smem;                     // [R][D]
  float* Ks = Qs + R * D;               // [TK][D+1]
  float* Vs = Ks + TK_MAX * (D + 1);    // [TK][D]
  float* Ps = Vs + TK_MAX * D;          // [R][TK]
  float* Acc = Ps + R * TK_MAX;         // [R][D]
  float* m_s = Acc + R * D;             // [R]
  float* l_s = m_s + R;                 // [R]
  float* a_s = l_s + R;                 // [R]
  float* ks_s = a_s + R;                // [TK]
  float* vs_s = ks_s + TK_MAX;          // [TK]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool quant = ks != nullptr;
  const int base = lens_include_current ? lens[b] - 1 : lens[b];
  const int n_keys = base + W;  // key positions [0, base + W) can be valid
  const int n_pages = min(n_keys > 0 ? (n_keys + ps - 1) / ps : 0, maxP);
  const int tk = min(ps, TK_MAX);
  const int tiles_per_page = ps / tk;
  // first tile that can hold a valid key of the earliest query row
  const int lo = window > 0 ? max(base - window + 1, 0) : 0;

  for (int e = tid; e < R * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int w = (r0 + r) / grp, g = (r0 + r) % grp;
    Qs[e] = to_f32<TQ>(q[(((size_t)b * W + w) * Hq + hk * grp + g) * D + d]);
    Acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  for (int it = lo / tk; it < n_pages * tiles_per_page; ++it) {
    const int p = it / tiles_per_page;
    const int t0 = (it % tiles_per_page) * tk;  // first row of the tile in its page
    const int pos0 = p * ps + t0;               // absolute position of that row
    const size_t page = (size_t)table[(size_t)b * maxP + p];
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    const TKV* kbase = kp + (page * ps + t0) * row_stride + (size_t)hk * D;
    const TKV* vbase = vp + (page * ps + t0) * row_stride + (size_t)hk * D;
    if constexpr (sizeof(TKV) == 1) {
      if (D % 16 == 0) load_tile<TKV, 16>(kbase, vbase, row_stride, tk, D, Ks, Vs);
      else load_tile<TKV, 8>(kbase, vbase, row_stride, tk, D, Ks, Vs);
    } else {
      load_tile<TKV, 16 / sizeof(TKV)>(kbase, vbase, row_stride, tk, D, Ks, Vs);
    }
    if (tid < tk) {
      const size_t si = (page * Hkv + hk) * ps + t0 + tid;
      ks_s[tid] = quant ? ks[si] : 1.f;
      vs_s[tid] = quant ? vs[si] : 1.f;
    }
    __syncthreads();

    // scores
    for (int e = tid; e < R * tk; e += THREADS) {
      const int r = e / tk, t = e % tk;
      const float* qr = Qs + r * D;
      const float* kr = Ks + t * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s = s * ks_s[t] * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int qpos = base + (r0 + r) / grp, kpos = pos0 + t;
      bool valid = kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      Ps[r * TK_MAX + t] = valid ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax statistics: one warp per row
    for (int r = warp; r < R; r += THREADS / 32) {
      const int qpos = base + (r0 + r) / grp;
      float* prow = Ps + r * TK_MAX;
      float mx = NEG_INF;
      for (int t = lane; t < tk; t += 32) mx = fmaxf(mx, prow[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tk; t += 32) {
        const int kpos = pos0 + t;
        bool valid = kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        const float pv = valid ? expf(prow[t] - m_new) : 0.f;
        sum += pv;
        prow[t] = pv * vs_s[t];  // v's dequant scale folded into the probabilities
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    for (int e = tid; e < R * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const float* prow = Ps + r * TK_MAX;
      float a = Acc[e] * a_s[r];
      for (int t = 0; t < tk; ++t) a = fmaf(prow[t], Vs[t * D + d], a);
      Acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < R * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int w = (r0 + r) / grp, g = (r0 + r) % grp;
    o[(((size_t)b * W + w) * Hq + hk * grp + g) * D + d] =
        from_f32<TQ>(Acc[e] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename TQ, typename TKV, int DC>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   void* o, const int* table, const int* lens, int B, int W, int Hq, int Hkv,
                   int D, int ps, int maxP, int lens_include_current, float scale, float softcap,
                   int window, cudaStream_t st) {
  const int R = W * (Hq / Hkv);
  const int rc = chunk_rows(R, D);
  const size_t smem = smem_bytes(rc, D);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_kernel<TQ, TKV, DC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(Hkv, B, (R + rc - 1) / rc);
  paged_kernel<TQ, TKV, DC><<<grid, THREADS, smem, st>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, ks, vs, (TQ*)o, table, lens, W, Hq, Hkv, D, ps,
      maxP, rc, lens_include_current, scale, softcap, window);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, void* o, const int* table, const int* lens, int B, int W,
                   int Hq, int Hkv, int ps, int maxP, int incl, float scale, float softcap,
                   int window, cudaStream_t st) {
  if (D == 128)
    return launch<TQ, TKV, 128>(q, k, v, ks, vs, o, table, lens, B, W, Hq, Hkv, D, ps, maxP, incl,
                                scale, softcap, window, st);
  if (D == 64)
    return launch<TQ, TKV, 64>(q, k, v, ks, vs, o, table, lens, B, W, Hq, Hkv, D, ps, maxP, incl,
                               scale, softcap, window, st);
  return launch<TQ, TKV, 0>(q, k, v, ks, vs, o, table, lens, B, W, Hq, Hkv, D, ps, maxP, incl,
                            scale, softcap, window, st);
}

template <typename TQ>
cudaError_t by_pool(int kv_kind, int D, const void* q, const void* k, const void* v,
                    const float* ks, const float* vs, void* o, const int* table, const int* lens,
                    int B, int W, int Hq, int Hkv, int ps, int maxP, int incl, float scale,
                    float softcap, int window, cudaStream_t st) {
  switch (kv_kind) {
    case 0:
      return by_dim<TQ, float>(D, q, k, v, nullptr, nullptr, o, table, lens, B, W, Hq, Hkv, ps,
                               maxP, incl, scale, softcap, window, st);
    case 1:
      return by_dim<TQ, bf16>(D, q, k, v, nullptr, nullptr, o, table, lens, B, W, Hq, Hkv, ps,
                              maxP, incl, scale, softcap, window, st);
    case 2:
      return by_dim<TQ, int8_t>(D, q, k, v, ks, vs, o, table, lens, B, W, Hq, Hkv, ps, maxP,
                                incl, scale, softcap, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             void* o, const void* table, const void* lens, int q_is_bf16, int kv_kind, int B,
             int W, int Hq, int Hkv, int D, int ps, int maxP, int incl, float scale,
             float softcap, int window, void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 8 || D > 256 || D % 8 != 0 || maxP < 1 ||
      ps < 8 || ps % 8 != 0 || (ps > TK_MAX && ps % TK_MAX != 0) || (kv_kind == 2 && !ks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ksf = (const float*)ks;
  const float* vsf = (const float*)vs;
  const int* tb = (const int*)table;
  const int* ln = (const int*)lens;
  cudaError_t err =
      q_is_bf16 ? by_pool<bf16>(kv_kind, D, q, k, v, ksf, vsf, o, tb, ln, B, W, Hq, Hkv, ps, maxP,
                                incl, scale, softcap, window, st)
                : by_pool<float>(kv_kind, D, q, k, v, ksf, vsf, o, tb, ln, B, W, Hq, Hkv, ps,
                                 maxP, incl, scale, softcap, window, st);
  return (int)err;
}

}  // namespace

// K4. q/o [B, Hq, D]; k/v one layer's pool [P, ps, Hkv, D]; lens include the
// current token. kv_kind 0 f32, 1 bf16, 2 int8 (then ks/vs [P, Hkv, ps] f32,
// else null). softcap <= 0 and window <= 0 mean none. Returns the first CUDA
// error (0 on success).
extern "C" int paro_paged_decode_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, void* o,
                                           const void* table, const void* lens, int q_is_bf16,
                                           int kv_kind, int B, int Hq, int Hkv, int D, int ps,
                                           int maxP, float scale, float softcap, int window,
                                           void* stream) {
  return dispatch(q, k, v, ks, vs, o, table, lens, q_is_bf16, kv_kind, B, 1, Hq, Hkv, D, ps,
                  maxP, 1, scale, softcap, window, stream);
}

// K5. q/o [B, W, Hq, D]; lens exclude the window (query w sits at lens[b] + w).
extern "C" int paro_paged_window_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, void* o,
                                           const void* table, const void* lens, int q_is_bf16,
                                           int kv_kind, int B, int W, int Hq, int Hkv, int D,
                                           int ps, int maxP, float scale, float softcap,
                                           int window, void* stream) {
  return dispatch(q, k, v, ks, vs, o, table, lens, q_is_bf16, kv_kind, B, W, Hq, Hkv, D, ps,
                  maxP, 0, scale, softcap, window, stream);
}
