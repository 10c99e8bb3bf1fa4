// Paged decode (K4) and paged speculative-verify (K5) attention for Hopper (sm_90a).
//
// Replaces paroquant_tpu/kernels/attention.py::paged_decode_attention
// (_paged_decode_kernel) and ::paged_window_attention_kernel
// (_paged_window_kernel). Both launchers share one design: K4 is the W = 1
// case whose lengths include the current token, K5 takes a window of W
// queries per slot whose lengths exclude the window.
//
// q [B, W, Hq, D] (K4: [B, Hq, D]); pools k/v [P, ps, Hkv, D] of f32, bf16
// or int8, with per-(token, head) dequant scales ks/vs [P, Hkv, ps] f32 (the
// page size last, as the JAX pool keeps them) when int8; page_table [B, maxP]
// and lens [B] int32 in device memory. Query row r = w * grp + g of kv head
// hk is head hk * grp + g at absolute position base + w, where base =
// lens[b] - 1 (K4) or lens[b] (K5). Key position s is valid when s <= that
// position and, with a sliding window, s > position - window. Scores are
// (q . k) * ks * scale, tanh-softcapped before the mask, reduced with an
// online softmax in f32; vs multiplies the probabilities before the PV
// product, as in the TPU kernel. The output is acc / max(l, 1e-30) in q's
// dtype, so a row with no valid key (K4 with lens[b] == 0) gives 0.
//
// Split over pages (flash-decoding). The grid is (splits, Hkv * chunks, B):
// block (s, hk + Hkv * chunk, b) reads lens[b] (and, beside it, the page ids
// of its first two tiles) and takes the key positions [s * pps * ps,
// (s + 1) * pps * ps) that lie in the slot's range: below min(base + W,
// maxP * ps) (the live pages, the TPU kernel's index-map clamp) and not
// wholly before a sliding window. `splits` and `pps` (pages per split) come
// from the wrapper's `paged_split`, from host-known shapes only (never lens
// or the table, so the decode step makes no host sync and can be captured in
// a CUDA graph): the most pages a split that still give the grid eight
// blocks per SM of the 132, at least 64 keys a split, at most 32 splits. At
// Qwen3-0.6B's engine shape (B 8, Hkv 8, maxP 16 pages of 128) that is 16
// splits of one page, 1024 blocks; at its decode step (maxP 3) 3 splits.
// Each block knows from lens which splits hold keys (a contiguous run s0 +
// [0, live)). A block outside it reads no K/V row and exits (block 0 writes
// the zeros of a slot with no key). With one live split that block writes
// the output itself. Otherwise each live block writes f32 partials to a
// workspace the wrapper allocates, (m, l) per query row and split, then acc
// per row, split and d: B * Hkv * R * splits * (D + 2) * 4 bytes (at
// Qwen3-0.6B's engine shape 1.1 MB for K4, 5.3 MB for K5 at W 5), and
// counts itself in on a counter of its (slot, kv head, chunk); the last
// to arrive merges the live splits in split order: m* = max m_s, w_s =
// e^(m_s - m*) (0 where the row had no key in split s), l* = sum w_s l_s,
// o = sum w_s acc_s / max(l*, 1e-30), rounded to q's dtype, and resets the
// counter to 0. One launch per call, no atomics on data: the same inputs give
// the same bits whichever block arrives last.
//
// Tiles. K/V rows of one (token, kv head) are D-element runs at a row stride
// of Hkv * D; a block copies tiles of key rows into a two-stage ring in
// shared memory, in their storage type, with cp.async: 16-byte pieces
// (8-byte for an int8 pool whose D is not a multiple of 16), the scales 4
// bytes a key, THREADS / tk threads a key row with one page-table read
// each. Both stages are in flight before the first is scored, the next
// tile's copy while the current one is. Key rows at or past the range's end
// (in the last live page, or in a page past it) are zero-filled, never read.
// bf16 rows whose width is a multiple of 128 bytes are XOR-swizzled in
// 16-byte pieces, others padded by 16 bytes, so that the 8 rows a fragment
// load or an ldmatrix reads hit distinct banks.
//
// Tensor cores for a bf16 query over a bf16 or int8 pool: QK and PV are
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (HMMA). Query rows are padded to 16
// (K4 at Qwen3-0.6B has R = 2 rows per kv head, K5 R = 10), D to a multiple
// of 16 with zeros. Tiles are 64 keys. Warp w takes m-tile w % MT of the
// block's MT (1, 2 or 4) and a quarter, half or all of each tile's keys,
// flash-attention style: its scores, mask, online softmax (m, l across the
// 4 lanes of a row) and P stay in registers, the score accumulators turn
// into P's A fragments, and its O accumulators (all of D) stay in registers
// across tiles; B fragments come straight from the K tile (int8 values
// -127..127 convert to bf16 exactly) and from V through ldmatrix.x4.trans
// (int8 converted by hand). At the end a warp that holds whole rows (MT 4)
// writes them from registers; otherwise the warps of one m-tile merge their
// key groups in order through shared memory. ks scales the score columns
// and vs is folded into P, as above. P goes to the PV product rounded to
// bf16: a relative error of at most 2^-9 per probability against l summed in
// f32, so an output row is off by at most 2^-9 of sum p |v| / l, about 2e-3
// of the row's own scale where the probabilities weigh rows of one sign;
// random rows land near 1e-3 (the K4/K5 rows and edges of chip_smoke stay
// at or below 0.0078 of their row's scale, the same as the f32 SIMT kernel
// this replaces: the bf16 output's own rounding), under the per-row
// TOL_KERNEL of 2e-2. An f32 query, or an f32 pool, runs the same split,
// ring and merge with the arithmetic on the SIMT units in f32 (no TF32):
// query rows, scores and accumulators in f32 shared memory, tiles of 8-64
// keys.
//
// Rows: a block holds at most 64 query rows of its kv head; R = W * grp is
// split into the fewest chunks that fit the 232,448 B of shared memory
// (`plan`), each chunk walking the slot's keys itself. On the tensor-core
// path 64 rows fit at every D up to 256.
//
// Bound on the H100: bytes. Each live K/V row of the slot's kv head is read
// once (plus its two f32 scales with int8); the arithmetic, 4 * R * D
// operations per key row, is far below the memory line (at K5's 64 rows and
// D 128, 32,768 operations per 512 bytes of K/V: 64 a byte, where the bf16
// tensor cores become the limit at 295). At Qwen3-0.6B's engine shape (8
// slots, lengths 1-2047, bf16 pool) the bound is 5.9 us for K4 and 6.0 us
// for K5; the kernel takes 5-6 times that, bound by latency: a block's
// chain of dependent steps (lens, page ids, the tiles, the scores, the
// partial, the counter, the merge) each waiting on memory, with most of
// the 1024 blocks empty. Left for later: TMA bulk copies with mbarriers in
// place of cp.async, wgmma, and a persistent grid that walks only the live
// splits and merges them without the counter.

#include <type_traits>

#include "common.cuh"

using namespace paro;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TK_MMA = 64;     // key rows per tile on the tensor-core path
constexpr int MAX_ROWS = 64;   // query rows per block (per chunk)
constexpr int MAX_SPLITS = 32;  // splits the last block merges (paged_split keeps to it)
constexpr int STAGES = 2;      // the cp.async ring: both stages in flight from the start
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block can use on the H100
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // null unless the pool is int8
  const float* vs;
  void* o;
  float* ws;      // partials when splits > 1: (m, l) [B * Hkv * R][splits], then acc [..][splits][D]
  int* counters;  // when splits > 1: one per (b, hk, chunk), 0 between calls
  const int* table;
  const int* lens;
  int B, W, Hq, Hkv, D, ps, maxP, incl, window;
  float scale, softcap;
  int grp, R;       // query rows per kv head: W * grp
  int rc, tk;       // query rows per chunk, key rows per tile
  int splits, pps;  // page splits and pages per split
  int piece;        // cp.async piece: 16 bytes, 8 for an int8 row whose D is not a multiple of 16
};

// byte offsets of one block's shared memory
struct Layout {
  int dp;      // D, padded to a multiple of 16 on the tensor-core path
  bool swz;    // bf16 K/V rows swizzled (16-byte piece c of row j at c ^ (j & 7)), else padded
  int kv_row;  // bytes of one K/V row in shared memory: dp elements, + 16 when not swizzled
  int rows;    // query rows held: rc, padded to 16 on the tensor-core path
  size_t k, v, ks, vs, q, s, acc, m, l, a, w, total;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = (off + bytes + 15) / 16 * 16;
  return at;
}

// The K/V ring and its scales; then, on the tensor-core path, bf16 Q
// [rows][dp + 8] (scores, P, the softmax state and the accumulators live in
// registers), else f32 Q [rc][D], scores / P [rc][tk], Acc [rc][D] and the
// online-softmax state m, l, alpha [rc]; the merge's weights
// [rows][MAX_SPLITS] and denominators [rows]. After the last tile the ring
// holds the tensor-core path's per-warp results.
__host__ __device__ inline Layout make_layout(bool mma, int elem_kv, int rc, int D, int tk) {
  Layout L;
  L.dp = mma ? (D + 15) / 16 * 16 : D;
  L.swz = mma && elem_kv == 2 && L.dp * 2 % 128 == 0;  // int8 rows keep their padding
  L.kv_row = L.dp * elem_kv + (L.swz ? 0 : 16);
  L.rows = mma ? (rc + 15) / 16 * 16 : rc;
  size_t off = 0;
  L.k = take(off, (size_t)STAGES * tk * L.kv_row);
  L.v = take(off, (size_t)STAGES * tk * L.kv_row);
  L.ks = take(off, (size_t)STAGES * tk * 4);
  L.vs = take(off, (size_t)STAGES * tk * 4);
  if (mma) {
    L.q = take(off, (size_t)L.rows * (L.dp + 8) * 2);
    L.s = L.acc = L.m = L.l = L.a = 0;
  } else {
    L.q = take(off, (size_t)L.rows * D * 4);
    L.s = take(off, (size_t)L.rows * tk * 4);
    L.acc = take(off, (size_t)L.rows * D * 4);
    L.m = take(off, (size_t)L.rows * 4);
    L.l = take(off, (size_t)L.rows * 4);
    L.a = take(off, (size_t)L.rows * 4);
  }
  L.w = take(off, (size_t)L.rows * (MAX_SPLITS + 1) * 4);
  L.total = off;
  return L;
}

// (rows per chunk, key rows per tile): the fewest chunks of at most
// MAX_ROWS rows that fit shared memory, balanced, then the largest tile
bool plan(bool mma, int elem_kv, int R, int D, int* rc, int* tk) {
  int best = 0;
  for (int t = mma ? TK_MMA : 64; t >= (mma ? TK_MMA : 8); t /= 2) {
    int cap = MAX_ROWS;
    while (cap > 0 && make_layout(mma, elem_kv, cap, D, t).total > SMEM_LIMIT) --cap;
    if (cap == 0) continue;
    const int n = (R + cap - 1) / cap;
    if (best == 0 || n < best) {
      best = n;
      *rc = (R + n - 1) / n;
      *tk = t;
    }
  }
  return best > 0;
}

template <typename TQ, typename TKV>
__host__ __device__ constexpr bool use_mma() {
  return std::is_same<TQ, bf16>::value && !std::is_same<TKV, float>::value;
}

// two consecutive elements of a shared K/V row, at x, as a bf16 pair
template <typename TKV>
__device__ __forceinline__ uint32_t pair_bf16(const unsigned char* x);
template <>
__device__ __forceinline__ uint32_t pair_bf16<bf16>(const unsigned char* x) {
  return *reinterpret_cast<const uint32_t*>(x);
}
template <>
__device__ __forceinline__ uint32_t pair_bf16<int8_t>(const unsigned char* x) {
  const char2 c = *reinterpret_cast<const char2*>(x);
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)c.x, (float)c.y);  // exact for |c| <= 256
  return *reinterpret_cast<const uint32_t*>(&h);
}

// byte `x` of K/V row `row` in shared memory: with a swizzle, 16-byte piece
// c of row j lies at piece c ^ (j & 7), so that the 8 rows a fragment load
// or an ldmatrix reads hit distinct banks without padding the rows
__device__ __forceinline__ int sw(const Layout& L, int row, int x) {
  return L.swz ? ((((x >> 4) ^ (row & 7)) << 4) | (x & 15)) : x;
}

// Every live split of a (slot, kv head, chunk), s0 + [0, S), has written its
// partial: the last block to arrive merges them in split order and resets
// the counter. The same partials give the same bits whichever block is last.
template <typename TQ>
__device__ void arrive_and_merge(const Params& p, const Layout& L, unsigned char* smem,
                                 size_t row0, int R, int b, int hk, int r0, int s0, int S) {
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, D = p.D;
  __threadfence();  // this thread's partials, before the block's arrival
  __syncthreads();
  if (tid == 0) {
    int* c = p.counters + ((size_t)b * p.Hkv + hk) * (gridDim.y / p.Hkv) + blockIdx.y / p.Hkv;
    last = atomicAdd(c, 1) == S - 1;
    if (last) *c = 0;  // every block has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int stride = p.splits;  // the workspace's splits per row
  const float2* ml = reinterpret_cast<const float2*>(p.ws) + s0;
  const float* acc = p.ws + (size_t)2 * p.B * p.Hkv * p.R * stride + (size_t)s0 * D;
  float* wts = reinterpret_cast<float*>(smem + L.w);  // [R][S] weights, then [R] denominators
  float* den = wts + L.rows * MAX_SPLITS;
  for (int r = warp; r < R; r += WARPS) {
    const float2 x = lane < S ? __ldcg(ml + (row0 + r) * stride + lane) : make_float2(NEG_INF, 0.f);
    float mx = x.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = x.y > 0.f ? expf(x.x - mx) : 0.f;  // a split with no valid key of the row weighs 0
    float l = 0.f;
    for (int s = 0; s < S; ++s) l = fmaf(__shfl_sync(0xffffffffu, w, s), __shfl_sync(0xffffffffu, x.y, s), l);
    if (lane < S) wts[r * MAX_SPLITS + lane] = w;
    if (lane == 0) den[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.o);
  for (int e = tid; e < R * (D / 4); e += THREADS) {
    const int r = e / (D / 4), d = (e % (D / 4)) * 4;
    // split s of this row's 4 columns; every live split wrote them (0 where a row had no key)
    const float4* src = reinterpret_cast<const float4*>(acc + (row0 + r) * stride * D + d);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s8 = 0; s8 < S; s8 += 8) {  // 8 loads in flight, the sum in split order
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s8 + j < S) v[j] = __ldcg(src + (size_t)(s8 + j) * (D / 4));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s8 + j < S) {
          const float w = wts[r * MAX_SPLITS + s8 + j];
          a = make_float4(fmaf(w, v[j].x, a.x), fmaf(w, v[j].y, a.y), fmaf(w, v[j].z, a.z),
                          fmaf(w, v[j].w, a.w));
        }
    }
    const int rr = r0 + r, wq = rr / p.grp, g = rr % p.grp;
    TQ* o = out + (((size_t)b * p.W + wq) * p.Hq + hk * p.grp + g) * D + d;
    o[0] = from_f32<TQ>(a.x / den[r]);
    o[1] = from_f32<TQ>(a.y / den[r]);
    o[2] = from_f32<TQ>(a.z / den[r]);
    o[3] = from_f32<TQ>(a.w / den[r]);
  }
}

// MT: m-tiles of 16 query rows per block (1, 2 or 4) and DB: D's bucket (64,
// 128, 256) on the tensor-core path; both 0 on the SIMT path
template <typename TQ, typename TKV, int MT, int DB>
__device__ __forceinline__ void paged_block(const Params& p) {
  constexpr bool MMA = use_mma<TQ, TKV>();
  static_assert(!MMA || (MT > 0 && DB > 0), "tensor-core tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, hk = blockIdx.y % p.Hkv, chunk = blockIdx.y / p.Hkv, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, tk = p.tk, grp = p.grp, ps = p.ps;
  const int r0 = chunk * p.rc;
  const int R = min(p.rc, p.R - r0);  // this block's query rows: r0 + [0, R)
  const Layout L = make_layout(MMA, sizeof(TKV), p.rc, D, tk);
  const bool quant = p.ks != nullptr;
  // the page ids of the first STAGES tiles when the range starts at the
  // split's first key (no window cut), read beside lens
  const int tpr = THREADS / tk, k_split = s * p.pps * ps;
  int page_hint[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i)
    page_hint[i] = p.table[(size_t)b * p.maxP + min((k_split + i * tk + tid / tpr) / ps, p.maxP - 1)];
  const int base = p.incl ? p.lens[b] - 1 : p.lens[b];
  const int n_keys = min(base + p.W, p.maxP * ps);  // positions [0, n_keys) can be valid
  const int lo = p.window > 0 ? max(base - p.window + 1, 0) : 0;  // the earliest row's window
  const int k_begin = max(k_split, lo);
  const int k_end = min((s + 1) * p.pps * ps, n_keys);
  // the splits that hold a key of the slot's range [lo, n_keys): s0 + [0, live)
  const int span = p.pps * ps, s0 = lo / span, live = lo < n_keys ? (n_keys - 1) / span - s0 + 1 : 0;
  const bool direct = live <= 1;  // one split holds every key: it writes the output
  const size_t row0 = ((size_t)b * p.Hkv + hk) * p.R + r0;  // workspace row of query row 0
  float2* ws_ml = reinterpret_cast<float2*>(p.ws);
  float* ws_acc = p.ws + (size_t)2 * p.B * p.Hkv * p.R * p.splits;
  TQ* out = static_cast<TQ*>(p.o);
  // element d of query row r's output, or of its partial for this split
  auto o_at = [&](int r, int d) -> TQ* {
    const int rr = r0 + r, w = rr / grp, g = rr % grp;
    return out + (((size_t)b * p.W + w) * p.Hq + hk * grp + g) * D + d;
  };
  auto ws_at = [&](int r, int d) { return ws_acc + ((row0 + r) * p.splits + s) * D + d; };

  if (k_begin >= k_end) {  // nothing of this slot in range: read no K/V row
    if (live == 0 && s == 0)  // no split has a key: the output is 0
      for (int e = tid; e < R * D; e += THREADS) *o_at(e / D, e % D) = from_f32<TQ>(0.f);
    return;
  }

  // cp.async of tile i (key positions k_begin + i * tk + [0, tk)) into stage
  // i % STAGES: THREADS / tk threads a key row, one page-table read each;
  // rows at or past k_end are zero-filled and not read
  const size_t row_stride = (size_t)p.Hkv * D;
  const int pieces = D * (int)sizeof(TKV) / p.piece;
  const int n_tiles = (k_end - k_begin + tk - 1) / tk;
  auto issue = [&](int i, int hint) {
    const int st = i % STAGES, j = tid / tpr, sub = tid % tpr, pos = k_begin + i * tk + j;
    const bool in = pos < k_end;
    size_t row = 0, si = 0;
    if (in) {
      const size_t page = hint >= 0 ? hint : p.table[(size_t)b * p.maxP + pos / ps];
      row = ((page * ps + pos % ps) * row_stride + (size_t)hk * D) * sizeof(TKV);
      si = (page * p.Hkv + hk) * ps + pos % ps;
    }
    const unsigned char* ksrc = static_cast<const unsigned char*>(p.k) + row;
    const unsigned char* vsrc = static_cast<const unsigned char*>(p.v) + row;
    unsigned char* kt = smem + L.k + ((size_t)st * tk + j) * L.kv_row;
    unsigned char* vt = smem + L.v + ((size_t)st * tk + j) * L.kv_row;
    for (int c = sub; c < pieces; c += tpr) {
      const int off = c * p.piece;
      if (p.piece == 16) {
        cp_async16(kt + sw(L, j, off), ksrc + off, in ? 16 : 0);
        cp_async16(vt + sw(L, j, off), vsrc + off, in ? 16 : 0);
      } else {
        cp_async8(kt + sw(L, j, off), ksrc + off, in ? 8 : 0);
        cp_async8(vt + sw(L, j, off), vsrc + off, in ? 8 : 0);
      }
    }
    if (quant && sub == 0) {
      cp_async4(smem + L.ks + ((size_t)st * tk + j) * 4, p.ks + si, in ? 4 : 0);
      cp_async4(smem + L.vs + ((size_t)st * tk + j) * 4, p.vs + si, in ? 4 : 0);
    }
  };
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_tiles) issue(i, k_begin == k_split ? page_hint[i] : -1);
    cp_async_commit();
  }

  const TQ* q = static_cast<const TQ*>(p.q);
  auto q_off = [&](int r) {
    const int rr = r0 + r, w = rr / grp, g = rr % grp;
    return (((size_t)b * p.W + w) * p.Hq + hk * grp + g) * D;
  };
  // key position pos is valid for a query row at absolute position qp
  auto valid = [&](int qp, int pos) {
    return pos < k_end && pos <= qp && (p.window <= 0 || pos > qp - p.window);
  };

  if constexpr (MMA) {
    // warp w: m-tile w % MT, keys [kw * (w / MT), kw * (w / MT + 1)) of each tile
    constexpr int KG = WARPS / MT, KW = TK_MMA / KG, NJ = KW / 8, NT = DB / 8;
    const int g = lane >> 2, t4 = lane & 3, mt = warp % MT, kbase = (warp / MT) * KW;
    const int q_stride = L.dp + 8;
    bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
    for (int e = tid; e < L.rows * (L.dp / 8); e += THREADS) {  // 16-byte pieces, zero padded
      const int r = e / (L.dp / 8), d = (e % (L.dp / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < R && d < D) v = *reinterpret_cast<const uint4*>(q + q_off(r) + d);
      *reinterpret_cast<uint4*>(Qs + r * q_stride + d) = v;
    }
    if (L.dp > D) {  // the zero columns [D, dp) of every K/V row of the ring
      for (int e = tid; e < 2 * STAGES * tk; e += THREADS) {
        const int j = e % (STAGES * tk);  // the ring's row; its row within a tile is j % tk
        unsigned char* row = smem + (e < STAGES * tk ? L.k : L.v) + j * L.kv_row;
        for (int c = D * (int)sizeof(TKV); c < L.dp * (int)sizeof(TKV); ++c) row[sw(L, j % tk, c)] = 0;
      }
    }
    // absolute positions of this lane's two rows, mt * 16 + g and + 8
    int qp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) qp[h] = base + (r0 + min(mt * 16 + g + 8 * h, R - 1)) / grp;
    float o[NT][4], m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    const bf16* qa = Qs + (mt * 16 + g) * q_stride + 2 * t4;

    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<STAGES - 1>();  // tile i has landed
      __syncthreads();              // ... for every thread
      const int st = i % STAGES, key0 = k_begin + i * tk, nk = min(tk, k_end - key0);
      const unsigned char* Kt = smem + L.k + (size_t)st * tk * L.kv_row;
      const unsigned char* Vt = smem + L.v + (size_t)st * tk * L.kv_row;
      const float* ksc = reinterpret_cast<const float*>(smem + L.ks) + st * tk;
      const float* vsc = reinterpret_cast<const float*>(smem + L.vs) + st * tk;
      if (kbase < nk && mt * 16 < R) {
        // S = Q K^T on this warp's rows and keys, in registers
        float sc[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DB; kk += 16) {
          if (kk >= L.dp) break;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa + kk);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * q_stride + kk);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + kk + 8);
          const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * q_stride + kk + 8);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int key = kbase + j * 8 + g;
            const unsigned char* kr = Kt + key * L.kv_row;
            constexpr int E = sizeof(TKV);
            mma_bf16(sc[j], a0, a1, a2, a3, pair_bf16<TKV>(kr + sw(L, key, (kk + 2 * t4) * E)),
                     pair_bf16<TKV>(kr + sw(L, key, (kk + 8 + 2 * t4) * E)));
          }
        }
        // scale, softcap, mask; the online softmax of rows g and g + 8 across the quad
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = kbase + j * 8 + 2 * t4 + (e & 1), h = e >> 1;
            float x = sc[j][e] * (quant ? ksc[t] : 1.f) * p.scale;
            if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
            x = valid(qp[h], key0 + t) ? x : NEG_INF;
            sc[j][e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m_r[h], mx[h]);
          alpha[h] = expf(m_r[h] - m_new);
          m_r[h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float pv = sc[j][e] > NEG_INF ? expf(sc[j][e] - m_r[h]) : 0.f;
            sum[h] += pv;
            // v's dequant scale folded into P
            sc[j][e] = quant ? pv * vsc[kbase + j * 8 + 2 * t4 + (e & 1)] : pv;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l_r[h] = alpha[h] * l_r[h] + sum[h];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
        // O += P V: the score accumulators are P's A fragments, rounded to bf16
#pragma unroll
        for (int ks = 0; ks < NJ / 2; ++ks) {
          const uint32_t a0 = pack_bf16(sc[2 * ks][0], sc[2 * ks][1]);
          const uint32_t a1 = pack_bf16(sc[2 * ks][2], sc[2 * ks][3]);
          const uint32_t a2 = pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
          const uint32_t a3 = pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
          const int k0 = kbase + ks * 16;
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            if (n * 8 >= D) break;
            uint32_t bv[4];  // b0, b1 of n-tile n, then of n-tile n + 1
            if constexpr (std::is_same<TKV, bf16>::value) {
              // lane l: key k0 + 8 * ((l >> 3) & 1) + (l & 7), the columns of n-tile n + (l >> 4)
              const int key = k0 + ((lane >> 3) & 1) * 8 + (lane & 7);
              ldmatrix_x4_trans(bv, Vt + key * L.kv_row + sw(L, key, (n + (lane >> 4)) * 16));
            } else {
              // V[key][d] of keys k0 + 2 t4 + {0, 1, 8, 9}, d = 8 (n + h) + g
              auto v8 = [&](int key, int d) {
                return (float)(int8_t)Vt[key * L.kv_row + sw(L, key, d)];
              };
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k = k0 + 2 * t4, d = (n + h) * 8 + g;
                bv[2 * h] = pack_bf16(v8(k, d), v8(k + 1, d));
                bv[2 * h + 1] = pack_bf16(v8(k + 8, d), v8(k + 9, d));
              }
            }
            mma_bf16(o[n], a0, a1, a2, a3, bv[0], bv[1]);
            mma_bf16(o[n + 1], a0, a1, a2, a3, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // stage i % STAGES is free
      if (i + STAGES < n_tiles) issue(i + STAGES, -1);
      cp_async_commit();
    }
    cp_async_wait<0>();
    if constexpr (KG == 1) {
      // each warp holds whole rows: its results go out from registers
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= R) continue;
        const float den = fmaxf(l_r[h], 1e-30f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n * 8 >= D) break;
          const int d = n * 8 + 2 * t4;
          const float x = o[n][2 * h], y = o[n][2 * h + 1];
          if (direct)
            *reinterpret_cast<__nv_bfloat162*>(o_at(r, d)) =
                __floats2bfloat162_rn(x / den, y / den);
          else
            *reinterpret_cast<float2*>(ws_at(r, d)) = make_float2(x, y);
        }
        if (!direct && t4 == 0) ws_ml[(row0 + r) * p.splits + s] = make_float2(m_r[h], l_r[h]);
      }
    } else {
      __syncthreads();

      // each warp's (m, l, o) of its rows and keys into the ring, [warp][16][D + 2];
      // then row by row the KG key groups merged in order
      float* part = reinterpret_cast<float*>(smem + L.k);
      float* mine = part + (size_t)warp * 16 * (D + 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = mine + (g + 8 * h) * (D + 2);
        if (t4 == 0) {
          row[D] = m_r[h];
          row[D + 1] = l_r[h];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n * 8 >= D) break;
          row[n * 8 + 2 * t4] = o[n][2 * h];
          row[n * 8 + 2 * t4 + 1] = o[n][2 * h + 1];
        }
      }
      __syncthreads();
      for (int e = tid; e < R * D; e += THREADS) {
        const int r = e / D, d = e % D;
        const float* grp0 = part + (size_t)r * (D + 2);  // key group 0: warp r / 16
        const size_t gstride = (size_t)MT * 16 * (D + 2);  // the next key group of these rows
        float m = NEG_INF;
#pragma unroll
        for (int k = 0; k < KG; ++k) m = fmaxf(m, grp0[k * gstride + D]);
        float l = 0.f, a = 0.f;
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          const float* x = grp0 + k * gstride;
          const float w = expf(x[D] - m);
          l = fmaf(w, x[D + 1], l);
          a = fmaf(w, x[d], a);
        }
        if (direct) {
          *o_at(r, d) = from_f32<TQ>(a / fmaxf(l, 1e-30f));
        } else {
          *ws_at(r, d) = a;
          if (d == 0) ws_ml[(row0 + r) * p.splits + s] = make_float2(m, l);
        }
      }
    }
  } else {
    float* m_s = reinterpret_cast<float*>(smem + L.m);
    float* l_s = reinterpret_cast<float*>(smem + L.l);
    float* a_s = reinterpret_cast<float*>(smem + L.a);
    float* Qs = reinterpret_cast<float*>(smem + L.q);
    float* Ps = reinterpret_cast<float*>(smem + L.s);
    float* Acc = reinterpret_cast<float*>(smem + L.acc);
    for (int e = tid; e < R * D; e += THREADS) {
      Qs[e] = to_f32<TQ>(q[q_off(e / D) + e % D]);
      Acc[e] = 0.f;
    }
    for (int r = tid; r < R; r += THREADS) {
      m_s[r] = NEG_INF;
      l_s[r] = 0.f;
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      const int st = i % STAGES, key0 = k_begin + i * tk, nk = min(tk, k_end - key0);
      const unsigned char* Kt = smem + L.k + (size_t)st * tk * L.kv_row;
      const unsigned char* Vt = smem + L.v + (size_t)st * tk * L.kv_row;
      const float* ksc = reinterpret_cast<const float*>(smem + L.ks) + st * tk;
      const float* vsc = reinterpret_cast<const float*>(smem + L.vs) + st * tk;
      for (int e = tid; e < R * tk; e += THREADS) {
        const int r = e / tk, t = e % tk;
        if (t >= nk) continue;  // past the range: masked below
        const float* qr = Qs + r * D;
        const TKV* kr = reinterpret_cast<const TKV*>(Kt + t * L.kv_row);
        float x = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) x = fmaf(qr[d], to_f32<TKV>(kr[d]), x);
        x = x * (quant ? ksc[t] : 1.f) * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        Ps[r * tk + t] = x;
      }
      __syncthreads();
      // the online-softmax statistics, one warp per row; P (times vs) in place
      for (int r = warp; r < R; r += WARPS) {
        const int qp = base + (r0 + r) / grp;
        float mx = NEG_INF;
        for (int t = lane; t < tk; t += 32)
          if (valid(qp, key0 + t)) mx = fmaxf(mx, Ps[r * tk + t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r], m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < tk; t += 32) {
          const float pv = valid(qp, key0 + t) ? expf(Ps[r * tk + t] - m_new) : 0.f;
          sum += pv;
          Ps[r * tk + t] = quant ? pv * vsc[t] : pv;
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
      for (int e = tid; e < R * D; e += THREADS) {
        const int r = e / D, d = e % D;
        const float* prow = Ps + r * tk;
        float acc = Acc[e] * a_s[r];
        for (int t = 0; t < nk; ++t)
          acc = fmaf(prow[t], to_f32<TKV>(reinterpret_cast<const TKV*>(Vt + t * L.kv_row)[d]), acc);
        Acc[e] = acc;
      }
      __syncthreads();  // stage i % STAGES is free
      if (i + STAGES < n_tiles) issue(i + STAGES, -1);
      cp_async_commit();
    }
    cp_async_wait<0>();
    for (int e = tid; e < R * D; e += THREADS) {
      const int r = e / D, d = e % D;
      if (direct)
        *o_at(r, d) = from_f32<TQ>(Acc[e] / fmaxf(l_s[r], 1e-30f));
      else
        *ws_at(r, d) = Acc[e];
    }
    if (!direct)
      for (int r = tid; r < R; r += THREADS)
        ws_ml[(row0 + r) * p.splits + s] = make_float2(m_s[r], l_s[r]);
  }
  if (!direct) arrive_and_merge<TQ>(p, L, smem, row0, R, b, hk, r0, s0, live);
}

// the two paths under their own names, so that the SASS of each can be checked
template <typename TQ, typename TKV, int MT, int DB>
__global__ void __launch_bounds__(THREADS) paged_mma_kernel(const Params p) {
  paged_block<TQ, TKV, MT, DB>(p);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS) paged_simt_kernel(const Params p) {
  paged_block<TQ, TKV, 0, 0>(p);
}

template <typename K>
cudaError_t launch(K kernel, bool mma, int elem_kv, const Params& p, cudaStream_t st) {
  const size_t smem = make_layout(mma, elem_kv, p.rc, p.D, p.tk).total;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int chunks = (p.R + p.rc - 1) / p.rc;
  kernel<<<dim3(p.splits, p.Hkv * chunks, p.B), THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t by_tiling(const Params& p, cudaStream_t st) {
  constexpr int E = sizeof(TKV);
  if constexpr (use_mma<TQ, TKV>()) {
    const int mt = (p.rc + 15) / 16;
#define PAGED_MT(DB)                                                        \
  return mt == 1   ? launch(paged_mma_kernel<TQ, TKV, 1, DB>, true, E, p, st) \
         : mt == 2 ? launch(paged_mma_kernel<TQ, TKV, 2, DB>, true, E, p, st) \
                   : launch(paged_mma_kernel<TQ, TKV, 4, DB>, true, E, p, st)
    if (p.D <= 64) PAGED_MT(64);
    if (p.D <= 128) PAGED_MT(128);
    PAGED_MT(256);
#undef PAGED_MT
  } else {
    return launch(paged_simt_kernel<TQ, TKV>, false, E, p, st);
  }
}

template <typename TQ>
cudaError_t by_pool(int kv_kind, const Params& p, cudaStream_t st) {
  switch (kv_kind) {
    case 0: return by_tiling<TQ, float>(p, st);
    case 1: return by_tiling<TQ, bf16>(p, st);
    case 2: return by_tiling<TQ, int8_t>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

bool plan_for(int q_is_bf16, int kv_kind, int R, int D, int* rc, int* tk) {
  const bool mma = q_is_bf16 && kv_kind != 0;
  return plan(mma, kv_kind == 0 ? 4 : kv_kind == 1 ? 2 : 1, R, D, rc, tk);
}

int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             void* o, const void* table, const void* lens, int q_is_bf16, int kv_kind, int B,
             int W, int Hq, int Hkv, int D, int ps, int maxP, int incl, float scale,
             float softcap, int window, int splits, int pps, void* ws, void* counters,
             void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || Hq % Hkv != 0 || D < 8 || D > 256 || D % 8 != 0 || maxP < 1 ||
      ps < 8 || ps % 8 != 0 || (ps > 64 && ps % 64 != 0) || kv_kind < 0 || kv_kind > 2 ||
      (kv_kind == 2 && !ks) || splits < 1 || splits > MAX_SPLITS || pps < 1 ||
      (long long)splits * pps < maxP || (long long)(splits - 1) * pps >= maxP ||
      (splits > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.ks = kv_kind == 2 ? (const float*)ks : nullptr;
  p.vs = kv_kind == 2 ? (const float*)vs : nullptr;
  p.o = o; p.ws = (float*)ws; p.counters = (int*)counters;
  p.table = (const int*)table; p.lens = (const int*)lens;
  p.B = B; p.W = W; p.Hq = Hq; p.Hkv = Hkv; p.D = D; p.ps = ps; p.maxP = maxP; p.incl = incl;
  p.window = window; p.scale = scale; p.softcap = softcap;
  p.grp = Hq / Hkv; p.R = W * p.grp;
  p.splits = splits; p.pps = pps;
  p.piece = (kv_kind == 2 && D % 16 != 0) ? 8 : 16;
  if (!plan_for(q_is_bf16, kv_kind, p.R, D, &p.rc, &p.tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(q_is_bf16 ? by_pool<bf16>(kv_kind, p, st) : by_pool<float>(kv_kind, p, st));
}

}  // namespace

// Query rows per block for R = W * Hq / Hkv rows per kv head at head dim D
// (the wrapper's chunk count is ceil(R / this)); -1 where no tiling fits.
extern "C" int paro_paged_rows_per_chunk(int q_is_bf16, int kv_kind, int R, int D) {
  int rc = 0, tk = 0;
  if (R < 1 || D < 8 || D > 256 || D % 8 != 0 || kv_kind < 0 || kv_kind > 2) return -1;
  return plan_for(q_is_bf16, kv_kind, R, D, &rc, &tk) ? rc : -1;
}

// K4. q/o [B, Hq, D]; k/v one layer's pool [P, ps, Hkv, D]; lens include the
// current token. kv_kind 0 f32, 1 bf16, 2 int8 (then ks/vs [P, Hkv, ps] f32,
// else null). softcap <= 0 and window <= 0 mean none. splits x pps pages
// cover maxP (paged_split); with splits > 1, ws holds B * Hkv * R * splits *
// (D + 2) floats (R = Hq / Hkv rows per kv head) and counters B * Hkv *
// chunks ints that are 0, as the call leaves them. Returns the first CUDA
// error (0 on success).
extern "C" int paro_paged_decode_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, void* o,
                                           const void* table, const void* lens, int q_is_bf16,
                                           int kv_kind, int B, int Hq, int Hkv, int D, int ps,
                                           int maxP, float scale, float softcap, int window,
                                           int splits, int pps, void* ws, void* counters,
                                           void* stream) {
  return dispatch(q, k, v, ks, vs, o, table, lens, q_is_bf16, kv_kind, B, 1, Hq, Hkv, D, ps,
                  maxP, 1, scale, softcap, window, splits, pps, ws, counters, stream);
}

// K5. q/o [B, W, Hq, D]; lens exclude the window (query w sits at lens[b] + w);
// R = W * Hq / Hkv rows per kv head in the workspace.
extern "C" int paro_paged_window_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, void* o,
                                           const void* table, const void* lens, int q_is_bf16,
                                           int kv_kind, int B, int W, int Hq, int Hkv, int D,
                                           int ps, int maxP, float scale, float softcap,
                                           int window, int splits, int pps, void* ws,
                                           void* counters, void* stream) {
  return dispatch(q, k, v, ks, vs, o, table, lens, q_is_bf16, kv_kind, B, W, Hq, Hkv, D, ps,
                  maxP, 0, scale, softcap, window, splits, pps, ws, counters, stream);
}
