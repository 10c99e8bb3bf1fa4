// Flash prefill attention for Hopper (sm_90a).
//
// Replaces paroquant_tpu/kernels/attention.py::flash_attention (_flash_kernel).
// q [B, Hq, T, D], k/v [B, Hkv, S, D] (head-major, the KV cache layout),
// kv_lens [B] and q_offset [B] int32 read from device memory, so one build
// serves every chunk offset. Query row t of batch b sits at absolute position
// q_offset[b] + t; key s is valid when s < kv_lens[b], s <= that position
// (causal) and s > position - window (sliding window, when window > 0).
// Scores are scaled, optionally tanh-softcapped, and reduced with an online
// softmax in f32; the PV product is f32 too, as in the TPU kernel. GQA maps
// query head h to kv head h / (Hq / Hkv). A row with no valid key returns 0.
//
// One block per (q tile of 64 rows, head, batch), 256 threads. Key tiles of
// 64 rows that are dead by the causal rule, the window or kv_lens are never
// loaded: skipping a fully masked tile leaves the online softmax unchanged.
// Bound on this card: at T = 512 the score and PV products (operations);
// this first kernel runs them on the f32 SIMT units, not the tensor cores.

#include "common.cuh"

using paro::bf16;
using paro::from_f32;
using paro::to_f32;

namespace {

constexpr int TQ = 64;
constexpr int TK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (TQ * (D + 1) + TK * (D + 1) + TK * D + TQ * (TK + 1) + 3 * TQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const int* __restrict__ kv_lens, const int* __restrict__ q_off,
    int Hq, int Hkv, int T_, int S_, float scale, float softcap, int window, int causal) {
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
  const T* kp = k + ((size_t)b * Hkv + hk) * (size_t)S_ * D;
  const T* vp = v + ((size_t)b * Hkv + hk) * (size_t)S_ * D;

  for (int e = tid; e < TQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qs[r * (D + 1) + d] = (q0 + r < T_) ? to_f32(qp[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  if (tid < TQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

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

    // acc = acc * alpha + P @ V: rows ty*4 + i, dims tx + 16*c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (TK + 1) + j];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
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
    for (int c = 0; c < D / 16; ++c)
      op[(size_t)(q0 + r) * D + tx + 16 * c] = from_f32<T>(acc[i][c] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_lens,
                   const int* q_off, int B, int Hq, int Hkv, int T_, int S_, float scale,
                   float softcap, int window, int causal, cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + TQ - 1) / TQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                                  kv_lens, q_off, Hq, Hkv, T_, S_, scale,
                                                  softcap, window, causal);
  return cudaGetLastError();
}

}  // namespace

// q/o [B, Hq, T, D], k/v [B, Hkv, S, D], contiguous, all f32 or all bf16;
// kv_lens and q_off int32 [B] on the device. D is 64 or 128. softcap <= 0 and
// window <= 0 mean none. Returns the first CUDA error (0 on success).
extern "C" int paro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    const void* kv_lens, const void* q_off, int is_bf16, int B,
                                    int Hq, int Hkv, int T_, int S_, int D, float scale,
                                    float softcap, int window, int causal, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || B < 1 || T_ < 1 || S_ < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* kl = (const int*)kv_lens;
  const int* qo = (const int*)q_off;
  cudaError_t err;
  if (D == 128 && is_bf16)
    err = launch<bf16, 128>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, scale, softcap, window, causal, st);
  else if (D == 128)
    err = launch<float, 128>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, scale, softcap, window, causal, st);
  else if (D == 64 && is_bf16)
    err = launch<bf16, 64>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, scale, softcap, window, causal, st);
  else if (D == 64)
    err = launch<float, 64>(q, k, v, o, kl, qo, B, Hq, Hkv, T_, S_, scale, softcap, window, causal, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
