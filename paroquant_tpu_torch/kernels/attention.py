"""Attention kernels: flash prefill (K3) and paged decode / verify (K4, K5).

K3, `flash_attention` (csrc/flash_attention.cu), ports
`paroquant_tpu/kernels/attention.py::flash_attention`. Layouts follow the
JAX function: q [B, Hq, T, D], head-major k/v [B, Hkv, S, D], kv_lens [B]
int32, q_offset scalar or [B] int32 (absolute position of q[:, :, 0]).
Causal by absolute position, masked to k_pos < kv_lens[b], optional
sliding window and tanh softcap, GQA h -> h // (Hq // Hkv), f32 softmax and
f32 PV product, output in q.dtype. A query row with no valid key gives 0,
as the TPU kernel's does.

K4, `paged_decode_attention`, and K5, `paged_window_attention_kernel`
(csrc/paged_attention.cu), port the functions of the same names: one query
(K4) or a window of W queries (K5) per slot against one layer's paged pool
[P, ps, Hkv, D] (f32, bf16, or int8 with scales [P, Hkv, ps] f32), read
through page_table [B, maxP] int32. K4's seq_lens include the current
token; K5's exclude the window. A slot with no valid key (K4 with
seq_lens == 0, which the engine never passes) gives 0 in the kernel and in
the plain version alike.

CUDA tensors launch the kernel; CPU tensors run the plain version. Nothing
falls back: a failed build or launch raises, and a shape the kernel does not
take raises NotImplementedError. Each CUDA call adds one to
`launch_counts[name]`; `variant_counts` splits K4/K5 into float and int8
pools.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

NEG_INF = -1e30

launch_counts = {"flash_attention": 0, "paged_decode_attention": 0,
                 "paged_window_attention_kernel": 0}
# per-variant split of the paged kernels' counts: [float pool, int8 pool]
variant_counts = {"paged_decode_attention": [0, 0], "paged_window_attention_kernel": [0, 0]}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    for name in variant_counts:
        variant_counts[name] = [0, 0]


def _per_batch(v, B: int, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.tensor(v)
    return t.to(device=device, dtype=torch.int32).reshape(-1).expand(B).contiguous()


def flash_attention_plain(
    q, k, v, kv_lens, *, scale: float, q_offset=0, sliding_window: int | None = None,
    logit_softcap: float | None = None, causal: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: the same masked softmax in f32, all keys at once."""
    B, Hq, T, D = q.shape
    Hkv, S_ = k.shape[1], k.shape[2]
    grp = Hq // Hkv
    lens = _per_batch(kv_lens, B, q.device)
    qoff = _per_batch(q_offset, B, q.device)
    qf = q.to(torch.float32).reshape(B, Hkv, grp, T, D)
    scores = torch.einsum("bhgtd,bhsd->bhgts", qf, k.to(torch.float32)) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    q_pos = (qoff[:, None] + torch.arange(T, device=q.device)[None, :])[:, :, None]  # [B, T, 1]
    k_pos = torch.arange(S_, device=q.device)[None, None, :]
    valid = k_pos < lens[:, None, None]
    if causal:
        valid = valid & (k_pos <= q_pos)
    if sliding_window is not None:
        valid = valid & (k_pos > q_pos - sliding_window)
    valid = valid[:, None, None]  # [B, 1, 1, T, S]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l_sum = probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.to(torch.float32))
    out = out / torch.clamp(l_sum, min=1e-30)
    return out.reshape(B, Hq, T, D).to(q.dtype)


_fn = None


def _lib_fn():
    global _fn
    if _fn is None:
        fn = load("flash_attention").paro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(
    q, k, v, kv_lens, *, scale: float, q_offset=0, sliding_window: int | None = None,
    logit_softcap: float | None = None, causal: bool = True,
) -> torch.Tensor:
    """K3: q [B, Hq, T, D], k/v [B, Hkv, S, D] -> [B, Hq, T, D] in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, kv_lens, scale=scale, q_offset=q_offset,
            sliding_window=sliding_window, logit_softcap=logit_softcap, causal=causal,
        )
    B, Hq, T, D = q.shape
    Hkv, S_ = k.shape[1], k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"CUDA flash_attention supports head_dim 64 or 128, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share dtype float32 or bfloat16: {q.dtype} {k.dtype} {v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on the same device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = _per_batch(kv_lens, B, dev)
    qoff = _per_batch(q_offset, B, dev)
    out = torch.empty_like(q)
    err = _lib_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lens.data_ptr(),
        qoff.data_ptr(), int(q.dtype == torch.bfloat16), B, Hq, Hkv, T, S_, D,
        float(scale), float(logit_softcap or 0.0), int(sliding_window or 0), int(causal),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {err}")
    launch_counts["flash_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# Paged decode (K4) and paged window (K5) attention
# ---------------------------------------------------------------------------

PAGED_HEAD_DIMS = (64, 128)
PAGED_MAX_ROWS = 64  # W * (Hq // Hkv) query rows per (slot, kv head)


def dequant_pages(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """pages [..., ps, Hkv, D] int8 + scales [..., Hkv, ps] -> f32 pages."""
    return pages.to(torch.float32) * scales.transpose(-1, -2)[..., None]


def gather_pages(k_pool, v_pool, page_table, k_scales=None, v_scales=None):
    """One layer's pool [P, ps, Hkv, D] gathered through page_table [B, maxP]
    to [B, maxP, ps, Hkv, D]; an int8 pool is dequantized to f32."""
    table = page_table.to(torch.int64)
    k_pages, v_pages = k_pool[table], v_pool[table]
    if k_scales is not None:
        k_pages = dequant_pages(k_pages, k_scales[table])
        v_pages = dequant_pages(v_pages, v_scales[table])
    return k_pages, v_pages


def paged_attention(q, k_pages, v_pages, seq_lens, *, scale: float,
                    sliding_window: int | None = None, logit_softcap: float | None = None):
    """Einsum reference: q [B, Hq, D]; gathered pages [B, maxP, ps, Hkv, D];
    seq_lens [B] including the current token. Output f32."""
    B, Hq, D = q.shape
    _, maxP, ps, Hkv, _ = k_pages.shape
    S_ = maxP * ps
    k = k_pages.reshape(B, S_, Hkv, D).to(torch.float32)
    v = v_pages.reshape(B, S_, Hkv, D).to(torch.float32)
    qf = q.reshape(B, Hkv, Hq // Hkv, D).to(torch.float32)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    kv_pos = torch.arange(S_, device=q.device)[None, :]
    lens = seq_lens.to(torch.int64)[:, None]
    mask = kv_pos < lens
    if sliding_window is not None:
        mask = mask & (kv_pos > lens - 1 - sliding_window)
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v)
    return out.reshape(B, Hq, D)


def paged_window_attention(q, k_pages, v_pages, q_positions, *, scale: float,
                           sliding_window: int | None = None,
                           logit_softcap: float | None = None):
    """Einsum reference for W queries per slot: q [B, W, Hq, D]; causal by
    the absolute positions q_positions [B, W]. Output f32."""
    B, W, Hq, D = q.shape
    _, maxP, ps, Hkv, _ = k_pages.shape
    S_ = maxP * ps
    k = k_pages.reshape(B, S_, Hkv, D).to(torch.float32)
    v = v_pages.reshape(B, S_, Hkv, D).to(torch.float32)
    qf = q.reshape(B, W, Hkv, Hq // Hkv, D).to(torch.float32)
    scores = torch.einsum("bwhgd,bshd->bwhgs", qf, k) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    kv_pos = torch.arange(S_, device=q.device)[None, None, :]
    qp = q_positions.to(torch.int64)[:, :, None]
    mask = kv_pos <= qp
    if sliding_window is not None:
        mask = mask & (kv_pos > qp - sliding_window)
    scores = torch.where(mask[:, :, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwhgs,bshd->bwhgd", probs, v)
    return out.reshape(B, W, Hq, D)


def _paged_plain(q, k_pages, v_pages, page_table, base, *, scale, sliding_window,
                 logit_softcap, k_scales, v_scales):
    """q [B, W, Hq, D]; query w of slot b sits at position base[b] + w. The
    slot's pages are gathered and dequantized, the pages past its last live
    one zeroed, then the einsum reference runs."""
    W = q.shape[1]
    ps, maxP = k_pages.shape[1], page_table.shape[1]
    k, v = gather_pages(k_pages, v_pages, page_table, k_scales, v_scales)
    # pages past the slot's last live one are never read by the kernel:
    # whatever they hold (NaN included) must not reach the output here either
    base = base.to(torch.int64)
    n_pages = torch.clamp((base + W + ps - 1).div(ps, rounding_mode="floor"), 0, maxP)
    live = (torch.arange(maxP, device=q.device)[None, :] < n_pages[:, None])[:, :, None, None, None]
    k = torch.where(live, k, torch.zeros_like(k))
    v = torch.where(live, v, torch.zeros_like(v))
    positions = base[:, None] + torch.arange(W, device=q.device)
    return paged_window_attention(q, k, v, positions, scale=scale, sliding_window=sliding_window,
                                  logit_softcap=logit_softcap).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens, *, scale: float,
                                 sliding_window=None, logit_softcap=None, k_scales=None,
                                 v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of K4: gathers every page of the table and
    masks in f32. q [B, Hq, D], seq_lens [B] including the current token."""
    return _paged_plain(
        q[:, None], k_pages, v_pages, page_table, seq_lens.to(torch.int64) - 1, scale=scale,
        sliding_window=sliding_window, logit_softcap=logit_softcap, k_scales=k_scales,
        v_scales=v_scales)[:, 0]


def paged_window_attention_plain(q, k_pages, v_pages, page_table, seq_lens, *, scale: float,
                                 sliding_window=None, logit_softcap=None, k_scales=None,
                                 v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of K5: q [B, W, Hq, D], seq_lens [B] before the window."""
    return _paged_plain(
        q, k_pages, v_pages, page_table, seq_lens, scale=scale, sliding_window=sliding_window,
        logit_softcap=logit_softcap, k_scales=k_scales, v_scales=v_scales)


_paged_fns: dict = {}
_PAGED_SYMBOLS = {"paged_decode_attention": "paro_paged_decode_attention",
                  "paged_window_attention_kernel": "paro_paged_window_attention"}


def _paged_lib_fn(name: str):
    if name not in _paged_fns:
        fn = getattr(load("paged_attention"), _PAGED_SYMBOLS[name])
        n_int = 8 if name == "paged_decode_attention" else 9
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n_int + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _paged_fns[name] = fn
    return _paged_fns[name]


def _paged_launch(name, q4, k_pages, v_pages, page_table, seq_lens, scale, sliding_window,
                  logit_softcap, k_scales, v_scales):
    B, W, Hq, D = q4.shape
    P, ps, Hkv, D_kv = k_pages.shape
    maxP = page_table.shape[1]
    if D not in PAGED_HEAD_DIMS:
        raise NotImplementedError(f"the CUDA paged kernels take head_dim 64 or 128, not {D}")
    if ps < 8 or ps % 8 or (ps > 64 and ps % 64):
        raise NotImplementedError(
            f"the CUDA paged kernels take page sizes that are multiples of 8 up to 64, "
            f"then multiples of 64; not {ps}")
    if Hq % Hkv or W * (Hq // Hkv) > PAGED_MAX_ROWS:
        raise NotImplementedError(
            f"the CUDA paged kernels take at most {PAGED_MAX_ROWS} query rows per kv head, "
            f"not W={W} x {Hq // Hkv}")
    if D_kv != D or v_pages.shape != k_pages.shape or page_table.shape[0] != B:
        raise ValueError(f"shapes q {tuple(q4.shape)} pool {tuple(k_pages.shape)} "
                         f"v {tuple(v_pages.shape)} table {tuple(page_table.shape)}")
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q4.dtype}")
    quant = k_scales is not None
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    if k_pages.dtype not in kinds or v_pages.dtype != k_pages.dtype or quant != (k_pages.dtype == torch.int8):
        raise TypeError(f"pools must be float32, bfloat16, or int8 with scales; got "
                        f"{k_pages.dtype} {v_pages.dtype}, scales {'given' if quant else 'none'}")
    tensors = [q4, k_pages, v_pages, page_table, seq_lens] + ([k_scales, v_scales] if quant else [])
    if any(t.device != q4.device for t in tensors):
        raise ValueError("all operands must be on the same device")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if quant and (k_scales.shape != (P, Hkv, ps) or v_scales.shape != (P, Hkv, ps)
                  or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise TypeError(f"scales must be float32 [{P}, {Hkv}, {ps}]")
    q4, k_pages, v_pages, page_table, seq_lens = (
        t.contiguous() for t in (q4, k_pages, v_pages, page_table, seq_lens))
    if quant:
        k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned")
    out = torch.empty_like(q4)
    dims = (B, Hq, Hkv, D, ps, maxP) if name == "paged_decode_attention" else (B, W, Hq, Hkv, D, ps, maxP)
    err = _paged_lib_fn(name)(
        q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        out.data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(),
        int(q4.dtype == torch.bfloat16), kinds[k_pages.dtype], *dims, float(scale),
        float(logit_softcap or 0.0), int(sliding_window or 0),
        torch.cuda.current_stream(q4.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launch_counts[name] += 1
    variant_counts[name][int(quant)] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, *, scale: float,
                           sliding_window: int | None = None, logit_softcap: float | None = None,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """K4: q [B, Hq, D] against one layer's pool [P, ps, Hkv, D]; page_table
    [B, maxP] int32; seq_lens [B] int32 including the current token."""
    kw = dict(scale=scale, sliding_window=sliding_window, logit_softcap=logit_softcap,
              k_scales=k_scales, v_scales=v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens, **kw)
    return _paged_launch("paged_decode_attention", q[:, None], k_pages, v_pages, page_table,
                         seq_lens, **kw)[:, 0]


def paged_window_attention_kernel(q, k_pages, v_pages, page_table, seq_lens, *, scale: float,
                                  sliding_window: int | None = None,
                                  logit_softcap: float | None = None, k_scales=None,
                                  v_scales=None) -> torch.Tensor:
    """K5: q [B, W, Hq, D]; seq_lens [B] int32 before the window; pages up to
    ceil((len + W) / ps), clamped to maxP, are read."""
    kw = dict(scale=scale, sliding_window=sliding_window, logit_softcap=logit_softcap,
              k_scales=k_scales, v_scales=v_scales)
    if q.device.type == "cpu":
        return paged_window_attention_plain(q, k_pages, v_pages, page_table, seq_lens, **kw)
    return _paged_launch("paged_window_attention_kernel", q, k_pages, v_pages, page_table,
                         seq_lens, **kw)
