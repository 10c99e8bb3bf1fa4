"""Attention kernels: flash prefill (K3) and paged decode / verify (K4, K5).

K3, `flash_attention` (csrc/flash_attention.cu), ports
`paroquant_tpu/kernels/attention.py::flash_attention`. Layouts follow the
JAX function: q [B, Hq, T, D], head-major k/v [B, Hkv, S, D], kv_lens [B]
int32, q_offset scalar or [B] int32 (absolute position of q[:, :, 0]).
Causal by absolute position, masked to k_pos < kv_lens[b], optional
sliding window and tanh softcap, GQA h -> h // (Hq // Hkv), f32 softmax,
output in q.dtype. A query row with no valid key gives 0, as the TPU
kernel's does. bf16 inputs run on the tensor cores (mma.sync), with P
rounded to bf16 for the PV product; f32 inputs on the SIMT units in f32.
f32 q over bf16 k/v (a hybrid model's f32 residual stream over its bf16
cache) takes the SIMT kernel too, with k/v widened to f32 and an f32
output, as the TPU kernel casts each block to f32 and writes q's dtype.
All walk the key tiles `flash_live_tiles` gives. `flash_kinds` counts
K3's calls by instance ("bf16", "f32", "f32_q_bf16_kv").

K4, `paged_decode_attention`, and K5, `paged_window_attention_kernel`
(csrc/paged_attention.cu), port the functions of the same names: one query
(K4) or a window of W queries (K5) per slot against one layer's paged pool
[P, ps, Hkv, D] (f32, bf16, or int8 with scales [P, Hkv, ps] f32), read
through page_table [B, maxP] int32. K4's seq_lens include the current
token; K5's exclude the window. A slot with no valid key (K4 with
seq_lens == 0, which the engine never passes) gives 0 in the kernel and in
the plain version alike.

K4/K5 split each slot's pages over blocks (flash-decoding): `paged_split`
chooses the number of splits from host-known shapes only, never from
seq_lens or the page table, so a decode step makes no host sync. With more
than one split the kernel writes f32 partials to a workspace this module
allocates with `torch.empty`, and the last block of each (slot, kv head,
chunk) to finish, behind a counter it resets, merges them in split order:
one launch per call.

The kernels take every head_dim D that is a multiple of 8 from 8 to 256 and,
K4/K5, any number W * Hq / Hkv of query rows per kv head. CUDA tensors
launch the kernel; CPU tensors run the plain version. Nothing falls back: a
failed build or launch raises, and a shape the kernel does not take (a D
outside that range, a page size K4/K5 do not tile) raises
NotImplementedError. Each CUDA call adds one to
`launch_counts[name]` (K4/K5: one per call, whatever the call launches);
`variant_counts` splits K4/K5 into float and int8 pools.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

NEG_INF = -1e30

launch_counts = {"flash_attention": 0, "paged_decode_attention": 0,
                 "paged_window_attention_kernel": 0}
# K3's calls by q and k/v dtypes (the instance it launches)
FLASH_KINDS = {(torch.float32, torch.float32): (0, "f32"),
               (torch.bfloat16, torch.bfloat16): (1, "bf16"),
               (torch.float32, torch.bfloat16): (2, "f32_q_bf16_kv")}
flash_kinds = {name: 0 for _, name in FLASH_KINDS.values()}
# per-variant split of the paged kernels' counts: [float pool, int8 pool]
variant_counts = {"paged_decode_attention": [0, 0], "paged_window_attention_kernel": [0, 0]}
# K4/K5's calls by instance: bf16 queries over a bf16 or int8 pool take the
# tensor-core `paged_mma_kernel`, everything else (f32 queries, as a hybrid
# model's f32 stream gives) the SIMT `paged_simt_kernel`
paged_instances = {name: {"mma": 0, "simt": 0} for name in variant_counts}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    for name in variant_counts:
        variant_counts[name] = [0, 0]
        paged_instances[name] = {"mma": 0, "simt": 0}
    for name in flash_kinds:
        flash_kinds[name] = 0


def _check_head_dim(D: int) -> None:
    if D % 8 or not 8 <= D <= 256:
        raise NotImplementedError(
            f"the CUDA attention kernels take head_dim a multiple of 8 from 8 to 256, not {D}")


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


FLASH_TILE = 64  # query rows per block and keys per tile of K3


def flash_live_tiles(q_first: int, q_last: int, kv_end: int, window: int | None,
                     causal: bool = True) -> tuple[int, int]:
    """The key tiles K3 walks for a block of query rows at absolute positions
    [q_first, q_last] with keys [0, kv_end) (kv_end = min(kv_lens[b], S)), as
    csrc/flash_attention.cu computes them: (first tile, number of tiles).
    No valid (query, key) pair lies outside them; the counterpart of the
    Pallas kernel's index-map clamp."""
    hi = min(kv_end, q_last + 1) if causal else kv_end
    lo = max(q_first - window + 1, 0) if window else 0
    t_lo = lo // FLASH_TILE
    return t_lo, (-(-hi // FLASH_TILE) - t_lo if hi > lo else 0)


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (K3 copies rows in 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_key_groups(B: int, Hq: int, T: int, D: int, device="cuda") -> int:
    """The key groups (1 or 2) K3's bf16 kernel takes for this shape on the
    device: 2 where its grid has at most one block per SM and D <= 128."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    fn = load("flash_attention").paro_flash_key_groups
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        kg = fn(B, Hq, T, D)
    if kg < 1:
        raise RuntimeError("flash_key_groups: the CUDA device could not be queried")
    return kg


def flash_attention(
    q, k, v, kv_lens, *, scale: float, q_offset=0, sliding_window: int | None = None,
    logit_softcap: float | None = None, causal: bool = True,
) -> torch.Tensor:
    """K3: q [B, Hq, T, D], k/v [B, Hkv, S, D] -> [B, Hq, T, D] in q.dtype;
    q/k/v all f32, all bf16, or f32 q over bf16 k/v."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, kv_lens, scale=scale, q_offset=q_offset,
            sliding_window=sliding_window, logit_softcap=logit_softcap, causal=causal,
        )
    B, Hq, T, D = q.shape
    Hkv, S_ = k.shape[1], k.shape[2]
    _check_head_dim(D)
    kind = FLASH_KINDS.get((q.dtype, k.dtype)) if v.dtype == k.dtype else None
    if kind is None:
        raise TypeError("q/k/v must be all float32, all bfloat16, or float32 q over bfloat16 "
                        f"k/v: {q.dtype} {k.dtype} {v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on the same device")
    q, k, v = (_aligned(t) for t in (q, k, v))
    lens = _per_batch(kv_lens, B, dev)
    qoff = _per_batch(q_offset, B, dev)
    out = torch.empty_like(q)
    err = _lib_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lens.data_ptr(),
        qoff.data_ptr(), kind[0], B, Hq, Hkv, T, S_, D,
        float(scale), float(logit_softcap or 0.0), int(sliding_window or 0), int(causal),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {err}")
    launch_counts["flash_attention"] += 1
    flash_kinds[kind[1]] += 1
    return out


# ---------------------------------------------------------------------------
# Paged decode (K4) and paged window (K5) attention
# ---------------------------------------------------------------------------

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


# blocks paged_split aims for: eight per SM of the H100's 132 (the host does
# not know how many pages each slot has live, so most blocks of short slots
# exit at once)
SPLIT_TARGET_BLOCKS = 8 * 132
# keys a split covers at least: one tile of the tensor-core path
SPLIT_MIN_KEYS = 64
# splits the kernel's last block merges (csrc/paged_attention.cu MAX_SPLITS)
SPLIT_MAX = 32


def paged_split(B: int, Hkv: int, chunks: int, maxP: int, ps: int,
                pages_per_split: int | None = None) -> tuple[int, int]:
    """(splits, pages_per_split) of K4/K5's split over pages, from host-known
    ints only: the most pages a split that still give the grid of B * Hkv *
    chunks * splits blocks SPLIT_TARGET_BLOCKS, but at least SPLIT_MIN_KEYS
    keys a split and at most SPLIT_MAX splits; or `pages_per_split` when
    given. Split s covers pages [s * pps, (s + 1) * pps); splits * pps >=
    maxP, and no split lies wholly past maxP."""
    if pages_per_split is None:
        want = -(-SPLIT_TARGET_BLOCKS // (B * Hkv * chunks))  # splits that reach the target
        most = maxP if want <= 1 else -(-maxP // (want - 1)) - 1  # pps with ceil(maxP / pps) >= want
        pages_per_split = max(most, -(-SPLIT_MIN_KEYS // ps), -(-maxP // SPLIT_MAX))
    pps = max(1, min(int(pages_per_split), maxP))
    return -(-maxP // pps), pps


# per device: the kernels' split counters, zero between calls (each call's
# last block resets its own)
_split_counters: dict = {}


def _counters(n: int, device) -> torch.Tensor:
    c = _split_counters.get(device)
    if c is None or c.numel() < n:
        c = _split_counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return c


_paged_fns: dict = {}
_PAGED_SYMBOLS = {"paged_decode_attention": "paro_paged_decode_attention",
                  "paged_window_attention_kernel": "paro_paged_window_attention"}


def _paged_lib_fn(name: str):
    if name not in _paged_fns:
        lib = load("paged_attention")
        if name == "rows_per_chunk":
            fn = lib.paro_paged_rows_per_chunk
            fn.argtypes = [ctypes.c_int] * 4
        else:
            fn = getattr(lib, _PAGED_SYMBOLS[name])
            n_int = 8 if name == "paged_decode_attention" else 9
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n_int + [
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _paged_fns[name] = fn
    return _paged_fns[name]


def _paged_launch(name, q4, k_pages, v_pages, page_table, seq_lens, scale, sliding_window,
                  logit_softcap, k_scales, v_scales):
    B, W, Hq, D = q4.shape
    P, ps, Hkv, D_kv = k_pages.shape
    maxP = page_table.shape[1]
    _check_head_dim(D)
    if ps < 8 or ps % 8 or (ps > 64 and ps % 64):
        raise NotImplementedError(
            f"the CUDA paged kernels take page sizes that are multiples of 8 up to 64, "
            f"then multiples of 64; not {ps}")
    if D_kv != D or Hq % Hkv or v_pages.shape != k_pages.shape or page_table.shape[0] != B:
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
    q_bf16, kind, R = int(q4.dtype == torch.bfloat16), kinds[k_pages.dtype], W * (Hq // Hkv)
    rows = _paged_lib_fn("rows_per_chunk")(q_bf16, kind, R, D)
    if rows < 1:
        raise NotImplementedError(f"no tiling of {R} query rows at head_dim {D} fits a block")
    chunks = -(-R // rows)
    splits, pps = paged_split(B, Hkv, chunks, maxP, ps)
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(B * Hkv * R * splits * (D + 2), dtype=torch.float32, device=q4.device)
        cnt = _counters(B * Hkv * chunks, q4.device)
    if q4.data_ptr() % 16:  # the kernel reads q in 16-byte pieces
        q4 = q4.clone()
    out = torch.empty_like(q4)
    dims = (B, Hq, Hkv, D, ps, maxP) if name == "paged_decode_attention" else (B, W, Hq, Hkv, D, ps, maxP)
    err = _paged_lib_fn(name)(
        q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        out.data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(), q_bf16, kind, *dims,
        float(scale), float(logit_softcap or 0.0), int(sliding_window or 0), splits, pps,
        None if ws is None else ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
        torch.cuda.current_stream(q4.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launch_counts[name] += 1
    variant_counts[name][int(quant)] += 1
    paged_instances[name]["mma" if q_bf16 and kind else "simt"] += 1
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
