"""Paged KV cache, paged decode step and speculative verify step.

Counterpart of `paroquant_tpu/serve/paged.py` for the dense families:

- a global page pool k/v [Lf, P, page_size, Hkv, D] (with kv_quant="int8",
  int8 pools plus per-(token, head) scales k_scale/v_scale [Lf, P, Hkv, ps]
  f32, the page size last as in JAX). The pools are updated IN PLACE by
  every function here: JAX needs buffer donation for the same effect, torch
  writes the rows where they are;
- per-slot page tables [max_batch, maxP] int32 and lengths [max_batch];
- `paged_decode_step`: one token per slot, its K/V row written at
  (page_table[b, len // ps], len % ps), attention over the slot's pages with
  seq_lens + 1. On CUDA it runs K4 (`kernels/attention.py::
  paged_decode_attention`), on the CPU that kernel's plain version; it makes
  no host sync, so a CUDA graph can capture it;
- `paged_verify_step`: a window of W tokens per slot (speculative verify)
  through K5, positions past the table redirected to the trash page.

attn_mode "kernel" (the default) goes through the K4/K5 wrappers;
"einsum" runs the einsum references `paged_attention` /
`paged_window_attention` over the gathered pages on any device, as JAX's
CPU path does. Tensor-parallel head sharding (`_headshard_attn`), hybrid
(qwen3_next) and gemma3n models are later slices and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels.attention import (
    dequant_pages,
    gather_pages,
    paged_attention,
    paged_decode_attention,
    paged_window_attention,
    paged_window_attention_kernel,
)
from ..models.config import ModelConfig
from ..models.decoder import (
    _unsupported,
    embed,
    layer_tail,
    lm_head_logits,
    qkv_rope,
    rms_norm,
    rope_tables_per_layer,
)
from ..utils.device import resolve_device


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel serving (a mesh, head-sharded paged attention) comes with "
            "slice 5 of the port (parallel/)")


@dataclasses.dataclass
class PagedKVCache:
    """Paged pool for the attention layers: k/v [Lf, P, ps, Hkv, D]; with
    int8 KV, k_scale/v_scale [Lf, P, Hkv, ps] f32. Updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, config: ModelConfig, num_pages: int, page_size: int = 128,
               dtype=torch.bfloat16, kv_quant: str | None = None,
               device="cuda") -> "PagedKVCache":
        _unsupported(config)
        dev = resolve_device(device)
        shape = (config.num_full_attn_layers, num_pages, page_size,
                 config.num_key_value_heads, config.head_dim)
        ks = vs = None
        if kv_quant is not None:
            if kv_quant != "int8":
                raise ValueError(f"unsupported kv_quant {kv_quant!r}")
            dtype = torch.int8
            sshape = (shape[0], num_pages, config.num_key_value_heads, page_size)
            ks = torch.zeros(sshape, dtype=torch.float32, device=dev)
            vs = torch.zeros(sshape, dtype=torch.float32, device=dev)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), ks, vs)


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (head_dim) axis: (q int8 [..., D],
    scale f32 [...]); round half to even, clip to +-127, amax floor 1e-8."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _write_rows(cache: PagedKVCache, li: int, page_idx, offset, k, v) -> None:
    """Write K/V rows [..., Hkv, D] at (page_idx, offset) of layer li, in place."""
    if cache.quantized:
        kq, ksc = kv_quantize(k)
        vq, vsc = kv_quantize(v)
        cache.k[li][page_idx, offset] = kq
        cache.v[li][page_idx, offset] = vq
        cache.k_scale[li][page_idx, :, offset] = ksc
        cache.v_scale[li][page_idx, :, offset] = vsc
    else:
        cache.k[li][page_idx, offset] = k.to(cache.k.dtype)
        cache.v[li][page_idx, offset] = v.to(cache.v.dtype)


def _layer_pool(cache: PagedKVCache, li: int) -> tuple:
    """(k pool, v pool, k scales, v scales) of layer li; scales None unless int8."""
    if cache.quantized:
        return cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li]
    return cache.k[li], cache.v[li], None, None


@torch.no_grad()
def paged_decode_step(params: dict[str, Any], config: ModelConfig, tokens, seq_lens, page_table,
                      cache: PagedKVCache, *, quant_mode: str = "xla", attn_mode: str | None = None,
                      attn_mesh=None):
    """One decode step for every slot: tokens [B] int32, seq_lens [B] int32
    (length BEFORE this token), page_table [B, maxP] int32, all on the
    cache's device. Returns (logits [B, V] f32, cache), the cache written in
    place. A position past the table writes to the slot's last table entry
    (the engine never lets a slot get there)."""
    _unsupported(config)
    _no_mesh(attn_mesh)
    attn_mode = attn_mode or "kernel"
    B = tokens.shape[0]
    ps = cache.page_size
    maxP = page_table.shape[1]
    Hq, D = config.num_attention_heads, config.head_dim

    x = embed(params, config, tokens)[:, None, :]  # [B, 1, H]
    rope_by_layer = rope_tables_per_layer(seq_lens[:, None], config)
    pos = seq_lens.to(torch.int64)
    page_idx = page_table.to(torch.int64).gather(1, (pos // ps).clamp(max=maxP - 1)[:, None])[:, 0]
    offset = pos % ps
    lens_incl = seq_lens + 1
    for li, lp in enumerate(params["layers"]):
        kv_li = config.kv_layer_index(li)
        cos, sin = rope_by_layer[li]
        q, k, v = qkv_rope(lp, x, config, cos, sin, quant_mode)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]  # [B, H*, D]
        _write_rows(cache, kv_li, page_idx, offset, k, v)
        kw = dict(scale=config.attn_scale, sliding_window=config.layer_sliding_window(li),
                  logit_softcap=config.attn_logit_softcap)
        kp, vp, ks, vs = _layer_pool(cache, kv_li)
        if attn_mode == "kernel":
            attn = paged_decode_attention(q, kp, vp, page_table, lens_incl, k_scales=ks,
                                          v_scales=vs, **kw)
        elif attn_mode == "einsum":
            k_pages, v_pages = gather_pages(kp, vp, page_table, ks, vs)
            attn = paged_attention(q, k_pages, v_pages, lens_incl, **kw)
        else:
            raise ValueError(f"unknown attn_mode {attn_mode!r}")
        x = layer_tail(lp, x, attn.to(x.dtype).reshape(B, 1, Hq * D), config, quant_mode)
    x = rms_norm(x[:, 0], params["norm"], config.rms_norm_eps, config.zero_centered_norm)
    return lm_head_logits(params, config, x, quant_mode), cache


@torch.no_grad()
def paged_verify_step(params: dict[str, Any], config: ModelConfig, windows, seq_lens, page_table,
                      cache: PagedKVCache, trash_page: int, *, quant_mode: str = "xla",
                      attn_mode: str | None = None, attn_mesh=None):
    """Speculative verify: windows [B, W] (current token + W-1 drafts) through
    one paged forward. seq_lens [B] is the length BEFORE the window; rows
    at positions past maxP * ps go to `trash_page`. Returns (greedy tokens
    [B, W] int32, their raw logprobs [B, W], the window-row-0 logits [B, V],
    cache). Rejected drafts' rows need no rollback: the next window writes
    over them before attention can reach them."""
    _unsupported(config)
    _no_mesh(attn_mesh)
    attn_mode = attn_mode or "kernel"
    B, W = windows.shape
    ps = cache.page_size
    maxP = page_table.shape[1]
    Hq, D = config.num_attention_heads, config.head_dim

    x = embed(params, config, windows)  # [B, W, H]
    positions = seq_lens[:, None] + torch.arange(W, dtype=seq_lens.dtype, device=seq_lens.device)
    rope_by_layer = rope_tables_per_layer(positions, config)
    pos = positions.to(torch.int64)
    in_range = pos < maxP * ps
    page_idx = torch.where(
        in_range, page_table.to(torch.int64).gather(1, (pos // ps).clamp(max=maxP - 1)),
        torch.full_like(pos, trash_page))
    offset = pos % ps
    for li, lp in enumerate(params["layers"]):
        kv_li = config.kv_layer_index(li)
        cos, sin = rope_by_layer[li]
        q, k, v = qkv_rope(lp, x, config, cos, sin, quant_mode)
        _write_rows(cache, kv_li, page_idx, offset, k, v)
        kw = dict(scale=config.attn_scale, sliding_window=config.layer_sliding_window(li),
                  logit_softcap=config.attn_logit_softcap)
        kp, vp, ks, vs = _layer_pool(cache, kv_li)
        if attn_mode == "kernel":
            attn = paged_window_attention_kernel(q, kp, vp, page_table, seq_lens, k_scales=ks,
                                                 v_scales=vs, **kw)
        elif attn_mode == "einsum":
            k_pages, v_pages = gather_pages(kp, vp, page_table, ks, vs)
            attn = paged_window_attention(q, k_pages, v_pages, positions, **kw)
        else:
            raise ValueError(f"unknown attn_mode {attn_mode!r}")
        x = layer_tail(lp, x, attn.to(x.dtype).reshape(B, W, Hq * D), config, quant_mode)
    x = rms_norm(x, params["norm"], config.rms_norm_eps, config.zero_centered_norm)
    logits = lm_head_logits(params, config, x, quant_mode)  # [B, W, V] f32
    toks = torch.argmax(logits, dim=-1)
    lps = torch.log_softmax(logits, dim=-1).gather(-1, toks[..., None])[..., 0]
    return toks.to(torch.int32), lps, logits[:, 0], cache


@torch.no_grad()
def scatter_prefill_kv(config: ModelConfig, cache: PagedKVCache, layer_k, layer_v, page_ids):
    """Copy a prefilled sequence's KV, layer_k/v [L, T_pad, Hkv, D], into the
    pages page_ids [maxP_req] (padded to whole pages), in place."""
    L, T_pad = layer_k.shape[0], layer_k.shape[1]
    ps = cache.page_size
    n_pages = -(-T_pad // ps)
    pad = n_pages * ps - T_pad
    if pad:
        layer_k = torch.nn.functional.pad(layer_k, (0, 0, 0, 0, 0, pad))
        layer_v = torch.nn.functional.pad(layer_v, (0, 0, 0, 0, 0, pad))
    pages = page_ids[:n_pages].to(torch.int64)
    kp = layer_k.reshape(L, n_pages, ps, *layer_k.shape[2:])
    vp = layer_v.reshape(L, n_pages, ps, *layer_v.shape[2:])
    if cache.quantized:
        kq, ksc = kv_quantize(kp)  # [L, n, ps, Hkv, D] int8, [L, n, ps, Hkv]
        vq, vsc = kv_quantize(vp)
        cache.k[:, pages] = kq
        cache.v[:, pages] = vq
        cache.k_scale[:, pages] = ksc.transpose(-1, -2)  # [L, n, Hkv, ps]
        cache.v_scale[:, pages] = vsc.transpose(-1, -2)
    else:
        cache.k[:, pages] = kp.to(cache.k.dtype)
        cache.v[:, pages] = vp.to(cache.v.dtype)
    return cache


@torch.no_grad()
def gather_prefix_rows(cache: PagedKVCache, page_vec, rows: int, out_dtype=torch.bfloat16):
    """A request's page-resident KV in the KVCache layout: per-layer tuples
    of head-major [1, Hkv, rows, D] (an int8 pool is dequantized to
    out_dtype). Rows past the true prefix carry whatever the pages hold; the
    suffix chunks overwrite them and valid lengths mask them."""
    L = cache.k.shape[0]
    ps = cache.page_size
    pages = page_vec.to(torch.int64)
    maxP = pages.shape[0]
    k, v = cache.k[:, pages], cache.v[:, pages]  # [L, maxP, ps, Hkv, D]
    if cache.quantized:
        k = dequant_pages(k, cache.k_scale[:, pages]).to(out_dtype)
        v = dequant_pages(v, cache.v_scale[:, pages]).to(out_dtype)
    k = k.reshape(L, maxP * ps, *k.shape[3:])
    v = v.reshape(L, maxP * ps, *v.shape[3:])
    if rows <= maxP * ps:
        k, v = k[:, :rows], v[:, :rows]
    else:
        pad = rows - maxP * ps
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    k = k.transpose(1, 2)  # [L, Hkv, rows, D]
    v = v.transpose(1, 2)
    return (tuple(k[i][None].contiguous() for i in range(L)),
            tuple(v[i][None].contiguous() for i in range(L)))
