"""Dense decoder (Llama / Qwen2 / Qwen3 / Gemma-class) in torch.

Counterpart of `paroquant_tpu/models/decoder.py:38-353, 407-680, 693-843`:
plain functions over a params dict, with the same names, so each JAX
function has its twin here. Linears are `DenseLinear` or the quantized
modules of ops/qlinear.py.

The decode step makes no host sync: the cache length is a 0-d device
tensor, new K/V rows are written with `index_copy_` at that position, and
the masks are built from it. (A later change can capture the step in a CUDA
graph, the counterpart of JAX's one-dispatch `greedy_decode_scan`.) The KV
cache buffers are updated in place.

MoE, linear attention (qwen3_next), gemma3n and the VLM path are later
slices of the port and raise NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from ..ops.qlinear import (
    MergedQuantizedLinear,
    QuantizedLinear,
    merge_quantized_linears,
    merged_linear_forward,
    quantized_linear_forward,
)
from ..utils.device import resolve_device
from .config import ModelConfig


class DenseLinear(nn.Module):
    """Unquantized linear: w [I, O], b [O] | None."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)


def apply_linear(lin, x: torch.Tensor, *, quant_mode: str = "xla") -> torch.Tensor:
    if isinstance(lin, QuantizedLinear):
        return quantized_linear_forward(lin, x, mode=quant_mode)
    y = (x @ lin.w.to(x.dtype)).to(x.dtype)
    if lin.b is not None:
        y = y + lin.b.to(y.dtype)
    return y


def merged_forward_parts(layer: MergedQuantizedLinear, x: torch.Tensor, quant_mode: str) -> tuple:
    """Per-partition outputs of a merged projection."""
    y = merged_linear_forward(layer, x, mode=quant_mode)
    return tuple(torch.split(y, layer.out_splits, dim=-1))


def _unsupported(config: ModelConfig) -> None:
    if config.is_gemma3n:
        raise NotImplementedError("gemma3n models come with slice 3 of the port (VLM/gemma3n)")
    if config.is_moe:
        raise NotImplementedError("MoE models come with slice 3 of the port (ops/moe.py)")
    if config.num_linear_layers or config.attn_gate:
        raise NotImplementedError(
            "linear-attention (qwen3_next) models come with slice 3 of the port")


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, gemma_style: bool) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if gemma_style:
        w = 1.0 + w
    return (xn * w).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [.., T, head_dim//2] for rotate-half RoPE."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def layer_rope_theta(config: ModelConfig, layer_idx: int) -> float:
    """Per-layer RoPE base: local (sliding-window) layers may use rope_local_theta."""
    if config.rope_local_theta is not None and config.layer_sliding_window(layer_idx) is not None:
        return config.rope_local_theta
    return config.rope_theta


def rope_tables_per_layer(positions: torch.Tensor, config: ModelConfig) -> list:
    """One (cos, sin) pair per layer, computed once per distinct theta, over
    config.rotary_dim dims (partial rotary passes the rest)."""
    by_theta: dict[float, tuple] = {}
    out = []
    for li in range(config.num_hidden_layers):
        th = layer_rope_theta(config, li)
        if th not in by_theta:
            by_theta[th] = rope_tables(positions, config.rotary_dim, th)
        out.append(by_theta[th])
    return out


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D], rotate-half convention; dims past the tables pass through."""
    half = cos.shape[-1]
    rd = 2 * half
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., :half].to(torch.float32), x_rot[..., half:].to(torch.float32)
    c = cos[:, :, None, :].to(torch.float32)
    s = sin[:, :, None, :].to(torch.float32)
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if x_pass.shape[-1] == 0:
        return rotated
    return torch.cat([rotated, x_pass], dim=-1)


@dataclass
class KVCache:
    """Uniform-length KV cache: k/v are tuples of per-layer head-major
    buffers [B, Hkv, S, D]; `length` is a 0-d int32 device tensor (tokens
    already cached). The buffers are written in place."""

    k: tuple
    v: tuple
    length: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        _unsupported(config)
        dev = resolve_device(device)
        shape = (batch, config.num_key_value_heads, max_len, config.head_dim)
        n = config.num_full_attn_layers
        return cls(
            k=tuple(torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)),
            v=tuple(torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)),
            length=torch.zeros((), dtype=torch.int32, device=dev),
        )


def attention_kvmajor(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    q_positions: torch.Tensor,  # [B, T] absolute positions of queries
    kv_valid_len: torch.Tensor,  # 0-d: number of valid kv slots
    *,
    scale: float,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Causal GQA attention over a partly filled head-major kv buffer.

    As in JAX, the dots take operands in the stored kv dtype and accumulate
    in f32 (here: the operands are rounded to that dtype, then multiplied in
    f32, where products of bf16 values are exact); probs are rounded to that
    dtype for the PV dot."""
    B, T, Hq, D = q.shape
    Hkv, S_ = k.shape[1], k.shape[2]
    group = Hq // Hkv
    cdt = k.dtype if k.dtype in (torch.bfloat16, torch.float16, torch.float32) else torch.float32
    qc = q.reshape(B, T, Hkv, group, D).to(cdt).to(torch.float32)
    scores = torch.einsum("bthgd,bhsd->bhgts", qc, k.to(cdt).to(torch.float32)) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    kv_pos = torch.arange(S_, device=q.device)[None, None, :]
    qp = q_positions[:, :, None]
    mask = (kv_pos <= qp) & (kv_pos < kv_valid_len)
    if sliding_window is not None:
        mask = mask & (kv_pos > qp - sliding_window)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgts,bhsd->bthgd", probs.to(cdt).to(torch.float32), v.to(cdt).to(torch.float32)
    )
    return out.reshape(B, T, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    xf = x.to(torch.float32)
    if name in ("gelu_pytorch_tanh", "gelu_tanh", "gelu"):
        return torch.nn.functional.gelu(xf, approximate="tanh").to(x.dtype)
    return torch.nn.functional.silu(xf).to(x.dtype)


def mlp_forward(p: dict, x: torch.Tensor, quant_mode: str, act: str = "silu") -> torch.Tensor:
    if "gate_up_proj" in p:  # merged projections (one kernel launch)
        gate, up = merged_forward_parts(p["gate_up_proj"], x, quant_mode)
    else:
        gate = apply_linear(p["gate_proj"], x, quant_mode=quant_mode)
        up = apply_linear(p["up_proj"], x, quant_mode=quant_mode)
    return apply_linear(p["down_proj"], _act(gate, act) * up, quant_mode=quant_mode)


def qkv_forward(p: dict, h: torch.Tensor, config: ModelConfig, quant_mode: str):
    """q/k/v projections, through the merged layer when present."""
    B, T, _ = h.shape
    Hq, Hkv, D = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    if "qkv_proj" in p:
        q, k, v = merged_forward_parts(p["qkv_proj"], h, quant_mode)
    else:
        q = apply_linear(p["q_proj"], h, quant_mode=quant_mode)
        k = apply_linear(p["k_proj"], h, quant_mode=quant_mode)
        v = apply_linear(p["v_proj"], h, quant_mode=quant_mode)
    return q.reshape(B, T, Hq, D), k.reshape(B, T, Hkv, D), v.reshape(B, T, Hkv, D)


def merge_projections(params: dict, config: ModelConfig) -> dict:
    """Merge each layer's quantized q/k/v and gate/up projections into
    MergedQuantizedLinears (one kernel launch, one weight stream each)."""
    out = dict(params)
    layers = []
    for li, lp in enumerate(params["layers"]):
        nlp = dict(lp)
        kv_unused = config.kv_share_source(li) is not None
        if not kv_unused and all(
            isinstance(lp.get(n), QuantizedLinear) for n in ("q_proj", "k_proj", "v_proj")
        ):
            nlp["qkv_proj"] = merge_quantized_linears([lp["q_proj"], lp["k_proj"], lp["v_proj"]])
            for n in ("q_proj", "k_proj", "v_proj"):
                nlp.pop(n)
        mlp = dict(lp["mlp"])
        if all(isinstance(mlp.get(n), QuantizedLinear) for n in ("gate_proj", "up_proj")):
            mlp["gate_up_proj"] = merge_quantized_linears([mlp["gate_proj"], mlp["up_proj"]])
            mlp.pop("gate_proj")
            mlp.pop("up_proj")
        nlp["mlp"] = mlp
        layers.append(nlp)
    out["layers"] = layers
    return out


def layer_forward(
    p: dict,
    x: torch.Tensor,
    config: ModelConfig,
    layer_idx: int,
    cos: torch.Tensor,
    sin: torch.Tensor,
    q_positions: torch.Tensor,
    kv_cache_layer: tuple | None,
    cache_offset: torch.Tensor,
    quant_mode: str,
    attn_mode: str = "einsum",
):
    B, T, _ = x.shape
    Hq, D = config.num_attention_heads, config.head_dim
    norm = config.zero_centered_norm

    h = rms_norm(x, p["input_layernorm"], config.rms_norm_eps, norm)
    q, k, v = qkv_forward(p, h, config, quant_mode)
    if config.qk_norm:
        q = rms_norm(q, p["q_norm"], config.rms_norm_eps, norm)
        k = rms_norm(k, p["k_norm"], config.rms_norm_eps, norm)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    if kv_cache_layer is not None:
        ck, cv = kv_cache_layer  # [B, Hkv, S, D], written in place
        rows = cache_offset.to(torch.int64) + torch.arange(T, device=x.device)
        ck.index_copy_(2, rows, kh.to(ck.dtype))
        cv.index_copy_(2, rows, vh.to(cv.dtype))
        k_all, v_all = ck, cv
        valid = cache_offset + T
        new_cache = (ck, cv)
    else:
        k_all, v_all = kh, vh
        valid = torch.full((), T, dtype=torch.int32, device=x.device)
        new_cache = None

    S_kv = k_all.shape[2]
    # the same gate as the JAX decoder: whole buffer when small, else a
    # 128-multiple kv tile that divides it
    block_k = next((b for b in (256, 128) if S_kv % b == 0), S_kv if S_kv <= 256 else None)
    flash_ok = attn_mode == "flash" and T >= 128 and T % 128 == 0 and block_k is not None
    window = config.layer_sliding_window(layer_idx)
    if flash_ok:
        from ..kernels.attention import flash_attention

        attn_out = flash_attention(
            q.transpose(1, 2), k_all, v_all, valid.reshape(1).expand(B),
            scale=config.attn_scale, q_offset=cache_offset, sliding_window=window,
            logit_softcap=config.attn_logit_softcap,
        ).transpose(1, 2)
    else:
        attn_out = attention_kvmajor(
            q, k_all, v_all, q_positions, valid, scale=config.attn_scale,
            sliding_window=window, logit_softcap=config.attn_logit_softcap,
        )
    attn_out = apply_linear(p["o_proj"], attn_out.reshape(B, T, Hq * D), quant_mode=quant_mode)
    if config.post_norms:
        attn_out = rms_norm(attn_out, p["post_attention_layernorm"], config.rms_norm_eps, norm)
        x = x + attn_out
        h2 = rms_norm(x, p["pre_feedforward_layernorm"], config.rms_norm_eps, norm)
    else:
        x = x + attn_out
        h2 = rms_norm(x, p["post_attention_layernorm"], config.rms_norm_eps, norm)
    mlp_out = mlp_forward(p["mlp"], h2, quant_mode, config.hidden_act)
    if config.post_norms:
        mlp_out = rms_norm(mlp_out, p["post_feedforward_layernorm"], config.rms_norm_eps, norm)
    return x + mlp_out, new_cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def lm_head_logits(params: dict, config: ModelConfig, x: torch.Tensor, quant_mode="xla"):
    """Final hidden [.., H] -> f32 logits [.., V] (tied-embedding aware)."""
    lm_head = params.get("lm_head")
    if lm_head is None:
        # JAX: x @ E^T with f32 accumulation (bf16 products are exact in f32)
        e = params["embed_tokens"].to(x.dtype)
        logits = x.to(torch.float32) @ e.to(torch.float32).T
    else:
        logits = apply_linear(lm_head, x, quant_mode=quant_mode)
    logits = logits.to(torch.float32)
    if config.logit_softcap:
        logits = torch.tanh(logits / config.logit_softcap) * config.logit_softcap
    return logits


def model_forward(
    params: dict,
    config: ModelConfig,
    tokens: torch.Tensor,  # int [B, T]
    cache: KVCache | None = None,
    *,
    quant_mode: str = "xla",
    attn_mode: str = "einsum",
    return_hidden: bool = False,
):
    """Returns (logits [B, T, V] f32, or final hidden [B, T, H] with
    return_hidden=True, and the updated cache)."""
    _unsupported(config)
    B, T = tokens.shape
    x = params["embed_tokens"][tokens.to(torch.int64)]
    if config.gemma_norm:
        # sqrt(H) rounded to x's dtype, as JAX's; a Python number needs no
        # host-to-device copy
        x = x * float(torch.tensor(math.sqrt(config.hidden_size), dtype=x.dtype))
    if cache is not None:
        offset = cache.length
    else:
        offset = torch.zeros((), dtype=torch.int32, device=x.device)
    positions = (offset + torch.arange(T, dtype=torch.int32, device=x.device))[None, :].expand(B, T)
    rope_by_layer = rope_tables_per_layer(positions, config)

    new_k, new_v = [], []
    for i, layer_params in enumerate(params["layers"]):
        layer_cache = None if cache is None else (cache.k[i], cache.v[i])
        cos, sin = rope_by_layer[i]
        x, updated = layer_forward(
            layer_params, x, config, i, cos, sin, positions, layer_cache, offset,
            quant_mode, attn_mode,
        )
        if updated is not None:
            new_k.append(updated[0])
            new_v.append(updated[1])

    x = rms_norm(x, params["norm"], config.rms_norm_eps, config.zero_centered_norm)
    out = x if return_hidden else lm_head_logits(params, config, x, quant_mode)
    if cache is not None:
        cache = KVCache(tuple(new_k), tuple(new_v), offset + T)
    return out, cache


# ---------------------------------------------------------------------------
# Random init (tests / synthetic benchmarks)
# ---------------------------------------------------------------------------


def _dense(gen, fan_in, fan_out, dtype, dev, bias=False) -> DenseLinear:
    w = torch.randn(fan_in, fan_out, generator=gen, dtype=torch.float32, device=dev) / math.sqrt(fan_in)
    b = torch.zeros(fan_out, dtype=dtype, device=dev) if bias else None
    return DenseLinear(w.to(dtype), b)


def init_params(config: ModelConfig, generator: torch.Generator | int = 0,
                dtype=torch.bfloat16, device="cuda") -> dict[str, Any]:
    """Random weights from an explicit torch.Generator (or a seed for one on
    `device`). Not the JAX package's numbers: tests hand both packages the
    same weights through convert/interop.py instead."""
    _unsupported(config)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    H, D = config.hidden_size, config.head_dim
    Hq, Hkv = config.num_attention_heads, config.num_key_value_heads

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    embed = torch.randn(config.vocab_size, H, generator=generator, dtype=torch.float32, device=dev)
    params: dict[str, Any] = {"embed_tokens": (embed * 0.02).to(dtype), "norm": ones(H), "layers": []}
    if not config.tie_word_embeddings:
        params["lm_head"] = _dense(generator, H, config.vocab_size, dtype, dev)
    for _ in range(config.num_hidden_layers):
        lp: dict[str, Any] = {
            "input_layernorm": ones(H),
            "post_attention_layernorm": ones(H),
            "q_proj": _dense(generator, H, Hq * D, dtype, dev, config.attention_bias),
            "k_proj": _dense(generator, H, Hkv * D, dtype, dev, config.attention_bias),
            "v_proj": _dense(generator, H, Hkv * D, dtype, dev, config.attention_bias),
            "o_proj": _dense(generator, Hq * D, H, dtype, dev),
        }
        if config.qk_norm:
            lp["q_norm"] = ones(D)
            lp["k_norm"] = ones(D)
        if config.post_norms:
            lp["pre_feedforward_layernorm"] = ones(H)
            lp["post_feedforward_layernorm"] = ones(H)
        inter = config.intermediate_size
        lp["mlp"] = {
            "gate_proj": _dense(generator, H, inter, dtype, dev, config.mlp_bias),
            "up_proj": _dense(generator, H, inter, dtype, dev, config.mlp_bias),
            "down_proj": _dense(generator, inter, H, dtype, dev, config.mlp_bias),
        }
        params["layers"].append(lp)
    return params


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(params, config: ModelConfig, tokens, cache: KVCache, *,
            quant_mode="xla", attn_mode="einsum"):
    logits, cache = model_forward(
        params, config, tokens, cache, quant_mode=quant_mode, attn_mode=attn_mode
    )
    return logits[:, -1, :], cache


@torch.no_grad()
def decode_step(params, config: ModelConfig, token, cache: KVCache, *, quant_mode="xla"):
    """One token per row ([B, 1]); no host sync."""
    logits, cache = model_forward(params, config, token, cache, quant_mode=quant_mode)
    return logits[:, -1, :], cache


@torch.no_grad()
def greedy_decode_scan(params, config: ModelConfig, first_token, cache: KVCache,
                       n_tokens: int, *, quant_mode: str = "xla", attn_mode="einsum"):
    """n_tokens greedy steps (the JAX lax.scan as a loop over decode_step,
    with no host sync). first_token [B]. Returns (tokens [B, n_tokens] --
    the input token of each step, as in JAX -- and the cache)."""
    tok = first_token.to(torch.int32)
    toks = []
    for _ in range(n_tokens):
        logits, cache = model_forward(params, config, tok[:, None], cache,
                                      quant_mode=quant_mode, attn_mode=attn_mode)
        toks.append(tok)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return torch.stack(toks, dim=1), cache


def greedy_generate(
    params, config: ModelConfig, prompt_tokens: np.ndarray, max_new_tokens: int, *,
    max_len: int | None = None, cache_dtype=torch.bfloat16, quant_mode: str = "xla",
    eos_token_id: int | None = None, device="cuda",
) -> np.ndarray:
    dev = resolve_device(device)
    B, T = prompt_tokens.shape
    max_len = max_len or T + max_new_tokens
    cache = KVCache.create(config, B, max_len, cache_dtype, dev)
    tokens = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int32, device=dev)
    logits, cache = prefill(params, config, tokens, cache, quant_mode=quant_mode)
    out = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(max_new_tokens):
        tok_np = tok.cpu().numpy()
        out.append(tok_np)
        if eos_token_id is not None and bool((tok_np == eos_token_id).all()):
            break
        logits, cache = decode_step(params, config, tok[:, None], cache, quant_mode=quant_mode)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return np.stack(out, axis=1)
