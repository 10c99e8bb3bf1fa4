"""The gemma3n decoder (HF Gemma3n, Gemma 3n E2B / E4B) in torch: AltUp,
LAuReL, per-layer inputs, per-layer MLP widths with activation sparsity and
the shared-KV tail.

Counterpart of `paroquant_tpu/models/gemma3n.py`, function for function and
with the same names; the ground truth is transformers'
models/gemma3n/modeling_gemma3n.py (Gemma3nTextModel). The q/k/v/o and MLP
projections take the linears of the shared decoder (`DenseLinear`, the
quantized modules, calibration's pseudo-quantized ones); the AltUp, LAuReL
and per-layer linears stay dense. Prefill attention goes through K3
(`kernels/attention.py::flash_attention`) under JAX's flash rule, the paged
decode step (`serve/paged.py`) through K4; the layer math is shared by
both through `gemma3n_layer_core`, into which the attention is injected.

Roundings follow JAX's: a Python constant that JAX casts to the tensor's
dtype before it multiplies (sqrt(P), H ** -0.5, 2 ** -0.5, 1 / H) is
rounded to that dtype here too (`_const`); the router's tanh, the AltUp
prediction einsum, `correct_output_scale` and `_magnitude_match` run in
f32 as JAX's do.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Any, Callable

import torch

from ..utils.device import resolve_device
from .config import ModelConfig
from .decoder import (
    KVCache,
    _act,
    _dense,
    apply_linear,
    apply_rope,
    attention_kvmajor,
    lm_head_logits,
    merged_forward_parts,
    rms_norm,
    rope_tables,
)


def _const(v: float, dtype: torch.dtype) -> float:
    """v rounded to dtype (JAX's `jnp.asarray(v, x.dtype)`), as a Python
    number: no host-to-device copy, and a product with a tensor of that
    dtype rounds once, as JAX's."""
    return float(torch.tensor(v, dtype=dtype))


def _rms_noscale(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma3nRMSNorm(with_scale=False): v before it is cached."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma3nRMSNorm: a plain weight (not Gemma's 1 + w)."""
    return rms_norm(x, w, eps, gemma_style=False)


def _magnitude_match(proj: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """proj's rows scaled to target's RMS magnitude, in f32 (the AltUp
    expand / unembed of Gemma3nTextModel; the denominator floored at 1e-5)."""
    pf = proj.to(torch.float32)
    tf = target.to(torch.float32)
    target_mag = torch.sqrt(torch.mean(tf * tf, dim=-1, keepdim=True))
    new_mag = torch.sqrt(torch.clamp(torch.mean(pf * pf, dim=-1, keepdim=True), min=1e-5))
    return (pf * target_mag / new_mag).to(proj.dtype)


# ---------------------------------------------------------------------------
# AltUp (alternating updates; Gemma3nTextAltUp)
# ---------------------------------------------------------------------------


def _altup_modalities(ap: dict, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """tanh(router(router_norm(x) / H)), the tanh in f32: [B, T, A]."""
    r_in = _norm(x, ap["router_norm"], config.rms_norm_eps)
    r_in = r_in * _const(1.0 / config.hidden_size, r_in.dtype)
    routed = apply_linear(ap["modality_router"], r_in)
    return torch.tanh(routed.to(torch.float32)).to(x.dtype)


def altup_predict(ap: dict, hidden: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """hidden [A, B, T, H] -> predictions [A, B, T, H]."""
    A = config.altup_num_inputs
    modal = _altup_modalities(ap, hidden[config.altup_active_idx], config)
    coefs = apply_linear(ap["prediction_coefs"], modal)  # [B, T, A*A]
    # out[j] = sum_a hidden[a] * coefs[.., j, a] (torch's permute before its matmul)
    coefs = coefs.reshape(*coefs.shape[:-1], A, A).transpose(-1, -2)
    pred = torch.einsum("abth,btaj->jbth", hidden.to(torch.float32), coefs.to(torch.float32))
    return pred.to(hidden.dtype) + hidden


def altup_correct(ap: dict, predictions: torch.Tensor, activated: torch.Tensor,
                  config: ModelConfig) -> torch.Tensor:
    """predictions [A, B, T, H], activated [B, T, H] -> corrected [A, B, T, H]."""
    modal = _altup_modalities(ap, activated, config)
    innovation = activated - predictions[config.altup_active_idx]  # [B, T, H]
    coefs = apply_linear(ap["correction_coefs"], modal) + 1.0  # [B, T, A]
    coefs = torch.movedim(coefs, -1, 0)[..., None]  # [A, B, T, 1]
    return predictions + innovation[None] * coefs


# ---------------------------------------------------------------------------
# LAuReL + MLP
# ---------------------------------------------------------------------------


def laurel_forward(lp: dict, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    h = apply_linear(lp["linear_left"], x)
    h = apply_linear(lp["linear_right"], h)
    return x + _norm(h, lp["post_laurel_norm"], config.rms_norm_eps)


def _gaussian_topk(x: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Keep about (1 - sparsity) of the activations: relu(x - (mean + std *
    ppf(sparsity))) with the population std (Gemma3nTextMLP._gaussian_topk)."""
    mult = NormalDist().inv_cdf(sparsity)
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    std = torch.sqrt(torch.mean((xf - mean) ** 2, dim=-1, keepdim=True))
    cutoff = mean + std * _const(mult, torch.float32)
    return torch.relu(xf - cutoff).to(x.dtype)


def gemma3n_mlp(p: dict, x: torch.Tensor, config: ModelConfig, layer_idx: int,
                quant_mode: str) -> torch.Tensor:
    """The GLU with the layer's activation sparsity on the gate."""
    if "gate_up_proj" in p:
        gate, up = merged_forward_parts(p["gate_up_proj"], x, quant_mode)
    else:
        gate = apply_linear(p["gate_proj"], x, quant_mode=quant_mode)
        up = apply_linear(p["up_proj"], x, quant_mode=quant_mode)
    sparsity = config.layer_activation_sparsity(layer_idx)
    if sparsity > 0.0:
        gate = _gaussian_topk(gate, sparsity)
    act_v = _act(gate, config.hidden_act) * up
    return apply_linear(p["down_proj"], act_v, quant_mode=quant_mode)


# ---------------------------------------------------------------------------
# Per-layer inputs
# ---------------------------------------------------------------------------


def per_layer_inputs(params: dict, config: ModelConfig, tokens: torch.Tensor,
                     inputs_embeds: torch.Tensor) -> torch.Tensor:
    """[B, T, L, P]: the scaled per-layer token embeddings plus the normed
    projection of the main embedding (Gemma3nTextModel.get_per_layer_inputs
    and project_per_layer_inputs)."""
    L, P = config.num_hidden_layers, config.hidden_size_per_layer_input
    # ids past the per-layer vocab (multimodal soft tokens) take row 0
    pl_tokens = torch.where(tokens < config.vocab_size_per_layer_input, tokens,
                            torch.zeros_like(tokens))
    ple = params["embed_tokens_per_layer"][pl_tokens.to(torch.int64)]
    ple = ple * _const(math.sqrt(P), ple.dtype)
    ple = ple.reshape(*tokens.shape, L, P)
    proj = apply_linear(params["per_layer_model_projection"], inputs_embeds)
    proj = proj * _const(config.hidden_size ** -0.5, proj.dtype)
    proj = proj.reshape(*inputs_embeds.shape[:-1], L, P)
    proj = _norm(proj, params["per_layer_projection_norm"], config.rms_norm_eps)
    return (proj + ple) * _const(2.0 ** -0.5, proj.dtype)


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------


def gemma3n_qkv(p: dict, h: torch.Tensor, config: ModelConfig, cos, sin, quant_mode: str, *,
                need_kv: bool = True):
    """q/k/v with gemma3n's norms: q_norm then RoPE, k_norm then RoPE, the
    scale-free RMS norm on v. Returns (q [B, T, Hq, D], k [B, T, Hkv, D] or
    None, v or None)."""
    B, T, _ = h.shape
    Hq, Hkv, D = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    eps = config.rms_norm_eps
    if "qkv_proj" in p:  # merged projections (one kernel launch)
        q, k_raw, v_raw = merged_forward_parts(p["qkv_proj"], h, quant_mode)
        q = q.reshape(B, T, Hq, D)
    else:
        q = apply_linear(p["q_proj"], h, quant_mode=quant_mode).reshape(B, T, Hq, D)
        k_raw = v_raw = None
    q = apply_rope(_norm(q, p["q_norm"], eps), cos, sin)
    if not need_kv:
        return q, None, None
    if k_raw is None:
        k_raw = apply_linear(p["k_proj"], h, quant_mode=quant_mode)
        v_raw = apply_linear(p["v_proj"], h, quant_mode=quant_mode)
    k = apply_rope(_norm(k_raw.reshape(B, T, Hkv, D), p["k_norm"], eps), cos, sin)
    v = _rms_noscale(v_raw.reshape(B, T, Hkv, D), eps)
    return q, k, v


def gemma3n_attention(p: dict, h: torch.Tensor, config: ModelConfig, layer_idx: int, cos, sin,
                      q_positions: torch.Tensor, kv_cache_layer: tuple | None,
                      cache_offset: torch.Tensor, shared_kv: tuple | None, quant_mode: str,
                      attn_mode: str = "einsum"):
    """Returns (o_proj's output [B, T, H], the updated cache rows or None,
    this layer's head-major (k, v) over the whole sequence, for the
    shared-KV tail). A tail layer (shared_kv given) attends over its source
    layer's (k, v) and projects no k/v of its own."""
    B, T, _ = h.shape
    Hq, D = config.num_attention_heads, config.head_dim
    is_shared = shared_kv is not None
    q, k, v = gemma3n_qkv(p, h, config, cos, sin, quant_mode, need_kv=not is_shared)
    if is_shared:
        k_all, v_all = shared_kv  # [B, Hkv, S, D]
        new_cache = own_kv = None
    else:
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        if kv_cache_layer is not None:
            ck, cv = kv_cache_layer  # [B, Hkv, S, D], written in place
            rows = cache_offset.to(torch.int64) + torch.arange(T, device=h.device)
            ck.index_copy_(2, rows, kh.to(ck.dtype))
            cv.index_copy_(2, rows, vh.to(cv.dtype))
            k_all, v_all = ck, cv
            new_cache = own_kv = (ck, cv)
        else:
            k_all, v_all = kh, vh
            new_cache, own_kv = None, (kh, vh)

    valid = cache_offset + T
    S_kv = k_all.shape[2]
    block_k = next((b for b in (256, 128) if S_kv % b == 0), S_kv if S_kv <= 256 else None)
    flash_ok = attn_mode == "flash" and T >= 128 and T % 128 == 0 and block_k is not None
    window = config.layer_sliding_window(layer_idx)
    if flash_ok:
        from ..kernels.attention import flash_attention

        out = flash_attention(
            q.transpose(1, 2), k_all, v_all, valid.reshape(1).expand(B),
            scale=config.attn_scale, q_offset=cache_offset, sliding_window=window,
        ).transpose(1, 2)
    else:
        out = attention_kvmajor(q, k_all, v_all, q_positions, valid, scale=config.attn_scale,
                                sliding_window=window)
    out = out.reshape(B, T, Hq * D)
    return apply_linear(p["o_proj"], out, quant_mode=quant_mode), new_cache, own_kv


def gemma3n_layer_core(p: dict, hidden: torch.Tensor, per_layer_input: torch.Tensor,
                       config: ModelConfig, layer_idx: int,
                       attn_fn: Callable[[torch.Tensor], torch.Tensor],
                       quant_mode: str) -> torch.Tensor:
    """The layer's math around its attention, shared by the contiguous and
    the paged paths: hidden [A, B, T, H], per_layer_input [B, T, P];
    attn_fn(normed active prediction [B, T, H]) returns o_proj's output."""
    eps = config.rms_norm_eps
    predictions = altup_predict(p["altup"], hidden, config)
    active = predictions[config.altup_active_idx]
    active_normed = _norm(active, p["input_layernorm"], eps)
    laurel_out = laurel_forward(p["laurel"], active_normed, config)

    attn = _norm(attn_fn(active_normed), p["post_attention_layernorm"], eps)
    attn_gated = active + attn
    attn_laurel = (attn_gated + laurel_out) * _const(2.0 ** -0.5, attn.dtype)

    h2 = _norm(attn_laurel, p["pre_feedforward_layernorm"], eps)
    ffw = gemma3n_mlp(p["mlp"], h2, config, layer_idx, quant_mode)
    activated = attn_laurel + _norm(ffw, p["post_feedforward_layernorm"], eps)

    corrected = altup_correct(p["altup"], predictions, activated, config)
    first = corrected[config.altup_active_idx]
    if config.altup_correct_scale:
        first = (first.to(torch.float32)
                 * p["altup"]["correct_output_scale"].to(torch.float32)).to(first.dtype)
    gate = _act(apply_linear(p["per_layer_input_gate"], first), config.hidden_act)
    proj = apply_linear(p["per_layer_projection"], gate * per_layer_input)
    proj = _norm(proj, p["post_per_layer_input_norm"], eps)
    return torch.cat([corrected[:1], corrected[1:] + proj.to(corrected.dtype)[None]])


def gemma3n_layer(p: dict, hidden: torch.Tensor, per_layer_input: torch.Tensor,
                  config: ModelConfig, layer_idx: int, cos, sin, q_positions,
                  kv_cache_layer: tuple | None, cache_offset: torch.Tensor,
                  shared_kv: tuple | None, quant_mode: str, attn_mode: str = "einsum"):
    """One layer over the AltUp stack: (stack, updated cache rows, own (k, v))."""
    out: dict[str, Any] = {}

    def attn_fn(active_normed):
        attn, out["cache"], out["own_kv"] = gemma3n_attention(
            p, active_normed, config, layer_idx, cos, sin, q_positions, kv_cache_layer,
            cache_offset, shared_kv, quant_mode, attn_mode)
        return attn

    corrected = gemma3n_layer_core(p, hidden, per_layer_input, config, layer_idx, attn_fn,
                                   quant_mode)
    return corrected, out["cache"], out["own_kv"]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def altup_expand(params: dict, x0: torch.Tensor) -> torch.Tensor:
    """The AltUp stack [A, B, T, H]: the embedding and its magnitude-matched
    projections."""
    stack = [x0] + [_magnitude_match(apply_linear(proj, x0), x0)
                    for proj in params["altup_projections"]]
    return torch.stack(stack)


def altup_unembed(params: dict, config: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """The final hidden state [B, T, H]: the mean of the stack's first row and
    its others' magnitude-matched projections, then the final norm."""
    outs = [hidden[0]] + [_magnitude_match(apply_linear(proj, hidden[j + 1]), hidden[0])
                          for j, proj in enumerate(params["altup_unembed_projections"])]
    x = torch.mean(torch.stack(outs), dim=0)
    return _norm(x, params["norm"], config.rms_norm_eps)


def embed_gemma3n(params: dict, config: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x0 = params["embed_tokens"][tokens.to(torch.int64)]
    return x0 * _const(math.sqrt(config.hidden_size), x0.dtype)


def gemma3n_forward(params: dict, config: ModelConfig, tokens: torch.Tensor,
                    cache: KVCache | None = None, *, quant_mode: str = "xla",
                    attn_mode: str = "einsum", input_embeds: torch.Tensor | None = None):
    """Returns (logits [B, T, V] f32, the updated cache). The shared-KV tail
    always reads its source layer's (k, v): the trained semantic, which HF
    takes whenever a cache is present. input_embeds [B, T, H] replaces the
    scaled token embeddings; the per-layer inputs still read `tokens`."""
    B, T = tokens.shape
    x0 = embed_gemma3n(params, config, tokens) if input_embeds is None else input_embeds
    pli = per_layer_inputs(params, config, tokens, x0)  # [B, T, L, P]
    if cache is not None:
        offset = cache.length
    else:
        offset = torch.zeros((), dtype=torch.int32, device=x0.device)
    positions = offset + torch.arange(T, dtype=torch.int32, device=x0.device)
    positions = positions[None, :].expand(B, T)
    rope_global = rope_tables(positions, config.head_dim, config.rope_theta)
    rope_local = rope_tables(positions, config.head_dim,
                             config.rope_local_theta or config.rope_theta)

    hidden = altup_expand(params, x0)  # [A, B, T, H]
    first_shared = config.first_kv_shared_layer
    new_k, new_v = [], []
    own_kvs: dict[int, tuple] = {}
    for i, lp in enumerate(params["layers"]):
        cos, sin = rope_local if config.layer_sliding_window(i) is not None else rope_global
        src = config.kv_share_source(i)
        shared_kv = own_kvs[src] if src is not None else None
        layer_cache = None if cache is None or src is not None else (cache.k[i], cache.v[i])
        hidden, updated, own_kv = gemma3n_layer(
            lp, hidden, pli[:, :, i], config, i, cos, sin, positions, layer_cache, offset,
            shared_kv, quant_mode, attn_mode)
        if updated is not None:
            new_k.append(updated[0])
            new_v.append(updated[1])
        if own_kv is not None and i < first_shared:
            own_kvs[i] = own_kv

    x = altup_unembed(params, config, hidden)
    logits = lm_head_logits(params, config, x, quant_mode)
    if cache is not None:
        cache = KVCache(tuple(new_k), tuple(new_v), offset + T)
    return logits, cache


# ---------------------------------------------------------------------------
# Random init (tests / benchmarks)
# ---------------------------------------------------------------------------


def init_gemma3n_shared(config: ModelConfig, gen: torch.Generator, dtype, dev) -> dict[str, Any]:
    """The weights outside the layers: both embeddings (std 0.02), the
    per-layer projection, the AltUp projections and the norms."""
    H, P = config.hidden_size, config.hidden_size_per_layer_input
    A, L = config.altup_num_inputs, config.num_hidden_layers

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32, device=dev)

    return {
        "embed_tokens": (randn(config.vocab_size, H) * 0.02).to(dtype),
        "embed_tokens_per_layer": (
            randn(config.vocab_size_per_layer_input, L * P) * 0.02).to(dtype),
        "per_layer_model_projection": _dense(gen, H, L * P, dtype, dev),
        "per_layer_projection_norm": torch.ones(P, dtype=dtype, device=dev),
        "altup_projections": [_dense(gen, H, H, dtype, dev) for _ in range(A - 1)],
        "altup_unembed_projections": [_dense(gen, H, H, dtype, dev) for _ in range(A - 1)],
        "norm": torch.ones(H, dtype=dtype, device=dev),
        "layers": [],
    }


def init_gemma3n_layer(config: ModelConfig, gen: torch.Generator, i: int, dtype,
                       dev) -> dict[str, Any]:
    """Random weights of layer i (JAX's layout; correct_output_scale f32 zeros)."""
    H, D, P = config.hidden_size, config.head_dim, config.hidden_size_per_layer_input
    Hq, Hkv, A = config.num_attention_heads, config.num_key_value_heads, config.altup_num_inputs
    inter = config.layer_intermediate_size(i)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    def dense(fi, fo):
        return _dense(gen, fi, fo, dtype, dev)

    return {
        "input_layernorm": ones(H),
        "post_attention_layernorm": ones(H),
        "pre_feedforward_layernorm": ones(H),
        "post_feedforward_layernorm": ones(H),
        "q_proj": dense(H, Hq * D),
        "k_proj": dense(H, Hkv * D),
        "v_proj": dense(H, Hkv * D),
        "o_proj": dense(Hq * D, H),
        "q_norm": ones(D),
        "k_norm": ones(D),
        "mlp": {"gate_proj": dense(H, inter), "up_proj": dense(H, inter),
                "down_proj": dense(inter, H)},
        "altup": {
            "correct_output_scale": torch.zeros(H, dtype=torch.float32, device=dev),
            "correction_coefs": dense(A, A),
            "prediction_coefs": dense(A, A * A),
            "modality_router": dense(H, A),
            "router_norm": ones(H),
        },
        "laurel": {"linear_left": dense(H, config.laurel_rank),
                   "linear_right": dense(config.laurel_rank, H),
                   "post_laurel_norm": ones(H)},
        "per_layer_input_gate": dense(H, P),
        "per_layer_projection": dense(P, H),
        "post_per_layer_input_norm": ones(H),
    }


def init_gemma3n_params(config: ModelConfig, generator: torch.Generator | int = 0,
                        dtype=torch.bfloat16, device="cuda") -> dict[str, Any]:
    """Random weights from an explicit torch.Generator (or a seed for one on
    `device`): not JAX's numbers; tests hand both packages the same weights
    through convert/interop.py."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    params = init_gemma3n_shared(config, generator, dtype, dev)
    for i in range(config.num_hidden_layers):
        params["layers"].append(init_gemma3n_layer(config, generator, i, dtype, dev))
    return params

