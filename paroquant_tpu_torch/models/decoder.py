"""Decoder (Llama / Qwen2 / Qwen3 / Gemma-class, the Qwen3-MoE /
Qwen2-MoE / Mixtral MoE family, the qwen3_next hybrid; gemma3n through
`models/gemma3n.py`) in torch.

Counterpart of `paroquant_tpu/models/decoder.py:38-680, 693-843`: plain
functions over a params dict, with the same names, so each JAX function
has its twin here. Linears are `DenseLinear`, the quantized modules of
ops/qlinear.py, or calibration's `optim/pseudo.py::PseudoQuantLinear`
(unmerged, on the q/k/v and MLP paths alike). A sparse layer's MLP is
`moe_forward`: an f32 router, top-k routing and the experts of
`ops/moe.py` (dense stacks, `QuantizedMoEExperts`, or calibration's
`optim/pseudo_moe.py::PseudoQuantMoEExperts`), plus an optional
sigmoid-gated shared expert. A qwen3_next model interleaves gated
delta-net layers (`models/linear_attn.py`, run by `linear_layer_forward`)
with full-attention layers whose q_proj also emits a sigmoid output gate
(`attn_gate`); the delta-net layers' conv windows and recurrent states ride
in `KVCache.linear`. As in JAX, a delta-net layer returns f32, so after the
first one a bf16 model's residual stream, its later activations and its
logits are f32.

The decode step makes no host sync: the cache length is a 0-d device
tensor, new K/V rows are written with `index_copy_` at that position, and
the masks are built from it. (A later change can capture the step in a CUDA
graph, the counterpart of JAX's one-dispatch `greedy_decode_scan`.) The KV
cache buffers and the delta-net states are updated in place.

`model_forward` and `init_params` hand a gemma3n config to
`models/gemma3n.py`, as JAX's do. The VLM prefill (`models/vision.py`)
enters `model_forward` with `input_embeds` (the merged text and image
embeddings) and `bidir_groups` (each image run's id), under which a layer
lets a run's tokens attend to each other both ways and takes the einsum
attention, as JAX's flash gate does.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable

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
    if type(lin).__name__ == "PseudoQuantLinear":  # calibration path
        from ..optim.pseudo import pseudo_linear_forward

        return pseudo_linear_forward(lin, x)
    y = (x @ lin.w.to(x.dtype)).to(x.dtype)
    if lin.b is not None:
        y = y + lin.b.to(y.dtype)
    return y


def merged_forward_parts(layer: MergedQuantizedLinear, x: torch.Tensor, quant_mode: str) -> tuple:
    """Per-partition outputs of a merged projection."""
    y = merged_linear_forward(layer, x, mode=quant_mode)
    return tuple(torch.split(y, layer.out_splits, dim=-1))


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
    buffers [B, Hkv, S, D], one per full-attention layer (gemma3n: one per
    layer before the shared-KV tail, which reads those); `length` is a 0-d
    int32 device tensor (tokens already cached). A hybrid model's delta-net
    layers keep their conv windows and recurrent states in `linear`
    (`LinearAttnStates`; its conv window in f32, as JAX's). The buffers are
    written in place."""

    k: tuple
    v: tuple
    length: torch.Tensor
    linear: Any = None

    @classmethod
    def create(cls, config: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (batch, config.num_key_value_heads, max_len, config.head_dim)
        n = config.num_full_attn_layers
        linear = None
        if config.num_linear_layers:
            from .linear_attn import LinearAttnStates

            linear = LinearAttnStates.create(config, batch, device=dev)
        return cls(
            k=tuple(torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)),
            v=tuple(torch.zeros(shape, dtype=dtype, device=dev) for _ in range(n)),
            length=torch.zeros((), dtype=torch.int32, device=dev),
            linear=linear,
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
    bidir_groups: tuple | None = None,
) -> torch.Tensor:
    """Causal GQA attention over a partly filled head-major kv buffer.

    As in JAX, the dots take operands in the stored kv dtype and accumulate
    in f32 (here: the operands are rounded to that dtype, then multiplied in
    f32, where products of bf16 values are exact); probs are rounded to that
    dtype for the PV dot. bidir_groups: (q_groups [B, T], kv_groups [B, S])
    int32 ids; positions that share a non-negative id attend to each other
    both ways (the Gemma3 VLM's image runs, HF's token_type_ids mask)."""
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
    if bidir_groups is not None:
        qg, kg = bidir_groups
        same = (qg[:, :, None] >= 0) & (qg[:, :, None] == kg[:, None, :])
        mask = mask | (same & (kv_pos < kv_valid_len))
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


def mlp_forward(p: dict, x: torch.Tensor, quant_mode: str, act: str = "silu",
                taps: dict | None = None) -> torch.Tensor:
    if "gate_up_proj" in p:  # merged projections (one kernel launch)
        gate, up = merged_forward_parts(p["gate_up_proj"], x, quant_mode)
    else:
        gate = apply_linear(p["gate_proj"], x, quant_mode=quant_mode)
        up = apply_linear(p["up_proj"], x, quant_mode=quant_mode)
    hidden = _act(gate, act) * up
    if taps is not None:
        taps["down"] = hidden  # input to down_proj
    return apply_linear(p["down_proj"], hidden, quant_mode=quant_mode)


def qkv_forward(p: dict, h: torch.Tensor, config: ModelConfig, quant_mode: str):
    """q/k/v projections, through the merged layer when present, and the
    attention output gate [B, T, Hq * D] or None: with `attn_gate`
    (qwen3_next) q_proj emits (query, gate) per head."""
    B, T, _ = h.shape
    Hq, Hkv, D = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    if "qkv_proj" in p:
        q, k, v = merged_forward_parts(p["qkv_proj"], h, quant_mode)
    else:
        q = apply_linear(p["q_proj"], h, quant_mode=quant_mode)
        k = apply_linear(p["k_proj"], h, quant_mode=quant_mode)
        v = apply_linear(p["v_proj"], h, quant_mode=quant_mode)
    gate = None
    if config.attn_gate:
        qg = q.reshape(B, T, Hq, 2 * D)
        q = qg[..., :D]
        gate = qg[..., D:].reshape(B, T, Hq * D)
    return q.reshape(B, T, Hq, D), k.reshape(B, T, Hkv, D), v.reshape(B, T, Hkv, D), gate


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


def qkv_rope(p: dict, x: torch.Tensor, config: ModelConfig, cos, sin, quant_mode: str,
             taps: dict | None = None):
    """Input norm, q/k/v projections, qk-norm and RoPE of one layer:
    q [B, T, Hq, D], k/v [B, T, Hkv, D] and the output gate (None without
    `attn_gate`). `taps` (a dict) receives the projections' input as "qkv"."""
    norm, eps = config.zero_centered_norm, config.rms_norm_eps
    h = rms_norm(x, p["input_layernorm"], eps, norm)
    if taps is not None:
        taps["qkv"] = h
    q, k, v, gate = qkv_forward(p, h, config, quant_mode)
    if config.qk_norm:
        q = rms_norm(q, p["q_norm"], eps, norm)
        k = rms_norm(k, p["k_norm"], eps, norm)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, gate


def moe_forward(p: dict, x: torch.Tensor, config: ModelConfig, quant_mode: str,
                return_act: bool = False):
    """Token-choice top-k MoE (Qwen3-MoE semantics): the router in f32, a
    softmax over all experts, the top k (ties to the lower expert index, as
    `lax.top_k`: a stable descending sort), renormalized when
    norm_topk_prob, then `ops/moe.py::moe_apply`; a shared expert, when
    present, adds its GLU output times sigmoid(x @ shared_expert_gate).
    With return_act=True returns (y, routed down_proj inputs [T*K, I_moe],
    the shared expert's down_proj input or None)."""
    from ..ops.moe import moe_apply

    experts = p["experts"]
    if type(experts).__name__ == "PseudoQuantMoEExperts":  # calibration path
        from ..optim.pseudo_moe import pseudo_moe_effective_experts

        p = dict(p)
        p["experts"] = pseudo_moe_effective_experts(experts)

    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    router_logits = xt.to(torch.float32) @ p["router"].w.to(torch.float32)
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = gate_vals[:, :config.num_experts_per_tok]
    idx = idx[:, :config.num_experts_per_tok]
    if config.norm_topk_prob:
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    out = moe_apply(p["experts"], xt, idx, gate_vals.to(x.dtype), quant_mode,
                    return_act=return_act)
    y, act = out if return_act else (out, None)
    shared_act = None
    if "shared_expert" in p:
        taps = {} if return_act else None
        shared = mlp_forward(p["shared_expert"], xt, quant_mode, taps=taps)
        if return_act:
            shared_act = taps["down"]
        sg = torch.sigmoid(xt.to(torch.float32) @ p["shared_expert_gate"].w.to(torch.float32))
        y = y + shared * sg.to(x.dtype)
    y = y.reshape(shape)
    return (y, act, shared_act) if return_act else y


def _mlp_block(p: dict, h2: torch.Tensor, config: ModelConfig, layer_idx: int,
               quant_mode: str, taps: dict | None) -> torch.Tensor:
    """A layer's MLP on its normed input h2 (the MoE block on a sparse
    layer), with the taps "mlp", "down" / "moe_down" and "shared_down"."""
    if taps is not None:
        taps["mlp"] = h2
    if config.layer_is_sparse(layer_idx) and taps is not None:
        mlp_out, taps["moe_down"], shared_act = moe_forward(p["mlp"], h2, config, quant_mode,
                                                            return_act=True)
        if shared_act is not None:
            taps["shared_down"] = shared_act
        return mlp_out
    if config.layer_is_sparse(layer_idx):
        return moe_forward(p["mlp"], h2, config, quant_mode)
    return mlp_forward(p["mlp"], h2, quant_mode, config.hidden_act, taps)


def layer_tail(p: dict, x: torch.Tensor, attn_out: torch.Tensor, config: ModelConfig,
               layer_idx: int, quant_mode: str, taps: dict | None = None,
               gate: torch.Tensor | None = None) -> torch.Tensor:
    """The output gate (attn_out * sigmoid(gate), in f32, where `gate` is
    given), o_proj, residuals, norms and MLP (the MoE block on a sparse
    layer) after a layer's attention output attn_out [B, T, Hq * D]. `taps`
    (a dict) receives the inputs of o_proj ("o"), of gate/up or the router
    and experts ("mlp"), and of down_proj ("down"; on a sparse layer the
    routed experts' "moe_down" and a shared expert's "shared_down")."""
    norm, eps = config.zero_centered_norm, config.rms_norm_eps
    if gate is not None:
        attn_out = (attn_out.to(torch.float32) * torch.sigmoid(gate.to(torch.float32))).to(
            attn_out.dtype)
    if taps is not None:
        taps["o"] = attn_out
    attn_out = apply_linear(p["o_proj"], attn_out, quant_mode=quant_mode)
    if config.post_norms:
        attn_out = rms_norm(attn_out, p["post_attention_layernorm"], eps, norm)
        x = x + attn_out
        h2 = rms_norm(x, p["pre_feedforward_layernorm"], eps, norm)
    else:
        x = x + attn_out
        h2 = rms_norm(x, p["post_attention_layernorm"], eps, norm)
    mlp_out = _mlp_block(p, h2, config, layer_idx, quant_mode, taps)
    if config.post_norms:
        mlp_out = rms_norm(mlp_out, p["post_feedforward_layernorm"], eps, norm)
    return x + mlp_out


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
    attn_mode: str | Callable = "einsum",
    bidir_groups: torch.Tensor | None = None,
    return_taps: bool = False,
):
    """One decoder layer: (output, updated kv), or with return_taps=True
    (output, updated kv, taps): the inputs of the layer's linears, "qkv",
    "o", "mlp" and "down" (a sparse layer: "moe_down" and, with a shared
    expert, "shared_down"), which GPTQ's Hessians are built from.
    bidir_groups [B, T]: the queries' image-run ids (VLM prefill), which
    take the einsum attention."""
    B, T, _ = x.shape
    Hq, D = config.num_attention_heads, config.head_dim
    taps = {} if return_taps else None
    q, k, v, gate = qkv_rope(p, x, config, cos, sin, quant_mode, taps)

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
    flash_ok = (attn_mode == "flash" and T >= 128 and T % 128 == 0 and block_k is not None
                and bidir_groups is None)
    window = config.layer_sliding_window(layer_idx)
    if flash_ok:
        from ..kernels.attention import flash_attention

        attn_out = flash_attention(
            q.transpose(1, 2), k_all, v_all, valid.reshape(1).expand(B),
            scale=config.attn_scale, q_offset=cache_offset, sliding_window=window,
            logit_softcap=config.attn_logit_softcap,
        ).transpose(1, 2)
    elif callable(attn_mode):
        # an injected attention (bench ablations, later the parallel paths):
        # q [B, T, Hq, D] and head-major k/v [B, Hkv, S, D], the cache layout
        if bidir_groups is not None:
            raise NotImplementedError("bidir (VLM) blocks under SP prefill")
        attn_out = attn_mode(
            q, k_all, v_all, q_positions, valid, scale=config.attn_scale,
            sliding_window=window, logit_softcap=config.attn_logit_softcap,
        )
    else:
        bg = None
        if bidir_groups is not None:
            # the keys' ids: the queries' at their cache rows, -1 elsewhere
            kv_groups = torch.full((B, S_kv), -1, dtype=torch.int32, device=x.device)
            cols = (cache_offset.to(torch.int64) if kv_cache_layer is not None else 0) + torch.arange(
                T, device=x.device)
            kv_groups.index_copy_(1, cols, bidir_groups.to(torch.int32))
            bg = (bidir_groups, kv_groups)
        attn_out = attention_kvmajor(
            q, k_all, v_all, q_positions, valid, scale=config.attn_scale,
            sliding_window=window, logit_softcap=config.attn_logit_softcap, bidir_groups=bg,
        )
    out = layer_tail(p, x, attn_out.reshape(B, T, Hq * D), config, layer_idx, quant_mode, taps,
                     gate)
    return (out, new_cache, taps) if return_taps else (out, new_cache)


def linear_layer_forward(p: dict, x: torch.Tensor, config: ModelConfig, layer_idx: int,
                         conv_state, rec_state, quant_mode: str, valid_len=None,
                         return_taps: bool = False):
    """One gated delta-net (linear-attention) layer of a hybrid model: input
    norm, `delta_net_forward`, residual, norm, MLP (or MoE block), residual,
    the branch JAX's model_forward, paged step, GPTQ and calibration each
    spell out. Returns (output, conv state, rec state), or with
    return_taps=True also the taps "la_qkvz" (in_proj's input), "la_out"
    (out_proj's input), "mlp" and "down" / "moe_down" / "shared_down"."""
    from .linear_attn import delta_net_forward

    norm, eps = config.zero_centered_norm, config.rms_norm_eps
    taps = {} if return_taps else None
    h = rms_norm(x, p["input_layernorm"], eps, norm)
    if taps is not None:
        taps["la_qkvz"] = h
        attn_out, conv_state, rec_state, la_taps = delta_net_forward(
            p["linear_attn"], h, config, conv_state, rec_state, quant_mode,
            valid_len=valid_len, return_taps=True)
        taps["la_out"] = la_taps["la_out"]
    else:
        attn_out, conv_state, rec_state = delta_net_forward(
            p["linear_attn"], h, config, conv_state, rec_state, quant_mode, valid_len=valid_len)
    x = x + attn_out
    h2 = rms_norm(x, p["post_attention_layernorm"], eps, norm)
    out = x + _mlp_block(p, h2, config, layer_idx, quant_mode, taps)
    return (out, conv_state, rec_state, taps) if return_taps else (out, conv_state, rec_state)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def embed(params: dict, config: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings [..., H] (scaled by sqrt(H) for Gemma-class models)."""
    x = params["embed_tokens"][tokens.to(torch.int64)]
    if config.gemma_norm:
        # sqrt(H) rounded to x's dtype, as JAX's; a Python number needs no
        # host-to-device copy
        x = x * float(torch.tensor(math.sqrt(config.hidden_size), dtype=x.dtype))
    return x


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
    attn_mode: str | Callable = "einsum",
    input_embeds: torch.Tensor | None = None,
    bidir_groups: torch.Tensor | None = None,
    linear_valid_len=None,
    return_hidden: bool = False,
):
    """Returns (logits [B, T, V] f32, or final hidden [B, T, H] with
    return_hidden=True, and the updated cache). attn_mode: "flash" (K3
    where the prefill fits its tiles), a callable taking q [B, T, Hq, D],
    head-major k/v [B, Hkv, S, D], the query positions and the valid kv
    length (plus scale=, sliding_window=, logit_softcap=), or any other
    string for the einsum attention. input_embeds [B, T, H]: the decoder's
    input in place of the token embeddings (the VLM's merged text and image
    rows); bidir_groups [B, T]: image-run ids, attended both ways (VLM
    prefill; the einsum attention). linear_valid_len (a hybrid model's
    zero-padded prefill bucket; a Python int or a 0-d tensor): the true
    length, past which the delta-net layers leave their states untouched.
    A gemma3n config runs `models/gemma3n.py::gemma3n_forward`."""
    if config.is_gemma3n:
        if return_hidden:
            raise NotImplementedError("return_hidden is not plumbed through the gemma3n forward")
        from .gemma3n import gemma3n_forward

        return gemma3n_forward(params, config, tokens, cache, quant_mode=quant_mode,
                               attn_mode=attn_mode, input_embeds=input_embeds)
    B, T = tokens.shape
    x = embed(params, config, tokens) if input_embeds is None else input_embeds
    if cache is not None:
        offset = cache.length
    else:
        offset = torch.zeros((), dtype=torch.int32, device=x.device)
    positions = (offset + torch.arange(T, dtype=torch.int32, device=x.device))[None, :].expand(B, T)
    rope_by_layer = rope_tables_per_layer(positions, config)

    new_k, new_v = [], []
    for i, layer_params in enumerate(params["layers"]):
        if config.layer_is_linear(i):
            ll = config.linear_layer_index(i)
            conv = None if cache is None else cache.linear.conv[ll]
            rec = None if cache is None else cache.linear.rec[ll]
            x, conv, rec = linear_layer_forward(layer_params, x, config, i, conv, rec, quant_mode,
                                                valid_len=linear_valid_len)
            if cache is not None:
                cache.linear.conv[ll].copy_(conv)
                cache.linear.rec[ll].copy_(rec)
            continue
        ki = config.kv_layer_index(i)
        layer_cache = None if cache is None else (cache.k[ki], cache.v[ki])
        cos, sin = rope_by_layer[i]
        x, updated = layer_forward(
            layer_params, x, config, i, cos, sin, positions, layer_cache, offset,
            quant_mode, attn_mode, bidir_groups,
        )
        if updated is not None:
            new_k.append(updated[0])
            new_v.append(updated[1])

    x = rms_norm(x, params["norm"], config.rms_norm_eps, config.zero_centered_norm)
    out = x if return_hidden else lm_head_logits(params, config, x, quant_mode)
    if cache is not None:
        cache = KVCache(tuple(new_k), tuple(new_v), offset + T, cache.linear)
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
    same weights through convert/interop.py instead. A gemma3n config takes
    `models/gemma3n.py::init_gemma3n_params`."""
    if config.is_gemma3n:
        from .gemma3n import init_gemma3n_params

        return init_gemma3n_params(config, generator, dtype, device)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    H = config.hidden_size
    embed = torch.randn(config.vocab_size, H, generator=generator, dtype=torch.float32, device=dev)
    params: dict[str, Any] = {"embed_tokens": (embed * 0.02).to(dtype),
                              "norm": torch.ones(H, dtype=dtype, device=dev), "layers": []}
    if not config.tie_word_embeddings:
        params["lm_head"] = _dense(generator, H, config.vocab_size, dtype, dev)
    for i in range(config.num_hidden_layers):
        params["layers"].append(_init_layer(config, generator, i, dtype, dev))
    return params


def _init_layer(config: ModelConfig, gen: torch.Generator, i: int, dtype, dev) -> dict[str, Any]:
    """Random weights of decoder layer i (its MLP from `_init_mlp`): a
    gated delta-net layer where config.layer_is_linear(i) (conv_w, dt_bias
    and A_log in f32, as JAX's), else attention (q_proj of 2 Hq D outputs
    with `attn_gate`)."""
    H, D = config.hidden_size, config.head_dim
    Hq, Hkv = config.num_attention_heads, config.num_key_value_heads
    ones = functools.partial(torch.ones, dtype=dtype, device=dev)
    if config.layer_is_linear(i):
        Hk_l, Hv_l = config.linear_num_key_heads, config.linear_num_value_heads
        dk_l, dv_l = config.linear_key_head_dim, config.linear_value_head_dim
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            "input_layernorm": ones(H),
            "post_attention_layernorm": ones(H),
            "linear_attn": {
                "in_proj_qkvz": _dense(gen, H, 2 * Hk_l * dk_l + 2 * Hv_l * dv_l, dtype, dev),
                "in_proj_ba": _dense(gen, H, 2 * Hv_l, dtype, dev),
                "conv_w": torch.randn(config.linear_conv_dim, config.linear_conv_kernel_dim,
                                      generator=gen, **f32) * 0.3,
                "dt_bias": torch.ones(Hv_l, **f32),
                "A_log": torch.log(torch.rand(Hv_l, generator=gen, **f32) * (16.0 - 1e-2) + 1e-2),
                "norm": ones(dv_l),
                "out_proj": _dense(gen, Hv_l * dv_l, H, dtype, dev),
            },
            "mlp": _init_mlp(config, gen, i, dtype, dev),
        }
    q_out = 2 * Hq * D if config.attn_gate else Hq * D
    lp: dict[str, Any] = {
        "input_layernorm": ones(H),
        "post_attention_layernorm": ones(H),
        "q_proj": _dense(gen, H, q_out, dtype, dev, config.attention_bias),
        "k_proj": _dense(gen, H, Hkv * D, dtype, dev, config.attention_bias),
        "v_proj": _dense(gen, H, Hkv * D, dtype, dev, config.attention_bias),
        "o_proj": _dense(gen, Hq * D, H, dtype, dev),
    }
    if config.qk_norm:
        lp["q_norm"] = ones(D)
        lp["k_norm"] = ones(D)
    if config.post_norms:
        lp["pre_feedforward_layernorm"] = ones(H)
        lp["post_feedforward_layernorm"] = ones(H)
    lp["mlp"] = _init_mlp(config, gen, i, dtype, dev)
    return lp


def _init_mlp(config: ModelConfig, gen: torch.Generator, i: int, dtype, dev) -> dict[str, Any]:
    """A dense GLU, or on a sparse layer the router (std 0.02), the stacked
    experts (fan-in scaled) and, where configured, a shared expert with its
    sigmoid gate: JAX's `_init_mlp` layout."""
    H = config.hidden_size

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32, device=dev)

    if config.layer_is_sparse(i):
        E, I_moe = config.num_experts, config.moe_intermediate_size
        mlp: dict[str, Any] = {
            "router": DenseLinear((randn(H, E) * 0.02).to(dtype)),
            "experts": {
                "gate_proj": (randn(E, H, I_moe) / math.sqrt(H)).to(dtype),
                "up_proj": (randn(E, H, I_moe) / math.sqrt(H)).to(dtype),
                "down_proj": (randn(E, I_moe, H) / math.sqrt(I_moe)).to(dtype),
            },
        }
        if config.shared_expert_intermediate_size:
            I_sh = config.shared_expert_intermediate_size
            mlp["shared_expert"] = {
                "gate_proj": _dense(gen, H, I_sh, dtype, dev),
                "up_proj": _dense(gen, H, I_sh, dtype, dev),
                "down_proj": _dense(gen, I_sh, H, dtype, dev),
            }
            mlp["shared_expert_gate"] = DenseLinear((randn(H, 1) * 0.02).to(dtype))
        return mlp
    inter = config.intermediate_size
    return {
        "gate_proj": _dense(gen, H, inter, dtype, dev, config.mlp_bias),
        "up_proj": _dense(gen, H, inter, dtype, dev, config.mlp_bias),
        "down_proj": _dense(gen, inter, H, dtype, dev, config.mlp_bias),
    }


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
