"""Gated delta-net linear attention (the qwen3_next hybrid family) in torch.

Counterpart of `paroquant_tpu/models/linear_attn.py`, function for
function. The JAX module reaches no Pallas kernel: it is jnp, one batched
`solve_triangular` and a `lax.scan` over chunks, so plain torch ports it:
`torch.linalg.solve_triangular` and a Python loop over the chunks that
carries the f32 state.

Per value head, with a state S in R^{dk x dv}:
    beta_t = sigmoid(b_t)
    g_t    = -exp(A_log) * softplus(a_t + dt_bias)          (log-decay, <= 0)
    q_t, k_t l2-normalized; q scaled by dk^-0.5
    S_t    = exp(g_t) S_{t-1} + k_t (beta_t (v_t - (exp(g_t) S_{t-1})^T k_t))^T
    o_t    = S_t^T q_t
after a depthwise causal conv (+ SiLU) over the concatenated q/k/v stream,
and followed by a z-gated RMSNorm and out_proj.

Prefill runs the chunked form: within a 64-token chunk the sequential
dependency is a unit-lower-triangular system, solved for all chunks and
heads at once; decode is the O(1) recurrent update on the carried conv
window and state. As in JAX, the recurrence is f32 whatever the model's
dtype, so the layer returns f32 for a bf16 input and the residual stream
that follows it is f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .config import ModelConfig

CHUNK = 64


@dataclass
class LinearAttnStates:
    """Stacked per-linear-layer decode states.

    conv [Ll, B, conv_dim, Kc-1]: the last Kc-1 conv inputs
    rec  [Ll, B, Hv, dk, dv]: the delta rule's recurrent state (f32)
    """

    conv: torch.Tensor
    rec: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, batch: int, dtype=torch.float32,
               device="cuda") -> "LinearAttnStates":
        dev = resolve_device(device)
        Ll = config.num_linear_layers
        return cls(
            conv=torch.zeros((Ll, batch, config.linear_conv_dim,
                              config.linear_conv_kernel_dim - 1), dtype=dtype, device=dev),
            rec=torch.zeros((Ll, batch, config.linear_num_value_heads,
                             config.linear_key_head_dim, config.linear_value_head_dim),
                            dtype=torch.float32, device=dev),
        )


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def _split_qkvz_ba(cfg: ModelConfig, qkvz: torch.Tensor, ba: torch.Tensor):
    """HF's fix_query_key_value_ordering: the projections are interleaved per
    k-head as (q, k, v-group, z-group) / (b-group, a-group). Returns q/k
    [B, T, Hk, dk], v/z [B, T, Hv, dv], b/a [B, T, Hv]."""
    B, T = qkvz.shape[0], qkvz.shape[1]
    Hk, Hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    r = Hv // Hk
    mixed = qkvz.reshape(B, T, Hk, 2 * dk + 2 * r * dv)
    q = mixed[..., :dk]
    k = mixed[..., dk:2 * dk]
    v = mixed[..., 2 * dk:2 * dk + r * dv].reshape(B, T, Hv, dv)
    z = mixed[..., 2 * dk + r * dv:].reshape(B, T, Hv, dv)
    mixed_ba = ba.reshape(B, T, Hk, 2 * r)
    b = mixed_ba[..., :r].reshape(B, T, Hv)
    a = mixed_ba[..., r:].reshape(B, T, Hv)
    return q, k, v, z, b, a


def _conv_mix(cfg: ModelConfig, qkv_flat: torch.Tensor, conv_w: torch.Tensor,
              prev_window: torch.Tensor | None, valid_len=None):
    """Depthwise causal conv + SiLU over the channel-last [B, T, C] stream.

    conv_w [C, Kc]; prev_window [B, C, Kc-1] (decode) or None (a prefill
    from 0). valid_len (a padded prefill's true length; the engine passes a
    Python int, a 0-d tensor is read on the host): the returned window holds
    the inputs at positions [valid_len-Kc+1, valid_len), not the padded tail.
    Returns (mixed [B, T, C] in the stream's dtype, new window [B, C, Kc-1])."""
    B, T, C = qkv_flat.shape
    Kc = conv_w.shape[-1]
    xc = qkv_flat.transpose(1, 2)  # [B, C, T]
    if prev_window is None:
        prev_window = torch.zeros((B, C, Kc - 1), dtype=xc.dtype, device=xc.device)
    xfull = torch.cat([prev_window.to(xc.dtype), xc], dim=-1)  # [B, C, T+Kc-1]
    # the depthwise conv as a sum of Kc shifted scalings, in JAX's order
    out = torch.zeros((B, C, T), dtype=torch.float32, device=xc.device)
    for i in range(Kc):
        out = out + conv_w[None, :, i:i + 1].to(torch.float32) * xfull[:, :, i:i + T].to(
            torch.float32)
    out = F.silu(out)
    if Kc == 1:
        new_window = xfull[:, :, :0]
    elif valid_len is None:
        new_window = xfull[:, :, -(Kc - 1):]
    else:
        # window = stream[valid_len-(Kc-1) : valid_len] = xfull[valid_len : valid_len+Kc-1]
        start = min(max(int(valid_len), 0), T)
        new_window = xfull[:, :, start:start + Kc - 1]
    return out.transpose(1, 2).to(qkv_flat.dtype), new_window.contiguous()


def _gated_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm(x) * w * silu(z) (HF Qwen3NextRMSNormGated); the weight as it is."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    return (xn * weight.to(torch.float32) * F.silu(z.to(torch.float32))).to(x.dtype)


def _chunk_delta_rule(q, k, v, g, beta, init_state):
    """Chunked parallel gated delta rule.

    q/k [B, Hv, T, dk] (l2-normed, q scaled), v [B, Hv, T, dv], g [B, Hv, T]
    log-decay, beta [B, Hv, T]; T % CHUNK == 0. init_state [B, Hv, dk, dv]
    f32. Returns (out [B, Hv, T, dv] f32, state)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    nC = T // CHUNK
    dev = q.device

    def to_chunks(x):  # [B, H, T, ...] -> [nC, B, H, CHUNK, ...]
        x = x.reshape(B, H, nC, CHUNK, *x.shape[3:])
        return x.permute(2, 0, 1, 3, *range(4, x.dim()))

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    gc, bc = to_chunks(g), to_chunks(beta)  # [nC, B, H, C]

    gcum = torch.cumsum(gc, dim=-1)  # the within-chunk cumulative log decay
    ones = torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=dev)
    tril = torch.tril(ones, -1)
    attn_mask = torch.tril(ones)
    eye = torch.eye(CHUNK, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    # decay[i, j] = exp(gcum_i - gcum_j) for j <= i
    decay = torch.where(attn_mask, torch.exp(gcum[..., :, None] - gcum[..., None, :]), zero)

    k_beta = kc * bc[..., None]
    v_beta = vc * bc[..., None]
    # L = strictly lower (k_beta k^T * decay); the in-chunk forward
    # substitution composes to M = (I + L)^{-1}: one batched unit-triangular solve
    L = torch.where(tril, torch.einsum("...id,...jd->...ij", k_beta, kc) * decay, zero)
    M = torch.linalg.solve_triangular(eye + L, eye.expand(L.shape), upper=False,
                                      unitriangular=True)  # [nC, B, H, C, C]
    v_eff = M @ v_beta
    kg = k_beta * torch.exp(gcum)[..., None]
    k_cumdecay = M @ kg

    state = init_state.to(torch.float32)
    qc, kc = qc.to(torch.float32), kc.to(torch.float32)
    outs = []
    for c in range(nC):  # JAX's lax.scan over the chunks
        q_i, k_i, gcum_i = qc[c], kc[c], gcum[c]
        attn = torch.where(attn_mask, (q_i @ k_i.transpose(-1, -2)) * decay[c], zero)
        v_new = v_eff[c] - k_cumdecay[c] @ state
        attn_inter = (q_i * torch.exp(gcum_i)[..., None]) @ state
        outs.append(attn_inter + attn @ v_new)
        g_last = gcum_i[..., -1]  # [B, H]
        k_scaled = k_i * torch.exp(g_last[..., None, None] - gcum_i[..., None])
        state = state * torch.exp(g_last)[..., None, None] + k_scaled.transpose(-1, -2) @ v_new
    out = torch.stack(outs).permute(1, 2, 0, 3, 4).reshape(B, H, T, dv)
    return out, state


def _recurrent_delta_rule(q, k, v, g, beta, state):
    """One-token recurrent update. q/k [B, Hv, dk], v [B, Hv, dv], g/beta
    [B, Hv], state [B, Hv, dk, dv] f32. Returns (out [B, Hv, dv], new state)."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    state = state * torch.exp(g)[..., None, None]
    kv_mem = torch.einsum("bhdv,bhd->bhv", state, kf)
    delta = (vf - kv_mem) * beta[..., None]
    state = state + kf[..., :, None] * delta[..., None, :]
    out = torch.einsum("bhdv,bhd->bhv", state, qf)
    return out, state


def delta_net_forward(
    p: dict[str, Any],
    x: torch.Tensor,  # [B, T, H]
    config: ModelConfig,
    conv_state: torch.Tensor | None,  # [B, conv_dim, Kc-1] or None (prefill)
    rec_state: torch.Tensor | None,  # [B, Hv, dk, dv] or None
    quant_mode: str,
    valid_len=None,  # the true prompt length of a zero-padded prefill
    return_taps: bool = False,  # also return {"la_out": out_proj's input}
):
    """The whole gated delta-net layer: (out [B, T, H], conv state, rec state).

    T == 1 with states present is the O(1) recurrent decode step; otherwise
    the chunked prefill (states, if given, seed the recurrence). valid_len
    serves the engine's zero-padded prefill buckets: positions >= valid_len
    are masked out of the state (g = 0, k = v = beta = 0) and the conv window
    is taken at the true length, so the carried states are those of an
    unpadded prefill."""
    from .decoder import apply_linear  # a local import: decoder imports this module

    B, T, _ = x.shape
    Hk, Hv = config.linear_num_key_heads, config.linear_num_value_heads
    dk, dv = config.linear_key_head_dim, config.linear_value_head_dim
    r = Hv // Hk

    qkvz = apply_linear(p["in_proj_qkvz"], x, quant_mode=quant_mode)
    ba = apply_linear(p["in_proj_ba"], x, quant_mode=quant_mode)
    q, k, v, z, b, a = _split_qkvz_ba(config, qkvz, ba)

    qkv_flat = torch.cat([q.reshape(B, T, -1), k.reshape(B, T, -1), v.reshape(B, T, -1)], dim=-1)
    valid = None
    if valid_len is not None and T > 1:
        valid = (torch.arange(T, device=x.device) < valid_len)[None, :]  # [1, T]
        qkv_flat = qkv_flat.masked_fill(~valid[..., None], 0)
    mixed, conv_state = _conv_mix(config, qkv_flat, p["conv_w"], conv_state,
                                  valid_len=valid_len if T > 1 else None)
    q = mixed[..., :Hk * dk].reshape(B, T, Hk, dk)
    k = mixed[..., Hk * dk:2 * Hk * dk].reshape(B, T, Hk, dk)
    v = mixed[..., 2 * Hk * dk:].reshape(B, T, Hv, dv)

    beta = torch.sigmoid(b.to(torch.float32))  # [B, T, Hv]
    # softplus as jax.nn.softplus: logaddexp(x, 0)
    a_dt = a.to(torch.float32) + p["dt_bias"].to(torch.float32)
    g = -torch.exp(p["A_log"].to(torch.float32)) * torch.logaddexp(a_dt, torch.zeros_like(a_dt))
    if valid is not None:
        k = k.masked_fill(~valid[..., None, None], 0)
        v = v.masked_fill(~valid[..., None, None], 0)
        beta = beta.masked_fill(~valid[..., None], 0)
        g = g.masked_fill(~valid[..., None], 0)

    q = _l2norm(q.to(torch.float32)) * (dk ** -0.5)
    k = _l2norm(k.to(torch.float32))
    if r > 1:
        q = torch.repeat_interleave(q, r, dim=2)
        k = torch.repeat_interleave(k, r, dim=2)

    if rec_state is None:
        rec_state = torch.zeros((B, Hv, dk, dv), dtype=torch.float32, device=x.device)

    if T == 1:
        out_h, rec_state = _recurrent_delta_rule(q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0],
                                                 rec_state)
        core = out_h[:, None]  # [B, 1, Hv, dv]
    else:
        pad = -T % CHUNK

        def hm(xx):  # [B, T, H, *] -> [B, H, T, *], zero-padded to a CHUNK multiple
            xx = xx.transpose(1, 2)
            if pad:
                xx = F.pad(xx, (0, 0) * (xx.dim() - 3) + (0, pad))
            return xx

        # the padding is exact: padded positions get g = 0 (no decay) and
        # k = v = beta = 0 (no update), so the carried state is untouched
        out_h, rec_state = _chunk_delta_rule(hm(q), hm(k), hm(v), hm(g), hm(beta), rec_state)
        core = out_h[:, :, :T].transpose(1, 2)  # [B, T, Hv, dv]
    out = _gated_norm(core, z, p["norm"], config.rms_norm_eps)
    out = out.reshape(B, T, Hv * dv)
    y = apply_linear(p["out_proj"], out, quant_mode=quant_mode)
    if return_taps:
        return y, conv_state, rec_state, {"la_out": out}
    return y, conv_state, rec_state
