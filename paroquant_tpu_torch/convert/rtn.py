"""Round-to-nearest quantization of a model (no calibration), on the device.

Counterpart of `paroquant_tpu/convert/rtn.py`: identity rotation
(theta = 0), seeded random rotation, or the Hadamard-equivalent butterfly
rotation, then per-group min/max RTN into the runtime format of
ops/qlinear.py. MoE layers: `quantize_experts_rtn` quantizes the stacked
experts with identity shared rotations into `ops/moe.py::
QuantizedMoEExperts` (every expert at once: the quantizer works row by
row, so this is JAX's per-expert loop); a shared expert is quantized like
any GLU, the router and the shared expert's gate stay dense. A hybrid's
delta-net layers get W4 in_proj_qkvz and out_proj; in_proj_ba stays dense.
A gemma3n model gets W4 q/k/v/o (the shared-KV tail's unused k/v too, as
JAX's) and MLP; its AltUp, LAuReL and per-layer linears stay dense, and a
W4 lm_head comes from the tied table.
`quantize_model_rtn` runs on the device it is given (the card by default);
only the pair tables are built on the host.
`rtn_export_linear` / `rtn_export_model` give the same quantization as
checkpoint interchange dicts (numpy, JAX's keys) for
`convert/checkpoint.py::save_paro_checkpoint` / `save_awq_checkpoint`: the
RTN and Hadamard-RTN (QuaRot-style) baselines; as in JAX, they leave MoE
experts and the delta-net projections dense. They run on the device the weights lie on.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import DenseLinear
from ..ops import quant, rotation as rot_ops
from ..ops.butterfly import make_butterfly_params
from ..ops.moe import QuantizedMoEExperts, pack_stacked
from ..ops.qlinear import QuantizedLinear, make_quantized_linear
from ..utils.device import resolve_device


def _rtn_quantize(w: torch.Tensor, n_bits: int, group_size: int):
    """(q, scales, zeros) of w [O, I] by round-to-nearest (quantize_to_int)."""
    qp = quant.calc_scales_and_zero_points(w, group_size, n_bits, jit=True)
    return quant.quantize_to_int(w, qp, n_bits, group_size)


@functools.lru_cache(maxsize=None)
def _rotation_params(in_features, group_size, num_rotations, seed, hadamard):
    """(RotationParams, theta or None), cached per shape (host work that
    grows with group_size^2). Hadamard: log2(S) butterfly stages at
    theta = pi/4 (a dense +-1/sqrt(S) mixer per group)."""
    if hadamard:
        params = make_butterfly_params(in_features, group_size, int(np.log2(group_size)))
        theta = torch.where(params.mask, torch.zeros_like(params.theta),
                            torch.full_like(params.theta, np.pi / 4))
        return params, theta
    return rot_ops.make_rotation_params(in_features, group_size, num_rotations, seed), None


def quantize_linear_rtn(
    lin: DenseLinear,
    *,
    n_bits: int = 4,
    group_size: int = 128,
    num_rotations: int = 8,
    seed: int = 0,
    random_rotation: bool = False,
    hadamard: bool = False,
    rot_dtype=torch.bfloat16,
) -> QuantizedLinear:
    """Quantize one dense linear (w [I, O]) to the PARO runtime format."""
    dev = lin.w.device
    w = lin.w.to(torch.float32).T  # [O, I] reference orientation
    O, I = w.shape
    params, theta = _rotation_params(
        I, group_size, num_rotations, seed if random_rotation else 0, hadamard
    )
    if random_rotation and not hadamard:
        rng = np.random.default_rng(seed)
        noise = torch.from_numpy(rng.normal(0, 0.1, tuple(params.theta.shape)).astype(np.float32))
        theta = torch.where(params.mask, torch.zeros_like(noise), noise)
    if random_rotation or hadamard:
        form = rot_ops.to_permutation_form(params.pairs, group_size, dev)
        w_rot = rot_ops.apply_rotation_stages(w, theta.to(dev), form)
    else:
        theta = torch.zeros_like(params.theta)  # identity rotation
        w_rot = w
    q, s, z = _rtn_quantize(w_rot, n_bits, group_size)
    return make_quantized_linear(
        q, s, z, params.pairs, theta, torch.ones(I, dtype=torch.float32, device=dev),
        group_size, bias=None if lin.b is None else lin.b.to(torch.float32),
        rot_dtype=rot_dtype, n_bits=n_bits, device=dev,
    )


def quantize_experts_rtn(
    experts: dict[str, Any], *, n_bits: int = 4, group_size: int = 128,
    num_rotations: int = 8, seed: int = 0, rot_dtype=torch.bfloat16,
) -> QuantizedMoEExperts:
    """Quantize stacked MoE experts (gate/up [E, H, I], down [E, I, H]) with
    identity shared rotations, on the experts' device: per (expert, output
    row) groups of the input dim, scales and zeros stored in bf16.
    num_rotations and seed are JAX's arguments; the identity uses neither."""
    dev = experts["gate_proj"].device

    def quant_stack(w_stack):  # [E, In, Out]: quantize along In per (e, out) row
        E, In, Out = w_stack.shape
        rows = w_stack.to(torch.float32).transpose(1, 2).reshape(E * Out, In)
        q, s, z = _rtn_quantize(rows, n_bits, group_size)
        del rows
        G = In // group_size
        return (pack_stacked(q.reshape(E, Out, In).transpose(1, 2), n_bits, group_size),
                s.reshape(E, Out, G).transpose(1, 2).to(torch.bfloat16).contiguous(),
                z.reshape(E, Out, G).transpose(1, 2).to(torch.bfloat16).contiguous())

    gq, gs, gz = quant_stack(experts["gate_proj"])
    uq, us, uz = quant_stack(experts["up_proj"])
    dq, ds, dz = quant_stack(experts["down_proj"])
    H, I_moe = experts["gate_proj"].shape[1:]

    def eye(n):
        return torch.eye(group_size, dtype=rot_dtype, device=dev).expand(
            n // group_size, group_size, group_size).contiguous()

    return QuantizedMoEExperts(gq, gs, gz, uq, us, uz, dq, ds, dz, eye(H), eye(I_moe))


def _to_device(tree, dev):
    """A copy of a params tree (dicts, lists, DenseLinear, QuantizedMoEExperts,
    tensors) on `dev`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, QuantizedMoEExperts):
        return tree.to(dev)
    if isinstance(tree, DenseLinear):
        return DenseLinear(tree.w.to(dev), None if tree.b is None else tree.b.to(dev))
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree


def quantize_model_rtn(
    params: dict[str, Any],
    config: ModelConfig,
    *,
    n_bits: int = 4,
    group_size: int = 128,
    num_rotations: int = 8,
    seed: int = 0,
    rot_dtype=torch.bfloat16,
    quantize_lm_head: bool = False,
    hadamard: bool = False,
    device="cuda",
) -> dict[str, Any]:
    """Swap every eligible DenseLinear for a QuantizedLinear (a new dict on
    `device`, where the quantization runs).

    quantize_lm_head: also quantize the output projection; for tied
    embeddings a separate W4 head copy is made and the bf16 table stays
    for the input lookup.
    """
    params = _to_device(params, resolve_device(device))
    out = dict(params)
    kw = dict(n_bits=n_bits, group_size=group_size, num_rotations=num_rotations,
              rot_dtype=rot_dtype, hadamard=hadamard)
    if quantize_lm_head:
        if "lm_head" in params:
            head = params["lm_head"]
        else:
            head = DenseLinear(params["embed_tokens"].T, None)
        out["lm_head"] = quantize_linear_rtn(head, seed=seed + 10_000, **kw)
    layers = []
    for i, lp in enumerate(params["layers"]):
        nlp = dict(lp)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            if name in lp and lp[name].w.shape[0] % group_size == 0:
                nlp[name] = quantize_linear_rtn(lp[name], seed=seed + i, **kw)
        if "linear_attn" in lp:
            # a gated delta-net layer: in_proj_qkvz and out_proj to W4; the
            # decay/gate projection in_proj_ba stays dense, as the reference
            # skips it (4bit_moe.sh --skipped-modules linear_attn.in_proj_a/b)
            la = dict(lp["linear_attn"])
            for name in ("in_proj_qkvz", "out_proj"):
                if la[name].w.shape[0] % group_size == 0:
                    la[name] = quantize_linear_rtn(la[name], seed=seed + i, **kw)
            nlp["linear_attn"] = la
        mlp = dict(lp["mlp"])
        if "experts" in mlp and not isinstance(mlp["experts"], QuantizedMoEExperts):
            if config.moe_intermediate_size % group_size == 0:
                mlp["experts"] = quantize_experts_rtn(
                    mlp["experts"], n_bits=n_bits, group_size=group_size,
                    num_rotations=num_rotations, seed=seed + i, rot_dtype=rot_dtype)
        else:
            for name in ("gate_proj", "up_proj", "down_proj"):
                if name in mlp:
                    mlp[name] = quantize_linear_rtn(mlp[name], seed=seed + i, **kw)
        if "shared_expert" in mlp:
            # quantized like any GLU; its sigmoid gate stays dense
            mlp["shared_expert"] = {
                name: lin if lin.w.shape[0] % group_size
                else quantize_linear_rtn(lin, seed=seed + i, **kw)
                for name, lin in mlp["shared_expert"].items()}
        nlp["mlp"] = mlp
        layers.append(nlp)
    out["layers"] = layers
    return out


def rtn_export_linear(
    lin: DenseLinear, *, n_bits: int = 4, group_size: int = 128,
    num_rotations: int = 8, hadamard: bool = False,
) -> dict[str, Any]:
    """Export dict (checkpoint interchange form) of an RTN-quantized linear:
    identity rotation (theta = 0) or the Hadamard-equivalent butterfly stages
    (hadamard=True, the QuaRot/SpinQuant-style baseline); unit channel
    scales. Arrays are numpy: q int32 [O, I], scales f32 [O, G], zeros int32
    [O, G], pairs int32 [K, I], theta f32 [K, I//2]."""
    w = lin.w.to(torch.float32).T  # [O, I]
    dev = w.device
    params, theta = _rotation_params(w.shape[1], group_size, num_rotations, 0, hadamard)
    if hadamard:
        form = rot_ops.to_permutation_form(params.pairs, group_size, dev)
        w = rot_ops.apply_rotation_stages(w, theta.to(dev), form)
    else:
        theta = torch.zeros_like(params.theta)
    q, s, z = _rtn_quantize(w, n_bits, group_size)
    return {
        "q": q.cpu().numpy(),
        "scales": s.cpu().numpy(),
        "zeros": z.cpu().numpy(),
        "pairs": params.pairs.cpu().numpy(),
        "theta": theta.to(torch.float32).cpu().numpy(),
        "inv_channel_scales": np.ones(w.shape[1], np.float32),
        "bias": None if lin.b is None else lin.b.to(torch.float32).cpu().numpy(),
        "n_bits": n_bits,
        "group_size": group_size,
    }


def rtn_export_model(
    params: dict[str, Any], config: ModelConfig, *,
    n_bits: int = 4, group_size: int = 128, hadamard: bool = False,
) -> list[dict[str, Any]]:
    """Per-layer export dicts for save_paro_checkpoint / save_awq_checkpoint
    (the RTN baseline). hadamard=True rotates each group by the
    Hadamard-equivalent butterfly before quantizing (QuaRot/SpinQuant-style
    no-training baseline)."""
    kw = dict(n_bits=n_bits, group_size=group_size, hadamard=hadamard)
    exports: list[dict[str, Any]] = []
    for lp in params["layers"]:
        e: dict[str, Any] = {}
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lin = lp.get(name)
            if isinstance(lin, DenseLinear) and lin.w.shape[0] % group_size == 0:
                e[name] = rtn_export_linear(lin, **kw)
        mlp = lp.get("mlp", {})
        for name in ("gate_proj", "up_proj", "down_proj"):
            lin = mlp.get(name)
            if isinstance(lin, DenseLinear) and lin.w.shape[0] % group_size == 0:
                e[f"mlp.{name}"] = rtn_export_linear(lin, **kw)
        exports.append(e)
    return exports
