"""Differentiable pseudo-quantized MoE experts for calibration.

Counterpart of `paroquant_tpu/optim/pseudo_moe.py`: stacked expert
weights with ONE shared rotation and channel-scale set per projection
across all experts. Gate and up share the input-side (hidden) rotation,
down has its own. Pseudo-quantization reshapes [E, In, Out] to output rows
[E*Out, In], so the group quantizer treats every expert's row alike; gate
and up share one quantizer over their concatenated rows.

`PseudoQuantMoEExperts` is an nn.Module like `optim/pseudo.py::
PseudoQuantLinear`: the trainable fields are nn.Parameters (the quantizer's
stay None until the quantizer stage), the pair tables buffers. The
quantizer takes its two forms as optim/pseudo.py's linears do: inside
`pseudo.jit_form()` (the training and validation steps) the jitted scale,
(max - min) * f32(1/15); outside it (init, export, an eager call) the
division.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from ..ops import quant
from ..ops import rotation as rot_ops
from ..ops.moe import QuantizedMoEExperts, pack_stacked, shared_rotation
from .pseudo import _JIT_FORM, _f32

SIDES = ("gate_up", "down")


class PseudoQuantMoEExperts(nn.Module):
    """gate_weight / up_weight [E, H, I], down_weight [E, I, H]; per side
    (gate_up over H, down over I): channel_scales [In], theta [K, In//2],
    q_scale / q_zp [rows * G, 1] (or None): f32 parameters. Per side: mask
    [K, In//2], pairs [K, In] and the permutation form (perm, sign,
    theta_idx [K, In]): buffers."""

    PARAM_FIELDS = {
        "weight": ("gate_weight", "up_weight", "down_weight"),
        "bias": (),
        "angles": ("gate_up_theta", "down_theta"),
        "channel_scales": ("gate_up_channel_scales", "down_channel_scales"),
        "quantizer": ("gate_up_q_scale", "gate_up_q_zp", "down_q_scale", "down_q_zp"),
    }

    def __init__(self, gate_weight, up_weight, down_weight, sides: dict, n_bits: int = 4,
                 group_size: int = 128):
        super().__init__()
        self.gate_weight = nn.Parameter(gate_weight)
        self.up_weight = nn.Parameter(up_weight)
        self.down_weight = nn.Parameter(down_weight)
        for side, t in sides.items():
            setattr(self, f"{side}_channel_scales", nn.Parameter(t["channel_scales"]))
            setattr(self, f"{side}_theta", nn.Parameter(t["theta"]))
            self.register_parameter(f"{side}_q_scale", None)
            self.register_parameter(f"{side}_q_zp", None)
            for name in ("mask", "pairs", "perm", "sign", "theta_idx"):
                self.register_buffer(f"{side}_{name}", t[name])
        self.n_bits = n_bits
        self.group_size = group_size

    def form(self, side: str) -> rot_ops.PermutationForm:
        return rot_ops.PermutationForm(getattr(self, f"{side}_perm"),
                                       getattr(self, f"{side}_sign"),
                                       getattr(self, f"{side}_theta_idx"))

    def theta_eff(self, side: str) -> torch.Tensor:
        theta = getattr(self, f"{side}_theta")
        return torch.where(getattr(self, f"{side}_mask"), torch.zeros_like(theta), theta)

    def set_quantizer(self, side: str, scale: torch.Tensor, zero_point_float: torch.Tensor):
        setattr(self, f"{side}_q_scale",
                nn.Parameter(scale.detach().to(torch.float32).clone()))
        setattr(self, f"{side}_q_zp",
                nn.Parameter(zero_point_float.detach().to(torch.float32).clone()))


def _side_tensors(rotation: rot_ops.RotationParams, in_features: int, group_size: int,
                  device) -> dict:
    pairs = rotation.pairs.cpu().numpy() if isinstance(rotation.pairs, torch.Tensor) \
        else np.asarray(rotation.pairs)
    perm, sign, theta_idx = rot_ops.pairs_to_permutation(pairs, group_size)
    mask = rotation.mask if isinstance(rotation.mask, torch.Tensor) \
        else torch.from_numpy(np.asarray(rotation.mask))
    return {
        "channel_scales": torch.ones(in_features, dtype=torch.float32, device=device),
        "theta": _f32(rotation.theta, device),
        "mask": mask.to(device=device, dtype=torch.bool),
        "pairs": torch.from_numpy(pairs.astype(np.int32)).to(device),
        "perm": torch.from_numpy(perm).long().to(device),
        "sign": torch.from_numpy(sign).to(device),
        "theta_idx": torch.from_numpy(theta_idx).long().to(device),
    }


def make_pseudo_moe(
    experts: dict[str, Any],
    gu_rotation: rot_ops.RotationParams,
    down_rotation: rot_ops.RotationParams,
    *,
    n_bits: int = 4,
    group_size: int = 128,
    device=None,
) -> PseudoQuantMoEExperts:
    """Pseudo experts from stacked dense experts (tensors or numpy) on
    `device` (default: the experts' device; numpy -> CPU), unit channel
    scales, the rotations' angles."""
    if device is None:
        g = experts["gate_proj"]
        device = g.device if isinstance(g, torch.Tensor) else "cpu"
    gate = _f32(experts["gate_proj"], device)
    H, I_moe = gate.shape[1], gate.shape[2]
    return PseudoQuantMoEExperts(
        gate, _f32(experts["up_proj"], device), _f32(experts["down_proj"], device),
        {"gate_up": _side_tensors(gu_rotation, H, group_size, device),
         "down": _side_tensors(down_rotation, I_moe, group_size, device)},
        n_bits=n_bits, group_size=group_size,
    )


def _rotated_scaled(w_stack, scales, theta, form) -> torch.Tensor:
    """[E, In, Out] -> rotated, scaled output rows [E*Out, In] (the
    quantizer's view); theta already masked."""
    In = w_stack.shape[1]
    w = w_stack.transpose(1, 2).reshape(-1, In) * scales[None, :]
    return rot_ops.apply_rotation_stages(w, theta, form)


def _side_rows(p: PseudoQuantMoEExperts, side: str) -> torch.Tensor:
    """A side's rotated rows: gate's then up's [2*E*I, H], or down's [E*H, I]."""
    scales = getattr(p, f"{side}_channel_scales")
    theta, form = p.theta_eff(side), p.form(side)
    if side == "down":
        return _rotated_scaled(p.down_weight, scales, theta, form)
    return torch.cat([_rotated_scaled(p.gate_weight, scales, theta, form),
                      _rotated_scaled(p.up_weight, scales, theta, form)])


@torch.no_grad()
def init_moe_quantizers(p: PseudoQuantMoEExperts) -> PseudoQuantMoEExperts:
    """Attach both sides' quantizer params, initialized (eagerly, dividing)
    from the current rotated rows. Updates `p` in place and returns it."""
    for side in SIDES:
        qp = quant.calc_scales_and_zero_points(_side_rows(p, side), p.group_size, p.n_bits)
        p.set_quantizer(side, qp.scale, qp.zero_point_float)
    return p


def _pseudo_quant_stack(w_stack, scales, theta, form, q_scale, q_zp, n_bits, group_size,
                        row_offset=0) -> torch.Tensor:
    """The pseudo-quant round trip of one stacked projection [E, In, Out]:
    scale, rotate, quantize (rows row_offset.. of the side's quantizer, or
    a fresh min/max one), unrotate, unscale."""
    E, In, Out = w_stack.shape
    w = _rotated_scaled(w_stack, scales, theta, form)
    if q_scale is not None:
        G = In // group_size
        sl = slice(row_offset * G, (row_offset + w.shape[0]) * G)
        w = quant.pseudo_quantize(w, n_bits, group_size,
                                  quant.QuantizerParams(q_scale[sl], q_zp[sl]))
    else:
        w = quant.pseudo_quantize(w, n_bits, group_size, jit=_JIT_FORM.get())
    w = rot_ops.apply_rotation_stages(w, theta, form, inverse=True) / scales[None, :]
    return w.reshape(E, Out, In).transpose(1, 2)


def pseudo_moe_effective_experts(p: PseudoQuantMoEExperts) -> dict[str, torch.Tensor]:
    """Dense effective expert weights after the simulated quantization."""
    E, H, I_moe = p.gate_weight.shape
    out = {}
    for name, side, offset in (("gate_proj", "gate_up", 0), ("up_proj", "gate_up", E * I_moe),
                               ("down_proj", "down", 0)):
        out[name] = _pseudo_quant_stack(
            getattr(p, name.replace("_proj", "_weight")), getattr(p, f"{side}_channel_scales"),
            p.theta_eff(side), p.form(side), getattr(p, f"{side}_q_scale"),
            getattr(p, f"{side}_q_zp"), p.n_bits, p.group_size, row_offset=offset)
    return out


@torch.no_grad()
def export_quantized_moe(p: PseudoQuantMoEExperts) -> dict[str, Any]:
    """Hard-quantize to the interchange tensors (numpy): per projection q
    int32 [E, O, In], scales f32 [E, O, G], zeros int32 [E, O, G]; per side
    theta, pairs and inv_channel_scales."""
    E, H, I_moe = p.gate_weight.shape
    gs = p.group_size
    out: dict[str, Any] = {"moe": True, "n_bits": p.n_bits, "group_size": gs}
    for side in SIDES:
        if getattr(p, f"{side}_q_scale") is not None:
            qp = quant.QuantizerParams(getattr(p, f"{side}_q_scale"), getattr(p, f"{side}_q_zp"))
        else:
            qp = None
        rows = _side_rows(p, side)
        if qp is None:
            qp = quant.calc_scales_and_zero_points(rows, gs, p.n_bits)
        q, s, z = quant.quantize_to_int(rows, qp, p.n_bits, gs)
        parts = (("down", 0, H, I_moe),) if side == "down" else \
            (("gate", 0, I_moe, H), ("up", E * I_moe, I_moe, H))
        for name, r0, O, In in parts:
            sl = slice(r0, r0 + E * O)
            out[name] = {"q": q[sl].reshape(E, O, In).cpu().numpy(),
                         "scales": s[sl].reshape(E, O, -1).cpu().numpy(),
                         "zeros": z[sl].reshape(E, O, -1).cpu().numpy()}
        out[f"{side}_theta"] = p.theta_eff(side).cpu().numpy()
        out[f"{side}_pairs"] = getattr(p, f"{side}_pairs").cpu().numpy()
        out[f"{side}_inv_channel_scales"] = (
            1.0 / getattr(p, f"{side}_channel_scales")).cpu().numpy()
    return {k: out[k] for k in ("moe", "n_bits", "group_size", "gate", "up", "down",
                                "gate_up_theta", "gate_up_pairs", "gate_up_inv_channel_scales",
                                "down_theta", "down_pairs", "down_inv_channel_scales")}


def quantized_moe_from_export(exp: dict[str, Any], rot_dtype=torch.float32,
                              device=None) -> QuantizedMoEExperts:
    """The runtime QuantizedMoEExperts of an export dict (numpy or tensors)
    on `device` (default: the device of the gate's codes; numpy -> CPU):
    packed stacks, bf16 scales and zeros, the shared rotations with
    1/channel_scale folded in."""
    gs, n_bits = int(exp["group_size"]), int(exp["n_bits"])
    q0 = exp["gate"]["q"]
    dev = device if device is not None else (
        q0.device if isinstance(q0, torch.Tensor) else torch.device("cpu"))

    def tensor(a, dtype):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(dev, dtype)

    def stack(sub):
        q = tensor(sub["q"], torch.int32)  # [E, O, In]
        return (pack_stacked(q.transpose(1, 2), n_bits, gs),
                tensor(sub["scales"], torch.float32).transpose(1, 2).to(torch.bfloat16).contiguous(),
                tensor(sub["zeros"], torch.float32).transpose(1, 2).to(torch.bfloat16).contiguous())

    return QuantizedMoEExperts(
        *stack(exp["gate"]), *stack(exp["up"]), *stack(exp["down"]),
        *(shared_rotation(exp[f"{side}_pairs"], exp[f"{side}_theta"],
                          exp[f"{side}_inv_channel_scales"], gs, rot_dtype, dev)
          for side in SIDES))
