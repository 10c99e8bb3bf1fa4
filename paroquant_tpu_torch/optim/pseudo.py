"""Differentiable pseudo-quantized linear for calibration.

Counterpart of `paroquant_tpu/optim/pseudo.py`. The quantization
simulation is the same math:

    W_hat = (1/s) * R^T( Q( R(s * W) ) )

with straight-through gradients through Q (ops/quant.py), plain autograd
through the rotation stages, and the dummy pairs' angles masked to zero
inside the forward (`ops/rotation.py::effective_theta`).

`PseudoQuantLinear` is an nn.Module: the trainable fields are
nn.Parameters (`q_scale` / `q_zero_point` stay None until the quantizer
stage), the pair tables are buffers.

Which quantizer form a call takes follows where JAX runs it. JAX's
training and validation steps are jitted, and XLA compiles their
(max - min) / qmax to (max - min) * f32(1 / qmax); `optim/train.py` runs
its steps inside `jit_form()`, which makes `pseudo_quantized_weight` take
that product. `init_quantizer`, `export_quantized` and an eager
`pseudo_quantized_weight` (calibration's GPTQ init) divide, as JAX's
eager calls do.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import numpy as np
import torch
from torch import nn

from ..ops import quant
from ..ops import rotation as rot_ops

# param-group selectors: group name -> the fields it trains
PARAM_GROUPS: dict[str, tuple[str, ...]] = {
    "weight": ("weight",),
    "bias": ("bias",),
    "angles": ("theta",),
    "channel_scales": ("channel_scales",),
    "quantizer": ("q_scale", "q_zero_point"),
}

_JIT_FORM = contextvars.ContextVar("paroquant_jit_form", default=False)


@contextlib.contextmanager
def jit_form():
    """Inside the block, a quantizer that derives its scale from the weight
    takes JAX's jitted form (see the module docstring)."""
    token = _JIT_FORM.set(True)
    try:
        yield
    finally:
        _JIT_FORM.reset(token)


class PseudoQuantLinear(nn.Module):
    """weight [O, I], channel_scales [I], theta [K, I//2], q_scale and
    q_zero_point [O*G, 1] (or None), bias [O] (or None): f32 parameters.
    mask bool [K, I//2], pairs int32 [K, I] and the permutation form
    (perm, sign, theta_idx [K, I]): buffers."""

    PARAM_FIELDS = PARAM_GROUPS

    def __init__(self, weight, channel_scales, theta, bias, mask, pairs, perm, sign, theta_idx,
                 n_bits: int = 4, group_size: int = 128):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.channel_scales = nn.Parameter(channel_scales)
        self.theta = nn.Parameter(theta)
        self.register_parameter("q_scale", None)
        self.register_parameter("q_zero_point", None)
        self.register_parameter("bias", None if bias is None else nn.Parameter(bias))
        self.register_buffer("mask", mask)
        self.register_buffer("pairs", pairs)
        self.register_buffer("perm", perm)
        self.register_buffer("sign", sign)
        self.register_buffer("theta_idx", theta_idx)
        self.n_bits = n_bits
        self.group_size = group_size

    @property
    def form(self) -> rot_ops.PermutationForm:
        return rot_ops.PermutationForm(self.perm, self.sign, self.theta_idx)

    @property
    def rotation_params(self) -> rot_ops.RotationParams:
        return rot_ops.RotationParams(self.pairs, self.theta, self.mask)

    def set_quantizer(self, scale: torch.Tensor, zero_point_float: torch.Tensor) -> None:
        self.q_scale = nn.Parameter(scale.detach().to(torch.float32).clone())
        self.q_zero_point = nn.Parameter(zero_point_float.detach().to(torch.float32).clone())


def _f32(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.detach().to(device=device, dtype=torch.float32).clone()


def make_pseudo_linear(
    weight,  # [O, I]
    rotation: rot_ops.RotationParams,
    *,
    bias=None,
    channel_scales=None,
    n_bits: int = 4,
    group_size: int = 128,
    device=None,
) -> PseudoQuantLinear:
    """A pseudo linear on `device` (default: the weight's; numpy -> CPU)."""
    if device is None:
        device = weight.device if isinstance(weight, torch.Tensor) else "cpu"
    w = _f32(weight, device)
    I = w.shape[1]
    pairs = rotation.pairs.cpu().numpy() if isinstance(rotation.pairs, torch.Tensor) \
        else np.asarray(rotation.pairs)
    perm, sign, theta_idx = rot_ops.pairs_to_permutation(pairs, group_size)
    mask = rotation.mask if isinstance(rotation.mask, torch.Tensor) \
        else torch.from_numpy(np.asarray(rotation.mask))
    return PseudoQuantLinear(
        weight=w,
        channel_scales=(torch.ones(I, dtype=torch.float32, device=device)
                        if channel_scales is None else _f32(channel_scales, device)),
        theta=_f32(rotation.theta, device),
        bias=None if bias is None else _f32(bias, device),
        mask=mask.to(device=device, dtype=torch.bool),
        pairs=torch.from_numpy(pairs.astype(np.int32)).to(device),
        perm=torch.from_numpy(perm).long().to(device),
        sign=torch.from_numpy(sign).to(device),
        theta_idx=torch.from_numpy(theta_idx).long().to(device),
        n_bits=n_bits,
        group_size=group_size,
    )


def rotated_scaled_weight(lin: PseudoQuantLinear) -> torch.Tensor:
    """R(s * W): the tensor the quantizer sees."""
    theta = rot_ops.effective_theta(lin.rotation_params)
    w = lin.weight * lin.channel_scales[None, :]
    return rot_ops.apply_rotation_stages(w, theta, lin.form)


@torch.no_grad()
def init_quantizer(lin: PseudoQuantLinear) -> PseudoQuantLinear:
    """Attach learnable quantizer params initialized (eagerly, dividing)
    from the current rotated weight. Updates `lin` in place and returns it."""
    qp = quant.calc_scales_and_zero_points(rotated_scaled_weight(lin), lin.group_size,
                                           lin.n_bits)
    lin.set_quantizer(qp.scale, qp.zero_point_float)
    return lin


def pseudo_quantized_weight(lin: PseudoQuantLinear) -> torch.Tensor:
    """W_hat [O, I]: scale -> rotate -> quant -> unrotate -> unscale. Where
    the quantizer derives its scale, it takes the jitted form inside
    `jit_form()` and the eager division outside it."""
    theta = rot_ops.effective_theta(lin.rotation_params)
    w = lin.weight * lin.channel_scales[None, :]
    w = rot_ops.apply_rotation_stages(w, theta, lin.form)
    if lin.q_scale is not None:
        params = quant.QuantizerParams(lin.q_scale, lin.q_zero_point)
        w = quant.pseudo_quantize(w, lin.n_bits, lin.group_size, params)
    else:
        w = quant.pseudo_quantize(w, lin.n_bits, lin.group_size, jit=_JIT_FORM.get())
    w = rot_ops.apply_rotation_stages(w, theta, lin.form, inverse=True)
    return w / lin.channel_scales[None, :]


def pseudo_linear_forward(lin: PseudoQuantLinear, x: torch.Tensor) -> torch.Tensor:
    w_hat = pseudo_quantized_weight(lin)
    y = x.to(torch.float32) @ w_hat.T
    if lin.bias is not None:
        y = y + lin.bias
    return y.to(x.dtype)


@torch.no_grad()
def export_quantized(lin: PseudoQuantLinear) -> dict[str, Any]:
    """Hard-quantize to the interchange tensors (numpy): q [O, I] int32,
    scales [O, G] f32, zeros [O, G] int32, pairs, theta,
    inv_channel_scales, bias, n_bits, group_size."""
    w_rot = rotated_scaled_weight(lin)
    if lin.q_scale is not None:
        qp = quant.QuantizerParams(lin.q_scale, lin.q_zero_point)
    else:
        qp = quant.calc_scales_and_zero_points(w_rot, lin.group_size, lin.n_bits)
    q, s, z = quant.quantize_to_int(w_rot, qp, lin.n_bits, lin.group_size)
    theta = rot_ops.effective_theta(lin.rotation_params)
    return {
        "q": q.cpu().numpy(),
        "scales": s.cpu().numpy(),
        "zeros": z.cpu().numpy(),
        "pairs": lin.pairs.cpu().numpy(),
        "theta": theta.cpu().numpy(),
        "inv_channel_scales": (1.0 / lin.channel_scales).cpu().numpy(),
        "bias": None if lin.bias is None else lin.bias.cpu().numpy(),
        "n_bits": lin.n_bits,
        "group_size": lin.group_size,
    }
