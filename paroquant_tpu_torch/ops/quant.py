"""Uniform affine group quantization math (asymmetric, weight-only INT4).

Counterpart of `paroquant_tpu/ops/quant.py:35-130`: the min/max init and
the hard quantize/dequantize used to export and to RTN-quantize. Each
step is the same float32 elementwise operation in the same order, and
`torch.round` rounds half to even like `jnp.round`, so the results are
bit-identical.

Calibration's straight-through ops (`round_ste`, `clamp_ste`,
`pseudo_quantize`) keep JAX's expression `x + (op(x) - x).detach()`: its
forward is op(x) plus one more rounding, which JAX's carries too, so the
forward is JAX's bit for bit and the gradient passes through unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round (half to even) with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def clamp_ste(x: torch.Tensor, min: float | None = None, max: float | None = None) -> torch.Tensor:
    """Clamp with a straight-through gradient."""
    return x + (torch.clamp(x, min, max) - x).detach()


class QuantizerParams(NamedTuple):
    """Per-group quantization parameters: for a weight [O, I] with
    G = I // group_size, both tensors are [O * G, 1] float32."""

    scale: torch.Tensor
    zero_point_float: torch.Tensor


def calc_scales_and_zero_points(
    weight: torch.Tensor, group_size: int, n_bits: int, *, jit: bool = False
) -> QuantizerParams:
    """Min/max asymmetric init per group, differentiable as JAX's: the span
    goes through `clamp_ste`, and amin/amax share a gradient between tied
    entries as jnp.min/jnp.max do.

    jit=True takes the scale as (max - min) * f32(1 / qmax), which is what
    XLA compiles JAX's (max - min) / qmax to under jit, where JAX runs its
    RTN, its GPTQ and calibration's training and validation steps: the
    port's RTN, GPTQ and those steps pass it, so their codes are JAX's bit
    for bit. The default divides, as JAX's eager calls do (calibration's
    quantizer init and export); on weights stored in f16 or bf16 about 0.1%
    of the codes (rounding ties) differ between the two."""
    if weight.ndim != 2 or weight.shape[-1] % group_size:
        raise ValueError(f"weight {tuple(weight.shape)} is not [O, k*{group_size}]")
    qmax = 2**n_bits - 1
    x = weight.to(torch.float32).reshape(-1, group_size)
    min_val = x.amin(dim=1, keepdim=True)
    max_val = x.amax(dim=1, keepdim=True)
    span = clamp_ste(max_val - min_val, min=1e-5)
    if jit:
        scale = span * torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    else:
        scale = span / qmax
    zero_point = min_val / scale
    return QuantizerParams(scale=scale, zero_point_float=zero_point)


def pseudo_quantize(
    x: torch.Tensor,
    n_bits: int,
    group_size: int,
    params: QuantizerParams | None = None,
    *,
    jit: bool = False,
) -> torch.Tensor:
    """Quantize-dequantize round trip with straight-through gradients.

    x is [O, I]; the math runs in float32 and the result is cast back to
    x.dtype. With params None the scale and zero point come from x itself
    (calc_scales_and_zero_points, in the form that `jit` picks)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    qmin, qmax = 0, 2**n_bits - 1
    if params is None:
        params = calc_scales_and_zero_points(xf, group_size, n_bits, jit=jit)
    scale = clamp_ste(params.scale.to(torch.float32), min=1e-5, max=1e5)
    round_zero_point = clamp_ste(-round_ste(params.zero_point_float.to(torch.float32)), qmin, qmax)
    dim1, dim2 = xf.shape
    xg = xf.reshape(-1, group_size)
    x_int = round_ste(xg / scale)
    x_int = x_int + round_zero_point
    x_int = clamp_ste(x_int, qmin, qmax)
    x_dequant = (x_int - round_zero_point) * scale
    return x_dequant.reshape(dim1, dim2).to(dtype)


def quantize_to_int(
    rotated_weight: torch.Tensor,
    params: QuantizerParams,
    n_bits: int,
    group_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hard quantization of the rotated weight [O, I].

    Returns q int32 [O, I] in [0, 2^bits), scales float32 [O, G] and the
    rounded zero points int32 [O, G], with dequant(q) = (q - zeros) * scales.
    """
    out_features, in_features = rotated_weight.shape
    qmax = 2**n_bits - 1
    n_groups = in_features // group_size
    w = rotated_weight.to(torch.float32).reshape(-1, group_size)
    scale = torch.clamp(params.scale.to(torch.float32), 1e-5, 1e5)
    zeros = torch.clamp(-torch.round(params.zero_point_float.to(torch.float32)), 0, qmax)
    q = torch.clamp(torch.round(w / scale) + zeros, 0, qmax).to(torch.int32)
    return (
        q.reshape(out_features, in_features),
        scale.reshape(out_features, n_groups),
        zeros.to(torch.int32).reshape(out_features, n_groups),
    )


def dequantize_int(
    q: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, group_size: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Inverse of quantize_to_int: q [O, I], scales/zeros [O, G] -> [O, I]."""
    out_features, in_features = q.shape
    qg = q.reshape(out_features, -1, group_size).to(torch.float32)
    w = (qg - zeros[..., None].to(torch.float32)) * scales[..., None].to(torch.float32)
    return w.reshape(out_features, in_features).to(dtype)
