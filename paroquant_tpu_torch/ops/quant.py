"""Uniform affine group quantization math (asymmetric, weight-only INT4).

Counterpart of `paroquant_tpu/ops/quant.py:35-130`: the min/max init and
the hard quantize/dequantize used to export and to RTN-quantize. Each
step is the same float32 elementwise operation in the same order, and
`torch.round` rounds half to even like `jnp.round`, so the results are
bit-identical. The straight-through ops wait for calibration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizerParams(NamedTuple):
    """Per-group quantization parameters: for a weight [O, I] with
    G = I // group_size, both tensors are [O * G, 1] float32."""

    scale: torch.Tensor
    zero_point_float: torch.Tensor


def calc_scales_and_zero_points(
    weight: torch.Tensor, group_size: int, n_bits: int
) -> QuantizerParams:
    """Min/max asymmetric init per group."""
    if weight.ndim != 2 or weight.shape[-1] % group_size:
        raise ValueError(f"weight {tuple(weight.shape)} is not [O, k*{group_size}]")
    qmax = 2**n_bits - 1
    x = weight.to(torch.float32).reshape(-1, group_size)
    min_val = x.amin(dim=1, keepdim=True)
    max_val = x.amax(dim=1, keepdim=True)
    scale = torch.clamp(max_val - min_val, min=1e-5) / qmax
    zero_point = min_val / scale
    return QuantizerParams(scale=scale, zero_point_float=zero_point)


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
