"""Round-to-nearest quantization of a dense model (no calibration), on the device.

Counterpart of `paroquant_tpu/convert/rtn.py:36-116, 160-247` for the dense
families: identity rotation (theta = 0), seeded random rotation, or the
Hadamard-equivalent butterfly rotation, then per-group min/max RTN into the
runtime format of ops/qlinear.py. `quantize_model_rtn` runs on the device it
is given (the card by default); only the pair tables are built on the host.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import DenseLinear, _unsupported
from ..ops import quant, rotation as rot_ops
from ..ops.butterfly import make_butterfly_params
from ..ops.qlinear import QuantizedLinear, make_quantized_linear
from ..utils.device import resolve_device


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
    qp = quant.calc_scales_and_zero_points(w_rot, group_size, n_bits)
    q, s, z = quant.quantize_to_int(w_rot, qp, n_bits, group_size)
    return make_quantized_linear(
        q, s, z, params.pairs, theta, torch.ones(I, dtype=torch.float32, device=dev),
        group_size, bias=None if lin.b is None else lin.b.to(torch.float32),
        rot_dtype=rot_dtype, n_bits=n_bits, device=dev,
    )


def _to_device(tree, dev):
    """A copy of a params tree (dicts, lists, DenseLinear, tensors) on `dev`."""
    if isinstance(tree, torch.Tensor):
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
    _unsupported(config)
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
        mlp = dict(lp["mlp"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            if name in mlp:
                mlp[name] = quantize_linear_rtn(mlp[name], seed=seed + i, **kw)
        nlp["mlp"] = mlp
        layers.append(nlp)
    out["layers"] = layers
    return out
