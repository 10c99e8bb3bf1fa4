"""PARO-TPU weight packing, in torch.

Counterpart of `paroquant_tpu/ops/packing.py` (the PARO-TPU layout only;
AWQ interchange waits for the AWQ loader). `qweight` is uint8 [I//2, O].
Within each 128-channel input group, channel k (k < 64) shares a byte with
channel k + 64: low nibble = q[g*128 + k], high nibble = q[g*128 + 64 + k].
This is not the AWQ nibble order. 8-bit weights are stored as uint8 [I, O].

Packing runs on whatever device the input lies on, so a model quantized on
the card is packed there.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(q) -> torch.Tensor:
    return q if isinstance(q, torch.Tensor) else torch.from_numpy(np.asarray(q))


def pack_w4_tpu(q, group_size: int = 128) -> torch.Tensor:
    """q int [I, O] in [0,16) -> uint8 [I//2, O] (group-aligned half-split)."""
    q = _as_tensor(q)
    I, O = q.shape
    if I % group_size:
        raise ValueError(f"in_features {I} is not a multiple of group_size {group_size}")
    half = group_size // 2
    qg = q.reshape(I // group_size, group_size, O).to(torch.uint8)
    lo = qg[:, :half, :] & 0xF
    hi = (qg[:, half:, :] & 0xF) << 4
    return (lo | hi).reshape(I // 2, O).contiguous()


def pack_wq_tpu(q, n_bits: int, group_size: int = 128) -> torch.Tensor:
    """Bits-dispatching pack: 4-bit nibble-packed, 8-bit stored as uint8."""
    if n_bits == 4:
        return pack_w4_tpu(q, group_size)
    if n_bits == 8:
        return _as_tensor(q).to(torch.uint8).contiguous()
    raise ValueError(f"unsupported n_bits={n_bits} (4 or 8)")


def unpack_w4_tpu(packed: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """uint8 [I//2, O] -> int32 [I, O]."""
    Ih, O = packed.shape
    half = group_size // 2
    p = packed.reshape(Ih // half, half, O).to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    return torch.cat([lo, hi], dim=1).reshape(Ih * 2, O)


def unpack_wq_tpu(packed: torch.Tensor, in_features: int, group_size: int = 128) -> torch.Tensor:
    """Inverse of pack_wq_tpu; bit width inferred from the packed row count."""
    if packed.shape[0] == in_features:
        return packed.to(torch.int32)
    if packed.shape[0] * 2 != in_features:
        raise ValueError(f"packed rows {packed.shape[0]} do not match in_features {in_features}")
    return unpack_w4_tpu(packed, group_size)
