"""INT4 weight packing layouts, in torch and numpy.

Counterpart of `paroquant_tpu/ops/packing.py`. Two layouts:

1. **PARO-TPU layout** (runtime): `qweight` is uint8 [I//2, O].
Within each 128-channel input group, channel k (k < 64) shares a byte with
channel k + 64: low nibble = q[g*128 + k], high nibble = q[g*128 + 64 + k].
This is not the AWQ nibble order. 8-bit weights are stored as uint8 [I, O].

The native-int4 kernel (`kernels/rot_matmul.py::rot_w4_matmul_i4`, K9)
reads another layout. JAX stores its weight as a `jnp.uint4 [I, O]` array,
and torch has no arithmetic on 4-bit types, so the port packs it as uint8
[I//2, O] in the interleaved ("native") order: byte row k holds channel 2k
in its low nibble and channel 2k + 1 in its high nibble, the same bytes as
JAX's array (`pack_w4_i4`, `unpack_w4_i4`; `convert/interop.py::w4_i4_from_jax`
takes JAX's array).

2. **AWQ layout** (interchange with the reference's checkpoints): int32
[R, C//8], 8 nibbles along the output dim in the order (0, 2, 4, 6, 1, 3,
5, 7). `pack_awq` / `unpack_awq` take and return numpy arrays, as JAX's
do: they are host-side checkpoint code.

Packing runs on whatever device the input lies on, so a model quantized on
the card is packed there. As in JAX, a host input of 1 MB or more (a numpy
array or a CPU tensor; an AWQ input to unpack of 128 KB or more) goes
through the native packer (`ops/native_packing.py`, C++ with OpenMP) when
it builds, with the same bits as the numpy path.
"""

from __future__ import annotations

import numpy as np
import torch


AWQ_REORDER = (0, 2, 4, 6, 1, 3, 5, 7)

_NATIVE_MIN_BYTES = 1 << 20  # use the C++ path for >= 1 MB host tensors


def _as_tensor(q) -> torch.Tensor:
    return q if isinstance(q, torch.Tensor) else torch.from_numpy(np.asarray(q))


def _nbytes(q) -> int:
    return q.numel() * q.element_size() if isinstance(q, torch.Tensor) else np.asarray(q).nbytes


def pack_w4_tpu(q, group_size: int = 128) -> torch.Tensor:
    """q int [I, O] in [0,16) -> uint8 [I//2, O] (group-aligned half-split)."""
    I, O = q.shape
    if I % group_size:
        raise ValueError(f"in_features {I} is not a multiple of group_size {group_size}")
    on_host = not isinstance(q, torch.Tensor) or q.device.type == "cpu"
    if on_host and _nbytes(q) >= _NATIVE_MIN_BYTES:
        from .native_packing import pack_w4_tpu_native

        out = pack_w4_tpu_native(q.numpy() if isinstance(q, torch.Tensor) else q, group_size)
        if out is not None:
            return torch.from_numpy(out)
    q = _as_tensor(q)
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


def pack_w4_i4(q) -> torch.Tensor:
    """q int [I, O] in [0,16) -> uint8 [I//2, O], byte row k = q[2k] | q[2k+1] << 4."""
    q = _as_tensor(q)
    I, O = q.shape
    if I % 2:
        raise ValueError(f"in_features {I} is odd")
    qp = q.reshape(I // 2, 2, O).to(torch.uint8) & 0xF
    return (qp[:, 0] | (qp[:, 1] << 4)).contiguous()


def unpack_w4_i4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [I//2, O] (interleaved) -> int32 [I, O]."""
    p = packed.to(torch.int32)
    return torch.stack([p & 0xF, (p >> 4) & 0xF], dim=1).reshape(2 * p.shape[0], -1)


# ---------------------------------------------------------------------------
# AWQ layout (interchange with reference checkpoints)
# ---------------------------------------------------------------------------


def pack_awq(values: np.ndarray, bits: int = 4) -> np.ndarray:
    """int [R, C] -> int32 [R, C//8] with the AWQ nibble reorder."""
    if bits == 4:
        v = np.asarray(values)
        if v.nbytes >= _NATIVE_MIN_BYTES:
            from .native_packing import pack_awq_native

            out = pack_awq_native(v)
            if out is not None:
                return out
    pack_factor = 32 // bits
    values = np.asarray(values, dtype=np.int64)
    R = values.shape[0]
    reordered = values.reshape(R, -1, pack_factor)[:, :, list(AWQ_REORDER)]
    packed = np.zeros((R, reordered.shape[1]), dtype=np.int64)
    for i in range(pack_factor):
        packed |= (reordered[:, :, i] & 0xF) << (bits * i)
    return packed.astype(np.uint32).view(np.int32)


def unpack_awq(packed: np.ndarray, bits: int = 4) -> np.ndarray:
    """int32 [R, C//8] -> int32 [R, C], undoing the nibble reorder."""
    if bits == 4:
        pk = np.asarray(packed)
        if pk.nbytes >= _NATIVE_MIN_BYTES // 8:
            from .native_packing import unpack_awq_native

            out = unpack_awq_native(pk)
            if out is not None:
                return out
    pack_factor = 32 // bits
    p = np.asarray(packed).view(np.uint32).astype(np.int64)
    R, Cp = p.shape
    out = np.zeros((R, Cp, pack_factor), dtype=np.int32)
    for i in range(pack_factor):
        out[:, :, AWQ_REORDER[i]] = ((p >> (bits * i)) & 0xF).astype(np.int32)
    return out.reshape(R, Cp * pack_factor)
