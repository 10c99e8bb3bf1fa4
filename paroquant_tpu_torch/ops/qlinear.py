"""Runtime quantized linear: rotation + INT4 dequant + matmul, in torch.

Counterpart of `paroquant_tpu/ops/qlinear.py`:

    y = rotate(x * inv_channel_scales) @ dequant(qweight)        (+ bias)

with the per-group rotation matrices composed at load time and the inverse
channel scales folded in, so y[., o] = sum_g (x_g @ M_g^T) @ (q_g - z_g) * s_g.

Execution modes (`mode`), the same names as the JAX package:
  - "fused": the hand-written kernel (kernels/rot_matmul.py): CUDA on the
    card; on the CPU its plain PyTorch version, the port's counterpart of the
    Pallas interpreter.
  - "xla":   rotation einsum, then a matmul on the dequantized weight (the
    name is kept; here it is plain torch).
  - "w4a8":  like "auto", with the int8-activation kernel at small M.
  - "auto":  per-shape choice made from the shapes alone (no host sync).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import rotation as rot_ops
from .packing import pack_wq_tpu, unpack_wq_tpu


class QuantizedLinear(nn.Module):
    """One quantized linear layer; its tensors are buffers.

      qweight uint8 [I//2, O]   PARO-TPU packed int4 (ops/packing.py)
      scales  bf16  [G, O]      per-group dequant scales
      zeros   bf16  [G, O]      per-group rounded zero points (exact in bf16)
      rot     bf16  [G, S, S]   rotation matrices with 1/channel_scale folded in
      bias    f32   [O] | None
    """

    def __init__(self, qweight, scales, zeros, rot, bias=None):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("scales", scales)
        self.register_buffer("zeros", zeros)
        self.register_buffer("rot", rot)
        self.register_buffer("bias", bias)

    @property
    def group_size(self) -> int:
        return self.rot.shape[-1]

    @property
    def in_features(self) -> int:
        return self.scales.shape[0] * self.group_size

    @property
    def out_features(self) -> int:
        return self.qweight.shape[1]

    def forward(self, x: torch.Tensor, mode: str = "xla") -> torch.Tensor:
        return quantized_linear_forward(self, x, mode)


class MergedQuantizedLinear(nn.Module):
    """P projections over the same input, concatenated along O.

    qweight uint8 [I//2, O_tot]; scales, zeros bf16 [G, O_tot]; rot
    [P, G, S, S] (per-partition rotations); bias [O_tot] | None;
    out_splits: per-partition output widths (sum == O_tot).
    """

    def __init__(self, qweight, scales, zeros, rot, bias, out_splits: tuple):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("scales", scales)
        self.register_buffer("zeros", zeros)
        self.register_buffer("rot", rot)
        self.register_buffer("bias", bias)
        self.out_splits = tuple(int(n) for n in out_splits)

    @property
    def group_size(self) -> int:
        return self.rot.shape[-1]

    def forward(self, x: torch.Tensor, mode: str = "xla") -> torch.Tensor:
        return merged_linear_forward(self, x, mode)


def make_quantized_linear(
    q, scales, zeros, pairs, theta, inv_channel_scales, group_size: int,
    bias=None, rot_dtype: torch.dtype = torch.bfloat16, n_bits: int = 4,
    device=None,
) -> QuantizedLinear:
    """Build the runtime layer from interchange-format tensors.

    q int [O, I]; scales/zeros [O, G]; pairs int [K, I]; theta [K, I//2];
    inv_channel_scales [I]. Inputs may be numpy arrays or tensors; the
    layer is built on `device` (default: the device of `q`).
    """
    def t(a, dtype=None):
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return a.to(device=device, dtype=dtype)

    q = t(q)
    device = q.device
    O, I = q.shape
    inv_s = t(inv_channel_scales, torch.float32).reshape(-1, group_size)
    theta = t(theta, torch.float32)
    G = I // group_size
    if not bool(torch.any(theta != 0)):
        # identity rotation (RTN path): M is just diag(inv_s) per group
        eye = torch.eye(group_size, dtype=torch.float32, device=device)
        M = eye.expand(G, group_size, group_size) * inv_s[:, None, :]
    else:
        form = rot_ops.to_permutation_form(pairs, group_size, device)
        R = rot_ops.build_rotation_matrices(theta, form, group_size, dtype=torch.float32)
        M = R * inv_s[:, None, :]  # fold diag(inv_s) on the input side
    return QuantizedLinear(
        qweight=pack_wq_tpu(q.T, n_bits, group_size),
        scales=t(scales, torch.float32).T.to(torch.bfloat16).contiguous(),
        zeros=t(zeros, torch.float32).T.to(torch.bfloat16).contiguous(),
        rot=M.to(rot_dtype).contiguous(),
        bias=None if bias is None else t(bias, torch.float32),
    )


def dequantized_weight(layer, dtype=torch.float32) -> torch.Tensor:
    """Dequantized rotated weight Wd [I, O] (no rotation folded)."""
    G = layer.scales.shape[0]
    S = layer.group_size
    q = unpack_wq_tpu(layer.qweight, G * S, S)  # [I, O]
    qg = q.reshape(G, S, -1).to(torch.float32)
    w = (qg - layer.zeros[:, None, :].to(torch.float32)) * layer.scales[:, None, :].to(torch.float32)
    return w.reshape(q.shape).to(dtype)


def _a8_sim(xr: torch.Tensor) -> torch.Tensor:
    """The kernels' per-(row, group) int8 activation rounding, simulated:
    round(xr / sx) * sx with sx = max|xr| / 127 per row (1 for a zero row)."""
    amax = xr.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(xr / sx) * sx


def _rotated(rot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 rotated activations [N, G, S] of x [..., G*S]."""
    G, S, _ = rot.shape
    xg = x.reshape(-1, G, S).to(torch.float32)
    return torch.einsum("gij,bgj->bgi", rot.to(torch.float32), xg)


def _dot(xr: torch.Tensor, wd: torch.Tensor, dtype, a8: bool) -> torch.Tensor:
    """xr [N, I] @ wd [I, O]: f32 for a8 (as JAX), else in x's dtype (JAX's
    bf16 x bf16 dot with f32 accumulation, cast back to x's dtype)."""
    if a8:
        return xr @ wd
    return xr.to(dtype) @ wd.to(dtype)


def _forward_xla(layer: QuantizedLinear, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
    """Reference forward: einsum rotation then dequant matmul."""
    shape = x.shape
    xr = _rotated(layer.rot, x)
    if a8:
        xr = _a8_sim(xr)
    y = _dot(xr.reshape(xr.shape[0], -1), dequantized_weight(layer), x.dtype, a8)
    return y.reshape(*shape[:-1], -1).to(x.dtype)


def merge_quantized_linears(layers: list[QuantizedLinear]) -> MergedQuantizedLinear:
    """Concatenate same-input QuantizedLinears into one merged layer."""
    if len({l.group_size for l in layers}) != 1 or len({l.scales.shape[0] for l in layers}) != 1:
        raise ValueError("merged layers must share group size and input width")
    bias = None
    if any(l.bias is not None for l in layers):
        bias = torch.cat([
            l.bias if l.bias is not None
            else torch.zeros(l.out_features, dtype=torch.float32, device=l.qweight.device)
            for l in layers
        ])
    return MergedQuantizedLinear(
        qweight=torch.cat([l.qweight for l in layers], dim=1),
        scales=torch.cat([l.scales for l in layers], dim=1),
        zeros=torch.cat([l.zeros for l in layers], dim=1),
        rot=torch.stack([l.rot for l in layers]),
        bias=bias,
        out_splits=tuple(int(l.out_features) for l in layers),
    )


def _merged_forward_xla(
    layer: MergedQuantizedLinear, x: torch.Tensor, a8: bool = False
) -> torch.Tensor:
    shape = x.shape
    wd = dequantized_weight(layer)  # [I, O_tot] f32
    outs, off = [], 0
    for p, n in enumerate(layer.out_splits):
        xr = _rotated(layer.rot[p], x)
        if a8:
            xr = _a8_sim(xr)
        outs.append(_dot(xr.reshape(xr.shape[0], -1), wd[:, off : off + n], x.dtype, a8))
        off += n
    y = torch.cat(outs, dim=-1)
    return y.reshape(*shape[:-1], -1).to(x.dtype)


# The three dispatch constants keep the JAX package's values, so that `auto`
# picks the same numerics as the reference on every geometry. They were tuned
# on a TPU and have not been re-measured on the H100 (an open question in
# PERF.md); the reasons for each are in the JAX module.
AUTO_FUSED_MAX_M = 128
AUTO_W4A8_MIN_KN = 8 * 1024 * 1024
AUTO_W4A8_MAX_M = 16


def _w4a8_auto_wins(layer) -> bool:
    """True when the matrix's weight count K*N reaches AUTO_W4A8_MIN_KN."""
    k = layer.scales.shape[0] * layer.group_size
    n = int(layer.scales.shape[-1])
    return k * n >= AUTO_W4A8_MIN_KN


def _base_auto(x: torch.Tensor, layer, m: int) -> str:
    """fused-vs-xla resolution by M (no a8)."""
    if x.device.type == "cpu":  # the kernels run on the card
        return "xla"
    # JAX's rule, kept so that both packages pick the same numerics: the
    # Pallas tiling needs S % 128 == 0 unless one group spans the row. Where
    # it says fused and the CUDA kernel lacks the group size, the kernel's
    # wrapper raises NotImplementedError.
    if layer.group_size % 128 != 0 and layer.scales.shape[0] > 1:
        return "xla"
    return "fused" if m <= AUTO_FUSED_MAX_M else "xla"


def _resolve_auto(mode: str, x: torch.Tensor, layer) -> str:
    m = 1
    for d in x.shape[:-1]:
        m *= int(d)
    if mode == "w4a8":
        # the M cut, not kernel availability, decides the numerics: small-M
        # launches that JAX runs unfused run the _a8_sim path
        if m > AUTO_FUSED_MAX_M:
            return "xla"
        return "w4a8_fused" if _base_auto(x, layer, m) == "fused" else "w4a8_xla"
    if mode != "auto":
        return mode
    if m <= AUTO_W4A8_MAX_M and _w4a8_auto_wins(layer):
        return _resolve_auto("w4a8", x, layer)
    return _base_auto(x, layer, m)


def merged_linear_forward(
    layer: MergedQuantizedLinear, x: torch.Tensor, mode: str = "xla"
) -> torch.Tensor:
    """Apply the merged layer to x [..., I] -> [..., O_tot]."""
    mode = _resolve_auto(mode, x, layer)
    if mode in ("fused", "w4a8_fused"):
        from ..kernels.rot_matmul import merged_rot_w4_matmul

        shape = x.shape
        y = merged_rot_w4_matmul(
            x.reshape(-1, shape[-1]), layer.rot, layer.qweight, layer.scales, layer.zeros,
            out_splits=layer.out_splits, a8=mode == "w4a8_fused",
        ).reshape(*shape[:-1], -1).to(x.dtype)
    elif mode in ("xla", "w4a8_xla"):
        y = _merged_forward_xla(layer, x, a8=mode == "w4a8_xla")
    else:
        raise ValueError(f"unknown mode: {mode}")
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    return y


def quantized_linear_forward(
    layer: QuantizedLinear, x: torch.Tensor, mode: str = "xla"
) -> torch.Tensor:
    """Apply the quantized linear to x [..., I] -> [..., O]."""
    mode = _resolve_auto(mode, x, layer)
    if mode in ("xla", "w4a8_xla"):
        y = _forward_xla(layer, x, a8=mode == "w4a8_xla")
    elif mode in ("fused", "w4a8_fused"):
        from ..kernels.rot_matmul import rot_w4_matmul

        shape = x.shape
        y = rot_w4_matmul(
            x.reshape(-1, shape[-1]), layer.rot, layer.qweight, layer.scales, layer.zeros,
            a8=mode == "w4a8_fused",
        ).reshape(*shape[:-1], -1).to(x.dtype)
    else:
        raise ValueError(f"unknown mode: {mode}")
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    return y
