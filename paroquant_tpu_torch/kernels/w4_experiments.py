"""The W4 GEMV design experiments: CUDA kernels (csrc/w4_experiments.cu) and
their plain versions.

Port of the kernels of four TPU experiment scripts (x [M, I]; rot M_g
[G, S, S]; q_g the nibbles 0..15 of group g from the half-split uint8
[I//2, O] weight; s_g, z_g rows g of scales and zeros [G, O]):

    K10 rot_w4_matmul_b (`scripts/kernel_edge_test.py`), one launch:
          xr32_g = f32(x_g in rot's dtype) @ M_g^T,   xr_g = bf16(xr32_g)
          out    = sum_g (xr_g @ q_g - rowsum(xr32_g) * z_g) * s_g
        the row sum taken over the unrounded xr32 (K1 sums the rounded xr);
        out in x's dtype.
    K11 dma_rot_w4_matmul (`scripts/kernel_dma_pipeline.py`), the weight
        streamed in chunks of Gb groups; s and z rounded to bf16 first:
          xr_g = bf16(bf16(x_g) @ bf16(M_g)^T),   w_g = bf16(bf16(q_g - z_g) * s_g)
          out  = sum over chunks c of xr_c @ w_c in f32, in x's dtype:
        K8's function (`rot_matmul.dequant_chunks_plain`) in chunks of Gb.
        G must be a multiple of Gb (the JAX kernel drops the last G mod Gb
        groups; the port refuses them).
    K12 rot_w4_matmul_v2 (`scripts/kernel_tune.py`):
          xr_g = bf16(f32(x_g) @ f32(M_g)^T)
          out  = sum_g (xr_g @ q_g - rowsum(xr_g) * z_g) * s_g   in float32
        whatever x's dtype.
    K13 w4a8_matmul (`scripts/kernel_w4a8_exp.py`), no rotation; per
        (row, group of group_size channels):
          sx  = max|x_g| / 127 (1 where the max is 0),  xq = round_half_even(x_g / sx)
          out = sum_g (xq . q_g - sum(xq) * z_g) * (s_g * sx)
        with xq . q_g exact in int32, (s_g * sx) formed first, and the sum
        over g taken in order in f32; out in x's dtype.

On the card K10, K12, K13 and K11 are variants of K1's one-launch kernel
(csrc/one_launch.cuh): one launch a call, its group splits and column tile
chosen from shapes alone by `one_launch_plan` (K13, the A8 variant:
`a8_plan`), or for K11 (the DQ variant, csrc/rot_w4_dequant.cu, shared with
K8) by `rot_matmul.dq_plan`, whose splits never cross a chunk of groups.

Scales and zeros come in float32, bfloat16, float16 or uint8. A wrapper
launches the CUDA kernel for tensors on a CUDA device and runs the plain
PyTorch version for tensors on the CPU (the counterpart of the Pallas
interpreter). A failed build or launch raises; nothing falls back. Each
CUDA call adds one to `launch_counts[name]`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .rot_matmul import (COLS_PER_TILE, MAX_SMEM_BYTES, SZ_CODES, _bf16, _check_operands,
                         _check_rot, _counters, _one_launch_smem, _raise_on, _row_tile,
                         _sm_count, _unpack_groups, dequant_chunks_plain, dq_plan, launch_dq)

A8_TILES = (512,)  # K13's column tile (csrc/one_launch.cuh A8_TW): two columns a lane

KERNELS = ("rot_w4_matmul_b", "dma_rot_w4_matmul", "rot_w4_matmul_v2", "w4a8_matmul")
launch_counts = {name: 0 for name in KERNELS}
BLOCK_MS = (8, 16)  # K10/K12: the JAX scripts' rows per block (see one_launch_plan)

F32, BF16 = torch.float32, torch.bfloat16


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _rotate(xg: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """xg [M, G, S] f32, rot [G, S, S] f32 -> xg_g @ rot_g^T in f32."""
    return torch.einsum("mgj,gij->mgi", xg, rot)


def rot_w4_matmul_b_plain(x, rot, qweight, scales, zeros) -> torch.Tensor:
    """Plain PyTorch version of K10 (`_kernel_b`): [M, I] -> [M, O] in x.dtype."""
    M = x.shape[0]
    G, S, _ = rot.shape
    xr32 = _rotate(x.to(rot.dtype).to(F32).reshape(M, G, S), rot.to(F32))
    acc = torch.einsum("mgk,gko->mgo", _bf16(xr32), _unpack_groups(qweight, G, S))
    contrib = (acc - xr32.sum(-1, keepdim=True) * zeros.to(F32)) * scales.to(F32)
    return contrib.sum(dim=1).to(x.dtype)


def _check_chunks(G: int, Gb: int) -> None:
    if Gb < 1 or G % Gb:
        raise ValueError(f"{G} groups do not split into chunks of Gb = {Gb} "
                         "(the JAX kernel would drop the last G mod Gb groups)")


def dma_rot_w4_matmul_plain(x, rot, qweight, scales, zeros, *, Gb: int = 4) -> torch.Tensor:
    """Plain PyTorch version of K11 (`_kernel_dma`): [M, I] -> [M, O] in x.dtype."""
    _check_chunks(rot.shape[0], Gb)
    return dequant_chunks_plain(x, rot, qweight, scales, zeros, Gb)


def rot_w4_matmul_v2_plain(x, rot, qweight, scales_f16, zeros_u8) -> torch.Tensor:
    """Plain PyTorch version of K12 (`_kernel_v2`): [M, I] -> float32 [M, O]."""
    M = x.shape[0]
    G, S, _ = rot.shape
    xr = _bf16(_rotate(x.to(F32).reshape(M, G, S), rot.to(F32)))
    acc = torch.einsum("mgk,gko->mgo", xr, _unpack_groups(qweight, G, S))
    contrib = (acc - xr.sum(-1, keepdim=True) * zeros_u8.to(F32)) * scales_f16.to(F32)
    return contrib.sum(dim=1)


def w4a8_matmul_plain(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """Plain PyTorch version of K13 (`_w4a8_kernel`): [M, I] -> [M, O] in x.dtype."""
    M, I = x.shape
    G = I // group_size
    xg = x.to(F32).reshape(M, G, group_size)
    amax = xg.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can move sx by an ulp and flip an int8 value
    sx = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    xq = torch.round(xg / sx)  # half to even; integer values, so the dot below is exact
    dot = torch.einsum("mgk,gko->mgo", xq, _unpack_groups(qweight, G, group_size))
    contrib = (dot - xq.sum(-1, keepdim=True) * zeros.to(F32)) * (scales.to(F32) * sx)
    out = contrib[:, 0]
    for g in range(1, G):  # in order, as the kernel's output block accumulates
        out = out + contrib[:, g]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # entry point: argument types (all in csrc/w4_experiments.cu)
    "paro_rot_w4_matmul_b": [_P] * 8 + [_I] * 10,
    "paro_rot_w4_matmul_v2": [_P] * 8 + [_I] * 10,
    "paro_w4a8_matmul": [_P] * 7 + [_I] * 9,
}
_fns: dict[str, object] = {}


def _lib_fn(entry: str):
    if entry not in _fns:
        fn = getattr(load("w4_experiments"), entry)
        fn.argtypes = _SIGNATURES[entry] + [_P]  # the stream last
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def one_launch_plan(M: int, I: int, S: int, O: int, sms: int) -> tuple[int, int, int]:
    """K10/K12's launch on a card of `sms` SMs: `rot_matmul.dq_plan` with
    all G groups one chunk and 128-column tiles past one wave (the wider
    tiles there were timed for K8 only), (KS group splits of ceil(G / KS)
    groups, column-tile width, rows per block)."""
    return dq_plan(M, I, S, O, sms, I // S, wide_past_wave=False)[:3]


def a8_plan(M: int, I: int, S: int, O: int, sms: int) -> tuple[int, int, int]:
    """K13's launch on a card of `sms` SMs: `one_launch_plan` on tiles of
    512 columns (each lane of the A8 variant owns two columns over every
    byte-row), a block's scales of x counted in its shared memory. At 4096 x
    4096 and M <= 8: one group a split, one wave; M 32: four groups a
    split."""
    mt = _row_tile(M, S)
    return dq_plan(M, I, S, O, sms, I // S, wide_past_wave=False, tiles=A8_TILES,
                   group_floats=mt)[:3]


def _launch_fused(name, entry, x, rot, qweight, scales, zeros, block_m, out_dtype):
    """K10 / K12 on the card: one launch of the one-launch kernel's variant."""
    M, I = x.shape
    G, S, _ = rot.shape
    O = qweight.shape[1]
    _check_rot(rot, G, S)
    if block_m not in BLOCK_MS:
        raise ValueError(f"block_m must be one of {BLOCK_MS}, got {block_m}")
    x, qweight, scales, zeros, (rot,) = _check_operands(x, qweight, scales, zeros, S, G, (rot,))
    fn = _lib_fn(entry)  # before the device is queried
    dev = x.device
    KS, tile, mt = one_launch_plan(M, I, S, O, _sm_count(dev))
    out = torch.empty((M, O), dtype=out_dtype or x.dtype, device=dev)
    partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=F32, device=dev)
    counters = _counters(-(-O // tile) * -(-M // mt), dev) if KS > 1 else partial
    err = fn(
        x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), partial.data_ptr(), counters.data_ptr(), M, I, S, O, KS,
        tile // COLS_PER_TILE, int(x.dtype == BF16), int(rot.dtype == BF16),
        SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype], _stream(dev))
    _raise_on(err, name)
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# Wrappers (the JAX scripts' signatures without the TPU-only knobs)
# ---------------------------------------------------------------------------


def rot_w4_matmul_b(x, rot, qweight, scales, zeros, *, block_m: int = 16) -> torch.Tensor:
    """K10: x [M, I]; rot [G, S, S]; qweight uint8 [I//2, O]; scales, zeros
    [G, O] -> [M, O] in x.dtype. block_m (8 or 16), the JAX script's rows
    per block, is checked and changes nothing: on the card a block carries
    `_row_tile(M, S)` rows (M = 1: one; M 9-16 and block_m 16's
    sixteen rows: two row tiles of 8 in the one launch; M > 16: ceil(M / 8)
    row tiles), on the CPU the plain version runs."""
    if x.device.type == "cpu":
        return rot_w4_matmul_b_plain(x, rot, qweight, scales, zeros)
    return _launch_fused("rot_w4_matmul_b", "paro_rot_w4_matmul_b", x, rot, qweight, scales,
                         zeros, block_m, None)


def dma_rot_w4_matmul(x, rot, qweight, scales, zeros, *, Gb: int = 4) -> torch.Tensor:
    """K11: K10's operands, the dot summed over chunks of Gb groups in order;
    G must be a multiple of Gb. -> [M, O] in x.dtype. On the card the DQ
    variant of the one-launch kernel, at every M (`rot_matmul.dq_plan`)."""
    _check_chunks(rot.shape[0], Gb)
    if x.device.type == "cpu":
        return dma_rot_w4_matmul_plain(x, rot, qweight, scales, zeros, Gb=Gb)
    out = launch_dq("dma_rot_w4_matmul", x, rot, qweight, scales, zeros, Gb)
    launch_counts["dma_rot_w4_matmul"] += 1
    return out


def rot_w4_matmul_v2(x, rot, qweight, scales_f16, zeros_u8, *, block_m: int = 8) -> torch.Tensor:
    """K12: K10's operands (scales and zeros in any of the four dtypes,
    whatever their names say) -> float32 [M, O]. block_m (8 or 16) is
    checked and changes nothing, as K10's. The JAX kernel's `semantics` flag, a
    Mosaic `dimension_semantics` hint for the TPU's grid, has no
    counterpart on the card and is not taken."""
    if x.device.type == "cpu":
        return rot_w4_matmul_v2_plain(x, rot, qweight, scales_f16, zeros_u8)
    return _launch_fused("rot_w4_matmul_v2", "paro_rot_w4_matmul_v2", x, rot, qweight,
                         scales_f16, zeros_u8, block_m, F32)


def w4a8_matmul(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """K13: x [M, I]; qweight uint8 [I//2, O] half-split; scales, zeros
    [I//group_size, O] -> [M, O] in x.dtype. On the card the A8 variant of
    the one-launch kernel at every M (`a8_plan`); a group too wide for one
    block's shared memory (about 24,000 channels) raises ValueError."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, qweight, scales, zeros, group_size=group_size)
    M, I = x.shape
    S = group_size
    G, O = I // S if S else 0, qweight.shape[1]
    x, qweight, scales, zeros, _ = _check_operands(x, qweight, scales, zeros, S, G)
    fn = _lib_fn("paro_w4a8_matmul")  # before the device is queried
    dev = x.device
    KS, tile, mt = a8_plan(M, I, S, O, _sm_count(dev))
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=F32, device=dev)
    counters = _counters(-(-O // tile) * -(-M // mt), dev) if KS > 1 else partial
    err = fn(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
        partial.data_ptr(), counters.data_ptr(), M, I, S, O, KS, tile // COLS_PER_TILE,
        int(x.dtype == BF16), SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype], _stream(dev))
    _raise_on(err, "w4a8_matmul")
    launch_counts["w4a8_matmul"] += 1
    return out
