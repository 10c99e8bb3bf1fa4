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
          out  = sum over chunks c of xr_c @ w_c in f32, in x's dtype.
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

On the card K10 and K12 are variants of K1's one-launch kernel
(csrc/one_launch.cuh): one launch a call, its group splits and column tile
chosen from shapes alone by `one_launch_plan`.

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
from .rot_matmul import (BLOCKS_PER_SM, COLS_PER_TILE, ONE_LAUNCH_MAX_GROUPS,
                         ONE_LAUNCH_SZ_FLOATS, ONE_LAUNCH_TILES, ONE_LAUNCH_X_FLOATS, SZ_CODES,
                         _check_operands, _counters, _group_splits, _raise_on, _sm_count,
                         _unpack_groups, one_launch_row_tile)

KERNELS = ("rot_w4_matmul_b", "dma_rot_w4_matmul", "rot_w4_matmul_v2", "w4a8_matmul")
launch_counts = {name: 0 for name in KERNELS}
BLOCK_MS = (8, 16)  # K10/K12: the JAX scripts' rows per block (see one_launch_plan)
DMA_ROWS = 8  # K11: the rows one block carries (one where M = 1)
MAX_SMEM_BYTES = 227 * 1024  # shared memory a block can use on the H100

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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).to(F32)


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
    M = x.shape[0]
    G, S, _ = rot.shape
    O = qweight.shape[1]
    _check_chunks(G, Gb)
    xr = _bf16(_rotate(_bf16(x.to(F32)).reshape(M, G, S), _bf16(rot.to(F32))))
    s = _bf16(scales.to(F32))[:, None, :]
    z = _bf16(zeros.to(F32))[:, None, :]
    w = _bf16(_bf16(_unpack_groups(qweight, G, S) - z) * s)  # [G, S, O]
    n = G // Gb
    parts = torch.einsum("mck,cko->mco", xr.reshape(M, n, Gb * S), w.reshape(n, Gb * S, O))
    acc = torch.zeros((M, O), dtype=F32, device=x.device)
    for c in range(n):  # the chunks in order, as the kernel's fori_loop sums them
        acc = acc + parts[:, c]
    return acc.to(x.dtype)


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
    "paro_dma_rot_w4_matmul": [_P] * 6 + [_I] * 9,
    "paro_rot_w4_matmul_v2": [_P] * 8 + [_I] * 10,
    "paro_w4a8_matmul": [_P] * 5 + [_I] * 7,
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


def _check_rot(rot, G: int, S: int):
    if tuple(rot.shape) != (G, S, S):
        raise ValueError(f"rot must be [G, S, S], got {tuple(rot.shape)}")
    if rot.dtype not in (F32, BF16):
        raise TypeError(f"rot must be float32 or bfloat16, got {rot.dtype}")


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _smem_bytes(bm: int, G: int, S: int, Gb: int) -> int:
    """K11's shared memory per block (`smem_layout` in the CUDA source): its
    two weight stages, the rotated rows in bf16, one group of x, the tile's
    partials, the chunk's scales and zeros."""
    return sum(_align16(n) for n in (
        2 * Gb * (S // 2) * 32, bm * G * (S + 2) * 2, bm * S * 4, 8 * bm * 32 * 4, Gb * 2 * 32 * 4))


def _row_tile(M: int, S: int) -> int:
    """Rows per block of K10/K12 (`row_tile` in csrc/one_launch.cuh): K1's
    row tile for M (1, 2, 4 or 8), halved while one group of that many rows
    exceeds ONE_LAUNCH_X_FLOATS."""
    mt = one_launch_row_tile(M)
    while mt > 1 and mt * S > ONE_LAUNCH_X_FLOATS:
        mt //= 2
    return mt


def _one_launch_smem(mt: int, S: int, gps: int, tile: int) -> int:
    """K10/K12's shared memory per block (`layout` in csrc/one_launch.cuh):
    the 8 x 4 KB weight ring, then x and xr, the scales and zeros and the
    row sums in floats; the warps' sums reuse it."""
    a4 = lambda n: (n + 3) & ~3
    body = 8 * 4096 + 4 * (2 * a4(gps * mt * S) + 2 * gps * tile + a4(gps * mt))
    return max(body, 4 * 8 * mt * 128)


def one_launch_plan(M: int, I: int, S: int, O: int, sms: int) -> tuple[int, int, int]:
    """K10/K12's launch on a card of `sms` SMs, from shapes alone: (KS group
    splits, column-tile width, rows per block).

    Rows per block: `_row_tile(M, S)`. Where one wave of BLOCKS_PER_SM
    blocks an SM can hold the grid, the tile of 128, 256 or 512 columns
    whose most splits that fit the wave leave the fewest groups a block (at
    most min(16, 4096 // (rows * S), 2048 // tile)), the narrower on a tie:
    every block rotates its own groups, and at 4096 x 4096 one group a block
    (512 columns, 32 splits, M <= 8) took the least time of the splits and
    tiles tried on an H100 (PERF.md §6). Otherwise 128-column tiles and as many splits as fill two
    blocks an SM, each of at most that many groups (one where a group of
    that many rows exceeds 4096 floats), past one wave: the split merge
    never waits on another block. Every split holds at least one group.
    Raises ValueError where one group does not fit a block's shared memory
    (S above about 24,000 channels)."""
    mt = _row_tile(M, S)
    G, rows, wave = I // S, -(-M // mt), BLOCKS_PER_SM * sms
    gmax = lambda tile: max(1, min(ONE_LAUNCH_MAX_GROUPS, ONE_LAUNCH_X_FLOATS // (mt * S),
                                   ONE_LAUNCH_SZ_FLOATS // tile))
    best = None
    for tile in ONE_LAUNCH_TILES:
        ks = min(G, wave // (-(-O // tile) * rows))
        if ks < 1 or -(-G // ks) > gmax(tile):
            continue
        gps = -(-G // ks)
        if best is None or gps < best[0]:
            best = (gps, -(-G // gps), tile)
    if best is None:
        tile = COLS_PER_TILE
        ks = _group_splits(-(-O // tile), rows, G, sms, gmax(tile))
        best = (-(-G // ks), ks, tile)
    gps, ks, tile = best
    if _one_launch_smem(mt, S, gps, tile) > MAX_SMEM_BYTES:
        raise ValueError(f"a group of {S} channels does not fit one block's shared memory")
    return ks, tile, mt


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
    """K11: K10's operands, the weight streamed in chunks of Gb groups; G
    must be a multiple of Gb. -> [M, O] in x.dtype."""
    G, S, _ = rot.shape
    _check_chunks(G, Gb)
    if x.device.type == "cpu":
        return dma_rot_w4_matmul_plain(x, rot, qweight, scales, zeros, Gb=Gb)
    _check_rot(rot, G, S)
    M, I = x.shape
    O = qweight.shape[1]
    if _smem_bytes(1 if M == 1 else DMA_ROWS, G, S, Gb) > MAX_SMEM_BYTES:
        raise ValueError(f"{G} groups of {S} channels in chunks of {Gb} do not fit shared memory")
    x, qweight, scales, zeros, (rot,) = _check_operands(x, qweight, scales, zeros, S, G, (rot,))
    out = torch.empty((M, O), dtype=x.dtype, device=x.device)
    err = _lib_fn("paro_dma_rot_w4_matmul")(
        x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), M, I, S, O, Gb, int(x.dtype == BF16), int(rot.dtype == BF16),
        SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype], _stream(x.device))
    _raise_on(err, "dma_rot_w4_matmul")
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
    [I//group_size, O] -> [M, O] in x.dtype."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, qweight, scales, zeros, group_size=group_size)
    M, I = x.shape
    S = group_size
    G, O = I // S if S else 0, qweight.shape[1]
    if S % 8:  # the int8 dot packs four channels of each half-group
        raise ValueError(f"the CUDA kernel takes group sizes that are multiples of 8, got {S}")
    if 8 * 8 * (32 * 4 + S) > MAX_SMEM_BYTES:  # per warp and row: the int8 group, partials
        raise ValueError(f"groups of {S} channels do not fit shared memory")
    x, qweight, scales, zeros, _ = _check_operands(x, qweight, scales, zeros, S, G)
    out = torch.empty((M, O), dtype=x.dtype, device=x.device)
    err = _lib_fn("paro_w4a8_matmul")(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
        M, I, S, O, int(x.dtype == BF16), SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype],
        _stream(x.device))
    _raise_on(err, "w4a8_matmul")
    launch_counts["w4a8_matmul"] += 1
    return out
