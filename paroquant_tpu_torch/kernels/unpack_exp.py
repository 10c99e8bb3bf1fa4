"""The W4 unpack experiments: CUDA kernels (csrc/unpack_exp.cu) and their
plain versions.

Port of the kernels of `scripts/kernel_unpack_exp.py`, which measure what
the nibble unpack costs in the W4 GEMV (x [M, I]; S = group_size; s_g, z_g
rows g of scales and zeros [G, O]; xr_g = bf16(x_g), xsum_g = rowsum(xr_g)
in f32):

    K18 stream_only: the half-split uint8 [I//2, O] weight streamed in
        blocks of Gb groups; returns float32 [1, O] =
            sum over g < G // Gb, in order, of (qweight[g Gb S/2, :] + x[0, g S])
        (the last G mod Gb groups are read by neither kernel). x is padded
        to 16 rows as in JAX, so M > 16 raises ValueError.
    K19 w4_matmul_bitcast: the output-pair layout uint8 [I, O//2]
        (`scripts.kernel_unpack_exp.pack_w4_opair`); K20 w4_matmul_mulfloor,
        K21 w4_matmul_splitdot (and w4_matmul_splitdot_ce, the same kernel:
        the JAX pair differ only by a TPU cost estimate), K22 w4_matmul_i8:
        the half-split layout. Each computes
            out = sum over g, in order, of (acc_g - xsum_g * z_g) * s_g
        with acc_g the f32 dot of xr_g with the nibbles 0..15 (the split
        bodies as two dots: low nibbles against x[:S/2] of the group, high
        ones against x[S/2:]), rounded to x's dtype. Each plain version
        unpacks the way its Pallas body does; all give the nibbles exactly.

Scales and zeros come in float32, bfloat16, float16 or uint8. A wrapper
launches the CUDA kernel for tensors on a CUDA device and runs the plain
PyTorch version for tensors on the CPU. A failed build or launch raises;
nothing falls back. Each CUDA call adds one to `launch_counts[name]`, the
two splitdot entry points apart.

On the card `unpack_route` picks, from shapes alone, the kernel of each
of K19-K22: at M <= 16, where one group fits a block, one launch of the
one-launch kernel (csrc/one_launch.cuh) on `w4_plan`'s plan, K19 on its BC
variant (csrc/w4_opair.cu: the output-pair layout, the bitcast's
exponent-bias unpack), K20 on its MF variant (csrc/w4_mulfloor.cu: the
bf16 mul-floor unpack), K21 on K6's PL variant (csrc/w4_plain.cu), whose
dot is K21's split dot already (low nibbles against the group's first S/2
channels, high ones against the rest; the scale folded into the nibbles),
and K22 on its WM variant (csrc/w4_wordmask.cu: the mask on whole words);
so the four share one skeleton and differ only by the unpack. Every other
call (M > 16, or a group too wide for a block) takes this file's gemv
(csrc/unpack_exp.cu). Each call adds one to
`unpack_route_counts[name][route]`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .rot_matmul import (COLS_PER_TILE, SZ_CODES, _check_operands, _counters, _group_splits,
                         _raise_on, _sm_count, w4_route)

KERNELS = ("stream_only", "w4_matmul_bitcast", "w4_matmul_mulfloor", "w4_matmul_splitdot_ce",
           "w4_matmul_splitdot", "w4_matmul_i8")
launch_counts = {name: 0 for name in KERNELS}
TM = 16  # the rows of x the JAX kernels' blocks hold
TILE_BYTES = 512  # bytes of a byte-row one CUDA block owns
MODES = {"w4_matmul_mulfloor": 0, "w4_matmul_splitdot_ce": 1, "w4_matmul_splitdot": 1,
         "w4_matmul_i8": 2, "w4_matmul_bitcast": 3}
SINK_KEY = 0x9E3779B9  # K18 writes its scratch word only when its loads fold to this
ONE_LAUNCH_ENTRY = {  # each GEMV's entry into the one-launch kernel, where `unpack_route` sends it
    "w4_matmul_bitcast": "paro_w4_opair_one_launch",  # K19: the BC variant
    "w4_matmul_mulfloor": "paro_w4_mulfloor_one_launch",  # K20: the MF variant
    "w4_matmul_splitdot_ce": "paro_w4_matmul_one_launch",  # K21: K6's PL variant
    "w4_matmul_splitdot": "paro_w4_matmul_one_launch",
    "w4_matmul_i8": "paro_w4_wordmask_one_launch",  # K22: the WM variant
}
ROUTES = ("one_launch", "gemv")
unpack_route_counts = {name: dict.fromkeys(ROUTES, 0) for name in ONE_LAUNCH_ENTRY}

F32, BF16 = torch.float32, torch.bfloat16


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
    for name in ONE_LAUNCH_ENTRY:
        unpack_route_counts[name] = dict.fromkeys(ROUTES, 0)


def unpack_route(M: int, I: int, S: int, O: int, sms: int):
    """The route of K19-K22 on a card of `sms` SMs, from shapes alone:
    ("one_launch", `w4_plan`'s plan (KS splits, column-tile width, rows per
    block, groups per split)) or ("gemv", None). K6's rule
    (`rot_matmul.w4_route`): the one-launch kernel takes M <= 16 rows where
    one group fits a block's shared memory. A group of K19's output-pair
    layout takes a tile's bytes as PL's does, so the plan is K6's (at 4096 x
    4096, M 1: 32 splits of one group, 512 columns, 256 blocks). Every other
    call takes the gemv."""
    route, plan = w4_route(M, I, S, O, sms)
    return ("one_launch", plan) if route == "one_launch" else ("gemv", None)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _check_stream(M: int, G: int, Gb: int) -> None:
    if M > TM:
        raise ValueError(f"stream_only pads x to {TM} rows; it takes M <= {TM}, not {M}")
    if Gb < 1 or G // Gb < 1:
        raise ValueError(f"{G} groups hold no block of groups_per_step = {Gb}")


def stream_only_plain(x, qweight, *, group_size: int = 128, groups_per_step: int = 1):
    """Plain PyTorch version of K18 (`_kernel_stream`): float32 [1, O]."""
    M, I = x.shape
    G, S, Gb = I // group_size, group_size, groups_per_step
    _check_stream(M, G, Gb)
    out = None
    for g in range(G // Gb):  # the grid's steps in order
        row = qweight[g * Gb * S // 2].to(torch.int32).to(F32) + x[0, g * S].to(F32)
        out = row if out is None else out + row
    return out[None]


def _epilogue(x, acc, scales, zeros, S):
    """sum over g, in order, of (acc_g - xsum_g z_g) s_g -> x.dtype; acc [M, G, O]."""
    M, I = x.shape
    xsum = x.to(BF16).to(F32).reshape(M, I // S, S).sum(-1, keepdim=True)
    contrib = (acc - xsum * zeros.to(F32)) * scales.to(F32)
    out = contrib[:, 0]
    for g in range(1, contrib.shape[1]):  # in order, as the output block accumulates
        out = out + contrib[:, g]
    return out.to(x.dtype)


def _split_dot(x, lo, hi, scales, zeros, S):
    """The split bodies: lo, hi [G, S/2, O] f32 nibbles (channels k and S/2 + k)."""
    M, I = x.shape
    xr = x.to(BF16).to(F32).reshape(M, I // S, S)
    acc = (torch.einsum("mgk,gko->mgo", xr[..., : S // 2], lo)
           + torch.einsum("mgk,gko->mgo", xr[..., S // 2 :], hi))
    return _epilogue(x, acc, scales, zeros, S)


def _groups(qweight, S):
    """uint8 [I//2, O] -> [G, S/2, O]."""
    return qweight.reshape(-1, S // 2, qweight.shape[1])


def w4_matmul_splitdot_plain(x, qweight, scales, zeros, *, group_size: int = 128):
    """Plain PyTorch version of K21 (`_kernel_splitdot`): int mask and shift."""
    q = _groups(qweight, group_size).to(torch.int32)
    return _split_dot(x, (q & 0xF).to(F32), ((q >> 4) & 0xF).to(F32), scales, zeros, group_size)


def w4_matmul_mulfloor_plain(x, qweight, scales, zeros, *, group_size: int = 128):
    """Plain PyTorch version of K20 (`_kernel_mulfloor`): bf16 arithmetic,
    exact for the bytes 0..255."""
    f = _groups(qweight, group_size).to(torch.int32).to(BF16)
    hi = torch.floor(f * torch.tensor(0.0625, dtype=BF16))
    lo = f - hi * torch.tensor(16.0, dtype=BF16)
    return _split_dot(x, lo.to(F32), hi.to(F32), scales, zeros, group_size)


def w4_matmul_i8_plain(x, qweight, scales, zeros, *, group_size: int = 128):
    """Plain PyTorch version of K22 (`_kernel_i8`): u8 bitwise, then i8."""
    q = _groups(qweight, group_size)
    lo = (q & 0xF).view(torch.int8).to(BF16).to(F32)
    hi = (q >> 4).view(torch.int8).to(BF16).to(F32)
    return _split_dot(x, lo, hi, scales, zeros, group_size)


def unpack_opair(qweight_opair: torch.Tensor) -> torch.Tensor:
    """uint8 [I, O//2] output pairs -> int32 [I, O] nibbles."""
    p = qweight_opair.to(torch.int32)
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(p.shape[0], -1)


def w4_matmul_bitcast_plain(x, qweight_opair, scales, zeros, *, group_size: int = 128):
    """Plain PyTorch version of K19 (`_kernel_bitcast`): one dot per group."""
    M, I = x.shape
    S = group_size
    w = unpack_opair(qweight_opair).to(F32).reshape(I // S, S, -1)
    acc = torch.einsum("mgk,gko->mgo", x.to(BF16).to(F32).reshape(M, I // S, S), w)
    return _epilogue(x, acc, scales, zeros, S)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # entry point: (source stem, argument types), the stream last
    "paro_unpack_gemv": ("unpack_exp", [_P] * 6 + [_I] * 9 + [_P]),
    "paro_stream_only": ("unpack_exp", [_P] * 4 + [ctypes.c_uint] + [_I] * 6 + [_P]),
    "paro_w4_opair_one_launch": ("w4_opair", [_P] * 7 + [_I] * 9 + [_P]),
    "paro_w4_matmul_one_launch": ("w4_plain", [_P] * 7 + [_I] * 9 + [_P]),
    "paro_w4_mulfloor_one_launch": ("w4_mulfloor", [_P] * 7 + [_I] * 9 + [_P]),
    "paro_w4_wordmask_one_launch": ("w4_wordmask", [_P] * 7 + [_I] * 9 + [_P]),
}
_fns: dict[str, object] = {}


def _lib_fn(entry: str):
    if entry not in _fns:
        stem, argtypes = _SIGNATURES[entry]
        fn = getattr(load(stem), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _launch_gemv(name, x, qweight, scales, zeros, S):
    M, I = x.shape
    G = I // S if S else 0
    opair = name == "w4_matmul_bitcast"
    O = qweight.shape[1] * (2 if opair else 1)
    if opair:
        if qweight.shape[0] != I or I % 2:
            raise ValueError(f"qweight_opair must be [I, O/2] for x {tuple(x.shape)}, "
                             f"got {tuple(qweight.shape)}")
        qweight = qweight.reshape(I // 2, O)  # the same bytes, in the shape the checks take
    x, qweight, scales, zeros, _ = _check_operands(x, qweight, scales, zeros, S, G)
    fns = {"gemv": _lib_fn("paro_unpack_gemv"),  # before the device is queried
           "one_launch": _lib_fn(ONE_LAUNCH_ENTRY[name])}
    dev = x.device
    route, plan = unpack_route(M, I, S, O, _sm_count(dev))
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    sz = (int(x.dtype == BF16), SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype],
          torch.cuda.current_stream(dev).cuda_stream)
    ptrs = (x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr())
    if route == "one_launch":
        KS, tile, mt, _ = plan
        partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=F32, device=dev)
        counters = _counters(-(-O // tile) * -(-M // mt), dev) if KS > 1 else partial
        err = fns[route](*ptrs, partial.data_ptr(), counters.data_ptr(), M, I, S, O, KS,
                         tile // COLS_PER_TILE, *sz)
    else:
        row_bytes = O // 2 if opair else O
        KS = _group_splits(-(-row_bytes // TILE_BYTES), M, G, _sm_count(dev))
        partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=F32, device=dev)
        err = fns[route](*ptrs, partial.data_ptr(), MODES[name], M, I, S, O, KS, *sz)
    _raise_on(err, name)
    launch_counts[name] += 1
    unpack_route_counts[name][route] += 1
    return out


# ---------------------------------------------------------------------------
# Wrappers (the JAX script's names and signatures)
# ---------------------------------------------------------------------------


def stream_only(x, qweight, *, group_size: int = 128, groups_per_step: int = 1) -> torch.Tensor:
    """K18: x [M <= 16, I]; qweight uint8 [I//2, O] -> float32 [1, O]."""
    M, I = x.shape
    S, Gb = group_size, groups_per_step
    G = I // S if S else 0
    _check_stream(M, G, Gb)
    if x.device.type == "cpu":
        return stream_only_plain(x, qweight, group_size=S, groups_per_step=Gb)
    if x.dtype not in (F32, BF16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    O = qweight.shape[1]
    if S < 2 or S % 2 or I != G * S:
        raise ValueError(f"groups of {S} channels do not tile x {tuple(x.shape)}")
    if qweight.dtype != torch.uint8 or qweight.shape[0] * 2 != I:
        raise TypeError(f"qweight must be uint8 [I/2, O], got {qweight.dtype} {tuple(qweight.shape)}")
    if qweight.device != x.device:
        raise ValueError("all operands must be on the same device")
    x, qweight = x.contiguous(), qweight.contiguous()
    dev = x.device
    KS = _group_splits(-(-O // TILE_BYTES), 1, G // Gb, _sm_count(dev))
    out = torch.empty((1, O), dtype=F32, device=dev)
    sink = torch.empty(1, dtype=torch.int32, device=dev)
    err = _lib_fn("paro_stream_only")(
        x.data_ptr(), qweight.data_ptr(), out.data_ptr(), sink.data_ptr(), SINK_KEY, I, S, O, Gb,
        KS, int(x.dtype == BF16), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "stream_only")
    launch_counts["stream_only"] += 1
    return out


def w4_matmul_bitcast(x, qweight_opair, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """K19: x [M, I]; qweight_opair uint8 [I, O//2]; scales, zeros
    [I//group_size, O] -> [M, O] in x.dtype. On the card `unpack_route`
    picks the BC variant of the one-launch kernel or the gemv."""
    if x.device.type == "cpu":
        return w4_matmul_bitcast_plain(x, qweight_opair, scales, zeros, group_size=group_size)
    return _launch_gemv("w4_matmul_bitcast", x, qweight_opair, scales, zeros, group_size)


def w4_matmul_mulfloor(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """K20: x [M, I]; qweight uint8 [I//2, O] half-split; scales, zeros
    [I//group_size, O] -> [M, O] in x.dtype. On the card `unpack_route`
    picks the MF variant of the one-launch kernel or the gemv."""
    if x.device.type == "cpu":
        return w4_matmul_mulfloor_plain(x, qweight, scales, zeros, group_size=group_size)
    return _launch_gemv("w4_matmul_mulfloor", x, qweight, scales, zeros, group_size)


def w4_matmul_splitdot_ce(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """K21 under the name of the JAX call that carries a `pl.CostEstimate`,
    a TPU scheduling hint with no counterpart on the card: K20's operands.
    On the card `unpack_route` picks K6's PL variant of the one-launch kernel
    or the gemv."""
    if x.device.type == "cpu":
        return w4_matmul_splitdot_plain(x, qweight, scales, zeros, group_size=group_size)
    return _launch_gemv("w4_matmul_splitdot_ce", x, qweight, scales, zeros, group_size)


def w4_matmul_splitdot(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """K21: K20's operands. On the card `unpack_route` picks K6's PL variant
    of the one-launch kernel or the gemv."""
    if x.device.type == "cpu":
        return w4_matmul_splitdot_plain(x, qweight, scales, zeros, group_size=group_size)
    return _launch_gemv("w4_matmul_splitdot", x, qweight, scales, zeros, group_size)


def w4_matmul_i8(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """K22: K20's operands. On the card `unpack_route` picks the WM variant
    of the one-launch kernel or the gemv."""
    if x.device.type == "cpu":
        return w4_matmul_i8_plain(x, qweight, scales, zeros, group_size=group_size)
    return _launch_gemv("w4_matmul_i8", x, qweight, scales, zeros, group_size)
