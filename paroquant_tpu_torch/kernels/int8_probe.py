"""The int8 tensor-core probe: CUDA kernels (csrc/int8_probe.cu) and their
plain versions.

Port of the four kernels of `scripts/kernel_int8_probe.py`:

    K14 narrow_cast (`probe_narrow_cast`): int32 [R, C] -> int8  x & 15
    K15 int8_dot (`probe_int8_dot`, the int8 arm of `bench_dots`):
          int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact
    K16 fused_unpack_int8_dot (`probe_fused_unpack_int8_dot`): x int8 [M, S],
          w uint8 [S/2, O]; byte-row r holds channel r in its low nibble and
          channel r + S/2 in its high nibble, each minus 8 (-8..7):
          x @ q -> int32 [M, O], exact. S must be even.
    K17 bf16_dot (the bf16 arm of `bench_dots`):
          bf16 [M, K] @ bf16 [K, N] -> float32 [M, N]

On the card K15/K16 run on the tensor cores with `mma.sync` s8 x s8 -> s32
and K17 with `mma.sync` bf16 x bf16 -> f32; the K range is split across
blocks where the columns alone would not fill the card (`k_splits`). A
wrapper launches the CUDA kernel for tensors on a CUDA device and runs the
plain PyTorch version for tensors on the CPU (the counterpart of the Pallas
interpreter). A failed build or launch raises; nothing falls back. Each
CUDA call adds one to `launch_counts[name]`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .rot_matmul import _raise_on

KERNELS = ("narrow_cast", "int8_dot", "fused_unpack_int8_dot", "bf16_dot")
launch_counts = {name: 0 for name in KERNELS}
TILE_M, TILE_N = 16, 64  # rows and columns of a block's output tile
CHUNK_K = {"int8": 128, "bf16": 64}  # K per stage of a block
TARGET_BLOCKS = 132 * 8  # about eight blocks per SM of the H100

I8, I32, U8, BF16, F32 = torch.int8, torch.int32, torch.uint8, torch.bfloat16, torch.float32


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def narrow_cast_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K14."""
    return (x & 15).to(I8)


def int8_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K15. CUDA has no int32 matmul; float64 is
    exact below 2**53, far above any int8 dot's |sum| (K * 2**14)."""
    return (a.double() @ b.double()).to(I32)


def unpack_nibbles(w: torch.Tensor) -> torch.Tensor:
    """uint8 [S/2, O] -> int8 [S, O]: the low nibbles (rows 0..S/2-1), then
    the high ones, each minus 8."""
    p = w.to(I32)
    return torch.cat([(p & 15) - 8, ((p >> 4) & 15) - 8], dim=0).to(I8)


def fused_unpack_int8_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K16."""
    _check_fused(x, w)
    return int8_dot_plain(x, unpack_nibbles(w))


def bf16_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K17: a float32 matmul of the bf16 values (in
    full float32 on the card while TF32 is off, PyTorch's default)."""
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# Checks and CUDA launch
# ---------------------------------------------------------------------------


def _check_2d(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or t.dim() != 2:
        raise TypeError(f"{what} must be a 2-D {dtype} tensor, got {t.dtype} {tuple(t.shape)}")


def _check_dot(a, b, dtype) -> None:
    _check_2d(a, dtype, "a")
    _check_2d(b, dtype, "b")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not chain")


def _check_fused(x, w) -> None:
    _check_2d(x, I8, "x")
    _check_2d(w, U8, "w")
    S = x.shape[1]
    if S % 2:
        raise ValueError(f"the half-split layout needs an even S, got {S}")
    if w.shape[0] * 2 != S:
        raise ValueError(f"w must be [S/2, O] = [{S // 2}, O], got {tuple(w.shape)}")


def k_splits(M: int, K: int, N: int, kind: str) -> tuple[int, int]:
    """(blocks along K, chunks of CHUNK_K[kind] per block): enough blocks
    that about TARGET_BLOCKS are in flight, and no block without a chunk."""
    chunks = -(-K // CHUNK_K[kind])
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    per = -(-chunks // max(1, min(chunks, TARGET_BLOCKS // tiles)))
    return -(-chunks // per), per


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # entry point: argument types (all in csrc/int8_probe.cu)
    "paro_narrow_cast": [_P, _P, _L],
    "paro_int8_dot": [_P] * 3 + [_I] * 5,
    "paro_fused_unpack_int8_dot": [_P] * 3 + [_I] * 5,
    "paro_bf16_dot": [_P] * 4 + [_I] * 5,
}
_fns: dict[str, object] = {}


def _lib_fn(entry: str):
    if entry not in _fns:
        fn = getattr(load("int8_probe"), entry)
        fn.argtypes = _SIGNATURES[entry] + [_P]  # the stream last
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _on_card(*tensors) -> list[torch.Tensor]:
    """The operands contiguous, after checking that they share a device and
    are not empty."""
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("all operands must be on the same device")
    if any(n < 1 for t in tensors for n in t.shape):
        raise ValueError(f"the CUDA kernels take no empty operand: {[tuple(t.shape) for t in tensors]}")
    return [t.contiguous() for t in tensors]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_int8(name, entry, a, b, M, K, N):
    a, b = _on_card(a, b)
    out = torch.empty((M, N), dtype=I32, device=a.device)
    split, per = k_splits(M, K, N, "int8")
    err = _lib_fn(entry)(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N, per, split,
                         _stream(a.device))
    _raise_on(err, name)
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# Wrappers (the JAX probes' kernels)
# ---------------------------------------------------------------------------


def narrow_cast(x: torch.Tensor) -> torch.Tensor:
    """K14: int32 [R, C] -> int8 [R, C], x & 15."""
    _check_2d(x, I32, "x")
    if x.device.type == "cpu":
        return narrow_cast_plain(x)
    (x,) = _on_card(x)
    out = torch.empty(x.shape, dtype=I8, device=x.device)
    err = _lib_fn("paro_narrow_cast")(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x.device))
    _raise_on(err, "narrow_cast")
    launch_counts["narrow_cast"] += 1
    return out


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K15: int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact."""
    _check_dot(a, b, I8)
    if a.device.type == "cpu":
        return int8_dot_plain(a, b)
    (M, K), N = a.shape, b.shape[1]
    return _launch_int8("int8_dot", "paro_int8_dot", a, b, M, K, N)


def fused_unpack_int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K16: x int8 [M, S], w uint8 [S/2, O] (S even) -> int32 [M, O], exact."""
    _check_fused(x, w)
    if x.device.type == "cpu":
        return fused_unpack_int8_dot_plain(x, w)
    (M, S), O = x.shape, w.shape[1]
    return _launch_int8("fused_unpack_int8_dot", "paro_fused_unpack_int8_dot", x, w, M, S, O)


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K17: bf16 [M, K] @ bf16 [K, N] -> float32 [M, N]."""
    _check_dot(a, b, BF16)
    if a.device.type == "cpu":
        return bf16_dot_plain(a, b)
    a, b = _on_card(a, b)
    (M, K), N = a.shape, b.shape[1]
    split, per = k_splits(M, K, N, "bf16")
    out = torch.empty((M, N), dtype=F32, device=a.device)
    part = torch.empty((split if split > 1 else 0, M, N), dtype=F32, device=a.device)
    err = _lib_fn("paro_bf16_dot")(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(),
                                   M, K, N, per, split, _stream(a.device))
    _raise_on(err, "bf16_dot")
    launch_counts["bf16_dot"] += 1
    return out
