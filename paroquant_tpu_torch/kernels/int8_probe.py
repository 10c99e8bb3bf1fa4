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

On the card K15, K16 and K17 stream B through a `cp.async` ring into
`mma.sync` in one launch, out^T = B^T A^T (K15 s8 x s8 -> s32, its B stage
transposed by byte permutes on the way out; K16 the same kernel over w's
S/2 byte-rows, each byte unpacked after the transpose into two rows of the
dot; K17 bf16 x bf16 -> f32, its ring read with the L2 policy evict_first),
their K splits merged in split order by the last block of each tile
(`int8_plan`, `fused_plan`, `bf16_plan`). A wrapper launches the CUDA
kernel for tensors on a CUDA device and runs the plain PyTorch version for
tensors on the CPU (the counterpart of the Pallas interpreter). A failed
build or launch raises; nothing falls back. Each CUDA call adds one to
`launch_counts[name]`. `empty_kernel` launches a kernel that does nothing,
to time what the harness charges a launch; it counts nowhere.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .rot_matmul import BLOCKS_PER_SM, MAX_SMEM_BYTES, _counters, _raise_on, _sm_count

KERNELS = ("narrow_cast", "int8_dot", "fused_unpack_int8_dot", "bf16_dot")
launch_counts = {name: 0 for name in KERNELS}
# K15 and K16 (csrc/int8_probe.cu, int8_stream_kernel): a block's columns of
# B, its K rows (K16: byte-rows of w) a ring stage, the ring's stages and its
# shared rows of A's padding in bytes; the rows of A a block takes are K17's
# (one, two or four n8 tiles)
INT8_TILE_N, INT8_CHUNK_K, INT8_STAGES, INT8_PAD = 128, 128, 4, 16
# K17 (csrc/int8_probe.cu, bf16_dot_kernel): a block's columns of B, its K
# rows a ring stage, the ring's stages, the rows of A it takes (one, two or
# four n8 tiles of the mma) and its shared rows' padding in bf16
BF16_TILE_N, BF16_CHUNK_K, BF16_STAGES = 128, 64, 4
BF16_ROWS = (8, 16, 32)
BF16_PAD = 8

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


def bf16_smem(rows: int) -> int:
    """K17's dynamic shared memory a block for `rows` rows of A: its ring of
    BF16_STAGES stages of B's 64 x 128 and A's rows x 64 bf16, each row
    padded by BF16_PAD (`bf_stage` in csrc/int8_probe.cu)."""
    return BF16_STAGES * 2 * (BF16_CHUNK_K * (BF16_TILE_N + BF16_PAD)
                              + rows * (BF16_CHUNK_K + BF16_PAD))


def int8_smem(rows: int) -> int:
    """K15's dynamic shared memory a block for `rows` rows of A: its ring of
    INT8_STAGES stages of B's 128 x 128 and A's rows x 128 bytes, A's rows
    padded by INT8_PAD (`i8_stage` in csrc/int8_probe.cu)."""
    return INT8_STAGES * (INT8_CHUNK_K * INT8_TILE_N + rows * (INT8_CHUNK_K + INT8_PAD))


def fused_smem(rows: int) -> int:
    """K16's dynamic shared memory a block: K15's ring with two padded rows
    of x a row, one for each half of its columns (`i8_stage(nm, true)`)."""
    return int8_smem(2 * rows)


def _one_wave(M: int, K: int, N: int, sms: int, tile_n: int, chunk_k: int,
              smem) -> tuple[int, int, int]:
    """(K splits, chunks of chunk_k rows a split, rows of A a block) of a
    streaming dot whose block takes the least of BF16_ROWS that holds M (32
    past it: more row tiles) and tile_n columns of B: as many splits as fill
    one wave of one block an SM, at most one a chunk, every split non-empty.
    Raises ValueError where two blocks (the kernels' launch bound) of
    smem(rows) bytes do not fit an SM's shared memory."""
    rows = next((r for r in BF16_ROWS if r >= M), BF16_ROWS[-1])
    if BLOCKS_PER_SM * smem(rows) > MAX_SMEM_BYTES:
        raise ValueError(f"the ring at {rows} rows does not fit two blocks an SM")
    tiles = -(-N // tile_n) * -(-M // rows)
    chunks = -(-K // chunk_k)
    per = -(-chunks // max(1, min(chunks, sms // tiles)))
    return -(-chunks // per), per, rows


def bf16_plan(M: int, K: int, N: int, sms: int) -> tuple[int, int, int]:
    """K17's launch on a card of `sms` SMs, from shapes alone: (K splits,
    chunks of BF16_CHUNK_K rows a split, rows of A a block), `_one_wave`'s
    rule with 128-column tiles. At 8 x 4096 x 4096: 4 splits of 16 chunks,
    128 blocks (on an H100 that beat 8 splits, two blocks an SM, at M 1, 8,
    16 and 32: PERF.md §6). Its rings take at most 88 KB a block."""
    return _one_wave(M, K, N, sms, BF16_TILE_N, BF16_CHUNK_K, bf16_smem)


def int8_plan(M: int, K: int, N: int, sms: int) -> tuple[int, int, int]:
    """K15's launch on a card of `sms` SMs, from shapes alone: (K splits,
    chunks of INT8_CHUNK_K rows a split, rows of A a block), K17's rule with
    its 128-column tiles and 128-row chunks. At 8 x 4096 x 4096: 4 splits of
    8 chunks, 128 blocks. Its rings take at most 84 KB a block."""
    return _one_wave(M, K, N, sms, INT8_TILE_N, INT8_CHUNK_K, int8_smem)


def fused_plan(M: int, S: int, O: int, sms: int) -> tuple[int, int, int]:
    """K16's launch on a card of `sms` SMs, from shapes alone: (K splits,
    chunks of INT8_CHUNK_K byte-rows of w a split, rows of x a block), K15's
    rule over w's S/2 byte-rows. At the probe's 8 x 256 -> 512: one split, 4
    blocks; at 8 x 4096 -> 4096: 4 splits of 4 chunks, 128 blocks. Its rings
    take at most 100 KB a block."""
    return _one_wave(M, S // 2, O, sms, INT8_TILE_N, INT8_CHUNK_K, fused_smem)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # entry point: argument types (all in csrc/int8_probe.cu)
    "paro_narrow_cast": [_P, _P, _L],
    "paro_int8_dot": [_P] * 5 + [_I] * 6,
    "paro_fused_unpack_int8_dot": [_P] * 5 + [_I] * 6,
    "paro_bf16_dot": [_P] * 5 + [_I] * 6,
    "paro_empty": [],
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


def _launch_stream(name, entry, a, b, plan, tile_n, out_dtype):
    """K15 / K16 / K17: one launch of a streaming dot by `plan` (int8_plan /
    fused_plan / bf16_plan, given a's [M, K] and b's N) with its partials
    and counters where K is split."""
    a, b = _on_card(a, b)
    (M, K), N = a.shape, b.shape[1]
    fn = _lib_fn(entry)  # before the device is queried
    dev = a.device
    split, per, rows = plan(M, K, N, _sm_count(dev))
    n_tiles = -(-N // tile_n)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    part = torch.empty((split, M, n_tiles * tile_n) if split > 1 else (0,), dtype=out_dtype,
                       device=dev)
    counters = _counters(n_tiles * -(-M // rows), dev) if split > 1 else part
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
             M, K, N, per, split, rows, _stream(dev))
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
    return _launch_stream("int8_dot", "paro_int8_dot", a, b, int8_plan, INT8_TILE_N, I32)


def fused_unpack_int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K16: x int8 [M, S], w uint8 [S/2, O] (S even) -> int32 [M, O], exact."""
    _check_fused(x, w)
    if x.device.type == "cpu":
        return fused_unpack_int8_dot_plain(x, w)
    return _launch_stream("fused_unpack_int8_dot", "paro_fused_unpack_int8_dot", x, w, fused_plan,
                          INT8_TILE_N, I32)


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K17: bf16 [M, K] @ bf16 [K, N] -> float32 [M, N]."""
    _check_dot(a, b, BF16)
    if a.device.type == "cpu":
        return bf16_dot_plain(a, b)
    return _launch_stream("bf16_dot", "paro_bf16_dot", a, b, bf16_plan, BF16_TILE_N, F32)


def empty_kernel(device) -> None:
    """Launch a kernel that does nothing (one block of 32 threads) on
    `device`'s current stream: the launch floor that chip_smoke.py times
    beside K14. Counted nowhere; raises where the launch fails."""
    dev = torch.device(device)
    _raise_on(_lib_fn("paro_empty")(_stream(dev)), "empty_kernel")
