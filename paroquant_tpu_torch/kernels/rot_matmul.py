"""W4 matmuls: CUDA kernels (csrc/rot_w4_matmul.cu, csrc/rot_w4_a8.cu,
csrc/w4_variants.cu, csrc/w4_plain.cu, csrc/rot_w4_dequant.cu) and their
plain versions.

Port of the six kernels of `paroquant_tpu/kernels/rot_matmul.py`:

    K1 rot_w4_matmul, K2 merged_rot_w4_matmul (P <= 4 partitions), each with
       the int8-activation branch (`a8`):
         xr_g = bf16(x_g @ M_g^T)
         out  = sum_g (xr_g @ q_g - rowsum(xr_g) * z_g) * s_g              (W4A16)
         out  = sum_g (xq_g @ q_g - rowsum(xq_g) * z_g) * s_g * sx_g       (a8)
    K6 w4_matmul: K1 without the rotation, xr_g = bf16(x_g)
    K7 butterfly_w4_matmul: xr_g = bf16(K butterfly Givens stages of x_g * inv_s)
    K8 rot_w4_matmul_mg: xr_g = bf16(bf16(x_g) @ bf16(M_g)^T), the weight
       dequantized in bf16, w = bf16(bf16(q - z) * s), out = the sum over
       chunks of groups, in order, of each chunk's dot xr @ w
    K9 rot_w4_matmul_i4: K1 on the interleaved weight layout of
       `ops/packing.py::pack_w4_i4`

The group size S of K1/K2/K6/K9 is any even divisor of I, and scales and
zeros come in float32, bfloat16, float16 or uint8 (K8 rounds them to
bfloat16 first, as JAX's wrapper does). A wrapper launches the CUDA kernel
for tensors on a CUDA device and runs the plain PyTorch version for tensors
on the CPU (the counterpart of the Pallas interpreter). A failed build or
launch raises; nothing falls back. Each CUDA call adds one to
`launch_counts[name]`, and to `sz_counts[name]` under its scales' and
zeros' dtypes.

K1/K2 take one of three routes on the card, chosen before launch from
shapes alone by `rot_route`: "one_launch" (W4A16 at M <= 16: one kernel
that rotates x inside its GEMV blocks and merges its group splits behind a
counter), "ra8" (`a8` at M <= 16: the one-launch kernel's RA8 variant,
csrc/rot_w4_a8.cu, on the plan `ra8_plan`, which past one wave gives each
block a run of column tiles) or "passes" (rotate, GEMV and, with split
groups, reduce). Each call adds one to `route_counts[name][route]`. K8 takes the DQ variant of the
one-launch kernel (csrc/rot_w4_dequant.cu, shared with K11, launched by
`launch_dq` on the plan `dq_plan`) at M <= 16, or the passes, by
`mg_route`; each call adds one to `mg_route_counts[route]`. K7 takes its BF
variant (csrc/w4_variants.cu) at M <= 16 where its tables fit a block, or
the passes, by `bf_route`; each call adds one to `bf_route_counts[route]`.
K9 takes its I4 variant (csrc/w4_variants.cu, on the plan `i4_plan`) at
M <= 16 and S <= 256, or the passes, by `i4_route`; each call adds one to
`i4_route_counts[route]`. K6 takes its PL variant (csrc/w4_plain.cu, on
the plan `w4_plan`) at M <= 16, or the passes, by `w4_route`; each call
adds one to `w4_route_counts[route]`.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.butterfly import butterfly_distances
from .build import load

MAX_PARTS = 4
ROWS_PER_TILE = 8
COLS_PER_TILE = 128
# the one-launch route (csrc/rot_w4_matmul.cu, namespace one)
ONE_LAUNCH_MAX_M = 16
ONE_LAUNCH_MAX_S = 256
ONE_LAUNCH_MAX_GROUPS = 16  # groups per block
ONE_LAUNCH_X_FLOATS = 4096  # x (and xr) a block keeps in shared memory: groups * rows * S
ONE_LAUNCH_SZ_FLOATS = 2048  # scales (and zeros) it keeps: groups * tile width
# K7's tables a block keeps at two blocks an SM: groups * S * (2K + 1) (one
# group may take more, alone)
ONE_LAUNCH_TABLE_FLOATS = 8192
ONE_LAUNCH_ROW_TILES = (1, 2, 4, 8)  # the kernel's instances of rows per block
ONE_LAUNCH_TILES = (128, 256, 512)  # its column-tile widths
RA8_TILE = 512  # RA8's column tile (csrc/one_launch.cuh A8_TW): A8's dot, two columns a lane
BLOCKS_PER_SM = 2  # its blocks resident per SM (registers and shared memory allow two)
MAX_SMEM_BYTES = 227 * 1024  # shared memory a block can use on the H100
MAX_BUTTERFLY_S = 32768  # K7 stages a group's rows in shared memory
SZ_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.uint8: 3}

KERNELS = ("rot_w4_matmul", "merged_rot_w4_matmul", "w4_matmul", "butterfly_w4_matmul",
           "rot_w4_matmul_mg", "rot_w4_matmul_i4")
launch_counts = {name: 0 for name in KERNELS}
# per-variant split of K1/K2's counts (W4A16 vs a8)
variant_counts = {"rot_w4_matmul": [0, 0], "merged_rot_w4_matmul": [0, 0]}
# launches by "scales dtype/zeros dtype", e.g. "float32/uint8"
sz_counts: dict[str, dict[str, int]] = {name: {} for name in KERNELS}
# K1/K2's calls by route (see rot_route); "passes_w4a16_m16" and
# "passes_a8_m16" count those of the passes that were W4A16 or a8 at M <= 16
# (only a W4A16 shape wider than one wave, S > 256, or for a8 S not a
# multiple of 8, sends one there)
ROUTES = ("one_launch", "passes", "passes_w4a16_m16", "ra8", "passes_a8_m16")
route_counts = {name: dict.fromkeys(ROUTES, 0) for name in variant_counts}
# K8's calls by route (see mg_route), K7's (bf_route), K9's (i4_route) and K6's (w4_route)
mg_route_counts = dict.fromkeys(ROUTES[:2], 0)
bf_route_counts = dict.fromkeys(ROUTES[:2], 0)
i4_route_counts = dict.fromkeys(ROUTES[:2], 0)
w4_route_counts = dict.fromkeys(ROUTES[:2], 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
        sz_counts[name] = {}
    for name in variant_counts:
        variant_counts[name] = [0, 0]
        route_counts[name] = dict.fromkeys(ROUTES, 0)
    for route in mg_route_counts:
        mg_route_counts[route] = 0
        bf_route_counts[route] = 0
        i4_route_counts[route] = 0
        w4_route_counts[route] = 0


# ---------------------------------------------------------------------------
# Plain versions (the kernels' decompositions)
# ---------------------------------------------------------------------------


def _unpack_groups(qweight: torch.Tensor, G: int, S: int) -> torch.Tensor:
    """uint8 [I//2, O] -> float32 [G, S, O] nibble values (channel k, then k+S/2)."""
    p = qweight.reshape(G, S // 2, -1).to(torch.int32)
    return torch.cat([p & 0xF, p >> 4], dim=1).to(torch.float32)


def _unpack_interleaved(qweight: torch.Tensor, G: int, S: int) -> torch.Tensor:
    """uint8 [I//2, O] (byte row k: channels 2k, 2k+1) -> float32 [G, S, O]."""
    p = qweight.to(torch.int32)
    q = torch.stack([p & 0xF, p >> 4], dim=1).reshape(G, S, -1)
    return q.to(torch.float32)


def _w4_epilogue(xb, q, scales, zeros):
    """sum_g (xb_g @ q_g - rowsum(xb_g) * z_g) * s_g in f32: xb [M, G, S]
    (bf16 or int8 values in f32), q [G, S, O]."""
    acc = torch.einsum("mgk,gko->mgo", xb, q)
    return (acc - xb.sum(-1, keepdim=True) * zeros.to(torch.float32)) * scales.to(torch.float32)


def _rot_w4_plain_part(x, rot, q, scales, zeros, a8):
    """One partition: x [M, I]; rot [G, S, S]; q [G, S, O] f32; scales/zeros [G, O]."""
    M = x.shape[0]
    G, S, _ = rot.shape
    xg = x.to(rot.dtype).to(torch.float32).reshape(M, G, S)
    xr = torch.einsum("mgj,gij->mgi", xg, rot.to(torch.float32))  # [M, G, S] f32
    if a8:
        amax = xr.abs().amax(dim=-1, keepdim=True)
        sx = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        xq = torch.round(xr / sx)  # integer-valued, so the dot is exact in f32
        return (_w4_epilogue(xq, q, scales, zeros) * sx).sum(dim=1)
    return _w4_epilogue(xr.to(torch.bfloat16).to(torch.float32), q, scales, zeros).sum(dim=1)


def rot_w4_matmul_plain(x, rot, qweight, scales, zeros, *, a8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1: [M, I] -> [M, O] in x.dtype."""
    G, S, _ = rot.shape
    q = _unpack_groups(qweight, G, S)
    return _rot_w4_plain_part(x, rot, q, scales, zeros, a8).to(x.dtype)


def merged_rot_w4_matmul_plain(
    x, rot, qweight, scales, zeros, *, out_splits: tuple, a8: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of K2: partition p rotates x with rot[p] and
    feeds its out_splits[p] columns."""
    P, G, S, _ = rot.shape
    q = _unpack_groups(qweight, G, S)
    outs, off = [], 0
    for p, n in enumerate(out_splits):
        sl = slice(off, off + n)
        outs.append(_rot_w4_plain_part(x, rot[p], q[:, :, sl], scales[:, sl], zeros[:, sl], a8))
        off += n
    return torch.cat(outs, dim=-1).to(x.dtype)


def w4_matmul_plain(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """Plain PyTorch version of K6 (`_kernel_plain`): [M, I] -> [M, O] in x.dtype."""
    M, I = x.shape
    G = I // group_size
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(M, G, group_size)
    q = _unpack_groups(qweight, G, group_size)
    return _w4_epilogue(xb, q, scales, zeros).sum(dim=1).to(x.dtype)


def butterfly_rotate_plain(x, inv_channel_scales, cos_table, sin_table, group_size: int):
    """K7's rotation in f32: x * inv_s, then stage r sets each lane l of a
    group to cos[r, l] x[l] + sin[r, l] x[l ^ d_r]. [M, I] -> [M, G, S]."""
    M, I = x.shape
    G, S = I // group_size, group_size
    xg = (x.to(torch.float32) * inv_channel_scales.to(torch.float32)).reshape(M, G, S)
    K = cos_table.shape[0]
    cos = cos_table.to(torch.float32).reshape(K, G, S)
    sin = sin_table.to(torch.float32).reshape(K, G, S)
    lane = torch.arange(S, device=x.device)
    for r, d in enumerate(butterfly_distances(K, S)):
        xg = cos[r] * xg + sin[r] * xg[..., lane ^ d]
    return xg


def butterfly_w4_matmul_plain(x, inv_channel_scales, cos_table, sin_table, qweight, scales,
                              zeros, *, group_size: int = 128) -> torch.Tensor:
    """Plain PyTorch version of K7 (`_kernel`): [M, I] -> [M, O] in x.dtype."""
    _check_butterfly_group(group_size)
    xr = butterfly_rotate_plain(x, inv_channel_scales, cos_table, sin_table, group_size)
    xb = xr.to(torch.bfloat16).to(torch.float32)
    q = _unpack_groups(qweight, xb.shape[1], group_size)
    return _w4_epilogue(xb, q, scales, zeros).sum(dim=1).to(x.dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t's values rounded to bf16 (nearest even), as float32."""
    return t.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def dequant_chunks_plain(x, rot, qweight, scales, zeros, chunk: int) -> torch.Tensor:
    """K8's and K11's function: x [M, I]; rot [G, S, S]; qweight uint8
    [I//2, O]; scales, zeros [G, O] of any dtype -> [M, O] in x.dtype.

        xr_g = bf16(bf16(x_g) @ bf16(M_g)^T),   w_g = bf16(bf16(q_g - z_g) * s_g)
        out  = the f32 sum over chunks of `chunk` groups (the last may be
               shorter), in order, of each chunk's f32 dot xr @ w

    with s and z rounded to bf16, each bf16 operation of the weight
    rounding once, as the TPU kernels compute (q - z) * s on bf16 operands."""
    M = x.shape[0]
    G, S, _ = rot.shape
    O = qweight.shape[1]
    xr = _bf16(torch.einsum("mgj,gij->mgi", _bf16(x).reshape(M, G, S), _bf16(rot)))
    s, z = _bf16(scales)[:, None, :], _bf16(zeros)[:, None, :]
    w = _bf16(_bf16(_unpack_groups(qweight, G, S) - z) * s)  # [G, S, O]
    acc = torch.zeros((M, O), dtype=torch.float32, device=x.device)
    for g0 in range(0, G, chunk):  # the chunks in order, as the kernels' accumulators take them
        acc = acc + xr[:, g0:g0 + chunk].reshape(M, -1) @ w[g0:g0 + chunk].reshape(-1, O)
    return acc.to(x.dtype)


def mg_chunk(G: int, groups_per_step: int) -> int:
    """K8's chunk in groups, as JAX's wrapper normalises groups_per_step
    (`paroquant_tpu/kernels/rot_matmul.py::rot_w4_matmul_mg`): at most G, and
    below G a multiple of 16 (its bf16 blocks of scales and zeros tile at 16
    sublanes), or G itself where G < 16. The last chunk holds what is left."""
    if groups_per_step < 1:
        raise ValueError(f"groups_per_step must be at least 1, got {groups_per_step}")
    Gb = min(groups_per_step, G)
    if Gb < G and Gb % 16:
        Gb = max(16, Gb // 16 * 16) if G >= 16 else G
    return Gb


def rot_w4_matmul_mg_plain(x, rot, qweight, scales, zeros, *,
                           groups_per_step: int = 16) -> torch.Tensor:
    """Plain PyTorch version of K8 (`_kernel_dense_rot_mg`): `dequant_chunks_plain`
    in chunks of `mg_chunk(G, groups_per_step)` groups."""
    return dequant_chunks_plain(x, rot, qweight, scales, zeros,
                                mg_chunk(rot.shape[0], groups_per_step))


def rot_w4_matmul_i4_plain(x, rot, qweight_i4, scales, zeros) -> torch.Tensor:
    """Plain PyTorch version of K9 (`_kernel_dense_rot_i4`): K1's numerics
    on the interleaved layout."""
    G, S, _ = rot.shape
    q = _unpack_interleaved(qweight_i4, G, S)
    return _rot_w4_plain_part(x, rot, q, scales, zeros, False).to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # entry point: (source stem, argument types)
    "paro_rot_w4_matmul": ("rot_w4_matmul", [_P] * 11 + [_I] * 4 + [ctypes.POINTER(_I)] + [_I] * 6),
    "paro_rot_w4_matmul_one_launch": ("rot_w4_matmul",
                                      [_P] * 8 + [_I] * 4 + [ctypes.POINTER(_I)] + [_I] * 6),
    "paro_butterfly_w4_matmul": ("w4_variants", [_P] * 4 + [_I] + [_P] * 7 + [_I] * 8),
    "paro_butterfly_w4_one_launch": ("w4_variants", [_P] * 4 + [_I] + [_P] * 6 + [_I] * 9),
    "paro_dense_rot_w4_variant": ("w4_variants", [_P] * 9 + [_I] * 10),
    "paro_rot_w4_matmul_i4_one_launch": ("w4_variants", [_P] * 8 + [_I] * 10),
    "paro_rot_w4_matmul_dq": ("rot_w4_dequant", [_P] * 8 + [_I] * 12),
    "paro_rot_w4_matmul_ra8": ("rot_w4_a8", [_P] * 8 + [_I] * 4 + [ctypes.POINTER(_I)] + [_I] * 7),
    "paro_w4_matmul_one_launch": ("w4_plain", [_P] * 7 + [_I] * 9),
}
_fns: dict[str, object] = {}


def _lib_fn(entry: str):
    if entry not in _fns:
        stem, argtypes = _SIGNATURES[entry]
        fn = getattr(load(stem), entry)
        fn.argtypes = argtypes + [_P]  # the stream last
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


_sm_counts: dict = {}


def _sm_count(device) -> int:
    """The device's SM count, read once per device."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def _group_splits(n_col_tiles: int, n_row_tiles: int, G: int, sms: int,
                  max_groups: int | None = None) -> int:
    """Split the groups across blocks only when the column tiles cannot fill
    the `sms` SMs twice over (and so that no block takes more than
    `max_groups`); returns KS with every split non-empty."""
    want = max(1, -(-2 * sms // (n_col_tiles * n_row_tiles)))
    gps = -(-G // min(G, want))
    if max_groups:
        gps = min(gps, max(1, max_groups))
    return -(-G // gps)


def one_launch_row_tile(M: int) -> int:
    """Rows per block of the one-launch kernel's instance for M rows: the
    least instance that holds M, at most 8 (M 9-16 take two row tiles)."""
    return next((t for t in ONE_LAUNCH_ROW_TILES if t >= M), ONE_LAUNCH_ROW_TILES[-1])


def rot_route(M: int, I: int, S: int, out_splits: tuple, a8: bool, rot_dtype,
              sms: int) -> tuple[str, int, int]:
    """K1/K2's route on a card of `sms` SMs, its group splits KS and its
    column-tile width, from shapes alone: ("one_launch", KS, tile), ("ra8",
    KS, 512) or ("passes", KS, 128).

    `a8` calls with M <= 16 rows and groups of S <= 256 channels, S a
    multiple of 8 (its dp4a dot takes four byte-rows of a group at a time),
    take "ra8", the RA8 variant of the one-launch kernel on `ra8_plan`'s
    plan (one launch at every width, the lm_head's included) where the plan
    finds one.

    The one-launch kernel takes W4A16 calls (not `a8`) with M <= 16 rows and
    groups of S <= 256 channels, and rot in float32 or bfloat16, when its
    grid fits in one wave: one block per column tile (128, 256 or 512
    columns) of each partition, group split and row tile
    (`one_launch_row_tile(M)` rows), BLOCKS_PER_SM blocks resident per SM.
    A block takes at most min(16, 4096 // (MT * S), 2048 // tile) groups
    (MT: the instance's rows), so the splits are at least ceil(G / that);
    if the tiles times those splits exceed one wave at every width (the
    151936-wide lm_head), the call takes the passes. Otherwise, at each
    width that fits, KS is the most splits the wave holds, at most G,
    evened out so that every split holds ceil(G / KS) groups but the last,
    which holds at least one. The width with the fewest groups a split wins
    (every block rotates its own groups); on a tie, at M <= 4 (widths 128
    and 256) the one whose busiest SM streams the fewest weight bytes, then
    the one with fewer blocks, and at larger M (all three widths) the
    narrower. Both tie-breaks follow times of Qwen3-0.6B's four decode
    linears on an H100 (PERF.md §6). Every other call takes the three
    passes, with KS from `_group_splits`."""
    if rot_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rot must be float32 or bfloat16, got {rot_dtype}")
    G = I // S
    wave = BLOCKS_PER_SM * sms
    if a8 and M <= ONE_LAUNCH_MAX_M and S <= ONE_LAUNCH_MAX_S and S % 8 == 0:
        plan = ra8_plan(M, I, S, out_splits, sms)
        if plan is not None:
            return "ra8", plan[0], plan[1]
    if not a8 and M <= ONE_LAUNCH_MAX_M and S <= ONE_LAUNCH_MAX_S:
        MT = one_launch_row_tile(M)
        best = None
        for tile in ONE_LAUNCH_TILES if MT > 4 else ONE_LAUNCH_TILES[:2]:
            n_tiles = sum(-(-int(n) // tile) for n in out_splits) * -(-M // MT)
            gmax = min(ONE_LAUNCH_MAX_GROUPS, ONE_LAUNCH_X_FLOATS // (MT * S),
                       ONE_LAUNCH_SZ_FLOATS // tile)
            if n_tiles * -(-G // gmax) > wave:
                continue
            gps = -(-G // min(G, wave // n_tiles))
            ks = -(-G // gps)
            per_sm = -(-n_tiles * ks // sms) * gps * tile  # weight bytes / (S/2) on the busiest SM
            key = (gps, per_sm, n_tiles * ks) if MT <= 4 else (gps, tile)
            if best is None or key < best[0]:
                best = (key, ks, tile)
        if best is not None:
            return "one_launch", best[1], best[2]
    n_tiles = sum(-(-int(n) // COLS_PER_TILE) for n in out_splits)
    return "passes", _group_splits(n_tiles, -(-M // ROWS_PER_TILE), G, sms), COLS_PER_TILE


def ra8_plan(M: int, I: int, S: int, out_splits: tuple, sms: int,
             gps: int | None = None) -> tuple[int, int, int, int, int] | None:
    """K1/K2's `a8` launch of the RA8 variant on a card of `sms` SMs, from
    shapes alone: (KS splits, column-tile width 512, rows per block, groups
    per split, tiles per block), or None where no plan fits one wave.

    Rows per block: `_row_tile(M, S)`; a split takes at most min(16, 4096 //
    (rows * S), 4) groups (x and xq in shared memory; the scales and zeros of
    a tile's 512 columns). Where one wave of BLOCKS_PER_SM blocks an SM holds
    one block per (column tile of each partition, split, row tile), the
    fewest groups a split that fit it, one tile a block: the ordinary
    one-launch grid. Past one wave (the 151936-wide lm_head) each block takes
    a run of consecutive tiles of one partition: at each number of groups a
    split, the shortest runs whose blocks fit one wave, and of those the
    split whose busiest SM streams the fewest bytes (its blocks' weight
    slices and, with more than one split, their f32 partials; on a tie the
    one with more blocks, then fewer splits). `gps` forces the groups a split (ceil(G / KS) after
    the split count is evened out), with the shortest runs that fit. On an
    H100 the rule's choice at the lm_head was the fastest of the splits
    timed at M 1, 8 and 16 (PERF.md §6, `scripts/ra8_split_sweep.py`)."""
    mt = _row_tile(M, S)
    G, rows, wave = I // S, -(-M // mt), BLOCKS_PER_SM * sms
    gmax = max(1, min(ONE_LAUNCH_MAX_GROUPS, ONE_LAUNCH_X_FLOATS // (mt * S),
                      ONE_LAUNCH_SZ_FLOATS // RA8_TILE))
    tiles = [-(-int(n) // RA8_TILE) for n in out_splits]

    def runs(tpb):
        return sum(-(-t // tpb) for t in tiles) * rows

    def plan_at(g):
        ks = -(-G // min(g, G))
        tpb = next((t for t in range(1, max(tiles) + 1) if runs(t) * ks <= wave), None)
        gps_k = -(-G // ks)  # its scales of x [gps][rows] are its tables
        if tpb is None or _one_launch_smem(mt, S, gps_k, RA8_TILE, gps_k * mt) > MAX_SMEM_BYTES:
            return None
        return ks, RA8_TILE, mt, gps_k, tpb

    if gps is not None:
        return plan_at(gps)
    fits = [g for g in range(1, min(G, gmax) + 1) if runs(1) * -(-G // g) <= wave]
    if fits:
        return plan_at(fits[0])
    best = None
    for g in range(1, min(G, gmax) + 1):
        plan = plan_at(g)
        if plan is None:
            continue
        ks, _, _, g2, tpb = plan
        per_block = tpb * RA8_TILE * (g2 * S // 2 + (4 * mt if ks > 1 else 0))
        key = (-(-runs(tpb) * ks // sms) * per_block, -runs(tpb) * ks, ks)
        if best is None or key < best[0]:
            best = (key, plan)
    return None if best is None else best[1]


def _row_tile(M: int, S: int) -> int:
    """Rows per block of K10/K12 and the DQ variant (`row_tile` in
    csrc/one_launch.cuh): K1's row tile for M (1, 2, 4 or 8), halved while
    one group of that many rows exceeds ONE_LAUNCH_X_FLOATS."""
    mt = one_launch_row_tile(M)
    while mt > 1 and mt * S > ONE_LAUNCH_X_FLOATS:
        mt //= 2
    return mt


def _one_launch_smem(mt: int, S: int, gps: int, tile: int, tab: int = 0) -> int:
    """The one-launch kernel's shared memory per block but K1's (`layout` in
    csrc/one_launch.cuh): the 8 x 4 KB weight ring, then x and xr, the
    scales and zeros, the row sums and `tab` floats of the variant's tables
    (BF's, A8's scales of x) in floats; the warps' sums reuse it."""
    a4 = lambda n: (n + 3) & ~3
    body = 8 * 4096 + 4 * (2 * a4(gps * mt * S) + 2 * gps * tile + a4(gps * mt) + a4(tab))
    return max(body, 4 * 8 * mt * 128)


def chunk_splits(G: int, chunk: int, gps: int) -> int:
    """The splits of at most gps groups that cover G groups without crossing
    a chunk of `chunk` groups (the last chunk holds G mod chunk where that is
    not 0): each chunk takes ceil(its groups / gps) splits, all of gps
    groups but its last."""
    return G // chunk * -(-chunk // gps) + -(-(G % chunk) // gps)


def dq_plan(M: int, I: int, S: int, O: int, sms: int, chunk: int, *,
            wide_past_wave: bool = True, tiles: tuple = ONE_LAUNCH_TILES,
            group_floats: int = 0) -> tuple[int, int, int, int]:
    """The one-launch kernel's launch on a card of `sms` SMs, from shapes
    alone, for splits that do not cross a chunk of `chunk` groups (K8, K11;
    a chunk of G or more groups is all of them, as for K7, K10, K12, K13):
    (KS splits, column-tile width, rows per block, groups per split).
    `tiles` are the column-tile widths the variant takes (A8: 512 only),
    and `group_floats` the floats of tables a group adds to a block (BF:
    S (2K + 1); A8: its rows), which also cap the groups a split at
    ONE_LAUNCH_TABLE_FLOATS // group_floats (at least one).

    Rows per block: `_row_tile(M, S)`. Where one wave of BLOCKS_PER_SM
    blocks an SM can hold the grid, the tile of `tiles` at which the fewest
    groups a split (at most the chunk and min(16, 4096 // (rows * S), 2048 //
    tile) and the tables' cap) fit the wave, the narrower on a tie: every
    block rotates its own groups, and at 4096 x 4096 one group a block (512
    columns, 32 splits, M <= 8) took the least time of the splits and tiles
    tried on an H100 (PERF.md §6). Otherwise the grid runs past one wave
    (the split merge never waits on another block): with `wide_past_wave`
    at M <= 16, the widest tiles of the most groups a split they allow,
    since every column tile reads its groups' rotations again (K8's
    kernel-speedup sweep at I = 32768, PERF.md §6); else the narrowest tiles
    and as many splits as fill two blocks an SM, each of at most that many
    groups (one where a group of that many rows exceeds 4096 floats). KS is
    `chunk_splits`, so every split holds at least one group. Raises
    ValueError where one group (with its tables) does not fit a block's
    shared memory (S above about 24,000 channels)."""
    mt = _row_tile(M, S)
    G, rows, wave = I // S, -(-M // mt), BLOCKS_PER_SM * sms
    chunk = min(chunk, G)
    cap = ONE_LAUNCH_TABLE_FLOATS // group_floats if group_floats else ONE_LAUNCH_MAX_GROUPS
    gmax = lambda tile: max(1, min(ONE_LAUNCH_MAX_GROUPS, ONE_LAUNCH_X_FLOATS // (mt * S),
                                   ONE_LAUNCH_SZ_FLOATS // tile, cap))
    best = None
    for tile in tiles:
        n = -(-O // tile) * rows
        gps = next((g for g in range(1, min(chunk, gmax(tile)) + 1)
                    if n * chunk_splits(G, chunk, g) <= wave), None)
        if gps is not None and (best is None or gps < best[0]):
            best = (gps, tile)
    if best is None and wide_past_wave and M <= ONE_LAUNCH_MAX_M:
        tile = tiles[-1]
        best = (min(chunk, gmax(tile)), tile)
    elif best is None:
        tile = tiles[0]
        ks = _group_splits(-(-O // tile), rows, G, sms, gmax(tile))
        best = (min(chunk, -(-G // ks)), tile)
    gps, tile = best
    if _one_launch_smem(mt, S, gps, tile, gps * group_floats) > MAX_SMEM_BYTES:
        raise ValueError(f"a group of {S} channels does not fit one block's shared memory")
    return chunk_splits(G, chunk, gps), tile, mt, gps


def mg_route(M: int, I: int, S: int, O: int, chunk: int, sms: int):
    """K8's route on a card of `sms` SMs, from shapes alone:
    ("one_launch", `dq_plan`'s plan in chunks of `chunk` groups) or
    ("passes", None). The DQ variant of the one-launch kernel takes M <= 16
    rows where one group fits a block's shared memory; every other call
    takes the three passes. On an H100 (PERF.md §6) the variant was the
    faster at M 1 and 16 and the passes at M 33 and 128 at 4096 x 4096."""
    if M <= ONE_LAUNCH_MAX_M:
        try:
            return "one_launch", dq_plan(M, I, S, O, sms, chunk)
        except ValueError:  # a group too wide for one block's shared memory
            pass
    return "passes", None


def bf_route(M: int, I: int, S: int, O: int, K: int, sms: int):
    """K7's route on a card of `sms` SMs, from shapes alone: ("one_launch",
    `dq_plan`'s plan with K stages' tables) or ("passes", None). The BF
    variant of the one-launch kernel takes M <= 16 rows, as K8's DQ
    (`mg_route`), where one group and its tables (S (2K + 1) floats) fit a
    block's shared memory; every other call takes the three passes."""
    if M <= ONE_LAUNCH_MAX_M:
        try:
            return "one_launch", dq_plan(M, I, S, O, sms, I // S, group_floats=S * (2 * K + 1))
        except ValueError:  # a group and its tables too wide for one block's shared memory
            pass
    return "passes", None


def i4_plan(M: int, I: int, S: int, O: int, sms: int) -> tuple[int, int, int, int]:
    """K9's launch of the I4 variant on a card of `sms` SMs, from shapes
    alone: K10's plan (`w4_experiments.one_launch_plan`, the same issue
    order), `dq_plan` with all G groups one chunk and 128-column tiles past
    one wave: (KS splits, column-tile width, rows per block, groups per
    split). At 4096 x 4096, M 1: 32 splits of one group, 512 columns."""
    return dq_plan(M, I, S, O, sms, I // S, wide_past_wave=False)


def i4_route(M: int, I: int, S: int, O: int, sms: int):
    """K9's route on a card of `sms` SMs, from shapes alone: ("one_launch",
    `i4_plan`'s plan) or ("passes", None). The I4 variant of the one-launch
    kernel takes K1's one-launch calls: M <= 16 rows and groups of S <= 256
    channels (where one group of 8 rows always fits a block); every other
    call takes the three passes."""
    if M <= ONE_LAUNCH_MAX_M and S <= ONE_LAUNCH_MAX_S:
        return "one_launch", i4_plan(M, I, S, O, sms)
    return "passes", None


def w4_plan(M: int, I: int, S: int, O: int, sms: int) -> tuple[int, int, int, int]:
    """K6's launch of the PL variant on a card of `sms` SMs, from shapes
    alone: `dq_plan` with all G groups one chunk and no tables (K7's plan
    without its tables): (KS splits, column-tile width, rows per block,
    groups per split). At 4096 x 4096, M 1: 32 splits of one group, 512
    columns. Raises ValueError where one group does not fit a block."""
    return dq_plan(M, I, S, O, sms, I // S)


def w4_route(M: int, I: int, S: int, O: int, sms: int):
    """K6's route on a card of `sms` SMs, from shapes alone: ("one_launch",
    `w4_plan`'s plan) or ("passes", None). The PL variant of the one-launch
    kernel takes M <= 16 rows where one group fits a block's shared memory,
    as K7's BF (`bf_route`); every other call takes the three passes."""
    if M <= ONE_LAUNCH_MAX_M:
        try:
            return "one_launch", w4_plan(M, I, S, O, sms)
        except ValueError:  # a group too wide for one block's shared memory
            pass
    return "passes", None


def _check_butterfly_group(S: int) -> None:
    if S < 2 or S & (S - 1):
        raise ValueError(f"butterfly stages need a power-of-two group size, got {S}")


def _sz_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in SZ_CODES:
        raise TypeError(f"{what} must be float32, bfloat16, float16 or uint8, got {t.dtype}")
    return SZ_CODES[t.dtype]


def _check_rot(rot, G: int, S: int) -> None:
    """A dense rotation [G, S, S] in float32 or bfloat16 (K8-K12)."""
    if tuple(rot.shape) != (G, S, S):
        raise ValueError(f"rot must be [G, S, S], got {tuple(rot.shape)}")
    if rot.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rot must be float32 or bfloat16, got {rot.dtype}")


def _check_operands(x, qweight, scales, zeros, S: int, G: int, others=()):
    """The checks every launch makes; returns the operands contiguous, the
    weight 4-byte aligned."""
    M, I = x.shape
    O = qweight.shape[1]
    if S < 2 or S % 2 or I != G * S:
        raise ValueError(f"groups of {S} channels do not tile x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if qweight.dtype != torch.uint8 or qweight.shape[0] * 2 != I:
        raise TypeError(f"qweight must be uint8 [I/2, O], got {qweight.dtype} {tuple(qweight.shape)}")
    for t, what in ((scales, "scales"), (zeros, "zeros")):
        _sz_code(t, what)
        if tuple(t.shape) != (G, O):
            raise ValueError(f"{what} must be [{G}, {O}], got {tuple(t.shape)}")
    tensors = (x, qweight, scales, zeros, *others)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on the same device")
    x, qweight, scales, zeros, *others = (t.contiguous() for t in tensors)
    if qweight.data_ptr() % 4:
        qweight = qweight.clone()
    return x, qweight, scales, zeros, others


def _scratch(M, I, G, O, KS, dev, P=1):
    f32 = torch.float32
    return (torch.empty((P, M, I), dtype=f32, device=dev),
            torch.empty((P, M, G), dtype=f32, device=dev),
            torch.empty((KS, M, O) if KS > 1 else (0,), dtype=f32, device=dev))


def _count(name: str, scales, zeros) -> None:
    launch_counts[name] += 1
    key = f"{scales.dtype}/{zeros.dtype}".replace("torch.", "")
    sz_counts[name][key] = sz_counts[name].get(key, 0) + 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


# per device: the one-launch route's split counters, zero between calls (each
# call's last block per column tile resets its own)
_split_counters: dict = {}


def _counters(n: int, device) -> torch.Tensor:
    c = _split_counters.get(device)
    if c is None or c.numel() < n:
        c = _split_counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return c


def launch_ra8(x, rot, qweight, scales, zeros, out_splits, plan):
    """K1 / K2's `a8` on the card in one launch of the RA8 variant, by `plan`
    (KS, tile, rows, gps, tiles per block; `ra8_plan`'s or another within the
    kernel's limits); x [M, I]; rot [P, G, S, S]; the rest as K2's. The
    caller checks the operands and counts the launch."""
    M, I = x.shape
    P, G, S, _ = rot.shape
    O = qweight.shape[1]
    fn = _lib_fn("paro_rot_w4_matmul_ra8")
    dev = x.device
    KS, tile, mt, _, tpb = plan
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=torch.float32, device=dev)
    n_tiles = sum(-(-n // tile) for n in out_splits)
    counters = _counters(n_tiles * -(-M // mt), dev) if KS > 1 else partial  # a (row tile, tile)
    err = fn(
        x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), partial.data_ptr(), counters.data_ptr(), M, I, S, P,
        (ctypes.c_int * P)(*out_splits), KS, tile // COLS_PER_TILE, tpb,
        int(x.dtype == torch.bfloat16), int(rot.dtype == torch.bfloat16), SZ_CODES[scales.dtype],
        SZ_CODES[zeros.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "rot_w4_matmul_ra8")
    return out


def _launch_rot(name, x, rot, qweight, scales, zeros, out_splits, a8):
    """K1 / K2 on the card, by the route `rot_route` picks."""
    M, I = x.shape
    P, G, S, _ = rot.shape
    O = qweight.shape[1]
    if P > MAX_PARTS or sum(out_splits) != O or min(out_splits) < 1:
        raise ValueError(f"out_splits {out_splits} must be at most {MAX_PARTS} positive widths summing to {O}")
    if rot.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rot must be float32 or bfloat16, got {rot.dtype}")
    x, qweight, scales, zeros, (rot,) = _check_operands(x, qweight, scales, zeros, S, G, (rot,))
    fns = {"one_launch": _lib_fn("paro_rot_w4_matmul_one_launch"),  # before the device is queried
           "passes": _lib_fn("paro_rot_w4_matmul"), "ra8": _lib_fn("paro_rot_w4_matmul_ra8")}
    dev = x.device
    route, KS, tile = rot_route(M, I, S, out_splits, a8, rot.dtype, _sm_count(dev))
    if route == "ra8":
        out = launch_ra8(x, rot, qweight, scales, zeros, out_splits,
                         ra8_plan(M, I, S, out_splits, _sm_count(dev)))
    else:
        out = torch.empty((M, O), dtype=x.dtype, device=dev)
        splits = (ctypes.c_int * P)(*out_splits)
        common = (int(x.dtype == torch.bfloat16), int(rot.dtype == torch.bfloat16))
        sz = (SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype])
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "one_launch":
            partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=torch.float32, device=dev)
            n_tiles = sum(-(-n // tile) for n in out_splits) * -(-M // one_launch_row_tile(M))
            counters = _counters(n_tiles, dev) if KS > 1 else partial
            err = fns[route](
                x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), partial.data_ptr(), counters.data_ptr(), M, I, S,
                P, splits, KS, tile // COLS_PER_TILE, *common, *sz, stream)
        else:
            xr, xsum, partial = _scratch(M, I, G, O, KS, dev, P)
            xq = torch.empty((P, M, I) if a8 else (0,), dtype=torch.int8, device=dev)
            sx = torch.empty((P, M, G), dtype=torch.float32, device=dev)
            err = fns[route](
                x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), xr.data_ptr(), xq.data_ptr(), xsum.data_ptr(),
                sx.data_ptr(), partial.data_ptr(), M, I, S, P, splits, KS, *common, int(a8), *sz,
                stream)
        _raise_on(err, name)
    _count(name, scales, zeros)
    variant_counts[name][int(a8)] += 1
    route_counts[name][route] += 1
    if route == "passes" and M <= ONE_LAUNCH_MAX_M:
        route_counts[name]["passes_a8_m16" if a8 else "passes_w4a16_m16"] += 1
    return out


def launch_dq(name, x, rot, qweight, scales, zeros, chunk, plan=None):
    """K8 / K11 on the card: one launch of the one-launch kernel's DQ variant
    (csrc/rot_w4_dequant.cu) in chunks of `chunk` groups, by `plan` (KS,
    tile, rows, gps) or else `dq_plan`'s. x [M, I]; rot [G, S, S] f32 or
    bf16; scales, zeros [G, O] of any of the four dtypes -> [M, O] in
    x.dtype. The caller counts the launch."""
    M, I = x.shape
    G, S, _ = rot.shape
    O = qweight.shape[1]
    _check_rot(rot, G, S)
    x, qweight, scales, zeros, (rot,) = _check_operands(x, qweight, scales, zeros, S, G, (rot,))
    fn = _lib_fn("paro_rot_w4_matmul_dq")  # before the device is queried
    dev = x.device
    KS, tile, mt, gps = plan or dq_plan(M, I, S, O, _sm_count(dev), chunk)
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=torch.float32, device=dev)
    counters = _counters(-(-O // tile) * -(-M // mt), dev) if KS > 1 else partial
    err = fn(
        x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), partial.data_ptr(), counters.data_ptr(), M, I, S, O, KS, gps,
        min(chunk, G), tile // COLS_PER_TILE, int(x.dtype == torch.bfloat16),
        int(rot.dtype == torch.bfloat16), SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    return out


def _launch_butterfly(name, x, inv_s, cos_t, sin_t, qweight, scales, zeros, S):
    """K6 (no tables) on the card by the route `w4_route` picks, K7 by the
    route `bf_route` picks."""
    M, I = x.shape
    G, O = I // S if S else 0, qweight.shape[1]
    tables = () if cos_t is None else (inv_s.to(torch.float32), cos_t.to(torch.float32),
                                        sin_t.to(torch.float32))
    x, qweight, scales, zeros, tables = _check_operands(x, qweight, scales, zeros, S, G, tables)
    K = 0
    if tables:
        inv_s, cos_t, sin_t = tables
        K = cos_t.shape[0]
        if inv_s.shape != (I,) or cos_t.shape != (K, I) or sin_t.shape != (K, I):
            raise ValueError("inv_channel_scales must be [I] and the tables [K, I]")
    fns = {"one_launch": _lib_fn("paro_butterfly_w4_one_launch" if tables  # before the device is queried
                                 else "paro_w4_matmul_one_launch"),
           "passes": _lib_fn("paro_butterfly_w4_matmul")}
    dev = x.device
    route, plan = (bf_route(M, I, S, O, K, _sm_count(dev)) if tables
                   else w4_route(M, I, S, O, _sm_count(dev)))
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    ptr = (lambda t: t.data_ptr()) if tables else (lambda t: None)
    common = (M, I, S, O)
    sz = (int(x.dtype == torch.bfloat16), SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype],
          torch.cuda.current_stream(dev).cuda_stream)
    if route == "one_launch":
        KS, tile, mt, _ = plan
        partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=torch.float32, device=dev)
        counters = _counters(-(-O // tile) * -(-M // mt), dev) if KS > 1 else partial
        ptrs = (qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
                partial.data_ptr(), counters.data_ptr())
        if tables:
            err = fns[route](x.data_ptr(), inv_s.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(), K,
                             *ptrs, *common, KS, tile // COLS_PER_TILE, *sz)
        else:
            err = fns[route](x.data_ptr(), *ptrs, *common, KS, tile // COLS_PER_TILE, *sz)
    else:
        KS = _group_splits(-(-O // COLS_PER_TILE), -(-M // ROWS_PER_TILE), G, _sm_count(dev))
        xr, xsum, partial = _scratch(M, I, G, O, KS, dev)
        err = fns[route](
            x.data_ptr(), ptr(inv_s), ptr(cos_t), ptr(sin_t), K, qweight.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), out.data_ptr(), xr.data_ptr(), xsum.data_ptr(),
            partial.data_ptr(), *common, KS, *sz)
    _raise_on(err, name)
    _count(name, scales, zeros)
    (bf_route_counts if tables else w4_route_counts)[route] += 1
    return out


def launch_i4(x, rot, qweight_i4, scales, zeros, plan):
    """K9 on the card in one launch of the I4 variant, by `plan` (KS, tile,
    rows, gps; `i4_plan`'s or another within the kernel's limits); K9's
    operands. The caller counts the launch."""
    M, I = x.shape
    G, S, _ = rot.shape
    O = qweight_i4.shape[1]
    _check_rot(rot, G, S)
    x, qweight_i4, scales, zeros, (rot,) = _check_operands(x, qweight_i4, scales, zeros, S, G, (rot,))
    fn = _lib_fn("paro_rot_w4_matmul_i4_one_launch")
    dev = x.device
    KS, tile, mt, _ = plan
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=torch.float32, device=dev)
    counters = _counters(-(-O // tile) * -(-M // mt), dev) if KS > 1 else partial
    err = fn(
        x.data_ptr(), rot.data_ptr(), qweight_i4.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), partial.data_ptr(), counters.data_ptr(), M, I, S, O, KS,
        tile // COLS_PER_TILE, int(x.dtype == torch.bfloat16), int(rot.dtype == torch.bfloat16),
        SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "rot_w4_matmul_i4")
    return out


def _launch_dense_variant(name, x, rot, qweight, scales, zeros, interleaved, max_groups=None):
    """K8 (interleaved=False; bf16 rot, scales and zeros) / K9 on the card by
    the three passes."""
    M, I = x.shape
    G, S, _ = rot.shape
    O = qweight.shape[1]
    _check_rot(rot, G, S)
    x, qweight, scales, zeros, (rot,) = _check_operands(x, qweight, scales, zeros, S, G, (rot,))
    fn = _lib_fn("paro_dense_rot_w4_variant")
    dev = x.device
    KS = _group_splits(-(-O // COLS_PER_TILE), -(-M // ROWS_PER_TILE), G, _sm_count(dev),
                       max_groups)
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    xr, xsum, partial = _scratch(M, I, G, O, KS, dev)
    err = fn(
        x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), xr.data_ptr(), xsum.data_ptr(), partial.data_ptr(), M, I, S, O, KS,
        int(x.dtype == torch.bfloat16), int(rot.dtype == torch.bfloat16),
        SZ_CODES[scales.dtype], SZ_CODES[zeros.dtype], int(interleaved),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, name)
    _count(name, scales, zeros)
    return out


# ---------------------------------------------------------------------------
# Wrappers (JAX's signatures without the TPU-only knobs)
# ---------------------------------------------------------------------------


def rot_w4_matmul(x, rot, qweight, scales, zeros, *, a8: bool = False) -> torch.Tensor:
    """K1: x [M, I]; rot [G, S, S]; qweight uint8 [I//2, O]; scales, zeros
    [G, O] -> [M, O] in x.dtype."""
    if x.device.type == "cpu":
        return rot_w4_matmul_plain(x, rot, qweight, scales, zeros, a8=a8)
    return _launch_rot("rot_w4_matmul", x, rot[None], qweight, scales, zeros,
                       (qweight.shape[1],), a8)


def merged_rot_w4_matmul(x, rot, qweight, scales, zeros, *, out_splits: tuple,
                         a8: bool = False) -> torch.Tensor:
    """K2: rot [P, G, S, S]; qweight [I//2, sum(out_splits)] -> [M, sum(out_splits)]."""
    out_splits = tuple(int(n) for n in out_splits)
    if x.device.type == "cpu":
        return merged_rot_w4_matmul_plain(x, rot, qweight, scales, zeros,
                                          out_splits=out_splits, a8=a8)
    return _launch_rot("merged_rot_w4_matmul", x, rot, qweight, scales, zeros, out_splits, a8)


def w4_matmul(x, qweight, scales, zeros, *, group_size: int = 128) -> torch.Tensor:
    """K6: x [M, I]; qweight uint8 [I//2, O] half-split; scales, zeros
    [I//group_size, O] -> [M, O] in x.dtype. On the card `w4_route` picks
    the PL variant of the one-launch kernel (one launch; the group splits
    merged in split order) or the three passes."""
    if x.device.type == "cpu":
        return w4_matmul_plain(x, qweight, scales, zeros, group_size=group_size)
    return _launch_butterfly("w4_matmul", x, None, None, None, qweight, scales, zeros, group_size)


def butterfly_w4_matmul(x, inv_channel_scales, cos_table, sin_table, qweight, scales, zeros, *,
                        group_size: int = 128) -> torch.Tensor:
    """K7: inv_channel_scales [I]; cos_table, sin_table [K, I] (the
    per-channel cos and signed sin of `ops/butterfly.py::butterfly_tables`);
    the rest as K6. group_size must be a power of two."""
    _check_butterfly_group(group_size)
    if x.device.type == "cpu":
        return butterfly_w4_matmul_plain(x, inv_channel_scales, cos_table, sin_table, qweight,
                                         scales, zeros, group_size=group_size)
    if group_size > MAX_BUTTERFLY_S:
        raise ValueError(f"the CUDA kernel stages groups of at most {MAX_BUTTERFLY_S} channels")
    return _launch_butterfly("butterfly_w4_matmul", x, inv_channel_scales, cos_table, sin_table,
                             qweight, scales, zeros, group_size)


def rot_w4_matmul_mg(x, rot, qweight, scales, zeros, *, groups_per_step: int = 16) -> torch.Tensor:
    """K8: K1's operands; x, rot, scales and zeros are rounded to bf16, and
    the dot is summed over chunks of `mg_chunk(G, groups_per_step)` groups in
    order. On the card `mg_route` picks the DQ variant of the one-launch
    kernel (one launch; the splits of a chunk merge in split order and the
    chunks in order) or the three passes (where the result moves only by
    the order of f32 sums)."""
    if x.device.type == "cpu":
        return rot_w4_matmul_mg_plain(x, rot, qweight, scales, zeros,
                                      groups_per_step=groups_per_step)
    M, I = x.shape
    G, S, _ = rot.shape
    chunk = mg_chunk(G, groups_per_step)
    route, plan = mg_route(M, I, S, qweight.shape[1], chunk, _sm_count(x.device))
    if route == "one_launch":
        out = launch_dq("rot_w4_matmul_mg", x, rot, qweight, scales, zeros, chunk, plan)
        _count("rot_w4_matmul_mg", scales, zeros)
    else:
        bf = torch.bfloat16
        out = _launch_dense_variant("rot_w4_matmul_mg", x, rot.to(bf), qweight, scales.to(bf),
                                    zeros.to(bf), False, groups_per_step)
    mg_route_counts[route] += 1
    return out


def rot_w4_matmul_i4(x, rot, qweight_i4, scales, zeros) -> torch.Tensor:
    """K9: K1 with qweight_i4 uint8 [I//2, O] in the interleaved layout
    (`ops/packing.py::pack_w4_i4`). On the card `i4_route` picks the I4
    variant of the one-launch kernel (one launch; the group splits merged in
    split order) or the three passes."""
    if x.device.type == "cpu":
        return rot_w4_matmul_i4_plain(x, rot, qweight_i4, scales, zeros)
    _lib_fn("paro_rot_w4_matmul_i4_one_launch")  # both libraries before the device is queried
    _lib_fn("paro_dense_rot_w4_variant")
    M, I = x.shape
    S = rot.shape[-1]
    if S < 2 or S % 2 or I != rot.shape[0] * S:
        raise ValueError(f"groups of {S} channels do not tile x {tuple(x.shape)}")
    route, plan = i4_route(M, I, S, qweight_i4.shape[1], _sm_count(x.device))
    if route == "one_launch":
        out = launch_i4(x, rot, qweight_i4, scales, zeros, plan)
        _count("rot_w4_matmul_i4", scales, zeros)
    else:
        out = _launch_dense_variant("rot_w4_matmul_i4", x, rot, qweight_i4, scales, zeros, True)
    i4_route_counts[route] += 1
    return out
