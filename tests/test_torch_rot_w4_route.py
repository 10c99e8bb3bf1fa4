"""K1/K2's one-launch route (kernels/rot_matmul.py::rot_route and the kernel's
arithmetic in csrc/rot_w4_matmul.cu) on the CPU.

The route rule is a pure function of shapes and the card's SM count, so it
is tested here at an H100's 132 SMs: Qwen3-0.6B's four decode linears take
the one-launch route at every M from 1 to 16; `a8` at M <= 16 and S <= 256
the RA8 variant (tests/test_torch_rot_w4_a8.py); M > 16, S > 256 and the
151936-wide lm_head in W4A16 take the three passes. The split count it picks must
leave every split non-empty and the grid within one wave.

The kernel itself runs only on the card. What it sums is modelled here in
torch: each block rotates its own groups, xr_g = bf16(round_rot(x_g) @
M_{p,g}^T), adds (xr_g . (q_g s_g) - rowsum(xr_g) z_g s_g) over its split's
groups into an f32 partial, and the partials are summed in split order.
The model is held against JAX's rot_w4_matmul / merged_rot_w4_matmul in
Pallas interpret mode, on Gaussian inputs made from a numpy seed, at the
route's split count and at one and two groups a split. The model also
takes K10's and K12's switches (tests/test_torch_w4_experiments.py holds
those against the JAX scripts' kernels).

Tolerance: `rot_tolerance` (tests/test_torch_rot_w4_flips.py): 1e-5 x max
|y| for f32 sums in another order, plus one bf16 ulp of each rotated
activation whose exact value lies within the f32 sums' error bound of a
bf16 rounding midpoint, times its coefficient |(q - z) s| in the output;
where x is bf16 the output is bf16 in both, and a different f32 sum may
round it one bf16 ulp the other way, so there the bound adds 2**-7 |y|
elementwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu_torch.kernels import rot_matmul as tk
from paroquant_tpu_torch.kernels import unpack_exp as ux
from test_torch_rot_w4_flips import rot_tolerance

SMS = 132  # an H100 SXM's SMs
QWEN3_DECODE = {  # Qwen3-0.6B's decode linears: I, out_splits
    "o_proj": (2048, (1024,)),
    "down_proj": (3072, (1024,)),
    "qkv_proj": (1024, (2048, 1024, 1024)),
    "gate_up_proj": (1024, (3072, 3072)),
}


# ---------------------------------------------------------------------------
# the route rule and the split count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("layer", list(QWEN3_DECODE))
def test_decode_linears_take_one_launch(layer, M):
    I, splits = QWEN3_DECODE[layer]
    route, KS, tile = tk.rot_route(M, I, 128, splits, False, torch.bfloat16, SMS)
    assert route == "one_launch"
    assert tile in tk.ONE_LAUNCH_TILES and 1 <= KS <= I // 128


PASSES = {  # case: M, I, S, out_splits, a8
    "a8_M17": (17, 2048, 128, (1024,), True),
    "a8_S512": (1, 1024, 512, (1024,), True),
    "M17": (17, 2048, 128, (1024,), False),
    "M128": (128, 1024, 128, (2048, 1024, 1024), False),
    "S512": (1, 1024, 512, (1024,), False),
    "S1024": (1, 2048, 1024, (1024,), False),
    "lm_head_M1": (1, 1024, 128, (151936,), False),
    "lm_head_M8": (8, 1024, 128, (151936,), False),
    "lm_head_M17_a8": (17, 1024, 128, (151936,), True),
}


@pytest.mark.parametrize("case", list(PASSES))
def test_other_calls_take_the_passes(case):
    M, I, S, splits, a8 = PASSES[case]
    route, KS, tile = tk.rot_route(M, I, S, splits, a8, torch.bfloat16, SMS)
    assert route == "passes" and tile == tk.COLS_PER_TILE
    n_tiles = sum(-(-n // tk.COLS_PER_TILE) for n in splits)
    assert KS == tk._group_splits(n_tiles, -(-M // tk.ROWS_PER_TILE), I // S, SMS)


RA8 = {  # case: M, I, S, out_splits (a8 at M <= 16 and S <= 256: the RA8 variant)
    "a8_o_proj": (1, 2048, 128, (1024,)),
    "a8_down_proj": (1, 3072, 128, (1024,)),
    "a8_qkv_proj": (1, 1024, 128, (2048, 1024, 1024)),
    "a8_gate_up_proj": (8, 1024, 128, (3072, 3072)),
    "lm_head_M16_a8": (16, 1024, 128, (151936,)),
}


@pytest.mark.parametrize("case", list(RA8))
def test_a8_calls_take_ra8(case):
    M, I, S, splits = RA8[case]
    route, KS, tile = tk.rot_route(M, I, S, splits, True, torch.bfloat16, SMS)
    assert route == "ra8" and (KS, tile) == tk.ra8_plan(M, I, S, splits, SMS)[:2]


SPLIT_SHAPES = [(M, I, S, splits) for M in (1, 3, 8, 9, 16)
                for I, S, splits in [*((I, 128, sp) for I, sp in QWEN3_DECODE.values()),
                                     (768, 256, (66, 62)), (192, 64, (128, 96, 160)),
                                     (4096, 128, (64, 34, 48, 78)), (128, 128, (33792,)),
                                     (6144, 256, (1000,))]]


@pytest.mark.parametrize("M,I,S,splits", SPLIT_SHAPES)
def test_split_count_fills_one_wave_with_nonempty_splits(M, I, S, splits):
    route, KS, tile = tk.rot_route(M, I, S, splits, False, torch.float32, SMS)
    assert route == "one_launch"
    G = I // S
    gps = -(-G // KS)
    MT = tk.one_launch_row_tile(M)
    assert (KS - 1) * gps < G  # the last split holds at least one group
    assert gps <= min(tk.ONE_LAUNCH_MAX_GROUPS, tk.ONE_LAUNCH_X_FLOATS // (MT * S),
                      tk.ONE_LAUNCH_SZ_FLOATS // tile)
    blocks = sum(-(-n // tile) for n in splits) * -(-M // MT) * KS
    assert blocks <= tk.BLOCKS_PER_SM * SMS


def test_route_refuses_other_rot_dtypes():
    with pytest.raises(TypeError):
        tk.rot_route(1, 256, 128, (128,), False, torch.float16, SMS)


# ---------------------------------------------------------------------------
# a model of the one-launch kernel's sums against the Pallas kernels
# ---------------------------------------------------------------------------


def split_groups(G, KS, chunk=None, gps=None):
    """The groups of each of the KS splits, as the one-launch kernel assigns
    them: split ks of chunk ks // spc (spc = ceil(chunk / gps) splits a
    chunk) takes up to gps groups from the chunk's start + (ks mod spc) gps,
    never past the chunk. Without a chunk, all G groups are one chunk of
    ceil(G / KS) groups a split. Returns [(chunk index, range of groups)]."""
    gps = gps or -(-G // KS)
    chunk = min(chunk or G, G)
    spc = -(-chunk // gps)
    out = []
    for ks in range(KS):
        c = ks // spc
        g0 = c * chunk + ks % spc * gps
        out.append((c, range(g0, min(g0 + gps, (c + 1) * chunk, G))))
    return out


def _a8_quantize(xr):
    """(sx, xq) of f32 values xr [..., S]: sx = max |xr| / 127 per row (1
    where that is 0), xq = xr / sx rounded half to even, as JAX's
    `_a8_quantize` (integer-valued f32)."""
    amax = xr.abs().amax(-1, keepdim=True)
    sx = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    return sx, torch.round(xr / sx)


def mulfloor_unpack(qweight: torch.Tensor):
    """MF's unpack (K20) in torch, bit for bit: uint8 [R, C] -> the (low,
    high) nibbles, float32 [R, C] each. The kernel takes a lane's bytes in
    pairs as bf16x2, whose halves are computed apart, so a byte at a time:
    f = bf16(float(b)) (exact for 0..255), hi = floor(bf16(f * 0.0625)) and
    lo = bf16(hi * -16 + f) rounded once (the fused __hfma2: the product of
    two bf16 values and the sum are exact in float64, so one rounding of the
    float64 value to bf16 is the FMA's), each then widened to float32."""
    f = qweight.to(torch.int32).to(torch.float32).to(torch.bfloat16)
    hi = torch.floor(f * torch.tensor(0.0625, dtype=torch.bfloat16))
    assert hi.dtype == torch.bfloat16
    lo = (hi.to(torch.float64) * -16.0 + f.to(torch.float64)).to(torch.bfloat16)
    return lo.to(torch.float32), hi.to(torch.float32)


def wordmask_unpack(qweight: torch.Tensor):
    """WM's unpack (K22) in torch, bit for bit: uint8 [R, C] (C a multiple
    of 4) -> the (low, high) nibbles, float32 [R, C] each. Lane l reads the
    32-bit word of columns 4l..4l+3 (byte i of the word is column 4l + i),
    masks it whole, w & 0x0F0F0F0F and (w >> 4) & 0x0F0F0F0F, and takes
    byte i of each as int8 to float."""
    b = qweight.to(torch.int64).reshape(qweight.shape[0], -1, 4)
    w = b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
    out = []
    for word in (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F):
        n = torch.stack([(word >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
        out.append(n.to(torch.uint8).view(torch.int8).to(torch.float32).reshape(qweight.shape))
    return tuple(out)


def one_launch_model(x, rot, qweight, scales, zeros, out_splits, KS, variant="k1", chunk=None,
                     gps=None, tables=None):
    """The one-launch kernel's arithmetic in torch: per block (partition p,
    split ks) xr_g = bf16(x_g @ rot[p, g]^T) for its groups, an f32 partial
    sum_g xr_g @ (q_g s_g) - rowsum_g z_g s_g, and the KS partials summed in
    split order. Returns f32 [M, O]. variant "k1" (K1/K2: x rounded to rot's
    dtype, rowsum of the bf16 xr), "b" (K10: the rowsum of the f32 xr), "v2"
    (K12: x not rounded), "dq" (K8/K11: x and rot rounded to bf16, the
    partial sum_g xr_g @ w_g with w_g = bf16(bf16(q_g - z_g) s_g) and s, z in
    bf16; the splits, `split_groups(G, KS, chunk, gps)`, do not cross a
    chunk, each chunk's splits add in split order into its f32 sum and the
    chunk sums in chunk order), "bf" (K7: no rot; xr_g = bf16 of the K
    butterfly stages on x_g * inv_s, `tables` = (inv_s, cos, sin), then K1's
    partial), "a8" (K13: no rot; per (row, group) sx = max |x_g| / 127 (1
    where 0) and xq = round(x_g / sx), and the partial the sum, in group
    order from 0, of (xq_g @ q_g - sum(xq_g) z_g) (s_g sx), each operation
    rounded apart and the dot exact), "i4" (K9: K1's arithmetic on a
    qweight in the interleaved layout, byte-row k of a group holding
    channels 2k and 2k + 1), "ra8" (K1/K2's a8: x rounded to rot's dtype,
    xr32_g = x_g @ rot[p, g]^T in f32, not rounded to bf16; per (row, group)
    sx = max |xr32_g| / 127 (1 where 0) and xq = round(xr32_g / sx); the
    partial the sum, in group order, of ((xq_g @ q_g - sum(xq_g) z_g) s_g) sx,
    each operation rounded apart and the dot exact), "pl" (K6 and K21: no
    rot; xr_g = bf16(x_g), then K1's partial), "bc" (K19: "pl" on a
    qweight in the output-pair layout uint8 [I, O//2], byte (i, j) holding
    columns 2j and 2j + 1 of channel i; xr per channel), "mf" (K20: "pl"
    with the nibbles of `mulfloor_unpack`) or "wm" (K22: "pl" with those of
    `wordmask_unpack`)."""
    M, I = x.shape
    if variant in ("bf", "a8", "pl", "bc", "mf", "wm"):  # no rotation matrix: one partition
        P, G = 1, scales.shape[0]
        S = I // G
    else:
        P, G, S, _ = rot.shape
    if variant == "bc":
        q = ux.unpack_opair(qweight).to(torch.float32).reshape(G, S, -1)
    elif variant in ("mf", "wm"):  # byte-row k of a group: channels k (low) and S/2 + k (high)
        lo, hi = (mulfloor_unpack if variant == "mf" else wordmask_unpack)(qweight)
        q = torch.cat([lo.reshape(G, S // 2, -1), hi.reshape(G, S // 2, -1)], dim=1)
    else:
        unpack = tk._unpack_interleaved if variant == "i4" else tk._unpack_groups
        q = unpack(qweight, G, S)  # [G, S, O] nibble values
    dq = variant == "dq"
    if dq:
        xg, rot = tk._bf16(x).reshape(M, G, S), tk._bf16(rot)
        s_all, z_all = tk._bf16(scales), tk._bf16(zeros)
    elif variant == "bf":
        xg = tk.butterfly_rotate_plain(x, *tables, S)  # [M, G, S] f32, the stages' output
        s_all, z_all = scales.to(torch.float32), zeros.to(torch.float32)
    elif variant == "a8":
        xg = x.to(torch.float32).reshape(M, G, S)
        sx, xg = _a8_quantize(xg)
        s_all, z_all = scales.to(torch.float32), zeros.to(torch.float32)
    elif variant in ("pl", "bc", "mf", "wm"):
        xg = x.to(torch.float32).reshape(M, G, S)
        s_all, z_all = scales.to(torch.float32), zeros.to(torch.float32)
    else:
        xg = (x if variant == "v2" else x.to(rot.dtype)).to(torch.float32).reshape(M, G, S)
        s_all, z_all = scales.to(torch.float32), zeros.to(torch.float32)
    splits = split_groups(G, KS, chunk, gps)
    outs, off = [], 0
    for p, n in enumerate(out_splits):
        cols = slice(off, off + n)
        total, chunk_sum = torch.zeros(M, n), torch.zeros(M, n)
        for ks, (c, groups) in enumerate(splits):
            part = torch.zeros(M, n)
            for g in groups:
                s, z = s_all[g, cols], z_all[g, cols]
                if variant == "a8":
                    dot = xg[:, g] @ q[g][:, cols]  # integers below 2**24: exact
                    part = part + (dot - xg[:, g].sum(-1, keepdim=True) * z) * (s * sx[:, g])
                    continue
                xr32 = (xg[:, g] if variant in ("bf", "pl", "bc", "mf", "wm")
                        else xg[:, g] @ rot[p, g].to(torch.float32).T)
                if variant == "ra8":
                    sxg, xq = _a8_quantize(xr32)
                    dot = xq @ q[g][:, cols]  # integers below 2**24: exact
                    part = part + ((dot - xq.sum(-1, keepdim=True) * z) * s) * sxg
                    continue
                xr = xr32.to(torch.bfloat16).to(torch.float32)
                if dq:
                    part = part + xr @ tk._bf16(tk._bf16(q[g][:, cols] - z) * s)
                    continue
                rowsum = (xr32 if variant == "b" else xr).sum(-1, keepdim=True)
                part = part + xr @ (q[g][:, cols] * s) - rowsum * z * s
            chunk_sum = chunk_sum + part
            if ks + 1 == KS or splits[ks + 1][0] != c:  # the chunk's last split
                total, chunk_sum = total + chunk_sum, torch.zeros(M, n)
        outs.append(total)
        off += n
    return torch.cat(outs, dim=-1)


SZ = (np.float32, "bfloat16", np.float16, np.uint8)
XR = ((np.float32, np.float32), ("bfloat16", "bfloat16"), (np.float32, "bfloat16"),
      ("bfloat16", np.float32))
MODEL_CASES = [(S, splits, M) for S in (64, 128, 256)
               for splits in ((66,), (66, 62), (128, 96, 160), (64, 34, 48, 78))
               for M in (1, 2, 5, 16)]


def _np(a, dt):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)) if dt == "bfloat16" else a.astype(dt)


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("S,splits,M", MODEL_CASES)
def test_one_launch_model_matches_pallas(S, splits, M):
    i = MODEL_CASES.index((S, splits, M))
    sz, (xdt, rdt) = SZ[i % 4], XR[(i // 4 + i) % 4]
    rng = np.random.default_rng(1000 + i)
    G, P, O = 3, len(splits), sum(splits)
    I = G * S
    x = _np(rng.normal(size=(M, I)).astype(np.float32), xdt)
    rot = _np((rng.normal(size=(P, G, S, S)) / np.sqrt(S)).astype(np.float32), rdt)
    qweight = rng.integers(0, 256, size=(I // 2, O)).astype(np.uint8)
    if sz is np.uint8:
        scales = rng.integers(1, 4, size=(G, O)).astype(np.uint8)
    else:
        scales = _np(rng.uniform(0.01, 0.05, size=(G, O)).astype(np.float32), sz)
    zeros = _np(rng.integers(0, 16, size=(G, O)).astype(np.float32), sz)

    if P == 1:
        yj = jk.rot_w4_matmul(jnp.asarray(x), jnp.asarray(rot[0]), jnp.asarray(qweight),
                              jnp.asarray(scales), jnp.asarray(zeros), interpret=True)
    else:
        yj = jk.merged_rot_w4_matmul(jnp.asarray(x), jnp.asarray(rot), jnp.asarray(qweight),
                                     jnp.asarray(scales), jnp.asarray(zeros), out_splits=splits,
                                     interpret=True)
    yj = np.asarray(yj.astype(jnp.float32))
    args = [_torch(a) for a in (x, rot, qweight, scales, zeros)]
    route, KS, _ = tk.rot_route(M, I, S, splits, False, args[1].dtype, SMS)
    assert route == "one_launch"
    tol = rot_tolerance(yj, *args, out_splits=splits, bf16_out=args[0].dtype == torch.bfloat16)
    for ks in sorted({KS, 1, 2}):
        y = one_launch_model(*args, splits, ks).to(args[0].dtype).to(torch.float32).numpy()
        assert np.all(np.abs(y - yj) <= tol), (ks, np.abs(y - yj).max())
