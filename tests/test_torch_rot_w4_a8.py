"""K1/K2's `a8` branch on the RA8 variant of the one-launch kernel, and K6
(`w4_matmul`) on its PL variant (`paroquant_tpu_torch/kernels/csrc/one_launch.cuh`),
on the CPU.

The routes and plans (`kernels/rot_matmul.py::rot_route`, `ra8_plan`,
`w4_route`, `w4_plan`) are pure functions of shapes and the card's SM
count, tested here at an H100's 132 SMs: every `a8` call at M <= 16 and S
<= 256 (a multiple of 8) takes "ra8" (Qwen3-0.6B's decode linears on the ordinary one-launch
grid, its 151936-wide lm_head in runs of column tiles, every plan within one
wave and every split non-empty), `a8` at M > 16 or S > 256 the passes; K6
takes the PL variant at M <= 16 and the passes above. Which entry point each
wrapper calls, with which plan, is checked on meta tensors with the library
replaced by a recorder.

The kernels run only on the card. `one_launch_model`
(tests/test_torch_rot_w4_route.py, variants "ra8" and "pl") models their
sums: per split an f32 partial over its groups, the partials summed in
split order. It is held against JAX's `rot_w4_matmul` / `merged_rot_w4_matmul`
with a8=True and `w4_matmul`, in Pallas interpret mode, on Gaussian inputs
from numpy seeds, at the plan's split count and at one and two groups a
split.

RA8's tolerance, `a8_tolerance`, derived as `rot_tolerance`
(tests/test_torch_rot_w4_flips.py) is: each side computes xr = x_g @ M_g^T
in f32 in its own order, so an element lies within eps_i = gamma_S sum_j
|x_j r_ij| (gamma_S = S u / (1 - S u), u = 2**-24) of its exact value v_i
(float64 here). Then each side's max |xr| lies within E = max_i eps_i of
the exact one, and its sx = fl(max / 127) within dsx = E / 127 + 2 u (max +
E) / 127 of sx0 = max |v| / 127. Each side's xr / sx (rounded once) lies
within tau_i = eps_i / sx_lo + |v_i| dsx / (sx0 sx_lo) + 2 u (|v_i / sx0| +
1) of t_i = v_i / sx0 (sx_lo = sx0 - dsx). Where t_i lies within tau_i of a
half-integer, the two sides' xq_i may round one step apart, which moves y
by at most (sx0 + dsx) |(q_i - z) s|; and the two sides' sx differ by at
most 2 dsx, which moves a group's term ((xq . q - sum(xq) z) s) sx by at
most 2 dsx sum_i (|xq_i| + 1) |(q_i - z) s|. So

    |y - y_ref| <= 1e-5 max |y_ref| + sum over near-half elements of
                   (sx0 + dsx) |(q - z) s| + sum_g 2 dsx_g sum_i (|xq_i| + 1)
                   |(q_i - z) s| (+ 2**-7 |y_ref| where y is bf16)

where the first term, as in `rot_tolerance`, covers the f32 epilogue and
sums taken in another order (the dot and sum(xq) z are exact integers). K6's
model is held to 1e-5 max |y| (plus 2**-7 |y| for a bf16 output): xr =
bf16(x) is exact on both sides, so only f32 sums differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu.ops import packing as jpk
from paroquant_tpu_torch.kernels import rot_matmul as rm
from paroquant_tpu_torch.ops import packing as tpk
from test_torch_rot_w4_flips import U32, _f64
from test_torch_rot_w4_route import QWEN3_DECODE, one_launch_model, split_groups
from test_torch_w4_bf_a8 import recorded  # noqa: F401 (fixture)
from test_torch_w4_experiments import JNP, TORCH

SMS = 132  # an H100 SXM's SMs
WAVE = rm.BLOCKS_PER_SM * SMS
LM_HEAD = (1024, (151936,))  # Qwen3-0.6B's lm_head: I, out_splits
BF16_ULP = 2.0**-7


def _ra8(M, I, splits, S=128):
    route, KS, tile = rm.rot_route(M, I, S, splits, True, torch.bfloat16, SMS)
    plan = rm.ra8_plan(M, I, S, splits, SMS)
    assert route == "ra8" and (KS, tile) == plan[:2]
    return plan


def _check_ra8_plan(M, I, S, splits, plan):
    """One wave, every split non-empty, the groups a block within the
    kernel's limits, its shared memory within a block's."""
    KS, tile, mt, gps, tpb = plan
    G = I // S
    assert tile == rm.RA8_TILE and mt == rm._row_tile(M, S)
    assert gps == -(-G // KS) and 1 <= KS <= G and (KS - 1) * gps < G
    assert sorted(g for _, r in split_groups(G, KS) for g in r) == list(range(G))
    assert gps <= min(rm.ONE_LAUNCH_MAX_GROUPS, rm.ONE_LAUNCH_X_FLOATS // (mt * S),
                      rm.ONE_LAUNCH_SZ_FLOATS // tile)
    assert rm._one_launch_smem(mt, S, gps, tile, gps * mt) <= rm.MAX_SMEM_BYTES
    runs = sum(-(-((n + tile - 1) // tile) // tpb) for n in splits) * -(-M // mt)
    assert runs * KS <= WAVE
    return runs


# ---------------------------------------------------------------------------
# the routes and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("layer", list(QWEN3_DECODE))
def test_a8_decode_linears_take_ra8_on_the_one_wave_grid(layer, M):
    I, splits = QWEN3_DECODE[layer]
    plan = _ra8(M, I, splits)
    _check_ra8_plan(M, I, 128, splits, plan)
    assert plan[4] == 1  # a tile a block: the ordinary one-launch grid


LM_HEAD_PLANS = {1: (8, 512, 1, 1, 9), 8: (4, 512, 8, 2, 5), 16: (4, 512, 8, 2, 9)}


@pytest.mark.parametrize("M", list(LM_HEAD_PLANS))
def test_lm_head_takes_ra8_in_runs_within_one_wave(M):
    I, splits = LM_HEAD
    plan = _ra8(M, I, splits)
    assert plan == LM_HEAD_PLANS[M]
    _check_ra8_plan(M, I, 128, splits, plan)
    assert 297 * plan[0] * -(-M // plan[2]) > WAVE  # a tile a block would exceed one wave


@pytest.mark.parametrize("M", range(1, 17))
@pytest.mark.parametrize("S,splits", [(64, (66, 62)), (128, (151936,)), (256, (128, 96, 160)),
                                      (128, (2048, 1024, 1024, 4096)), (256, (40000,))])
def test_ra8_plan_at_every_m(M, S, splits):
    plan = rm.ra8_plan(M, 8 * S, S, splits, SMS)
    _check_ra8_plan(M, 8 * S, S, splits, plan)


@pytest.mark.parametrize("gps", [1, 2, 4])
@pytest.mark.parametrize("M", [1, 8, 16])
def test_lm_head_forced_splits_fit_one_wave(M, gps):
    """The candidates `scripts/ra8_split_sweep.py` times: 8, 4 and 2 splits."""
    plan = rm.ra8_plan(M, LM_HEAD[0], 128, LM_HEAD[1], SMS, gps=gps)
    assert plan[0] == 8 // gps and plan[3] == gps
    _check_ra8_plan(M, LM_HEAD[0], 128, LM_HEAD[1], plan)


A8_PASSES = {  # case: M, I, S, out_splits
    "M17": (17, 2048, 128, (1024,)),
    "M128_qkv": (128, 1024, 128, (2048, 1024, 1024)),
    "S512": (1, 1024, 512, (1024,)),
    "S1024": (1, 2048, 1024, (1024,)),
    "S100": (1, 1000, 100, (1024,)),  # S not a multiple of 8
    "lm_head_M17": (17, 1024, 128, (151936,)),
}


@pytest.mark.parametrize("case", list(A8_PASSES))
def test_other_a8_calls_take_the_passes(case):
    M, I, S, splits = A8_PASSES[case]
    route, KS, tile = rm.rot_route(M, I, S, splits, True, torch.bfloat16, SMS)
    assert route == "passes" and tile == rm.COLS_PER_TILE


@pytest.mark.parametrize("M", [1, 5, 8, 16])
def test_k6_takes_the_pl_variant_to_sixteen_rows(M):
    route, plan = rm.w4_route(M, 4096, 128, 4096, SMS)
    assert route == "one_launch" and plan == rm.w4_plan(M, 4096, 128, 4096, SMS)
    KS, tile, mt, gps = plan
    assert -(-4096 // tile) * -(-M // mt) * KS <= WAVE
    assert sorted(g for _, r in split_groups(32, KS) for g in r) == list(range(32))
    if M == 1:
        assert plan == (32, 512, 1, 1)  # K7's plan at the benchmarks' shape


@pytest.mark.parametrize("M", [17, 32, 128])
def test_k6_past_sixteen_rows_takes_the_passes(M):
    assert rm.w4_route(M, 4096, 128, 4096, SMS) == ("passes", None)


def test_k6_with_a_group_too_wide_for_a_block_takes_the_passes():
    assert rm.w4_route(1, 65536, 32768, 128, SMS) == ("passes", None)


# ---------------------------------------------------------------------------
# the wrappers' launches, on meta tensors with the library recorded
# ---------------------------------------------------------------------------


def _meta(M, I, O, P=None, S=128):
    G = I // S
    meta = dict(device="meta")
    rot = (G, S, S) if P is None else (P, G, S, S)
    return (torch.empty(M, I, dtype=torch.bfloat16, **meta),
            torch.empty(rot, dtype=torch.bfloat16, **meta),
            torch.empty(I // 2, O, dtype=torch.uint8, **meta),
            torch.empty(G, O, dtype=torch.float16, **meta),
            torch.empty(G, O, dtype=torch.uint8, **meta))


@pytest.mark.parametrize("M", [1, 8, 16, 17])
def test_lm_head_a8_launches_ra8(recorded, M):  # noqa: F811
    I, (O,) = LM_HEAD
    x, rot, qw, s, z = _meta(M, I, O)
    rm.reset_launch_counts()
    rm.rot_w4_matmul(x, rot, qw, s, z, a8=True)
    ((entry, args),) = recorded
    if M <= rm.ONE_LAUNCH_MAX_M:
        KS, tile, _, _, tpb = rm.ra8_plan(M, I, 128, (O,), SMS)
        assert entry == "paro_rot_w4_matmul_ra8"
        assert args[8:12] == (M, I, 128, 1) and list(args[12]) == [O]
        assert args[13:20] == (KS, tile // rm.COLS_PER_TILE, tpb, 1, 1, rm.SZ_CODES[torch.float16],
                               rm.SZ_CODES[torch.uint8])
        assert rm.route_counts["rot_w4_matmul"]["ra8"] == 1
    else:
        assert entry == "paro_rot_w4_matmul" and args[19] == 1  # the passes with a8
        assert rm.route_counts["rot_w4_matmul"]["passes"] == 1
    assert rm.variant_counts["rot_w4_matmul"] == [0, 1]
    assert rm.launch_counts["rot_w4_matmul"] == 1


@pytest.mark.parametrize("layer", ["qkv_proj", "gate_up_proj"])
def test_merged_a8_launches_ra8(recorded, layer):  # noqa: F811
    I, splits = QWEN3_DECODE[layer]
    x, rot, qw, s, z = _meta(8, I, sum(splits), P=len(splits))
    rm.reset_launch_counts()
    rm.merged_rot_w4_matmul(x, rot, qw, s, z, out_splits=splits, a8=True)
    ((entry, args),) = recorded
    KS, tile, _, _, tpb = rm.ra8_plan(8, I, 128, splits, SMS)
    assert entry == "paro_rot_w4_matmul_ra8"
    assert args[11] == len(splits) and tuple(args[12]) == splits
    assert args[13:16] == (KS, tile // rm.COLS_PER_TILE, tpb) and tpb == 1
    assert rm.route_counts["merged_rot_w4_matmul"]["ra8"] == 1


# ---------------------------------------------------------------------------
# the kernel models against the Pallas kernels
# ---------------------------------------------------------------------------


def a8_tolerance(y_ref, x, rot, qweight, scales, zeros, out_splits=None, *,
                 bf16_out=False) -> np.ndarray:
    """The elementwise bound of the module docstring around y_ref (numpy):
    x [M, I] as the caller passes it, rot [G, S, S] or [P, G, S, S],
    qweight uint8 [I//2, O] half-split, scales/zeros [G, O] (torch)."""
    rot = rot if rot.dim() == 4 else rot[None]
    P, G, S, _ = rot.shape
    M = x.shape[0]
    out_splits = out_splits or (qweight.shape[1],)
    xg = _f64(x.to(rot.dtype)).reshape(M, G, S)
    q = _f64(rm._unpack_groups(qweight, G, S))  # [G, S, O]
    coef = np.abs((q - _f64(zeros)[:, None]) * _f64(scales)[:, None])
    gamma = S * U32 / (1 - S * U32)
    parts, off = [], 0
    for p, n in enumerate(out_splits):
        r = _f64(rot[p])
        v = np.einsum("mgj,gij->mgi", xg, r)
        eps = gamma * np.einsum("mgj,gij->mgi", np.abs(xg), np.abs(r))
        amax = np.abs(v).max(-1, keepdims=True)
        E = eps.max(-1, keepdims=True)
        assert np.all((amax == 0) == (E == 0)) and np.all(E < amax / 2 + (amax == 0))
        sx0 = np.where(amax > 0, amax / 127, 1.0)
        dsx = np.where(amax > 0, E / 127 + 2 * U32 * (amax + E) / 127, 0.0)
        t = v / sx0
        tau = eps / (sx0 - dsx) + np.abs(v) * dsx / (sx0 * (sx0 - dsx)) + 2 * U32 * (np.abs(t) + 1)
        near = np.abs(t - (np.floor(t) + 0.5)) <= tau
        c = coef[:, :, off:off + n]
        flips = np.einsum("mgi,gio->mo", near * (sx0 + dsx), c)
        terms = np.einsum("mgi,gio->mgo", np.abs(np.round(t)) + 1, c)
        parts.append(flips + np.einsum("mg,mgo->mo", 2 * dsx[..., 0], terms))
        off += n
    y_ref = np.asarray(y_ref, np.float64)
    tol = 1e-5 * np.abs(y_ref).max() + np.concatenate(parts, axis=1)
    return tol + (BF16_ULP * np.abs(y_ref) if bf16_out else 0.0)


SZ_KINDS = ("f32", "bf16", "f16", "u8")
XR_KINDS = (("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16"), ("bf16", "f32"))  # x, rot
RA8_SPLITS = {1: (160,), 2: (66, 62), 3: (128, 96, 160)}
RA8_CASES = [(S, P, M) for S in (64, 128, 256) for P in (1, 2, 3) for M in (1, 5, 8, 16)]
G_RA8 = 3


def _ra8_draw(seed, S, P, M, xk, rk, szk):
    """numpy operands: Gaussian x and rotations, random nibbles, scales
    and integer zeros in their dtypes; row M // 2 of x all zero."""
    rng = np.random.default_rng(seed)
    splits = RA8_SPLITS[P]
    I, O = G_RA8 * S, sum(splits)
    x = rng.normal(size=(M, I)).astype(np.float32)
    x[M // 2] = 0  # sx = 1, xq = 0: the row's output is exactly 0
    rot = (rng.normal(size=(P, G_RA8, S, S)) / np.sqrt(S)).astype(np.float32)
    qw = rng.integers(0, 256, size=(I // 2, O)).astype(np.uint8)
    s = (rng.integers(1, 4, size=(G_RA8, O)) if szk == "u8"
         else rng.uniform(0.01, 0.05, size=(G_RA8, O))).astype(np.float32)
    z = rng.integers(0, 16, size=(G_RA8, O)).astype(np.float32)
    kinds = (xk, rk, "u8", szk, szk)
    jops = [jnp.asarray(a, JNP[k]) for a, k in zip((x, rot, qw, s, z), kinds)]
    tops = [torch.from_numpy(a).to(TORCH[k]) for a, k in zip((x, rot, qw, s, z), kinds)]
    return jops, tops, splits


@pytest.mark.parametrize("S,P,M", RA8_CASES)
def test_ra8_model_matches_pallas(S, P, M):
    i = RA8_CASES.index((S, P, M))
    xk, rk = XR_KINDS[(i + i // 4) % 4]
    jops, tops, splits = _ra8_draw(800 + i, S, P, M, xk, rk, SZ_KINDS[i % 4])
    if P == 1:
        yj = jk.rot_w4_matmul(jops[0], jops[1][0], *jops[2:], a8=True, interpret=True)
    else:
        yj = jk.merged_rot_w4_matmul(*jops, out_splits=splits, a8=True, interpret=True)
    yj = np.asarray(yj.astype(jnp.float32), np.float64)
    x = tops[0]
    tol = a8_tolerance(yj, *tops, out_splits=splits, bf16_out=x.dtype == torch.bfloat16)
    KS = _ra8(M, G_RA8 * S, splits, S)[0]
    for ks in sorted({KS, 1, 2, 3}):  # the plan's, three, two and one groups a split
        y = one_launch_model(*tops, splits, ks, "ra8").to(x.dtype).to(torch.float64).numpy()
        assert np.all(np.abs(y - yj) <= tol), (ks, (np.abs(y - yj) / tol).max())
        assert np.all(y[M // 2] == 0)


def test_a8_tolerance_covers_an_xq_at_a_half_integer():
    """x_1 / sx = 2.5 exactly (identity rotation, max |x| = 127, so sx = 1):
    the two sides may round xq_1 to 2 or 3, and the bound holds the move of
    one step, |(q_1 - z) s| sx, in every column."""
    S, O = 128, 160
    rng = np.random.default_rng(7)
    x = np.zeros((1, S), np.float32)
    x[0, 0], x[0, 1] = 127.0, 2.5
    rot = np.eye(S, dtype=np.float32)[None, None]  # [P, G, S, S]
    q = rng.integers(0, 16, size=(S, O)).astype(np.int32)
    s = rng.uniform(0.01, 0.05, size=(1, O)).astype(np.float32)
    z = rng.integers(0, 16, size=(1, O)).astype(np.float32)
    qw = tpk.pack_w4_tpu(q, S)
    ops = [torch.from_numpy(a) for a in (x, rot)] + [qw] + [torch.from_numpy(a) for a in (s, z)]
    y = one_launch_model(*ops, (O,), 1, "ra8").to(torch.float64).numpy()
    assert np.allclose(y, (127 * (q[0] - z[0]) + 2 * (q[1] - z[0])) * s[0])  # half to even: 2
    step = np.abs((q[1] - z[0]) * s[0])  # sx = 1
    assert np.all(a8_tolerance(y, *ops) - 1e-5 * np.abs(y).max() >= step)


PL_CASES = [(S, M, k) for S in (64, 128, 256) for M in (1, 5, 16) for k in range(2)]


@pytest.mark.parametrize("S,M,k", PL_CASES)
def test_pl_model_matches_pallas(S, M, k):
    i = PL_CASES.index((S, M, k))
    szk, xk = SZ_KINDS[i % 4], ("f32", "bf16")[k]
    rng = np.random.default_rng(1000 + i)
    G, O = 4, 160
    I = G * S
    x = rng.normal(size=(M, I)).astype(np.float32)
    q = rng.integers(0, 16, size=(I, O), dtype=np.int32)
    s = (rng.integers(1, 4, size=(G, O)) if szk == "u8"
         else rng.uniform(0.01, 0.05, size=(G, O))).astype(np.float32)
    z = rng.integers(0, 16, size=(G, O)).astype(np.float32)
    qw = np.asarray(jpk.pack_w4_tpu(q, S))
    yj = jk.w4_matmul(jnp.asarray(x, JNP[xk]), jnp.asarray(qw), jnp.asarray(s, JNP[szk]),
                      jnp.asarray(z, JNP[szk]), group_size=S, interpret=True)
    yj = np.asarray(yj.astype(jnp.float32), np.float64)
    xt = torch.from_numpy(x).to(TORCH[xk])
    st, zt = (torch.from_numpy(a).to(TORCH[szk]) for a in (s, z))
    qt = tpk.pack_w4_tpu(q, S)
    tol = 1e-5 * np.abs(yj).max() + (BF16_ULP * np.abs(yj) if xk == "bf16" else 0.0)
    KS = rm.w4_plan(M, I, S, O, SMS)[0]
    for ks in sorted({KS, 1, 2}):
        y = one_launch_model(xt, None, qt, st, zt, (O,), ks, "pl").to(xt.dtype)
        y = y.to(torch.float64).numpy()
        assert np.all(np.abs(y - yj) <= tol), (ks, (np.abs(y - yj) / tol).max())
