"""K8 (`rot_w4_matmul_mg`) and K11 (`dma_rot_w4_matmul`) on the DQ variant of
the one-launch kernel (`paroquant_tpu_torch/kernels/csrc/rot_w4_dequant.cu`,
`one_launch.cuh`), on the CPU.

Both TPU kernels compute one function: xr_g = bf16(bf16(x_g) @ bf16(M_g)^T),
w_g = bf16(bf16(q_g - z_g) s_g) with s and z in bf16, and the f32 sum over
chunks of groups, in order, of each chunk's dot xr @ w. K8's chunk is its
normalised `groups_per_step` (`rot_matmul.mg_chunk`; the last chunk may be
shorter), K11's its Gb.

The launch plan (`kernels/rot_matmul.py::dq_plan`) is a pure function
of shapes and the card's SM count, tested here at an H100's 132 SMs: no
split crosses a chunk, every group lies in one split, one wave of two blocks
an SM holds the grid where some tile allows it, with the fewest groups a
split, and a split never takes more groups than a block may.

The kernel runs only on the card. `one_launch_model`
(tests/test_torch_rot_w4_route.py, variant "dq") models its sums: per split
an f32 partial of its groups' dots, the splits of a chunk added in split
order into the chunk's sum and the chunk sums in chunk order. It is held
against both JAX kernels in Pallas interpret mode (K8 at 16 and 32 groups a
step, G 20 and 40 with a ragged last chunk; K11 at Gb 1, 2, 4, 8) at the
plan's split count, at one and two groups a split and at a whole chunk a
split, on Gaussian x and rotations with fractional zeros.

Tolerance, `rot_tolerance` (tests/test_torch_rot_w4_flips.py) with variant
"dq": the kernel and the TPU kernel sum each rotated activation's S
products in f32 in different orders, so where its exact value lies within
the f32 sums' error bound gamma_S sum_j |x_j r_ij| of a bf16 rounding
midpoint the two may round it one bf16 ulp apart; that element enters y
only through the dot, with coefficient |w| = |bf16(bf16(q - z) s)| (there
is no row sum), so each such element adds ulp |w[i, o]| to the bound of
y[m, o]. The rest is 1e-5 max |y| for the f32 sums of the dot in another
order, and 2**-7 |y| where the output is bf16 (a different f32 sum may
round it one bf16 ulp the other way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu_torch.kernels import rot_matmul as rm, w4_experiments as wx
from test_torch_rot_w4_flips import rot_tolerance
from test_torch_rot_w4_route import one_launch_model, split_groups
from test_torch_w4_experiments import JNP, TORCH, js  # noqa: F401 (fixture)

SMS = 132  # an H100 SXM's SMs
WAVE = rm.BLOCKS_PER_SM * SMS


# ---------------------------------------------------------------------------
# the chunk and the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,gps,chunk", [(32, 16, 16), (32, 32, 32), (20, 16, 16), (20, 32, 20),
                                         (40, 20, 16), (40, 33, 32), (10, 5, 10), (8, 3, 8),
                                         (16, 1, 16), (17, 1, 16), (256, 16, 16), (3, 16, 3)])
def test_mg_chunk_follows_the_jax_wrapper(G, gps, chunk):
    """JAX's rot_w4_matmul_mg: Gb = min(gps, G), and a Gb below G that is
    not a multiple of 16 becomes the largest multiple of 16 below it (at
    least 16), or G where G < 16."""
    assert rm.mg_chunk(G, gps) == chunk


def test_mg_chunk_refuses_no_groups_a_step():
    with pytest.raises(ValueError, match="groups_per_step"):
        rm.mg_chunk(8, 0)


def _check_plan(M, I, S, O, chunk, plan):
    """No split crosses a chunk, the splits cover the groups once, each holds
    at least one and at most the block's limit of groups, and the block fits
    shared memory."""
    KS, tile, mt, gps = plan
    G = I // S
    chunk = min(chunk, G)
    seen = []
    for c, groups in split_groups(G, KS, chunk, gps):
        assert 1 <= len(groups) <= gps
        assert groups[0] // chunk == groups[-1] // chunk == c  # within chunk c
        seen += list(groups)
    assert seen == list(range(G))
    assert gps <= max(1, min(rm.ONE_LAUNCH_MAX_GROUPS, rm.ONE_LAUNCH_X_FLOATS // (mt * S),
                             rm.ONE_LAUNCH_SZ_FLOATS // tile))
    assert rm._one_launch_smem(mt, S, gps, tile) <= rm.MAX_SMEM_BYTES


def _blocks(M, O, plan):
    KS, tile, mt, _ = plan
    return -(-O // tile) * -(-M // mt) * KS


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 32])
def test_plan_at_the_scripts_shape(chunk):
    """4096 x 4096, g128, M 1: K11 at Gb 1, 2, 4, 8 and K8 at 16 and 32
    groups a step all take K10's plan, one group a split of 512 columns."""
    plan = rm.dq_plan(1, 4096, 128, 4096, SMS, chunk)
    assert plan == (32, 512, 1, 1)
    _check_plan(1, 4096, 128, 4096, chunk, plan)
    assert _blocks(1, 4096, plan) <= WAVE


SWEEP = {4096: (32, 512, 1, 1), 8192: (32, 512, 1, 2), 16384: (32, 512, 1, 4),
         32768: (64, 512, 1, 4)}


@pytest.mark.parametrize("I", list(SWEEP))
def test_plan_over_the_speedup_sweep(I):
    """The kernel-speedup sweep (M 1, O 4096, g128, K8's default 16 groups a
    step): 512-column tiles of 1, 2, 4 groups a split (at most 2048 / 512 a
    block), one wave up to I = 16384 and two past it."""
    G = I // 128
    chunk = rm.mg_chunk(G, 16)
    plan = rm.dq_plan(1, I, 128, 4096, SMS, chunk)
    assert plan == SWEEP[I]
    _check_plan(1, I, 128, 4096, chunk, plan)
    assert (_blocks(1, 4096, plan) <= WAVE) == (I <= 16384)


@pytest.mark.parametrize("M", [1, 16])
def test_one_launch_plan_keeps_128_column_tiles_past_one_wave(M):
    """K10/K12's plan is `dq_plan` with all groups one chunk, but past one
    wave (I = 32768, O = 4096) it keeps 128-column tiles where K8 and K11
    take 512."""
    plan = wx.one_launch_plan(M, 32768, 128, 4096, SMS)
    assert plan == rm.dq_plan(M, 32768, 128, 4096, SMS, 256, wide_past_wave=False)[:3]
    assert plan[1] == rm.COLS_PER_TILE and _blocks(M, 4096, (*plan, 0)) > WAVE
    assert rm.dq_plan(M, 32768, 128, 4096, SMS, 256)[1] == 512


PLAN_SHAPES = [(M, I, S, O, chunk) for M in (1, 5, 16, 17, 33)
               for I, S, O in ((4096, 128, 4096), (2048, 128, 1024), (2560, 64, 160),
                               (1280, 64, 130), (512, 256, 128))
               for chunk in (1, 3, 4, 16, 64)]


@pytest.mark.parametrize("M,I,S,O,chunk", PLAN_SHAPES)
def test_plan_fills_one_wave_without_crossing_a_chunk(M, I, S, O, chunk):
    """Where some tile fits one wave, the plan does, and no tile that fits
    allows fewer groups a split; otherwise, past one wave, 512-column tiles
    of the most groups a split they allow at M <= 16 and 128-column tiles
    at M > 16."""
    plan = rm.dq_plan(M, I, S, O, SMS, chunk)
    KS, tile, mt, gps = plan
    G = I // S
    _check_plan(M, I, S, O, chunk, plan)
    assert KS == rm.chunk_splits(G, min(chunk, G), gps)
    fits = {}
    for t in rm.ONE_LAUNCH_TILES:
        limit = max(1, min(16, 4096 // (mt * S), 2048 // t, min(chunk, G)))
        n = -(-O // t) * -(-M // mt)
        ok = [g for g in range(1, limit + 1) if n * rm.chunk_splits(G, min(chunk, G), g) <= WAVE]
        if ok:
            fits[t] = ok[0]
    if fits:
        assert _blocks(M, O, plan) <= WAVE and gps == min(fits.values())
    elif M <= 16:
        assert tile == 512 and gps == max(1, min(16, 4096 // (mt * S), 2048 // 512, min(chunk, G)))
    else:
        assert tile == rm.COLS_PER_TILE


MG_ROUTES = [(I, O, M, route) for I, O in ((4096, 4096), (2560, 1024), (2048, 1024))
             for M, route in ((1, "one_launch"), (16, "one_launch"), (17, "passes"),
                              (33, "passes"), (128, "passes"))]


@pytest.mark.parametrize("I,O,M,route", MG_ROUTES)
def test_mg_route(I, O, M, route):
    """K8 takes the DQ variant at M <= 16 and the passes above, whatever
    the weight's size."""
    got, plan = rm.mg_route(M, I, 128, O, 16, SMS)
    assert got == route
    assert (plan == rm.dq_plan(M, I, 128, O, SMS, 16)) if route == "one_launch" else plan is None


def test_mg_route_takes_the_passes_where_a_group_does_not_fit():
    assert rm.mg_route(1, 32768, 32768, 128, 1, SMS) == ("passes", None)


# ---------------------------------------------------------------------------
# the kernel model against the JAX kernels
# ---------------------------------------------------------------------------

# kernel, knob (K8: groups_per_step, K11: Gb), G, S
MODEL_CASES = [("k11", gb, 8, S) for gb in (1, 2, 4, 8) for S in (64, 128)] + \
              [("k8", gps, G, 64) for gps in (16, 32) for G in (20, 40)]
DTYPES = (("f32", "f32", "f32", "f32"), ("bf16", "bf16", "bf16", "bf16"),  # x, rot, scales, zeros
          ("bf16", "f32", "f16", "f32"), ("f32", "bf16", "u8", "u8"))
MS = (1, 5, 16)
O = 160


def _draw(seed, G, S, M, kinds):
    """Gaussian x and rotation, random nibbles, scales ~ U(0.01, 0.05) (1-3
    where uint8) and zeros ~ U(0, 15) (integers where uint8); (JAX arrays,
    torch tensors) of the kinds named."""
    rng = np.random.default_rng(seed)
    I = G * S
    x = rng.normal(size=(M, I)).astype(np.float32)
    rot = (rng.normal(size=(G, S, S)) / np.sqrt(S)).astype(np.float32)
    qw = rng.integers(0, 256, size=(I // 2, O)).astype(np.uint8)
    s = (rng.integers(1, 4, size=(G, O)) if kinds[2] == "u8"
         else rng.uniform(0.01, 0.05, size=(G, O))).astype(np.float32)
    z = (rng.integers(0, 16, size=(G, O)) if kinds[3] == "u8"
         else rng.uniform(0, 15, size=(G, O))).astype(np.float32)
    kinds = (kinds[0], kinds[1], "u8", kinds[2], kinds[3])
    arrays = (x, rot, qw, s, z)
    return ([jnp.asarray(a, JNP[k]) for a, k in zip(arrays, kinds)],
            [torch.from_numpy(a).to(TORCH[k]) for a, k in zip(arrays, kinds)])


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("kernel,knob,G,S", MODEL_CASES)
def test_dq_model_matches_the_jax_kernels(js, kernel, knob, G, S, M):  # noqa: F811
    i = MODEL_CASES.index((kernel, knob, G, S)) * len(MS) + MS.index(M)
    kinds = DTYPES[i % len(DTYPES)]
    jops, tops = _draw(2000 + i, G, S, M, kinds)
    if kernel == "k8":
        chunk = rm.mg_chunk(G, knob)
        yj = jk.rot_w4_matmul_mg(*jops, groups_per_step=knob, interpret=True)
    else:
        chunk = knob
        yj = js["kernel_dma_pipeline"].dma_rot_w4_matmul(*jops, Gb=knob, interpret=True)
    yj = np.asarray(yj.astype(jnp.float32), np.float64)
    x, rot, qw, s, z = tops
    bf16_out = x.dtype == torch.bfloat16
    tol = rot_tolerance(yj, x, rot, qw, s, z, variant="dq", bf16_out=bf16_out)
    KS, _, _, gps_plan = rm.dq_plan(M, G * S, S, O, SMS, chunk)
    C = min(chunk, G)
    for gps in sorted({gps_plan, 1, min(2, C), C}):
        ks = rm.chunk_splits(G, C, gps)
        assert gps != gps_plan or ks == KS
        y = one_launch_model(x, rot[None], qw, s, z, (O,), ks, "dq", chunk=C, gps=gps)
        y = y.to(x.dtype).to(torch.float64).numpy()
        assert np.all(np.abs(y - yj) <= tol), (gps, (np.abs(y - yj) / tol).max())
    # the plain version, which the wrappers run on the CPU, meets the same bound
    if kernel == "k8":
        y = rm.rot_w4_matmul_mg(x, rot, qw, s, z, groups_per_step=knob)
    else:
        y = wx.dma_rot_w4_matmul(x, rot, qw, s, z, Gb=knob)
    assert y.dtype == x.dtype
    assert np.all(np.abs(y.to(torch.float64).numpy() - yj) <= tol)
