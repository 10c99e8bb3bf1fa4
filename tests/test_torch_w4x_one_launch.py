"""K10 (`rot_w4_matmul_b`) and K12 (`rot_w4_matmul_v2`) on the one-launch
kernel (`paroquant_tpu_torch/kernels/csrc/one_launch.cuh`), on the CPU.

The launch plan (`kernels/w4_experiments.py::one_launch_plan`) is a pure
function of shapes and the card's SM count, so it is tested here at an
H100's 132 SMs: at 4096 x 4096 and M 1-16 one wave of two blocks an SM
with the fewest groups a block (one group of 512 columns at M <= 8); past
one wave, 128-column tiles and as many splits as fill it; at groups wider
than 512 fewer rows a block; and every split holds at least one group.

The kernel runs only on the card. `one_launch_model`
(tests/test_torch_rot_w4_route.py) models its sums with K10's and K12's
switches (K10: the row sum of the f32 xr; K12: x not rounded, f32 out) and
is held against the JAX scripts' kernels in Pallas interpret mode at the
plan's split count and at one and two groups a split, on Gaussian inputs
from numpy seeds, to `rot_tolerance` (tests/test_torch_rot_w4_flips.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu_torch.kernels import rot_matmul as rm, w4_experiments as wx
from paroquant_tpu_torch.scripts import one_launch_phases, one_launch_sass
from test_torch_rot_w4_flips import rot_tolerance
from test_torch_rot_w4_route import one_launch_model
from test_torch_w4_experiments import JNP, TORCH, interpret, js  # noqa: F401 (fixtures)

SMS = 132  # an H100 SXM's SMs
WAVE = rm.BLOCKS_PER_SM * SMS


def _blocks(M, O, plan):
    KS, tile, mt = plan
    return -(-O // tile) * -(-M // mt) * KS


def _check_splits(M, I, S, plan):
    KS, tile, mt = plan
    G = I // S
    gps = -(-G // KS)
    assert (KS - 1) * gps < G  # the last split holds at least one group
    gmax = min(rm.ONE_LAUNCH_MAX_GROUPS, rm.ONE_LAUNCH_X_FLOATS // (mt * S),
               rm.ONE_LAUNCH_SZ_FLOATS // tile)
    assert gps <= max(1, gmax)
    assert wx._one_launch_smem(mt, S, gps, tile) <= wx.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

SCRIPT_PLANS = {  # M: (KS, tile, rows per block) at 4096 x 4096, g128, 132 SMs
    1: (32, 512, 1),
    8: (32, 512, 8),
    16: (16, 512, 8),
    17: (11, 512, 8),
    33: (8, 128, 8),
}


@pytest.mark.parametrize("M", list(SCRIPT_PLANS))
def test_plan_at_the_scripts_shape(M):
    plan = wx.one_launch_plan(M, 4096, 128, 4096, SMS)
    assert plan == SCRIPT_PLANS[M]
    _check_splits(M, 4096, 128, plan)
    assert (_blocks(M, 4096, plan) <= WAVE) == (M <= 17)  # M 33: past one wave
    assert -(-M // plan[2]) == -(-M // 8)  # M 9-16: two row tiles of 8


PLAN_SHAPES = [(M, I, S, O) for M in (1, 3, 8, 16, 17, 33, 64)
               for I, S, O in ((4096, 128, 4096), (2048, 128, 1024), (256, 128, 160),
                               (192, 96, 130), (512, 256, 128))]


@pytest.mark.parametrize("M,I,S,O", PLAN_SHAPES)
def test_plan_fills_one_wave_or_splits_past_it(M, I, S, O):
    """Where some tile fits one wave, the plan does and no tile that fits
    gives fewer groups a block; otherwise 128-column tiles and
    `_group_splits`."""
    plan = wx.one_launch_plan(M, I, S, O, SMS)
    KS, tile, mt = plan
    G = I // S
    _check_splits(M, I, S, plan)
    fits = {}
    for t in rm.ONE_LAUNCH_TILES:  # the fewest groups a block each tile allows in one wave
        ks = min(G, WAVE // (-(-O // t) * -(-M // mt)))
        if ks >= 1 and -(-G // ks) <= max(1, min(16, 4096 // (mt * S), 2048 // t)):
            fits[t] = -(-G // ks)
    if fits:
        assert _blocks(M, O, plan) <= WAVE and -(-G // KS) == min(fits.values())
    else:
        assert tile == rm.COLS_PER_TILE
        assert KS == rm._group_splits(-(-O // tile), -(-M // mt), G, SMS,
                                      max(1, min(16, 4096 // (mt * S), 16)))


WIDE_GROUPS = [(M, S, G) for M in (1, 3, 16) for S, G in ((512, 2), (1024, 1), (4096, 2), (16384, 1))]


@pytest.mark.parametrize("M,S,G", WIDE_GROUPS)
def test_plan_at_wide_groups(M, S, G):
    plan = wx.one_launch_plan(M, G * S, S, 256, SMS)
    mt = plan[2]
    assert mt == max(1, min(rm.one_launch_row_tile(M), 4096 // S))
    _check_splits(M, G * S, S, plan)


def test_plan_refuses_a_group_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        wx.one_launch_plan(1, 32768, 32768, 128, SMS)


@pytest.mark.parametrize("M,S,rows", [(1, 128, 1), (2, 128, 2), (3, 128, 4), (5, 128, 8),
                                      (16, 128, 8), (33, 256, 8), (16, 1024, 4), (9, 2048, 2),
                                      (4, 4096, 1)])
def test_block_m_maps_onto_row_tiles_of_at_most_eight(M, S, rows):
    """block_m (8 or 16) does not enter the plan: a block carries `rows`
    rows whichever the caller names, and M 9-16 run as two tiles of 8."""
    assert wx._row_tile(M, S) == rows
    assert wx.one_launch_plan(M, 2 * S, S, 256, SMS)[2] == rows


@pytest.mark.parametrize("kernel", ["rot_w4_matmul_b", "rot_w4_matmul_v2"])
def test_block_m_leaves_the_cpu_result_alone(kernel):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32))
    rot = torch.from_numpy((rng.normal(size=(2, 128, 128)) / np.sqrt(128)).astype(np.float32))
    qw = torch.from_numpy(rng.integers(0, 256, (128, 160)).astype(np.uint8))
    s = torch.from_numpy(rng.uniform(0.01, 0.05, (2, 160)).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, 16, (2, 160)).astype(np.float32))
    fn = getattr(wx, kernel)
    assert torch.equal(fn(x, rot, qw, s, z, block_m=8), fn(x, rot, qw, s, z, block_m=16))


SASS = """
		Function : _ZN4paro3one24rot_w4_one_launch_kernelIffLi1ELi1EEEvNS0_4ArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
		Function : _ZN4paro3one24rot_w4_one_launch_kernelIffLi1ELi5EEEvNS0_4ArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
		Function : _ZN4paro2w413reduce_kernelIfEEvPKfPT_im
        /*0000*/                   EXIT ;
"""


def test_sass_comparison_counts_identical_instances_by_variant():
    """scripts/one_launch_sass.py: the one-launch instances of a cuobjdump
    listing, by variant, and how many compile to the same SASS."""
    ref = one_launch_sass.sass_functions(SASS)
    assert sorted(one_launch_sass.variant_of(f) for f in ref) == [1, 5]
    moved = {f: body.replace("R1,", "R2,") if f.endswith("Li5EEEvNS0_4ArgsE") else body
             for f, body in ref.items()}
    assert one_launch_sass.compare(ref, moved) == {1: [1, 1], 5: [0, 1]}
    assert one_launch_sass.count_by_variant(ref) == {1: 1, 5: 1}


UNPACK_SASS = """
		Function : _ZN4paro3one24rot_w4_one_launch_kernelIffLi1ELi8EEEvNS0_4ArgsE
        /*0000*/                   LOP3.LUT R5, R4, 0xf, RZ, 0xc0, !PT ;
        /*0010*/                   I2FP.F32.U32 R6, R5 ;
        /*0020*/              @!P0 I2FP.F32.U32 R7, R5 ;
		Function : _ZN4paro3one24rot_w4_one_launch_kernelI13__nv_bfloat16fLi8ELi10EEEvNS0_4ArgsE
        /*0000*/                   HFMA2.BF16_V2 R5, R4, R3, R2 ;
        /*0010*/                   FRND.FLOOR R6, R5 ;
		Function : _ZN4paro3one24rot_w4_one_launch_kernelIffLi1ELi11EEEvNS0_4ArgsE
        /*0000*/                   LOP3.LUT R5, R4, 0xf, RZ, 0xc0, !PT ;
        /*0010*/                   I2FP.F32.U32 R6, R5 ;
        /*0020*/              @!P0 I2FP.F32.U32 R7, R5 ;
		Function : _ZN4paro3one24rot_w4_one_launch_kernelIffLi2ELi11EEEvNS0_4ArgsE
        /*0000*/                   PRMT R5, R4, 0x7440, RZ ;
		Function : _ZN4paro3one24rot_w4_one_launch_kernelIffLi1ELi1EEEvNS0_4ArgsE
        /*0000*/                   LOP3.LUT R5, R4, 0xf, RZ, 0xc0, !PT ;
"""


def test_unpack_readout_counts_opcodes_and_holds_wm_to_pl():
    """scripts/one_launch_sass.py's unpack readout: the unpack opcodes of
    PL's, MF's and WM's instances (none of K10's), and each WM instance
    against PL's of the same x type and row tile."""
    funcs = one_launch_sass.sass_functions(UNPACK_SASS)
    got = one_launch_sass.unpack_readout(funcs)
    assert got["opcodes"] == {
        "mf": {"13__nv_bfloat16fLi8E": {"FRND.FLOOR": 1, "HFMA2.BF16_V2": 1}},
        "pl": {"ffLi1E": {"I2FP.F32.U32": 2, "LOP3.LUT": 1}},
        "wm": {"ffLi1E": {"I2FP.F32.U32": 2, "LOP3.LUT": 1}, "ffLi2E": {"PRMT": 1}}}
    assert got["wm_identical_to_pl"] == {"ffLi1E": True, "ffLi2E": False}


def test_phase_stamps_find_their_anchors():
    """scripts/one_launch_phases.py stamps the kernel after texts of
    csrc/one_launch.cuh: each must still be there, once."""
    src = one_launch_phases.instrumented_source()
    assert src.count("PHASE_STAMP(") == 1 + len(one_launch_phases.STAMPS)
    assert 'extern "C" int phases_call(' in src


# ---------------------------------------------------------------------------
# the kernel model against the JAX scripts' kernels
# ---------------------------------------------------------------------------

MODEL_CASES = [(S, M) for S in (64, 128, 256) for M in (1, 5, 16, 17)]
DTYPES = (("bf16", "bf16", "bf16", "bf16"), ("f32", "f32", "f32", "f32"),  # x, rot, scales, zeros
          ("f32", "bf16", "f16", "u8"), ("bf16", "f32", "u8", "bf16"))
SEEDS = 4  # draws per case
G, O = 3, 160


def _draw(seed, S, M, kinds):
    """Gaussian x and rotation, random nibbles, scales and zeros; (JAX
    arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    I = G * S
    x = rng.normal(size=(M, I)).astype(np.float32)
    rot = (rng.normal(size=(G, S, S)) / np.sqrt(S)).astype(np.float32)
    qw = rng.integers(0, 256, size=(I // 2, O)).astype(np.uint8)
    s = (rng.integers(1, 4, size=(G, O)) if kinds[2] == "u8"
         else rng.uniform(0.01, 0.05, size=(G, O))).astype(np.float32)
    z = rng.integers(0, 16, size=(G, O)).astype(np.float32)
    arrays = (x, rot, qw, s, z)
    kinds = (kinds[0], kinds[1], "u8", kinds[2], kinds[3])
    return ([jnp.asarray(a, JNP[k]) for a, k in zip(arrays, kinds)],
            [torch.from_numpy(a).to(TORCH[k]) for a, k in zip(arrays, kinds)])


@pytest.mark.parametrize("S,M", MODEL_CASES)
@pytest.mark.parametrize("variant", ["b", "v2"])
def test_one_launch_model_matches_the_jax_scripts(js, interpret, variant, S, M):  # noqa: F811
    i = MODEL_CASES.index((S, M))
    kinds = DTYPES[i % len(DTYPES)]
    KS = wx.one_launch_plan(M, G * S, S, O, SMS)[0]
    for seed in range(SEEDS * i, SEEDS * i + SEEDS):
        jops, tops = _draw(seed + (0 if variant == "b" else 1000), S, M, kinds)
        if variant == "b":
            yj = js["kernel_edge_test"].rot_w4_matmul_b(*jops)
        else:
            yj = js["kernel_tune"].rot_w4_matmul_v2(*jops, block_m=8)
        yj = np.asarray(yj.astype(jnp.float32), np.float64)
        bf16_out = variant == "b" and tops[0].dtype == torch.bfloat16
        tol = rot_tolerance(yj, *tops, variant=variant, bf16_out=bf16_out)
        x, rot, qw, s, z = tops
        for ks in sorted({KS, 1, 2}):
            y = one_launch_model(x, rot[None], qw, s, z, (O,), ks, variant)
            y = (y.to(x.dtype) if variant == "b" else y).to(torch.float64).numpy()
            assert np.all(np.abs(y - yj) <= tol), (seed, ks, (np.abs(y - yj) / tol).max())
