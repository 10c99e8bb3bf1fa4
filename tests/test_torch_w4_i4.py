"""K9 (`rot_w4_matmul_i4`) on the I4 variant of the one-launch kernel
(`paroquant_tpu_torch/kernels/csrc/one_launch.cuh`), on the CPU.

The launch plan (`kernels/rot_matmul.py::i4_plan`) and the route
(`i4_route`) are pure functions of shapes and the card's SM count, tested
here at an H100's 132 SMs: K10's plan at 4096 x 4096 (one wave, one group
of 512 columns a block at M <= 8), every split non-empty, shared memory
within its limits, and the passes at M > 16 and at S > 256. Which entry
point the wrapper calls, with which plan, is checked on meta tensors with
the library replaced by a recorder.

The kernel runs only on the card. `one_launch_model`
(tests/test_torch_rot_w4_route.py, variant "i4": K1's arithmetic on the
interleaved nibbles) models its sums: per split an f32 partial over its
groups, the partials summed in split order. It is held against
`paroquant_tpu.kernels.rot_matmul.rot_w4_matmul_i4` in Pallas interpret
mode at the plan's split count and at one and two groups a split, on
Gaussian inputs from numpy seeds, to `rot_tolerance`
(tests/test_torch_rot_w4_flips.py) taken on the same nibbles in K1's
half-split layout: K9 is K1's function, so its bf16 flips and their
coefficients are K1's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu_torch.kernels import rot_matmul as rm
from paroquant_tpu_torch.ops import packing as tpk
from test_torch_rot_w4_flips import rot_tolerance
from test_torch_rot_w4_route import one_launch_model, split_groups
from test_torch_w4_bf_a8 import recorded  # noqa: F401 (fixture)
from test_torch_w4_experiments import JNP, TORCH

SMS = 132  # an H100 SXM's SMs
WAVE = rm.BLOCKS_PER_SM * SMS


def _plan(M, I, S, O):
    route, plan = rm.i4_route(M, I, S, O, SMS)
    assert route == "one_launch"
    return plan


def _check_plan(M, I, S, O, plan):
    """Every split non-empty, the groups a block within the kernel's limits,
    its shared memory within a block's."""
    KS, tile, mt, gps = plan
    G = I // S
    assert tile in rm.ONE_LAUNCH_TILES and mt == rm._row_tile(M, S)
    assert gps == -(-G // KS) and 1 <= KS <= G and (KS - 1) * gps < G
    assert sorted(g for _, r in split_groups(G, KS) for g in r) == list(range(G))
    gmax = min(rm.ONE_LAUNCH_MAX_GROUPS, rm.ONE_LAUNCH_X_FLOATS // (mt * S),
               rm.ONE_LAUNCH_SZ_FLOATS // tile)
    assert gps <= max(1, gmax)
    assert rm._one_launch_smem(mt, S, gps, tile) <= rm.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# the plan and the route
# ---------------------------------------------------------------------------

BENCH_PLANS = {1: (32, 512, 1, 1), 8: (32, 512, 8, 1), 16: (16, 512, 8, 2)}  # 4096 x 4096, g128


@pytest.mark.parametrize("M", list(BENCH_PLANS))
def test_plan_at_the_benchmarks_shape(M):
    """K10's plan (the same issue order): at M 1 32 splits of one group and
    512-column tiles, one wave."""
    plan = _plan(M, 4096, 128, 4096)
    assert plan == BENCH_PLANS[M]
    KS, tile, mt, _ = plan
    assert -(-4096 // tile) * -(-M // mt) * KS <= WAVE
    _check_plan(M, 4096, 128, 4096, plan)


PLAN_SHAPES = [(M, I, S, O) for M in (1, 3, 5, 9, 16)
               for I, S, O in ((4096, 128, 4096), (2048, 128, 1024), (280, 40, 160),
                               (256, 128, 130), (512, 256, 160), (768, 96, 128),
                               (32768, 128, 4096), (1024, 128, 151936))]


@pytest.mark.parametrize("M,I,S,O", PLAN_SHAPES)
def test_plan_splits_and_shared_memory(M, I, S, O):
    """One wave where it holds the grid (else 128-column tiles past it), every
    split non-empty and within shared memory, at S 40 (not a multiple of
    8), O 130 (not a multiple of 16) and widths past one wave."""
    plan = _plan(M, I, S, O)
    _check_plan(M, I, S, O, plan)
    KS, tile, mt, _ = plan
    if -(-O // tile) * -(-M // mt) * KS > WAVE:
        assert tile == rm.ONE_LAUNCH_TILES[0]


@pytest.mark.parametrize("M,S", [(17, 128), (32, 128), (128, 128), (1, 512), (16, 1024), (1, 320)])
def test_other_calls_take_the_passes(M, S):
    assert rm.i4_route(M, 4 * S, S, 4096, SMS) == ("passes", None)


# ---------------------------------------------------------------------------
# the wrapper's launches, on meta tensors with the library recorded
# ---------------------------------------------------------------------------


def _meta_operands(M, I, O, S=128):
    G = I // S
    meta = dict(device="meta")
    return (torch.empty(M, I, dtype=torch.bfloat16, **meta),
            torch.empty(G, S, S, dtype=torch.bfloat16, **meta),
            torch.empty(I // 2, O, dtype=torch.uint8, **meta),
            torch.empty(G, O, dtype=torch.bfloat16, **meta),
            torch.empty(G, O, dtype=torch.uint8, **meta))


@pytest.mark.parametrize("M,S", [(1, 128), (8, 128), (16, 128), (17, 128), (128, 128), (1, 512)])
def test_k9_launches_by_route(recorded, M, S):  # noqa: F811
    x, rot, qw, s, z = _meta_operands(M, 4 * S if S > 128 else 4096, 4096, S)
    I = x.shape[1]
    rm.reset_launch_counts()
    rm.rot_w4_matmul_i4(x, rot, qw, s, z)
    ((entry, args),) = recorded
    if M <= rm.ONE_LAUNCH_MAX_M and S <= rm.ONE_LAUNCH_MAX_S:
        KS, tile, _, _ = rm.i4_plan(M, I, S, 4096, SMS)
        assert entry == "paro_rot_w4_matmul_i4_one_launch"
        assert args[8:14] == (M, I, S, 4096, KS, tile // rm.COLS_PER_TILE)
        assert args[14:18] == (1, 1, rm.SZ_CODES[torch.bfloat16], rm.SZ_CODES[torch.uint8])
        assert rm.i4_route_counts == {"one_launch": 1, "passes": 0}
    else:
        assert entry == "paro_dense_rot_w4_variant"
        assert args[18] == 1  # the interleaved GEMV mode
        assert rm.i4_route_counts == {"one_launch": 0, "passes": 1}
    assert rm.launch_counts["rot_w4_matmul_i4"] == 1
    assert rm.sz_counts["rot_w4_matmul_i4"] == {"bfloat16/uint8": 1}


def test_k9_refuses_groups_that_do_not_tile_x(recorded):  # noqa: F811
    x, rot, qw, s, z = _meta_operands(1, 4096, 256)
    with pytest.raises(ValueError, match="do not tile"):
        rm.rot_w4_matmul_i4(x[:, :4000], rot, qw[:2000], s, z)
    assert not recorded


# ---------------------------------------------------------------------------
# the kernel model against the Pallas kernel
# ---------------------------------------------------------------------------

G, O = 5, 160
MODEL_CASES = [(S, M) for S in (64, 128, 256) for M in (1, 5, 16)]
DTYPES = (("bf16", "bf16", "bf16", "bf16"), ("f32", "f32", "f32", "f32"),  # x, rot, scales, zeros
          ("f32", "bf16", "f16", "u8"), ("bf16", "f32", "u8", "bf16"))


def _draw(seed, S, M, kinds):
    """Gaussian x and rotation, random nibbles q [I, O], scales and zeros:
    (JAX operands with q as uint4 [I, O], port operands with q packed by
    `pack_w4_i4`, the port's operands with q in K1's half-split layout)."""
    rng = np.random.default_rng(seed)
    I = G * S
    x = rng.normal(size=(M, I)).astype(np.float32)
    rot = (rng.normal(size=(G, S, S)) / np.sqrt(S)).astype(np.float32)
    q = rng.integers(0, 16, size=(I, O)).astype(np.int32)
    s = (rng.integers(1, 4, size=(G, O)) if kinds[2] == "u8"
         else rng.uniform(0.01, 0.05, size=(G, O))).astype(np.float32)
    z = rng.integers(0, 16, size=(G, O)).astype(np.float32)
    x, rot, s, z = ((jnp.asarray(a, JNP[k]), torch.from_numpy(a).to(TORCH[k]))
                    for a, k in zip((x, rot, s, z), kinds))
    jops = (x[0], rot[0], jnp.asarray(q, jnp.uint4), s[0], z[0])
    tops = (x[1], rot[1], tpk.pack_w4_i4(q), s[1], z[1])
    return jops, tops, (x[1], rot[1], tpk.pack_w4_tpu(q, S), s[1], z[1])


def _model(ops, ks, variant):
    x, rot, qw, s, z = ops
    return one_launch_model(x, rot[None], qw, s, z, (O,), ks, variant)


@pytest.mark.parametrize("S,M", MODEL_CASES)
def test_i4_model_matches_pallas(S, M):
    i = MODEL_CASES.index((S, M))
    kinds = DTYPES[i % len(DTYPES)]
    KS = _plan(M, G * S, S, O)[0]
    for seed in range(3 * i, 3 * i + 3):
        jops, tops, half_split = _draw(600 + seed, S, M, kinds)
        yj = np.asarray(jk.rot_w4_matmul_i4(*jops, interpret=True).astype(jnp.float32), np.float64)
        x = tops[0]
        tol = rot_tolerance(yj, *half_split, bf16_out=x.dtype == torch.bfloat16)
        for ks in sorted({KS, G, -(-G // 2)}):  # the plan's, one and two groups a split
            y = _model(tops, ks, "i4").to(x.dtype).to(torch.float64).numpy()
            assert np.all(np.abs(y - yj) <= tol), (seed, ks, (np.abs(y - yj) / tol).max())


@pytest.mark.parametrize("ks", [1, 2, 3, 5])
def test_i4_model_is_k1_on_the_half_split_layout(ks):
    """The I4 variant differs from K1 only in where a channel's nibble lies:
    on the same nibbles the two models agree bit for bit."""
    _, tops, half_split = _draw(700 + ks, 128, 5, DTYPES[2])
    assert torch.equal(_model(tops, ks, "i4"), _model(half_split, ks, "k1"))
