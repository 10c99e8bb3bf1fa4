"""K7 (`butterfly_w4_matmul`) and K13 (`w4a8_matmul`) on the BF and A8
variants of the one-launch kernel (`paroquant_tpu_torch/kernels/csrc/one_launch.cuh`),
on the CPU.

The launch plans (`kernels/rot_matmul.py::bf_route`, K7's route and plan;
`kernels/w4_experiments.py::a8_plan`) are pure functions of shapes and the
card's SM count, tested here at an H100's 132 SMs: one wave at 4096 x 4096,
the tables within shared memory, every split non-empty, K7 at M > 16 on the
passes. Which entry point each wrapper calls, with which plan, is checked
on meta tensors with the library replaced by a recorder (K6 on its PL
variant at M <= 16, `tests/test_torch_rot_w4_a8.py`).

The kernel runs only on the card. `one_launch_model`
(tests/test_torch_rot_w4_route.py, variants "bf" and "a8") models its sums:
per split an f32 partial over its groups (A8: the groups' epilogues added in
order), the partials summed in split order. It is held against the JAX
kernels in Pallas interpret mode at the plan's split count and at one and
two groups a split, on Gaussian inputs from numpy seeds:
  K7  within 2e-3 max |y| (the bound of
      `test_butterfly_w4_matmul_plain_matches_pallas`: a bf16 rounding of a
      rotated activation can flip), f32 x, K 1, 4 and 8;
  K13 within one bf16 ulp of max |y| (the bound of
      `test_w4a8_matmul_matches_jax`), bf16 and f32 x.
With one group a split the A8 model is bit for bit the plain version.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu.ops import butterfly as jbf, packing as jpk
from paroquant_tpu_torch.kernels import rot_matmul as rm, w4_experiments as wx
from paroquant_tpu_torch.ops import butterfly as tbf, packing as tpk
from test_torch_rot_w4_route import one_launch_model, split_groups
from test_torch_w4_experiments import js  # noqa: F401 (fixture)

SMS = 132  # an H100 SXM's SMs
WAVE = rm.BLOCKS_PER_SM * SMS
BF16_ULP = 2.0**-7


def _bf_plan(M, I, S, O, K):
    route, plan = rm.bf_route(M, I, S, O, K, SMS)
    assert route == "one_launch"
    return plan


def _check_split(G, KS):
    """The kernel's split: ceil(G / KS) groups, every split non-empty."""
    gps = -(-G // KS)
    assert 1 <= KS <= G and (KS - 1) * gps < G
    assert sorted(g for _, r in split_groups(G, KS) for g in r) == list(range(G))


# ---------------------------------------------------------------------------
# the plans and routes
# ---------------------------------------------------------------------------

BF_SCRIPT = {1: (32, 512, 1, 1), 8: (32, 512, 8, 1), 16: (16, 512, 8, 2)}  # 4096 x 4096, K 8


@pytest.mark.parametrize("M", list(BF_SCRIPT))
def test_bf_plan_at_the_benchmarks_shape(M):
    KS, tile, mt, gps = plan = _bf_plan(M, 4096, 128, 4096, 8)
    assert plan == BF_SCRIPT[M]
    assert -(-4096 // tile) * -(-M // mt) * KS <= WAVE  # one wave
    _check_split(32, KS)


A8_SCRIPT = {1: (32, 512, 1), 8: (32, 512, 8), 32: (8, 512, 8)}  # 4096 x 4096


@pytest.mark.parametrize("M", list(A8_SCRIPT))
def test_a8_plan_at_the_scripts_shape(M):
    KS, tile, mt = plan = wx.a8_plan(M, 4096, 128, 4096, SMS)
    assert plan == A8_SCRIPT[M]
    assert -(-4096 // tile) * -(-M // mt) * KS <= WAVE
    _check_split(32, KS)


@pytest.mark.parametrize("M", [17, 32, 33, 128])
def test_k7_past_sixteen_rows_takes_the_passes(M):
    assert rm.bf_route(M, 4096, 128, 4096, 8, SMS) == ("passes", None)


@pytest.mark.parametrize("K,S", [(k, s) for k in (1, 2, 4, 8, 16) for s in (128, 256, 512)])
@pytest.mark.parametrize("M", [1, 9, 16])
def test_bf_tables_fit_shared_memory(M, K, S):
    """The tables, S (2K + 1) floats a group, stay within a block's shared
    memory, and several groups a split only within ONE_LAUNCH_TABLE_FLOATS."""
    I = 8 * S
    KS, tile, mt, gps = _bf_plan(M, I, S, 1024, K)
    tab = gps * S * (2 * K + 1)
    assert gps == 1 or tab <= rm.ONE_LAUNCH_TABLE_FLOATS
    assert rm._one_launch_smem(mt, S, gps, tile, tab) <= rm.MAX_SMEM_BYTES
    _check_split(I // S, KS)


def test_bf_route_sends_a_group_too_wide_for_its_tables_to_the_passes():
    assert rm.bf_route(1, 8192, 4096, 128, 8, SMS) == ("passes", None)  # 17 x 16 KB of tables
    assert rm.bf_route(1, 8192, 4096, 128, 0, SMS)[0] == "one_launch"


PLAN_SHAPES = [(M, I, S, O) for M in (1, 3, 5, 16, 17, 32, 64)
               for I, S, O in ((4096, 128, 4096), (2048, 128, 1024), (256, 128, 160),
                               (192, 96, 130), (512, 256, 128), (64, 8, 8192))]


@pytest.mark.parametrize("M,I,S,O", PLAN_SHAPES)
def test_a8_plan_splits_and_tiles(M, I, S, O):
    """Tiles of 512 columns (two a lane), every split non-empty, and within
    shared memory with its scales of x."""
    KS, tile, mt = wx.a8_plan(M, I, S, O, SMS)
    assert tile in wx.A8_TILES and mt == wx._row_tile(M, S)
    _check_split(I // S, KS)
    gps = -(-(I // S) // KS)
    assert wx._one_launch_smem(mt, S, gps, tile, gps * mt) <= wx.MAX_SMEM_BYTES


def test_a8_plan_adds_groups_in_a_split_past_one_wave():
    """A shape whose wave holds fewer splits than groups: two groups a split,
    each group spanning less than a ring stage (S 8)."""
    assert wx.a8_plan(32, 64, 8, 8192, SMS) == (4, 512, 8)


# ---------------------------------------------------------------------------
# the wrappers' launches, on meta tensors with the library recorded
# ---------------------------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Every library entry point replaced by a recorder of (entry, args)."""
    calls = []

    def lib_fn(entry):
        return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(rm, "_lib_fn", lib_fn)
    monkeypatch.setattr(wx, "_lib_fn", lib_fn)
    monkeypatch.setattr(rm, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(wx, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(rm, "_split_counters", {})
    return calls


def _meta_operands(M, I, O, S=128):
    G = I // S
    meta = dict(device="meta")
    return (torch.empty(M, I, dtype=torch.bfloat16, **meta),
            torch.empty(I // 2, O, dtype=torch.uint8, **meta),
            torch.empty(G, O, dtype=torch.bfloat16, **meta),
            torch.empty(G, O, dtype=torch.uint8, **meta))


@pytest.mark.parametrize("M", [1, 16, 17, 128])
def test_k7_and_k6_launch_by_route(recorded, M):
    x, qw, s, z = _meta_operands(M, 4096, 4096)
    inv = torch.empty(4096, device="meta")
    cos = torch.empty(8, 4096, device="meta")
    rm.reset_launch_counts()
    rm.butterfly_w4_matmul(x, inv, cos, cos, qw, s, z)
    rm.w4_matmul(x, qw, s, z)
    (k7, a7), (k6, a6) = recorded
    if M <= rm.ONE_LAUNCH_MAX_M:
        KS, tile, mt, _ = rm.bf_route(M, 4096, 128, 4096, 8, SMS)[1]
        assert k7 == "paro_butterfly_w4_one_launch"
        assert a7[4] == 8 and a7[11:17] == (M, 4096, 128, 4096, KS, tile // rm.COLS_PER_TILE)
        assert rm.bf_route_counts == {"one_launch": 1, "passes": 0}
        KS, tile, mt, _ = rm.w4_plan(M, 4096, 128, 4096, SMS)
        assert k6 == "paro_w4_matmul_one_launch"  # K6 on the PL variant
        assert a6[7:16] == (M, 4096, 128, 4096, KS, tile // rm.COLS_PER_TILE, 1,
                            rm.SZ_CODES[torch.bfloat16], rm.SZ_CODES[torch.uint8])
        assert rm.w4_route_counts == {"one_launch": 1, "passes": 0}
    else:
        assert k7 == "paro_butterfly_w4_matmul"
        assert rm.bf_route_counts == {"one_launch": 0, "passes": 1}
        assert k6 == "paro_butterfly_w4_matmul"  # K6 on the passes
        assert rm.w4_route_counts == {"one_launch": 0, "passes": 1}
    assert rm.launch_counts["butterfly_w4_matmul"] == rm.launch_counts["w4_matmul"] == 1


@pytest.mark.parametrize("M", [1, 5, 8, 17, 32])
def test_k13_launches_the_a8_variant_at_every_m(recorded, M):
    x, qw, s, z = _meta_operands(M, 4096, 4096)
    wx.reset_launch_counts()
    wx.w4a8_matmul(x, qw, s, z)
    ((entry, args),) = recorded
    KS, tile, _ = wx.a8_plan(M, 4096, 128, 4096, SMS)
    assert entry == "paro_w4a8_matmul"
    assert args[7:13] == (M, 4096, 128, 4096, KS, tile // rm.COLS_PER_TILE)
    assert wx.launch_counts["w4a8_matmul"] == 1


@pytest.mark.parametrize("S", [8, 96, 512, 4096])
def test_k13_takes_group_sizes_the_old_kernel_refused(recorded, S):
    """Any even group size whose group fits a block: the A8 variant has no
    packing of four channels (S 8 and 96 were the old kernel's too)."""
    x, qw, s, z = _meta_operands(3, 2 * S, 160, S)
    wx.w4a8_matmul(x, qw, s, z, group_size=S)
    assert recorded[0][0] == "paro_w4a8_matmul"


def test_k13_refuses_a_group_past_shared_memory(recorded):
    x, qw, s, z = _meta_operands(1, 32768, 128, 32768)
    with pytest.raises(ValueError, match="shared memory"):
        wx.w4a8_matmul(x, qw, s, z, group_size=32768)
    assert not recorded


# ---------------------------------------------------------------------------
# the kernel model against the Pallas kernels
# ---------------------------------------------------------------------------

BF_CASES = [(K, M, S) for K in (1, 4, 8) for M in (1, 5, 16) for S in (128, 256)]


def _butterfly_draw(seed, K, M, S, G=3, O=160):
    params = jbf.make_butterfly_params(G * S, S, K)
    rng = np.random.default_rng(seed)
    I = G * S
    theta = np.where(np.asarray(params.mask), 0,
                     rng.normal(0, 0.3, np.asarray(params.theta).shape)).astype(np.float32)
    inv_s = rng.uniform(0.5, 2.0, I).astype(np.float32)
    cos_t, sin_t = tbf.butterfly_tables(theta, S)
    x = rng.normal(size=(M, I)).astype(np.float32)
    q = rng.integers(0, 16, size=(I, O), dtype=np.int32)
    scales = rng.uniform(0.01, 0.05, size=(G, O)).astype(np.float32)
    zeros = rng.integers(0, 16, size=(G, O)).astype(np.float32)
    return x, inv_s, cos_t, sin_t, q, scales, zeros


@pytest.mark.parametrize("K,M,S", BF_CASES)
def test_bf_model_matches_pallas(K, M, S):
    i = BF_CASES.index((K, M, S))
    x, inv_s, cos_t, sin_t, q, scales, zeros = _butterfly_draw(400 + i, K, M, S)
    yj = jk.butterfly_w4_matmul(*(jnp.asarray(a) for a in (x, inv_s, cos_t, sin_t)),
                                jnp.asarray(jpk.pack_w4_tpu(q, S)), jnp.asarray(scales),
                                jnp.asarray(zeros), group_size=S, interpret=True)
    yj = np.asarray(yj, np.float64)
    t = [torch.from_numpy(a) for a in (x, inv_s, cos_t, sin_t, scales, zeros)]
    qw = tpk.pack_w4_tpu(q, S)
    G, O = scales.shape
    KS = _bf_plan(M, G * S, S, O, K)[0]
    for ks in sorted({KS, 1, 2}):
        y = one_launch_model(t[0], None, qw, t[4], t[5], (O,), ks, "bf", tables=t[1:4])
        np.testing.assert_allclose(y.numpy(), yj, rtol=0, atol=2e-3 * np.abs(yj).max(),
                                   err_msg=f"KS={ks}")


A8_CASES = [(M, S, xdt) for M in (1, 5, 17, 32) for S in (96, 128) for xdt in ("bf16", "f32")]


def _a8_draw(seed, M, S, xdt, G=4, O=160):
    rng = np.random.default_rng(seed)
    I = G * S
    x = rng.normal(size=(M, I)).astype(np.float32)
    x[M // 2] = 0  # an all-zero row: sx = 1, out exactly 0
    q = rng.integers(0, 16, size=(I, O), dtype=np.int32)
    scales = rng.uniform(0.01, 0.05, size=(G, O)).astype(np.float32)
    zeros = rng.integers(0, 16, size=(G, O)).astype(np.uint8)
    xj = jnp.asarray(x, jnp.bfloat16 if xdt == "bf16" else jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if xdt == "bf16" else torch.float32)
    return xj, xt, q, scales, zeros


@pytest.mark.parametrize("M,S,xdt", A8_CASES)
def test_a8_model_matches_the_jax_script(js, M, S, xdt):  # noqa: F811
    i = A8_CASES.index((M, S, xdt))
    xj, xt, q, scales, zeros = _a8_draw(500 + i, M, S, xdt)
    qw = jpk.pack_w4_tpu(q, S)
    yj = js["kernel_w4a8_exp"].w4a8_matmul(xj, jnp.asarray(qw), jnp.asarray(scales, jnp.bfloat16),
                                          jnp.asarray(zeros), group_size=S, interpret=True)
    yj = np.asarray(yj.astype(jnp.float32), np.float64)
    st = torch.from_numpy(scales).to(torch.bfloat16)
    zt, qt = torch.from_numpy(zeros), torch.from_numpy(np.asarray(qw))
    G, O = scales.shape
    KS = wx.a8_plan(M, G * S, S, O, SMS)[0]
    for ks in sorted({KS, 1, 2}):
        y = one_launch_model(xt, None, qt, st, zt, (O,), ks, "a8").to(xt.dtype)
        y = y.to(torch.float64).numpy()
        np.testing.assert_allclose(y, yj, rtol=0, atol=BF16_ULP * np.abs(yj).max(),
                                   err_msg=f"KS={ks}")
        assert np.all(y[M // 2] == 0)


@pytest.mark.parametrize("M,S", [(1, 128), (7, 96), (32, 8)])
def test_a8_model_with_one_group_a_split_is_the_plain_version(M, S):
    """One group a split adds the groups' epilogues in the TPU kernel's
    order, so the model and the plain version agree bit for bit (f32 x)."""
    _, xt, q, scales, zeros = _a8_draw(7, M, S, "f32", G=6)
    qw = tpk.pack_w4_tpu(q, S)
    st, zt = torch.from_numpy(scales), torch.from_numpy(zeros)
    y = one_launch_model(xt, None, qw, st, zt, (160,), 6, "a8")
    assert torch.equal(y, wx.w4a8_matmul_plain(xt, qw, st, zt, group_size=S))
