"""The W4 unpack-experiment kernels K18-K22 (`paroquant_tpu_torch/kernels/unpack_exp.py`)
and the port's `kernel_unpack_exp` script against the JAX script they port.

The JAX kernels live in `scripts/kernel_unpack_exp.py` (`scripts/` is not a
package): it is loaded by path, and `jax.experimental.pallas.pallas_call` is
replaced by its interpret-mode partial before the first trace (a jitted
function keeps its first trace, so the replacement must come first).

On the card K19-K22 take the one-launch kernel at M <= 16 (`unpack_route`):
K19 its BC variant, K20 its MF variant, K21 K6's PL variant and K22 its WM
variant. Those kernels run only on the card; `one_launch_model`
(tests/test_torch_rot_w4_route.py, variants "bc", "mf", "pl" and "wm")
models their sums, per split an f32 partial over its groups with the scale
folded into the nibbles, the partials summed in split order, and is held
here against JAX's `w4_matmul_bitcast`, `w4_matmul_mulfloor`,
`w4_matmul_splitdot`, `w4_matmul_splitdot_ce` and `w4_matmul_i8` in
interpret mode. Each variant's unpack is modelled bit for bit in torch
(`bias_unpack`, `mulfloor_unpack`, `wordmask_unpack`) and held to the
nibbles on every byte value; MF and WM give PL's nibbles, so their models
equal PL's bit for bit. The route, its plan and the wrappers' launches are
checked on meta tensors with the library replaced by a recorder.

Tolerances: the GEMVs (and the models) within one bf16 ulp (2**-7) of max
|y| of the JAX output (the nibbles are exact everywhere; only the order of
the f32 sums differs), plus 2e-3 for the rotated control arm, where a bf16
rounding of a rotated activation can flip; `stream_only`, the packing and
the unpack bit for bit.
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu.ops.packing import pack_w4_tpu
from paroquant_tpu_torch.kernels import rot_matmul as rm, unpack_exp as ux
from paroquant_tpu_torch.scripts import kernel_unpack_exp
from test_torch_rot_w4_route import SMS, mulfloor_unpack, one_launch_model, wordmask_unpack

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "kernel_unpack_exp.py"
O, S = 256, 128
BF16_ULP = 2.0**-7
ROT_TOL = BF16_ULP + 2e-3
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "u8": jnp.uint8}
WAVE = 2 * SMS  # the one-launch kernel's blocks resident at two an SM
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}
GEMVS = ("w4_matmul_bitcast", "w4_matmul_mulfloor", "w4_matmul_splitdot_ce",
         "w4_matmul_splitdot", "w4_matmul_i8")


@pytest.fixture(scope="module")
def js(tmp_path_factory):
    """The JAX script as a module (its compilation-cache directory in tmp)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PAROQUANT_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    spec = importlib.util.spec_from_file_location("jax_script_kernel_unpack_exp", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.undo()
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Pallas in interpret mode for the kernels that take no `interpret` argument."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _pair(a, kind):
    """The same numpy array as a JAX array and a torch tensor of dtype `kind`."""
    return jnp.asarray(a, JNP[kind]), torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[kind])


def _close(yt, yj, rel, what=""):
    yj = np.asarray(yj, np.float32)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0, atol=rel * np.abs(yj).max(),
                               err_msg=what)


def _operands(seed, M, n_in, sz, js, xk="bf16", gs=S):
    """x, the half-split and output-pair weights, scales and zeros."""
    rng = np.random.default_rng(seed)
    G = n_in // gs
    x = rng.normal(size=(M, n_in)).astype(np.float32)
    q = rng.integers(0, 16, (n_in, O), dtype=np.int32)
    scales = rng.uniform(0.01, 0.05, (G, O)).astype(np.float32)
    zeros = rng.integers(0, 16, (G, O)).astype(np.float32)
    return dict(x=_pair(x, xk), qweight=_pair(np.asarray(pack_w4_tpu(q, gs)), "u8"),
                q_opair=_pair(js.pack_w4_opair(q, gs), "u8"), scales=_pair(scales, sz[0]),
                zeros=_pair(zeros, sz[1]))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sz", [("bf16", "bf16"), ("bf16", "u8")])
@pytest.mark.parametrize("n_in", [256, 512])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("name", GEMVS)
def test_gemv_plain_matches_jax(js, interpret, name, M, n_in, sz):
    ops = _operands(GEMVS.index(name) * 100 + M * 10 + n_in // 256, M, n_in, sz, js)
    w = "q_opair" if name == "w4_matmul_bitcast" else "qweight"
    args = [ops[k] for k in ("x", w, "scales", "zeros")]
    yj = getattr(js, name)(*(a[0] for a in args), group_size=S)
    yt = getattr(ux, name)(*(a[1] for a in args), group_size=S)
    assert yt.dtype == torch.bfloat16 and yt.shape == (M, O)
    _close(yt, yj, BF16_ULP, name)


@pytest.mark.parametrize("Gb", [1, 2, 3])
def test_stream_only_bit_for_bit(js, interpret, Gb):
    ops = _operands(40 + Gb, 3, 8 * S, ("bf16", "bf16"), js)  # G = 8: Gb = 3 leaves 2 groups unread
    yj = js.stream_only(ops["x"][0], ops["qweight"][0], group_size=S, groups_per_step=Gb)
    yt = ux.stream_only(ops["x"][1], ops["qweight"][1], group_size=S, groups_per_step=Gb)
    assert yt.dtype == torch.float32 and yt.shape == (1, O)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_stream_only_reads_the_first_row_of_each_block():
    """The formula the BlockSpecs give: row g Gb S/2 of the weight plus x[0, g S]."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 6 * S)).astype(np.float32)).to(torch.bfloat16)
    qw = torch.from_numpy(rng.integers(0, 256, (3 * S, O)).astype(np.uint8))
    rows = [qw[g * 2 * S // 2].float() + x[0, g * S].float() for g in range(3)]  # G 6, Gb 2
    got = ux.stream_only(x, qw, group_size=S, groups_per_step=2)
    assert got.shape == (1, O)
    assert torch.equal(got[0], (rows[0] + rows[1]) + rows[2])


def test_stream_only_refuses_more_than_16_rows():
    x = torch.zeros((17, 2 * S), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="M <= 16"):
        ux.stream_only(x, torch.zeros((S, O), dtype=torch.uint8), group_size=S)


def test_pack_w4_opair_matches_jax(js):
    q = np.random.default_rng(3).integers(0, 16, (64, 96), dtype=np.int32)
    got, want = kernel_unpack_exp.pack_w4_opair(q, S), js.pack_w4_opair(q, S)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ux.unpack_opair(torch.from_numpy(got)).numpy(), q)


# ---------------------------------------------------------------------------
# K19 on the BC variant and K21 on PL: the kernels' models against JAX
# ---------------------------------------------------------------------------

SZ3 = (("bf16", "bf16"), ("bf16", "u8"), ("f32", "f32"))
BC_CASES = [(M, gs, xk) for M in (1, 5, 16) for gs in (128, 256) for xk in ("bf16", "f32")]


@pytest.mark.parametrize("M,gs,xk", BC_CASES)
def test_bc_model_matches_jax_bitcast(js, interpret, M, gs, xk):
    """K19's one launch: the output-pair layout, xr per channel, the splits
    merged in split order, at the plan's split count and at one and two
    groups a split."""
    i = BC_CASES.index((M, gs, xk))
    sz = SZ3[i % 3]
    ops = _operands(500 + i, M, 3 * gs, sz, js, xk, gs)
    args = [ops[k] for k in ("x", "q_opair", "scales", "zeros")]
    yj = js.w4_matmul_bitcast(*(a[0] for a in args), group_size=gs)
    xt, qo, st, zt = (a[1] for a in args)
    route, (KS, *_) = ux.unpack_route(M, 3 * gs, gs, O, SMS)
    assert route == "one_launch"
    for ks in sorted({KS, 1, 2}):
        y = one_launch_model(xt, None, qo, st, zt, (O,), ks, "bc").to(xt.dtype)
        _close(y, yj, BF16_ULP, f"bc KS={ks} sz={sz}")


SPLITDOT_CASES = [(name, M, gs) for name in ("w4_matmul_splitdot", "w4_matmul_splitdot_ce")
                  for M in (1, 5, 16) for gs in (128, 256)]


@pytest.mark.parametrize("name,M,gs", SPLITDOT_CASES)
def test_pl_model_matches_jax_splitdot(js, interpret, name, M, gs):
    """K21's one launch is K6's PL: its split dot, the scale folded into the
    nibbles, within K21's tolerance of JAX's split dot and epilogue."""
    i = SPLITDOT_CASES.index((name, M, gs))
    sz, xk = SZ3[i % 3], ("bf16", "f32")[i % 2]
    ops = _operands(600 + i, M, 3 * gs, sz, js, xk, gs)
    args = [ops[k] for k in ("x", "qweight", "scales", "zeros")]
    yj = getattr(js, name)(*(a[0] for a in args), group_size=gs)
    xt, qw, st, zt = (a[1] for a in args)
    route, (KS, *_) = ux.unpack_route(M, 3 * gs, gs, O, SMS)
    assert route == "one_launch"
    for ks in sorted({KS, 1, 2}):
        y = one_launch_model(xt, None, qw, st, zt, (O,), ks, "pl").to(xt.dtype)
        _close(y, yj, BF16_ULP, f"pl KS={ks} sz={sz} x={xk}")


def _half_split_model_case(js, name, variant, i, M, gs, xk):
    """The "mf" or "wm" model against JAX's `name` in interpret mode at the
    plan's split count and at one and two groups a split, and bit for bit
    against the "pl" model on the same inputs."""
    sz = SZ3[i % 3]
    ops = _operands(700 + 50 * (variant == "wm") + i, M, 3 * gs, sz, js, xk, gs)
    args = [ops[k] for k in ("x", "qweight", "scales", "zeros")]
    yj = getattr(js, name)(*(a[0] for a in args), group_size=gs)
    xt, qw, st, zt = (a[1] for a in args)
    route, (KS, *_) = ux.unpack_route(M, 3 * gs, gs, O, SMS)
    assert route == "one_launch"
    for ks in sorted({KS, 1, 2}):
        y = one_launch_model(xt, None, qw, st, zt, (O,), ks, variant)
        assert torch.equal(y, one_launch_model(xt, None, qw, st, zt, (O,), ks, "pl"))
        _close(y.to(xt.dtype), yj, BF16_ULP, f"{variant} KS={ks} sz={sz} x={xk}")


@pytest.mark.parametrize("M,gs,xk", BC_CASES)
def test_mf_model_matches_jax_mulfloor(js, interpret, M, gs, xk):
    """K20's one launch: PL's skeleton with the bf16 mul-floor unpack."""
    _half_split_model_case(js, "w4_matmul_mulfloor", "mf", BC_CASES.index((M, gs, xk)), M, gs, xk)


@pytest.mark.parametrize("M,gs,xk", BC_CASES)
def test_wm_model_matches_jax_i8(js, interpret, M, gs, xk):
    """K22's one launch: PL's skeleton with the word-wide mask unpack."""
    _half_split_model_case(js, "w4_matmul_i8", "wm", BC_CASES.index((M, gs, xk)), M, gs, xk)


def _words(seed, pos):
    """uint8 [256, 16]: 4 words a row, random bytes but every byte value at
    byte position `pos` of the row's first word."""
    words = np.random.default_rng(seed).integers(0, 256, (256, 16)).astype(np.uint8)
    words[:, pos] = np.arange(256)
    return torch.from_numpy(words)


@pytest.mark.parametrize("pos", range(4))
@pytest.mark.parametrize("unpack", [mulfloor_unpack, wordmask_unpack], ids=["mf", "wm"])
def test_half_split_unpack_models_bit_for_bit(unpack, pos):
    """MF's and WM's unpacks give (b & 15, b >> 4) exactly: every byte value
    at each byte position of a 32-bit word, beside random bytes."""
    qw = _words(20 + pos, pos)
    lo, hi = unpack(qw)
    assert lo.dtype == hi.dtype == torch.float32 and lo.shape == hi.shape == qw.shape
    b = qw.to(torch.int32)
    assert torch.equal(lo, (b & 15).to(torch.float32))
    assert torch.equal(hi, (b >> 4).to(torch.float32))


def bias_unpack(qweight_opair: torch.Tensor) -> torch.Tensor:
    """BC's unpack in torch, bit for bit: uint8 [R, B] (B even) -> float32
    [R, 2B]. Lane l takes the 2 bytes (b0, b1) of columns 4l..4l+3, spreads
    them to w = b0 | b1 << 16 (the byte permute 0x4140), and for t = 0, 1
    the word ((w >> 4t) & 0x000F000F) | 0x43004300 holds the bf16 values 128
    + n of columns 4l + t (low half) and 4l + 2 + t (high half); one bf16
    subtraction of 128 gives n."""
    b = qweight_opair.to(torch.int32)
    w = b[:, 0::2] | (b[:, 1::2] << 16)
    out = torch.empty(b.shape[0], w.shape[1], 4, dtype=torch.float32)
    bias = torch.tensor(128.0, dtype=torch.bfloat16)
    for t in (0, 1):
        bits = ((w >> (4 * t)) & 0x000F000F) | 0x43004300
        for half, col in ((bits & 0xFFFF, t), ((bits >> 16) & 0xFFFF, 2 + t)):
            v = half.to(torch.int16).view(torch.bfloat16)  # the bits 0x43.. fit int16
            n = v - bias  # bf16 arithmetic, rounded to bf16
            assert n.dtype == torch.bfloat16
            out[..., col] = n.to(torch.float32)
    return out.reshape(b.shape[0], -1)


def test_bias_unpack_matches_unpack_opair_bit_for_bit():
    """Every byte value at every byte position of a 32-bit word (so every
    nibble value at each of its 8 nibble positions), beside random bytes."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 256, (4 * 256, 4)).astype(np.uint8)
    for pos in range(4):
        words[pos * 256:(pos + 1) * 256, pos] = np.arange(256)
    qo = torch.from_numpy(words.reshape(-1, 8))  # [128, 8]: 8 bytes, 16 columns a row
    got = bias_unpack(qo)
    want = ux.unpack_opair(qo)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want.to(torch.float32))
    assert torch.equal(got.to(torch.int32).to(torch.float32), got)  # integral: exact


# ---------------------------------------------------------------------------
# the route, its plan and the wrappers' launches
# ---------------------------------------------------------------------------

# K19-K22: each GEMV's entry into the one-launch kernel at M <= 16
ROUTED = {"w4_matmul_bitcast": "paro_w4_opair_one_launch",  # K19: BC
          "w4_matmul_mulfloor": "paro_w4_mulfloor_one_launch",  # K20: MF
          "w4_matmul_splitdot_ce": "paro_w4_matmul_one_launch",  # K21: K6's PL
          "w4_matmul_splitdot": "paro_w4_matmul_one_launch",
          "w4_matmul_i8": "paro_w4_wordmask_one_launch"}  # K22: WM


def test_plan_at_the_scripts_shape():
    """4096 x 4096, M 1, g128: 32 splits of one group, 512 columns, 256
    blocks, two an SM."""
    route, plan = ux.unpack_route(1, 4096, 128, 4096, SMS)
    assert route == "one_launch" and plan == rm.w4_plan(1, 4096, 128, 4096, SMS)
    KS, tile, mt, gps = plan
    assert (KS, tile, mt, gps) == (32, 512, 1, 1)
    assert -(-4096 // tile) * KS == 256 <= WAVE


@pytest.mark.parametrize("M", [1, 5, 8, 16])
def test_route_takes_one_launch_to_sixteen_rows(M):
    route, plan = ux.unpack_route(M, 4096, 128, 4096, SMS)
    assert route == "one_launch" and plan == rm.w4_plan(M, 4096, 128, 4096, SMS)
    KS, tile, mt, _ = plan
    assert -(-4096 // tile) * -(-M // mt) * KS <= WAVE


@pytest.mark.parametrize("M", [17, 32, 128])
def test_route_past_sixteen_rows_takes_the_gemv(M):
    assert ux.unpack_route(M, 4096, 128, 4096, SMS) == ("gemv", None)


def test_route_with_a_group_too_wide_for_a_block_takes_the_gemv():
    assert ux.unpack_route(1, 65536, 32768, 128, SMS) == ("gemv", None)


@pytest.fixture
def recorded(monkeypatch):
    """Every library entry point replaced by a recorder of (entry, args)."""
    calls = []
    monkeypatch.setattr(ux, "_lib_fn", lambda entry: lambda *a: calls.append((entry, a)) or 0)
    monkeypatch.setattr(ux, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(rm, "_split_counters", {})
    return calls


def _meta(name, M, I=4096, n_out=4096):
    G = I // S
    meta = dict(device="meta")
    w = (I, n_out // 2) if name == "w4_matmul_bitcast" else (I // 2, n_out)
    return (torch.empty(M, I, dtype=torch.bfloat16, **meta),
            torch.empty(w, dtype=torch.uint8, **meta),
            torch.empty(G, n_out, dtype=torch.bfloat16, **meta),
            torch.empty(G, n_out, dtype=torch.uint8, **meta))


@pytest.mark.parametrize("M", [1, 8, 16, 17])
@pytest.mark.parametrize("name", list(ROUTED))
def test_k19_to_k22_launch_by_route(recorded, name, M):
    ux.reset_launch_counts()
    getattr(ux, name)(*_meta(name, M))
    ((entry, args),) = recorded
    codes = (1, rm.SZ_CODES[torch.bfloat16], rm.SZ_CODES[torch.uint8], 0)
    if M <= rm.ONE_LAUNCH_MAX_M:
        KS, tile, _, _ = rm.w4_plan(M, 4096, 128, 4096, SMS)
        assert entry == ROUTED[name]
        assert args[7:] == (M, 4096, 128, 4096, KS, tile // rm.COLS_PER_TILE, *codes)
        assert ux.unpack_route_counts[name] == {"one_launch": 1, "gemv": 0}
    else:
        assert entry == "paro_unpack_gemv"
        assert args[6:11] == (ux.MODES[name], M, 4096, 128, 4096) and args[12:] == codes
        assert ux.unpack_route_counts[name] == {"one_launch": 0, "gemv": 1}
    assert ux.launch_counts[name] == 1
    assert sum(ux.launch_counts.values()) == 1
    assert all(sum(c.values()) == (n == name) for n, c in ux.unpack_route_counts.items())


# ---------------------------------------------------------------------------
# the port's script against the JAX script's draws
# ---------------------------------------------------------------------------


def _jax_cases(js, M=1, n_in=256):
    """scripts/kernel_unpack_exp.py::main's draws and cases at I = O = 256."""
    G = n_in // S
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(M, n_in)), jnp.bfloat16)
    qint = rng.integers(0, 16, (n_in, O), dtype=np.int32)
    qweight = jnp.asarray(pack_w4_tpu(qint, S))
    q_opair = jnp.asarray(js.pack_w4_opair(qint, S))
    scales = jnp.asarray(rng.uniform(0.01, 0.05, (G, O)), jnp.bfloat16)
    zeros = jnp.asarray(rng.integers(0, 16, (G, O)).astype(np.float32), jnp.bfloat16)
    rot = jnp.asarray(rng.normal(size=(G, S, S)), jnp.bfloat16)
    w4b = n_in * O // 2 + G * O * 4
    rotb = w4b + G * S * S * 2
    ops = (qweight, scales, zeros)
    return [
        ("stream Gb=1", x, n_in * O // 2, lambda xv: js.stream_only(xv, qweight)[:1, :n_in]),
        ("w4 uint8 (baseline)", x, w4b, lambda xv: jk.w4_matmul(xv, *ops, interpret=True)),
        ("w4 splitdot", x, w4b, lambda xv: js.w4_matmul_splitdot(xv, *ops)),
        ("w4 splitdot+CE", x, w4b, lambda xv: js.w4_matmul_splitdot_ce(xv, *ops)),
        ("w4 bitcast-u4", x, w4b, lambda xv: js.w4_matmul_bitcast(xv, q_opair, scales, zeros)),
        ("w4 mulfloor", x, w4b, lambda xv: js.w4_matmul_mulfloor(xv, *ops)),
        ("w4 i8-bitcast", x, w4b, lambda xv: js.w4_matmul_i8(xv, *ops)),
        ("rot dense (prod)", x, rotb,
         lambda xv: jk.rot_w4_matmul(xv, rot, qweight, scales, zeros, interpret=True)),
    ]


def test_script_cases_match_the_jax_script(js, interpret):
    cases = kernel_unpack_exp.cases(kernel_unpack_exp.draws("cpu", I=256, O=O, GS=S), S)
    want = _jax_cases(js)
    assert [c.label for c in cases] == [w[0] for w in want]
    for case, (label, xj, nbytes, step) in zip(cases, want):
        np.testing.assert_array_equal(case.x.float().numpy(), np.asarray(xj, np.float32))
        assert case.nbytes == nbytes, label
        yt, yj = case.step(case.x), step(xj)
        if label.startswith("stream"):
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        else:
            _close(yt, yj, ROT_TOL if label.startswith("rot") else BF16_ULP, label)


def test_script_main_on_the_cpu(capsys):
    errs, rows = kernel_unpack_exp.main("cpu", reps=1, I=256, O=O)
    assert list(errs) == ["splitdot", "splitdot+CE", "bitcast", "mulfloor", "i8"]
    assert all(e <= BF16_ULP for e in errs.values()), errs
    labels = [c.label for c in kernel_unpack_exp.cases(kernel_unpack_exp.draws("cpu", I=256, O=O))]
    assert [r["label"] for r in rows] == labels
    for r in rows:  # the host clock gives no device rate
        assert r["us"] > 0 and r["gbps"] is None and r["hbm_share"] is None
        assert r["device"] == "cpu (host clock)"
    out = capsys.readouterr().out
    for name in errs:
        assert f"{name}: max rel err vs baseline" in out
    assert "host clock" in out
