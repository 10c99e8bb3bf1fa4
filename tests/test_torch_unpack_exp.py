"""The W4 unpack-experiment kernels K18-K22 (`paroquant_tpu_torch/kernels/unpack_exp.py`)
and the port's `kernel_unpack_exp` script against the JAX script they port.

The JAX kernels live in `scripts/kernel_unpack_exp.py` (`scripts/` is not a
package): it is loaded by path, and `jax.experimental.pallas.pallas_call` is
replaced by its interpret-mode partial before the first trace (a jitted
function keeps its first trace, so the replacement must come first).

Tolerances: the GEMVs within one bf16 ulp (2**-7) of max |y| of the JAX
output (the nibbles are exact everywhere; only the order of the f32 sums
differs), plus 2e-3 for the rotated control arm, where a bf16 rounding of a
rotated activation can flip; `stream_only` and the packing bit for bit.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu.ops.packing import pack_w4_tpu
from paroquant_tpu_torch.kernels import unpack_exp as ux
from paroquant_tpu_torch.scripts import kernel_unpack_exp

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "kernel_unpack_exp.py"
O, S = 256, 128
BF16_ULP = 2.0**-7
ROT_TOL = BF16_ULP + 2e-3
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "u8": jnp.uint8}
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


def _operands(seed, M, n_in, sz, js):
    """x, the half-split and output-pair weights, scales and zeros."""
    rng = np.random.default_rng(seed)
    G = n_in // S
    x = rng.normal(size=(M, n_in)).astype(np.float32)
    q = rng.integers(0, 16, (n_in, O), dtype=np.int32)
    scales = rng.uniform(0.01, 0.05, (G, O)).astype(np.float32)
    zeros = rng.integers(0, 16, (G, O)).astype(np.float32)
    return dict(x=_pair(x, "bf16"), qweight=_pair(np.asarray(pack_w4_tpu(q, S)), "u8"),
                q_opair=_pair(js.pack_w4_opair(q, S), "u8"), scales=_pair(scales, sz[0]),
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
