"""The W4 GEMV experiment kernels K10-K13 (`paroquant_tpu_torch/kernels/w4_experiments.py`)
and the port's experiment scripts against the JAX scripts they port.

The JAX kernels live in `scripts/`, which is not a package: each script is
loaded by path. `rot_w4_matmul_b` and `rot_w4_matmul_v2` take no
`interpret` argument, so `jax.experimental.pallas.pallas_call` is replaced
by its interpret-mode partial before they are traced (a jitted function
keeps its first trace, so the replacement must come first).

Tolerances, relative to max |y| of the JAX output: one bf16 ulp (2**-7),
plus 2e-3 for the kernels that rotate (K10-K12), where a bf16 rounding of
a rotated activation can flip.
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
from paroquant_tpu_torch.kernels import w4_experiments as wx
from paroquant_tpu_torch.scripts import (kernel_dma_pipeline, kernel_edge_test, kernel_tune,
                                         kernel_w4a8_exp)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
I, O, S = 256, 256, 128
G = I // S
BF16_ULP = 2.0**-7
ROT_TOL = BF16_ULP + 2e-3
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16, "u8": jnp.uint8}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16, "u8": torch.uint8}


@pytest.fixture(scope="module")
def js(tmp_path_factory):
    """The four JAX scripts as modules (their compilation-cache directory in tmp)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PAROQUANT_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    mods = {}
    for name in ("kernel_edge_test", "kernel_dma_pipeline", "kernel_tune", "kernel_w4a8_exp"):
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mp.undo()
    return mods


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


def _operands(seed, M, n_groups=G, sz=("bf16", "bf16"), x_kind="bf16", rot_kind="bf16",
              q_bytes=False):
    rng = np.random.default_rng(seed)
    n_in = n_groups * S
    x = rng.normal(size=(M, n_in)).astype(np.float32)
    rot = (rng.normal(size=(n_groups, S, S)) / np.sqrt(S)).astype(np.float32)
    if q_bytes:
        qw = rng.integers(0, 256, (n_in // 2, O)).astype(np.uint8)
    else:
        qw = np.asarray(pack_w4_tpu(rng.integers(0, 16, (n_in, O), dtype=np.int32), S))
    scales = rng.uniform(0.01, 0.05, (n_groups, O)).astype(np.float32)
    zeros = rng.integers(0, 16, (n_groups, O)).astype(np.float32)
    return (_pair(x, x_kind), _pair(rot, rot_kind), _pair(qw, "u8"), _pair(scales, sz[0]),
            _pair(zeros, sz[1]))


def _split(ops):
    return [o[0] for o in ops], [o[1] for o in ops]


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 5, 16])
def test_rot_w4_matmul_b_matches_jax(js, interpret, M):
    jops, tops = _split(_operands(10 + M, M))
    yj = js["kernel_edge_test"].rot_w4_matmul_b(*jops)
    yt = wx.rot_w4_matmul_b(*tops)
    assert yt.dtype == torch.bfloat16 and yt.shape == (M, O)
    _close(yt, yj, ROT_TOL)


def test_rot_w4_matmul_b_sums_the_unrounded_rotation():
    """K10's zero-point term uses rowsum(xr32), not K1's rowsum(bf16(xr)):
    with the nibbles all 0 the output is -rowsum * z * s, so the two differ."""
    _, tops = _split(_operands(3, 4, x_kind="f32", rot_kind="f32"))
    x, rot, qw, s, z = tops
    qw = torch.zeros_like(qw)
    xr32 = torch.einsum("mgj,gij->mgi", x.reshape(4, G, S), rot)
    want = -(xr32.sum(-1, keepdim=True) * z * s).sum(1)
    torch.testing.assert_close(wx.rot_w4_matmul_b(x, rot, qw, s, z), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Gb", [1, 2])
def test_dma_rot_w4_matmul_matches_jax(js, Gb):
    jops, tops = _split(_operands(20 + Gb, 1, sz=("f32", "f32"), q_bytes=True))
    yj = js["kernel_dma_pipeline"].dma_rot_w4_matmul(*jops, Gb=Gb, interpret=True)
    yt = wx.dma_rot_w4_matmul(*tops, Gb=Gb)
    assert yt.dtype == torch.bfloat16
    _close(yt, yj, ROT_TOL)


@pytest.mark.parametrize("Gb", [2, 4])
def test_dma_rot_w4_matmul_refuses_a_ragged_chunk(Gb):
    _, tops = _split(_operands(5, 1, n_groups=3, sz=("f32", "f32"), q_bytes=True))
    with pytest.raises(ValueError, match="chunks of Gb"):
        wx.dma_rot_w4_matmul(*tops, Gb=Gb)


@pytest.mark.parametrize("sz", [("f32", "f32"), ("f16", "u8")])
@pytest.mark.parametrize("block_m", [8, 16])
def test_rot_w4_matmul_v2_matches_jax(js, interpret, block_m, sz):
    jops, tops = _split(_operands(30 + block_m, 3, sz=sz))
    yj = js["kernel_tune"].rot_w4_matmul_v2(*jops, block_m=block_m)
    yt = wx.rot_w4_matmul_v2(*tops, block_m=block_m)
    assert yj.dtype == jnp.float32 and yt.dtype == torch.float32 and yt.shape == (3, O)
    _close(yt, yj, ROT_TOL)


def _w4a8_operands(rng, M, n_in, n_out, js):
    """The script's `_mk_case` draws, as JAX arrays and torch tensors."""
    jx, jq, js_, jz = js["kernel_w4a8_exp"]._mk_case(rng, M, n_in, n_out, S)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    ts = torch.from_numpy(np.asarray(js_, np.float32)).to(torch.bfloat16)
    return (jx, jq, js_, jz), (tx, torch.from_numpy(np.array(jq)), ts,
                               torch.from_numpy(np.array(jz)))


@pytest.mark.parametrize("case", ["script", "M1", "M17", "zero_row"])
def test_w4a8_matmul_matches_jax(js, case):
    rng = np.random.default_rng(0)
    M, n_out = {"script": (4, 512), "M1": (1, O), "M17": (17, O), "zero_row": (5, O)}[case]
    jops, tops = _w4a8_operands(rng, M, I, n_out, js)
    if case == "zero_row":
        jops = (jops[0].at[2].set(0),) + jops[1:]
        tops = (tops[0].clone().index_fill_(0, torch.tensor([2]), 0),) + tops[1:]
    yj = js["kernel_w4a8_exp"].w4a8_matmul(*jops, group_size=S, interpret=True)
    yt = wx.w4a8_matmul(*tops, group_size=S)
    assert yt.dtype == torch.bfloat16 and yt.shape == (M, n_out)
    _close(yt, yj, BF16_ULP)
    if case == "zero_row":
        assert torch.all(yt[2] == 0)


# ---------------------------------------------------------------------------
# the port's scripts against the JAX scripts' draws
# ---------------------------------------------------------------------------


def _jax_edge(js):
    """scripts/kernel_edge_test.py::main's draws at I = O = 256."""
    mod = js["kernel_edge_test"]
    rng = np.random.default_rng(0)
    qw = jnp.asarray(pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), S))
    scales = jnp.asarray(rng.uniform(0.01, 0.05, (G, O)), jnp.bfloat16)
    zeros = jnp.asarray(rng.integers(0, 16, (G, O)), jnp.bfloat16)
    rot = jnp.asarray(rng.normal(size=(G, S, S)) / np.sqrt(S), jnp.bfloat16)
    out = []
    for M in (1, 16):
        x0 = jnp.asarray(rng.normal(size=(M, I)), jnp.bfloat16)
        # the JAX kernel's cost estimate
        nbytes = I * O // 2 + G * S * S * 2 + M * I * 2 + M * O * 2 + G * O * 4
        out += [(f"M={M} variant a", x0, nbytes,
                 lambda xv: jk.rot_w4_matmul(xv, rot, qw, scales, zeros, interpret=True)),
                (f"M={M} variant b", x0, nbytes,
                 lambda xv: mod.rot_w4_matmul_b(xv, rot, qw, scales, zeros))]
    return out


def _jax_dma(js):
    mod = js["kernel_dma_pipeline"]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((1, I)), jnp.bfloat16)
    rot = jnp.asarray(rng.standard_normal((G, S, S)) / np.sqrt(S), jnp.bfloat16)
    qw = jnp.asarray(rng.integers(0, 256, (I // 2, O)), jnp.uint8)
    scales = jnp.asarray(rng.uniform(0.001, 0.02, (G, O)), jnp.float32)
    zeros = jnp.asarray(rng.integers(0, 16, (G, O)), jnp.float32)
    nbytes = I * O // 2 + G * O * 4 + G * S * S * 2 + 2 * 1 * I
    sb, zb = scales.astype(jnp.bfloat16), zeros.astype(jnp.bfloat16)
    return [("dma", x, nbytes, lambda xv: mod.dma_rot_w4_matmul(xv, rot, qw, scales, zeros, Gb=2,
                                                                 interpret=True)),
            ("prod", x, nbytes, lambda xv: jk.rot_w4_matmul(xv, rot, qw, sb, zb, interpret=True))]


def _jax_tune(js):
    mod = js["kernel_tune"]
    rng = np.random.default_rng(0)
    x16 = jnp.asarray(rng.normal(size=(1, I)), jnp.float32).astype(jnp.bfloat16)
    qweight = jnp.asarray(pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), S))
    scales = jnp.asarray(rng.uniform(0.01, 0.05, (G, O)), jnp.float32)
    zeros = jnp.asarray(rng.integers(0, 16, (G, O)), jnp.float32)
    rot16 = jnp.asarray(rng.normal(size=(G, S, S)), jnp.float32).astype(jnp.bfloat16)
    v2f_bytes = I * O // 2 + 2 * G * O * 4 + G * S * S * 2
    return [(f"v2 bf16rot TM{bm}", x16, v2f_bytes,
             lambda xv, bm=bm: mod.rot_w4_matmul_v2(xv, rot16, qweight, scales, zeros, block_m=bm))
            for bm in (16, 8)]  # the script's "+sem" case has no counterpart on the card


def _jax_w4a8(js):
    mod = js["kernel_w4a8_exp"]
    rng = np.random.default_rng(0)
    mod._mk_case(rng, 4, 256, 512, S)
    out = []
    for M in (1, 8, 32):
        x, qw, s, z = mod._mk_case(rng, M, I, O, S)
        out += [(f"M={M} w4a8", x, I * O // 2,
                 lambda xv, a=(qw, s, z): mod.w4a8_matmul(xv, *a, group_size=S, interpret=True)),
                (f"M={M} w4a16", x, I * O // 2,
                 lambda xv, a=(qw, s, z): jk.w4_matmul(xv, *a, group_size=S, interpret=True))]
    return out


SCRIPT_CASES = {
    "kernel_edge_test": (lambda: kernel_edge_test.cases("cpu", I=I, O=O, GS=S), _jax_edge,
                         ROT_TOL),
    "kernel_dma_pipeline": (lambda: kernel_dma_pipeline.cases("cpu", size=I, m=1, gb=2), _jax_dma,
                            ROT_TOL),
    "kernel_tune": (lambda: kernel_tune.cases("cpu", M=1, I=I, O=O, GS=S), _jax_tune, ROT_TOL),
    "kernel_w4a8_exp": (lambda: kernel_w4a8_exp.cases("cpu", I=I, O=O, gs=S), _jax_w4a8,
                        BF16_ULP),
}


@pytest.mark.parametrize("script", list(SCRIPT_CASES))
def test_script_cases_match_the_jax_scripts(js, interpret, script):
    port_cases, jax_cases, tol = SCRIPT_CASES[script]
    cases, want = port_cases(), jax_cases(js)
    assert [c.label for c in cases] == [w[0] for w in want]
    for case, (label, xj, nbytes, step) in zip(cases, want):
        np.testing.assert_array_equal(case.x.float().numpy(), np.asarray(xj, np.float32))
        assert case.nbytes == nbytes, label
        _close(case.step(case.x), step(xj), tol, label)


MAINS = {
    "kernel_edge_test": lambda: kernel_edge_test.main("cpu", reps=1, I=I, O=O, GS=S),
    "kernel_dma_pipeline": lambda: kernel_dma_pipeline.main("cpu", reps=1, size=I, gb=2),
    "kernel_tune": lambda: kernel_tune.main("cpu", reps=1, I=I, O=O, GS=S),
    "kernel_w4a8_exp": lambda: kernel_w4a8_exp.main("cpu", reps=1, I=I, O=O, gs=S),
}


@pytest.mark.parametrize("script", list(MAINS))
def test_script_main_rows_on_the_cpu(script, capsys):
    rows = MAINS[script]()
    assert [r["label"] for r in rows] == [c.label for c in SCRIPT_CASES[script][0]()]
    for r in rows:  # the host clock gives no device rate
        assert r["us"] > 0 and r["gbps"] is None and r["hbm_share"] is None
        assert r["device"] == "cpu (host clock)"
    out = capsys.readouterr().out
    assert "host clock" in out
    if script == "kernel_edge_test":
        assert "rel err a-vs-b" in out
    if script == "kernel_dma_pipeline":
        assert "parity vs mg kernel" in out
    if script == "kernel_w4a8_exp":
        assert "w4a8 vs f32-dequant" in out and "speedup" in out
