"""The int8 tensor-core probe (`paroquant_tpu_torch/kernels/int8_probe.py`,
K14-K17) and its script against `scripts/kernel_int8_probe.py`.

The JAX script lives in `scripts/`, which is not a package: it is loaded by
path. Its probes call `pl.pallas_call` with no `interpret` argument, so a
recorder stands in for it that runs the interpret-mode call and keeps each
output; the port's probes run with a recorder around the port's wrappers.
`bench_dots` hard-codes 4096 x 4096 and a timing loop, so its two kernel
bodies are captured (the stand-in returns a callable that raises before
anything is timed) and run through the real interpret-mode `pallas_call` at
a small shape. Every comparison with JAX is bit for bit: the inputs are
small integers, so even the bf16 dot is exact in float32. The plain
versions' edges are exact too, but for random bf16 (1e-5 of max |y|).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paroquant_tpu_torch.kernels import int8_probe as ip
from paroquant_tpu_torch.scripts import kernel_int8_probe as kp

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "kernel_int8_probe.py"
REAL_PALLAS_CALL = pl.pallas_call


@pytest.fixture(scope="module")
def js():
    spec = importlib.util.spec_from_file_location("jax_script_kernel_int8_probe", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(y_port: torch.Tensor, y_jax) -> None:
    yj = np.asarray(y_jax)
    yt = y_port.numpy()
    assert yt.dtype == yj.dtype and yt.shape == yj.shape
    np.testing.assert_array_equal(yt, yj)


# ---------------------------------------------------------------------------
# the probes, port against JAX (interpret mode), on the script's inputs
# ---------------------------------------------------------------------------

PROBES = {  # JAX probe, port probe, port wrapper it calls
    "narrow_cast": ("probe_narrow_cast", kp.probe_narrow_cast, "narrow_cast"),
    "int8_dot": ("probe_int8_dot", kp.probe_int8_dot, "int8_dot"),
    "fused_unpack_int8_dot": ("probe_fused_unpack_int8_dot", kp.probe_fused_unpack_int8_dot,
                              "fused_unpack_int8_dot"),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_matches_the_jax_probe(js, probe, monkeypatch):
    jax_name, port_probe, wrapper = PROBES[probe]
    jax_out, port_out = [], []

    def jax_recorder(*args, **kw):
        call = REAL_PALLAS_CALL(*args, interpret=True, **kw)
        return lambda *xs: jax_out.append(call(*xs)) or jax_out[-1]

    monkeypatch.setattr(pl, "pallas_call", jax_recorder)
    real = getattr(ip, wrapper)
    monkeypatch.setattr(ip, wrapper, lambda *xs: port_out.append(real(*xs)) or port_out[-1])
    want = getattr(js, jax_name)()
    assert port_probe("cpu") == want
    assert len(jax_out) == len(port_out) == 1
    _same(port_out[0], jax_out[0])


class _Stop(Exception):
    pass


def _bench_bodies(js, monkeypatch):
    """bench_dots' two kernel bodies with their output dtypes, int8 then bf16."""
    bodies = []

    def capture(kernel, out_shape, **_):
        bodies.append((kernel, out_shape.dtype))

        def stop(*_):
            raise _Stop

        return stop

    monkeypatch.setattr(pl, "pallas_call", capture)
    with pytest.raises(_Stop):
        js.bench_dots()
    monkeypatch.undo()
    return bodies


@pytest.mark.parametrize("arm", ["int8", "bf16"])
def test_bench_dots_bodies_match_the_port(js, arm, monkeypatch):
    bodies = _bench_bodies(js, monkeypatch)
    assert [np.dtype(d) for _, d in bodies] == [np.int32, np.float32]
    kernel, acc = bodies[0 if arm == "int8" else 1]
    M, K, N = 8, 256, 384
    rng = np.random.default_rng(7)
    a = rng.integers(-8, 8, (M, K), dtype=np.int8)
    b = rng.integers(-8, 8, (K, N), dtype=np.int8)
    call = REAL_PALLAS_CALL(kernel, out_shape=jax.ShapeDtypeStruct((M, N), acc), interpret=True)
    if arm == "int8":
        yj = call(jnp.asarray(a), jnp.asarray(b))
        yt = ip.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    else:
        yj = call(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
        yt = ip.bf16_dot(torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16))
    _same(yt, yj)
    np.testing.assert_array_equal(np.asarray(yj, np.float64), a.astype(np.float64) @ b)


# ---------------------------------------------------------------------------
# the plain versions at the kernels' edges
# ---------------------------------------------------------------------------


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape, dtype=np.int8)


# each edge gives (output, the numpy reference, the absolute tolerance: 0 is bit for bit)


def _edge_narrow(rng):
    x = rng.integers(-2**31, 2**31 - 1, (7, 129), dtype=np.int32)  # R*C not a multiple of 4
    return ip.narrow_cast(torch.from_numpy(x)), (x & 15).astype(np.int8), 0


def _edge_int8_ragged(rng):
    a, b = _int8(rng, (5, 200)), _int8(rng, (200, 130))
    return ip.int8_dot(torch.from_numpy(a), torch.from_numpy(b)), a.astype(np.int32) @ b, 0


def _edge_int8_extremes(rng):
    a = np.full((3, 4096), -128, np.int8)
    b = np.tile(np.array([-128, 127], np.int8), (4096, 8))  # columns of -128 and of 127
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(want).max() == 128 * 128 * 4096
    return ip.int8_dot(torch.from_numpy(a), torch.from_numpy(b)), want.astype(np.int32), 0


def _fused_want(x, w):
    p = w.astype(np.int32)
    return x.astype(np.int32) @ np.concatenate([(p & 15) - 8, (p >> 4) - 8], axis=0)


def _edge_fused_nibbles(rng):
    x = _int8(rng, (17, 198))  # S/2 = 99: a row quad straddles the two halves
    w = np.where(rng.random((99, 130)) < 0.5, 0, 255).astype(np.uint8)  # nibbles 0 and 15
    return ip.fused_unpack_int8_dot(torch.from_numpy(x), torch.from_numpy(w)), _fused_want(x, w), 0


def _edge_bf16(rng):
    a = rng.normal(size=(5, 200)).astype(np.float32)
    b = rng.normal(size=(200, 130)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    want = ta.double().numpy() @ tb.double().numpy()  # float32 sums: about 1e-6 of max |y| apart
    return ip.bf16_dot(ta, tb), want.astype(np.float32), 1e-5 * np.abs(want).max()


EDGES = {"narrow_cast ragged": _edge_narrow, "int8_dot ragged": _edge_int8_ragged,
         "int8_dot -128/127": _edge_int8_extremes, "fused nibbles 0/15": _edge_fused_nibbles,
         "bf16_dot random": _edge_bf16, "fused odd S": None}


@pytest.mark.parametrize("case", list(EDGES))
def test_plain_versions_at_the_edges(case):
    rng = np.random.default_rng(3)
    if EDGES[case] is None:  # the half-split layout needs an even S
        with pytest.raises(ValueError, match="even S"):
            ip.fused_unpack_int8_dot(torch.zeros((2, 7), dtype=torch.int8),
                                     torch.zeros((3, 4), dtype=torch.uint8))
        return
    y, want, atol = EDGES[case](rng)
    assert y.numpy().dtype == want.dtype and y.shape == want.shape
    if atol:
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(y.numpy(), want)


def test_wrappers_refuse_other_dtypes_and_shapes():
    with pytest.raises(TypeError):
        ip.narrow_cast(torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(TypeError):
        ip.int8_dot(torch.zeros((2, 4), dtype=torch.int8), torch.zeros((4, 2), dtype=torch.uint8))
    with pytest.raises(ValueError, match="do not chain"):
        ip.bf16_dot(torch.zeros((2, 4), dtype=torch.bfloat16), torch.zeros((3, 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="S/2"):
        ip.fused_unpack_int8_dot(torch.zeros((2, 8), dtype=torch.int8), torch.zeros((3, 4), dtype=torch.uint8))


@pytest.mark.parametrize("M, K, N, kind, want", [
    (8, 4096, 4096, "int8", (16, 2)),  # 64 column tiles: the K range splits 16 ways
    (8, 4096, 4096, "bf16", (16, 4)),
    (8, 96, 128, "int8", (1, 1)),  # one chunk: no split
    (8, 16384, 256, "int8", (128, 1)),
    (8, 4096, 300 * 64, "int8", (3, 11)),  # 300 tiles: every block keeps a chunk
])
def test_k_splits(M, K, N, kind, want):
    split, per = ip.k_splits(M, K, N, kind)
    chunks = -(-K // ip.CHUNK_K[kind])
    assert (split, per) == want and (split - 1) * per < chunks <= split * per


# ---------------------------------------------------------------------------
# the script on the CPU
# ---------------------------------------------------------------------------


def test_main_on_the_cpu(capsys):
    ok, rows = kp.main("cpu", reps=1, S=256, O=256)
    assert ok == {"narrow_cast": True, "int8_dot": True, "fused_unpack_int8_dot": True,
                  "bench_dots": True}
    assert [r["label"] for r in rows] == ["int8 dot", "bf16 dot"]
    assert [r["bytes"] for r in rows] == [8 * 256 + 256 * 256 + 4 * 8 * 256,
                                          2 * 8 * 256 + 2 * 256 * 256 + 4 * 8 * 256]
    for r in rows:  # the host clock gives no device rate
        assert r["us"] > 0 and r["gbps"] is None and r["device"] == "cpu (host clock)"
    out = capsys.readouterr().out
    assert out.count("PROBE_OK") == 4 and "PROBE_FAIL" not in out
    assert "int8 dot" in out and "@ 256x256 M=8" in out


def test_a_failed_probe_prints_probe_fail(monkeypatch, capsys):
    """A wrong kernel fails its probe with PROBE_FAIL (an assertion without a
    message, on which the JAX script's `_run` itself raises) and stops the
    bench, as the script's int8 probe gates it."""
    monkeypatch.setattr(ip, "int8_dot", lambda a, b: ip.int8_dot_plain(a, b) + 1)
    ok, rows = kp.main("cpu", reps=1, S=256, O=256)
    assert ok == {"narrow_cast": True, "int8_dot": False, "fused_unpack_int8_dot": True}
    assert rows == []
    assert "PROBE_FAIL int8_mxu_dot: AssertionError: " in capsys.readouterr().out


def test_the_jax_run_raises_on_an_assertion_without_a_message(js):
    """The reference's `_run` takes str(e).splitlines()[0], so the bare
    `assert` of a failed probe raises IndexError instead of PROBE_FAIL; the
    port's prints PROBE_FAIL."""

    def bad():  # what a failed `assert` gives outside pytest's rewritten test modules
        raise AssertionError

    with pytest.raises(IndexError):
        js._run("probe", bad)
    assert kp._run("probe", bad) == (False, None)
