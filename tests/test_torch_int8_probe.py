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

K17's launch plan (`bf16_plan`) is a pure function of shapes and the card's
SM count, tested at an H100's 132 SMs (one wave at the bench's shape, every
split non-empty, two blocks an SM within shared memory). The kernel runs
only on the card; `bf16_dot_model` models its sums (an f32 partial per K
split, the partials added in split order) and is held bit for bit against
the JAX bench body on integer inputs.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paroquant_tpu_torch.kernels import int8_probe as ip, rot_matmul as rm
from paroquant_tpu_torch.scripts import bf16_dot_sweep, kernel_int8_probe as kp

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


@pytest.mark.parametrize("M, K, N, want", [
    (8, 4096, 4096, (16, 2)),  # 64 column tiles: the K range splits 16 ways
    (8, 96, 128, (1, 1)),  # one chunk: no split
    (8, 16384, 256, (128, 1)),
    (8, 4096, 300 * 64, (3, 11)),  # 300 tiles: every block keeps a chunk
])
def test_k_splits(M, K, N, want):
    """K15/K16's split of the K range."""
    split, per = ip.k_splits(M, K, N)
    chunks = -(-K // ip.CHUNK_K)
    assert (split, per) == want and (split - 1) * per < chunks <= split * per


# ---------------------------------------------------------------------------
# K17's plan, and a model of its sums against the JAX bench body
# ---------------------------------------------------------------------------

SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("M, K, N, want", [
    (8, 4096, 4096, (4, 16, 8)),  # the bench: 32 column tiles x 4 splits, one wave
    (1, 4096, 4096, (4, 16, 8)),
    (16, 4096, 4096, (4, 16, 16)),
    (17, 4096, 4096, (4, 16, 32)),
    (33, 4096, 4096, (2, 32, 32)),  # two row tiles
    (5, 96, 128, (2, 1, 8)),  # ragged K: the last chunk holds 32 rows
    (5, 200, 130, (4, 1, 8)),  # the last chunk holds 8 rows
    (8, 16384, 256, (64, 4, 8)),  # split K: 64 splits of four chunks
    (8, 64, 300 * 128, (1, 1, 8)),  # past one wave: no split
])
def test_bf16_plan(M, K, N, want):
    """One wave of one block an SM where the columns leave room for splits,
    every split non-empty, at most one split a chunk."""
    KS, per, rows = plan = ip.bf16_plan(M, K, N, SMS)
    assert plan == want
    chunks = -(-K // ip.BF16_CHUNK_K)
    assert (KS - 1) * per < chunks <= KS * per
    blocks = -(-N // ip.BF16_TILE_N) * -(-M // rows) * KS
    assert blocks <= SMS or KS == 1


@pytest.mark.parametrize("rows", ip.BF16_ROWS)
def test_bf16_ring_fits_two_blocks_an_sm(rows):
    """The ring of 4 stages (B's 64 x 128 and A's rows x 64 bf16, rows
    padded by 8) fits twice in an SM's shared memory: 74-88 KB a block."""
    assert 70_000 < ip.bf16_smem(rows) and 2 * ip.bf16_smem(rows) <= rm.MAX_SMEM_BYTES


def bf16_dot_model(a: torch.Tensor, b: torch.Tensor, KS: int, per: int) -> torch.Tensor:
    """K17's sums: split ks takes K rows [64 per ks, 64 per (ks + 1)), its f32
    partial a_ks @ b_ks, and the partials added in split order from 0."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for ks in range(KS):
        k = slice(ip.BF16_CHUNK_K * per * ks, ip.BF16_CHUNK_K * per * (ks + 1))
        out = out + a[:, k].float() @ b[k].float()
    return out


@pytest.mark.parametrize("variant", list(bf16_dot_sweep.VARIANTS))
def test_sweep_variants_find_their_anchors(variant):
    """scripts/bf16_dot_sweep.py builds K17 with other constants and B's L2
    policy: each anchor must be in csrc/int8_probe.cu once, and the
    committed variant is the source as it is."""
    stages, rows, evict_first = bf16_dot_sweep.VARIANTS[variant]
    src = bf16_dot_sweep.variant_source(stages, rows, evict_first)
    assert f"constexpr int BF_NST = {stages};" in src and f"constexpr int BF_BK = {rows};" in src
    assert ("cp_async16_evict_first(dst, ok ? B" in src) == evict_first
    if variant == "committed":
        assert src == (bf16_dot_sweep.build.CSRC / "int8_probe.cu").read_text()


@pytest.mark.parametrize("M, K, N", [(8, 256, 384), (5, 200, 130), (33, 1024, 256)])
def test_bf16_dot_model_matches_the_jax_bench_body(js, monkeypatch, M, K, N):
    """On integer inputs every product and partial sum is exact in f32, so
    the model, at the plan's splits and at one split a chunk, and the JAX
    bench's bf16 body agree bit for bit."""
    kernel, acc = _bench_bodies(js, monkeypatch)[1]
    rng = np.random.default_rng(K)
    a = rng.integers(-8, 8, (M, K)).astype(np.float32)
    b = rng.integers(-8, 8, (K, N)).astype(np.float32)
    call = REAL_PALLAS_CALL(kernel, out_shape=jax.ShapeDtypeStruct((M, N), acc), interpret=True)
    yj = call(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ta, tb = torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    KS, per, _ = ip.bf16_plan(M, K, N, SMS)
    chunks = -(-K // ip.BF16_CHUNK_K)
    assert KS > 1
    for ks, p in ((KS, per), (chunks, 1), (1, chunks)):
        _same(bf16_dot_model(ta, tb, ks, p), yj)


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
