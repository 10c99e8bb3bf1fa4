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

K15's, K16's and K17's launch plans (`int8_plan`, `fused_plan`,
`bf16_plan`) are pure functions of shapes and the card's SM count, tested
at an H100's 132 SMs (one wave at the bench's shape, every split non-empty,
two blocks an SM within shared memory). The kernels run only on the card.
`bf16_dot_model` models K17's sums (an f32 partial per K split, the
partials added in split order) and is held bit for bit against the JAX
bench body on integer inputs. `int8_dot_model` models K15's dataflow byte
by byte (`_stream_model`): the swizzled [k][n] stages of B and the [m][k]
rows of A, each lane's 32-bit reads, its `transpose4x4` (the kernel's
`__byte_perm` selectors), the `mma.sync.m16n8k32` fragments as PTX lays
them out, the column-to-row map of the two m16 tiles and the store that
undoes it, the two K halves of a stage and the merge in split order; it is
held bit for bit against `probe_int8_dot` and the JAX bench's int8 body in
interpret mode. `fused_dot_model` runs the same dataflow as K16's nibble
instance: stages of w's byte-rows, x's two column ranges in the stage, each
word unpacked (`__vsub4`) after the transpose into a low and a high k32
step; it is held bit for bit against `probe_fused_unpack_int8_dot` and its
kernel body at other shapes, and shown to need x's stage columns past S/2
zeroed. The lanes' shared-memory addresses of one k32 step are checked to
fall on 32 distinct banks.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paroquant_tpu_torch.kernels import int8_probe as ip, rot_matmul as rm
from paroquant_tpu_torch.scripts import bf16_dot_sweep, int8_dot_sweep, kernel_int8_probe as kp

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


@pytest.mark.parametrize("variant", list(int8_dot_sweep.VARIANTS))
def test_int8_sweep_variants_find_their_anchors(variant):
    """scripts/int8_dot_sweep.py builds K15 with other ring depths and B's L2
    policy: each anchor must be in csrc/int8_probe.cu once, K17's lines stay
    as they are, and the committed variant is the source as it is."""
    stages, evict_first = int8_dot_sweep.VARIANTS[variant]
    src = int8_dot_sweep.variant_source(stages, evict_first)
    committed = (bf16_dot_sweep.build.CSRC / "int8_probe.cu").read_text()
    assert f"constexpr int I8_NST = {stages};" in src and "constexpr int BF_NST = 4;" in src
    assert src.count("createpolicy.fractional.L2::evict_first") == 1 + evict_first
    assert src.count("cp_async16_evict_first(dst, ok ? B") == 1 + evict_first
    if variant == "committed":
        assert src == committed


def test_int8_sweep_reads_ldgsts_descriptor_registers():
    """The sweep's check before a call: the uniform registers of LDGSTS's
    memory descriptors in SASS text, other instructions' ignored."""
    sass = """
        /*0390*/ LDGSTS.E.BYPASS.128 [R11+UR0], desc[UR1][R8.64], P0 ;  /* 0x00000000080b7dae */
        /*03a0*/ LDG.E.U8 R7, desc[UR3][R8.64] ;  /* 0x0000000808078981 */
        /*0410*/ LDGSTS.E.BYPASS.128 [R7], desc[UR4][R14.64], P0 ;  /* 0x000000000e077fae */
        /*0420*/ @P1 LDGSTS.E.BYPASS.128 [R9], desc[UR8][R12.64], P0 ;  /* 0x000000000c097fae */
    """
    assert int8_dot_sweep.descriptor_registers(sass) == [1, 4, 8]
    assert int8_dot_sweep.descriptor_registers("") == []


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
# K15's plan, its shared-memory layout, and a model of its dataflow against
# the JAX probe and bench body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M, K, N, want", [
    (8, 4096, 4096, (4, 8, 8)),  # the bench: 32 column tiles x 4 splits of 8 chunks, one wave
    (1, 4096, 4096, (4, 8, 8)),
    (16, 4096, 4096, (4, 8, 16)),
    (32, 4096, 4096, (4, 8, 32)),
    (33, 4096, 4096, (2, 16, 32)),  # two row tiles
    (8, 256, 128, (2, 1, 8)),  # the probe: one chunk a split
    (5, 200, 130, (2, 1, 8)),  # ragged K and N: the last chunk holds 72 rows
    (8, 96, 128, (1, 1, 8)),  # one chunk: no split
    (8, 16384, 256, (64, 2, 8)),
    (8, 128, 300 * 128, (1, 1, 8)),  # past one wave: no split
])
def test_int8_plan(M, K, N, want):
    """K17's rule with 128-row chunks: one wave of one block an SM where the
    columns leave room for splits, every split non-empty, at most one split
    a chunk."""
    KS, per, rows = plan = ip.int8_plan(M, K, N, SMS)
    assert plan == want
    chunks = -(-K // ip.INT8_CHUNK_K)
    assert (KS - 1) * per < chunks <= KS * per
    blocks = -(-N // ip.INT8_TILE_N) * -(-M // rows) * KS
    assert blocks <= SMS or KS == 1


@pytest.mark.parametrize("rows", ip.BF16_ROWS)
def test_int8_ring_fits_two_blocks_an_sm(rows):
    """The ring of 4 stages (B's 128 x 128 bytes and A's rows x 128, rows
    padded by 16 bytes) fits twice in an SM's shared memory (68-82 KB a
    block), and the int32 tile of the stores fits in the ring."""
    assert 65_000 < ip.int8_smem(rows) and 2 * ip.int8_smem(rows) <= rm.MAX_SMEM_BYTES
    assert rows * (ip.INT8_TILE_N + 4) * 4 <= ip.int8_smem(rows)


@pytest.mark.parametrize("M, S, O, want", [
    (8, 256, 512, (1, 1, 8)),  # the probe: one chunk of byte-rows, 4 column tiles
    (8, 4096, 4096, (4, 4, 8)),  # the bench's geometry: 32 column tiles x 4 splits of 4 chunks
    (1, 4096, 4096, (4, 4, 8)),
    (16, 4096, 4096, (4, 4, 16)),
    (32, 4096, 4096, (4, 4, 32)),
    (33, 4096, 4096, (2, 8, 32)),  # two row tiles
    (5, 198, 130, (1, 1, 8)),  # S/2 = 99: one ragged chunk
    (32, 512, 256, (2, 1, 32)),
    (8, 16384, 256, (64, 1, 8)),  # split K: 64 splits of one chunk
    (8, 256, 300 * 128, (1, 1, 8)),  # past one wave: no split
])
def test_fused_plan(M, S, O, want):
    """K15's rule over w's S/2 byte-rows: one wave of one block an SM where
    the columns leave room for splits, every split non-empty, at most one
    split a chunk of 128 byte-rows."""
    KS, per, rows = plan = ip.fused_plan(M, S, O, SMS)
    assert plan == want
    chunks = -(-(S // 2) // ip.INT8_CHUNK_K)
    assert (KS - 1) * per < chunks <= KS * per
    blocks = -(-O // ip.INT8_TILE_N) * -(-M // rows) * KS
    assert blocks <= SMS or KS == 1


@pytest.mark.parametrize("rows", ip.BF16_ROWS)
def test_fused_ring_fits_two_blocks_an_sm(rows):
    """K16's ring of 4 stages (w's 128 x 128 bytes and x's rows twice, each
    padded to 144 bytes) fits twice in an SM's shared memory: 100 KB a block
    at 32 rows (4 x (16384 + 2 x 32 x 144))."""
    assert ip.fused_smem(rows) == 4 * (128 * 128 + 2 * rows * 144)
    assert 2 * ip.fused_smem(rows) <= rm.MAX_SMEM_BYTES
    assert ip.fused_smem(32) == 102_400


LANE = torch.arange(32)
G_, T_ = LANE // 4, LANE % 4  # a lane's group and thread in the group
I8_SA = ip.INT8_CHUNK_K + ip.INT8_PAD  # A's shared row stride in bytes


def b_swizzle(r, p):
    """Byte offset in a B stage of 16-byte piece p of the stage's k-row r
    (`i8_swizzle`): the piece index XOR 2 ((r >> 2) & 3)."""
    return r * ip.INT8_TILE_N + ((p ^ (((r >> 2) & 3) << 1)) << 4)


def b_word(cg):
    """A lane's fixed byte offset in a B row (`wb`): word g of the warp's
    32 columns, in piece 2 cg + g / 4 swizzled by 2t."""
    return (((2 * cg + (G_ >> 2)) ^ (2 * T_)) << 4) + 4 * (G_ & 3)


def b_rows(kh, s, half):
    """The four k-rows (of the stage) a lane reads in step s of K half kh:
    4t + i, or 16 + 4t + i for the second half of the k32 step; [32, 4]."""
    kb = 32 * (2 * kh + s) + 16 * half
    return kb + 4 * T_[:, None] + torch.arange(4)[None, :]


@pytest.mark.parametrize("kh, s, half", [(kh, s, h) for kh in (0, 1) for s in (0, 1) for h in (0, 1)])
@pytest.mark.parametrize("cg", range(4))
def test_int8_b_reads_hit_32_banks_and_the_copy(cg, kh, s, half):
    """Each of a lane's eight 32-bit reads of B, across the warp, falls on 32
    distinct banks (4-byte words mod 32) and reads the four columns 32 cg +
    4g .. + 3 of the row the copy put there; without the swizzle the same
    reads share 8 banks."""
    rows = b_rows(kh, s, half)
    for i in range(4):
        addr = rows[:, i] * ip.INT8_TILE_N + b_word(cg)
        assert len(set((addr // 4 % 32).tolist())) == 32
        col = 32 * cg + 4 * G_
        copy = b_swizzle(rows[:, i], col // 16) + col % 16  # where the copy put column col
        assert torch.equal(addr, copy)
        plain = rows[:, i] * ip.INT8_TILE_N + col
        assert len(set((plain // 4 % 32).tolist())) == 8


@pytest.mark.parametrize("s", [0, 1, 2, 3])
@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_int8_a_reads_hit_32_banks(j, s):
    """A's fragment reads (rows 8j + g, bytes 32 s + 4t and + 16) fall on 32
    distinct banks with rows padded to 144 bytes."""
    for off in (0, 16):
        addr = (8 * j + G_) * I8_SA + 32 * s + 4 * T_ + off
        assert len(set((addr // 4 % 32).tolist())) == 32


def byte_perm(x, y, sel):
    """`__byte_perm(x, y, sel)` on int64 tensors of 32-bit words: byte n of
    the result is byte (sel >> 4n) & 7 of the eight bytes of (y:x)."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def transpose4x4(r):
    """csrc/int8_probe.cu::transpose4x4 with its selectors: rows r[0..3] of a
    4 x 4 byte block -> its columns."""
    t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    t2, t3 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def s8_bytes(w):
    """[..., 32] words -> [..., 32, 4] signed bytes (byte i at k 4t + i)."""
    b = (w[..., None] >> (8 * torch.arange(4))) & 0xFF
    return (b ^ 0x80) - 0x80


def mma_m16n8k32(c, a, b):
    """`mma.sync.m16n8k32.row.col.s32.s8.s8.s32` over W warps as PTX lays out
    its fragments (lane (g, t)): a0 row g, k 4t..4t+3; a1 row g + 8; a2 row
    g, k 16 + 4t..; a3 row g + 8, k 16 + 4t..; b0 column g, k 4t..; b1
    column g, k 16 + 4t..; c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g +
    8. a: four [W, 32] words, b: two, c: [W, 32, 4] int64."""
    W = c.shape[0]
    k = 4 * T_[:, None] + torch.arange(4)[None, :]  # [32, 4]
    g = G_[:, None].expand(32, 4)
    A = torch.zeros(W, 16, 32, dtype=torch.int64)
    for reg, (row, kk) in zip(a, ((g, k), (g + 8, k), (g, k + 16), (g + 8, k + 16))):
        A[:, row, kk] = s8_bytes(reg)
    B = torch.zeros(W, 32, 8, dtype=torch.int64)
    for reg, kk in zip(b, (k, k + 16)):
        B[:, kk, g] = s8_bytes(reg)
    D = A @ B
    g1, t1 = G_, T_
    return c + torch.stack([D[:, g1, 2 * t1], D[:, g1, 2 * t1 + 1],
                            D[:, g1 + 8, 2 * t1], D[:, g1 + 8, 2 * t1 + 1]], dim=-1)


def words(stage, offsets):
    """Little-endian 32-bit words of a uint8 stage at byte offsets."""
    st = stage.to(torch.int64)
    return sum(st[offsets + i] << (8 * i) for i in range(4))


def vsub4(a, b):
    """`__vsub4(a, b)` on int64 tensors of 32-bit words: byte-wise a - b
    modulo 256."""
    return sum(((((a >> (8 * n)) & 0xFF) - ((b >> (8 * n)) & 0xFF)) & 0xFF) << (8 * n)
               for n in range(4))


def nibbles_s8(c, h):
    """csrc/int8_probe.cu::nibbles_s8: the low (h = 0) or high (h = 1)
    nibble of each byte of the words c, minus 8, as int8 bytes."""
    return vsub4((c >> (4 * h)) & 0x0F0F0F0F, 0x08080808)


def _stream_model(a_stage, bp, M: int, N: int, KS: int, per: int, rows: int,
                  nib: bool) -> torch.Tensor:
    """`int8_stream_kernel<rows / 8, nib>`, byte by byte: per block (column
    tile of 128, split of `per` chunks of 128 K rows, row tile of `rows` = 8
    NM), each chunk's B rows (bp, uint8, zero-padded to whole chunks and
    tiles) at their swizzled places and its A rows (`a_stage(mt, c)`,
    uint8 [rows, 128], or [2 rows, 128] with nib: x's two column ranges)
    padded to 144 bytes; the 8 warps (column group cg = w & 3, K half kh = w
    >> 2) read, transpose and multiply as the kernel does, columns 4g, 4g +
    1 as rows g, g + 8 of tile 0 and 4g + 2, 4g + 3 of tile 1 (nib: each
    word unpacked after the transpose, its low nibbles against A's first
    rows, its high ones against the second); the K halves meet in the int32
    tile; each split's partial, the partials summed in split order."""
    NM, TN, BK = rows // 8, ip.INT8_TILE_N, ip.INT8_CHUNK_K
    n_tiles, m_tiles, chunks = -(-N // TN), -(-M // rows), bp.shape[0] // BK
    assert (KS - 1) * per < chunks <= KS * per
    r = torch.arange(BK)[:, None]
    n = torch.arange(TN)[None, :]
    place = b_swizzle(r, n // 16) + n % 16  # [k][n] -> byte of the B stage
    warp = torch.arange(8)
    cg, kh = warp & 3, warp >> 2
    wb = torch.stack([b_word(int(c)) for c in cg])  # [8, 32]
    part = torch.zeros(KS, m_tiles * rows, n_tiles * TN, dtype=torch.int64)
    for mt in range(m_tiles):
        for nt in range(n_tiles):
            for ks in range(KS):
                acc = torch.zeros(2, NM, 8, 32, 4, dtype=torch.int64)
                for c in range(ks * per, min(chunks, (ks + 1) * per)):
                    sb = torch.zeros(BK * TN, dtype=torch.uint8)
                    sb[place.flatten()] = bp[c * BK:(c + 1) * BK, nt * TN:(nt + 1) * TN].flatten()
                    rows_a = a_stage(mt, c)
                    sa = torch.zeros(rows_a.shape[0], I8_SA, dtype=torch.uint8)
                    sa[:, :BK] = rows_a
                    sa = sa.flatten()
                    for s in range(2):
                        kb = (32 * (2 * kh + s))[:, None]  # [8, 1]
                        lo = [words(sb, (kb + 4 * T_ + i) * TN + wb) for i in range(4)]
                        hi = [words(sb, (kb + 16 + 4 * T_ + i) * TN + wb) for i in range(4)]
                        cl, ch = transpose4x4(lo), transpose4x4(hi)
                        halves = ([([nibbles_s8(v, h) for v in cl], [nibbles_s8(v, h) for v in ch],
                                    h * rows) for h in (0, 1)] if nib else [(cl, ch, 0)])
                        for ql, qh, r0 in halves:
                            for j in range(NM):
                                ra = (r0 + 8 * j + G_) * I8_SA + kb + 4 * T_  # [8, 32]
                                b0, b1 = words(sa, ra), words(sa, ra + 16)
                                acc[0, j] = mma_m16n8k32(acc[0, j], (ql[0], ql[1], qh[0], qh[1]), (b0, b1))
                                acc[1, j] = mma_m16n8k32(acc[1, j], (ql[2], ql[3], qh[2], qh[3]), (b0, b1))
                red = torch.zeros(rows, TN + 4, dtype=torch.int64)
                for half in (0, 1):
                    for w in range(8):
                        if int(kh[w]) != half:
                            continue
                        for j in range(NM):
                            for e in range(2):
                                v = torch.stack([acc[0, j, w, :, e], acc[0, j, w, :, 2 + e],
                                                 acc[1, j, w, :, e], acc[1, j, w, :, 2 + e]], -1)
                                m_row = 8 * j + 2 * T_ + e
                                col = 32 * int(cg[w]) + 4 * G_[:, None] + torch.arange(4)
                                red[m_row[:, None], col] += v
                part[ks, mt * rows:(mt + 1) * rows, nt * TN:(nt + 1) * TN] = red[:, :TN]
    out = torch.zeros(m_tiles * rows, n_tiles * TN, dtype=torch.int64)
    for ks in range(KS):
        out = out + part[ks]
    return out[:M, :N].to(torch.int32)


def int8_dot_model(a: torch.Tensor, b: torch.Tensor, KS: int, per: int, rows: int) -> torch.Tensor:
    """K15's kernel, byte by byte (`_stream_model`): A's and B's rows zero
    outside M, K, N."""
    M, K = a.shape
    N = b.shape[1]
    TN, BK = ip.INT8_TILE_N, ip.INT8_CHUNK_K
    chunks = -(-K // BK)
    ap = torch.zeros(-(-M // rows) * rows, chunks * BK, dtype=torch.uint8)
    ap[:M, :K] = a.view(torch.uint8)
    bp = torch.zeros(chunks * BK, -(-N // TN) * TN, dtype=torch.uint8)
    bp[:K, :N] = b.view(torch.uint8)
    return _stream_model(lambda mt, c: ap[mt * rows:(mt + 1) * rows, c * BK:(c + 1) * BK],
                         bp, M, N, KS, per, rows, nib=False)


def fused_dot_model(x: torch.Tensor, w: torch.Tensor, KS: int, per: int, rows: int,
                    x_masked: bool = True) -> torch.Tensor:
    """K16's kernel, byte by byte (`_stream_model` over w's S/2 byte-rows):
    a stage's A part holds x's columns [r0, r0 + 128) and [S/2 + r0, S/2 +
    r0 + 128) (x as [2M, S/2], rows 2m and 2m + 1), zero past M and past
    S/2 byte-rows; byte-rows of w past S/2 are zero, which unpack to q =
    -8. With x_masked False the stage's x columns run on to x's end instead
    (the low half reads the high half's columns): w's zero rows alone would
    have to keep the dot right, and they do not."""
    M, S = x.shape
    K, N = w.shape
    TN, BK = ip.INT8_TILE_N, ip.INT8_CHUNK_K
    chunks = -(-K // BK)
    xp = torch.zeros(-(-M // rows) * rows, 2, chunks * BK + K, dtype=torch.uint8)
    if x_masked:
        xp[:M, :, :K] = x.view(torch.uint8).reshape(M, 2, K)
    else:
        xp[:M, 0, :S] = x.view(torch.uint8)
        xp[:M, 1, :K] = x.view(torch.uint8)[:, K:]
    bp = torch.zeros(chunks * BK, -(-N // TN) * TN, dtype=torch.uint8)
    bp[:K, :N] = w
    return _stream_model(
        lambda mt, c: xp[mt * rows:(mt + 1) * rows, :, c * BK:(c + 1) * BK].transpose(0, 1)
        .reshape(2 * rows, BK), bp, M, N, KS, per, rows, nib=True)


def test_int8_dot_model_matches_the_jax_probe(js, monkeypatch):
    """The probe's own inputs (8 x 256 @ 256 x 128 from its seed) through
    the model at the plan's splits, against `probe_int8_dot`'s pallas_call
    in interpret mode, bit for bit."""
    jax_out, port_out = [], []

    def jax_recorder(*args, **kw):
        call = REAL_PALLAS_CALL(*args, interpret=True, **kw)
        return lambda *xs: jax_out.append(call(*xs)) or jax_out[-1]

    def model(a, b):
        port_out.append(int8_dot_model(a, b, *ip.int8_plan(*a.shape, b.shape[1], SMS)))
        return port_out[-1]

    monkeypatch.setattr(pl, "pallas_call", jax_recorder)
    monkeypatch.setattr(ip, "int8_dot", model)
    assert kp.probe_int8_dot("cpu") == js.probe_int8_dot()
    assert ip.int8_plan(8, 256, 128, SMS) == (2, 1, 8)
    _same(port_out[0], jax_out[0])


@pytest.mark.parametrize("M, K, N", [(8, 256, 128), (5, 200, 130), (33, 1024, 256),
                                     (32, 512, 256)])
def test_int8_dot_model_matches_the_jax_bench_body(js, monkeypatch, M, K, N):
    """The model at `int8_plan`'s splits, at one split and at one chunk a
    split, on int8 values over the whole range, against the JAX bench's
    int8 body in interpret mode, bit for bit."""
    kernel, acc = _bench_bodies(js, monkeypatch)[0]
    rng = np.random.default_rng(K + N)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    a[0, :] = -128  # the extremes in one row and one column
    b[:, -1] = -128
    call = REAL_PALLAS_CALL(kernel, out_shape=jax.ShapeDtypeStruct((M, N), acc), interpret=True)
    yj = call(jnp.asarray(a), jnp.asarray(b))
    KS, per, rows = ip.int8_plan(M, K, N, SMS)
    chunks = -(-K // ip.INT8_CHUNK_K)
    assert KS > 1
    for ks, p in ((KS, per), (1, chunks), (chunks, 1)):
        _same(int8_dot_model(torch.from_numpy(a), torch.from_numpy(b), ks, p, rows), yj)


@pytest.mark.parametrize("rows", ip.BF16_ROWS)
def test_int8_dot_model_takes_each_row_tiling(rows):
    """NM = 1, 2 and 4 n8 tiles of A's rows (and M padded to them) give the
    same output."""
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.integers(-128, 128, (7, 256), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (256, 136), dtype=np.int8))
    want = ip.int8_dot_plain(a, b)
    assert torch.equal(int8_dot_model(a, b, 2, 1, rows), want)


def _fused_body(js, monkeypatch):
    """`probe_fused_unpack_int8_dot`'s kernel body (captured; the stand-in
    raises before the probe's own call runs)."""
    bodies = []

    def capture(kernel, out_shape, **_):
        bodies.append(kernel)

        def stop(*_):
            raise _Stop

        return stop

    monkeypatch.setattr(pl, "pallas_call", capture)
    with pytest.raises(_Stop):
        js.probe_fused_unpack_int8_dot()
    monkeypatch.undo()
    return bodies[0]


def _fused_jax(js, monkeypatch, x, w):
    kernel = _fused_body(js, monkeypatch)
    call = REAL_PALLAS_CALL(kernel, out_shape=jax.ShapeDtypeStruct((x.shape[0], w.shape[1]), jnp.int32),
                            interpret=True)
    return call(jnp.asarray(x), jnp.asarray(w))


def test_fused_dot_model_matches_the_jax_probe(js, monkeypatch):
    """The probe's own inputs (x 8 x 256, w 128 x 512 from its seed) through
    K16's model at its plan (one split, 4 column tiles), against
    `probe_fused_unpack_int8_dot`'s pallas_call in interpret mode, bit for
    bit."""
    jax_out, port_out = [], []

    def jax_recorder(*args, **kw):
        call = REAL_PALLAS_CALL(*args, interpret=True, **kw)
        return lambda *xs: jax_out.append(call(*xs)) or jax_out[-1]

    def model(x, w):
        port_out.append(fused_dot_model(x, w, *ip.fused_plan(*x.shape, w.shape[1], SMS)))
        return port_out[-1]

    monkeypatch.setattr(pl, "pallas_call", jax_recorder)
    monkeypatch.setattr(ip, "fused_unpack_int8_dot", model)
    assert kp.probe_fused_unpack_int8_dot("cpu") == js.probe_fused_unpack_int8_dot()
    assert ip.fused_plan(8, 256, 512, SMS) == (1, 1, 8)
    _same(port_out[0], jax_out[0])


@pytest.mark.parametrize("M, S, O", [
    (5, 198, 130),  # S/2 = 99: a row quad across the end of w, x's copies element by element
    (8, 200, 128),  # S/2 = 100: not a multiple of 16
    (16, 96, 136),  # S/2 = 48: one ragged chunk, 16-byte copies
    (32, 512, 256),  # two splits at the plan
    (33, 1024, 256),  # two row tiles, four splits
])
def test_fused_dot_model_matches_the_jax_probe_body(js, monkeypatch, M, S, O):
    """K16's model at `fused_plan`'s splits, at one split and at one chunk a
    split, on x over the whole int8 range and w over every byte, against the
    JAX probe's kernel body in interpret mode at the same shape, bit for
    bit."""
    rng = np.random.default_rng(S + O)
    x = rng.integers(-128, 128, (M, S), dtype=np.int8)
    w = rng.integers(0, 256, (S // 2, O), dtype=np.uint8)
    x[0, :] = -128  # the extremes in one row, nibbles 0 and 15 in two columns
    w[:, 0], w[:, -1] = 0, 255
    yj = _fused_jax(js, monkeypatch, x, w)
    np.testing.assert_array_equal(np.asarray(yj), _fused_want(x, w))
    KS, per, rows = ip.fused_plan(M, S, O, SMS)
    chunks = -(-(S // 2) // ip.INT8_CHUNK_K)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for ks, p in {(KS, per), (1, chunks), (chunks, 1)}:
        _same(fused_dot_model(tx, tw, ks, p, rows), yj)


@pytest.mark.parametrize("rows", ip.BF16_ROWS)
def test_fused_dot_model_takes_each_row_tiling(rows):
    """NM = 1, 2 and 4 n8 tiles of x's rows (and M padded to them) give the
    plain version's output, at two splits."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.integers(-128, 128, (7, 512), dtype=np.int8))
    w = torch.from_numpy(rng.integers(0, 256, (256, 136), dtype=np.uint8))
    assert torch.equal(fused_dot_model(x, w, 2, 1, rows), ip.fused_unpack_int8_dot_plain(x, w))


def test_fused_dot_needs_x_masked_past_half_s(js, monkeypatch):
    """At S/2 = 99 the stage's byte-rows 99..127 of w are zero-filled, and a
    zero byte unpacks to q = -8 in both nibbles: with x's stage columns past
    S/2 taken from x's memory (w's zero rows the only mask) the dot is wrong;
    with them zero, as the kernel copies them, it is the JAX probe's."""
    rng = np.random.default_rng(99)
    x = rng.integers(-128, 128, (8, 198), dtype=np.int8)
    w = rng.integers(0, 256, (99, 128), dtype=np.uint8)
    yj = np.asarray(_fused_jax(js, monkeypatch, x, w))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    _same(fused_dot_model(tx, tw, 1, 1, 8), yj)
    assert not np.array_equal(fused_dot_model(tx, tw, 1, 1, 8, x_masked=False).numpy(), yj)


@pytest.fixture
def recorded(monkeypatch):
    """The library's entry points replaced by a recorder of (entry, args)."""
    calls = []
    monkeypatch.setattr(ip, "_lib_fn", lambda entry: lambda *a: calls.append((entry, a)) or 0)
    monkeypatch.setattr(ip, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(rm, "_split_counters", {})
    return calls


STREAMING = {  # wrapper: (a's dtype, b's dtype and rows, plan)
    "int8_dot": (torch.int8, torch.int8, 4096, ip.int8_plan),
    "bf16_dot": (torch.bfloat16, torch.bfloat16, 4096, ip.bf16_plan),
    "fused_unpack_int8_dot": (torch.int8, torch.uint8, 2048, ip.fused_plan),
}


@pytest.mark.parametrize("M", [1, 8, 16, 33])
@pytest.mark.parametrize("kernel", list(STREAMING))
def test_streaming_dots_launch_by_plan(recorded, kernel, M):
    """On a device tensor K15, K16 and K17 make one call of their entry with
    a's K (K16: S) and their plan's (per, split, rows), a partial of split x
    M x 128 ceil(N / 128) of the output's dtype and the shared counters, and
    count one launch."""
    a_dtype, b_dtype, b_rows, plan = STREAMING[kernel]
    ip.reset_launch_counts()
    a = torch.empty(M, 4096, dtype=a_dtype, device="meta")
    b = torch.empty(b_rows, 4096, dtype=b_dtype, device="meta")
    out = getattr(ip, kernel)(a, b)
    ((entry, args),) = recorded
    KS, per, rows = plan(M, 4096, 4096, SMS)
    assert entry == f"paro_{kernel}" and args[5:11] == (M, 4096, 4096, per, KS, rows)
    assert len(args) == 12  # and the stream
    assert out.shape == (M, 4096) and out.dtype == (torch.float32 if kernel == "bf16_dot" else torch.int32)
    assert ip.launch_counts == {k: int(k == kernel) for k in ip.KERNELS}


def test_empty_kernel_launches_its_entry_and_counts_nothing(recorded):
    """The launch floor's empty kernel: one call of `paro_empty` with the
    stream alone, no launch counted."""
    ip.reset_launch_counts()
    ip.empty_kernel("meta")
    assert recorded == [("paro_empty", (0,))]
    assert ip.launch_counts == dict.fromkeys(ip.KERNELS, 0)


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
