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

K15's and K17's launch plans (`int8_plan`, `bf16_plan`) are pure functions
of shapes and the card's SM count, tested at an H100's 132 SMs (one wave at
the bench's shape, every split non-empty, two blocks an SM within shared
memory). The kernels run only on the card. `bf16_dot_model` models K17's
sums (an f32 partial per K split, the partials added in split order) and is
held bit for bit against the JAX bench body on integer inputs.
`int8_dot_model` models K15's dataflow byte by byte: the swizzled [k][n]
stages of B and the [m][k] rows of A, each lane's 32-bit reads, its
`transpose4x4` (the kernel's `__byte_perm` selectors), the
`mma.sync.m16n8k32` fragments as PTX lays them out, the column-to-row map of
the two m16 tiles and the store that undoes it, the two K halves of a stage
and the merge in split order; it is held bit for bit against `probe_int8_dot`
and the JAX bench's int8 body in interpret mode. The lanes' shared-memory
addresses of one k32 step are checked to fall on 32 distinct banks.
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


@pytest.mark.parametrize("M, K, N, want", [
    (8, 4096, 4096, (16, 2)),  # 64 column tiles: the K range splits 16 ways
    (8, 96, 128, (1, 1)),  # one chunk: no split
    (8, 16384, 256, (128, 1)),
    (8, 4096, 300 * 64, (3, 11)),  # 300 tiles: every block keeps a chunk
])
def test_k_splits(M, K, N, want):
    """K16's split of the K range."""
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


def int8_dot_model(a: torch.Tensor, b: torch.Tensor, KS: int, per: int, rows: int) -> torch.Tensor:
    """K15's kernel, byte by byte: per block (column tile of 128, split of
    `per` chunks of 128 K rows, row tile of `rows` = 8 NM), each chunk's B
    rows at their swizzled places and A's rows padded to 144 bytes, zero
    outside M, K, N; the 8 warps (column group cg = w & 3, K half kh = w >>
    2) read, transpose and multiply as the kernel does, columns 4g, 4g + 1
    as rows g, g + 8 of tile 0 and 4g + 2, 4g + 3 of tile 1; the K halves
    meet in the int32 tile; each split's partial, the partials summed in
    split order."""
    M, K = a.shape
    N = b.shape[1]
    NM, TN, BK = rows // 8, ip.INT8_TILE_N, ip.INT8_CHUNK_K
    n_tiles, m_tiles, chunks = -(-N // TN), -(-M // rows), -(-K // BK)
    assert (KS - 1) * per < chunks <= KS * per
    ap = torch.zeros(m_tiles * rows, chunks * BK, dtype=torch.uint8)
    ap[:M, :K] = a.view(torch.uint8)
    bp = torch.zeros(chunks * BK, n_tiles * TN, dtype=torch.uint8)
    bp[:K, :N] = b.view(torch.uint8)
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
                    sa = torch.zeros(rows, I8_SA, dtype=torch.uint8)
                    sa[:, :BK] = ap[mt * rows:(mt + 1) * rows, c * BK:(c + 1) * BK]
                    sa = sa.flatten()
                    for s in range(2):
                        kb = (32 * (2 * kh + s))[:, None]  # [8, 1]
                        lo = [words(sb, (kb + 4 * T_ + i) * TN + wb) for i in range(4)]
                        hi = [words(sb, (kb + 16 + 4 * T_ + i) * TN + wb) for i in range(4)]
                        cl, ch = transpose4x4(lo), transpose4x4(hi)
                        for j in range(NM):
                            ra = (8 * j + G_) * I8_SA + kb + 4 * T_  # [8, 32]
                            b0, b1 = words(sa, ra), words(sa, ra + 16)
                            acc[0, j] = mma_m16n8k32(acc[0, j], (cl[0], cl[1], ch[0], ch[1]), (b0, b1))
                            acc[1, j] = mma_m16n8k32(acc[1, j], (cl[2], cl[3], ch[2], ch[3]), (b0, b1))
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


@pytest.mark.parametrize("M", [1, 8, 16, 33])
@pytest.mark.parametrize("kernel", ["int8_dot", "bf16_dot"])
def test_streaming_dots_launch_by_plan(recorded, kernel, M):
    """On a device tensor K15 and K17 make one call of their entry with
    their plan's (per, split, rows), a partial of split x M x 128 ceil(N /
    128) of the output's dtype and the shared counters, and count one
    launch."""
    dtype, plan = (torch.int8, ip.int8_plan) if kernel == "int8_dot" else (torch.bfloat16, ip.bf16_plan)
    ip.reset_launch_counts()
    a = torch.empty(M, 4096, dtype=dtype, device="meta")
    b = torch.empty(4096, 4096, dtype=dtype, device="meta")
    out = getattr(ip, kernel)(a, b)
    ((entry, args),) = recorded
    KS, per, rows = plan(M, 4096, 4096, SMS)
    assert entry == f"paro_{kernel}" and args[5:11] == (M, 4096, 4096, per, KS, rows)
    assert out.shape == (M, 4096) and out.dtype == (torch.int32 if kernel == "int8_dot" else torch.float32)
    assert ip.launch_counts == {k: int(k == kernel) for k in ip.KERNELS}


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
