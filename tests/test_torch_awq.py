"""The AWQ pair, the native packer and the AWQ branch of the port's loader
against the JAX package: packing bit for bit on both sides of the native
routing threshold, the native library (built here with g++) against the
numpy path, prompt-lookup drafting across its 512-token switch, AWQ
checkpoints that JAX's `save_awq_checkpoint` writes, and the port's
safetensors writer read back by the `safetensors` library."""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert.rtn import rtn_export_model
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.ops import packing as jpack
from paroquant_tpu.serve.generator import _lookup_draft as j_lookup_draft
from paroquant_tpu_torch.convert.checkpoint import (_DTYPES, load_checkpoint, read_safetensors,
                                                    write_safetensors)
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops import native_packing as nat
from paroquant_tpu_torch.ops import packing as tpack
from paroquant_tpu_torch.serve import generator as tgen

JCFG = J_PRESETS["tiny"]
# [R, C] int inputs: below and above the 1 MB routing threshold (int32)
SHAPES = {"small": (128, 64), "above_1mb": (512, 1024)}


def _ints(shape, seed, lo=0, hi=16, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(dtype)


def _numpy_only(monkeypatch):
    """Route every size to the numpy path."""
    monkeypatch.setattr(tpack, "_NATIVE_MIN_BYTES", 1 << 62)


@pytest.mark.parametrize("size", list(SHAPES))
@pytest.mark.parametrize("values", ["nibbles", "any_int"])
def test_pack_awq_matches_jax(size, values):
    lo, hi = (0, 16) if values == "nibbles" else (-(1 << 20), 1 << 20)
    q = _ints(SHAPES[size], 1, lo, hi)
    got, want = tpack.pack_awq(q), jpack.pack_awq(q)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 16), (256, 64)])  # 4 KB / 64 KB and 256 KB packed words
def test_unpack_awq_matches_jax(shape):
    words = _ints(shape, 2, -(1 << 31), 1 << 31, np.int64).astype(np.int32)
    got, want = tpack.unpack_awq(words), jpack.unpack_awq(words)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpack.pack_awq(got), words)  # the pair round-trips


@pytest.mark.parametrize("size", list(SHAPES))
@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor"])
def test_pack_w4_tpu_matches_jax(size, kind):
    q = _ints(SHAPES[size], 3)
    got = tpack.pack_w4_tpu(q if kind == "numpy" else torch.from_numpy(q))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpack.pack_w4_tpu(q)))


def test_native_library_builds_here():
    lib = nat.library()
    assert lib is not None
    assert nat.library_path().parent.parent == nat.BUILD_ROOT
    assert "native" not in nat.library_path().parent.parent.parts[-2:]


@pytest.mark.parametrize("fn", ["pack_awq", "unpack_awq", "pack_w4_tpu", "unpack_w4_tpu"])
def test_native_equals_numpy_path(fn, monkeypatch):
    assert nat.library() is not None
    q = _ints((1024, 512), 4)  # 2 MB of int32: native by default
    if fn == "pack_awq":
        native = tpack.pack_awq(q)
        _numpy_only(monkeypatch)
        np.testing.assert_array_equal(native, tpack.pack_awq(q))
    elif fn == "unpack_awq":
        words = jpack.pack_awq(q)
        native = tpack.unpack_awq(words)
        _numpy_only(monkeypatch)
        np.testing.assert_array_equal(native, tpack.unpack_awq(words))
    elif fn == "pack_w4_tpu":
        native = tpack.pack_w4_tpu(q).numpy()
        _numpy_only(monkeypatch)
        np.testing.assert_array_equal(native, tpack.pack_w4_tpu(q).numpy())
    else:
        packed = tpack.pack_w4_tpu(q)
        np.testing.assert_array_equal(nat.unpack_w4_tpu_native(packed.numpy()),
                                      tpack.unpack_w4_tpu(packed).numpy())


def test_native_build_failure_falls_back_with_a_warning(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(nat, "_LIB", None)
    monkeypatch.setattr(nat, "_TRIED", False)
    monkeypatch.setattr(nat, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(nat, "CXX", "false")  # a compiler that always fails
    q = _ints((1024, 512), 5)
    with caplog.at_level(logging.WARNING, logger="paroquant_tpu_torch.native"):
        assert nat.library() is None
        got = tpack.pack_awq(q)
    assert any(r.levelno == logging.WARNING for r in caplog.records)
    assert nat.pack_awq_native(q) is None and nat.native_lookup_draft(q[0], 3, 4) is None
    np.testing.assert_array_equal(got, jpack.pack_awq(q))


def _context(L, seed):
    """Random tokens with planted repeats of 1-3 grams."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 50, size=L).tolist()
    for _ in range(max(1, L // 64)):
        n = int(rng.integers(1, 4))
        if L > 2 * n + 1:
            i, j = sorted(rng.choice(L - n, size=2, replace=False).tolist())
            ctx[j : j + n] = ctx[i : i + n]
    return ctx


@pytest.mark.parametrize("L", [2, 3, 17, 300, 511, 512, 513, 1024, 2048])
def test_lookup_draft_matches_jax(L):
    for seed in range(4):
        ctx = _context(L, seed)
        ctx[-2:] = ctx[L // 3 : L // 3 + 2] if L > 8 else ctx[-2:]  # a suffix that recurs
        for k in (1, 4):
            assert tgen._lookup_draft(ctx, k) == j_lookup_draft(ctx, k), (L, seed, k)


def test_lookup_draft_native_equals_numpy_scan(monkeypatch):
    ctxs = [_context(L, 7 + L) for L in (513, 900, 2048, 4096)]
    native = [tgen._lookup_draft(c, 4) for c in ctxs]
    monkeypatch.setattr(nat, "library", lambda: None)
    assert native == [tgen._lookup_draft(c, 4) for c in ctxs]


def _write_awq(path):
    params = jd.init_params(JCFG, jax.random.PRNGKey(1), dtype=jnp.float32)
    jck.save_awq_checkpoint(path, params, JCFG, rtn_export_model(params, JCFG, hadamard=True))


def test_load_awq_checkpoint_matches_jax(tmp_path):
    _write_awq(tmp_path)
    assert "format" not in json.loads((tmp_path / "config.json").read_text())["quantization_config"]
    jp, jcfg = jck.load_checkpoint(tmp_path, dtype=jnp.float32)
    tp, tcfg = load_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    assert tcfg == td.ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    for li in range(jcfg.num_hidden_layers):
        for name in ("q_proj", "o_proj"):
            np.testing.assert_array_equal(tp["layers"][li][name].qweight.numpy(),
                                          np.asarray(jp["layers"][li][name].qweight))
        np.testing.assert_array_equal(tp["layers"][li]["mlp"]["down_proj"].qweight.numpy(),
                                      np.asarray(jp["layers"][li]["mlp"]["down_proj"].qweight))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl, _ = jd.model_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = td.model_forward(tp, tcfg, torch.from_numpy(toks))
    # f32 on both sides: summation order only
    err = np.max(np.abs(tl.numpy() - np.asarray(jl))) / np.max(np.abs(np.asarray(jl)))
    assert err < 1e-5, err
    jt = np.asarray(jd.greedy_generate(jp, jcfg, toks, 10, cache_dtype=jnp.float32))
    tt = td.greedy_generate(tp, tcfg, toks, 10, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tt, jt)


def test_load_awq_checkpoint_bf16_default(tmp_path):
    _write_awq(tmp_path)
    jp, jcfg = jck.load_checkpoint(tmp_path)
    tp, tcfg = load_checkpoint(tmp_path, device="cpu")
    assert tp["embed_tokens"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(1, 8)).astype(np.int32)
    jl, _ = jd.model_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = td.model_forward(tp, tcfg, torch.from_numpy(toks))
    jl = np.asarray(jl, np.float32)
    err = np.max(np.abs(tl.float().numpy() - jl)) / np.max(np.abs(jl))
    assert err < 3e-2, err  # bf16 activations, the parity bound of the bf16 loads


def _sample(dtype, shape, rng):
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, size=shape).astype(bool))
    if dtype.is_floating_point:
        return torch.from_numpy(rng.normal(size=shape).astype(np.float64)).to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(max(info.min, -(1 << 40)), min(info.max, 1 << 40),
                                         size=shape, endpoint=True)).to(dtype)


@pytest.mark.parametrize("name", sorted(_DTYPES))
def test_write_safetensors_read_by_the_library(name, tmp_path):
    rng = np.random.default_rng(len(name))
    dt = _DTYPES[name]
    tensors = {"b.matrix": _sample(dt, (5, 7), rng), "a.vector": _sample(dt, (13,), rng),
               "c.scalar": _sample(dt, (), rng), "d.empty": _sample(dt, (0, 3), rng),
               "model.layers.0.cube": _sample(dt, (2, 3, 4), rng)}
    path = tmp_path / "x.safetensors"
    write_safetensors(path, tensors)
    got = load_file(str(path))
    mine = read_safetensors(path)
    assert sorted(got) == sorted(mine) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and tuple(got[k].shape) == tuple(v.shape), k
        assert torch.equal(got[k], v) and torch.equal(mine[k], v), k


def test_write_safetensors_awq_directory_loads_in_jax(tmp_path):
    """A checkpoint directory copied tensor for tensor through the port's
    writer loads in JAX to the same model as the original."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    _write_awq(src)
    dst.mkdir()
    write_safetensors(dst / "model.safetensors", read_safetensors(src / "model.safetensors"))
    (dst / "config.json").write_text((src / "config.json").read_text())
    a, cfg = jck.load_checkpoint(src, dtype=jnp.float32)
    b, _ = jck.load_checkpoint(dst, dtype=jnp.float32)
    toks = jnp.asarray(np.arange(9, dtype=np.int32)[None])
    np.testing.assert_array_equal(np.asarray(jd.model_forward(a, cfg, toks)[0]),
                                  np.asarray(jd.model_forward(b, cfg, toks)[0]))
