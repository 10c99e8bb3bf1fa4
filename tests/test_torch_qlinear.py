"""The port's rotated W4 matmuls (K1, K2) and quantized-linear forwards
against the JAX package. The port's kernels run their plain PyTorch versions
here (CPU tensors); the JAX kernels run in Pallas interpret mode, as
tests/test_kernels.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu.ops import qlinear as jql, rotation as jrot
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.kernels import rot_matmul as tk
from paroquant_tpu_torch.models.config import PRESETS
from paroquant_tpu_torch.ops import qlinear as tql

GS = 128
I = 256  # two groups


def _jax_layer(O, seed, K=4):
    rng = np.random.default_rng(seed)
    params = jrot.make_rotation_params(I, GS, K, seed=seed + 1)
    theta = np.where(
        np.asarray(params.mask), 0, rng.normal(0, 0.3, np.asarray(params.theta).shape)
    ).astype(np.float32)
    q = rng.integers(0, 16, size=(O, I)).astype(np.int32)
    scales = rng.uniform(0.01, 0.05, size=(O, I // GS)).astype(np.float32)
    zeros = rng.integers(0, 16, size=(O, I // GS)).astype(np.float32)
    inv_s = rng.uniform(0.5, 2.0, I).astype(np.float32)
    return jql.make_quantized_linear(q, scales, zeros, np.asarray(params.pairs), theta, inv_s, GS)


def _port(layer):
    """The same layer in the port (numpy leaves through params_from_jax)."""
    tree = jax.tree.map(np.asarray, {"l": layer})
    return params_from_jax(tree, PRESETS["tiny"], device="cpu")["l"]


def _x(M, seed):
    return np.random.default_rng(seed).normal(size=(M, I)).astype(np.float32)


def _check(y_port, y_ref, a8):
    y_port, y_ref = np.asarray(y_port, np.float32), np.asarray(y_ref, np.float32)
    if a8:
        assert np.linalg.norm(y_port - y_ref) / np.linalg.norm(y_ref) < 1e-2
    else:
        np.testing.assert_allclose(y_port, y_ref, rtol=5e-3, atol=2e-2)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("M", [1, 17])
def test_rot_w4_matmul_plain_matches_pallas(M, a8):
    lj = _jax_layer(160, seed=20)
    lt = _port(lj)
    x = _x(M, 21)
    yj = jk.rot_w4_matmul(jnp.asarray(x), lj.rot, lj.qweight, lj.scales, lj.zeros,
                          interpret=True, a8=a8)
    yt = tk.rot_w4_matmul(torch.from_numpy(x), lt.rot, lt.qweight, lt.scales, lt.zeros, a8=a8)
    _check(yt.numpy(), yj, a8)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("splits", [(128, 64), (128, 96, 160)])
@pytest.mark.parametrize("M", [1, 17])
def test_merged_rot_w4_matmul_plain_matches_pallas(M, splits, a8):
    mj = jql.merge_quantized_linears([_jax_layer(n, seed=30 + i) for i, n in enumerate(splits)])
    mt = _port(mj)
    x = _x(M, 31)
    yj = jk.merged_rot_w4_matmul(jnp.asarray(x), mj.rot, mj.qweight, mj.scales, mj.zeros,
                                 out_splits=mj.out_splits, interpret=True, a8=a8)
    yt = tk.merged_rot_w4_matmul(torch.from_numpy(x), mt.rot, mt.qweight, mt.scales, mt.zeros,
                                 out_splits=mt.out_splits, a8=a8)
    _check(yt.numpy(), yj, a8)


@pytest.mark.parametrize("mode", ["xla", "w4a8", "fused", "auto"])
@pytest.mark.parametrize("M", [1, 17])
def test_quantized_linear_forward_modes(M, mode):
    lj = _jax_layer(160, seed=40)
    lt = _port(lj)
    x = _x(M, 41)
    yj = jql.quantized_linear_forward(lj, jnp.asarray(x), mode=mode)
    yt = tql.quantized_linear_forward(lt, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=5e-3, atol=6e-2)


@pytest.mark.parametrize("mode", ["xla", "w4a8", "fused", "auto"])
@pytest.mark.parametrize("M", [1, 17])
def test_merged_linear_forward_modes(M, mode):
    mj = jql.merge_quantized_linears([_jax_layer(n, seed=50 + i) for i, n in enumerate((128, 96, 160))])
    mt = _port(mj)
    x = _x(M, 51)
    yj = jql.merged_linear_forward(mj, jnp.asarray(x), mode=mode)
    yt = tql.merged_linear_forward(mt, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=5e-3, atol=6e-2)


@pytest.mark.parametrize("a8", [False, True])
def test_xla_forward_matches_jax_tightly(a8):
    """The plain forward (the reference the kernels are held to) agrees with
    JAX's _forward_xla to f32 rounding."""
    lj = _jax_layer(160, seed=60)
    lt = _port(lj)
    x = _x(17, 61)
    yj = jql._forward_xla(lj, jnp.asarray(x), a8=a8)
    yt = tql._forward_xla(lt, torch.from_numpy(x), a8=a8)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)


def test_auto_resolution_matches_jax_on_cpu():
    """auto resolves from shapes alone, to xla on the CPU as in JAX, and a big
    matrix at small M to the a8 numerics."""
    big = type("L", (), {"scales": torch.zeros(8, 1 << 20), "group_size": 128})()
    x1 = torch.zeros(1, 1024)
    assert tql._resolve_auto("auto", x1, big) == "w4a8_xla"
    assert tql._resolve_auto("auto", torch.zeros(17, 1024), big) == "xla"
    small = type("L", (), {"scales": torch.zeros(8, 1024), "group_size": 128})()
    assert tql._resolve_auto("auto", x1, small) == "xla"


@pytest.mark.parametrize("S,G", [(64, 1), (64, 4), (128, 1), (128, 4), (256, 4), (640, 2)])
def test_auto_resolution_matches_jax_off_cpu(S, G, monkeypatch):
    """Off the CPU (a meta tensor stands in for the card's) every mode
    resolves as JAX's does on an accelerator, group size and M included."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for N in (1024, 1 << 17):
        jl = type("L", (), {"scales": np.broadcast_to(np.float32(0), (G, N)), "group_size": S})()
        tl = type("L", (), {"scales": torch.empty(G, N, device="meta"), "group_size": S})()
        for M in (1, 16, 17, 128, 129):
            for mode in ("auto", "w4a8", "fused", "xla"):
                want = jql._resolve_auto(mode, jnp.zeros((M, G * S)), jl)
                assert tql._resolve_auto(mode, torch.empty(M, G * S, device="meta"), tl) == want


class _Launched(Exception):
    pass


def _no_launch(monkeypatch):
    """Stand-in for the compiled library: reaching it means the wrapper took
    the layout (meta tensors stand in for the card's)."""
    def reached(entry):
        raise _Launched(entry)
    monkeypatch.setattr(tk, "_lib_fn", reached)


def _meta_operands(S, G, O=128):
    x = torch.empty(1, G * S, device="meta")
    rot = torch.empty(G, S, S, dtype=torch.bfloat16, device="meta")
    qw = torch.empty(G * S // 2, O, dtype=torch.uint8, device="meta")
    sz = torch.empty(G, O, dtype=torch.bfloat16, device="meta")
    return x, rot, qw, sz


@pytest.mark.parametrize("S,G", [(64, 1), (640, 1)])
def test_kernel_wrapper_raises_for_group_sizes_it_lacks(S, G, monkeypatch):
    """Off the CPU the wrappers launch the CUDA kernel or raise; they never
    fall back to the plain version. The kernel now lacks no layout that
    `auto` sends to fused (one group spanning the row, any multiple of 128):
    the wrapper goes on to its launch."""
    _no_launch(monkeypatch)
    x, rot, qw, sz = _meta_operands(S, G)
    with pytest.raises(_Launched):
        tk.rot_w4_matmul(x, rot, qw, sz, sz)
    with pytest.raises(_Launched):
        tk.merged_rot_w4_matmul(x, rot[None], qw, sz, sz, out_splits=(128,))


@pytest.mark.parametrize("S,G", [(96, 1), (320, 1), (1024, 1), (1024, 2), (2048, 2), (64, 4)])
def test_kernel_wrappers_take_every_group_layout(S, G, monkeypatch):
    """K1, K2, K6 and K9 take any even group size dividing I on the card, and
    f32, bf16, f16 and uint8 scales and zeros."""
    _no_launch(monkeypatch)
    x, rot, qw, sz = _meta_operands(S, G)
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.uint8):
        s = sz.to(dt)
        for call in (lambda: tk.rot_w4_matmul(x, rot, qw, s, s, a8=True),
                     lambda: tk.merged_rot_w4_matmul(x, rot[None], qw, s, s, out_splits=(64, 64)),
                     lambda: tk.w4_matmul(x, qw, s, s, group_size=S),
                     lambda: tk.rot_w4_matmul_i4(x, rot, qw, s, s)):
            with pytest.raises(_Launched):
                call()


def test_kernel_wrappers_refuse_what_jax_rejects(monkeypatch):
    """Shapes that do not tile, odd groups and other dtypes raise before a launch."""
    _no_launch(monkeypatch)
    x, rot, qw, sz = _meta_operands(64, 2)
    with pytest.raises(ValueError):  # rot does not cover x
        tk.rot_w4_matmul(x[:, :96], rot, qw[:48], sz, sz)
    with pytest.raises(ValueError):  # an odd group
        tk.w4_matmul(torch.empty(1, 99, device="meta"), qw[:49], sz[:1], sz[:1], group_size=99)
    with pytest.raises(TypeError):
        tk.rot_w4_matmul(x, rot, qw, sz.to(torch.int32), sz)
    with pytest.raises(TypeError):
        tk.w4_matmul(x.to(torch.float16), qw, sz, sz, group_size=64)
    with pytest.raises(ValueError):  # K7's stages need a power-of-two group
        tk.butterfly_w4_matmul(torch.empty(1, 192, device="meta"), None, None, None, qw, sz, sz,
                               group_size=96)
