"""K1/K2 (rot_w4_matmul, merged_rot_w4_matmul) and the quantized-linear
forwards at every group layout the JAX package runs fused beyond 128-512
(S = 1024 with one and two groups, one 96-channel group spanning the row),
with f32 and uint8 scales/zeros, against the JAX package: the port's plain
versions on the CPU, JAX's kernels in Pallas interpret mode.

Tolerances: the forwards as tests/test_torch_qlinear.py states them (rtol
5e-3, atol 6e-2); K1/K2 W4A16 `rot_tolerance` (tests/test_torch_rot_w4_flips.py:
1e-5 x max |y| for the order of f32 sums, plus one bf16 ulp of each rotated
activation that the two sides may round apart, times its coefficient in the
output); a8 a relative Frobenius error below 1e-2 (an int8 rounding of a
near-tie activation may flip).
"""

import functools

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
from test_torch_rot_w4_flips import rot_tolerance

# ---------------------------------------------------------------------------
# K1/K2 at every layout `auto` sends to fused, with every scale/zero dtype
# ---------------------------------------------------------------------------

LAYOUTS = {"S1024_G1": (1024, 1), "S1024_G2": (1024, 2), "S96_row": (96, 1)}


def _jax_layer(I, S, O, seed, K=4):
    rng = np.random.default_rng(seed)
    params = jrot.make_rotation_params(I, S, K, seed=seed + 1)
    theta = np.where(np.asarray(params.mask), 0,
                     rng.normal(0, 0.3, np.asarray(params.theta).shape)).astype(np.float32)
    q = rng.integers(0, 16, size=(O, I)).astype(np.int32)
    scales = rng.uniform(0.01, 0.05, size=(O, I // S)).astype(np.float32)
    zeros = rng.integers(0, 16, size=(O, I // S)).astype(np.float32)
    inv_s = rng.uniform(0.5, 2.0, I).astype(np.float32)
    return jql.make_quantized_linear(q, scales, zeros, np.asarray(params.pairs), theta, inv_s, S)


def _port(layer):
    tree = jax.tree.map(np.asarray, {"l": layer})
    return params_from_jax(tree, PRESETS["tiny"], device="cpu")["l"]


def _layout(name):
    S, G = LAYOUTS[name]
    return S, G, S * G


@functools.lru_cache(maxsize=None)
def _layers(layout, merged, seed):
    """(JAX layer, the port's copy) at `layout`: one of 160 columns, or a
    merged one of 128 + 96."""
    S, G, I = _layout(layout)
    if merged:
        lj = jql.merge_quantized_linears([_jax_layer(I, S, n, seed=seed + i)
                                          for i, n in enumerate((128, 96))])
    else:
        lj = _jax_layer(I, S, 160, seed=seed)
    return lj, _port(lj)


@pytest.mark.parametrize("mode", ["xla", "w4a8", "fused", "auto"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_quantized_linear_forward_wide_and_narrow_groups(layout, mode):
    S, G, I = _layout(layout)
    lj, lt = _layers(layout, False, 70)
    x = np.random.default_rng(71).normal(size=(3, I)).astype(np.float32)
    yj = jql.quantized_linear_forward(lj, jnp.asarray(x), mode=mode)
    yt = tql.quantized_linear_forward(lt, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=5e-3, atol=6e-2)


@pytest.mark.parametrize("mode", ["xla", "w4a8", "fused", "auto"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_merged_linear_forward_wide_and_narrow_groups(layout, mode):
    S, G, I = _layout(layout)
    mj, mt = _layers(layout, True, 80)
    x = np.random.default_rng(81).normal(size=(3, I)).astype(np.float32)
    yj = jql.merged_linear_forward(mj, jnp.asarray(x), mode=mode)
    yt = tql.merged_linear_forward(mt, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=5e-3, atol=6e-2)


def _check_k12(yt, yj, a8, operands, out_splits=None):
    """operands: the port's (x, rot, qweight, scales, zeros)."""
    yt, yj = yt.numpy(), np.asarray(yj)
    if a8:
        assert np.linalg.norm(yt - yj) / np.linalg.norm(yj) < 1e-2
    else:
        tol = rot_tolerance(yj, *operands, out_splits=out_splits)
        assert np.all(np.abs(yt - yj) <= tol), (np.abs(yt - yj) / tol).max()


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("sz", ["f32/f32", "f32/u8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rot_w4_matmul_plain_matches_pallas_layouts_and_dtypes(layout, sz, a8):
    S, G, I = _layout(layout)
    lj, lt = _layers(layout, False, 90)
    s32 = np.asarray(lj.scales, np.float32)
    z32 = np.asarray(lj.zeros, np.float32)
    zdt = np.uint8 if sz == "f32/u8" else np.float32
    x = np.random.default_rng(91).normal(size=(5, I)).astype(np.float32)
    yj = jk.rot_w4_matmul(jnp.asarray(x), lj.rot, lj.qweight, jnp.asarray(s32),
                          jnp.asarray(z32.astype(zdt)), a8=a8, interpret=True)
    ops = (torch.from_numpy(x), lt.rot, lt.qweight, torch.from_numpy(s32),
           torch.from_numpy(z32.astype(zdt)))
    yt = tk.rot_w4_matmul(*ops, a8=a8)
    _check_k12(yt, yj, a8, ops)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_merged_rot_w4_matmul_plain_matches_pallas_layouts(layout, a8):
    S, G, I = _layout(layout)
    mj, mt = _layers(layout, True, 100)
    z8 = np.asarray(mj.zeros, np.float32).astype(np.uint8)
    x = np.random.default_rng(101).normal(size=(5, I)).astype(np.float32)
    yj = jk.merged_rot_w4_matmul(jnp.asarray(x), mj.rot, mj.qweight, mj.scales, jnp.asarray(z8),
                                 out_splits=mj.out_splits, a8=a8, interpret=True)
    ops = (torch.from_numpy(x), mt.rot, mt.qweight, mt.scales, torch.from_numpy(z8))
    yt = tk.merged_rot_w4_matmul(*ops, out_splits=mt.out_splits, a8=a8)
    _check_k12(yt, yj, a8, ops, mt.out_splits)
