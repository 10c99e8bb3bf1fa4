"""The port's math core against the JAX package: packing, quantizer, pairs,
rotations and make_quantized_linear, on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert import rtn as jrtn
from paroquant_tpu.models.decoder import DenseLinear as JDense
from paroquant_tpu.ops import butterfly as jbf, packing as jpk, quant as jq, rotation as jrot
from paroquant_tpu.ops.qlinear import make_quantized_linear as j_make
from paroquant_tpu_torch.convert import rtn as trtn
from paroquant_tpu_torch.convert.interop import to_torch
from paroquant_tpu_torch.models.decoder import DenseLinear as TDense
from paroquant_tpu_torch.ops import butterfly as tbf, packing as tpk, quant as tq, rotation as trot
from paroquant_tpu_torch.ops.qlinear import make_quantized_linear as t_make

GS = 128


def _np(t):
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("n_bits", [4, 8])
def test_pack_unpack_bit_exact(n_bits):
    rng = np.random.default_rng(0)
    q = rng.integers(0, 2**n_bits, size=(384, 96)).astype(np.int32)
    packed_j = np.asarray(jpk.pack_wq_tpu(q, n_bits, GS))
    packed_t = tpk.pack_wq_tpu(q, n_bits, GS)
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    un_j = np.asarray(jpk.unpack_wq_tpu(jnp.asarray(packed_j), 384, GS))
    un_t = tpk.unpack_wq_tpu(packed_t, 384, GS).numpy()
    np.testing.assert_array_equal(un_t, un_j)
    np.testing.assert_array_equal(un_t, q)


@pytest.mark.parametrize("n_bits", [4, 8])
def test_quantizer_bit_exact(n_bits):
    w = np.random.default_rng(1).normal(size=(96, 256)).astype(np.float32)
    pj = jq.calc_scales_and_zero_points(jnp.asarray(w), GS, n_bits)
    pt = tq.calc_scales_and_zero_points(torch.from_numpy(w), GS, n_bits)
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pj.scale))
    np.testing.assert_array_equal(pt.zero_point_float.numpy(), np.asarray(pj.zero_point_float))
    for a, b in zip(tq.quantize_to_int(torch.from_numpy(w), pt, n_bits, GS),
                    jq.quantize_to_int(jnp.asarray(w), pj, n_bits, GS)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    qj, sj, zj = jq.quantize_to_int(jnp.asarray(w), pj, n_bits, GS)
    dj = jq.dequantize_int(qj, sj, zj, GS)
    dt = tq.dequantize_int(*tq.quantize_to_int(torch.from_numpy(w), pt, n_bits, GS), GS)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("seed", [0, 7])
def test_random_pairs_same_from_seed(seed):
    pj = jrot.make_rotation_params(256, GS, 4, seed)
    pt = trot.make_rotation_params(256, GS, 4, seed)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(trot.pairs_to_permutation(pt.pairs, GS),
                    jrot.pairs_to_permutation(np.asarray(pj.pairs), GS)):
        np.testing.assert_array_equal(a, b)


def test_butterfly_params_same():
    assert tbf.butterfly_distances(9, GS) == jbf.butterfly_distances(9, GS)
    pj = jbf.make_butterfly_params(256, GS, 7)
    pt = tbf.make_butterfly_params(256, GS, 7)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _theta(params, seed):
    rng = np.random.default_rng(seed)
    th = rng.normal(0, 0.3, np.asarray(params.theta).shape)
    return np.where(np.asarray(params.mask), 0, th).astype(np.float32)


def test_build_rotation_matrices_match():
    params = jrot.make_rotation_params(256, GS, 6, seed=3)
    theta = _theta(params, 4)
    rj = jrot.build_rotation_matrices(jnp.asarray(theta), jrot.to_permutation_form(params, GS), GS)
    form = trot.to_permutation_form(np.asarray(params.pairs), GS)
    rt = trot.build_rotation_matrices(torch.from_numpy(theta), form, GS)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_rotation_stages_match(inverse):
    params = jrot.make_rotation_params(256, GS, 6, seed=5)
    theta = _theta(params, 6)
    x = np.random.default_rng(7).normal(size=(5, 256)).astype(np.float32)
    yj = jrot.apply_rotation_stages(jnp.asarray(x), jnp.asarray(theta),
                                    jrot.to_permutation_form(params, GS), inverse=inverse)
    yt = trot.apply_rotation_stages(torch.from_numpy(x), torch.from_numpy(theta),
                                    trot.to_permutation_form(np.asarray(params.pairs), GS),
                                    inverse=inverse)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("theta_kind", ["random", "zero"])
def test_make_quantized_linear_same(theta_kind):
    """Random theta exercises the composed rotation; theta = 0 the diagonal
    shortcut (qlinear.py:109-113)."""
    O, I = 192, 256
    rng = np.random.default_rng(8)
    params = jrot.make_rotation_params(I, GS, 4, seed=9)
    theta = _theta(params, 10) if theta_kind == "random" else np.zeros_like(np.asarray(params.theta))
    q = rng.integers(0, 16, size=(O, I)).astype(np.int32)
    scales = rng.uniform(0.01, 0.05, size=(O, I // GS)).astype(np.float32)
    zeros = rng.integers(0, 16, size=(O, I // GS)).astype(np.float32)
    inv_s = rng.uniform(0.5, 2.0, I).astype(np.float32)
    lj = j_make(q, scales, zeros, np.asarray(params.pairs), theta, inv_s, GS)
    lt = t_make(q, scales, zeros, np.asarray(params.pairs), theta, inv_s, GS)
    np.testing.assert_array_equal(lt.qweight.numpy(), np.asarray(lj.qweight))
    np.testing.assert_array_equal(_np(lt.scales), np.asarray(lj.scales, np.float32))
    np.testing.assert_array_equal(_np(lt.zeros), np.asarray(lj.zeros, np.float32))
    # bf16 rot: f32 composition agrees to ~1e-7, so at most one bf16 ulp apart
    rj = np.asarray(lj.rot, np.float32)
    np.testing.assert_allclose(_np(lt.rot), rj, rtol=2**-7, atol=1e-6)
    assert np.mean(_np(lt.rot) == rj) > 0.999


@pytest.mark.parametrize("kind", ["identity", "random", "hadamard"])
def test_quantize_linear_rtn_same(kind):
    w = np.random.default_rng(11).normal(size=(256, 160)).astype(np.float32) / 16
    kw = dict(random_rotation=kind == "random", hadamard=kind == "hadamard", seed=3,
              num_rotations=4)
    lj = jrtn.quantize_linear_rtn(JDense(jnp.asarray(w), None), **kw)
    lt = trtn.quantize_linear_rtn(TDense(torch.from_numpy(w), None), **kw)
    # the rotated weight may differ in its last bit (cos/sin of two libms),
    # which can move a value across a rounding boundary: a tiny share only
    assert np.mean(lt.qweight.numpy() == np.asarray(lj.qweight)) > 0.999
    np.testing.assert_allclose(_np(lt.scales), np.asarray(lj.scales, np.float32), rtol=1e-2)
    np.testing.assert_allclose(_np(lt.rot), np.asarray(lj.rot, np.float32), rtol=2**-7, atol=1e-6)


def test_to_torch_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(jnp.bfloat16))
    t = to_torch(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.to(torch.float32).numpy(), a.astype(np.float32))
