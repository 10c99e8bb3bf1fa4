"""The port's W4 matmul variants (K6 w4_matmul, K7 butterfly_w4_matmul, K8
rot_w4_matmul_mg, K9 rot_w4_matmul_i4), their tables and weight layouts,
against the JAX package. The port's wrappers run their plain PyTorch versions here
(CPU tensors); the JAX kernels run in Pallas interpret mode, as
tests/test_kernels.py runs them.

Tolerances, relative to max |y| of the JAX output:
  1e-5    where only the order of f32 sums differs (K6, K9);
  2e-3    where a bf16 rounding of an intermediate can flip (K7's and K8's xr;
          K8's weight rounds q - z to bf16 before the product, and a port
          that rounds once misses this bound on fractional zeros);
  2**-7   (one bf16 ulp at max |y|) for bf16 outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu.ops import butterfly as jbf, packing as jpk, rotation as jrot
from paroquant_tpu_torch.convert.interop import w4_i4_from_jax
from paroquant_tpu_torch.kernels import rot_matmul as tk
from paroquant_tpu_torch.ops import butterfly as tbf, packing as tpk, rotation as trot

GS = 128
BF16_ULP = 2.0**-7


def _close(y_port, y_jax, rel):
    y_port = y_port.to(torch.float32).numpy()
    y_jax = np.asarray(jnp.asarray(y_jax, jnp.float32))
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y_port, y_jax, rtol=0, atol=rel * scale)


def _quant(I, O, G, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, size=(I, O), dtype=np.int32)
    scales = rng.uniform(0.01, 0.05, size=(G, O)).astype(np.float32)
    zeros = rng.integers(0, 16, size=(G, O)).astype(np.float32)
    return q, scales, zeros


SZ = {"f32/f32": (np.float32, np.float32), "bf16/bf16": ("bf16", "bf16"),
      "bf16/u8": ("bf16", np.uint8)}


def _sz(scales, zeros, kind):
    """(jax scales, jax zeros, torch scales, torch zeros) in the dtypes `kind` names."""
    out_j, out_t = [], []
    for a, dt in zip((scales, zeros), SZ[kind]):
        if dt == "bf16":
            out_j.append(jnp.asarray(a, jnp.bfloat16))
            out_t.append(torch.from_numpy(a).to(torch.bfloat16))
        else:
            out_j.append(jnp.asarray(a.astype(dt)))
            out_t.append(torch.from_numpy(a.astype(dt)))
    return out_j[0], out_j[1], out_t[0], out_t[1]


def _x(M, I, seed, dtype):
    x = np.random.default_rng(seed).normal(size=(M, I)).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("sz", list(SZ))
@pytest.mark.parametrize("M", [1, 5, 48])
def test_w4_matmul_plain_matches_pallas(M, sz, xdt):
    I, O = 256, 384
    q, scales, zeros = _quant(I, O, I // GS, 0)
    sj, zj, st, zt = _sz(scales, zeros, sz)
    xj, xt = _x(M, I, 1, xdt)
    yj = jk.w4_matmul(xj, jnp.asarray(jpk.pack_w4_tpu(q, GS)), sj, zj, interpret=True)
    yt = tk.w4_matmul(xt, tpk.pack_w4_tpu(q, GS), st, zt)
    assert yt.dtype == xt.dtype and yt.shape == (M, O)
    _close(yt, yj, 1e-5 if xdt == "f32" else BF16_ULP)


# ---------------------------------------------------------------------------
# K7 and its tables
# ---------------------------------------------------------------------------


def _butterfly_case(I, K, seed):
    params = jbf.make_butterfly_params(I, GS, K)
    rng = np.random.default_rng(seed)
    theta = np.where(np.asarray(params.mask), 0,
                     rng.normal(0, 0.3, np.asarray(params.theta).shape)).astype(np.float32)
    inv_s = rng.uniform(0.5, 2.0, I).astype(np.float32)
    return params, theta, inv_s


@pytest.mark.parametrize("K", [1, 4, 8])
def test_butterfly_tables_and_pairs_match_jax(K):
    params, theta, _ = _butterfly_case(256, K, 2)
    for a, b in zip(tbf.butterfly_tables(theta, GS), jbf.butterfly_tables(theta, GS)):
        np.testing.assert_array_equal(a, b)
    assert tbf.is_butterfly_pairs(np.asarray(params.pairs), GS)
    assert jbf.is_butterfly_pairs(np.asarray(params.pairs), GS)
    random_pairs = jrot.make_rotation_params(256, GS, K, seed=3).pairs
    assert tbf.is_butterfly_pairs(np.asarray(random_pairs), GS) == jbf.is_butterfly_pairs(
        np.asarray(random_pairs), GS)


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("M", [1, 33])
def test_butterfly_w4_matmul_plain_matches_pallas(M, K):
    I, O = 256, 256
    params, theta, inv_s = _butterfly_case(I, K, 3)
    q, scales, zeros = _quant(I, O, I // GS, 4)
    cos_t, sin_t = tbf.butterfly_tables(theta, GS)
    xj, xt = _x(M, I, 5, "f32")
    yj = jk.butterfly_w4_matmul(xj, jnp.asarray(inv_s), jnp.asarray(cos_t), jnp.asarray(sin_t),
                                jnp.asarray(jpk.pack_w4_tpu(q, GS)), jnp.asarray(scales),
                                jnp.asarray(zeros), interpret=True)
    yt = tk.butterfly_w4_matmul(xt, torch.from_numpy(inv_s), torch.from_numpy(cos_t),
                                torch.from_numpy(sin_t), tpk.pack_w4_tpu(q, GS),
                                torch.from_numpy(scales), torch.from_numpy(zeros))
    _close(yt, yj, 2e-3)

    # and against the generic stage application + dequant, as the JAX test does
    form = trot.to_permutation_form(np.asarray(params.pairs), GS)
    xr = trot.apply_rotation_stages(xt * torch.from_numpy(inv_s), torch.from_numpy(theta), form)
    xr = xr.to(torch.bfloat16).to(torch.float32).numpy()
    wd = ((q.reshape(-1, GS, O) - zeros[:, None]) * scales[:, None]).reshape(I, O)
    np.testing.assert_allclose(yt.numpy(), xr @ wd, rtol=5e-3, atol=2e-2)


def test_butterfly_w4_matmul_refuses_other_group_sizes():
    x = torch.zeros(1, 192)
    with pytest.raises(ValueError, match="power-of-two"):
        tk.butterfly_w4_matmul(x, torch.ones(192), torch.ones(1, 192), torch.zeros(1, 192),
                               torch.zeros(96, 8, dtype=torch.uint8), torch.ones(2, 8),
                               torch.zeros(2, 8), group_size=96)


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,gps", [(2, 16), (20, 16)])
@pytest.mark.parametrize("M", [1, 17])
def test_rot_w4_matmul_mg_plain_matches_pallas(M, G, gps):
    I, O = G * GS, 128
    rng = np.random.default_rng(6)
    q, scales, zeros = _quant(I, O, G, 7)
    rot = (rng.normal(size=(G, GS, GS)) / GS**0.5).astype(np.float32)
    xj, xt = _x(M, I, 8, "bf16")
    yj = jk.rot_w4_matmul_mg(xj, jnp.asarray(rot, jnp.bfloat16), jnp.asarray(jpk.pack_w4_tpu(q, GS)),
                             jnp.asarray(scales, jnp.bfloat16), jnp.asarray(zeros, jnp.bfloat16),
                             groups_per_step=gps, interpret=True)
    yt = tk.rot_w4_matmul_mg(xt, torch.from_numpy(rot).to(torch.bfloat16), tpk.pack_w4_tpu(q, GS),
                             torch.from_numpy(scales).to(torch.bfloat16),
                             torch.from_numpy(zeros).to(torch.bfloat16), groups_per_step=gps)
    assert yt.dtype == torch.bfloat16
    _close(yt, yj, 2e-3 + BF16_ULP)


@pytest.mark.parametrize("seed", range(20))
def test_rot_w4_matmul_mg_plain_on_fractional_zeros(seed):
    """JAX's kernel forms (q - z) * s on bf16 operands, so q - z is rounded to
    bf16 before the product; with integer zeros q - z is exact and a single
    rounding of (q - z) * s gives the same weight, with fractional ones it
    does not. Zeros ~ U(0, 15) rounded to bf16, scales ~ U(0.01, 0.05),
    Gaussian x and rotations, f32 operands; G 4 (one chunk) or 20 (chunks of
    16 and 4) and M 1 or 5 by seed."""
    G, M = (4, 20)[seed % 2], (1, 5)[seed // 2 % 2]
    I, O = G * GS, 128
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, I)).astype(np.float32)
    rot = (rng.normal(size=(G, GS, GS)) / GS**0.5).astype(np.float32)
    qw = np.asarray(jpk.pack_w4_tpu(rng.integers(0, 16, (I, O), dtype=np.int32), GS))
    scales = rng.uniform(0.01, 0.05, (G, O)).astype(np.float32)
    zeros = np.asarray(jnp.asarray(rng.uniform(0, 15, (G, O)).astype(np.float32), jnp.bfloat16),
                       np.float32)
    ops = (x, rot, qw, scales, zeros)
    yj = jk.rot_w4_matmul_mg(*(jnp.asarray(a) for a in ops), interpret=True)
    yt = tk.rot_w4_matmul_mg(*(torch.from_numpy(a) for a in ops))
    assert yt.dtype == torch.float32
    _close(yt, yj, 2e-3)


def test_rot_w4_matmul_mg_rounds_f32_operands_to_bf16():
    """JAX casts x, rot, scales and zeros to bf16 even where they are f32."""
    G, I, O = 2, 256, 128
    rng = np.random.default_rng(9)
    q, scales, zeros = _quant(I, O, G, 10)
    rot = (rng.normal(size=(G, GS, GS)) / GS**0.5).astype(np.float32)
    xj, xt = _x(3, I, 11, "f32")
    yj = jk.rot_w4_matmul_mg(xj, jnp.asarray(rot), jnp.asarray(jpk.pack_w4_tpu(q, GS)),
                             jnp.asarray(scales), jnp.asarray(zeros), interpret=True)
    yt = tk.rot_w4_matmul_mg(xt, torch.from_numpy(rot), tpk.pack_w4_tpu(q, GS),
                             torch.from_numpy(scales), torch.from_numpy(zeros))
    _close(yt, yj, 2e-3)


# ---------------------------------------------------------------------------
# K9 and its weight layout
# ---------------------------------------------------------------------------


def test_pack_w4_i4_round_trip():
    q = np.random.default_rng(12).integers(0, 16, size=(384, 96)).astype(np.int32)
    packed = tpk.pack_w4_i4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (192, 96)
    np.testing.assert_array_equal(packed.numpy() & 0xF, q[0::2])
    np.testing.assert_array_equal(packed.numpy() >> 4, q[1::2])
    np.testing.assert_array_equal(tpk.unpack_w4_i4(packed).numpy(), q)
    # from JAX's native uint4 array, as numpy
    np.testing.assert_array_equal(
        w4_i4_from_jax(np.asarray(jnp.asarray(q, jnp.uint4)), device="cpu").numpy(), packed.numpy())


@pytest.mark.parametrize("M", [1, 17])
def test_rot_w4_matmul_i4_plain_matches_pallas(M):
    G, I, O = 2, 256, 256
    rng = np.random.default_rng(13)
    q, scales, zeros = _quant(I, O, G, 14)
    rot = (rng.normal(size=(G, GS, GS)) / GS**0.5).astype(np.float32)
    q4 = jnp.asarray(q, jnp.uint4)
    xj, xt = _x(M, I, 15, "f32")
    yj = jk.rot_w4_matmul_i4(xj, jnp.asarray(rot), q4, jnp.asarray(scales), jnp.asarray(zeros),
                             interpret=True)
    yt = tk.rot_w4_matmul_i4(xt, torch.from_numpy(rot), w4_i4_from_jax(np.asarray(q4), device="cpu"),
                             torch.from_numpy(scales), torch.from_numpy(zeros))
    _close(yt, yj, 1e-5)
    # K9 is K1 on another layout
    yk1 = tk.rot_w4_matmul(xt, torch.from_numpy(rot), tpk.pack_w4_tpu(q, GS),
                           torch.from_numpy(scales), torch.from_numpy(zeros))
    np.testing.assert_array_equal(yt.numpy(), yk1.numpy())
