"""The port's GPTQ (`paroquant_tpu_torch/convert/gptq.py`) against JAX's on
the CPU.

Tolerances, and why. With an identity Hessian nothing is compensated, so
GPTQ is RTN bit for bit (within the port, as tests/test_gptq.py holds it
within JAX), and JAX's GPTQ bit for bit. On random Hessians the two packages factor the same f32
matrices with different Cholesky routines (LAPACK's potrf against XLA's
blocked decomposition), whose sums run in other orders, so U differs in its
last bits. A weight that sits on a rounding boundary then rounds to the
neighbouring code in one package, and the compensation carries the change
into the later columns. So the codes may differ in at most 0.1% of entries,
by at most 1 where they differ, and the proxy loss ||X (W - W_q)^T|| must be
within 1% of JAX's. At model level the quantized layers feed the next
layer's Hessian, so differences compound: the logits' error against the
dense model must be within 2% of JAX's, and both must beat RTN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert.gptq import gptq_quantize_model as j_gptq_model
from paroquant_tpu.convert.gptq import gptq_quantize_weight as j_gptq_weight
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.convert import (load_checkpoint, quantize_model_rtn,
                                         save_paro_checkpoint)
from paroquant_tpu_torch.convert.gptq import _gptq_linear, gptq_quantize_model, gptq_quantize_weight
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.convert.rtn import _rtn_quantize, quantize_linear_rtn
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops import quant
from paroquant_tpu_torch.ops.qlinear import QuantizedLinear, effective_weight

CFG, JCFG = PRESETS["tiny"], J_PRESETS["tiny"]


def _dequant(q, s, z, gs=128):
    return quant.dequantize_int(torch.as_tensor(np.array(q)), torch.as_tensor(np.array(s)),
                                torch.as_tensor(np.array(z)), gs).numpy()


def _correlated(seed, O=64, I=256, N=512, outliers=False):
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(I, I)) / np.sqrt(I) + 0.5 * np.eye(I)
    x = (rng.normal(size=(N, I)) @ mix).astype(np.float32)
    w = rng.normal(size=(O, I)).astype(np.float32)
    if outliers:
        w[:, rng.integers(0, I, 8)] *= 15.0
    return w, x, (x.T @ x).astype(np.float32)


@pytest.mark.parametrize("dtype", (np.float32, np.float16))
def test_identity_hessian_is_rtn_bit_for_bit(dtype):
    w = np.random.default_rng(0).normal(size=(48, 256)).astype(dtype).astype(np.float32)
    q, s, z = gptq_quantize_weight(torch.from_numpy(w), torch.eye(256), n_bits=4, group_size=128)
    for got, want in zip((q, s, z), _rtn_quantize(torch.from_numpy(w), 4, 128)):
        assert torch.equal(got, want)
    assert q.dtype == z.dtype == torch.int32 and s.dtype == torch.float32
    # and JAX's GPTQ on the same inputs
    for got, want in zip((q, s, z), j_gptq_weight(jnp.asarray(w), jnp.eye(256))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (seed, O, I, N): N > I (full-rank Hessian), N < I (rank-deficient, the
# damping carries it), a wider input
HESSIANS = {"full_rank": (1, 64, 256, 512), "rank_deficient": (3, 48, 256, 96),
            "wide": (5, 32, 512, 1024)}


@pytest.mark.parametrize("case", sorted(HESSIANS))
def test_codes_and_proxy_loss_match_jax(case):
    seed, O, I, N = HESSIANS[case]
    w, x, H = _correlated(seed, O, I, N)
    jq_, js_, jz_ = (np.asarray(a) for a in j_gptq_weight(jnp.asarray(w), jnp.asarray(H)))
    tq_, ts_, tz_ = (a.numpy() for a in gptq_quantize_weight(torch.from_numpy(w),
                                                              torch.from_numpy(H)))
    diff = tq_ != jq_
    assert diff.mean() <= 1e-3, diff.mean()
    assert np.abs(tq_ - jq_).max(initial=0) <= 1
    loss = [np.linalg.norm(x @ (w - _dequant(q, s, z)).T) for q, s, z in
            ((tq_, ts_, tz_), (jq_, js_, jz_))]
    assert abs(loss[0] - loss[1]) <= 0.01 * loss[1], loss


def test_gptq_beats_rtn_on_proxy_loss():
    w, x, H = _correlated(1)
    q, s, z = gptq_quantize_weight(torch.from_numpy(w), torch.from_numpy(H))
    tw = torch.from_numpy(w)
    q2, s2, z2 = quant.quantize_to_int(tw, quant.calc_scales_and_zero_points(tw, 128, 4), 4, 128)
    loss_gptq = np.linalg.norm(x @ (w - _dequant(q, s, z)).T)
    loss_rtn = np.linalg.norm(x @ (w - _dequant(q2, s2, z2)).T)
    assert loss_gptq < loss_rtn * 0.9, (loss_gptq, loss_rtn)


def test_dead_columns_give_finite_codes():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32))
    x = rng.normal(size=(64, 256))
    x[:, 5] = 0.0
    x[:, 200] = 0.0
    q, s, z = gptq_quantize_weight(w, torch.from_numpy((x.T @ x).astype(np.float32)))
    assert torch.isfinite(s).all() and (q >= 0).all() and (q <= 15).all()
    jq_ = np.asarray(j_gptq_weight(jnp.asarray(w.numpy()), jnp.asarray((x.T @ x), jnp.float32))[0])
    assert (q.numpy() != jq_).mean() <= 1e-3


def test_a_ragged_group_is_refused():
    with pytest.raises(ValueError, match="group_size"):
        gptq_quantize_weight(torch.zeros(4, 200), torch.eye(200))


def test_quarot_beats_gptq_and_hadamard_rtn():
    """hadamard=True (the QuaRot recipe): on outlier-heavy weights with
    correlated inputs, Hadamard + GPTQ beats plain GPTQ and Hadamard RTN on
    ||X (W - W_eff)||."""
    w, x, H = _correlated(7, outliers=True)
    lin = td.DenseLinear(torch.from_numpy(w.T.copy()), None)
    Ht = torch.from_numpy(H)

    def proxy(layer):
        return float(np.linalg.norm(x @ (w.T - effective_weight(layer).numpy())))

    kw = dict(n_bits=4, group_size=128, percdamp=0.01, rot_dtype=torch.float32)
    loss_quarot = proxy(_gptq_linear(lin, Ht, hadamard=True, **kw)[0])
    loss_gptq = proxy(_gptq_linear(lin, Ht, **kw)[0])
    loss_hrtn = proxy(quantize_linear_rtn(lin, group_size=128, hadamard=True,
                                          rot_dtype=torch.float32))
    assert loss_quarot < loss_gptq, (loss_quarot, loss_gptq)
    assert loss_quarot < loss_hrtn, (loss_quarot, loss_hrtn)


@pytest.fixture(scope="module")
def tiny():
    jp = jd.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    tokens = np.random.default_rng(3).integers(0, CFG.vocab_size, (8, 64)).astype(np.int32)
    return jp, tp, tokens


def _mse(out, ref):
    return float(np.mean((np.asarray(out) - np.asarray(ref)) ** 2))


@pytest.mark.parametrize("hadamard", (False, True))
def test_model_matches_jax_and_beats_rtn(tiny, hadamard):
    jp, tp, tokens = tiny
    jq_, jexp = j_gptq_model(jp, JCFG, tokens, batch_size=4, rot_dtype=jnp.float32,
                             hadamard=hadamard)
    logs = []
    tq_, texp = gptq_quantize_model(tp, CFG, tokens, batch_size=4, rot_dtype=torch.float32,
                                    hadamard=hadamard, log_fn=logs.append, device="cpu")
    assert logs == [f"gptq layer {i}: quantized {sorted(texp[i])}" for i in range(2)]
    for li, (lp, e, je) in enumerate(zip(tq_["layers"], texp, jexp)):
        assert sorted(e) == sorted(je) and len(e) == 7, li
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            assert isinstance(lp[name], QuantizedLinear)
        assert all(isinstance(lp["mlp"][n], QuantizedLinear) for n in lp["mlp"])
        assert np.any(e["q_proj"]["theta"]) == hadamard
        for k in e:
            np.testing.assert_array_equal(e[k]["pairs"], np.asarray(je[k]["pairs"]))
            np.testing.assert_array_equal(e[k]["theta"], np.asarray(je[k]["theta"]))
    # dense params are left untouched
    assert isinstance(tp["layers"][0]["q_proj"], td.DenseLinear)
    toks = torch.from_numpy(tokens)
    ref = td.model_forward(tp, CFG, toks)[0].numpy()
    err = _mse(td.model_forward(tq_, CFG, toks)[0].numpy(), ref)
    j_err = _mse(jd.model_forward(jq_, JCFG, jnp.asarray(tokens))[0], ref)
    assert abs(err - j_err) <= 0.02 * j_err, (err, j_err)
    rtn = quantize_model_rtn(tp, CFG, rot_dtype=torch.float32, hadamard=hadamard, device="cpu")
    assert err < _mse(td.model_forward(rtn, CFG, toks)[0].numpy(), ref)


def test_checkpoint_round_trip(tiny, tmp_path):
    _, tp, tokens = tiny
    qp, exports = gptq_quantize_model(tp, CFG, tokens[:4, :32], rot_dtype=torch.float32,
                                      device="cpu")
    save_paro_checkpoint(tmp_path / "ckpt", tp, CFG, exports)
    loaded, lcfg = load_checkpoint(tmp_path / "ckpt", rot_dtype=torch.float32,
                                   dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(tokens[:4, :32])
    mem = td.model_forward(qp, CFG, toks)[0]
    # the checkpoint keeps dense tensors in f16 (the reference's format)
    torch.testing.assert_close(td.model_forward(loaded, lcfg, toks)[0], mem, rtol=5e-2,
                               atol=5e-2)
    for li in range(2):
        for name in ("q_proj", "o_proj"):
            a, b = qp["layers"][li][name], loaded["layers"][li][name]
            assert torch.equal(a.qweight, b.qweight) and torch.equal(a.zeros, b.zeros)


def test_remainder_batch_counts(tiny):
    """N mod batch_size samples contribute: 6 samples at batch 4 differ from
    their first 4."""
    _, tp, _ = tiny
    tokens = np.random.default_rng(7).integers(0, CFG.vocab_size, (6, 32)).astype(np.int32)
    _, split = gptq_quantize_model(tp, CFG, tokens, batch_size=4, rot_dtype=torch.float32,
                                   device="cpu")
    _, trunc = gptq_quantize_model(tp, CFG, tokens[:4], batch_size=4, rot_dtype=torch.float32,
                                   device="cpu")
    assert sum(int((a[k]["q"] != b[k]["q"]).sum()) for a, b in zip(split, trunc) for k in a) > 0


def test_merged_projections_are_left_dense_and_logged(tiny):
    _, tp, tokens = tiny
    merged = td.merge_projections(quantize_model_rtn(tp, CFG, rot_dtype=torch.float32,
                                                     device="cpu"), CFG)
    dense = dict(merged, layers=[dict(lp, **{n: tp["layers"][i][n] for n in
                                             ("q_proj", "k_proj", "v_proj", "o_proj")})
                                 for i, lp in enumerate(merged["layers"])])
    for lp in dense["layers"]:
        lp.pop("qkv_proj")
    logs = []
    qp, exp = gptq_quantize_model(dense, CFG, tokens[:2, :32], rot_dtype=torch.float32,
                                  log_fn=logs.append, device="cpu")
    assert any("gate_up_proj is merged" in m for m in logs)
    assert sorted(exp[0]) == ["k_proj", "o_proj", "q_proj", "v_proj"]  # the MLP was quantized
    assert "gate_up_proj" in qp["layers"][0]["mlp"]


@pytest.mark.parametrize("name", ("tiny-moe", "tiny-gemma3n"))
def test_moe_and_gemma3n_are_refused(name):
    """gemma3n raises JAX's own NotImplementedError (JAX's GPTQ baseline does
    not support the family). tiny-moe, refused before, is
    ported: each layer's experts are GPTQ'd into QuantizedMoEExperts with an
    "mlp.experts" export (tests/test_torch_moe_convert.py holds the codes
    against JAX's)."""
    if name == "tiny-gemma3n":
        with pytest.raises(NotImplementedError, match="^GPTQ baseline does not support gemma3n$"):
            gptq_quantize_model({"layers": []}, PRESETS[name], np.zeros((1, 8), np.int32),
                                device="cpu")
        return
    jp = jd.init_params(J_PRESETS[name], jax.random.PRNGKey(2), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), PRESETS[name], device="cpu")
    tokens = np.random.default_rng(4).integers(0, 512, (2, 32)).astype(np.int32)
    qp, exp = gptq_quantize_model(tp, PRESETS[name], tokens, rot_dtype=torch.float32,
                                  device="cpu")
    for lp, e in zip(qp["layers"], exp):
        assert sorted(e) == ["k_proj", "mlp.experts", "o_proj", "q_proj", "v_proj"]
        assert type(lp["mlp"]["experts"]).__name__ == "QuantizedMoEExperts"
        assert isinstance(lp["mlp"]["router"], td.DenseLinear)
