"""The port's pseudo-quantized MoE experts (`paroquant_tpu_torch/optim/
pseudo_moe.py`) and the calibration of the experts against JAX's, on the
CPU, from the same seeded numpy inputs.

Tolerances, and why (tests/test_torch_calibrate_train.py derives them for
the linears; the experts reuse them).
- Bit for bit: the quantizer's init (eager division) and the export codes
  where the rotation is exact (theta 0); the effective weights in both
  quantizer forms against JAX's eager call and JAX's `jax.jit`.
- With learned angles the rotation's cos/sin and sums differ in their last
  bits: codes equal, scales within 1e-6 relative; effective weights within
  1e-5 of max |w|.
- Gradients of the effective experts: 1e-4 of max |g| against JAX's eager
  `jax.grad` (the port keeps eager JAX's min/max gradient).
- Loss trajectories (stage 1 at LR 5e-3; 5e-2 is chaotic): each logged loss
  within 1% of JAX's.
- calibrate_model on a two-layer `tiny-moe`: layer 0 sees equal inputs and
  hands back its initial point; layer 1 carries last-bit differences, so
  theta and inverse channel scales within 2e-3, codes equal in at least
  99.5% of entries and never more than 1 apart, logits within 2% of max
  (tests/test_torch_calibrate.py's bounds).
The properties of tests/test_moe_quant.py hold in the port: the identity
rotation is per-expert RTN, and the export round-trips to the pseudo
weights through the runtime's bf16 scales.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.ops import moe as jmoe
from paroquant_tpu.ops import rotation as jrot
from paroquant_tpu.ops.butterfly import make_butterfly_params as j_butterfly
from paroquant_tpu.optim import CalibConfig as JCalibConfig
from paroquant_tpu.optim import calibrate_model as j_calibrate
from paroquant_tpu.optim import pseudo_moe as jpm
from paroquant_tpu.optim.train import optimize_linears as j_optimize
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops import moe as tmoe
from paroquant_tpu_torch.ops import quant as tq
from paroquant_tpu_torch.ops import rotation as trot
from paroquant_tpu_torch.ops.butterfly import make_butterfly_params
from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
from paroquant_tpu_torch.optim import pseudo as tpseudo
from paroquant_tpu_torch.optim import pseudo_moe as tpm
from paroquant_tpu_torch.optim import train as ttrain
from test_torch_calibrate import _exports_close, _logits_close

GS = 64
E, H, I = 4, 128, 64


def _np(t):
    return t.detach().cpu().numpy()


def _experts(seed=0):
    rng = np.random.default_rng(seed)
    return {"gate_proj": rng.normal(0, 0.2, (E, H, I)).astype(np.float32),
            "up_proj": rng.normal(0, 0.2, (E, H, I)).astype(np.float32),
            "down_proj": rng.normal(0, 0.2, (E, I, H)).astype(np.float32)}


def _pair(theta_std=0.2, scales=True, butterfly=False, seed=1, n_bits=4):
    """The same pseudo experts in both packages."""
    ex = _experts(seed)
    if butterfly:
        jr = (j_butterfly(H, GS, 4), j_butterfly(I, GS, 4))
        tr = (make_butterfly_params(H, GS, 4), make_butterfly_params(I, GS, 4))
    else:
        jr = (jrot.make_rotation_params(H, GS, 4, seed), jrot.make_rotation_params(I, GS, 4, seed + 1))
        tr = (trot.make_rotation_params(H, GS, 4, seed), trot.make_rotation_params(I, GS, 4, seed + 1))
    jp = jpm.make_pseudo_moe({k: jnp.asarray(v) for k, v in ex.items()}, *jr, n_bits=n_bits,
                             group_size=GS)
    tp = tpm.make_pseudo_moe({k: torch.from_numpy(v) for k, v in ex.items()}, *tr, n_bits=n_bits,
                             group_size=GS)
    rng = np.random.default_rng(seed + 7)
    upd = {}
    for side, n in (("gate_up", H), ("down", I)):
        th = getattr(jp, f"{side}_theta")
        upd[f"{side}_theta"] = (rng.normal(0, theta_std, th.shape).astype(np.float32)
                                if theta_std else np.zeros(th.shape, np.float32))
        upd[f"{side}_channel_scales"] = (rng.uniform(0.7, 1.4, n).astype(np.float32) if scales
                                         else np.ones(n, np.float32))
    jp = jp.replace(**{k: jnp.asarray(v) for k, v in upd.items()})
    with torch.no_grad():
        for k, v in upd.items():
            getattr(tp, k).copy_(torch.from_numpy(v))
    return jp, tp


def _eff_close(t, j, tol):
    for k in ("gate_proj", "up_proj", "down_proj"):
        a, b = np.asarray(j[k]), _np(t[k])
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), k


def test_identity_rotation_matches_rtn():
    """tests/test_moe_quant.py:35 in the port: theta 0 and unit scales, the
    effective experts are each expert's RTN round trip."""
    _, tp = _pair(theta_std=0.0, scales=False, butterfly=True, n_bits=8)
    eff = tpm.pseudo_moe_effective_experts(tp)
    for k in ("gate_proj", "up_proj", "down_proj"):
        w = getattr(tp, k.replace("_proj", "_weight"))
        for e in range(E):
            ref = tq.pseudo_quantize(w[e].T, 8, GS).T
            assert torch.abs(eff[k][e] - ref).max() <= 1e-5


def test_export_round_trip_matches_pseudo():
    """tests/test_moe_quant.py:52 in the port: the runtime experts built
    from the export give the pseudo experts' outputs within 2% (the runtime
    keeps bf16 scales), and JAX's runtime experts' outputs within 1e-5 of
    max |y|."""
    jp, tp = _pair(theta_std=0.2, seed=3)
    eff = tpm.pseudo_moe_effective_experts(tp)
    qmoe = tpm.quantized_moe_from_export(tpm.export_quantized_moe(tp))
    rng = np.random.default_rng(4)
    x, idx, gates = (rng.normal(size=(6, H)).astype(np.float32),
                     rng.integers(0, E, (6, 2)).astype(np.int32),
                     rng.uniform(0, 1, (6, 2)).astype(np.float32))
    args = tuple(torch.from_numpy(a) for a in (x, idx, gates))
    with torch.no_grad():
        y_q = tmoe._moe_gather(qmoe, *args)
        y_eff = tmoe._moe_gather(eff, *args)
    assert float(torch.linalg.norm(y_q - y_eff) / torch.linalg.norm(y_eff)) < 2e-2
    j_q = np.asarray(jmoe._moe_gather(jpm.quantized_moe_from_export(jpm.export_quantized_moe(jp)),
                                      *(jnp.asarray(a) for a in (x, idx, gates))))
    assert np.abs(_np(y_q) - j_q).max() <= 1e-5 * np.abs(j_q).max()


@pytest.mark.parametrize("form", ["eager", "jit"])
def test_effective_experts_bit_for_bit_at_theta_zero(form):
    jp, tp = _pair(theta_std=0.0)
    if form == "jit":
        want = jax.jit(jpm.pseudo_moe_effective_experts)(jp)
        with tpseudo.jit_form():
            got = tpm.pseudo_moe_effective_experts(tp)
    else:
        want, got = jpm.pseudo_moe_effective_experts(jp), tpm.pseudo_moe_effective_experts(tp)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), k)


def test_init_and_export_bit_for_bit():
    """theta 0 (an exact rotation), channel scales not 1: the quantizer's
    eager init and the export are JAX's bit for bit, before and after init."""
    jp, tp = _pair(theta_std=0.0)
    before = (jpm.export_quantized_moe(jp), tpm.export_quantized_moe(tp))
    assert tp.gate_up_q_scale is None
    after = (jpm.export_quantized_moe(jpm.init_moe_quantizers(jp)),
             tpm.export_quantized_moe(tpm.init_moe_quantizers(tp)))
    for je, te in (before, after):
        assert list(te) == list(je)
        for side in ("gate_up", "down"):
            for k in ("theta", "pairs", "inv_channel_scales"):
                np.testing.assert_array_equal(te[f"{side}_{k}"], np.asarray(je[f"{side}_{k}"]))
        for p in ("gate", "up", "down"):
            for k in ("q", "scales", "zeros"):
                np.testing.assert_array_equal(te[p][k], np.asarray(je[p][k]), (p, k))
                assert te[p][k].dtype == np.asarray(je[p][k]).dtype
    for side in ("gate_up", "down"):
        for f in ("q_scale", "q_zp"):
            np.testing.assert_array_equal(_np(getattr(tp, f"{side}_{f}")),
                                          np.asarray(getattr(jpm.init_moe_quantizers(jp),
                                                             f"{side}_{f}")))


def test_learned_rotation_values_exports_and_grads():
    jp, tp = _pair(theta_std=0.2, seed=5)
    _eff_close(tpm.pseudo_moe_effective_experts(tp), jpm.pseudo_moe_effective_experts(jp), 1e-5)
    je, te = jpm.export_quantized_moe(jp), tpm.export_quantized_moe(tp)
    for p in ("gate", "up", "down"):
        np.testing.assert_array_equal(te[p]["q"], np.asarray(je[p]["q"]))
        np.testing.assert_allclose(te[p]["scales"], np.asarray(je[p]["scales"]), rtol=1e-6)
    # gradients of a loss on the effective experts, wrt the trainable fields
    rng = np.random.default_rng(6)
    c = {k: rng.normal(size=s).astype(np.float32)
         for k, s in (("gate_proj", (E, H, I)), ("up_proj", (E, H, I)), ("down_proj", (E, I, H)))}
    fields = ("gate_up_theta", "down_theta", "gate_up_channel_scales", "down_channel_scales",
              "gate_weight", "down_weight")

    def jloss(vals):
        eff = jpm.pseudo_moe_effective_experts(jp.replace(**vals))
        return sum(jnp.sum(eff[k] * c[k]) for k in c)

    jg = jax.grad(jloss)({f: getattr(jp, f) for f in fields})
    eff = tpm.pseudo_moe_effective_experts(tp)
    sum(torch.sum(eff[k] * torch.from_numpy(c[k])) for k in c).backward()
    for f in fields:
        a, b = np.asarray(jg[f]), _np(getattr(tp, f).grad)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), f


def _trajectories(weight_decay=0.01):
    """Both stages on the experts alone in both packages: the gather path
    over 16 tokens a batch, targets from the dense experts."""
    jp, tp = _pair(theta_std=0.0, seed=8)
    rng = np.random.default_rng(9)
    xs = rng.normal(size=(8, 16, H)).astype(np.float32)
    idx = np.stack([rng.integers(0, E, (16, 2)) for _ in range(8)]).astype(np.int32)
    gates = rng.uniform(0, 1, (8, 16, 2)).astype(np.float32)
    dense = {k: jnp.asarray(v) for k, v in _experts(8).items()}
    ys = [np.asarray(jmoe._moe_gather(dense, jnp.asarray(xs[i]), jnp.asarray(idx[i]),
                                      jnp.asarray(gates[i]))) for i in range(8)]
    stages = (({"channel_scales": 5e-3, "angles": 5e-3}, 4), ({"weight": 1e-4, "quantizer": 1e-4}, 3))
    logs = {"j": [], "t": []}

    def japply(d, b):
        return jmoe._moe_gather(jpm.pseudo_moe_effective_experts(d["experts"]), b[0], b[1], b[2])

    def tapply(d, b):
        return tmoe._moe_gather(tpm.pseudo_moe_effective_experts(d["experts"]), b[0], b[1], b[2])

    jb = [((jnp.asarray(xs[i]), jnp.asarray(idx[i]), jnp.asarray(gates[i])), jnp.asarray(ys[i]))
          for i in range(8)]
    tb = [((torch.from_numpy(xs[i]), torch.from_numpy(idx[i]), torch.from_numpy(gates[i])),
           torch.from_numpy(np.array(ys[i]))) for i in range(8)]
    JL, TL = {"experts": jp}, {"experts": tp}
    for groups, ep in stages:
        JL, _ = j_optimize(japply, JL, jb[:6], jb[6:], groups, n_epochs=ep,
                           log_fn=lambda m, s: logs["j"].append((s, m)))
        TL, _ = ttrain.optimize_linears(tapply, TL, tb[:6], tb[6:], groups, n_epochs=ep,
                                        weight_decay=weight_decay,
                                        log_fn=lambda m, s: logs["t"].append((s, m)))
    assert TL["experts"].gate_up_q_scale is not None  # the quantizer stage initialized it
    return logs["j"], logs["t"]


def _rel_gap(lj, lt):
    assert [(s, sorted(m)) for s, m in lj] == [(s, sorted(m)) for s, m in lt]
    return max(abs(mj[k] - mt[k]) / abs(mj[k]) for (_, mj), (_, mt) in zip(lj, lt) for k in mj)


@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
def test_loss_trajectory_matches_jax(weight_decay):
    """optax.adamw's weight decay is 0.01: the port at 0.0 is the negative
    control and must leave the 1% band."""
    lj, lt = _trajectories(weight_decay)
    assert (_rel_gap(lj, lt) <= 0.01) == (weight_decay == 0.01), _rel_gap(lj, lt)


# ---------------------------------------------------------------------------
# calibrate_model on a two-layer tiny-moe, against JAX's
# ---------------------------------------------------------------------------

J_CFG = dataclasses.replace(J_PRESETS["tiny-moe"], num_experts=4)
T_CFG = dataclasses.replace(PRESETS["tiny-moe"], num_experts=4)
STAGES = (({"channel_scales": 5e-3, "angles": 5e-3}, 2), ({"weight": 1e-5, "quantizer": 1e-6}, 2))
CALIB = dict(n_bits=4, group_size=GS, num_rotations=4, stages=STAGES)


@pytest.fixture(scope="module")
def calibrated():
    params = jd.init_params(J_CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, J_CFG.vocab_size, (4, 2, 16)).astype(np.int32)
    test_tokens = rng.integers(0, J_CFG.vocab_size, (1, 16)).astype(np.int32)
    jq, jexp = j_calibrate(params, J_CFG, tokens, JCalibConfig(**CALIB))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), T_CFG, device="cpu")
    tq_, texp = calibrate_model(tparams, T_CFG, tokens, CalibConfig(**CALIB), device="cpu")
    with torch.no_grad():
        t_logits = _np(td.model_forward(tq_, T_CFG, torch.from_numpy(test_tokens))[0])
    return dict(jexp=jexp, texp=texp, tq=tq_, t_logits=t_logits,
                j_logits=np.asarray(jd.model_forward(jq, J_CFG, jnp.asarray(test_tokens))[0]))


def _flat(exports):
    """Each layer's expert export as per-projection entries, in the linears' schema."""
    out = []
    for layer in exports:
        d = {k: v for k, v in layer.items() if k != "mlp.experts"}
        e = layer["mlp.experts"]
        for p, side in (("gate", "gate_up"), ("up", "gate_up"), ("down", "down")):
            d[f"experts.{p}"] = {"q": np.asarray(e[p]["q"]), "theta": np.asarray(e[f"{side}_theta"]),
                                 "inv_channel_scales": np.asarray(e[f"{side}_inv_channel_scales"]),
                                 "pairs": np.asarray(e[f"{side}_pairs"])}
        out.append(d)
    return out


def test_calibrated_moe_matches_jax(calibrated):
    je, te = calibrated["jexp"], calibrated["texp"]
    assert [sorted(x) for x in te] == [sorted(x) for x in je]
    assert all("mlp.experts" in x for x in te)
    assert isinstance(calibrated["tq"]["layers"][0]["mlp"]["experts"], tmoe.QuantizedMoEExperts)
    assert _exports_close(_flat(je), _flat(te))
    assert _logits_close(calibrated["j_logits"], calibrated["t_logits"])
