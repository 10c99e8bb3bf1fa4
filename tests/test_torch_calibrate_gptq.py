"""calibrate_model with gptq_init=True, the port's against JAX's, on the CPU:
tests/test_optim.py's tiny setup (hidden 256, outlier gate/up rows, group
64, 6 rotations) cut to its first layer, JAX's weights handed to the port
through params_from_jax, the stages of tests/test_torch_calibrate.py.

Why one layer, and why not the exports at _exports_close's limits. The
GPTQ grid turns a last-bit change of its Hessian into other codes, which
GPTQ's error feedback carries on to the next columns: JAX against itself,
with each Hessian multiplied by (1 + 2**-23), gives codes that differ in up
to 0.11% of entries and by up to 3 in layer 0. Layer 1 trains its rotation
on those outputs, so its rotation and then its grid part: 72-76% of its
codes equal and logits 25% of max apart, JAX against JAX, and the same
between the port and JAX. Only layer 0 sees equal inputs in both packages,
so the checks hold what decides GPTQ init there:
- the order of the work: stage 1, then GPTQ init of the seven linears in
  their order, then stage 2 (equal to JAX's sequence);
- what GPTQ init is given: each linear's weight, theta and channel scales
  bit for bit JAX's (stage 1 returns its initial point in both packages),
  and each Hessian within 1e-6 of max |H| of JAX's (measured 4.3e-7: the
  taps' sums run in other orders);
- what comes out: theta and the inverse channel scales bit for bit, codes
  equal in at least 99.5% of entries, logits within 6% of max |logits| of
  JAX's calibrated model. Measured: codes 99.89% equal, logits 2.0-2.9%
  apart; JAX against itself with each Hessian one ulp off (x (1 +- 2**-23),
  x (1 + 2**-22)): 99.88%, 2.8-2.9%.
Negative controls, which the Hessian check and the output check both fail:
o_proj given the q/k/v tap (codes 58% equal, logits 30% apart), and the
Hessians summed over the training batches only (62%, 49%).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paroquant_tpu.optim.calibrate as jcal
from paroquant_tpu.models import model_forward as j_model_forward
from paroquant_tpu.optim import CalibConfig as JCalibConfig
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import model_forward
from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
from paroquant_tpu_torch.optim import calibrate as tcal
from test_torch_calibrate_train import CALIB, J_CFG, T_CFG, _tiny_setup

J_CFG1 = dataclasses.replace(J_CFG, num_hidden_layers=1)
T_CFG1 = dataclasses.replace(T_CFG, num_hidden_layers=1)
GPTQ = dict(CALIB, gptq_init=True)
STATE = ("weight", "theta", "channel_scales")


@contextlib.contextmanager
def _recording(mod, to_np):
    """Record, in `mod` (either package's calibrate module), each
    optimize_linears call's groups and each gptq_init_linear call's input
    state and Hessian, in the order they come."""
    events = []
    opt, gptq = mod.optimize_linears, mod.gptq_init_linear

    def optimize_linears(apply_fn, linears, train_b, val_b, stage_groups, **kw):
        events.append(("stage", tuple(sorted(stage_groups))))
        return opt(apply_fn, linears, train_b, val_b, stage_groups, **kw)

    def gptq_init_linear(lin, hessian, *a):
        events.append(("gptq", {k: to_np(getattr(lin, k)) for k in STATE}, to_np(hessian)))
        return gptq(lin, hessian, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "optimize_linears", optimize_linears)
        mp.setattr(mod, "gptq_init_linear", gptq_init_linear)
        yield events


def _t_np(t):
    return t.detach().cpu().numpy().copy()


def _port_run(setup):
    with _recording(tcal, _t_np) as events:
        q, exports = calibrate_model(setup["tparams"], T_CFG1, setup["tokens"],
                                     CalibConfig(**GPTQ), device="cpu")
    with torch.no_grad():
        logits = model_forward(q, T_CFG1, torch.from_numpy(setup["test_tokens"]))[0].numpy()
    return events, exports, logits


@pytest.fixture(scope="module")
def gptq_calibrated():
    params, tokens, test_tokens = _tiny_setup()
    params = dict(params, layers=params["layers"][:1])
    with _recording(jcal, np.asarray) as j_events:
        jq, j_exports = jcal.calibrate_model(params, J_CFG1, tokens, JCalibConfig(**GPTQ))
    setup = dict(tparams=params_from_jax(jax.tree.map(np.asarray, params), T_CFG1, device="cpu"),
                 tokens=tokens, test_tokens=test_tokens)
    t_events, t_exports, t_logits = _port_run(setup)
    return dict(setup=setup, j_events=j_events, j_exports=j_exports, t_events=t_events,
                t_exports=t_exports, t_logits=t_logits,
                j_logits=np.asarray(j_model_forward(jq, J_CFG1, jnp.asarray(test_tokens))[0]))


def _sequence(events):
    return [e[0] if e[0] == "gptq" else e for e in events]


def test_gptq_init_runs_between_the_stages_as_jax(gptq_calibrated):
    want = _sequence(gptq_calibrated["j_events"])
    assert want == [("stage", ("angles", "channel_scales"))] + ["gptq"] * 7 \
        + [("stage", ("quantizer", "weight"))]
    assert _sequence(gptq_calibrated["t_events"]) == want


def test_gptq_init_inputs_match_jax(gptq_calibrated):
    """Each linear reaches GPTQ init in JAX's state, bit for bit."""
    gj = [e for e in gptq_calibrated["j_events"] if e[0] == "gptq"]
    gt = [e for e in gptq_calibrated["t_events"] if e[0] == "gptq"]
    for (_, sj, _), (_, st, _) in zip(gj, gt, strict=True):
        for k in STATE:
            np.testing.assert_array_equal(st[k], sj[k])


def _hessians_close(j_events, t_events):
    """Each Hessian within 1e-6 of max |H| of JAX's."""
    hj = [e[2] for e in j_events if e[0] == "gptq"]
    ht = [e[2] for e in t_events if e[0] == "gptq"]
    return len(hj) == len(ht) and all(
        a.shape == b.shape and np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
        for a, b in zip(hj, ht))


def test_gptq_init_hessians_match_jax(gptq_calibrated):
    assert _hessians_close(gptq_calibrated["j_events"], gptq_calibrated["t_events"])


def _outputs_close(je, te, j_logits, t_logits):
    """theta and inverse channel scales bit for bit, codes >= 99.5% equal,
    logits within 6% of max |logits|."""
    return sorted(je) == sorted(te) and all(
        np.array_equal(te[name][k], je[name][k])
        for name in je for k in ("theta", "inv_channel_scales", "pairs")
    ) and all((te[n]["q"] == je[n]["q"]).mean() >= 0.995 for n in je) \
        and np.abs(j_logits - t_logits).max() <= 0.06 * np.abs(j_logits).max()


def test_gptq_init_exports_and_logits_match_jax(gptq_calibrated):
    (je,), (te,) = gptq_calibrated["j_exports"], gptq_calibrated["t_exports"]
    assert len(te) == 7
    assert _outputs_close(je, te, gptq_calibrated["j_logits"], gptq_calibrated["t_logits"])


def _train_batches_only(layer_forward, n):
    """layer_forward whose taps of every n-th call (the validation batch of
    each Hessian sum) are zero."""
    calls = [0]

    def wrapped(*a, return_taps=False, **kw):
        out = layer_forward(*a, return_taps=return_taps, **kw)
        if not return_taps:
            return out
        calls[0] += 1
        if calls[0] % n:
            return out
        return (*out[:2], {k: torch.zeros_like(t) for k, t in out[2].items()})

    return wrapped


@pytest.mark.parametrize("mutation", ["o_proj_takes_qkv_tap", "train_batches_only"])
def test_gptq_init_negative_controls(gptq_calibrated, mutation, monkeypatch):
    if mutation == "o_proj_takes_qkv_tap":
        monkeypatch.setattr(tcal, "_TAP_OF", {**tcal._TAP_OF, "o_proj": "qkv"})
    else:
        n = gptq_calibrated["setup"]["tokens"].shape[0]
        monkeypatch.setattr(tcal, "layer_forward", _train_batches_only(tcal.layer_forward, n))
    events, (te,), logits = _port_run(gptq_calibrated["setup"])
    assert not _hessians_close(gptq_calibrated["j_events"], events)
    (je,) = gptq_calibrated["j_exports"]
    assert not _outputs_close(je, te, gptq_calibrated["j_logits"], logits)
