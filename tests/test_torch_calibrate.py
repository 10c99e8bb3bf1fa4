"""The port's calibrate_model (`paroquant_tpu_torch/optim/calibrate.py`)
against JAX's, on the CPU: tests/test_optim.py's tiny two-layer setup
(hidden 256, outlier gate/up rows, group 64, 6 rotations), JAX's weights
handed to the port through params_from_jax.

Tolerances, and why. Stage 1 runs at LR 5e-3 for 2 epochs (at the
recipe's 5e-2 the dynamics are chaotic: tests/test_torch_calibrate_train.py).
No epoch of layer 0 beats its first validation loss, so both packages hand
back its initial point bit for bit; layer 1's inputs then differ in their
last bits (the layer's sums run in other orders), and its training carries
that on: theta and the inverse channel scales within 2e-3, codes equal in
at least 99.5% of entries and never more than 1 apart, logits within 2% of
max |logits| (measured: 8e-4, 99.87%, 0.9%). The negative control is an
aliased best snapshot (logits 30% off). Bit for bit: resume, and the
.npz files read across packages. tests/test_torch_calibrate_train.py
holds calibrate_model's own properties (it beats RTN W4 at
tests/test_optim.py's recipe, GPTQ init, host-paged staging), and
tests/test_torch_calibrate_gptq.py holds gptq_init=True against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paroquant_tpu.cli.convert import load_results as j_load_results
from paroquant_tpu.models import model_forward as j_model_forward
from paroquant_tpu.optim import CalibConfig as JCalibConfig
from paroquant_tpu.optim import calibrate_model as j_calibrate
from paroquant_tpu_torch.cli.convert import load_results
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
from paroquant_tpu_torch.optim import train as ttrain
from test_torch_calibrate_train import CALIB, J_CFG, T_CFG, _t_logits, _tiny_setup


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    params, tokens, test_tokens = _tiny_setup()
    jdir, tdir = tmp_path_factory.mktemp("jax_results"), tmp_path_factory.mktemp("port_results")
    jq_params, j_exports = j_calibrate(params, J_CFG, tokens, JCalibConfig(**CALIB), output_dir=jdir)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), T_CFG, device="cpu")
    tq_params, t_exports = calibrate_model(tparams, T_CFG, tokens, CalibConfig(**CALIB),
                                           output_dir=tdir, device="cpu")
    return dict(
        params=params, tparams=tparams, tokens=tokens, test_tokens=test_tokens, jdir=jdir,
        tdir=tdir, j_exports=j_exports, t_exports=t_exports, tq_params=tq_params,
        j_logits=np.asarray(j_model_forward(jq_params, J_CFG, jnp.asarray(test_tokens))[0]),
        fp_logits=np.asarray(j_model_forward(params, J_CFG, jnp.asarray(test_tokens))[0]),
        t_logits=_t_logits(tq_params, test_tokens),
    )


def _exports_close(je, te):
    """theta / inverse scales within 2e-3, codes >= 99.5% equal, |dq| <= 1."""
    for li in range(len(je)):
        assert set(je[li]) == set(te[li])
        for name in je[li]:
            a, b = je[li][name], te[li][name]
            for k in ("theta", "inv_channel_scales"):
                if np.abs(a[k] - b[k]).max() > 2e-3 * max(np.abs(a[k]).max(), 1.0):
                    return False
            if (a["q"] == b["q"]).mean() < 0.995 or np.abs(a["q"] - b["q"]).max() > 1:
                return False
            np.testing.assert_array_equal(a["pairs"], b["pairs"])
    return True


def test_calibrated_exports_match_jax(calibrated):
    je, te = calibrated["j_exports"], calibrated["t_exports"]
    assert len(te) == 2 and all(len(r) == 7 for r in te)
    assert _exports_close(je, te)
    # no epoch of layer 0 beats its first validation loss in JAX: both
    # packages hand back the initial point, bit for bit
    for name in je[0]:
        assert not np.asarray(je[0][name]["theta"]).any()
        for k in ("q", "zeros", "theta", "inv_channel_scales"):
            np.testing.assert_array_equal(te[0][name][k], je[0][name][k])


def _logits_close(a, b):
    return np.abs(a - b).max() <= 0.02 * np.abs(a).max()


def test_calibrated_logits_match_jax(calibrated):
    assert _logits_close(calibrated["j_logits"], calibrated["t_logits"])


def test_calibration_negative_control_aliased_snapshot(calibrated, monkeypatch):
    """A best snapshot that aliases the live parameters hands back the last
    step instead of the best epoch: both checks above fail."""
    monkeypatch.setattr(ttrain, "_snapshot", lambda trainable: trainable)
    q, exps = calibrate_model(calibrated["tparams"], T_CFG, calibrated["tokens"],
                              CalibConfig(**CALIB), device="cpu")
    assert not _exports_close(calibrated["j_exports"], exps)
    assert not _logits_close(calibrated["j_logits"], _t_logits(q, calibrated["test_tokens"]))


def test_resume_reproduces_the_model(calibrated):
    q2, exps = calibrate_model(calibrated["tparams"], T_CFG, calibrated["tokens"],
                               CalibConfig(**CALIB), output_dir=calibrated["tdir"], device="cpu")
    np.testing.assert_array_equal(_t_logits(q2, calibrated["test_tokens"]), calibrated["t_logits"])
    for li, layer in enumerate(exps):
        for name, exp in layer.items():
            np.testing.assert_array_equal(exp["q"], calibrated["t_exports"][li][name]["q"])


def test_npz_results_read_across_packages(calibrated):
    """Each package's cli.convert load_results reads the other's files."""
    for reader, d, exports in ((j_load_results, calibrated["tdir"], calibrated["t_exports"]),
                               (load_results, calibrated["jdir"], calibrated["j_exports"])):
        got = reader(d)
        assert [sorted(g) for g in got] == [sorted(e) for e in exports]
        for g, e in zip(got, exports):
            for name in e:
                for k, v in e[name].items():
                    if isinstance(v, np.ndarray):
                        np.testing.assert_array_equal(g[name][k], v)
                        assert g[name][k].dtype == v.dtype, (name, k)
                    else:
                        assert g[name][k] == v, (name, k)
