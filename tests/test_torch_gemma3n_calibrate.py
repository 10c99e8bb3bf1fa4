"""gemma3n calibration in the port against the JAX package, on the CPU: a
source layer and its shared-KV tail through JAX's gemma3n branch and the
port's (the AltUp stack with its batch on axis 1, the per-layer inputs
sliced per layer, the tail attending over the source student's (k, v) and
skipping its k/v projections; GPTQ init leaves gemma3n on the plain init,
as in JAX), from the same JAX weights.

Tolerances: tests/test_torch_calibrate.py's bounds (theta and inverse
channel scales within 2e-3, codes at least 99.5% equal and never more than
1 apart, logits within 2% of max); the PARO-TPU directory of the exports
byte for byte JAX's.

Also, port only: how far chip_smoke.py's card-against-host calibration
check of a small gemma3n can be held, from two host runs one ulp apart.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.models import from_hf_dict as j_from_hf_dict
from paroquant_tpu.optim import CalibConfig as JCalibConfig
from paroquant_tpu.optim import calibrate_model as j_calibrate
from paroquant_tpu_torch.convert import checkpoint as tck
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.models import from_hf_dict
from paroquant_tpu_torch.ops.qlinear import QuantizedLinear
from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
from test_torch_calibrate import _exports_close, _logits_close
from test_torch_gemma3n import _chip_smoke

# a source layer and its shared-KV tail (layer 1 reads layer 0's k/v)
CALIB_G3N = dict(
    model_type="gemma3n_text", vocab_size=64, vocab_size_per_layer_input=64, hidden_size=64,
    hidden_size_per_layer_input=16, intermediate_size=[96, 96], num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=1_000_000.0,
    rope_local_base_freq=10_000.0, sliding_window=8,
    layer_types=["sliding_attention", "sliding_attention"], num_kv_shared_layers=1,
    altup_num_inputs=4, laurel_rank=8, activation_sparsity_pattern=[0.95, 0.0],
    final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True)
STAGES = (({"channel_scales": 5e-3, "angles": 5e-3}, 1), ({"weight": 1e-5, "quantizer": 1e-6}, 1))
j_forward = jax.jit(jd.model_forward, static_argnames=("config", "quant_mode", "attn_mode"))
j_init = jax.jit(jd.init_params, static_argnames=("config", "dtype"))


def _models(jcfg, cfg, seed):
    jp = j_init(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    jp["layers"] = [dict(lp, altup=dict(lp["altup"], correct_output_scale=jnp.asarray(
        rng.normal(1.0, 0.1, cfg.hidden_size).astype(np.float32)))) for lp in jp["layers"]]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.mark.parametrize("gptq_init", [False, True])
def test_calibrate_source_and_tail_matches_jax(gptq_init, tmp_path):
    """A source layer and its tail through both packages (JAX's gemma3n
    branch: the AltUp stack with its batch on axis 1, the per-layer inputs
    sliced per layer, the tail attending over the source student's (k, v)
    and its k/v projections skipped; gptq_init leaves gemma3n on the plain
    init, as in JAX): the same exports within the calibration bounds, the
    logits within 2%, and the PARO-TPU directory of the exports JAX's."""
    jcfg, cfg = j_from_hf_dict(CALIB_G3N), from_hf_dict(CALIB_G3N)
    jp, tp = _models(jcfg, cfg, 2)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 1, 16)).astype(np.int32)
    # the weight stage only where GPTQ init could act on it
    calib = dict(n_bits=4, group_size=16, num_rotations=2, gptq_init=gptq_init,
                 stages=STAGES if gptq_init else STAGES[:1])
    jq, jexp = j_calibrate(jp, jcfg, tokens, JCalibConfig(**calib))
    tq, texp = calibrate_model(tp, cfg, tokens, CalibConfig(**calib), device="cpu")
    assert [sorted(e) for e in texp] == [sorted(e) for e in jexp]
    assert "k_proj" in texp[0] and "k_proj" not in texp[1] and "v_proj" not in texp[1]
    assert isinstance(tq["layers"][1]["k_proj"], td.DenseLinear)
    assert isinstance(tq["layers"][1]["q_proj"], QuantizedLinear)

    def flat(exports):
        return [{k: {kk: np.asarray(v[kk]) for kk in ("q", "theta", "inv_channel_scales", "pairs")}
                 for k, v in layer.items()} for layer in exports]

    assert _exports_close(flat(jexp), flat(texp))
    test = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    tl = td.model_forward(tq, cfg, torch.from_numpy(test))[0].numpy()
    assert _logits_close(np.asarray(j_forward(jq, jcfg, jnp.asarray(test))[0]), tl)
    tck.save_paro_checkpoint(tmp_path / "port", tp, cfg, texp)
    jck.save_paro_checkpoint(tmp_path / "jax", jp, jcfg, texp)
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


@pytest.mark.parametrize("epochs", [(1, 1), (4, 2)])
def test_small_calibration_one_ulp_apart(epochs):
    """chip_smoke.py's card-against-host calibration check of TINY_GEMMA3N
    (a source layer and its tail; small_calibration_inputs' weights and
    tokens) run twice on the host, the second time with the embedding table
    one ulp up. At 1+1 epochs (GEMMA3N_CALIB, which chip_smoke holds between
    card and host) the two runs stay within that check's rule (the CPU
    tests' export bounds, logits within 2% of max). At 4+2 (SMALL_CALIB,
    the dense and hybrid checks' epochs) the loss gap grows from 3e-7 to
    about 2% and the tail's exports leave the rule, so that no second device
    can be held to it there: if this case comes to hold, chip_smoke's
    gemma3n check should go back to SMALL_CALIB."""
    cs = _chip_smoke()
    cfg, params, tokens, test = cs.small_calibration_inputs(
        from_hf_dict(cs.TINY_GEMMA3N), 2, cs.gemma3n_random_init)
    calib = cs.GEMMA3N_CALIB if epochs == (1, 1) else cs.SMALL_CALIB
    assert tuple(e for _, e in calib["stages"]) == epochs
    up = torch.nextafter(params["embed_tokens"], torch.tensor(math.inf))
    (a, la), (b, lb) = (cs.small_calibration(cfg, dict(params, embed_tokens=e), tokens, test,
                                             calib, "cpu") for e in (params["embed_tokens"], up))
    worst = cs.calib_exports_close(a, b)
    err = ((lb - la).abs().max() / la.abs().max()).item()
    assert (worst["ok"] and err <= 0.02) == (epochs == (1, 1)), (worst, err)
