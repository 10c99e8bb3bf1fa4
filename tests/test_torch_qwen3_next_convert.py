"""The qwen3_next hybrid's conversion and training paths in the port against
the JAX package, on the CPU: RTN (codes bit for bit, in_proj_ba dense),
the PARO-TPU and AWQ directories (bytes, and each side loading the
other's), GPTQ (tests/test_gptq.py::test_gptq_hybrid_delta_net_layers) and
calibration with the default skip of linear_attn.in_proj_ba
(tests/test_optim.py::test_calibrate_hybrid_delta_net_layers and
::test_hybrid_checkpoint_round_trip), each from the same JAX weights.

Tolerances. Logits of the same model in the two packages: 2e-4 of max
|logit| (tests/test_torch_qwen3_next.py derives it: the chunked delta
rule's cumulative decays and triangular solve amplify the f32 roundings in
which XLA and torch differ). GPTQ codes: at most 0.1% differ, by 1
(tests/test_torch_gptq.py: the Cholesky factors differ in their last bits),
on the first layer, where both packages see equal inputs. Calibration:
tests/test_torch_calibrate.py's bounds (theta and inverse channel scales
within 2e-3, codes at least 99.5% equal and never more than 1 apart,
logits within 2% of max).

The AWQ directory: JAX's `save_awq_checkpoint` leaves a hybrid's delta-net
tensors out, so its directory loads in neither package; the port writes
them as its PARO-TPU writer does, and every tensor JAX writes with JAX's
bytes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert import gptq as jgptq
from paroquant_tpu.convert import rtn as jrtn
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.models import from_hf_dict as j_from_hf_dict
from paroquant_tpu.models import init_params as j_init_params
from paroquant_tpu.optim import CalibConfig as JCalibConfig
from paroquant_tpu.optim import calibrate_model as j_calibrate
from paroquant_tpu_torch.convert import checkpoint as tck
from paroquant_tpu_torch.convert import gptq as tgptq
from paroquant_tpu_torch.convert import rtn as trtn
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.models import from_hf_dict
from paroquant_tpu_torch.ops.qlinear import QuantizedLinear
from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
from test_torch_calibrate import _exports_close, _logits_close

TOL = 2e-4
# a 2-layer MoE hybrid (a delta-net layer, then full attention) whose every
# quantized input dim is a multiple of 128
MOE_HYBRID = dict(model_type="qwen3_next", vocab_size=256, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, full_attention_interval=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=32, partial_rotary_factor=0.25,
                  linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=32,
                  linear_value_head_dim=32, linear_conv_kernel_dim=4, num_experts=4,
                  num_experts_per_tok=2, moe_intermediate_size=128,
                  shared_expert_intermediate_size=128, tie_word_embeddings=False)
# tests/test_gptq.py::test_gptq_hybrid_delta_net_layers's model
GPTQ_HYBRID = dict(model_type="qwen3_next", vocab_size=512, hidden_size=256, intermediate_size=384,
                   num_hidden_layers=2, full_attention_interval=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, partial_rotary_factor=0.25,
                   rope_theta=10000.0, linear_num_value_heads=4, linear_num_key_heads=2,
                   linear_key_head_dim=64, linear_value_head_dim=64, linear_conv_kernel_dim=4,
                   tie_word_embeddings=True)
# tests/test_optim.py's hybrid models: a dense MLP (2 layers), and MoE with a
# shared expert, here at 1 layer (the delta-net layer): past the first layer
# the two packages' inputs differ in their last bits, which this model's
# delta rule amplifies (see the module docstring), and the MoE hybrid's
# second-layer theta then leaves 2e-3 (3.7e-3 measured, v_proj)
CALIB_HYBRID = dict(model_type="qwen3_next", vocab_size=64, hidden_size=64, intermediate_size=96,
                    num_hidden_layers=2, full_attention_interval=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.25,
                    rope_theta=10000.0, linear_num_value_heads=4, linear_num_key_heads=2,
                    linear_key_head_dim=16, linear_value_head_dim=16, linear_conv_kernel_dim=4,
                    tie_word_embeddings=True)
CALIB_MOE = dict(CALIB_HYBRID, num_hidden_layers=1, num_experts=4, num_experts_per_tok=2,
                 moe_intermediate_size=32, shared_expert_intermediate_size=32)
j_forward = jax.jit(jd.model_forward, static_argnames=("config", "quant_mode", "attn_mode"))
j_init = jax.jit(j_init_params, static_argnames=("config", "dtype"))


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max() / np.abs(j).max())


def _models(hf, seed):
    jcfg, cfg = j_from_hf_dict(hf), from_hf_dict(hf)
    jp = j_init(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tokens(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(np.int32)


def test_rtn_codes_bit_for_bit():
    """Hadamard RTN with a W4 lm_head: every leaf the port gives equals JAX's;
    in_proj_qkvz and out_proj W4, in_proj_ba dense, as the reference skips it."""
    jcfg, cfg, jp, tp = _models(MOE_HYBRID, 1)
    jq_dev = jrtn.quantize_model_rtn(jp, jcfg, hadamard=True, quantize_lm_head=True)
    jq = jax.tree.map(np.asarray, jq_dev)
    tq = trtn.quantize_model_rtn(tp, cfg, hadamard=True, quantize_lm_head=True, device="cpu")
    la = tq["layers"][0]["linear_attn"]
    assert isinstance(la["in_proj_qkvz"], QuantizedLinear) and isinstance(la["out_proj"], QuantizedLinear)
    assert isinstance(la["in_proj_ba"], td.DenseLinear)
    ref = params_from_jax(jq, cfg, "cpu")
    for name in ("in_proj_qkvz", "out_proj"):
        for leaf in ("qweight", "scales", "zeros", "rot"):
            assert torch.equal(getattr(la[name], leaf),
                               getattr(ref["layers"][0]["linear_attn"][name], leaf)), (name, leaf)
    for name in ("q_proj", "o_proj"):
        assert torch.equal(tq["layers"][1][name].qweight, ref["layers"][1][name].qweight)
    toks = _tokens(20, 2, cfg.vocab_size)
    tl, _ = td.model_forward(tq, cfg, torch.from_numpy(toks))
    jl, _ = j_forward(jq_dev, jcfg, jnp.asarray(toks))
    assert _rel(tl, jl) < TOL


@pytest.fixture(scope="module")
def directories(tmp_path_factory):
    """The port's and JAX's PARO-TPU and AWQ directories of the same weights
    and exports: rtn_export_model's (the attention) plus in_proj_qkvz,
    out_proj and the shared expert exported by rtn_export_linear."""
    jcfg, cfg, jp, tp = _models(MOE_HYBRID, 3)
    exports = trtn.rtn_export_model(tp, cfg, hadamard=True)
    for li, lp in enumerate(tp["layers"]):
        if "linear_attn" in lp:
            for name in ("in_proj_qkvz", "out_proj"):
                exports[li][f"linear_attn.{name}"] = trtn.rtn_export_linear(
                    lp["linear_attn"][name], hadamard=True)
        for name, lin in lp["mlp"]["shared_expert"].items():
            exports[li][f"mlp.shared_expert.{name}"] = trtn.rtn_export_linear(lin, hadamard=True)
    root = tmp_path_factory.mktemp("hybrid_ckpt")
    dirs = {}
    for fmt in ("paro", "awq"):
        for side, save in (("port", getattr(tck, f"save_{fmt}_checkpoint")),
                           ("jax", getattr(jck, f"save_{fmt}_checkpoint"))):
            d = root / f"{side}_{fmt}"
            save(d, tp if side == "port" else jp, cfg if side == "port" else jcfg, exports)
            dirs[side, fmt] = d
    return jcfg, cfg, dirs


def test_paro_directory_bytes_and_cross_loading(directories):
    jcfg, cfg, dirs = directories
    for f in ("model.safetensors", "config.json"):
        assert (dirs["port", "paro"] / f).read_bytes() == (dirs["jax", "paro"] / f).read_bytes(), f
    hf = json.loads((dirs["port", "paro"] / "config.json").read_text())
    assert hf["layer_types"] == ["linear_attention", "full_attention"]
    toks = _tokens(24, 4, cfg.vocab_size)
    jp2, jcfg2 = jck.load_checkpoint(dirs["port", "paro"], dtype=jnp.float32)
    jl, _ = j_forward(jp2, jcfg2, jnp.asarray(toks))
    tp2, cfg2 = tck.load_checkpoint(dirs["jax", "paro"], dtype=torch.float32, device="cpu")
    assert cfg2.layer_types == cfg.layer_types and cfg2.attn_gate
    la = tp2["layers"][0]["linear_attn"]
    assert isinstance(la["in_proj_qkvz"], QuantizedLinear) and isinstance(la["in_proj_ba"], td.DenseLinear)
    assert la["conv_w"].dtype == torch.float32 and la["conv_w"].shape == (cfg.linear_conv_dim, 4)
    tl, _ = td.model_forward(tp2, cfg2, torch.from_numpy(toks))
    assert _rel(tl, jl) < TOL


def test_awq_directory(directories):
    jcfg, cfg, dirs = directories
    port, jaxd = (tck.read_safetensors(dirs[s, "awq"] / "model.safetensors") for s in ("port", "jax"))
    assert set(jaxd) < set(port)
    assert all(torch.equal(port[k], jaxd[k]) for k in jaxd)
    extra = sorted(set(port) - set(jaxd))
    assert extra and all(".linear_attn." in k for k in extra)
    assert "model.layers.0.linear_attn.in_proj_qkvz.qzeros" in extra
    assert (dirs["port", "awq"] / "config.json").read_bytes() == (
        dirs["jax", "awq"] / "config.json").read_bytes()
    with pytest.raises(KeyError, match="linear_attn"):
        jck.load_checkpoint(dirs["jax", "awq"], dtype=jnp.float32)
    toks = _tokens(24, 5, cfg.vocab_size)
    jp2, jcfg2 = jck.load_checkpoint(dirs["port", "awq"], dtype=jnp.float32)
    tp2, cfg2 = tck.load_checkpoint(dirs["port", "awq"], dtype=torch.float32, device="cpu")
    tl, _ = td.model_forward(tp2, cfg2, torch.from_numpy(toks))
    jl, _ = j_forward(jp2, jcfg2, jnp.asarray(toks))
    assert _rel(tl, jl) < TOL


def test_gptq_hybrid_delta_net_layers():
    """in_proj_qkvz / out_proj GPTQ'd against their own taps' Hessians,
    in_proj_ba dense, the full-attention layer the standard way; the first
    layer's codes JAX's up to the Cholesky factors' last bits, the model
    beats RTN on the calibration logits as in JAX's test."""
    jcfg, cfg, jp, tp = _models(GPTQ_HYBRID, 5)
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    _, jexp = jgptq.gptq_quantize_model(jp, jcfg, tokens, batch_size=4, rot_dtype=jnp.float32)
    tq, texp = tgptq.gptq_quantize_model(tp, cfg, tokens, batch_size=4, rot_dtype=torch.float32,
                                         device="cpu")
    assert [sorted(e) for e in texp] == [sorted(e) for e in jexp]
    la = tq["layers"][0]["linear_attn"]
    assert isinstance(la["in_proj_qkvz"], QuantizedLinear) and isinstance(la["out_proj"], QuantizedLinear)
    assert isinstance(la["in_proj_ba"], td.DenseLinear)
    assert isinstance(tq["layers"][1]["q_proj"], QuantizedLinear)
    for name, e in texp[0].items():
        diff = e["q"] != np.asarray(jexp[0][name]["q"])
        assert diff.mean() <= 1e-3 and np.abs(e["q"] - np.asarray(jexp[0][name]["q"])).max(initial=0) <= 1, name
    toks = torch.from_numpy(tokens)
    ref = td.model_forward(tp, cfg, toks)[0]
    err_g = float(torch.mean((td.model_forward(tq, cfg, toks)[0] - ref) ** 2))
    rtn = trtn.quantize_model_rtn(tp, cfg, group_size=128, rot_dtype=torch.float32, device="cpu")
    err_r = float(torch.mean((td.model_forward(rtn, cfg, toks)[0] - ref) ** 2))
    assert err_g < err_r, (err_g, err_r)


STAGES = (({"channel_scales": 5e-3, "angles": 5e-3}, 1),)


@pytest.mark.parametrize("hf", ["dense_mlp", "moe"])
def test_calibrate_hybrid_matches_jax(hf, tmp_path):
    """tests/test_optim.py's hybrid calibration (stage 1 at LR 5e-3: 5e-2 is
    chaotic; one epoch) through both packages: the same exports (in_proj_ba skipped),
    within the calibration bounds; the PARO-TPU round trip of the port's
    exports (the port writes JAX's bytes and loads to the calibrated
    model's logits, tests/test_optim.py::test_hybrid_checkpoint_round_trip)."""
    cfg_dict = {"dense_mlp": CALIB_HYBRID, "moe": CALIB_MOE}[hf]
    jcfg, cfg, jp, tp = _models(cfg_dict, 2)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 1, 16)).astype(np.int32)
    calib = dict(n_bits=4, group_size=16, num_rotations=2, stages=STAGES)
    jq, jexp = j_calibrate(jp, jcfg, tokens, JCalibConfig(**calib))
    tq, texp = calibrate_model(tp, cfg, tokens, CalibConfig(**calib), device="cpu")
    assert [sorted(e) for e in texp] == [sorted(e) for e in jexp]
    assert "linear_attn.in_proj_qkvz" in texp[0] and "linear_attn.in_proj_ba" not in texp[0]
    la = tq["layers"][0]["linear_attn"]
    assert isinstance(la["in_proj_qkvz"], QuantizedLinear) and isinstance(la["in_proj_ba"], td.DenseLinear)

    def flat(exports):  # stacked experts as per-projection entries
        out = []
        for layer in exports:
            d = {k: {kk: np.asarray(vv) for kk, vv in v.items() if kk in
                     ("q", "theta", "inv_channel_scales", "pairs")}
                 for k, v in layer.items() if k != "mlp.experts"}
            if "mlp.experts" in layer:
                e = layer["mlp.experts"]
                for p, side in (("gate", "gate_up"), ("up", "gate_up"), ("down", "down")):
                    d[f"experts.{p}"] = {"q": np.asarray(e[p]["q"]),
                                         "theta": np.asarray(e[f"{side}_theta"]),
                                         "inv_channel_scales": np.asarray(e[f"{side}_inv_channel_scales"]),
                                         "pairs": np.asarray(e[f"{side}_pairs"])}
            out.append(d)
        return out

    assert _exports_close(flat(jexp), flat(texp))
    test = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    tl = td.model_forward(tq, cfg, torch.from_numpy(test))[0].numpy()
    assert _logits_close(np.asarray(j_forward(jq, jcfg, jnp.asarray(test))[0]), tl)
    tck.save_paro_checkpoint(tmp_path / "port", tp, cfg, texp)
    jck.save_paro_checkpoint(tmp_path / "jax", jp, jcfg, texp)
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    tp2, cfg2 = tck.load_checkpoint(tmp_path / "port", dtype=torch.float32, device="cpu")
    assert cfg2.layer_types == cfg.layer_types
    if hf == "moe":
        assert isinstance(tp2["layers"][0]["mlp"]["shared_expert"]["gate_proj"], QuantizedLinear)
        assert isinstance(tp2["layers"][0]["mlp"]["shared_expert_gate"], td.DenseLinear)
    l2 = td.model_forward(tp2, cfg2, torch.from_numpy(test))[0].numpy()
    # dense side tensors and theta go through f16 in the file (JAX's bound)
    np.testing.assert_allclose(l2, tl, rtol=2e-2, atol=5e-2)
