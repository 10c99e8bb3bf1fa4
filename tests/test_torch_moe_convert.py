"""The MoE family's checkpoints and GPTQ in the port against JAX's, on the
CPU (`tiny-moe` with a shared expert of 256, f32 weights of JAX's
init_params handed over through params_from_jax).

Checkpoints. The exports: JAX's `export_quantized_moe` of pseudo experts
with random angles and channel scales (so the shared rotations are not the
identity), JAX's RTN exports of the attention linears and of the shared
expert. JAX writes a PARO-TPU directory (stacked experts) and an AWQ one
(the reference's per-expert layout): the port loads each to JAX's loaded
model's f32 logits within 1e-5 of max |logit| (the same tensors; the sums
run in other orders) and the same greedy tokens. The port writes both from
the same exports: JAX's bytes, file for file, and JAX loads them. A
Mixtral-layout directory (`block_sparse_moe`, w1/w3/w2) and a dense-expert
one load in both packages the same way.

GPTQ. `_gptq_moe` on random positive-definite Hessians: the codes equal
JAX's in at least 99.9% of entries and never more than 1 apart (the two
Cholesky routines round apart, as tests/test_torch_gptq.py explains).
`gptq_quantize_model` on the model: the same exports' keys, the experts
quantized, the shared expert's gate dense, and JAX's property that GPTQ
beats RTN (logits' MSE to the dense model).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert.gptq import _gptq_moe as j_gptq_moe
from paroquant_tpu.convert.gptq import gptq_quantize_model as j_gptq_model
from paroquant_tpu.convert.rtn import rtn_export_linear as j_export_linear
from paroquant_tpu.convert.rtn import rtn_export_model as j_export_model
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.ops import rotation as jrot
from paroquant_tpu.optim import pseudo_moe as jpm
from paroquant_tpu_torch.convert import (load_checkpoint, quantize_model_rtn,
                                         save_awq_checkpoint, save_paro_checkpoint)
from paroquant_tpu_torch.convert.checkpoint import write_safetensors
from paroquant_tpu_torch.convert.gptq import _gptq_moe, gptq_quantize_model
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops.moe import QuantizedMoEExperts
from paroquant_tpu_torch.ops.qlinear import QuantizedLinear

JCFG = dataclasses.replace(J_PRESETS["tiny-moe"], shared_expert_intermediate_size=256)
CFG = dataclasses.replace(PRESETS["tiny-moe"], shared_expert_intermediate_size=256)
TOL = 1e-5
SAVERS = {"paro": (save_paro_checkpoint, jck.save_paro_checkpoint),
          "awq": (save_awq_checkpoint, jck.save_awq_checkpoint)}


@pytest.fixture(scope="module")
def moe():
    """JAX's dense f32 params, the port's copy, and per-layer exports."""
    jp = jd.init_params(JCFG, jax.random.PRNGKey(4), dtype=jnp.float32)
    exports = j_export_model(jp, JCFG)
    rng = np.random.default_rng(2)
    for li, lp in enumerate(jp["layers"]):
        ex = lp["mlp"]["experts"]
        H, I = ex["gate_proj"].shape[1:]
        pm = jpm.make_pseudo_moe(ex, jrot.make_rotation_params(H, 128, 8, li),
                                 jrot.make_rotation_params(I, 128, 8, li + 1000))
        pm = pm.replace(
            gate_up_theta=jnp.asarray(rng.normal(0, 0.2, pm.gate_up_theta.shape), jnp.float32),
            down_theta=jnp.asarray(rng.normal(0, 0.2, pm.down_theta.shape), jnp.float32),
            gate_up_channel_scales=jnp.asarray(rng.uniform(0.7, 1.4, H), jnp.float32),
            down_channel_scales=jnp.asarray(rng.uniform(0.7, 1.4, I), jnp.float32))
        exports[li]["mlp.experts"] = jpm.export_quantized_moe(pm)
        for n in ("gate_proj", "up_proj", "down_proj"):
            exports[li][f"mlp.shared_expert.{n}"] = j_export_linear(lp["mlp"]["shared_expert"][n])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, "cpu")
    toks = np.random.default_rng(5).integers(0, 512, (2, 24)).astype(np.int32)
    return dict(jp=jp, tp=tp, exports=exports, toks=toks)


def _logits_and_tokens(j_loaded, t_loaded, toks):
    jl = np.asarray(jd.model_forward(j_loaded[0], j_loaded[1], jnp.asarray(toks))[0])
    tl = td.model_forward(t_loaded[0], t_loaded[1], torch.from_numpy(toks))[0].numpy()
    assert np.abs(tl - jl).max() <= TOL * np.abs(jl).max()
    prompt = toks[:1, :12]
    jt = jd.greedy_generate(j_loaded[0], j_loaded[1], prompt, 8, cache_dtype=jnp.float32)
    tt = td.greedy_generate(t_loaded[0], t_loaded[1], prompt, 8, cache_dtype=torch.float32,
                            device="cpu")
    np.testing.assert_array_equal(tt, jt)


def _load_both(path):
    return (jck.load_checkpoint(path, rot_dtype=jnp.float32, dtype=jnp.float32),
            load_checkpoint(path, rot_dtype=torch.float32, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("fmt", sorted(SAVERS))
def test_jax_checkpoint_loads_in_the_port(moe, fmt, tmp_path):
    SAVERS[fmt][1](tmp_path / fmt, moe["jp"], JCFG, moe["exports"])
    jl, tl = _load_both(tmp_path / fmt)
    assert dataclasses.asdict(tl[1]) == dataclasses.asdict(jl[1]) and tl[1].is_moe
    for lp in tl[0]["layers"]:
        assert isinstance(lp["mlp"]["experts"], QuantizedMoEExperts)
        assert isinstance(lp["mlp"]["shared_expert"]["down_proj"], QuantizedLinear)
        assert isinstance(lp["mlp"]["shared_expert_gate"], td.DenseLinear)
    # the experts' buffers are JAX's loaded ones: the packed codes, scales
    # and zeros bit for bit, the composed rotations within 1e-6 (a product
    # of 8 stage matrices whose f32 sums run in another order)
    je = jax.tree.map(np.asarray, jl[0]["layers"][1]["mlp"]["experts"])
    for name, a, b in zip(je._fields, je, tl[0]["layers"][1]["mlp"]["experts"]):
        a, b = np.asarray(a, np.float32), b.to(torch.float32).numpy()
        if name.endswith("_rot"):
            assert np.abs(a - b).max() <= 1e-6, name
        else:
            np.testing.assert_array_equal(b, a, name)
    _logits_and_tokens(jl, tl, moe["toks"])


@pytest.mark.parametrize("fmt", sorted(SAVERS))
def test_port_writes_jax_bytes_and_jax_loads_them(moe, fmt, tmp_path):
    SAVERS[fmt][1](tmp_path / "jax", moe["jp"], JCFG, moe["exports"])
    SAVERS[fmt][0](tmp_path / "port", moe["tp"], CFG, moe["exports"])
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert json.loads((tmp_path / "port" / "config.json").read_text())["num_experts"] == 8
    _logits_and_tokens(*_load_both(tmp_path / "port"), moe["toks"])


def test_awq_refuses_runtime_experts_without_exports(moe, tmp_path):
    q = quantize_model_rtn(moe["tp"], CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="AWQ export"):
        save_awq_checkpoint(tmp_path / "x", q, CFG, [{} for _ in q["layers"]])


def test_dense_experts_round_trip(moe, tmp_path):
    """No expert export: JAX writes per-expert dense weights, both load them."""
    exports = [{k: v for k, v in e.items() if k.startswith(("q_", "k_", "v_", "o_"))}
               for e in moe["exports"]]
    jck.save_paro_checkpoint(tmp_path / "d", moe["jp"], JCFG, exports)
    save_paro_checkpoint(tmp_path / "p", moe["tp"], CFG, exports)
    assert (tmp_path / "p" / "model.safetensors").read_bytes() == \
        (tmp_path / "d" / "model.safetensors").read_bytes()
    jl, tl = _load_both(tmp_path / "d")
    assert isinstance(tl[0]["layers"][0]["mlp"]["experts"], dict)
    _logits_and_tokens(jl, tl, moe["toks"])


def test_mixtral_layout_loads_the_same(moe, tmp_path):
    """An HF Mixtral directory (block_sparse_moe.gate, experts.{e}.{w1,w3,w2})
    written here: both packages load it into stacked dense experts."""
    jp = moe["jp"]
    cfg = dict(model_type="mixtral", vocab_size=512, hidden_size=256, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
               num_local_experts=8, num_experts_per_tok=2, rms_norm_eps=1e-6,
               rope_theta=10000.0, tie_word_embeddings=True)
    tensors = {"model.embed_tokens.weight": np.asarray(jp["embed_tokens"]),
               "model.norm.weight": np.asarray(jp["norm"])}
    for li, lp in enumerate(jp["layers"]):
        b = f"model.layers.{li}"
        for n in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{b}.{n}.weight"] = np.asarray(lp[n])
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            tensors[f"{b}.self_attn.{n}.weight"] = np.asarray(lp[n].w).T
        mlp = lp["mlp"]
        tensors[f"{b}.block_sparse_moe.gate.weight"] = np.asarray(mlp["router"].w).T
        for e in range(8):
            for pn, w in (("gate_proj", "w1"), ("up_proj", "w3"), ("down_proj", "w2")):
                tensors[f"{b}.block_sparse_moe.experts.{e}.{w}.weight"] = \
                    np.asarray(mlp["experts"][pn][e]).T
    (tmp_path / "mx").mkdir()
    write_safetensors(tmp_path / "mx" / "model.safetensors",
                      {k: torch.from_numpy(np.array(v)) for k, v in tensors.items()})
    (tmp_path / "mx" / "config.json").write_text(json.dumps(cfg))
    jl, tl = _load_both(tmp_path / "mx")
    assert tl[1].model_type == "mixtral" and tl[1].num_experts == 8 and tl[1].qk_norm is False
    assert sorted(tl[0]["layers"][0]["mlp"]) == ["experts", "router"]
    _logits_and_tokens(jl, tl, moe["toks"])


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4 * n, n)) @ (rng.normal(size=(n, n)) / np.sqrt(n) + 0.5 * np.eye(n))
    return (x.T @ x).astype(np.float32)


@pytest.mark.parametrize("hadamard", [False, True])
def test_gptq_moe_codes_match_jax(moe, hadamard):
    ex = moe["jp"]["layers"][0]["mlp"]["experts"]
    H, I = ex["gate_proj"].shape[1:]
    h_gu, h_d = _spd(H, 1), _spd(I, 2)
    kw = dict(n_bits=4, group_size=128, percdamp=0.01, hadamard=hadamard)
    jrun, jexp = j_gptq_moe(ex, jnp.asarray(h_gu), jnp.asarray(h_d), rot_dtype=jnp.float32, **kw)
    texp_in = moe["tp"]["layers"][0]["mlp"]["experts"]
    trun, texp = _gptq_moe(texp_in, torch.from_numpy(h_gu), torch.from_numpy(h_d),
                           rot_dtype=torch.float32, **kw)
    assert sorted(texp) == sorted(jexp)
    for p in ("gate", "up", "down"):
        a, b = np.asarray(jexp[p]["q"]), texp[p]["q"]
        assert a.shape == b.shape and b.dtype == np.int32
        assert (a != b).mean() <= 1e-3, (p, (a != b).mean())
        assert np.abs(a.astype(np.int64) - b).max() <= 1
    for k in ("gate_up_theta", "gate_up_pairs", "down_theta", "down_pairs",
              "gate_up_inv_channel_scales", "down_inv_channel_scales"):
        np.testing.assert_array_equal(texp[k], np.asarray(jexp[k]), k)
    assert isinstance(trun, QuantizedMoEExperts)
    assert np.abs(trun.gate_up_rot.numpy() - np.asarray(jrun.gate_up_rot)).max() <= 1e-6


def test_gptq_model_matches_jax_and_beats_rtn(moe):
    tokens = np.random.default_rng(9).integers(0, 512, (8, 64)).astype(np.int32)
    jq_, jexp = j_gptq_model(moe["jp"], JCFG, tokens, batch_size=4, rot_dtype=jnp.float32)
    tq_, texp = gptq_quantize_model(moe["tp"], CFG, tokens, batch_size=4,
                                    rot_dtype=torch.float32, device="cpu")
    for li, lp in enumerate(tq_["layers"]):
        assert sorted(texp[li]) == sorted(jexp[li]) and "mlp.experts" in texp[li]
        assert isinstance(lp["mlp"]["experts"], QuantizedMoEExperts)
        assert isinstance(lp["mlp"]["shared_expert"]["gate_proj"], QuantizedLinear)
        assert isinstance(lp["mlp"]["shared_expert_gate"], td.DenseLinear)
    # layer 0 sees the same inputs in both packages: its codes agree
    for name, e in texp[0].items():
        if name == "mlp.experts":
            pairs = [(e[p]["q"], np.asarray(jexp[0][name][p]["q"])) for p in ("gate", "up", "down")]
        else:
            pairs = [(e["q"], np.asarray(jexp[0][name]["q"]))]
        for a, b in pairs:
            assert (a != b).mean() <= 1e-3 and np.abs(a.astype(np.int64) - b).max() <= 1, name
    toks = torch.from_numpy(tokens)
    ref = td.model_forward(moe["tp"], CFG, toks)[0].numpy()
    err = float(np.mean((td.model_forward(tq_, CFG, toks)[0].numpy() - ref) ** 2))
    rtn = quantize_model_rtn(moe["tp"], CFG, rot_dtype=torch.float32, device="cpu")
    assert err < float(np.mean((td.model_forward(rtn, CFG, toks)[0].numpy() - ref) ** 2))
