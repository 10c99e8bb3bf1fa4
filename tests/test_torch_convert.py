"""The port's conversion path without calibration against JAX's, on the CPU:
`ops/qlinear.py::effective_weight`, `convert/rtn.py::rtn_export_*`, the save
side of `convert/checkpoint.py` and `layer_forward(..., return_taps=True)`.

Weights: f32 `init_params` of JAX's `tiny` preset (Qwen3, tied embeddings)
and of a narrow Llama (llama-2-7b's family at hidden 256, untied lm_head),
handed to the port through params_from_jax.

Tolerances. effective_weight: 1e-6 of max |We| (f32 products of the same
operands). Exports: equal. JAX's `_rtn_quantize_jit` is compiled by XLA,
which turns (max - min) / 15 into (max - min) * (1/15); the port's RTN
(`ops/quant.py::calc_scales_and_zero_points(..., jit=True)`) takes the same
product, where JAX's eager `ops/quant.py` (and the port's default) divides
(test_rtn_quantizer_is_jax_jit_not_eager). Files written from JAX's
exports: the same names, dtypes, shapes and bytes. A directory the port
writes: JAX's f32 logits within 1e-5 of max of the port's, identical greedy
tokens. Taps: 1e-5 of max.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert.rtn import _rtn_quantize_jit
from paroquant_tpu.convert.rtn import quantize_linear_rtn as j_qlin
from paroquant_tpu.convert.rtn import rtn_export_linear as j_export_linear
from paroquant_tpu.convert.rtn import rtn_export_model as j_export
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.ops import quant as jq
from paroquant_tpu.ops.qlinear import effective_weight as j_effective_weight
from paroquant_tpu_torch.convert import (load_checkpoint, rtn_export_linear, rtn_export_model,
                                         save_awq_checkpoint, save_paro_checkpoint)
from paroquant_tpu_torch.convert.checkpoint import hf_prefix
from paroquant_tpu_torch.convert.interop import _convert, params_from_jax
from paroquant_tpu_torch.convert.rtn import _rtn_quantize
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops import quant as tq
from paroquant_tpu_torch.ops.qlinear import effective_weight

NARROW_LLAMA = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=4, head_dim=64)
CONFIGS = {
    "tiny": (PRESETS["tiny"], J_PRESETS["tiny"]),
    "llama": (dataclasses.replace(PRESETS["llama-2-7b"], **NARROW_LLAMA),
              dataclasses.replace(J_PRESETS["llama-2-7b"], **NARROW_LLAMA)),
}
SAVERS = {"paro": (save_paro_checkpoint, jck.save_paro_checkpoint),
          "awq": (save_awq_checkpoint, jck.save_awq_checkpoint)}


def _models(name, seed=0):
    cfg, jcfg = CONFIGS[name]
    jp = jd.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def assert_exports_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        assert g.keys() == w.keys(), k
        for f in ("q", "scales", "zeros", "pairs", "theta", "inv_channel_scales"):
            np.testing.assert_array_equal(g[f], np.asarray(w[f]), err_msg=f"{k}.{f}")
            assert g[f].dtype == np.asarray(w[f]).dtype, (k, f)
        assert (g["n_bits"], g["group_size"]) == (w["n_bits"], w["group_size"])
        assert (g["bias"] is None) == (w["bias"] is None)


@pytest.mark.parametrize("dtype", (np.float32, np.float16))
def test_rtn_quantizer_is_jax_jit_not_eager(dtype):
    """Under jit JAX's scales are (max - min) * f32(1/15); eagerly, and in the
    port's ops/quant.py, (max - min) / 15. The port's RTN takes the jit's
    product; on f16 weights the division would move the ties' codes."""
    w = np.random.default_rng(0).normal(size=(64, 256)).astype(dtype).astype(np.float32)
    jit = [np.asarray(a) for a in _rtn_quantize_jit(jnp.asarray(w), 4, 128)]
    eager = [np.asarray(a) for a in jq.quantize_to_int(
        jnp.asarray(w), jq.calc_scales_and_zero_points(jnp.asarray(w), 128, 4), 4, 128)]
    t = torch.from_numpy(w)
    port = [a.numpy() for a in _rtn_quantize(t, 4, 128)]
    port_eager = [a.numpy() for a in tq.quantize_to_int(
        t, tq.calc_scales_and_zero_points(t, 128, 4), 4, 128)]
    for a, b, c, d in zip(port, jit, port_eager, eager):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
    assert not np.array_equal(jit[1], eager[1])
    np.testing.assert_allclose(jit[1], eager[1], rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("hadamard", (False, True))
def test_effective_weight_matches_jax(hadamard):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(256, 384)).astype(np.float32)  # [I, O]
    b = rng.normal(size=384).astype(np.float32)
    jlin = j_qlin(jd.DenseLinear(jnp.asarray(w), jnp.asarray(b)), hadamard=hadamard,
                  rot_dtype=jnp.float32)
    want = np.asarray(j_effective_weight(jlin))
    got = effective_weight(_convert(jax.tree.map(np.asarray, jlin), torch.device("cpu")))
    assert got.dtype == torch.float32 and got.shape == want.shape == (256, 384)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("hadamard", (False, True))
def test_rtn_export_linear_matches_jax(hadamard):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32)
    want = j_export_linear(jd.DenseLinear(jnp.asarray(w), jnp.asarray(b)), hadamard=hadamard)
    got = rtn_export_linear(td.DenseLinear(torch.from_numpy(w), torch.from_numpy(b)),
                            hadamard=hadamard)
    assert_exports_equal({"x": got}, {"x": want})
    np.testing.assert_array_equal(got["bias"], b)
    assert np.any(got["theta"]) == hadamard


@pytest.mark.parametrize("hadamard", (False, True))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rtn_export_model_matches_jax(name, hadamard):
    cfg, jcfg, jp, tp = _models(name)
    want = j_export(jp, jcfg, hadamard=hadamard)
    got = rtn_export_model(tp, cfg, hadamard=hadamard)
    assert len(got) == len(want) == cfg.num_hidden_layers
    for g, w in zip(got, want):
        assert_exports_equal(g, w)
        assert sorted(g) == ["k_proj", "mlp.down_proj", "mlp.gate_proj", "mlp.up_proj", "o_proj",
                             "q_proj", "v_proj"]


def _file_tensors(path):
    return load_file(str(path / "model.safetensors"))


@pytest.mark.parametrize("fmt", sorted(SAVERS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_saved_files_match_jax(tmp_path, name, fmt):
    """From JAX's exports (Hadamard RTN), both savers write the same tensors
    (names, dtypes, shapes, bytes) and an equal config.json."""
    cfg, jcfg, jp, tp = _models(name)
    exports = j_export(jp, jcfg, hadamard=True)
    t_save, j_save = SAVERS[fmt]
    t_save(tmp_path / "port", tp, cfg, exports)
    j_save(tmp_path / "jax", jp, jcfg, exports)
    got, want = _file_tensors(tmp_path / "port"), _file_tensors(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert ("lm_head.weight" in got) == (not cfg.tie_word_embeddings)
    t_cfg = json.loads((tmp_path / "port" / "config.json").read_text())
    assert t_cfg == json.loads((tmp_path / "jax" / "config.json").read_text())
    assert (tmp_path / "port" / "config.json").read_text().endswith("}\n")


def test_saved_dense_layers_and_hf_config(tmp_path):
    """Linears with no export stay dense (f16, JAX's names), and a given
    hf_config is written with the quantization_config added."""
    cfg, jcfg, jp, tp = _models("tiny")
    exports = [{k: v for k, v in e.items() if not k.startswith("mlp.")}
               for e in j_export(jp, jcfg)]
    hf = {"model_type": "qwen3", "custom": 1}
    save_paro_checkpoint(tmp_path / "port", tp, cfg, exports, hf_config=hf)
    jck.save_paro_checkpoint(tmp_path / "jax", jp, jcfg, exports, hf_config=hf)
    got, want = _file_tensors(tmp_path / "port"), _file_tensors(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    assert "model.layers.0.mlp.down_proj.weight" in got
    t_cfg = json.loads((tmp_path / "port" / "config.json").read_text())
    assert t_cfg == json.loads((tmp_path / "jax" / "config.json").read_text())
    assert t_cfg["custom"] == 1 and t_cfg["quantization_config"]["format"] == "paro-tpu"
    assert hf_prefix(3, "o_proj") == "model.layers.3.self_attn.o_proj"
    assert hf_prefix(3, "mlp.up_proj") == "model.layers.3.mlp.up_proj"
    with pytest.raises(ValueError):
        hf_prefix(0, "lm_head")


def _greedy_jax(params, cfg, prompt, n):
    return np.asarray(jd.greedy_generate(params, cfg, prompt, n, cache_dtype=jnp.float32,
                                         quant_mode="xla"))


@pytest.mark.parametrize("fmt", sorted(SAVERS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_written_checkpoint_loads_in_jax(tmp_path, name, fmt):
    """A directory the port writes (from its own Hadamard RTN exports) loads
    in JAX to the port's logits and greedy tokens."""
    cfg, jcfg, jp, tp = _models(name, seed=3)
    save = SAVERS[fmt][0]
    save(tmp_path / "ckpt", tp, cfg, rtn_export_model(tp, cfg, hadamard=True))
    jl, jlc = jck.load_checkpoint(tmp_path / "ckpt", rot_dtype=jnp.float32, dtype=jnp.float32)
    tl, tlc = load_checkpoint(tmp_path / "ckpt", rot_dtype=torch.float32, dtype=torch.float32,
                              device="cpu")
    assert dataclasses.asdict(tlc) == dataclasses.asdict(jlc)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jd.model_forward(jl, jlc, jnp.asarray(toks))
    got, _ = td.model_forward(tl, tlc, torch.from_numpy(toks))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    t_toks = td.greedy_generate(tl, tlc, toks[:, :8], 8, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(t_toks, _greedy_jax(jl, jlc, toks[:, :8], 8))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layer_taps_match_jax(name):
    cfg, jcfg, jp, tp = _models(name, seed=6)
    B, T = 2, 16
    x = np.random.default_rng(7).normal(size=(B, T, cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    for li in range(cfg.num_hidden_layers):
        jcos, jsin = jd.rope_tables_per_layer(jnp.asarray(pos), jcfg)[li]
        tcos, tsin = td.rope_tables_per_layer(torch.from_numpy(pos), cfg)[li]
        jout, _, jtaps = jd.layer_forward(
            jp["layers"][li], jnp.asarray(x), jcfg, li, jcos, jsin, jnp.asarray(pos), None,
            jnp.zeros((), jnp.int32), "xla", return_taps=True)
        tout, cache, ttaps = td.layer_forward(
            tp["layers"][li], torch.from_numpy(x), cfg, li, tcos, tsin, torch.from_numpy(pos),
            None, torch.zeros((), dtype=torch.int32), "xla", return_taps=True)
        assert cache is None and sorted(ttaps) == sorted(jtaps) == ["down", "mlp", "o", "qkv"]
        for k in jtaps:
            want = np.asarray(jtaps[k])
            assert ttaps[k].shape == want.shape, k
            assert np.abs(ttaps[k].numpy() - want).max() <= 1e-5 * np.abs(want).max(), (li, k)
        plain, _ = td.layer_forward(tp["layers"][li], torch.from_numpy(x), cfg, li, tcos, tsin,
                                    torch.from_numpy(pos), None,
                                    torch.zeros((), dtype=torch.int32), "xla")
        assert torch.equal(plain, tout)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jout)).max())


def test_moe_and_gemma3n_are_refused(tmp_path):
    """Both families, refused before, are ported. gemma3n: tiny-gemma3n's RTN
    exports are JAX's (q/k/v/o, the tail's unused k/v too, and the MLP), and
    both writers' directories load back to its config with its AltUp,
    LAuReL and per-layer modules (tests/test_torch_gemma3n_convert.py holds
    the bytes against JAX's). MoE: an MoE layer's taps (router and
    experts' input "mlp", the routed down_proj inputs "moe_down", a shared
    expert's "shared_down") match JAX's, and its RTN exports (experts left
    dense, as JAX's) are JAX's."""
    name = "tiny-gemma3n"
    gp = jd.init_params(J_PRESETS[name], jax.random.PRNGKey(7), dtype=jnp.float32)
    gt = params_from_jax(jax.tree.map(np.asarray, gp), PRESETS[name], "cpu")
    g_exp = rtn_export_model(gt, PRESETS[name])
    assert [sorted(e) for e in g_exp] == [sorted(e) for e in j_export(gp, J_PRESETS[name])]
    assert all("k_proj" in e and "mlp.down_proj" in e for e in g_exp)
    for save in (save_paro_checkpoint, save_awq_checkpoint):
        save(tmp_path / save.__name__, gt, PRESETS[name], g_exp)
        loaded, lcfg = load_checkpoint(tmp_path / save.__name__, dtype=torch.float32, device="cpu")
        assert dataclasses.replace(lcfg, quantization_items=None) == PRESETS[name]
        assert len(loaded["altup_projections"]) == 3 and "laurel" in loaded["layers"][5]
        assert type(loaded["layers"][5]["k_proj"]).__name__ == "QuantizedLinear"
    cfg = dataclasses.replace(PRESETS["tiny-moe"], shared_expert_intermediate_size=256)
    jcfg = dataclasses.replace(J_PRESETS["tiny-moe"], shared_expert_intermediate_size=256)
    jp = jd.init_params(jcfg, jax.random.PRNGKey(8), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    B, T = 2, 16
    x = np.random.default_rng(9).normal(size=(B, T, cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    jcos, jsin = jd.rope_tables_per_layer(jnp.asarray(pos), jcfg)[0]
    tcos, tsin = td.rope_tables_per_layer(torch.from_numpy(pos), cfg)[0]
    jout, _, jtaps = jd.layer_forward(jp["layers"][0], jnp.asarray(x), jcfg, 0, jcos, jsin,
                                      jnp.asarray(pos), None, jnp.zeros((), jnp.int32), "xla",
                                      return_taps=True)
    tout, _, ttaps = td.layer_forward(tp["layers"][0], torch.from_numpy(x), cfg, 0, tcos, tsin,
                                      torch.from_numpy(pos), None,
                                      torch.zeros((), dtype=torch.int32), "xla", return_taps=True)
    assert list(ttaps) == list(jtaps) == ["qkv", "o", "mlp", "moe_down", "shared_down"]
    assert ttaps["moe_down"].shape == (B * T * cfg.num_experts_per_tok, cfg.moe_intermediate_size)
    for k in jtaps:
        want = np.asarray(jtaps[k])
        assert np.abs(ttaps[k].numpy() - want).max() <= 1e-5 * np.abs(want).max(), k
    assert np.abs(tout.numpy() - np.asarray(jout)).max() <= 1e-5 * np.abs(np.asarray(jout)).max()
    want_exp, got_exp = j_export(jp, jcfg), rtn_export_model(tp, cfg)
    assert [sorted(e) for e in got_exp] == [sorted(e) for e in want_exp]
    assert all("mlp.experts" not in e for e in got_exp)
    for we, ge in zip(want_exp, got_exp):
        for n in we:
            np.testing.assert_array_equal(ge[n]["q"], np.asarray(we[n]["q"]))