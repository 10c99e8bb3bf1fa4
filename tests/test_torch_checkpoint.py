"""The port's load_checkpoint against the JAX package's, on checkpoints that
the JAX package writes: PARO-TPU (Hadamard RTN export) and HF dense."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert.rtn import rtn_export_model
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.convert.checkpoint import load_checkpoint, read_safetensors
from paroquant_tpu_torch.models import decoder as td

JCFG = J_PRESETS["tiny"]


def _write_paro(path):
    params = jd.init_params(JCFG, jax.random.PRNGKey(1), dtype=jnp.float32)
    jck.save_paro_checkpoint(path, params, JCFG, rtn_export_model(params, JCFG, hadamard=True))


def _write_hf_dense(path):
    params = jd.init_params(JCFG, jax.random.PRNGKey(2), dtype=jnp.float32)
    t = {"model.embed_tokens.weight": np.asarray(params["embed_tokens"]),
         "model.norm.weight": np.asarray(params["norm"])}
    for li, lp in enumerate(params["layers"]):
        b = f"model.layers.{li}"
        for n in ("input_layernorm", "post_attention_layernorm"):
            t[f"{b}.{n}.weight"] = np.asarray(lp[n])
        for n in ("q_norm", "k_norm"):
            t[f"{b}.self_attn.{n}.weight"] = np.asarray(lp[n])
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            t[f"{b}.self_attn.{n}.weight"] = np.asarray(lp[n].w).T
        for n in ("gate_proj", "up_proj", "down_proj"):
            t[f"{b}.mlp.{n}.weight"] = np.asarray(lp["mlp"][n].w).T
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: np.ascontiguousarray(v) for k, v in t.items()}, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(jck._config_to_hf(JCFG)))


@pytest.mark.parametrize("kind", ["paro_tpu", "hf_dense"])
def test_load_checkpoint_logits_match(tmp_path, kind):
    (_write_paro if kind == "paro_tpu" else _write_hf_dense)(tmp_path)
    jp, jcfg = jck.load_checkpoint(tmp_path, dtype=jnp.float32)
    tp, tcfg = load_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    assert tcfg == td.ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    if kind == "paro_tpu":
        assert type(tp["layers"][0]["o_proj"]).__name__ == "QuantizedLinear"
        np.testing.assert_array_equal(tp["layers"][1]["o_proj"].qweight.numpy(),
                                      np.asarray(jp["layers"][1]["o_proj"].qweight))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(1, 10)).astype(np.int32)
    jl, _ = jd.model_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = td.model_forward(tp, tcfg, torch.from_numpy(toks))
    # f32 on both sides: summation order only
    err = np.max(np.abs(tl.numpy() - np.asarray(jl))) / np.max(np.abs(np.asarray(jl)))
    assert err < 1e-5, err


def test_read_safetensors_matches_library(tmp_path):
    rng = np.random.default_rng(3)
    bf16 = np.asarray(jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32)).astype(jnp.bfloat16))
    tensors = {"a": rng.normal(size=(4, 6)).astype(np.float16),
               "b": rng.integers(0, 255, size=(7,)).astype(np.uint8),
               "c": rng.integers(-9, 9, size=(2, 2, 3)).astype(np.int16),
               "d": rng.normal(size=(5,)).astype(np.float32), "e": bf16}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    got = read_safetensors(tmp_path / "x.safetensors")
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        g = got[k].to(torch.float32).numpy() if k == "e" else got[k].numpy()
        np.testing.assert_array_equal(g, v.astype(np.float32) if k == "e" else v)
