"""The port's dense decoder against the JAX package: the same W4 (Hadamard
RTN, quantized lm_head, merged projections) weights go through
params_from_jax, then prefill logits, teacher-forced decode logits and
greedy tokens are compared, on the `tiny` preset and on Gemma- and
Qwen2-style variants of it; and the port's own RTN against JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.models.config import ModelConfig as JModelConfig
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.convert.rtn import quantize_model_rtn as t_rtn
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td

CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]
T_PROMPT = 12
N_DECODE = 8
# Max abs difference over the max |logit|. f32: the two packages differ only
# in summation order (measured 1.3e-6 at the prefill). bf16: the port rounds
# to bf16 after every op, as JAX does eagerly (the eager prefill matches
# exactly); the jitted JAX decode_step fuses elementwise chains and skips
# some of those roundings -- JAX's own jitted and eager forwards of this
# model differ by 1.3e-2 -- so the bound is 3e-2.
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@functools.lru_cache(maxsize=None)
def _models(dtype_name):
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    params = jd.init_params(JCFG, jax.random.PRNGKey(0), dtype=jdt)
    qp = j_rtn(params, JCFG, hadamard=True, quantize_lm_head=True)
    qp = jd.merge_projections(qp, JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, qp), CFG, device="cpu")
    return qp, tparams


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=(1, n)).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match(dtype_name):
    jp, tp = _models(dtype_name)
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype_name)
    toks = _tokens(T_PROMPT + N_DECODE, 1)
    max_len = T_PROMPT + N_DECODE
    jc = jd.KVCache.create(JCFG, 1, max_len, jdt)
    tc = td.KVCache.create(CFG, 1, max_len, tdt, device="cpu")
    jl, jc = jd.model_forward(jp, JCFG, jnp.asarray(toks[:, :T_PROMPT]), jc, quant_mode="xla")
    tl, tc = td.model_forward(tp, CFG, torch.from_numpy(toks[:, :T_PROMPT]), tc, quant_mode="xla")
    assert _rel(tl.numpy(), jl) < TOL[dtype_name]
    for i in range(T_PROMPT, T_PROMPT + N_DECODE):  # teacher-forced decode
        jl, jc = jd.decode_step(jp, JCFG, jnp.asarray(toks[:, i : i + 1]), jc, quant_mode="xla")
        tl, tc = td.decode_step(tp, CFG, torch.from_numpy(toks[:, i : i + 1]), tc, quant_mode="xla")
        assert _rel(tl.numpy(), jl) < TOL[dtype_name], i
    assert int(tc.length) == int(jc.length) == T_PROMPT + N_DECODE


def test_greedy_tokens_identical_f32():
    jp, tp = _models("float32")
    prompt = _tokens(T_PROMPT, 2)
    jt = jd.greedy_generate(jp, JCFG, prompt, 16, cache_dtype=jnp.float32)
    tt = td.greedy_generate(tp, CFG, prompt, 16, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tt, jt)


def test_greedy_decode_scan_matches_loop():
    _, tp = _models("float32")
    prompt = torch.from_numpy(_tokens(T_PROMPT, 3))
    cache = td.KVCache.create(CFG, 1, T_PROMPT + 8, torch.float32, device="cpu")
    logits, cache = td.prefill(tp, CFG, prompt, cache)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    toks, _ = td.greedy_decode_scan(tp, CFG, first, cache, 8)
    ref = td.greedy_generate(tp, CFG, prompt.numpy(), 8, max_len=T_PROMPT + 8,
                             cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), ref)


# The other dense-family branches of the decoder: Gemma-class norms, post
# norms, GELU, per-layer sliding windows and RoPE bases, attention and final
# softcaps and query_pre_attn_scalar; Qwen2-style q/k/v biases without
# qk-norm, partial rotary and an untied lm_head.
FAMILIES = {
    "gemma3_dense": dict(model_type="gemma3_text", gemma_norm=True, post_norms=True,
                         hidden_act="gelu_pytorch_tanh", sliding_window=8,
                         sliding_window_pattern=2, rope_local_theta=10_000.0,
                         query_pre_attn_scalar=48.0, logit_softcap=30.0,
                         attn_logit_softcap=50.0),
    "qwen2_bias_partial_rope": dict(model_type="qwen2", qk_norm=False, attention_bias=True,
                                    partial_rotary_factor=0.5, tie_word_embeddings=False),
}
TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64)


def _perturbed(tree, rng):
    """Random norm weights and biases, so that those paths compute something."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.2, v.shape).astype(np.float32) if "norm" in k
                    else _perturbed(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed(v, rng) for v in tree]
    if type(tree).__name__ == "DenseLinear" and tree.b is not None:
        return type(tree)(tree.w, rng.normal(0, 0.5, tree.b.shape).astype(np.float32))
    return tree


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dense_family_logits_match(family, quantized):
    jcfg = JModelConfig(**TINY, **FAMILIES[family])
    cfg = td.ModelConfig(**TINY, **FAMILIES[family])
    params = jd.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    params = _perturbed(jax.tree.map(np.asarray, params), np.random.default_rng(6))
    if quantized:
        params = jd.merge_projections(
            j_rtn(params, jcfg, hadamard=True, quantize_lm_head=True), jcfg)
    jp = params
    tp = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    toks = _tokens(T_PROMPT + 4, 7)
    jc = jd.KVCache.create(jcfg, 1, T_PROMPT + 4, jnp.float32)
    tc = td.KVCache.create(cfg, 1, T_PROMPT + 4, torch.float32, device="cpu")
    jl, jc = jd.model_forward(jp, jcfg, jnp.asarray(toks[:, :T_PROMPT]), jc)
    tl, tc = td.model_forward(tp, cfg, torch.from_numpy(toks[:, :T_PROMPT]), tc)
    assert _rel(tl.numpy(), jl) < TOL["float32"]
    for i in range(T_PROMPT, T_PROMPT + 4):
        jl, jc = jd.decode_step(jp, jcfg, jnp.asarray(toks[:, i : i + 1]), jc)
        tl, tc = td.decode_step(tp, cfg, torch.from_numpy(toks[:, i : i + 1]), tc)
        assert _rel(tl.numpy(), jl) < TOL["float32"], i


def test_port_rtn_model_matches_jax_rtn():
    """The port's quantize_model_rtn on the same dense weights gives the JAX
    package's W4 model: qweights agree except where the rotated weight's last
    bit (cos/sin of two libms) moves a value across a rounding boundary."""
    params = jd.init_params(JCFG, jax.random.PRNGKey(8), dtype=jnp.float32)
    dense = params_from_jax(jax.tree.map(np.asarray, params), CFG, device="cpu")
    jq = jd.merge_projections(j_rtn(params, JCFG, hadamard=True, quantize_lm_head=True), JCFG)
    tq = td.merge_projections(
        t_rtn(dense, CFG, hadamard=True, quantize_lm_head=True, device="cpu"), CFG)
    for jl, tl in [(jq["lm_head"], tq["lm_head"])] + [
            (jq["layers"][i][n], tq["layers"][i][n]) for i in range(2) for n in ("qkv_proj", "o_proj")]:
        assert np.mean(tl.qweight.numpy() == np.asarray(jl.qweight)) > 0.999
        np.testing.assert_array_equal(tl.rot.to(torch.float32).numpy(), np.asarray(jl.rot, np.float32))
    toks = _tokens(T_PROMPT, 9)
    jlog, _ = jd.model_forward(jq, JCFG, jnp.asarray(toks))
    tlog, _ = td.model_forward(tq, CFG, torch.from_numpy(toks))
    assert _rel(tlog.numpy(), jlog) < TOL["float32"]  # measured 1.1e-6


def test_flash_prefill_matches_einsum():
    _, tp = _models("float32")
    toks = torch.from_numpy(_tokens(128, 4))
    out = {}
    for mode in ("einsum", "flash"):
        cache = td.KVCache.create(CFG, 1, 256, torch.float32, device="cpu")
        out[mode], _ = td.model_forward(tp, CFG, toks, cache, attn_mode=mode)
    # f32 on both sides: the flash PV product is f32, the einsum's rounds
    # probs to the (f32) cache dtype, so only summation order differs
    assert _rel(out["flash"].numpy(), out["einsum"].numpy()) < 1e-4
