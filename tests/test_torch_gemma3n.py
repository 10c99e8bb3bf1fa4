"""The gemma3n model in the port against the JAX package and against
transformers' Gemma3nForCausalLM, on the CPU.

Model: tests/test_gemma3n.py's HF_CFG (6 layers, 4 sliding and 2 full, the
last two a shared-KV tail reading layers 3 and 2; AltUp of 4, LAuReL rank 8,
per-layer inputs of 16, sparsity 0.95 on layers 0-1), its weights from a
seeded transformers model (AltUp coefficients and correct_output_scale
perturbed, as there) through JAX's params to the port (`params_from_jax`).

Checked: every function of `models/gemma3n.py` against JAX's in f32 within
1e-5 of the reference's max |value|; prefill logits against JAX and against
transformers (use_cache=True, so the tail reads its source layers) within
JAX's 2e-4 of max |logit|, cached and uncached; incremental decode against
the full forward; greedy tokens equal to transformers' and JAX's; the flash
path (K3's plain version on the CPU) against the einsum one and K3's plain
version against the Pallas kernel in interpret mode at a tail layer's
shapes; a bf16 model's embedding and per-layer inputs bit for bit JAX's,
its AltUp stack within one bf16 ulp and its logits within BF16_TOL of max
|logit| of JAX's (XLA keeps f32 between fused bf16 ops where torch rounds
each, so bf16 logits are held looser than f32); `init_params`' tree
against JAX's; and the E4B config of chip_smoke.py against transformers'
Gemma3nTextConfig defaults.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from paroquant_tpu.kernels.attention import flash_attention as j_flash
from paroquant_tpu.models import KVCache as JKVCache
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.models import from_hf_dict as j_from_hf_dict
from paroquant_tpu.models import gemma3n as jg
from paroquant_tpu.models.decoder import DenseLinear as JDense
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.kernels.attention import flash_attention as t_flash
from paroquant_tpu_torch.models import PRESETS, KVCache, from_hf_dict, init_params
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.models import gemma3n as tg

HF_CFG = dict(
    model_type="gemma3n_text", vocab_size=128, vocab_size_per_layer_input=128, hidden_size=64,
    hidden_size_per_layer_input=16, intermediate_size=[96] * 6, num_hidden_layers=6,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
    rope_theta=1_000_000.0, rope_local_base_freq=10_000.0, sliding_window=8,
    layer_types=["sliding_attention", "sliding_attention", "full_attention",
                 "sliding_attention", "sliding_attention", "full_attention"],
    num_kv_shared_layers=2, altup_num_inputs=4, altup_active_idx=0, altup_coef_clip=120.0,
    altup_correct_scale=True, laurel_rank=8,
    activation_sparsity_pattern=[0.95, 0.95, 0.0, 0.0, 0.0, 0.0], final_logit_softcapping=30.0,
    hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True, attention_bias=False,
    max_position_embeddings=256,
)
VP = HF_CFG["vocab_size_per_layer_input"]
TOL = 2e-4  # whole models: JAX's HF parity bound (tests/test_gemma3n.py)
FN_TOL = 1e-5  # single functions, f32
BF16_TOL = 5e-2  # bf16 logits against JAX's bf16 (test_gemma3n_bf16_matches_jax)
j_forward = jax.jit(jd.model_forward, static_argnames=("config", "quant_mode", "attn_mode"))


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max() / max(np.abs(j).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _hf_tree(hf):
    """JAX's params for a transformers Gemma3nForCausalLM (tests/test_gemma3n.py's mapping)."""
    def a(t):
        return jnp.asarray(t.detach().float().numpy())

    def lin(mod):
        return JDense(a(mod.weight).T, None)

    m = hf.model
    params = {
        "embed_tokens": a(m.embed_tokens.weight),
        "embed_tokens_per_layer": a(m.embed_tokens_per_layer.weight),
        "per_layer_model_projection": lin(m.per_layer_model_projection),
        "per_layer_projection_norm": a(m.per_layer_projection_norm.weight),
        "altup_projections": [lin(p) for p in m.altup_projections],
        "altup_unembed_projections": [lin(p) for p in m.altup_unembed_projections],
        "norm": a(m.norm.weight),
        "layers": [],
    }
    for layer in m.layers:
        at = layer.self_attn
        params["layers"].append({
            "input_layernorm": a(layer.input_layernorm.weight),
            "post_attention_layernorm": a(layer.post_attention_layernorm.weight),
            "pre_feedforward_layernorm": a(layer.pre_feedforward_layernorm.weight),
            "post_feedforward_layernorm": a(layer.post_feedforward_layernorm.weight),
            "q_proj": lin(at.q_proj), "k_proj": lin(at.k_proj), "v_proj": lin(at.v_proj),
            "o_proj": lin(at.o_proj), "q_norm": a(at.q_norm.weight), "k_norm": a(at.k_norm.weight),
            "mlp": {"gate_proj": lin(layer.mlp.gate_proj), "up_proj": lin(layer.mlp.up_proj),
                    "down_proj": lin(layer.mlp.down_proj)},
            "altup": {"correct_output_scale": a(layer.altup.correct_output_scale),
                      "correction_coefs": lin(layer.altup.correction_coefs),
                      "prediction_coefs": lin(layer.altup.prediction_coefs),
                      "modality_router": lin(layer.altup.modality_router),
                      "router_norm": a(layer.altup.router_norm.weight)},
            "laurel": {"linear_left": lin(layer.laurel.linear_left),
                       "linear_right": lin(layer.laurel.linear_right),
                       "post_laurel_norm": a(layer.laurel.post_laurel_norm.weight)},
            "per_layer_input_gate": lin(layer.per_layer_input_gate),
            "per_layer_projection": lin(layer.per_layer_projection),
            "post_per_layer_input_norm": a(layer.post_per_layer_input_norm.weight),
        })
    return params


@pytest.fixture(scope="module")
def model():
    from transformers.models.gemma3n import Gemma3nForCausalLM, Gemma3nTextConfig

    torch.manual_seed(0)
    hf_cfg = Gemma3nTextConfig(**{k: v for k, v in HF_CFG.items() if k != "model_type"})
    hf = Gemma3nForCausalLM(hf_cfg).eval().float()
    with torch.no_grad():
        for layer in hf.model.layers:
            layer.altup.correct_output_scale.normal_(1.0, 0.1)
            layer.altup.correction_coefs.weight.normal_(0.0, 0.2)
            layer.altup.prediction_coefs.weight.normal_(0.0, 0.2)
    jparams = _hf_tree(hf)
    jcfg, cfg = j_from_hf_dict(HF_CFG), from_hf_dict(HF_CFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return hf, jparams, jcfg, tparams, cfg


def _hf_logits(hf, ids):
    with torch.no_grad():
        return hf(torch.tensor(ids, dtype=torch.int64), use_cache=True).logits.float().numpy()


def _inputs(cfg, seed, B=2, T=12):
    rng = np.random.default_rng(seed)
    H, A = cfg.hidden_size, cfg.altup_num_inputs
    return rng, rng.standard_normal((A, B, T, H)).astype(np.float32)


def _rope(cfg, T, B, local, torch_side):
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    theta = cfg.rope_local_theta if local else cfg.rope_theta
    if torch_side:
        return td.rope_tables(torch.from_numpy(pos.copy()), cfg.head_dim, theta)
    return jd.rope_tables(jnp.asarray(pos), cfg.head_dim, theta)


def _attn_case(jparams, jcfg, tparams, cfg, rng, li, shared):
    """gemma3n_attention of layer li on an unmerged, uncached input; a tail
    layer (shared) reads a random source (k, v)."""
    B, T, H = 2, 12, cfg.hidden_size
    h = rng.standard_normal((B, T, H)).astype(np.float32)
    kv = None
    if shared:
        kv = tuple(rng.standard_normal((B, cfg.num_key_value_heads, T, cfg.head_dim))
                   .astype(np.float32) for _ in range(2))
    local = cfg.layer_sliding_window(li) is not None
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jo = jg.gemma3n_attention(
        jparams["layers"][li], jnp.asarray(h), jcfg, li, *_rope(jcfg, T, B, local, False),
        jnp.asarray(pos), None, jnp.zeros((), jnp.int32),
        None if kv is None else tuple(map(jnp.asarray, kv)), "xla")
    to = tg.gemma3n_attention(
        tparams["layers"][li], torch.from_numpy(h), cfg, li, *_rope(cfg, T, B, local, True),
        torch.from_numpy(pos), None, torch.zeros((), dtype=torch.int32),
        None if kv is None else tuple(map(torch.from_numpy, kv)), "xla")
    outs = [(to[0], jo[0])]
    if not shared:
        outs += [(to[2][0], jo[2][0]), (to[2][1], jo[2][1])]
    return outs


def _fn_cases(jparams, jcfg, tparams, cfg, name):
    """[(port output, JAX output)] for one function of models/gemma3n.py."""
    rng, stack = _inputs(cfg, FUNCTIONS.index(name))
    jp, tp = jparams["layers"][1], tparams["layers"][1]
    x = stack[0]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    eps = cfg.rms_norm_eps
    if name == "_rms_noscale":
        return [(tg._rms_noscale(tx, eps), jg._rms_noscale(jx, eps))]
    if name == "_norm":
        return [(tg._norm(tx, tp["input_layernorm"], eps),
                 jg._norm(jx, jp["input_layernorm"], eps))]
    if name == "_magnitude_match":
        y = 3.0 * stack[1]
        return [(tg._magnitude_match(torch.from_numpy(y), tx),
                 jg._magnitude_match(jnp.asarray(y), jx))]
    if name == "_altup_modalities":
        return [(tg._altup_modalities(tp["altup"], tx, cfg),
                 jg._altup_modalities(jp["altup"], jx, jcfg))]
    if name == "altup_predict":
        return [(tg.altup_predict(tp["altup"], torch.from_numpy(stack), cfg),
                 jg.altup_predict(jp["altup"], jnp.asarray(stack), jcfg))]
    if name == "altup_correct":
        act = stack[2]
        return [(tg.altup_correct(tp["altup"], torch.from_numpy(stack), torch.from_numpy(act), cfg),
                 jg.altup_correct(jp["altup"], jnp.asarray(stack), jnp.asarray(act), jcfg))]
    if name == "laurel_forward":
        return [(tg.laurel_forward(tp["laurel"], tx, cfg),
                 jg.laurel_forward(jp["laurel"], jx, jcfg))]
    if name == "_gaussian_topk":
        return [(tg._gaussian_topk(tx, s), jg._gaussian_topk(jx, s)) for s in (0.95, 0.5, 0.1)]
    if name == "gemma3n_mlp":  # layer 0 (sparse) and layer 2 (dense)
        return [(tg.gemma3n_mlp(tparams["layers"][li]["mlp"], tx, cfg, li, "xla"),
                 jg.gemma3n_mlp(jparams["layers"][li]["mlp"], jx, jcfg, li, "xla"))
                for li in (0, 2)]
    if name == "per_layer_inputs":  # ids past the per-layer vocab take row 0
        toks = rng.integers(0, cfg.vocab_size_per_layer_input + 40, (2, 12)).astype(np.int32)
        return [(tg.per_layer_inputs(tparams, cfg, torch.from_numpy(toks), tx),
                 jg.per_layer_inputs(jparams, jcfg, jnp.asarray(toks), jx))]
    if name == "gemma3n_qkv":
        T, B = x.shape[1], x.shape[0]
        to = tg.gemma3n_qkv(tp, tx, cfg, *_rope(cfg, T, B, True, True), "xla")
        jo = jg.gemma3n_qkv(jp, jx, jcfg, *_rope(jcfg, T, B, True, False), "xla")
        tq = tg.gemma3n_qkv(tp, tx, cfg, *_rope(cfg, T, B, True, True), "xla", need_kv=False)
        return list(zip(to, jo)) + [(tq[0], jo[0])]
    if name == "gemma3n_attention":  # sliding, full, and both tail layers
        return [pair for li, shared in ((1, False), (2, False), (4, True), (5, True))
                for pair in _attn_case(jparams, jcfg, tparams, cfg, rng, li, shared)]
    if name == "gemma3n_layer":
        B, T = x.shape[0], x.shape[1]
        pli = rng.standard_normal((B, T, cfg.hidden_size_per_layer_input)).astype(np.float32)
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
        to = tg.gemma3n_layer(tp, torch.from_numpy(stack), torch.from_numpy(pli), cfg, 1,
                              *_rope(cfg, T, B, True, True), torch.from_numpy(pos), None,
                              torch.zeros((), dtype=torch.int32), None, "xla")
        jo = jg.gemma3n_layer(jp, jnp.asarray(stack), jnp.asarray(pli), jcfg, 1,
                              *_rope(jcfg, T, B, True, False), jnp.asarray(pos), None,
                              jnp.zeros((), jnp.int32), None, "xla")
        return [(to[0], jo[0]), (to[2][0], jo[2][0]), (to[2][1], jo[2][1])]
    raise KeyError(name)


FUNCTIONS = ("_rms_noscale", "_norm", "_magnitude_match", "_altup_modalities", "altup_predict",
             "altup_correct", "laurel_forward", "_gaussian_topk", "gemma3n_mlp",
             "per_layer_inputs", "gemma3n_qkv", "gemma3n_attention", "gemma3n_layer")


@pytest.mark.parametrize("name", FUNCTIONS)
def test_gemma3n_function_matches_jax(model, name):
    _, jparams, jcfg, tparams, cfg = model
    with torch.no_grad():
        pairs = _fn_cases(jparams, jcfg, tparams, cfg, name)
    for t, j in pairs:
        assert tuple(t.shape) == tuple(j.shape)
        assert _rel(t, j) < FN_TOL, (name, _rel(t, j))


def test_gemma3n_logits_match_jax_and_transformers(model):
    hf, jparams, jcfg, tparams, cfg = model
    ids = np.random.default_rng(0).integers(0, VP, (2, 24)).astype(np.int32)
    ref = _hf_logits(hf, ids)
    jl, _ = j_forward(jparams, jcfg, jnp.asarray(ids), JKVCache.create(jcfg, 2, 32, jnp.float32))
    with torch.no_grad():
        tl, cache = td.model_forward(tparams, cfg, torch.from_numpy(ids),
                                     KVCache.create(cfg, 2, 32, torch.float32, "cpu"))
        tl2, _ = td.model_forward(tparams, cfg, torch.from_numpy(ids))  # the tail shares in-pass
    assert len(cache.k) == cfg.first_kv_shared_layer == 4
    assert int(cache.length) == 24
    for t in (tl, tl2):
        assert _rel(t, ref) < TOL and _rel(t, jl) < TOL
    assert _rel(torch.from_numpy(np.array(jl)), ref) < TOL


def test_gemma3n_decode_matches_full_forward(model):
    _, jparams, jcfg, tparams, cfg = model
    ids = np.random.default_rng(1).integers(0, VP, (1, 12)).astype(np.int32)
    with torch.no_grad():
        full, _ = td.model_forward(tparams, cfg, torch.from_numpy(ids))
        cache = KVCache.create(cfg, 1, 16, torch.float32, "cpu")
        logits, cache = td.prefill(tparams, cfg, torch.from_numpy(ids[:, :8]), cache)
        for t in range(8, 12):
            logits, cache = td.decode_step(tparams, cfg, torch.from_numpy(ids[:, t:t + 1]), cache)
    assert _rel(logits, _np(full[:, -1])) < TOL
    assert int(cache.length) == 12


def test_gemma3n_greedy_tokens_match(model):
    hf, jparams, jcfg, tparams, cfg = model
    prompt = np.random.default_rng(2).integers(0, VP, (1, 10)).astype(np.int32)
    with torch.no_grad():
        hf_out = hf.generate(torch.tensor(prompt, dtype=torch.int64), max_new_tokens=8,
                             do_sample=False, pad_token_id=0).numpy()[0, 10:]
    ours = td.greedy_generate(tparams, cfg, prompt, 8, max_len=32, cache_dtype=torch.float32,
                              device="cpu")
    theirs = jd.greedy_generate(jparams, jcfg, jnp.asarray(prompt), 8, max_len=32)
    np.testing.assert_array_equal(ours[0], hf_out)
    np.testing.assert_array_equal(ours[0], np.asarray(theirs)[0])
    toks, _ = td.greedy_decode_scan(
        tparams, cfg, torch.from_numpy(ours[0, :1].astype(np.int32)),
        td.prefill(tparams, cfg, torch.from_numpy(prompt),
                   KVCache.create(cfg, 1, 32, torch.float32, "cpu"))[1], 7)
    np.testing.assert_array_equal(toks[0].numpy(), ours[0, :7])


def test_gemma3n_flash_path_matches_einsum():
    """attn_mode="flash" at T = 128 (K3's rule: T >= 128, a multiple of 128)
    runs K3's plain version here, on every layer including the tail."""
    cfg = PRESETS["tiny-gemma3n"]
    params = init_params(cfg, 3, torch.float32, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 128)).astype(np.int32))
    from paroquant_tpu_torch.kernels import attention as at

    calls = []
    plain = at.flash_attention_plain

    def counted(*a, **k):
        calls.append(k.get("sliding_window"))
        return plain(*a, **k)

    at.flash_attention_plain = counted
    try:
        with torch.no_grad():
            fl, _ = td.model_forward(params, cfg, toks, KVCache.create(cfg, 1, 256, torch.float32, "cpu"),
                                     attn_mode="flash")
            ei, _ = td.model_forward(params, cfg, toks, KVCache.create(cfg, 1, 256, torch.float32, "cpu"))
    finally:
        at.flash_attention_plain = plain
    assert len(calls) == cfg.num_hidden_layers
    assert _rel(fl, _np(ei)) < FN_TOL


def test_gemma3n_tail_flash_plain_matches_pallas():
    """K3's plain version against the Pallas kernel (interpret mode, f32) at a
    tail layer's shapes: Hq 4 over Hkv 2, D 16, scale 1.0, a window of 8,
    the source layer's cache of 256 rows read from offset 128."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 128, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 256, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 256, 16)).astype(np.float32)
    for window, off in ((8, 128), (None, 128), (8, 0)):
        lens = np.array([off + 128], np.int32)
        ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                      scale=1.0, q_offset=off, sliding_window=window, block_q=128, block_k=128,
                      interpret=True)
        got = t_flash(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(lens), scale=1.0, q_offset=off, sliding_window=window)
        assert _rel(got, ref) < FN_TOL


def _bf16_ulps(t, j):
    """Elementwise distance in bf16 ulps between a bf16 tensor and a bf16
    JAX array (both read through f32, which holds them exactly)."""

    def ordered(a):  # the bf16 bit patterns as integers in the order of their values
        b = np.asarray(a, np.float32).view(np.int32) >> 16
        return np.where(b < 0, -(b & 0x7FFF), b).astype(np.int64)

    return np.abs(ordered(_np(t)) - ordered(j))


def test_gemma3n_bf16_matches_jax():
    """tiny-gemma3n in bf16 from JAX's init, q_norm and k_norm at
    head_dim ** -0.25 (as chip_smoke's gemma3n_random_init: unit norms make
    a random model's attention near-hard and its bf16 logits chaotic). The
    embedding and the per-layer inputs (the constants sqrt(H), sqrt(P),
    H ** -0.5 and 2 ** -0.5 rounded to bf16 before they multiply, as JAX's
    casts) bit for bit JAX's jitted ones; the AltUp stack (the f32
    `_magnitude_match` of bf16 projections) within one bf16 ulp of JAX's
    (the projection's bf16 matmul rounds differently in a few percent of
    the elements; a bf16 `_magnitude_match` is 2 ulps off). Whole models:
    XLA fuses bf16 chains in f32 where torch rounds each op, so a layer on
    identical bf16 inputs lies 0.8-1.9% (of max) from JAX's and the logits
    4.2% from JAX's bf16 logits (JAX's bf16 lie 4.1% from its f32): held
    within BF16_TOL of JAX's bf16 logits and within 1.25 times JAX's
    bf16-vs-f32 distance of the f32 ones. The router's tanh and the AltUp
    einsum, f32 islands as in JAX, round once either way on the CPU."""
    jcfg, cfg = J_PRESETS["tiny-gemma3n"], PRESETS["tiny-gemma3n"]
    jparams = jd.init_params(jcfg, jax.random.PRNGKey(7), jnp.bfloat16)
    jparams["layers"] = [dict(
        lp, altup=dict(lp["altup"], correct_output_scale=jnp.full((cfg.hidden_size,), 1.1,
                                                                   jnp.float32)),
        **{n: lp[n] * jnp.asarray(cfg.head_dim ** -0.25, lp[n].dtype) for n in ("q_norm", "k_norm")})
        for lp in jparams["layers"]]
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = j_forward(jparams, jcfg, jnp.asarray(ids))
    jl32, _ = j_forward(j32, jcfg, jnp.asarray(ids))
    with torch.no_grad():
        tl, _ = td.model_forward(tparams, cfg, torch.from_numpy(ids))
        x0 = tg.embed_gemma3n(tparams, cfg, torch.from_numpy(ids))
        pli = tg.per_layer_inputs(tparams, cfg, torch.from_numpy(ids), x0)
        stack = tg.altup_expand(tparams, x0)
    assert tl.dtype == torch.float32
    floor = _rel(torch.from_numpy(np.array(jl)), jl32)
    assert _rel(tl, jl) <= BF16_TOL and _rel(tl, jl32) <= 1.25 * floor, (_rel(tl, jl), floor)

    @jax.jit
    def j_inputs(p, toks):  # gemma3n_forward's embedding, per-layer inputs and AltUp stack
        x = jnp.take(p["embed_tokens"], toks, axis=0)
        x = x * jnp.asarray(np.sqrt(cfg.hidden_size), x.dtype)
        st = [x] + [jg._magnitude_match(jd.apply_linear(pr, x), x) for pr in p["altup_projections"]]
        return x, jg.per_layer_inputs(p, jcfg, toks, x), jnp.stack(st)

    jx0, jpli, jstack = j_inputs(jparams, jnp.asarray(ids))
    assert x0.dtype == pli.dtype == stack.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(x0), np.asarray(jx0, np.float32))
    np.testing.assert_array_equal(_np(pli), np.asarray(jpli, np.float32))
    assert _bf16_ulps(stack, jstack).max() <= 1


def test_gemma3n_init_params_tree_matches_jax():
    jcfg, cfg = J_PRESETS["tiny-gemma3n"], PRESETS["tiny-gemma3n"]
    jt = jax.eval_shape(lambda k: jd.init_params(jcfg, k, jnp.float32), jax.random.PRNGKey(0))
    tt = init_params(cfg, 0, torch.float32, "cpu")

    def shapes(node, torch_side):
        if type(node).__name__ == "DenseLinear":
            return ("DenseLinear", tuple(node.w.shape), node.b is None)
        if isinstance(node, dict):
            return {k: shapes(v, torch_side) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [shapes(v, torch_side) for v in node]
        return tuple(node.shape), str(node.dtype).replace("torch.", "")

    assert shapes(tt, True) == shapes(jt, False)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gemma3n_e4b_config_matches_transformers_defaults():
    """chip_smoke.py's Gemma 3n E4B dict gives the config that transformers'
    Gemma3nTextConfig() defaults (google/gemma-3n-E4B's text config) give."""
    from transformers.models.gemma3n import Gemma3nTextConfig

    ref = from_hf_dict(dict(Gemma3nTextConfig().to_dict(), model_type="gemma3n_text"))
    ours = _chip_smoke().gemma3n_config(35)
    assert ours == ref
    assert (ours.hidden_size, ours.num_hidden_layers, ours.vocab_size) == (2048, 35, 262400)
    assert ours.first_kv_shared_layer == 20 and ours.num_full_attn_layers == 20
    assert [ours.kv_share_source(i) for i in (20, 23, 24, 34)] == [18, 18, 19, 19]
