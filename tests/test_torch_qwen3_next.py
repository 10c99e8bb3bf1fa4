"""The qwen3_next hybrid end to end in the port against the JAX package and
against transformers' Qwen3NextForCausalLM, on the CPU.

Models: tests/test_qwen3_next.py's HF_CFG (4 layers: 3 gated delta-net, 1
full attention with the gated q; 4 experts, top 2, and a shared expert),
its weights from a seeded transformers model through JAX's params to the
port (`params_from_jax`); and a dense-MLP hybrid of 2 layers in bf16.
Checked: prefill logits against JAX and against transformers, incremental
decode against the full forward across the 64-token chunk boundary
(T = 70), greedy tokens, the Generator with bursts, the Engine request for
request against JAX's (alone, interleaved, with decode_burst), its
refusal of spec_k, no prefix hits, and `paged_decode_step` with the slots'
conv / rec states against JAX's.

Tolerance. The f32 logits are held to 2e-4 of max |logit| (the HF parity
bound of tests/test_qwen3_next.py) rather than 1e-5: the chunked delta rule
subtracts cumulative log decays that reach a few hundred within a chunk
(A_log up to log 16) and inverts (I + L) by a triangular solve, and both
amplify the f32 roundings in which the two packages differ (XLA's dot and
LAPACK's trsm against torch's). Measured on these models (the CPU): the
port against JAX 2.9e-5 to 6.6e-5 of max |logit|, and JAX itself 2.4e-5 to
1.0e-4 from an f64 evaluation of the same model; each delta-net layer alone
stays within 1e-6 (tests/test_torch_linear_attn.py). Greedy tokens must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from paroquant_tpu.models import KVCache as JKVCache
from paroquant_tpu.models import from_hf_dict as j_from_hf_dict
from paroquant_tpu.models import init_params as j_init_params
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.models.decoder import DenseLinear as JDense
from paroquant_tpu.serve import Engine as JEngine
from paroquant_tpu.serve import Generator as JGenerator
from paroquant_tpu.serve import SamplingParams as JSP
from paroquant_tpu.serve.paged import PagedKVCache as JPaged
from paroquant_tpu.serve.paged import paged_decode_step as j_paged_step
from paroquant_tpu_torch.convert.interop import kv_cache_from_jax, paged_cache_from_jax, params_from_jax
from paroquant_tpu_torch.models import from_hf_dict
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.serve import Engine, Generator, SamplingParams
from paroquant_tpu_torch.serve.paged import paged_decode_step

HF_CFG = dict(
    model_type="qwen3_next", vocab_size=128, hidden_size=64, intermediate_size=96,
    num_hidden_layers=4, full_attention_interval=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, partial_rotary_factor=0.25, rope_theta=10000.0, rms_norm_eps=1e-6,
    linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=16,
    linear_value_head_dim=16, linear_conv_kernel_dim=4, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=32, shared_expert_intermediate_size=32, norm_topk_prob=True,
    decoder_sparse_step=1, tie_word_embeddings=False, attention_bias=False, hidden_act="silu",
)
DENSE_HYBRID = dict(model_type="qwen3_next", vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, full_attention_interval=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.25,
                    linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=16,
                    linear_value_head_dim=16, linear_conv_kernel_dim=4, tie_word_embeddings=False)
TOL = 2e-4  # see the module docstring
BF16_TOL = 3e-2
LP_TOL = 1e-3
# JAX's forward and init jitted: one compilation each (about a second) where the
# eager forward compiles its many small ops on first use (about 10 s)
j_forward = jax.jit(jd.model_forward, static_argnames=("config", "quant_mode", "attn_mode"))
j_init = jax.jit(j_init_params, static_argnames=("config", "dtype"))


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max() / np.abs(j).max())


def _t2j(t):
    return jnp.asarray(t.detach().float().numpy())


def _lin(mod):
    return JDense(_t2j(mod.weight).T, None if mod.bias is None else _t2j(mod.bias))


@pytest.fixture(scope="module")
def models():
    """(hf, jax params, jax config, port params, port config): JAX's params
    mapped from the transformers model as tests/test_qwen3_next.py maps them."""
    from transformers.models.qwen3_next import Qwen3NextConfig, Qwen3NextForCausalLM

    torch.manual_seed(0)
    hf = Qwen3NextForCausalLM(Qwen3NextConfig(
        **{k: v for k, v in HF_CFG.items() if k != "model_type"})).eval().float()
    jcfg = j_from_hf_dict(HF_CFG)
    jp = {"embed_tokens": _t2j(hf.model.embed_tokens.weight), "norm": _t2j(hf.model.norm.weight),
          "lm_head": _lin(hf.lm_head), "layers": []}
    for li, hl in enumerate(hf.model.layers):
        lp = {"input_layernorm": _t2j(hl.input_layernorm.weight),
              "post_attention_layernorm": _t2j(hl.post_attention_layernorm.weight)}
        if jcfg.layer_is_linear(li):
            la = hl.linear_attn
            lp["linear_attn"] = {
                "in_proj_qkvz": _lin(la.in_proj_qkvz), "in_proj_ba": _lin(la.in_proj_ba),
                "conv_w": _t2j(la.conv1d.weight).reshape(jcfg.linear_conv_dim,
                                                         jcfg.linear_conv_kernel_dim),
                "dt_bias": _t2j(la.dt_bias), "A_log": _t2j(la.A_log),
                "norm": _t2j(la.norm.weight), "out_proj": _lin(la.out_proj)}
        else:
            sa = hl.self_attn
            lp.update(q_proj=_lin(sa.q_proj), k_proj=_lin(sa.k_proj), v_proj=_lin(sa.v_proj),
                      o_proj=_lin(sa.o_proj), q_norm=_t2j(sa.q_norm.weight),
                      k_norm=_t2j(sa.k_norm.weight))
        mlp = hl.mlp
        lp["mlp"] = {
            "router": JDense(_t2j(mlp.gate.weight).T, None),
            "experts": {p: jnp.stack([_t2j(getattr(e, p).weight).T for e in mlp.experts])
                        for p in ("gate_proj", "up_proj", "down_proj")},
            "shared_expert": {p: _lin(getattr(mlp.shared_expert, p))
                              for p in ("gate_proj", "up_proj", "down_proj")},
            "shared_expert_gate": JDense(_t2j(mlp.shared_expert_gate.weight).T, None)}
        jp["layers"].append(lp)
    cfg = from_hf_dict(HF_CFG)
    return hf, jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"), cfg


def _tokens(n, seed, b=1):
    return np.random.default_rng(seed).integers(0, HF_CFG["vocab_size"], (b, n)).astype(np.int32)


def test_prefill_logits_match_jax_and_hf(models):
    hf, jp, jcfg, tp, cfg = models
    assert cfg.layer_types == jcfg.layer_types and cfg.attn_gate and cfg.rotary_dim == 4
    toks = _tokens(24, 0, b=2)
    jl, _ = j_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = td.model_forward(tp, cfg, torch.from_numpy(toks))
    with torch.no_grad():
        want = hf(torch.from_numpy(toks).long()).logits.float().numpy()
    assert _rel(tl, jl) < TOL
    assert _rel(tl, want) < TOL


def test_incremental_decode_across_chunk_boundary(models):
    """T = 70 crosses the 64-token chunk: a prefill of 69 then a decode step
    (the conv window and the delta state in KVCache.linear) against the full
    forward, and the cache's states against JAX's."""
    _, jp, jcfg, tp, cfg = models
    toks = _tokens(70, 3)
    full, _ = td.model_forward(tp, cfg, torch.from_numpy(toks))
    jfull, _ = j_forward(jp, jcfg, jnp.asarray(toks))
    assert _rel(full, jfull) < TOL
    tc = td.KVCache.create(cfg, 1, 80, torch.float32, device="cpu")
    assert tc.linear.rec.shape == (3, 1, 4, 16, 16) and tc.linear.conv.dtype == torch.float32
    jc = JKVCache.create(jcfg, 1, 80, jnp.float32)
    _, tc = td.model_forward(tp, cfg, torch.from_numpy(toks[:, :69]), tc)
    _, jc = j_forward(jp, jcfg, jnp.asarray(toks[:, :69]), jc)
    assert _rel(tc.linear.rec, jc.linear.rec) < TOL
    np.testing.assert_allclose(tc.linear.conv.numpy(), np.asarray(jc.linear.conv), rtol=0,
                               atol=TOL * float(np.abs(np.asarray(jc.linear.conv)).max()))
    inc, tc = td.model_forward(tp, cfg, torch.from_numpy(toks[:, 69:]), tc)
    assert _rel(inc[:, 0], full[:, 69].numpy()) < TOL
    assert int(tc.length) == 70
    # the same step from JAX's cache, converted
    inc2, _ = td.model_forward(tp, cfg, torch.from_numpy(toks[:, 69:]),
                               kv_cache_from_jax(jax.tree.map(np.asarray, jc), "cpu"))
    assert _rel(inc2[:, 0], full[:, 69].numpy()) < TOL


def test_greedy_tokens(models):
    hf, jp, jcfg, tp, cfg = models
    prompt = _tokens(8, 2)
    jt = jd.greedy_generate(jp, jcfg, prompt, 6, cache_dtype=jnp.float32)
    tt = td.greedy_generate(tp, cfg, prompt, 6, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tt, jt)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(prompt).long(), max_new_tokens=6, do_sample=False,
                           use_cache=False)[0, 8:].numpy()
    np.testing.assert_array_equal(tt[0], want)


def test_generator_with_bursts(models):
    """Bursts carry the delta-net states; lookup speculation stays off for
    hybrids (as JAX's Generator), so lookup_spec_k gives k = 0's tokens."""
    _, jp, jcfg, tp, cfg = models
    jgen = JGenerator(jp, jcfg, quant_mode="xla", cache_dtype=jnp.float32)
    prompts = [_tokens(n, 10 + n)[0].tolist() for n in (7, 15, 40)]
    want = [list(jgen.stream_generate(p, JSP(max_tokens=9, temperature=0.0))) for p in prompts]
    for kw in (dict(), dict(decode_burst=4), dict(lookup_spec_k=3)):
        tgen = Generator(tp, cfg, cache_dtype=torch.float32, device="cpu", **kw)
        got = [list(tgen.stream_generate(p, SamplingParams(max_tokens=9, temperature=0.0)))
               for p in prompts]
        assert got == want, kw
        assert tgen.spec_metrics["windows"] == 0


def _drain(eng, reqs, max_ticks=500):
    for _ in range(max_ticks):
        if not eng.step():
            break
    outs = []
    for r in reqs:
        toks = []
        while not r.out_queue.empty():
            kind, t = r.out_queue.get_nowait()
            if kind == "done":
                break
            toks.append(int(t))
        outs.append(toks)
    return outs


@pytest.mark.parametrize("setting", ["alone", "interleaved", "decode_burst"])
def test_engine_matches_jax_engine(models, setting):
    """Request for request against JAX's Engine (bucketed prefills whose
    padding the delta-net states skip; slot states installed at the finish):
    tokens equal, logprobs within LP_TOL, the scheduler's counts equal."""
    _, jp, jcfg, tp, cfg = models
    kw = dict(max_batch=2, max_len=64, page_size=8, decode_burst=3 if setting == "decode_burst" else 1)
    je = JEngine(jp, jcfg, quant_mode="xla", cache_dtype=jnp.float32, **kw)
    te = Engine(tp, cfg, quant_mode="xla", cache_dtype=torch.float32, device="cpu", **kw)
    prompts = [_tokens(n, 20 + n)[0].tolist() for n in (7, 15, 21)]
    sp, jsp = SamplingParams(max_tokens=8, temperature=0.0), JSP(max_tokens=8, temperature=0.0)
    if setting == "interleaved":
        jreqs = [je.submit(p, jsp) for p in prompts]
        treqs = [te.submit(p, sp) for p in prompts]
        jout, tout = _drain(je, jreqs), _drain(te, treqs)
    else:
        jreqs, treqs, jout, tout = [], [], [], []
        for p in prompts:
            jreqs.append(je.submit(p, jsp))
            treqs.append(te.submit(p, sp))
            jout += _drain(je, jreqs[-1:])
            tout += _drain(te, treqs[-1:])
    assert tout == jout
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, rtol=0, atol=LP_TOL)
    keys = ("requests", "steps", "tokens_generated", "prefix_hit_tokens")
    assert {k: te.metrics[k] for k in keys} == {k: je.metrics[k] for k in keys}
    np.testing.assert_allclose(te.score_sync(prompts[2])[1:], je.score_sync(prompts[2])[1:],
                               rtol=0, atol=LP_TOL)


def test_engine_chunked_prefill_carries_states(models):
    """A prompt longer than the prefill chunk (JAX's chunked prefill drops a
    hybrid's states, so here the reference is the port's unchunked Engine
    and the JAX Generator): the chunks carry the delta-net states, the last
    one padded past the prompt."""
    _, jp, jcfg, tp, cfg = models
    prompt = _tokens(45, 30)[0].tolist()
    want = list(JGenerator(jp, jcfg, quant_mode="xla", cache_dtype=jnp.float32).stream_generate(
        prompt, JSP(max_tokens=8, temperature=0.0)))
    for chunk in (16, 256):
        te = Engine(tp, cfg, max_batch=2, max_len=96, page_size=8, prefill_chunk=chunk,
                    cache_dtype=torch.float32, device="cpu")
        assert te.generate_sync(prompt, SamplingParams(max_tokens=8, temperature=0.0)) == want


def test_engine_refuses_speculation_and_prefix_hits(models):
    _, jp, jcfg, tp, cfg = models
    with pytest.raises(ValueError, match="standard-attention families only"):
        Engine(tp, cfg, spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="standard-attention families only"):
        JEngine(jp, jcfg, spec_k=2)
    te = Engine(tp, cfg, max_batch=2, max_len=96, page_size=8, prefix_caching=True,
                cache_dtype=torch.float32, device="cpu")
    prompt = _tokens(40, 31)[0].tolist()
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    first, second = te.generate_sync(prompt, sp), te.generate_sync(prompt, sp)
    assert first == second and te.metrics["prefix_hit_tokens"] == 0 and not te.prefix_map


def test_paged_decode_step_matches_jax(models):
    """Two paged steps of 3 slots from the same pool, the slots' conv / rec
    states random (a hybrid pool's conv in the pool dtype, rec f32)."""
    _, jp, jcfg, tp, cfg = models
    rng = np.random.default_rng(40)
    B, ps, maxP = 3, 8, 4
    jc = JPaged.create(jcfg, B * maxP + 1, ps, jnp.float32, batch=B)
    jc = jc._replace(
        k=jnp.asarray(rng.standard_normal(jc.k.shape).astype(np.float32)),
        v=jnp.asarray(rng.standard_normal(jc.v.shape).astype(np.float32)),
        conv=jnp.asarray(rng.standard_normal(jc.conv.shape).astype(np.float32)),
        rec=jnp.asarray(0.3 * rng.standard_normal(jc.rec.shape).astype(np.float32)))
    tc = paged_cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert tc.conv.shape == (3, B, cfg.linear_conv_dim, 3) and tc.rec.dtype == torch.float32
    table = np.arange(B * maxP, dtype=np.int32).reshape(B, maxP)
    lens = np.array([5, 17, 30], np.int32)
    toks = _tokens(B, 41)[0]
    for _ in range(2):
        jl, jc = j_paged_step(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(table),
                              jc)
        tl, tc = paged_decode_step(tp, cfg, torch.from_numpy(toks), torch.from_numpy(lens),
                                   torch.from_numpy(table), tc, attn_mode="einsum")
        assert _rel(tl, jl) < TOL
        assert _rel(tc.rec, jc.rec) < TOL and _rel(tc.conv, jc.conv) < TOL
        toks = np.argmax(np.asarray(jl), -1).astype(np.int32)
        lens = lens + 1


def test_dense_mlp_hybrid_bf16():
    """A dense-MLP hybrid of 2 layers in bf16: the logits within 3e-2 of
    JAX's, and f32 as JAX's (the stream turns f32 after the delta-net
    layer); the full-attention layer's merged gated QKV splits q | k | v."""
    jcfg, cfg = j_from_hf_dict(DENSE_HYBRID), from_hf_dict(DENSE_HYBRID)
    jp = j_init(jcfg, jax.random.PRNGKey(8), dtype=jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(20, 42)
    jl, _ = j_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = td.model_forward(tp, cfg, torch.from_numpy(toks))
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32
    assert _rel(tl, jl) < BF16_TOL
    # the port's own init builds the same layout
    own = td.init_params(cfg, 0, torch.bfloat16, "cpu")
    assert set(own["layers"][0]["linear_attn"]) == set(tp["layers"][0]["linear_attn"])
    assert own["layers"][0]["linear_attn"]["conv_w"].dtype == torch.float32
    assert own["layers"][1]["q_proj"].w.shape == (64, 2 * 4 * 16)
