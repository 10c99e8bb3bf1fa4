"""The MoE family end to end in the port against the JAX package, on the
CPU: the `tiny-moe` preset (8 experts, top 2) and a `tiny-moe` with a
shared expert of 256 (tests/test_gptq.py:221's variant). JAX's weights go
to the port through params_from_jax: dense, and W4 (Hadamard RTN of the
attention, the shared expert and the lm_head, identity-rotation RTN of the
experts, merged projections). Checked: `model_forward`, `prefill` and
teacher-forced `decode_step` logits (f32, within 1e-5 of max |logit|: the
packages differ only in the order of f32 sums), greedy tokens (identical)
through `greedy_generate`, `greedy_decode_scan`, the Generator and the
Engine (request for request, logprobs within 1e-4, the scheduler's counts
equal; its paged decode steps and prefill chunks of 16 take the gather
path, whole prefills and verify windows of 9 rows the ragged one), and the
port's own expert RTN against JAX's, code for code.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.serve.engine import Engine as JEngine
from paroquant_tpu.serve.generator import Generator as JGenerator
from paroquant_tpu.serve.sampling import SamplingParams as JSP
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.convert.rtn import quantize_model_rtn as t_rtn
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops import moe as tmoe
from paroquant_tpu_torch.ops.moe import QuantizedMoEExperts
from paroquant_tpu_torch.serve import Engine, Generator, SamplingParams

VARIANTS = {"tiny-moe": 0, "shared": 256}
TOL = 1e-5
LP_TOL = 1e-4
METRICS = ("requests", "steps", "tokens_generated", "prefix_hit_tokens", "spec_windows",
           "spec_drafted", "spec_accepted")


def _cfgs(variant):
    n = VARIANTS[variant]
    return (dataclasses.replace(J_PRESETS["tiny-moe"], shared_expert_intermediate_size=n),
            dataclasses.replace(PRESETS["tiny-moe"], shared_expert_intermediate_size=n))


@functools.lru_cache(maxsize=None)
def _models(variant, quantized=True):
    jcfg, cfg = _cfgs(variant)
    params = jd.init_params(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    if quantized:
        params = jd.merge_projections(
            j_rtn(params, jcfg, hadamard=True, quantize_lm_head=True), jcfg)
    return params, params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")


def _tokens(n, seed, b=1):
    return np.random.default_rng(seed).integers(0, 512, size=(b, n)).astype(np.int32)


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.numpy() - j).max() / np.abs(j).max())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_forward_matches_jax(variant, quantized):
    jcfg, cfg = _cfgs(variant)
    jp, tp = _models(variant, quantized)
    if quantized:
        assert isinstance(tp["layers"][0]["mlp"]["experts"], QuantizedMoEExperts)
    toks = _tokens(40, 1, b=2)  # 80 tokens x top 2: the ragged path
    jl, _ = jd.model_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = td.model_forward(tp, cfg, torch.from_numpy(toks))
    assert _rel(tl, jl) < TOL


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_logits_match(variant):
    """A 24-token prefill (ragged), then 8 teacher-forced steps of two rows
    (gather)."""
    jcfg, cfg = _cfgs(variant)
    jp, tp = _models(variant)
    toks = _tokens(32, 2, b=2)
    jc = jd.KVCache.create(jcfg, 2, 32, jnp.float32)
    tc = td.KVCache.create(cfg, 2, 32, torch.float32, device="cpu")
    jl, jc = jd.prefill(jp, jcfg, jnp.asarray(toks[:, :24]), jc)
    tl, tc = td.prefill(tp, cfg, torch.from_numpy(toks[:, :24]), tc)
    assert _rel(tl, jl) < TOL
    for i in range(24, 32):
        jl, jc = jd.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = td.decode_step(tp, cfg, torch.from_numpy(toks[:, i:i + 1]), tc)
        assert _rel(tl, jl) < TOL, i


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_tokens_identical(variant):
    jcfg, cfg = _cfgs(variant)
    jp, tp = _models(variant)
    prompt = _tokens(12, 3)
    jt = jd.greedy_generate(jp, jcfg, prompt, 16, cache_dtype=jnp.float32)
    tt = td.greedy_generate(tp, cfg, prompt, 16, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tt, jt)
    # greedy_decode_scan gives the same tokens as JAX's scan
    jc = jd.KVCache.create(jcfg, 1, 28, jnp.float32)
    tc = td.KVCache.create(cfg, 1, 28, torch.float32, device="cpu")
    jl, jc = jd.prefill(jp, jcfg, jnp.asarray(prompt), jc)
    tl, tc = td.prefill(tp, cfg, torch.from_numpy(prompt), tc)
    first = np.argmax(np.asarray(jl), -1).astype(np.int32)
    js, _ = jd.greedy_decode_scan(jp, jcfg, jnp.asarray(first), jc, 16)
    ts, _ = td.greedy_decode_scan(tp, cfg, torch.from_numpy(first), tc, 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generator_matches_jax(variant):
    jcfg, cfg = _cfgs(variant)
    jp, tp = _models(variant)
    jgen = JGenerator(jp, jcfg, max_len=128, quant_mode="xla", cache_dtype=jnp.float32)
    tgen = Generator(tp, cfg, max_len=128, quant_mode="xla", cache_dtype=torch.float32,
                     device="cpu")
    for n in (3, 17, 40):
        prompt = _tokens(n, 4 + n)[0].tolist()
        jt = jgen.generate(prompt, JSP(max_tokens=10, temperature=0.0)).token_ids
        tt = tgen.generate(prompt, SamplingParams(max_tokens=10, temperature=0.0)).token_ids
        assert tt == jt, (n, tt, jt)


def _drain(eng, reqs, max_ticks=3000):
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


ENGINE_KW = {
    # decode steps of 3 slots take the gather path (3 x top 2 <= 64), the
    # unchunked 33-token prefill the ragged one
    "plain": dict(max_batch=3, max_len=96, page_size=8),
    # verify windows of 4 slots x 9 rows take the ragged path (72 x top 2),
    # prefill chunks of 16 the gather one
    "spec_chunked": dict(max_batch=4, max_len=96, page_size=8, spec_k=8, prefill_chunk=16),
}


@pytest.mark.parametrize("setting", sorted(ENGINE_KW))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_matches_jax_engine(variant, setting, monkeypatch):
    jcfg, cfg = _cfgs(variant)
    jp, tp = _models(variant)
    kw = ENGINE_KW[setting]
    taken = {"_moe_gather": 0, "_moe_ragged": 0}
    for name in taken:
        fn = getattr(tmoe, name)

        def counted(*a, _f=fn, _n=name, **k):
            taken[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tmoe, name, counted)
    je = JEngine(jp, jcfg, quant_mode="xla", cache_dtype=jnp.float32, **kw)
    te = Engine(tp, cfg, quant_mode="xla", cache_dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 33, 12)] + [[7, 3, 9, 4] * 5]
    jreqs = [je.submit(p, JSP(max_tokens=10, temperature=0.0)) for p in prompts]
    treqs = [te.submit(p, SamplingParams(max_tokens=10, temperature=0.0)) for p in prompts]
    jout, tout = _drain(je, jreqs), _drain(te, treqs)
    assert tout == jout
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, rtol=0, atol=LP_TOL)
    assert {k: te.metrics[k] for k in METRICS} == {k: je.metrics[k] for k in METRICS}
    if "spec_k" in kw:
        assert te.metrics["spec_windows"] > 0
    assert taken["_moe_gather"] > 0 and taken["_moe_ragged"] > 0, taken
    got, want = te.score_sync(prompts[1]), je.score_sync(prompts[1])
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_rtn_matches_jax_rtn(variant, dtype_name):
    """quantize_model_rtn on the port's copy of JAX's weights: the experts'
    codes, scales and zeros (and every other tensor) bit for bit JAX's."""
    jcfg, cfg = _cfgs(variant)
    jdt = getattr(jnp, dtype_name)
    params = jd.init_params(jcfg, jax.random.PRNGKey(5), dtype=jdt)
    want = params_from_jax(jax.tree.map(np.asarray, j_rtn(params, jcfg, hadamard=True)), cfg,
                           "cpu")
    got = t_rtn(params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu"), cfg,
                hadamard=True, device="cpu")

    def leaves(tree, path=""):
        if isinstance(tree, torch.Tensor):
            yield path, tree
        elif isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}.{k}")
        elif isinstance(tree, (list, tuple)):
            names = getattr(tree, "_fields", range(len(tree)))
            for k, v in zip(names, tree):
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(tree, torch.nn.Module):
            for k, v in sorted(tree.named_buffers()):
                yield from leaves(v, f"{path}.{k}")

    lw, lg = dict(leaves(want)), dict(leaves(got))
    assert sorted(lw) == sorted(lg)
    assert any(".experts.gate_qweight" in k for k in lw)
    for k in lw:
        assert lw[k].dtype == lg[k].dtype and torch.equal(lw[k], lg[k]), k
