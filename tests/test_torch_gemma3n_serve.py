"""Serving a gemma3n model in the port against the JAX package, on the CPU.

Model: the tiny-gemma3n preset (6 layers, the last two a shared-KV tail
reading layers 3 and 2, a sliding window of 16) with f32 weights from JAX's
init, handed to the port through `params_from_jax`.

Checked: `paged_decode_step` against JAX's over the same pool (the tail
attends over its source layers' pages, written earlier in the same step;
tests/test_serve.py's scenario), and against the contiguous forward; the
Generator with bursts (lookup speculation stays off for gemma3n, as in
JAX) against JAX's Generator; the Engine request for request against JAX's
Engine alone, interleaved, with decode bursts, chunked (a prompt longer
than the prefill chunk, one chunk a tick) and with a prefix-cache hit:
tokens equal, logprobs within LP_TOL, the scheduler's counts equal; and
the refusals of kv_quant, spec_k and the speculative verify step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.models import KVCache as JKVCache
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.serve import Engine as JEngine
from paroquant_tpu.serve import Generator as JGenerator
from paroquant_tpu.serve import SamplingParams as JSP
from paroquant_tpu.serve.paged import PagedKVCache as JPaged
from paroquant_tpu.serve.paged import paged_decode_step as j_paged_step
from paroquant_tpu.serve.paged import scatter_prefill_kv as j_scatter
from paroquant_tpu_torch.convert.interop import paged_cache_from_jax, params_from_jax
from paroquant_tpu_torch.models import PRESETS, KVCache
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.serve import Engine, Generator, SamplingParams
from paroquant_tpu_torch.serve.paged import PagedKVCache, paged_decode_step, paged_verify_step

TOL = 2e-4  # of max |logit|, f32
LP_TOL = 1e-3  # nats
j_init = jax.jit(jd.init_params, static_argnames=("config", "dtype"))
j_forward = jax.jit(jd.model_forward, static_argnames=("config", "quant_mode", "attn_mode"))


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max() / np.abs(j).max())


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = J_PRESETS["tiny-gemma3n"], PRESETS["tiny-gemma3n"]
    jp = j_init(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    # the init leaves correct_output_scale zero: give it a scale that acts
    rng = np.random.default_rng(5)
    jp["layers"] = [dict(lp, altup=dict(lp["altup"], correct_output_scale=jnp.asarray(
        rng.normal(1.0, 0.1, cfg.hidden_size).astype(np.float32)))) for lp in jp["layers"]]
    return jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"), cfg


def _tokens(n, seed, b=1):
    return np.random.default_rng(seed).integers(0, PRESETS["tiny-gemma3n"].vocab_size,
                                                (b, n)).astype(np.int32)


def test_paged_decode_step_matches_jax_and_contiguous(models):
    """A 12-token prefill scattered into pages (2, 6, 1, 4) of 8, then two
    paged steps: the port against JAX's step on the same pool, and the first
    against the contiguous forward's next-token logits."""
    jp, jcfg, tp, cfg = models
    prompt = _tokens(12, 5)
    jc = JKVCache.create(jcfg, 1, 32, jnp.float32)
    _, jc = j_forward(jp, jcfg, jnp.asarray(prompt), jc)
    ref, _ = j_forward(jp, jcfg, jnp.asarray([[7]], jnp.int32), jc)
    ps, page_ids = 8, np.array([2, 6, 1, 4], np.int32)
    pk = jnp.pad(jnp.stack([jnp.swapaxes(k[0], 0, 1)[:12] for k in jc.k]),
                 ((0, 0), (0, 4), (0, 0), (0, 0)))
    pv = jnp.pad(jnp.stack([jnp.swapaxes(v[0], 0, 1)[:12] for v in jc.v]),
                 ((0, 0), (0, 4), (0, 0), (0, 0)))
    jpool = j_scatter(jcfg, JPaged.create(jcfg, 8, ps, jnp.float32), pk, pv, jnp.asarray(page_ids))
    tpool = paged_cache_from_jax(jax.tree.map(np.asarray, jpool), "cpu")
    assert tpool.k.shape[0] == cfg.first_kv_shared_layer == 4
    own = PagedKVCache.create(cfg, 8, ps, torch.float32, device="cpu")
    assert own.k.shape == tpool.k.shape
    table = page_ids[None]
    toks, lens = np.array([7], np.int32), np.array([12], np.int32)
    for step in range(2):
        jl, jpool = j_paged_step(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                                 jnp.asarray(table), jpool)
        tl, tpool = paged_decode_step(tp, cfg, torch.from_numpy(toks), torch.from_numpy(lens),
                                      torch.from_numpy(table), tpool, attn_mode="einsum")
        assert _rel(tl, jl) < TOL
        assert _rel(tpool.k, jpool.k) < TOL and _rel(tpool.v, jpool.v) < TOL
        if step == 0:
            assert _rel(tl, np.asarray(ref)[:, -1]) < TOL
        toks = np.argmax(np.asarray(jl), -1).astype(np.int32)
        lens = lens + 1


def test_generator_with_bursts(models):
    """Bursts and the Generator's lookup speculation (off for gemma3n, as in
    JAX: lookup_spec_k gives k = 0's tokens and runs no window)."""
    jp, jcfg, tp, cfg = models
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


SETTINGS = {
    "alone": dict(lens=(7, 15, 21)),
    "interleaved": dict(lens=(7, 15, 21), interleave=True),
    "decode_burst": dict(lens=(7, 15, 21), decode_burst=3),
    # prompts past the chunk prefill one 16-token chunk a tick, the last one
    # padded past the prompt; the tail reads its sources' chunk-written rows
    "chunked": dict(lens=(45, 9, 33), prefill_chunk=16, interleave=True),
    # the second request's first 5 pages come from the prefix cache
    "prefix_hit": dict(lens=(44,), prefix=True, prefill_chunk=16),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_engine_matches_jax_engine(models, setting):
    jp, jcfg, tp, cfg = models
    s = SETTINGS[setting]
    kw = dict(max_batch=2, max_len=96, page_size=8, decode_burst=s.get("decode_burst", 1),
              prefill_chunk=s.get("prefill_chunk", 256), prefix_caching=s.get("prefix", False))
    je = JEngine(jp, jcfg, quant_mode="xla", cache_dtype=jnp.float32, **kw)
    te = Engine(tp, cfg, quant_mode="xla", cache_dtype=torch.float32, device="cpu", **kw)
    prompts = [_tokens(n, 20 + n)[0].tolist() for n in s["lens"]]
    if s.get("prefix"):
        prompts.append(prompts[0][:40] + _tokens(6, 99)[0].tolist())
    sp, jsp = SamplingParams(max_tokens=8, temperature=0.0), JSP(max_tokens=8, temperature=0.0)
    if s.get("interleave"):
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
    assert all(len(t) == 8 for t in tout)
    assert tout == jout
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, rtol=0, atol=LP_TOL)
    keys = ("requests", "steps", "tokens_generated", "prefix_hit_tokens")
    assert {k: te.metrics[k] for k in keys} == {k: je.metrics[k] for k in keys}
    if s.get("prefix"):
        assert te.metrics["prefix_hit_tokens"] == 40
    np.testing.assert_allclose(te.score_sync(prompts[-1])[1:], je.score_sync(prompts[-1])[1:],
                               rtol=0, atol=LP_TOL)


def test_engine_and_verify_refusals(models):
    jp, jcfg, tp, cfg = models
    for kw, text in ((dict(kv_quant="int8"), "kv_quant is not supported for gemma3n"),
                     (dict(spec_k=2), "standard-attention families only")):
        with pytest.raises(ValueError, match=text):
            Engine(tp, cfg, device="cpu", **kw)
        with pytest.raises(ValueError, match=text):
            JEngine(jp, jcfg, **kw)
    pool = PagedKVCache.create(cfg, 4, 8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="standard-attention families only"):
        paged_verify_step(tp, cfg, torch.zeros((1, 3), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32),
                          pool, 3)
    with pytest.raises(NotImplementedError, match="return_hidden"):
        td.model_forward(tp, cfg, torch.zeros((1, 4), dtype=torch.int32), return_hidden=True)
    cache = KVCache.create(cfg, 1, 8, torch.float32, "cpu")
    assert len(cache.k) == cfg.num_full_attn_layers == 4
