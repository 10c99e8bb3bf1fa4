"""The port's Engine against the JAX Engine on the CPU.

Both engines get the same W4 (Hadamard RTN, quantized lm_head, merged
projections) weights of the `tiny` preset in f32 through params_from_jax,
quant_mode "xla", and the same stream of requests. Greedy tokens must be
identical, logprobs within 1e-4, and the scheduler's counts equal. The
sampled draws of the two packages differ by design (the port hashes the
request's seed and step, JAX uses jax.random), so sampled requests are
held to port-only invariants instead.
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
from paroquant_tpu.serve import engine as j_engine_mod
from paroquant_tpu.serve.engine import Engine as JEngine
from paroquant_tpu.serve.sampling import SamplingParams as JSP
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.serve import Engine, SamplingParams
from paroquant_tpu_torch.serve.engine import EngineOverloaded

CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]
METRICS = ("requests", "steps", "tokens_generated", "prefix_hit_tokens", "spec_windows",
           "spec_drafted", "spec_accepted")
LP_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _models():
    params = jd.init_params(JCFG, jax.random.PRNGKey(21), dtype=jnp.float32)
    qp = jd.merge_projections(j_rtn(params, JCFG, hadamard=True, quantize_lm_head=True), JCFG)
    return qp, params_from_jax(jax.tree.map(np.asarray, qp), CFG, device="cpu")


def _engines(**kw):
    jp, tp = _models()
    je = JEngine(jp, JCFG, quant_mode="xla", cache_dtype=jnp.float32, **kw)
    te = Engine(tp, CFG, quant_mode="xla", cache_dtype=torch.float32, device="cpu", **kw)
    return je, te


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


def _prompts(seed, lengths, vocab=None):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab or CFG.vocab_size, n).tolist() for n in lengths]


def _stream(name):
    """(engine kwargs, [(prompt, sampling kwargs)]) of one setting."""
    g = dict(temperature=0.0)
    if name == "plain":
        p = _prompts(1, (5, 9, 17))
        return dict(max_batch=4, max_len=64, page_size=8), [
            (p[0], dict(g, max_tokens=8)), (p[1], dict(g, max_tokens=8)),
            (p[2], dict(g, max_tokens=8, repetition_penalty=1.3))]
    if name == "chunked_prefill":
        p = _prompts(2, (40, 6, 40))
        return dict(max_batch=2, max_len=128, page_size=8, prefill_chunk=16,
                    max_inflight_prefills=1), [(x, dict(g, max_tokens=12)) for x in p]
    if name == "concurrent_chunked_prefills":
        p = _prompts(3, (40, 40, 33))
        return dict(max_batch=3, max_len=128, page_size=8, prefill_chunk=16), [
            (x, dict(g, max_tokens=5)) for x in p]
    if name == "prefix_caching_eviction":
        p = _prompts(4, (20,) * 6)
        base = _prompts(5, (40,))[0]
        tail = _prompts(6, (5, 9))
        stream = p + [p[0], base + tail[0], base + tail[1], list(base), p[1]]
        return dict(max_batch=1, max_len=64, page_size=8, num_pages=12, prefix_caching=True), [
            (x, dict(g, max_tokens=4)) for x in stream]
    if name == "burst_eos":
        p = _prompts(7, (6, 11))
        stop = _probe_stop(p[0])
        return dict(max_batch=2, max_len=64, page_size=8, decode_burst=4), [
            (p[0], dict(g, max_tokens=12, stop_token_ids=(stop,))), (p[1], dict(g, max_tokens=13))]
    if name == "spec_mixed":
        p = _prompts(8, (9,))
        return dict(max_batch=3, max_len=128, page_size=8, spec_k=3), [
            ([7, 3, 9, 4] * 5, dict(g, max_tokens=12)), (p[0], dict(g, max_tokens=12)),
            ([5, 2, 8, 1] * 4, dict(temperature=0.8, top_k=16, seed=11, max_tokens=12))]
    if name == "kv_int8":
        p = _prompts(9, (5, 13))
        return dict(max_batch=3, max_len=128, page_size=8, kv_quant="int8", spec_k=3,
                    decode_burst=2), [
            (p[0], dict(g, max_tokens=8)), (p[1], dict(g, max_tokens=8)),
            ([7, 3, 9, 4] * 5, dict(g, max_tokens=10))]
    if name == "logit_bias":
        p = _prompts(10, (5, 7))
        return dict(max_batch=2, max_len=64, page_size=8, decode_burst=3, spec_k=2), [
            (p[0], dict(g, max_tokens=6, logit_bias=((7, 1e9),))),
            (p[1], dict(g, max_tokens=6, logit_bias=((3, 2.0), (9, -4.0)), top_logprobs=3)),
            ([5, 2, 8, 1] * 5, dict(g, max_tokens=6))]
    raise KeyError(name)


def _probe_stop(prompt):
    """A token whose first occurrence in the greedy stream is mid-stream."""
    _, te = _engines(max_batch=1, max_len=64, page_size=8)
    toks = te.generate_sync(prompt, SamplingParams(max_tokens=8, temperature=0.0))
    return toks[next(i for i in range(2, len(toks)) if toks[i] not in toks[:i])]


SETTINGS = ["plain", "chunked_prefill", "concurrent_chunked_prefills", "prefix_caching_eviction",
            "burst_eos", "spec_mixed", "kv_int8", "logit_bias"]


@pytest.mark.parametrize("name", SETTINGS)
def test_torch_engine_matches_jax_engine(name):
    kw, stream = _stream(name)
    je, te = _engines(**kw)
    jreqs = [je.submit(p, JSP(**s)) for p, s in stream]
    treqs = [te.submit(p, SamplingParams(**s)) for p, s in stream]
    jout, tout = _drain(je, jreqs), _drain(te, treqs)
    for i, ((p, s), jr, tr) in enumerate(zip(stream, jreqs, treqs)):
        if s.get("temperature", 1.0) > 0:  # sampled: other draws, same length
            assert len(tout[i]) == len(jout[i]) == s["max_tokens"], i
            continue
        assert tout[i] == jout[i], (name, i)
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, rtol=0, atol=LP_TOL)
        assert len(tr.top_logprobs) == len(jr.top_logprobs)
        for ta, ja in zip(tr.top_logprobs, jr.top_logprobs):
            assert [t for t, _ in ta] == [t for t, _ in ja]
            np.testing.assert_allclose([lp for _, lp in ta], [lp for _, lp in ja], atol=LP_TOL)
    assert {k: te.metrics[k] for k in METRICS} == {k: je.metrics[k] for k in METRICS}
    # accounting: every page is free or idle-cached, none referenced
    assert len(te.free_pages) + len(te.cached_idle) == te.cache.num_pages - 1
    assert all(r == 0 for r in te.page_refs.values())
    if name == "prefix_caching_eviction":
        assert te.metrics["prefix_hit_tokens"] > 0
    if name in ("spec_mixed", "kv_int8"):
        assert te.metrics["spec_accepted"] > 0


def test_torch_engine_score_sync_matches_jax():
    je, te = _engines(max_batch=1, max_len=64, page_size=8)
    for prompt in _prompts(12, (9, 30)):
        got, want = te.score_sync(prompt), je.score_sync(prompt)
        assert got[0] is None and want[0] is None and len(got) == len(want)
        np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=LP_TOL)
    assert te.score_sync([3]) == [None]


def test_torch_engine_prefix_hash_collision_safe(monkeypatch):
    """Forced hash collisions between different blocks never serve another
    prompt's pages; the true repeat still hits."""
    from paroquant_tpu_torch.serve import engine as t_engine_mod

    monkeypatch.setattr(t_engine_mod, "_block_hash", lambda h, block: 42)
    monkeypatch.setattr(j_engine_mod, "_block_hash", lambda h, block: 42)
    prompts = _prompts(13, (20,) * 3)
    prompts.append(list(prompts[0]))
    je, te = _engines(max_batch=1, max_len=64, page_size=8, prefix_caching=True)
    sp = dict(max_tokens=5, temperature=0.0)
    got = [te.generate_sync(p, SamplingParams(**sp)) for p in prompts]
    want = [je.generate_sync(p, JSP(**sp)) for p in prompts]
    assert got == want
    assert te.metrics["prefix_hit_tokens"] == je.metrics["prefix_hit_tokens"] > 0


# ---------------------------------------------------------------------------
# Port-only invariants
# ---------------------------------------------------------------------------


def _port_engine(**kw):
    _, tp = _models()
    base = dict(max_batch=3, max_len=128, page_size=8, quant_mode="xla")
    base.update(kw)
    return Engine(tp, CFG, cache_dtype=torch.float32, device="cpu", **base)


def test_sampled_request_independent_of_batch_and_seeded():
    sp = SamplingParams(max_tokens=8, temperature=0.9, top_p=0.9, top_k=20, seed=7)

    def run(extra_load, **kw):
        eng = _port_engine(**kw)
        req = eng.submit([3, 1, 4, 1, 5], sp)
        if extra_load:
            eng.submit([9, 9, 2], SamplingParams(max_tokens=10, temperature=0.7, seed=123))
            eng.submit([7, 3, 9, 4] * 5, SamplingParams(max_tokens=10, temperature=0.0))
        return _drain(eng, [req])[0]

    alone = run(False)
    assert run(False) == alone  # the same seed again
    assert run(True) == alone  # other requests in the batch
    assert run(True, decode_burst=3, spec_k=3, prefix_caching=True) == alone
    assert run(False, decode_burst=4) == alone
    other = _drain(*(lambda e: (e, [e.submit([3, 1, 4, 1, 5], dataclasses.replace(sp, seed=8))]))(
        _port_engine()))[0]
    assert other != alone and len(other) == 8


def test_top_k_one_equals_greedy():
    prompt = [2, 7, 1, 8, 2, 8]
    eng = _port_engine()
    greedy = eng.generate_sync(prompt, SamplingParams(max_tokens=8, temperature=0.0))
    top1 = eng.generate_sync(prompt, SamplingParams(max_tokens=8, temperature=1.3, top_k=1,
                                                    seed=5))
    assert top1 == greedy


def test_cancel_frees_slot_and_pages():
    eng = _port_engine(max_batch=1, max_len=64)
    free_before = len(eng.free_pages)
    req = eng.submit([3, 1, 4, 1, 5], SamplingParams(max_tokens=40, temperature=0.0))
    for _ in range(3):
        eng.step()
    assert eng.slots[0].request is req
    eng.cancel(req)
    eng.step()
    kinds = []
    while not req.out_queue.empty():
        kinds.append(req.out_queue.get_nowait()[0])
    assert kinds[-1] == "done" and len(kinds) - 1 < 40
    assert eng.slots[0].request is None and len(eng.free_pages) == free_before
    assert (eng.page_table[0] == eng.trash_page).all()
    # cancelled while still queued: done without decoding
    blocker = eng.submit([5, 5, 5], SamplingParams(max_tokens=30, temperature=0.0))
    eng.step()
    queued = eng.submit([1, 2, 3], SamplingParams(max_tokens=5, temperature=0.0))
    eng.cancel(queued)
    eng.step()
    assert queued.out_queue.get_nowait()[0] == "done"
    eng.cancel(blocker)
    eng.step()
    assert len(eng.generate_sync([2, 7, 1], SamplingParams(max_tokens=4, temperature=0.0))) == 4
    assert len(eng.free_pages) == free_before


def test_max_queue_raises_engine_overloaded():
    eng = _port_engine(max_batch=1, max_len=64, max_queue=2)
    sp = SamplingParams(max_tokens=3, temperature=0.0)
    reqs = [eng.submit([1, 2, 3], sp), eng.submit([1, 2, 3], sp)]
    with pytest.raises(EngineOverloaded):
        eng.submit([1, 2, 3], sp)
    assert eng.metrics["rejected"] == 1
    assert all(len(t) == 3 for t in _drain(eng, reqs))
    assert eng.generate_sync([1, 2, 3], sp)  # accepted again once drained


def test_submit_rejects_oversized_and_later_slices():
    eng = _port_engine(max_batch=1, max_len=32)
    with pytest.raises(ValueError):
        eng.submit(list(range(30)), SamplingParams(max_tokens=10))
    # a model with no vision tower refuses images with JAX's ValueError
    with pytest.raises(ValueError, match="no vision tower"):
        eng.submit([1, 2], SamplingParams(max_tokens=2), pixel_values=np.zeros((1, 3, 4, 4)))
    with pytest.raises(NotImplementedError, match="§A 7"):
        _port_engine(mesh=object())


def test_engine_stats_and_quant_mode_default():
    eng = _port_engine(max_batch=1, max_len=64, decode_burst=4, quant_mode=None)
    assert eng.quant_mode == "xla" and eng.prefill_attn == "einsum"
    req_toks = eng.generate_sync([5, 6, 7], SamplingParams(max_tokens=10, temperature=0.0))
    assert len(req_toks) == 10
    stats = eng.step_time_stats()
    assert stats["decode_tick_samples"] >= 3 and "decode_step_device_ms_est" in stats
    assert eng.ttft_stats()["ttft_samples"] == 1
