"""The port's EngineRouter against JAX's on the CPU.

Two port Engines under `paroquant_tpu_torch.serve.EngineRouter` and two JAX
Engines under `paroquant_tpu.serve.EngineRouter`, on the same W4 weights of
the `tiny` preset (f32, through params_from_jax, as test_torch_engine.py),
take the requests of JAX's router test (tests/test_serve.py
test_engine_router_dp): greedy tokens must be identical, logprobs within
LP_TOL, and the aggregated metrics equal. Cancel is routed to the replica
that holds the request, and score_sync works through the router.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.serve import EngineRouter as JRouter
from paroquant_tpu.serve.engine import Engine as JEngine
from paroquant_tpu.serve.sampling import SamplingParams as JSP
from paroquant_tpu_torch.serve import Engine, EngineRouter, SamplingParams
from test_torch_engine import CFG, JCFG, LP_TOL, _models

ENGINE_KW = dict(max_batch=2, max_len=64, page_size=8, quant_mode="xla")


def _routers():
    jp, tp = _models()
    jr = JRouter([JEngine(jp, JCFG, cache_dtype=jnp.float32, **ENGINE_KW) for _ in range(2)])
    tr = EngineRouter([Engine(tp, CFG, cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
                       for _ in range(2)])
    return jr, tr


def _collect(reqs):
    outs = []
    for r in reqs:
        out = []
        while not r.out_queue.empty():
            kind, t = r.out_queue.get_nowait()
            if kind != "done":
                out.append(int(t))
        outs.append(out)
    return outs


def _prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(0, CFG.vocab_size, n).tolist() for n in (5, 9, 7, 11)]


def _run(router, sp_cls, prompts, max_tokens=6):
    sp = sp_cls(max_tokens=max_tokens, temperature=0.0)
    reqs = [router.submit(p, sp) for p in prompts]
    for _ in range(400):
        if not router.step():
            break
    return reqs, _collect(reqs)


def test_router_matches_jax_router():
    jr, tr = _routers()
    prompts = _prompts()
    jreqs, jout = _run(jr, JSP, prompts)
    treqs, tout = _run(tr, SamplingParams, prompts)
    assert tout == jout
    for a, b in zip(treqs, jreqs):
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0, atol=LP_TOL)
    # the same least-loaded placement: each request on the same replica
    assert ([tr.engines.index(r.owner) for r in treqs]
            == [jr.engines.index(r.owner) for r in jreqs])
    assert all(e.metrics["requests"] > 0 for e in tr.engines)
    keys = set(tr.metrics)
    assert keys == set(jr.metrics) - {"tp_flash_fallback_shapes"}  # a TP-only count
    assert {k: tr.metrics[k] for k in keys} == {k: jr.metrics[k] for k in keys}
    assert tr.metrics["replicas"] == 2 and tr.metrics["requests"] == len(prompts)
    assert set(tr.ttft_stats()) == set(jr.ttft_stats())
    assert tr.ttft_stats()["ttft_samples"] == jr.ttft_stats()["ttft_samples"] == len(prompts)
    assert set(tr.step_time_stats()) <= set(jr.step_time_stats()) | {
        "decode_step_device_ms_est", "decode_dispatch_overhead_ms_est"}


def test_router_matches_single_engine_and_jax_generate_sync():
    _, tp = _models()
    jr, tr = _routers()
    prompts = _prompts()
    ref = Engine(tp, CFG, cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
    sp = SamplingParams(max_tokens=6, temperature=0.0)
    want = [ref.generate_sync(p, sp) for p in prompts]
    assert [tr.generate_sync(p, sp) for p in prompts] == want
    assert [jr.generate_sync(p, JSP(max_tokens=6, temperature=0.0)) for p in prompts] == want


def test_router_cancel_goes_to_owner():
    jr, tr = _routers()
    prompt = _prompts()[0]
    kinds = {}
    for name, router, sp_cls in (("jax", jr, JSP), ("port", tr, SamplingParams)):
        busy = router.submit(prompt, sp_cls(max_tokens=40, temperature=0.0))
        long_req = router.submit(prompt, sp_cls(max_tokens=40, temperature=0.0))
        assert long_req.owner is not busy.owner  # least-loaded: the other replica
        router.step()
        router.cancel(long_req)
        for _ in range(4):
            router.step()
        k = []
        while not long_req.out_queue.empty():
            k.append(long_req.out_queue.get_nowait()[0])
        kinds[name] = k
        assert k and k[-1] == "done" and len(k) - 1 < 40
        # the other replica's request still runs
        assert any(s.request is busy for s in busy.owner.slots)
        router.cancel(busy)
        for _ in range(4):
            router.step()
    assert kinds["port"] == kinds["jax"]


def test_router_score_sync_matches_jax():
    jr, tr = _routers()
    for prompt in _prompts():
        got, want = tr.score_sync(prompt), jr.score_sync(prompt)
        assert got[0] is None and want[0] is None and len(got) == len(want) == len(prompt)
        np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=LP_TOL)


def test_router_threads_and_surface():
    """start/stop run every replica's thread; the Engine surface the HTTP
    layer reads; an empty router is refused."""
    _, tr = _routers()
    assert tr.tokenizer is None and tr.max_len == 64 and tr.config is CFG
    tr.start()
    try:
        assert all(e._thread.is_alive() for e in tr.engines)
        out = tr.generate_sync(_prompts()[1], SamplingParams(max_tokens=4, temperature=0.0),
                               timeout=60)
        assert len(out) == 4
    finally:
        tr.stop()
    assert not any(e._thread.is_alive() for e in tr.engines)
    with pytest.raises(ValueError):
        EngineRouter([])


def test_router_concurrent_submits_are_counted_and_spread():
    """Submits from more threads than cores, a short switch interval: the
    router's lock keeps every count and every owner."""
    import sys
    import threading

    _, tr = _routers()
    reqs, lock = [], threading.Lock()
    sp = SamplingParams(max_tokens=2, temperature=0.0)

    def client(i):
        for j in range(25):
            r = tr.submit([i + 1, j + 1, 3], sp)
            with lock:
                reqs.append(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(reqs) == 400
    assert tr.metrics["requests"] == 400
    assert all(r.owner in tr.engines for r in reqs)
    assert sorted(e.metrics["requests"] for e in tr.engines) == [200, 200]
