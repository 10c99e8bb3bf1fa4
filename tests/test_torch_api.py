"""The port's HTTP server against JAX's on the CPU.

The same requests go to JAX's `Server` (aiohttp, driven through aiohttp's
TestClient as tests/test_serve.py does) and to the port's `Server`, both
through `Server.handle` directly and over a loopback socket. Both servers
front Engines on the same W4 weights of the `tiny` preset (f32, through
params_from_jax, as test_torch_engine.py), each on its own thread, with the
byte-level tokenizer of scripts/make_byte_tokenizer.py (or none, for the
token-ids-only protocol). Greedy answers must be the same JSON with `id` and
`created` left out, logprobs within LP_TOL; errors the same status and
text. Sampled requests draw differently in the two packages
(test_torch_engine.py), so for them only lengths and finish reasons are
compared, beside the port's own seed reproducibility.
"""

import asyncio
import http.client
import importlib.util
import json
import socket
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from paroquant_tpu.serve.api import Server as JServer
from paroquant_tpu.serve.engine import Engine as JEngine
from paroquant_tpu.serve.sampling import SamplingParams as JSP
from paroquant_tpu_torch.serve import Engine, SamplingParams
from paroquant_tpu_torch.serve.api import Server
from test_torch_engine import CFG, JCFG, LP_TOL, _models

ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(max_batch=4, max_len=128, page_size=8, quant_mode="xla")
TRANSPORTS = ("direct", "socket")


def byte_tokenizer(path):
    spec = importlib.util.spec_from_file_location(
        "make_byte_tokenizer", ROOT / "scripts" / "make_byte_tokenizer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_byte_tokenizer(path)
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(path))


def _pair(tok, **kw):
    jp, tp = _models()
    kw = {**ENGINE_KW, **kw}
    je = JEngine(jp, JCFG, tok, cache_dtype=jnp.float32, **kw)
    te = Engine(tp, CFG, tok, cache_dtype=torch.float32, device="cpu", **kw)
    return je, te


class JClient:
    """JAX's Server under aiohttp's TestClient, on one event loop."""

    def __init__(self, server, loop):
        self.loop = loop
        self.client = TestClient(TestServer(server.app), loop=loop)
        loop.run_until_complete(self.client.start_server())

    def call(self, method, path, body=None):
        async def go():
            r = await self.client.request(method, path, json=body)
            return r.status, dict(r.headers), await r.read()

        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory, loop):
    """{"tok": ..., "ids": ...}: (JAX client, port server, port URL) with the
    byte tokenizer and without one, engines running."""
    tok = byte_tokenizer(tmp_path_factory.mktemp("tok"))
    out, engines, ctxs = {}, [], []
    for name, t in (("tok", tok), ("ids", None)):
        je, te = _pair(t)
        engines += [je, te]
        ts = Server(te, "tiny")
        ctx = ts.serving()
        out[name] = (JClient(JServer(je, "tiny"), loop), ts, ctx.__enter__())
        ctxs.append(ctx)
    for e in engines:
        e.start()
    yield out
    for jc, _, _ in out.values():
        jc.close()
    for ctx in ctxs:
        ctx.__exit__(None, None, None)
    for e in engines:
        e.stop()


def t_call(ts, url, transport, method, path, body=None):
    if transport == "direct":
        resp = ts.handle(method, path, None if body is None else json.dumps(body).encode())
        data = resp.body if resp.chunks is None else b"".join(resp.chunks)
        return resp.status, resp.headers, data
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _strip(obj):
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


def sse_events(data: bytes) -> list:
    events = []
    for block in data.decode().split("\n\n"):
        if not block:
            continue
        assert block.startswith("data: "), block
        payload = block[len("data: "):]
        events.append(payload if payload == "[DONE]" else _strip(json.loads(payload)))
    return events


def assert_same(got, want, path="$"):
    """Equal JSON, floats within LP_TOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert got is not None and want is not None, path
        assert abs(got - want) <= LP_TOL, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def both(servers, variant, transport, method, path, body=None):
    jc, ts, url = servers[variant]
    return jc.call(method, path, body), t_call(ts, url, transport, method, path, body)


def _prompts():
    rng = np.random.default_rng(31)
    return [rng.integers(0, CFG.vocab_size, n).tolist() for n in (5, 12, 20)]


GREEDY = dict(temperature=0.0, max_tokens=8)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("variant", ("tok", "ids"))
def test_completions_by_token_ids_match_jax(servers, variant, transport):
    body = {"prompt_token_ids": _prompts()[1], **GREEDY}
    (js_, jh, jb), (ts_, th, tb) = both(servers, variant, transport, "POST", "/v1/completions", body)
    assert ts_ == js_ == 200
    assert th["Content-Type"].startswith("application/json")
    want, got = json.loads(jb), json.loads(tb)
    assert_same(_strip(got), _strip(want))
    assert got["id"].startswith("cmpl-") and got["choices"][0]["finish_reason"] == "length"


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("variant", ("tok", "ids"))
def test_stream_matches_jax(servers, variant, transport):
    body = {"prompt_token_ids": _prompts()[2], **GREEDY, "stream": True}
    (js_, jh, jb), (ts_, th, tb) = both(servers, variant, transport, "POST", "/v1/completions", body)
    assert ts_ == js_ == 200
    assert th["Content-Type"] == "text/event-stream" and th["Cache-Control"] == "no-cache"
    got, want = sse_events(tb), sse_events(jb)
    assert got == want and got[-1] == "[DONE]"
    assert got[-2]["choices"][0]["finish_reason"] == "length"
    # the streamed tokens are the non-streamed ones
    _, ts, url = servers[variant]
    _, _, flat = t_call(ts, url, transport, "POST", "/v1/completions",
                        {k: v for k, v in body.items() if k != "stream"})
    choice = json.loads(flat)["choices"][0]
    if variant == "ids":
        assert [e["choices"][0]["token_ids"][0] for e in got[:-2]] == choice["token_ids"]
    else:
        assert "".join(e["choices"][0]["text"] for e in got[:-1]) == choice["text"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_n2_greedy_matches_jax(servers, transport):
    body = {"prompt_token_ids": _prompts()[0], "n": 2, **GREEDY}
    (js_, _, jb), (ts_, _, tb) = both(servers, "tok", transport, "POST", "/v1/completions", body)
    assert ts_ == js_ == 200
    got = json.loads(tb)
    assert_same(_strip(got), _strip(json.loads(jb)))
    a, b = got["choices"]
    assert (a["index"], b["index"]) == (0, 1) and a["token_ids"] == b["token_ids"]
    assert got["usage"]["completion_tokens"] == 2 * GREEDY["max_tokens"]


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("case", ("chat", "completions"))
def test_logprobs_match_jax(servers, transport, case):
    if case == "chat":
        path = "/v1/chat/completions"
        body = {"messages": [{"role": "user", "content": "hello there"}], "logprobs": True,
                "top_logprobs": 3, **GREEDY}
    else:
        path = "/v1/completions"
        body = {"prompt_token_ids": _prompts()[2], "logprobs": 2, **GREEDY}
    (js_, _, jb), (ts_, _, tb) = both(servers, "tok", transport, "POST", path, body)
    assert ts_ == js_ == 200
    got, want = json.loads(tb), json.loads(jb)
    assert_same(_strip(got), _strip(want))
    lp = got["choices"][0]["logprobs"]
    if case == "chat":
        assert got["object"] == "chat.completion" and got["id"].startswith("chatcmpl-")
        assert len(lp["content"]) == GREEDY["max_tokens"]
        assert all(len(e["top_logprobs"]) == 3 for e in lp["content"])
    else:
        assert len(lp["tokens"]) == len(lp["token_logprobs"]) == GREEDY["max_tokens"]
        assert all(1 <= len(d) <= 2 for d in lp["top_logprobs"])


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("variant", ("tok", "ids"))
def test_echo_scoring_matches_jax(servers, variant, transport):
    body = {"prompt_token_ids": _prompts()[2], "echo": True, "max_tokens": 0, "logprobs": 1}
    (js_, _, jb), (ts_, _, tb) = both(servers, variant, transport, "POST", "/v1/completions", body)
    assert ts_ == js_ == 200
    got = json.loads(tb)
    assert_same(_strip(got), _strip(json.loads(jb)))
    lps = got["choices"][0]["logprobs"]["token_logprobs"]
    assert lps[0] is None and len(lps) == 20 and got["usage"]["completion_tokens"] == 0


def _stop_case(servers):
    """A prompt and a 3-character stop string taken from the middle of its
    greedy answer (so it spans several tokens and chunks)."""
    _, ts, _ = servers["tok"]
    body = {"prompt": "the quick brown fox", "temperature": 0.0, "max_tokens": 24}
    text = ts.handle("POST", "/v1/completions", json.dumps(body).encode()).json()
    text = text["choices"][0]["text"]
    i = next(i for i in range(3, len(text) - 3) if "�" not in text[i:i + 3])
    stop = text[i:i + 3]
    return body, stop, text[:text.find(stop)]


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("stream", (False, True))
def test_stop_string_matches_jax(servers, transport, stream):
    body, stop, want_text = _stop_case(servers)
    body = {**body, "stop": [stop], "stream": stream}
    (js_, _, jb), (ts_, _, tb) = both(servers, "tok", transport, "POST", "/v1/completions", body)
    assert ts_ == js_ == 200
    if stream:
        got = sse_events(tb)
        assert got == sse_events(jb)
        assert "".join(e["choices"][0]["text"] for e in got[:-1]) == want_text
        assert got[-2]["choices"][0]["finish_reason"] == "stop"
    else:
        got = json.loads(tb)
        assert_same(_strip(got), _strip(json.loads(jb)))
        assert got["choices"][0]["text"] == want_text
        assert got["choices"][0]["finish_reason"] == "stop"


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_429_when_overloaded_matches_jax(loop, transport):
    je, te = _pair(None, max_queue=1)
    jb_ = je.submit([1, 2, 3], JSP(max_tokens=2, temperature=0.0))  # engines not started:
    tb_ = te.submit([1, 2, 3], SamplingParams(max_tokens=2, temperature=0.0))  # queue full
    ts = Server(te, "tiny")
    body = {"prompt_token_ids": [1, 2, 3], "max_tokens": 2, "n": 2}
    jc = JClient(JServer(je, "tiny"), loop)
    try:
        js_, jh, jbody = jc.call("POST", "/v1/completions", body)
    finally:
        jc.close()
    with ts.serving() as url:
        ts_, th, tbody = t_call(ts, url, transport, "POST", "/v1/completions", body)
    assert ts_ == js_ == 429
    assert th["Retry-After"] == jh["Retry-After"] == "1"
    assert tbody == jbody
    assert te.metrics["rejected"] == je.metrics["rejected"] == 1
    for eng, req in ((je, jb_), (te, tb_)):
        eng.cancel(req)
        while eng.step():
            pass


BAD = {
    "missing_prompt": ("/v1/completions", {"max_tokens": 2}),
    "missing_messages": ("/v1/chat/completions", {"max_tokens": 2}),
    "echo_without_max_tokens_0": ("/v1/completions", {"prompt_token_ids": [1, 2], "echo": True}),
    "n_with_stream": ("/v1/completions", {"prompt_token_ids": [1, 2], "n": 2, "stream": True}),
    "oversized_prompt": ("/v1/completions", {"prompt_token_ids": [1] * 128, "max_tokens": 2}),
    "image_without_processor": ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "x"}}]}]}),
}


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("case", sorted(BAD))
def test_400_matches_jax(servers, transport, case):
    path, body = BAD[case]
    (js_, _, jb), (ts_, _, tb) = both(servers, "tok", transport, "POST", path, body)
    assert ts_ == js_ == 400
    assert tb == jb


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_models_health_and_metrics_keys_match_jax(servers, transport):
    for path in ("/v1/models", "/health"):
        (js_, _, jb), (ts_, _, tb) = both(servers, "tok", transport, "GET", path)
        assert ts_ == js_ == 200 and json.loads(tb) == json.loads(jb)
    body = {"prompt_token_ids": _prompts()[0], **GREEDY}
    both(servers, "tok", transport, "POST", "/v1/completions", body)
    (js_, _, jb), (ts_, _, tb) = both(servers, "tok", transport, "GET", "/metrics")
    got, want = json.loads(tb), json.loads(jb)
    # JAX's tp_flash_fallback_shapes counts tensor-parallel prefills (not ported)
    assert set(got) == set(want) - {"tp_flash_fallback_shapes"}
    assert {"ttft_p50_ms", "ttft_p99_ms", "decode_tick_wall_p50_ms"} <= set(got)
    for path, method in (("/nowhere", "GET"), ("/health", "POST")):
        (js_, _, _), (ts_, _, _) = both(servers, "tok", transport, method, path, {})
        assert ts_ == js_


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_sampled_lengths_match_jax_and_seed_repeats(servers, transport):
    body = {"prompt_token_ids": _prompts()[1], "n": 2, "max_tokens": 6, "temperature": 0.9,
            "seed": 5}
    (js_, _, jb), (ts_, _, tb) = both(servers, "tok", transport, "POST", "/v1/completions", body)
    assert ts_ == js_ == 200
    got, want = json.loads(tb)["choices"], json.loads(jb)["choices"]
    assert ([(len(c["token_ids"]), c["finish_reason"]) for c in got]
            == [(len(c["token_ids"]), c["finish_reason"]) for c in want])
    _, ts, url = servers["tok"]
    again = json.loads(t_call(ts, url, transport, "POST", "/v1/completions", body)[2])["choices"]
    assert [c["token_ids"] for c in again] == [c["token_ids"] for c in got]
    assert got[0]["token_ids"] != got[1]["token_ids"]  # seeds 5 and 6


def test_image_prompts_get_501(servers):
    """Images reach the Engine now (tests/test_torch_vlm_serve.py serves
    them); this text model has no vision tower, so its Engine refuses them
    with JAX's ValueError, which the server answers with 400."""
    _, ts, _ = servers["tok"]
    body = {"prompt_token_ids": [1, 2], "pixel_values": [[0.0]]}
    r = ts.handle("POST", "/v1/completions", json.dumps(body).encode())
    assert r.status == 400 and b"no vision tower" in r.body


@pytest.mark.parametrize("body", (b"[1, 2]", b"{not json"))
def test_a_body_that_is_not_an_object_gets_400(servers, body):
    _, ts, _ = servers["tok"]
    assert ts.handle("POST", "/v1/completions", body).status == 400


def test_client_gone_mid_stream_cancels_its_request(servers):
    _, ts, _ = servers["ids"]
    eng = ts.engine
    resp = ts.handle("POST", "/v1/completions", json.dumps(
        {"prompt_token_ids": _prompts()[0], "max_tokens": 100, "temperature": 0.0,
         "stream": True}).encode())
    first = next(resp.chunks)
    assert json.loads(first[len("data: "):])["choices"][0]["token_ids"]
    resp.chunks.close()  # what the transport does when a write fails
    before = eng.metrics["tokens_generated"]
    for _ in range(200):
        if all(s.request is None for s in eng.slots):
            break
        import time

        time.sleep(0.01)
    assert all(s.request is None for s in eng.slots)
    assert eng.metrics["tokens_generated"] - before < 100


def test_concurrent_handlers_lose_no_submission(servers):
    """Many handler threads at once (more than the cores, a short switch
    interval): every request is answered and counted."""
    import sys
    import threading

    _, ts, url = servers["ids"]
    before = ts.engine.metrics["requests"]
    answers, n_threads, per = [], 24, 2
    lock = threading.Lock()

    def client(i):
        for j in range(per):
            body = {"prompt_token_ids": [i + 1, j + 2, 3], "max_tokens": 1, "temperature": 0.0}
            status, _, data = t_call(ts, url, "socket" if i % 2 else "direct", "POST",
                                     "/v1/completions", body)
            with lock:
                answers.append((status, len(json.loads(data)["choices"][0]["token_ids"])))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert answers == [(200, 1)] * (n_threads * per)
    assert ts.engine.metrics["requests"] - before == n_threads * per


def test_connections_queue_while_nothing_accepts(servers):
    """32 clients connect to a listening server whose accept loop has not
    started: each handshake completes within the listen backlog (aiohttp's
    128, as JAX's server). With the standard library's 5, the seventh
    client's SYN is dropped and it waits a second for the resend."""
    httpd = servers["ids"][1].listen("127.0.0.1", 0)
    conns = []
    try:
        for _ in range(32):
            conns.append(socket.create_connection(httpd.server_address, timeout=0.5))
    finally:
        for c in conns:
            c.close()
        httpd.server_close()
    assert len(conns) == 32
