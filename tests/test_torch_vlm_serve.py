"""Serving the Gemma3 VLM in the port against the JAX package, on the CPU.

Model: tests/test_vlm.py's tiny HF_CFG with its projector perturbed
(test_torch_vlm.py's `perturbed_projector`), f32, the weights handed to the
port through `params_from_jax`.

Checked: the Generator's greedy tokens for an image prompt equal to JAX's
Generator's, plainly, with decode bursts and with lookup speculation; the
Engine with an image request interleaved with text requests, one image
prompt longer than prefill_chunk (prefilled whole) and prefix caching on
(no image request takes or leaves a prefix-cache page): tokens equal to
the port's Generator and to JAX's Engine; the ValueErrors of a model with
no tower; the HTTP API with raw `pixel_values` and with chat image parts
through one stub processor given to both servers, tokens equal to JAX's,
and 400 without a processor; and the serve CLI over an HF-named VLM
directory with no processor files.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from aiohttp.test_utils import TestClient, TestServer

from paroquant_tpu.serve import Engine as JEngine
from paroquant_tpu.serve import Generator as JGenerator
from paroquant_tpu.serve import SamplingParams as JSP
from paroquant_tpu.serve.api import Server as JServer
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import from_hf_dict
from paroquant_tpu_torch.serve import Engine, Generator, SamplingParams
from paroquant_tpu_torch.serve.api import Server
from test_torch_vlm import perturbed_projector
from test_vlm import HF_CFG, IMAGE_TOKEN, hf_and_ours  # noqa: F401 (a module fixture)

ENGINE_KW = dict(max_batch=3, max_len=64, page_size=8, prefill_chunk=16, quant_mode="xla")


@pytest.fixture(scope="module")
def served(hf_and_ours):
    hf, jparams, jcfg = hf_and_ours
    torch.manual_seed(1)
    perturbed_projector(hf, jparams)
    cfg = from_hf_dict(HF_CFG)
    return hf, jparams, jcfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"), cfg


def _image_prompt(seed, n_text=8, repeat=1):
    """BOI, one image run of 4, EOI and text (a random block `repeat` times)."""
    rng = np.random.default_rng(seed)
    return ([248] + [IMAGE_TOKEN] * 4 + [249]
            + list(map(int, rng.integers(0, 240, n_text))) * repeat)


def _pixels(seed, n=1):
    return np.random.default_rng(seed).standard_normal((n, 3, 28, 28)).astype(np.float32)


def _drain(eng, reqs, max_ticks=400):
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
            toks.append(t)
        outs.append(toks)
    return outs


@pytest.mark.parametrize("kw", ({}, {"decode_burst": 3}, {"lookup_spec_k": 3}),
                         ids=("plain", "burst", "spec"))
def test_generator_image_tokens_match_jax(served, kw):
    _, jp, jcfg, tp, cfg = served
    prompt, px = _image_prompt(1, n_text=6, repeat=3), _pixels(1)
    want = list(JGenerator(jp, jcfg, quant_mode="xla", cache_dtype=jnp.float32).stream_generate(
        prompt, JSP(max_tokens=10, temperature=0.0), pixel_values=px))
    gen = Generator(tp, cfg, cache_dtype=torch.float32, device="cpu", **kw)
    got = list(gen.stream_generate(prompt, SamplingParams(max_tokens=10, temperature=0.0),
                                   pixel_values=px))
    assert got == want and len(got) == 10
    if "lookup_spec_k" in kw:
        assert gen.spec_metrics["windows"] > 0
    # the image reaches the tokens
    other = list(gen.stream_generate(prompt, SamplingParams(max_tokens=10, temperature=0.0),
                                     pixel_values=_pixels(2)))
    assert other != got


def test_engine_image_and_text_requests_match_generator_and_jax(served):
    """An image prompt longer than prefill_chunk (26 tokens, chunk 16), a
    short image prompt, its twin with another image (prefix caching on:
    neither reuses the first's pages), and two text prompts, one chunked."""
    _, jp, jcfg, tp, cfg = served
    rng = np.random.default_rng(3)
    long_img = _image_prompt(3, n_text=20)
    short_img = _image_prompt(4)
    text_long = list(map(int, rng.integers(0, 240, 20)))
    text = list(map(int, rng.integers(0, 240, 9)))
    jobs = [(long_img, _pixels(3)), (text_long, None), (short_img, _pixels(4)), (text, None),
            (short_img, _pixels(5))]
    sp = SamplingParams(max_tokens=6, temperature=0.0)
    gen = Generator(tp, cfg, cache_dtype=torch.float32, device="cpu")
    want = [list(gen.stream_generate(p, sp, pixel_values=px)) for p, px in jobs]
    assert want[2] != want[4]  # the twins differ by their image alone
    eng = Engine(tp, cfg, cache_dtype=torch.float32, device="cpu", prefix_caching=True,
                 **ENGINE_KW)
    got = _drain(eng, [eng.submit(p, sp, pixel_values=px) for p, px in jobs])
    assert got == want
    assert eng.metrics["prefix_hit_tokens"] == 0
    assert eng.page_tokens and all(blk[0] != 248 for blk in eng.page_tokens.values())
    jeng = JEngine(jp, jcfg, cache_dtype=jnp.float32, prefix_caching=True, **ENGINE_KW)
    jgot = _drain(jeng, [jeng.submit(p, JSP(max_tokens=6, temperature=0.0), pixel_values=px)
                         for p, px in jobs])
    assert got == jgot
    assert eng.generate_sync(short_img, sp, pixel_values=_pixels(4)) == want[2]


def test_no_vision_tower_raises_value_errors(served):
    _, _, _, tp, cfg = served
    text_only = dataclasses.replace(cfg, vision_items=None)
    sp = SamplingParams(max_tokens=2, temperature=0.0)
    with pytest.raises(ValueError, match="no vision tower; cannot take images"):
        next(Generator(tp, text_only, cache_dtype=torch.float32, device="cpu").stream_generate(
            _image_prompt(6), sp, pixel_values=_pixels(6)))
    eng = Engine(tp, text_only, cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="no vision tower; cannot serve images"):
        eng.submit(_image_prompt(6), sp, pixel_values=_pixels(6))


class StubProcessor:
    """A processor's chat-template call as the servers make it: the prompt
    of `_image_prompt(seed)` and seeded pixels, one image per image part."""

    def __init__(self, seed):
        self.seed = seed

    def apply_chat_template(self, messages, add_generation_prompt, tokenize, return_dict):
        assert add_generation_prompt and tokenize and return_dict
        n = sum(p.get("type") in ("image", "image_url") for m in messages
                if isinstance(m["content"], list) for p in m["content"])
        return {"input_ids": [_image_prompt(self.seed)], "pixel_values": _pixels(self.seed, n)}


@pytest.fixture(scope="module")
def servers(served):
    _, jp, jcfg, tp, cfg = served
    proc = StubProcessor(7)
    je = JEngine(jp, jcfg, cache_dtype=jnp.float32, **ENGINE_KW)
    te = Engine(tp, cfg, cache_dtype=torch.float32, device="cpu", **ENGINE_KW)
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(JServer(je, "vlm", proc).app), loop=loop)
    loop.run_until_complete(client.start_server())

    def j_call(path, body):
        async def go():
            r = await client.post(path, json=body)
            return r.status, await r.read()

        return loop.run_until_complete(go())

    ts, bare = Server(te, "vlm", proc), Server(te, "vlm")
    je.start()
    te.start()
    yield j_call, ts, bare, te
    je.stop()
    te.stop()
    loop.run_until_complete(client.close())
    loop.close()


def _ids(data):
    return [c["token_ids"] for c in json.loads(data)["choices"]]


def test_api_raw_pixel_values_match_jax(servers, served):
    j_call, ts, _, te = servers
    prompt, px = _image_prompt(8), _pixels(8)
    body = {"prompt_token_ids": prompt, "pixel_values": px.tolist(), "max_tokens": 5,
            "temperature": 0.0}
    js, jb = j_call("/v1/completions", body)
    r = ts.handle("POST", "/v1/completions", json.dumps(body).encode())
    assert js == r.status == 200
    assert _ids(r.body) == _ids(jb)
    _, _, _, tp, cfg = served
    want = list(Generator(tp, cfg, cache_dtype=torch.float32, device="cpu").stream_generate(
        prompt, SamplingParams(max_tokens=5, temperature=0.0), pixel_values=px))
    assert _ids(r.body) == [want]


def test_api_chat_image_parts_match_jax(servers):
    """Chat image parts through the same stub processor in both servers;
    without a processor the port answers 400, as JAX's does."""
    j_call, ts, bare, _ = servers
    body = {"messages": [{"role": "user", "content": [
        {"type": "image", "url": "cat.png"}, {"type": "text", "text": "what is this?"}]}],
        "max_tokens": 5, "temperature": 0.0}
    js, jb = j_call("/v1/chat/completions", body)
    r = ts.handle("POST", "/v1/chat/completions", json.dumps(body).encode())
    assert js == r.status == 200
    assert _ids(r.body) == _ids(jb) and len(_ids(r.body)[0]) == 5
    r = bare.handle("POST", "/v1/chat/completions", json.dumps(body).encode())
    assert r.status == 400 and b"vision processor" in r.body


def test_serve_cli_serves_a_vlm_directory(served, tmp_path, capsys):
    """An HF-named VLM directory with no processor files: the CLI loads the
    tower, prints JAX's message, and serves raw pixel_values."""
    from paroquant_tpu_torch.cli.serve import build
    from paroquant_tpu_torch.convert.checkpoint import write_safetensors

    hf, _, _, _, cfg = served
    d = tmp_path / "vlm"
    d.mkdir()
    write_safetensors(d / "model.safetensors",
                      {k: v.detach().float() for k, v in hf.state_dict().items()})
    (d / "config.json").write_text(json.dumps(HF_CFG))
    server, args = build(["--model", str(d), "--device", "cpu", "--max-len", "64",
                          "--page-size", "8"])
    assert server.processor is None and "chat image content disabled" in capsys.readouterr().out
    assert "vision" in server.engine.params
    prompt, px = _image_prompt(9), _pixels(9)
    toks = server.engine.generate_sync(prompt, SamplingParams(max_tokens=4, temperature=0.0),
                                       pixel_values=px)
    assert len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks)
    assert server.engine.params["vision"]["patch_embed_w"].dtype == torch.bfloat16
