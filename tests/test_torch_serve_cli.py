"""The port's serving CLI (`paroquant_tpu_torch/cli/serve.py`) on the CPU.

Its flags are JAX's (read from `paroquant_tpu/cli/serve.py` with ast), with
`--device cpu|cuda` (default cuda) in place of JAX's platforms. `build`
loads a PARO-TPU directory that JAX wrote and returns the Server that
`main` runs; `--dp` beyond the devices present stops with JAX's SystemExit,
and `--tp` > 1 raises (tensor parallelism is ROADMAP §A 7).
"""

import http.client
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paroquant_tpu.convert.checkpoint import save_paro_checkpoint as j_save
from paroquant_tpu.convert.rtn import rtn_export_model as j_export
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.cli import serve
from paroquant_tpu_torch.serve import Engine, EngineRouter, SamplingParams
from paroquant_tpu_torch.serve.api import Server
from test_torch_api import byte_tokenizer
from test_torch_evaluate import _flags

ROOT = Path(__file__).resolve().parents[1]


def test_flags_match_jax():
    j = _flags(ROOT / "paroquant_tpu" / "cli" / "serve.py")
    t = _flags(ROOT / "paroquant_tpu_torch" / "cli" / "serve.py")
    assert list(t) == list(j)
    assert t.pop("--device") == {"default": "'cuda'", "choices": "['cpu', 'cuda']"}
    j.pop("--device")
    assert t == j


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A PARO-TPU directory of the `tiny` preset written by JAX (Hadamard RTN),
    with the byte-level tokenizer."""
    cfg = J_PRESETS["tiny"]
    params = jd.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("ckpt") / "tiny-paro"
    j_save(path, params, cfg, j_export(params, cfg, hadamard=True))
    byte_tokenizer(path)
    return path


def test_build_defaults_on_the_cpu(checkpoint):
    server, args = serve.build(["--model", str(checkpoint), "--device", "cpu",
                                "--prefix-caching", "--spec-k", "2", "--max-len", "256",
                                "--page-size", "16", "--max-queue", "3"])
    eng = server.engine
    assert isinstance(eng, Engine) and eng.device.type == "cpu"
    assert (args.quant_mode, args.decode_burst) == ("xla", 1) == (eng.quant_mode, eng.decode_burst)
    assert (eng.prefix_caching, eng.spec_k, eng.max_len, eng.page_size, eng.max_queue) == (
        True, 2, 256, 16, 3)
    assert eng.tokenizer is not None and server.model_name == "tiny-paro"
    server2, args2 = serve.build(["--model", str(checkpoint), "--device", "cpu", "--quant-mode",
                                  "fused", "--decode-burst", "4", "--served-model-name", "x"])
    assert (server2.engine.quant_mode, server2.engine.decode_burst, server2.model_name) == (
        "fused", 4, "x")


def test_build_serves_over_http(checkpoint):
    server, _ = serve.build(["--model", str(checkpoint), "--device", "cpu", "--max-len", "128",
                             "--page-size", "16"])
    prompt = np.random.default_rng(4).integers(0, 512, 9).tolist()
    want = server.engine.generate_sync(prompt, SamplingParams(max_tokens=6, temperature=0.0))
    server.engine.start()
    try:
        with server.serving() as url:
            host, port = url.split("//")[1].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=120)
            conn.request("POST", "/v1/completions", body=json.dumps(
                {"prompt_token_ids": prompt, "max_tokens": 6, "temperature": 0.0}))
            r = conn.getresponse()
            body = json.loads(r.read())
            conn.close()
        assert r.status == 200 and body["choices"][0]["token_ids"] == want
        assert body["model"] == "tiny-paro"
        assert server.engine._thread.is_alive()
    finally:
        server.engine.stop()


def test_warmup_walks_the_prefill_buckets(checkpoint, capsys):
    server, _ = serve.build(["--model", str(checkpoint), "--device", "cpu", "--max-len", "128",
                             "--page-size", "16", "--warmup"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["warmup: bucket 16", "warmup: bucket 32", "warmup: bucket 64"]
    assert server.engine.metrics["requests"] == 3


def test_dp_beyond_the_devices_exits():
    with pytest.raises(SystemExit, match="--dp 2 x tp 1 needs 2 devices, have 1"):
        serve.build(["--model", "/nonexistent", "--device", "cpu", "--dp", "2"])


def test_tp_raises():
    with pytest.raises(NotImplementedError, match="§A 7"):
        serve.build(["--model", "/nonexistent", "--device", "cpu", "--tp", "2"])


def test_main_prints_and_runs(checkpoint, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(Server, "run", lambda self, host, port: calls.append((host, port)))
    serve.main(["--model", str(checkpoint), "--device", "cpu", "--port", "8123", "--max-len",
                "64", "--page-size", "16"])
    assert calls == [("0.0.0.0", 8123)]
    assert capsys.readouterr().out.strip() == (
        "serving tiny-paro on 0.0.0.0:8123 (quant_mode=xla)")


def test_run_serves_until_interrupted(checkpoint, monkeypatch):
    from http.server import ThreadingHTTPServer

    server, _ = serve.build(["--model", str(checkpoint), "--device", "cpu", "--max-len", "64",
                             "--page-size", "16"])
    seen = {}

    def interrupted(httpd, *a, **kw):
        seen["port"] = httpd.server_address[1]
        seen["alive"] = server.engine._thread.is_alive()
        raise KeyboardInterrupt

    monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", interrupted)
    server.run("127.0.0.1", 0)
    assert seen["port"] > 0 and seen["alive"]
    assert not server.engine._thread.is_alive()


def test_router_behind_the_server(checkpoint):
    """What `--dp N` builds on N cards, here on the CPU: the Server over an
    EngineRouter answers as over one Engine."""
    from paroquant_tpu_torch.convert import load_checkpoint

    params, cfg = load_checkpoint(checkpoint, device="cpu")
    kw = dict(max_batch=2, max_len=64, page_size=16, quant_mode="xla", device="cpu")
    one = Server(Engine(params, cfg, **kw), "m")
    two = Server(EngineRouter([Engine(params, cfg, **kw), Engine(params, cfg, **kw)]), "m")
    body = {"prompt_token_ids": [5, 6, 7, 8], "max_tokens": 5, "temperature": 0.0, "n": 3}
    answers = []
    for s in (one, two):
        s.engine.start()
        try:
            answers.append(s.handle("POST", "/v1/completions", json.dumps(body).encode()).json())
        finally:
            s.engine.stop()
    assert answers[0]["choices"] == answers[1]["choices"]
    assert two.handle("GET", "/metrics").json()["replicas"] == 2
