"""The port's cli/chat.py: the turn loop (`chat_turns`) driven by a scripted
line source on a tiny model with a stand-in byte tokenizer, and `main`
with its flags and warm-up, against the JAX CLI's behaviour."""

import ast
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from rich.console import Console

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert.rtn import rtn_export_model
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.cli import chat
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.serve import generator as tgen
from paroquant_tpu_torch.serve import Generator, SamplingParams

ROOT = Path(__file__).resolve().parent.parent
CFG = PRESETS["tiny"]
STATS = re.compile(r"ttft \d+ ms · (\d+) tokens · [\d.]+ tok/s")


class ByteTokenizer:
    """Bytes as token ids 0-255; a chat template of tagged turns; `special`
    maps other ids to text (e.g. one id to "</think>")."""

    eos_token_id = 511

    def __init__(self, special=None):
        self.special = special or {}

    def apply_chat_template(self, messages, add_generation_prompt=True, enable_thinking=True):
        text = "".join(f"<|{m['role']}|>{m['content']}" for m in messages)
        text += "<|assistant|>" if add_generation_prompt else ""
        text += "" if enable_thinking else "<|nothink|>"
        return list(text.encode())

    def decode(self, ids, skip_special_tokens=True):
        out = b""
        for i in ids:
            out += self.special.get(i, "").encode() if i >= 256 or i in self.special else bytes([i])
        return out.decode("utf-8", errors="replace")


@pytest.fixture(scope="module")
def params():
    jp = jd.init_params(J_PRESETS["tiny"], jax.random.PRNGKey(5), dtype=jnp.float32)
    from paroquant_tpu.convert.rtn import quantize_model_rtn

    jp = quantize_model_rtn(jp, J_PRESETS["tiny"], hadamard=True)
    return params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def _lines(*lines):
    it = iter(lines)

    def read_line():
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None

    return read_line


def _run(gen, sp, *lines, history=None):
    buf = io.StringIO()
    turns = chat.chat_turns(gen, sp, _lines(*lines), Console(file=buf, width=120),
                            history=history)
    return turns, buf.getvalue().splitlines()


def _gen(params, tok=None, **kw):
    return Generator(params, CFG, tok or ByteTokenizer(), max_len=1024, cache_dtype=torch.float32,
                     device="cpu", **kw)


@pytest.mark.parametrize("burst", [1, 4])
def test_greedy_turns_give_the_generators_tokens(params, burst):
    gen = _gen(params, decode_burst=burst)
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    history = []
    turns, out = _run(gen, sp, "hi", "", "tell me more", history=history)
    assert len(turns) == 2
    for t in turns:
        assert t["tokens"] == list(gen.stream_generate(t["prompt"], sp))
        assert 1 <= len(t["tokens"]) <= sp.max_tokens
    # the second prompt holds the whole history: both user lines, the first answer
    assert turns[1]["prompt"] == gen.build_prompt(history[:3], True)
    assert [m["role"] for m in history] == ["user", "assistant", "user", "assistant"]
    assert [m["content"] for m in history[::2]] == ["hi", "tell me more"]
    stats = [STATS.search(line) for line in out if "tok/s" in line]
    assert [int(m.group(1)) for m in stats] == [len(t["tokens"]) for t in turns]


def test_think_and_clear(params):
    gen = _gen(params)
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    history = []
    turns, out = _run(gen, sp, "one", "/think", "two", "/clear", "three", "/think", "four",
                      history=history)
    assert "thinking off" in out and "history cleared" in out and "thinking on" in out
    first, second, third, fourth = turns
    assert first["prompt"] == gen.build_prompt([{"role": "user", "content": "one"}], True)
    # /think: reasoning off for the next turn, on the whole history
    assert second["prompt"][-len("<|nothink|>"):] == list(b"<|nothink|>")
    assert second["prompt"] == gen.build_prompt(
        [{"role": "user", "content": "one"}, {"role": "assistant", "content": first["answer"]},
         {"role": "user", "content": "two"}], False)
    # /clear: the third turn's prompt holds only its own line
    assert third["prompt"] == gen.build_prompt([{"role": "user", "content": "three"}], False)
    assert fourth["prompt"] == gen.build_prompt(history[:3], True)
    assert [m["content"] for m in history[::2]] == ["three", "four"]


def test_history_keeps_the_answer_after_think(params):
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    plain = _gen(params)
    prompt = plain.build_prompt([{"role": "user", "content": "why"}], True)
    toks = list(plain.stream_generate(prompt, sp))
    assert len(toks) >= 4
    # the third token decodes as "</think>", so the answer is what follows it
    special = {toks[0]: "<think>", toks[2]: "</think>"}
    tok = ByteTokenizer(special)
    gen = _gen(params, tok)
    history = []
    turns, out = _run(gen, sp, "why", history=history)
    assert turns[0]["tokens"] == toks
    text = tok.decode(toks)
    assert "</think>" in text
    assert history[-1] == {"role": "assistant", "content": text.split("</think>", 1)[1].strip()}
    assert turns[0]["answer"] == history[-1]["content"]


def test_main_warms_up_and_runs_a_turn(tmp_path, monkeypatch, capsys):
    params = jd.init_params(J_PRESETS["tiny"], jax.random.PRNGKey(6), dtype=jnp.float32)
    jck.save_paro_checkpoint(tmp_path, params, J_PRESETS["tiny"],
                             rtn_export_model(params, J_PRESETS["tiny"], hadamard=True))
    monkeypatch.setattr(tgen, "load_tokenizer", lambda d: ByteTokenizer())
    prompts = []
    stream = tgen.Generator.stream_generate

    def recording(self, prompt, sp, *a, **k):
        prompts.append((list(prompt), sp.max_tokens))
        return stream(self, prompt, sp, *a, **k)

    monkeypatch.setattr(tgen.Generator, "stream_generate", recording)
    monkeypatch.setattr(Console, "input", lambda self, prompt="": _read())
    _read = _lines("hello")
    chat.main(["--model", str(tmp_path), "--max-tokens", "5", "--temperature", "0",
               "--device", "cpu"])
    out = capsys.readouterr().out
    # the warm-up turn (2 tokens of "hi"), then the scripted turn
    assert prompts[0] == (ByteTokenizer().apply_chat_template(
        [{"role": "user", "content": "hi"}]), 2)
    assert prompts[1][1] == 5 and len(prompts) == 2
    assert "paroquant-tpu chat" in out and re.search(r"ttft \d+ ms · \d+ tokens", out)


def test_main_without_tokenizer_returns(tmp_path, capsys):
    params = jd.init_params(J_PRESETS["tiny"], jax.random.PRNGKey(6), dtype=jnp.float32)
    jck.save_paro_checkpoint(tmp_path, params, J_PRESETS["tiny"],
                             rtn_export_model(params, J_PRESETS["tiny"], hadamard=True))
    assert chat.main(["--model", str(tmp_path), "--device", "cpu"]) is None
    assert "model dir has no tokenizer; chat needs one" in capsys.readouterr().out


def _flags(path: Path) -> dict:
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            out[node.args[0].value] = {k.arg: ast.unparse(k.value) for k in node.keywords
                                       if k.arg in ("default", "choices", "type", "required")}
    return out


def test_flags_match_jax():
    j = _flags(ROOT / "paroquant_tpu" / "cli" / "chat.py")
    t = _flags(ROOT / "paroquant_tpu_torch" / "cli" / "chat.py")
    assert list(t) == list(j)
    assert t.pop("--device") == {"default": "'cuda'", "choices": "['cuda', 'cpu']"}
    j.pop("--device")
    assert t == j
