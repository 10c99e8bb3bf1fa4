"""The port's scripts/bench_longcontext.py on the CPU at tiny sizes: each arm's
keys in the order of the JAX script's JSON lines (read from its source with
`ast`, without running it), the ppl16k arm's PPL against JAX's
`perplexity` on the same params, gen32k's finish and count, ttft16k's
chunks, and `build_w4` against the whole-model build."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.cli.evaluate import perplexity as j_perplexity
from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
from paroquant_tpu_torch.models import PRESETS, init_params, merge_projections
from paroquant_tpu_torch.scripts import bench_longcontext as bl

ROOT = Path(__file__).resolve().parent.parent
JAX_SCRIPT = ROOT / "scripts" / "bench_longcontext.py"
# one layer of the tiny preset: every arm runs in a few seconds on the CPU
NARROW = dict(num_hidden_layers=1)


def _arm_keys() -> dict[str, list]:
    """arm name -> the keys of the dict its json.dumps prints, in order, with
    None where the JAX script splices in `**eng.step_time_stats()`."""
    out = {}
    for fn in ast.parse(JAX_SCRIPT.read_text()).body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("arm_"):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                        and isinstance(node.args[0], ast.Dict)):
                    out[fn.name[4:]] = [None if k is None else k.value for k in node.args[0].keys]
    return out


@pytest.fixture(scope="module")
def model():
    return bl.build_w4("qwen3-0.6b", config=dataclasses.replace(PRESETS["tiny"], **NARROW),
                       device="cpu")


def test_build_w4_is_the_whole_model_build():
    """The model is init_params (seed 0, bf16) + quantize_model_rtn (W4 g128)
    + merge_projections, bit for bit."""
    cfg = dataclasses.replace(PRESETS["tiny"], num_hidden_layers=2)
    got, gcfg = bl.build_w4("tiny", config=cfg, device="cpu")
    want = merge_projections(quantize_model_rtn(
        init_params(cfg, 0, dtype=torch.bfloat16, device="cpu"), cfg, n_bits=4, group_size=128,
        device="cpu"), cfg)
    assert gcfg == cfg and sorted(got) == sorted(want)
    assert torch.equal(got["embed_tokens"], want["embed_tokens"])
    for lg, lw in zip(got["layers"], want["layers"]):
        assert sorted(lg) == sorted(lw) and sorted(lg["mlp"]) == sorted(lw["mlp"])
        for name in ("qkv_proj", "o_proj"):
            for buf in ("qweight", "scales", "zeros", "rot"):
                assert torch.equal(getattr(lg[name], buf), getattr(lw[name], buf)), (name, buf)
        for name in ("gate_up_proj", "down_proj"):
            for buf in ("qweight", "scales", "zeros", "rot"):
                assert torch.equal(getattr(lg["mlp"][name], buf), getattr(lw["mlp"][name], buf))


def test_build_w4_layers_cut_depth():
    _, cfg = bl.build_w4("tiny", layers=1, device="cpu")
    assert cfg.num_hidden_layers == 1 and cfg.hidden_size == PRESETS["tiny"].hidden_size


def test_ttft16k(model, capsys):
    out = bl.main(["--arm", "ttft16k", "--prompt-len", "300", "--chunk", "128", "--device", "cpu"],
                  model=model)
    assert list(out) == _arm_keys()["ttft16k"]
    assert out["chunks"] == 3 and out["prompt_tokens"] == 300 and out["prefill_chunk"] == 128
    assert out["ttft_cold_s"] >= 0 and out["ttft_warm_s"] >= 0
    assert capsys.readouterr().out.strip().startswith('{"metric": "long_context_ttft"')


def test_gen32k(model):
    out = bl.main(["--arm", "gen32k", "--gen-total", "160", "--device", "cpu"], model=model)
    keys = _arm_keys()["gen32k"]
    cut = keys.index(None)
    assert list(out)[:cut] == keys[:cut]
    # the rest: Engine.step_time_stats(), as in JAX's line
    assert set(list(out)[cut:]) <= {"decode_tick_wall_p50_ms", "decode_tick_wall_p99_ms",
                                    "decode_tick_samples", "decode_step_device_ms_est",
                                    "decode_dispatch_overhead_ms_est"}
    assert "decode_tick_wall_p50_ms" in out
    assert out["finish"] == "done" and out["generated"] == 160 - 32
    assert out["pages_used"] == "freed" and list(out["tok_s_at_mark"]) == [128]


def test_ppl16k_matches_jax_perplexity(monkeypatch):
    """The arm's PPL (before its rounding for the line) against JAX's
    `perplexity` on the same f32 params (params_from_jax), auto mode."""
    jcfg = dataclasses.replace(J_PRESETS["tiny"], **NARROW)
    jp = jd.merge_projections(
        j_rtn(jd.init_params(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32), jcfg), jcfg)
    cfg = dataclasses.replace(PRESETS["tiny"], **NARROW)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    seen = []
    ppl = bl.perplexity
    monkeypatch.setattr(bl, "perplexity", lambda *a, **k: seen.append(ppl(*a, **k)) or seen[-1])
    out = bl.main(["--arm", "ppl16k", "--window", "192", "--device", "cpu"], model=(tp, cfg))
    assert list(out) == _arm_keys()["ppl16k"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, 192).astype(np.int32)
    want = j_perplexity(jp, jcfg, toks, 192, "auto", batch=1)
    assert abs(seen[0] - want) / want < 1e-5, (seen[0], want)
    assert out["ppl_random_weights"] == round(seen[0], 1)
    assert out["layers"] == "full" and out["window_tokens"] == 192
    assert out["peak_bytes_in_use"] is None  # a device number; none on the CPU


def test_ppl16k_chunked_window(model):
    """A window longer than the CE chunk (2048) takes the chunked path."""
    out = bl.main(["--arm", "ppl16k", "--window", "4096", "--layers", "1", "--device", "cpu"],
                  model=model)
    assert out["layers"] == 1 and np.isfinite(out["ppl_random_weights"])


def _flags(path: Path) -> dict:
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            out[node.args[0].value] = {k.arg: ast.unparse(k.value) for k in node.keywords
                                       if k.arg in ("default", "type", "required")}
    return out


def test_flags_match_jax():
    t = _flags(ROOT / "paroquant_tpu_torch" / "scripts" / "bench_longcontext.py")
    assert t.pop("--device") == {"default": "'cuda'"}
    assert t == _flags(JAX_SCRIPT)
    assert list(bl.ARMS) == ["ttft16k", "gen32k", "ppl16k"]
