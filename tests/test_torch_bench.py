"""The port's decode-measurement entry points on the CPU: `bench.py`, the
benchmark CLI, `scripts/kernel_dispatch.py`, `bench_prefill.py`,
`bench_spec.py`, and the profiling and build-cache utilities, held against
the JAX package's where they compute the same thing."""

import ast
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.convert.rtn import rtn_export_model
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.utils import profiling as jprof
from paroquant_tpu_torch import bench
from paroquant_tpu_torch.cli import benchmark as cli_benchmark
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.kernels import build
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.scripts import bench_prefill, bench_spec, kernel_dispatch
from paroquant_tpu_torch.utils import cache as tcache
from paroquant_tpu_torch.utils import profiling as tprof

ROOT = Path(__file__).resolve().parent.parent
CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]


def _root_bench_keys() -> list[str]:
    """The keys of the dict that root bench.py prints, read without running it."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in bench.py")


def test_bench_prints_the_root_bench_keys(capsys):
    result = bench.main(["--preset", "tiny", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert list(printed) == _root_bench_keys() == list(result)
    assert printed["decode_chain_tokens"] == 48 and printed["reps"] == 2  # the CPU protocol
    assert all(np.isfinite(v) for v in printed.values() if isinstance(v, float))


def test_bench_protocol_defaults_and_cuts(capsys):
    args = bench.parse_args([])
    assert (args.preset, args.device, args.warmup) == ("qwen3-0.6b", "cuda", 2)
    assert bench.arm_modes("cpu") == {"bf16": "xla", "w4": "xla", "w4a8": "w4a8_xla"}
    result = bench.main(["--preset", "tiny", "--device", "cpu", "--n-long", "6",
                         "--n-short", "3", "--reps", "1", "--warmup", "0"])
    assert (result["decode_chain_tokens"], result["reps"]) == (6, 1)
    assert len(capsys.readouterr().out.strip().splitlines()) == 1


@functools.lru_cache(maxsize=None)
def _bench_models():
    """bench.py's model at `tiny` with f32 weights: random, RTN W4 g128 with a
    W4 lm_head, merged projections; JAX's and the port's copies. Both sides
    keep the bench's bf16 KV cache."""
    params = jd.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = jd.merge_projections(
        j_rtn(params, JCFG, n_bits=4, group_size=128, quantize_lm_head=True), JCFG)
    to_port = functools.partial(params_from_jax, config=CFG, device="cpu")
    return ((params, qparams),
            (to_port(jax.tree.map(np.asarray, params)), to_port(jax.tree.map(np.asarray, qparams))))


@pytest.mark.parametrize("arm", ["bf16", "w4", "w4a8"])
def test_bench_arm_tokens_match_jax(arm):
    """Each arm's chain (prefill of bench.py's 16-token prompt, then
    greedy_decode_scan) gives JAX's tokens on the same params."""
    (jp, jq), (tp, tq) = _bench_models()
    mode = bench.arm_modes("cpu")[arm]
    n = 12
    _, toks = bench.make_decode_runner(tp if arm == "bf16" else tq, CFG, mode, "cpu", n_long=n)(n)
    prompt = np.random.default_rng(0).integers(0, JCFG.vocab_size, (1, bench.PROMPT_LEN))
    params = jp if arm == "bf16" else jq
    cache = jd.KVCache.create(JCFG, 1, bench.PROMPT_LEN + n + 8, jnp.bfloat16)
    logits, cache = jd.prefill(params, JCFG, jnp.asarray(prompt, jnp.int32), cache,
                               quant_mode=mode)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want, _ = jd.greedy_decode_scan(params, JCFG, tok, cache, n, quant_mode=mode)
    assert toks.tolist() == np.asarray(want).tolist()


@pytest.fixture(scope="module")
def paro_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("paro")
    params = jd.init_params(JCFG, jax.random.PRNGKey(1), dtype=jnp.float32)
    jck.save_paro_checkpoint(path, params, JCFG, rtn_export_model(params, JCFG, hadamard=True))
    return path


@pytest.mark.parametrize("spec_k", [0, 3])
def test_benchmark_cli(paro_checkpoint, capsys, spec_k):
    cli_benchmark.main(["--model", str(paro_checkpoint), "--prefill-len", "8",
                        "--decode-len", "6", "--warmup", "1", "--runs", "1",
                        "--quant-mode", "xla", "--device", "cpu", "--spec-k", str(spec_k)])
    out = capsys.readouterr().out
    assert "backend=cpu quant_mode=xla" in out and "tok/s" in out
    assert ("speculation:" in out) == bool(spec_k)


def test_benchmark_cli_has_no_batch_flag(paro_checkpoint):
    """The JAX CLI's --batch is read by nothing; the port refuses it rather
    than print single-stream numbers under it."""
    with pytest.raises(SystemExit) as e:
        cli_benchmark.main(["--model", str(paro_checkpoint), "--batch", "4", "--device", "cpu"])
    assert e.value.code == 2


def test_kernel_dispatch_rows(capsys):
    rows = kernel_dispatch.main("cpu", ms=(1, 3, 20), reps=1, I=256, O=256)
    out = capsys.readouterr().out
    assert [r["M"] for r in rows] == [1, 3, 20]
    assert all(r["winner"] in ("fused", "xla") and r["fused_us"] > 0 for r in rows)
    assert "winner table" in out and "AUTO_FUSED_MAX_M = 128" in out


def test_kernel_dispatch_reads_its_environment(monkeypatch):
    monkeypatch.setenv("DISPATCH_MS", "2,8")
    monkeypatch.setenv("DISPATCH_REPS", "4")
    assert kernel_dispatch.env_ms() == (2, 8) and kernel_dispatch.env_reps() == 4
    monkeypatch.delenv("DISPATCH_MS")
    monkeypatch.delenv("DISPATCH_REPS")
    assert kernel_dispatch.env_ms()[0] == 1 and kernel_dispatch.env_reps() == 9


def test_kernel_dispatch_modes_agree():
    """At each M the two timed modes compute the same layer (the plain
    versions here, to f32 rounding of the bf16 rotation)."""
    from paroquant_tpu_torch.ops.qlinear import quantized_linear_forward

    layer = kernel_dispatch.make_layer("cpu", 256, 256)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 256))).to(torch.bfloat16)
    fused = quantized_linear_forward(layer, x, mode="fused").float()
    xla = quantized_linear_forward(layer, x, mode="xla").float()
    assert torch.allclose(fused, xla, rtol=2e-2, atol=2e-2 * float(xla.abs().max()))


def test_bench_prefill_rows(capsys):
    rows = bench_prefill.main("cpu", M=16, I=256, O=256, reps=1)
    assert [r["label"] for r in rows] == ["bf16_dense", "w4 xla path", "w4 fused kernel"]
    assert all(r["tflops"] is None for r in rows)  # no rate from the host clock
    assert capsys.readouterr().out.count("host clock") == 3


def test_bench_spec_rows(capsys):
    rows = bench_spec.main("cpu", preset="tiny", tokens=12, reps=1)
    assert [(r["regime"], r["spec_k"]) for r in rows] == [
        (g, k) for g in ("repeat", "random") for k in bench_spec.SPEC_KS]
    for r in rows:  # the tokens are identical across k
        assert r["first_divergence_vs_k0"] == r["len"] == 12 and r["mismatches_vs_k0"] == 0
    assert max(r["acceptance"] for r in rows if r["regime"] == "repeat") > 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 6 + 4


def test_first_divergence():
    assert bench_spec.first_divergence([1, 2, 3], [1, 2, 3]) == 3
    assert bench_spec.first_divergence([1, 5, 3], [1, 2, 3]) == 1
    assert bench_spec.first_divergence([1, 2], [1, 2, 3]) == 2


def test_step_timer_summary_matches_jax():
    samples = [0.004, 0.001, 0.0025, 0.010, 0.0031, 0.0007]
    jt, tt = jprof.StepTimer(window=4), tprof.StepTimer(window=4)
    for s in samples:
        jt.samples.append(s)
        tt.samples.append(s)
    assert tt.summary() == jt.summary()
    assert tprof.StepTimer().summary() == {}
    with tt:
        pass
    assert len(tt.samples) == 4


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "prof", device="cpu"):
        with tprof.annotate("matmul_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "prof" / "trace.json"
    assert path.exists()
    assert "matmul_region" in path.read_text()


def test_compilation_cache_returns_on_the_cpu():
    code = (
        "import sys\n"
        "from paroquant_tpu_torch.kernels import build\n"
        "from paroquant_tpu_torch.utils.cache import enable_compilation_cache\n"
        "root = build.BUILD_ROOT\n"
        "enable_compilation_cache('/nonexistent/cache', device='cpu')\n"
        "assert build.BUILD_ROOT == root and not build._libs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'paroquant_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120, env={**os.environ, "PAROQUANT_CACHE_DIR": "/x"})
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path, env, want", [
    (None, None, None),
    (None, "env_root", "env_root"),
    ("arg_root", "env_root", "arg_root"),
])
def test_compilation_cache_names_the_build_root(monkeypatch, tmp_path, path, env, want):
    """On CUDA the root is `path`, else $PAROQUANT_CACHE_DIR, else the
    default, and every library is built there (the build recorded here)."""
    default = build.BUILD_ROOT
    monkeypatch.setattr(build, "BUILD_ROOT", default)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    monkeypatch.setattr(build, "build_all", lambda: calls.append(build.BUILD_ROOT))
    if env is None:
        monkeypatch.delenv("PAROQUANT_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("PAROQUANT_CACHE_DIR", str(tmp_path / env))
    tcache.enable_compilation_cache(None if path is None else str(tmp_path / path))
    assert calls == [default if want is None else tmp_path / want]
