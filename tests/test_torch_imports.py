"""The port stands alone: it imports neither jax nor paroquant_tpu, and a
CUDA entry point with no CUDA present raises instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paroquant_tpu_torch

PKG = Path(paroquant_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "safetensors", "aiohttp", "paroquant_tpu")


def _modules():
    return sorted(
        "paroquant_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )


EXPERIMENT_MODULES = (
    "paroquant_tpu_torch.kernels.w4_experiments", "paroquant_tpu_torch.scripts.kernel_edge_test",
    "paroquant_tpu_torch.scripts.kernel_dma_pipeline", "paroquant_tpu_torch.scripts.kernel_tune",
    "paroquant_tpu_torch.scripts.kernel_w4a8_exp", "paroquant_tpu_torch.kernels.int8_probe",
    "paroquant_tpu_torch.scripts.kernel_int8_probe", "paroquant_tpu_torch.kernels.unpack_exp",
    "paroquant_tpu_torch.scripts.kernel_unpack_exp", "paroquant_tpu_torch.scripts.one_launch_phases",
    "paroquant_tpu_torch.bench", "paroquant_tpu_torch.cli.benchmark",
    "paroquant_tpu_torch.scripts.kernel_dispatch", "paroquant_tpu_torch.scripts.bench_prefill",
    "paroquant_tpu_torch.scripts.bench_spec", "paroquant_tpu_torch.utils.cache",
    "paroquant_tpu_torch.scripts.bench_serving", "paroquant_tpu_torch.scripts.bench_7b",
    "paroquant_tpu_torch.scripts.bench_decode_accounting",
    "paroquant_tpu_torch.scripts.bench_kv_quant", "paroquant_tpu_torch.scripts.bench_a8_accuracy",
    "paroquant_tpu_torch.experiments.baselines.quality_ladder",
    "paroquant_tpu_torch.cli.evaluate", "paroquant_tpu_torch.cli.chat",
    "paroquant_tpu_torch.scripts.bench_longcontext", "paroquant_tpu_torch.ops.native_packing",
    "paroquant_tpu_torch.serve.router", "paroquant_tpu_torch.serve.api",
    "paroquant_tpu_torch.cli.serve", "paroquant_tpu_torch.convert.gptq",
    "paroquant_tpu_torch.optim.data", "paroquant_tpu_torch.experiments.baselines.rtn_baseline",
    "paroquant_tpu_torch.experiments.baselines.gptq_baseline",
    "paroquant_tpu_torch.optim.pseudo", "paroquant_tpu_torch.optim.train",
    "paroquant_tpu_torch.optim.calibrate", "paroquant_tpu_torch.cli.optimize",
    "paroquant_tpu_torch.cli.convert", "paroquant_tpu_torch.scripts.bench_calibration",
    "paroquant_tpu_torch.ops.moe", "paroquant_tpu_torch.optim.pseudo_moe",
    "paroquant_tpu_torch.models.linear_attn", "paroquant_tpu_torch.models.gemma3n",
    "paroquant_tpu_torch.models.vision",
)


def test_import_leaves_jax_and_reference_unloaded():
    assert set(EXPERIMENT_MODULES) <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'safetensors', 'aiohttp', 'paroquant_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_import_nothing_forbidden():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def _entry_points():
    from paroquant_tpu_torch.convert.checkpoint import load_checkpoint
    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.models import PRESETS, KVCache, from_hf_dict, init_params
    from paroquant_tpu_torch.convert.interop import (kv_cache_from_jax, paged_cache_from_jax,
                                                     w4_i4_from_jax)
    from paroquant_tpu_torch.models.gemma3n import init_gemma3n_params
    from paroquant_tpu_torch.models.linear_attn import LinearAttnStates
    from paroquant_tpu_torch.experiments import plot_kernel_speedup
    from paroquant_tpu_torch.scripts import (kernel_bench3, kernel_bench4, kernel_dma_pipeline,
                                             kernel_edge_test, kernel_int8_probe, kernel_tune,
                                             kernel_unpack_exp, kernel_w4a8_exp, one_launch_phases)
    from paroquant_tpu_torch import bench
    from paroquant_tpu_torch.cli import benchmark as cli_benchmark
    from paroquant_tpu_torch.scripts import bench_prefill, bench_spec, kernel_dispatch
    from paroquant_tpu_torch.scripts import (bench_7b, bench_a8_accuracy,
                                             bench_decode_accounting, bench_kv_quant,
                                             bench_serving)
    from paroquant_tpu_torch.cli import chat as cli_chat
    from paroquant_tpu_torch.cli import evaluate as cli_evaluate
    from paroquant_tpu_torch.scripts import bench_longcontext
    from paroquant_tpu_torch.cli import serve as cli_serve
    from paroquant_tpu_torch.convert.gptq import gptq_quantize_model
    from paroquant_tpu_torch.cli import convert as cli_convert
    from paroquant_tpu_torch.cli import optimize as cli_optimize
    from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
    from paroquant_tpu_torch.scripts import bench_calibration
    from paroquant_tpu_torch.experiments.baselines import gptq_baseline, rtn_baseline
    from paroquant_tpu_torch.serve import Engine, Generator, PagedKVCache, create_generator
    from paroquant_tpu_torch.utils.cache import enable_compilation_cache
    from paroquant_tpu_torch.utils.profiling import trace
    from paroquant_tpu_torch.utils.device import resolve_device
    from paroquant_tpu_torch.kernels.attention import flash_key_groups
    from paroquant_tpu_torch.utils.profiling import (kernel_time_ms, profile_paged_decode,
                                                     profile_prefill)

    cfg = PRESETS["tiny"]
    hybrid = from_hf_dict(dict(model_type="qwen3_next", num_hidden_layers=4))
    return {
        "resolve_device": lambda: resolve_device(),
        "init_params": lambda: init_params(cfg, 0),
        "KVCache.create": lambda: KVCache.create(cfg, 1, 8),
        "Generator": lambda: Generator({}, cfg),
        "load_checkpoint": lambda: load_checkpoint("/nonexistent"),
        "quantize_model_rtn": lambda: quantize_model_rtn({"layers": []}, cfg),
        "Engine": lambda: Engine({}, cfg),
        "PagedKVCache.create": lambda: PagedKVCache.create(cfg, 4, 8),
        "paged_cache_from_jax": lambda: paged_cache_from_jax(
            type("C", (), dict(k=None, v=None, k_scale=None, v_scale=None))()),
        "profile_paged_decode": lambda: profile_paged_decode({}, cfg),
        "profile_prefill": lambda: profile_prefill({}, cfg),
        "flash_key_groups": lambda: flash_key_groups(1, 16, 512, 128),
        "kernel_bench3.main": lambda: kernel_bench3.main(),
        "kernel_bench4.main": lambda: kernel_bench4.main(),
        "plot_kernel_speedup.main": lambda: plot_kernel_speedup.main(),
        "w4_i4_from_jax": lambda: w4_i4_from_jax(np.zeros((4, 4), np.uint8)),
        "kernel_time_ms": lambda: kernel_time_ms(lambda: None),
        "kernel_edge_test.main": lambda: kernel_edge_test.main(),
        "kernel_dma_pipeline.main": lambda: kernel_dma_pipeline.main(),
        "kernel_tune.main": lambda: kernel_tune.main(),
        "kernel_w4a8_exp.main": lambda: kernel_w4a8_exp.main(),
        "kernel_int8_probe.main": lambda: kernel_int8_probe.main(),
        "kernel_unpack_exp.main": lambda: kernel_unpack_exp.main(),
        "one_launch_phases.main": lambda: one_launch_phases.main([]),
        "bench.main": lambda: bench.main(["--preset", "tiny"]),
        "bench.make_decode_runner": lambda: bench.make_decode_runner({}, cfg, "xla", "cuda"),
        "cli.benchmark.main": lambda: cli_benchmark.main(["--model", "/nonexistent"]),
        "kernel_dispatch.main": lambda: kernel_dispatch.main(),
        "bench_prefill.main": lambda: bench_prefill.main(),
        "bench_spec.main": lambda: bench_spec.main(),
        "create_generator": lambda: create_generator("/nonexistent"),
        "enable_compilation_cache": lambda: enable_compilation_cache(),
        "trace": lambda: trace("/nonexistent").__enter__(),
        "bench_serving.main": lambda: bench_serving.main(["--preset", "tiny"]),
        "bench_7b.main": lambda: bench_7b.main([]),
        "bench_7b.build_quantized_llama7b": lambda: bench_7b.build_quantized_llama7b(),
        "bench_decode_accounting.main": lambda: bench_decode_accounting.main(["--preset", "tiny"]),
        "bench_decode_accounting.account": lambda: bench_decode_accounting.account({}, cfg, 1, [1]),
        "bench_kv_quant.main": lambda: bench_kv_quant.main(),
        "bench_a8_accuracy.main": lambda: bench_a8_accuracy.main(["--preset", "tiny"]),
        "cli.evaluate.main": lambda: cli_evaluate.main(["--model", "/nonexistent", "--synthetic"]),
        "cli.chat.main": lambda: cli_chat.main(["--model", "/nonexistent"]),
        "bench_longcontext.main": lambda: bench_longcontext.main(["--arm", "ppl16k"]),
        "bench_longcontext.build_w4": lambda: bench_longcontext.build_w4("tiny"),
        "cli.serve.main": lambda: cli_serve.main(["--model", "/nonexistent"]),
        "cli.serve.build": lambda: cli_serve.build(["--model", "/nonexistent"]),
        "rtn_baseline.main": lambda: rtn_baseline.main(["--model", "preset:tiny",
                                                        "--output", "/nonexistent"]),
        "gptq_baseline.main": lambda: gptq_baseline.main(["--model", "preset:tiny",
                                                          "--output", "/nonexistent"]),
        "gptq_quantize_model": lambda: gptq_quantize_model({"layers": []}, cfg,
                                                           np.zeros((1, 8), np.int32)),
        "calibrate_model": lambda: calibrate_model({"layers": []}, cfg,
                                                   np.zeros((1, 1, 8), np.int32), CalibConfig()),
        "cli.optimize.main": lambda: cli_optimize.main(["--model", "preset:tiny",
                                                        "--output", "/nonexistent"]),
        "cli.convert.main": lambda: cli_convert.main(["--model", "preset:tiny", "--results",
                                                      "/nonexistent", "--output", "/nonexistent"]),
        "bench_calibration.main": lambda: bench_calibration.main([]),
        "LinearAttnStates.create": lambda: LinearAttnStates.create(hybrid, 1),
        "init_gemma3n_params": lambda: init_gemma3n_params(PRESETS["tiny-gemma3n"]),
        "kv_cache_from_jax": lambda: kv_cache_from_jax(
            type("C", (), dict(k=(), v=(), length=np.int32(0), linear=None))()),
    }


@pytest.mark.parametrize(
    "name",
    ["resolve_device", "init_params", "KVCache.create", "Generator", "load_checkpoint",
     "quantize_model_rtn", "Engine", "PagedKVCache.create", "paged_cache_from_jax",
     "profile_paged_decode", "kernel_bench3.main", "kernel_bench4.main",
     "plot_kernel_speedup.main", "w4_i4_from_jax", "kernel_time_ms", "kernel_edge_test.main",
     "kernel_dma_pipeline.main", "kernel_tune.main", "kernel_w4a8_exp.main",
     "kernel_int8_probe.main", "kernel_unpack_exp.main", "profile_prefill", "flash_key_groups",
     "one_launch_phases.main", "bench.main", "bench.make_decode_runner", "cli.benchmark.main",
     "kernel_dispatch.main", "bench_prefill.main", "bench_spec.main", "create_generator",
     "enable_compilation_cache", "trace", "bench_serving.main", "bench_7b.main",
     "bench_7b.build_quantized_llama7b", "bench_decode_accounting.main",
     "bench_decode_accounting.account", "bench_kv_quant.main", "bench_a8_accuracy.main",
     "cli.evaluate.main", "cli.chat.main", "bench_longcontext.main", "bench_longcontext.build_w4",
     "cli.serve.main", "cli.serve.build", "rtn_baseline.main", "gptq_baseline.main",
     "gptq_quantize_model", "calibrate_model", "cli.optimize.main", "cli.convert.main",
     "bench_calibration.main", "LinearAttnStates.create", "kv_cache_from_jax",
     "init_gemma3n_params"],
)
def test_cuda_default_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_cpu_when_asked():
    from paroquant_tpu_torch.models import PRESETS, KVCache

    cache = KVCache.create(PRESETS["tiny"], 1, 8, device="cpu")
    assert cache.k[0].device.type == "cpu" and cache.length.device.type == "cpu"
