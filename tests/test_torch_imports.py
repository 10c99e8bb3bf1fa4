"""The port stands alone: it imports neither jax nor paroquant_tpu, and a
CUDA entry point with no CUDA present raises instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paroquant_tpu_torch

PKG = Path(paroquant_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "safetensors", "paroquant_tpu")


def _modules():
    return sorted(
        "paroquant_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'safetensors', 'paroquant_tpu')]\n"
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
    from paroquant_tpu_torch.models import PRESETS, KVCache, init_params
    from paroquant_tpu_torch.convert.interop import paged_cache_from_jax
    from paroquant_tpu_torch.serve import Engine, Generator, PagedKVCache
    from paroquant_tpu_torch.utils.device import resolve_device
    from paroquant_tpu_torch.utils.profiling import profile_paged_decode

    cfg = PRESETS["tiny"]
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
    }


@pytest.mark.parametrize(
    "name",
    ["resolve_device", "init_params", "KVCache.create", "Generator", "load_checkpoint",
     "quantize_model_rtn", "Engine", "PagedKVCache.create", "paged_cache_from_jax",
     "profile_paged_decode"],
)
def test_cuda_default_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_cpu_when_asked():
    from paroquant_tpu_torch.models import PRESETS, KVCache

    cache = KVCache.create(PRESETS["tiny"], 1, 8, device="cpu")
    assert cache.k[0].device.type == "cpu" and cache.length.device.type == "cpu"
