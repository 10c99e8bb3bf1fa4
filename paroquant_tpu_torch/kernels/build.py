"""Build the package's CUDA sources at first use and load them with ctypes.

Each `csrc/*.cu` file exports a plain C interface (`extern "C"` launchers
taking device pointers and the stream), so it compiles with `nvcc` alone in
seconds: no PyTorch headers, no ninja. Every source gets its own `nvcc`
process, all started together, and its own shared library. The build
directory is keyed by a hash of the sources and the flags, so a changed
source rebuilds and an unchanged one is loaded as it is. The directory
(`kernels/_build/`) is listed in `.gitignore`.

A failed build raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds taken and whether the libraries were found already built, for
# the first build_all() of this process
build_info: dict[str, object] = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every csrc/*.cu (in parallel) unless already built, load them all."""
    with _lock:
        if _libs:
            return _libs
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
        procs = []
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
            log = open(out_dir / f"{src.stem}.log", "w")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for src, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append((src, (out_dir / f"{src.stem}.log").read_text()))
            else:
                os.replace(tmp, out_dir / f"lib{src.stem}.so")
        if failed:
            msg = "\n".join(f"--- nvcc failed on {s.name}:\n{text}" for s, text in failed)
            raise RuntimeError(msg)
        for src in _sources():
            _libs[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        build_info.update(seconds=time.perf_counter() - t0, cached=not todo, dir=str(out_dir))
        return _libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu."""
    return build_all()[stem]


def ptxas_report() -> str:
    """nvcc's resource lines (registers, shared memory, spills) from the last
    build, each kernel's after the line that names it."""
    out_dir = _build_dir()
    lines = []
    for log in sorted(out_dir.glob("*.log")):
        lines += [ln for ln in log.read_text().splitlines()
                  if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
    return "\n".join(lines)
