"""ctypes bindings to the native packing library (native/paropack.cpp).

Counterpart of `paroquant_tpu/ops/native_packing.py`, with the same entry
points and argtypes. The library is built from the in-repo source at first
use with `g++ -O3 -march=native -fopenmp -shared -fPIC` (the flags of
`native/Makefile`) into `kernels/_build/paropack-<hash>/`, keyed by a hash
of the source and the flags, as `kernels/build.py` keys the CUDA builds,
and of the CPU's model and feature flags, since `-march=native` builds for
the CPU it runs on; it never writes into `native/` and never loads
`native/libparopack.so`, the JAX package's build. The compiler is `g++`
itself, not `$CXX`: an environment may point `CXX` at a compiler without
OpenMP's runtime. When the build or the load fails, the failure is
logged at warning level and every entry point returns None, so the caller
takes the numpy path: this is host packing, not a device kernel.
`library()` returns the loaded library or None, for checks that need it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("paroquant_tpu_torch.native")

SOURCE = Path(__file__).resolve().parents[2] / "native" / "paropack.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "kernels" / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-Wall")

_lock = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _cpu_id() -> bytes:
    """The CPU's model name and feature flags, which `-march=native` targets."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()
    first = {}
    for ln in lines:
        key = ln.split(":", 1)[0].strip()
        if key in ("model name", "flags"):
            first.setdefault(key, ln)
    return "\n".join(first.values()).encode()


def library_path() -> Path:
    """Where the library built from the current source and flags for this CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_id())
    return BUILD_ROOT / f"paropack-{h.hexdigest()[:16]}" / "libparopack.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    res = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a process building at the same time never loads half a file


def library() -> ctypes.CDLL | None:
    """The loaded native library, built at first use; None if it is unavailable."""
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native paropack unavailable (%s); using numpy", e)
            return None
        i64 = ctypes.c_int64
        p_i32, p_u8 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
        lib.pack_w4_tpu.argtypes = [p_i32, p_u8, i64, i64, i64]
        lib.pack_w4_tpu.restype = None
        lib.unpack_w4_tpu.argtypes = [p_u8, p_i32, i64, i64, i64]
        lib.unpack_w4_tpu.restype = None
        lib.pack_awq.argtypes = [p_i32, p_i32, i64, i64]
        lib.pack_awq.restype = None
        lib.unpack_awq.argtypes = [p_i32, p_i32, i64, i64]
        lib.unpack_awq.restype = None
        lib.lookup_draft.argtypes = [p_i32, i64, i64, i64, p_i32]
        lib.lookup_draft.restype = i64
        _LIB = lib
        return _LIB


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def pack_w4_tpu_native(q: np.ndarray, group_size: int = 128) -> np.ndarray | None:
    lib = library()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.int32)
    I, O = q.shape
    out = np.empty((I // 2, O), np.uint8)
    lib.pack_w4_tpu(_i32p(q), _u8p(out), I, O, group_size)
    return out


def unpack_w4_tpu_native(packed: np.ndarray, group_size: int = 128) -> np.ndarray | None:
    lib = library()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    Ih, O = packed.shape
    out = np.empty((Ih * 2, O), np.int32)
    lib.unpack_w4_tpu(_u8p(packed), _i32p(out), Ih * 2, O, group_size)
    return out


def pack_awq_native(vals: np.ndarray) -> np.ndarray | None:
    lib = library()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, np.int32)
    R, C = vals.shape
    out = np.empty((R, C // 8), np.int32)
    lib.pack_awq(_i32p(vals), _i32p(out), R, C)
    return out


def unpack_awq_native(packed: np.ndarray) -> np.ndarray | None:
    lib = library()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.int32)
    R, Cp = packed.shape
    out = np.empty((R, Cp * 8), np.int32)
    lib.unpack_awq(_i32p(packed), _i32p(out), R, Cp)
    return out


def native_lookup_draft(ctx: np.ndarray, max_ngram: int, k: int) -> list[int] | None:
    """C++ prompt-lookup drafting (native/paropack.cpp lookup_draft); None
    when the library is unavailable (the caller falls back to the numpy
    scan). ctx: int32 [len] token ids."""
    lib = library()
    if lib is None:
        return None
    ctx = np.ascontiguousarray(ctx, np.int32)
    out = np.empty(k, np.int32)
    n = lib.lookup_draft(_i32p(ctx), len(ctx), max_ngram, k, _i32p(out))
    return out[:n].tolist()
