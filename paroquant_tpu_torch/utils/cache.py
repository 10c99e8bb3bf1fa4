"""Build the CUDA kernels ahead of use: the port's counterpart of
`paroquant_tpu/utils/cache.py::enable_compilation_cache`.

JAX keeps compiled programs in XLA's persistent cache. The port's compiled
programs are the kernel libraries that `kernels/build.py` builds with
`nvcc` into its build root (`kernels/_build/` by default, listed in
`.gitignore`), keyed by a hash of the sources, and loads from there when
they are already built. This function names that root and builds or loads
every library at once, so that no timed region pays for `nvcc`.
"""

from __future__ import annotations

import os
from pathlib import Path

from .device import resolve_device


def enable_compilation_cache(path: str | None = None, device="cuda") -> None:
    """`path`, else $PAROQUANT_CACHE_DIR, else `kernels/_build/` is the
    build root; on CUDA every kernel library is built there (or loaded when
    already built). On the CPU there is nothing to build: it returns at
    once, as JAX's returns on the CPU. A root named after the libraries
    were loaded in this process takes effect in the next one."""
    if resolve_device(device).type != "cuda":
        return
    from ..kernels import build

    root = path or os.environ.get("PAROQUANT_CACHE_DIR")
    if root:
        build.BUILD_ROOT = Path(root)
    build.build_all()
