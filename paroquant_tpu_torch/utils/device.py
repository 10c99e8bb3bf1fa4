"""Device selection for the port's entry points.

Every entry point takes `device=`. The default is "cuda"; when CUDA is
missing it raises instead of running on the CPU. The CPU runs only when
the caller asks for it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return `device` as a torch.device; raise if it names CUDA and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
