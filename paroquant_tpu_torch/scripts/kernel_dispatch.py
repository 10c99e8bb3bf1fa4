"""Fused kernel against the plain dequant path of a quantized linear, over M:
the port of `scripts/kernel_dispatch.py`.

    python -m paroquant_tpu_torch.scripts.kernel_dispatch
    DISPATCH_MS=1,16,128 DISPATCH_REPS=30 python -m paroquant_tpu_torch.scripts.kernel_dispatch

For each token count M, one call of `ops/qlinear.py::quantized_linear_forward`
on the JAX script's 4096 x 4096 g128 layer (its seeds and draws) with
mode="fused" (K1: one launch at M <= 16, the three passes above) and with
mode="xla" (the rotation, then a matmul on the dequantized weight), each
timed by `utils/profiling.py::kernel_time_ms`: CUDA events around the call
after an L2 flush, the median of DISPATCH_REPS. The JAX script timed chains
of calls inside one program at two lengths and took the slope, a method for
its TPU behind a relay; on the card one call is timed directly. It prints
a row a M and the winner table, the measurement behind `AUTO_FUSED_MAX_M`
(`ops/qlinear.py`), which this script reads and does not change.
`main(device="cpu", ...)` runs the plain versions on the host clock, for
the logic only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.packing import pack_w4_tpu
from ..ops.qlinear import AUTO_FUSED_MAX_M, QuantizedLinear, quantized_linear_forward
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms
from .bench_common import device_name, tensor

MODES = ("fused", "xla")


def env_ms() -> tuple[int, ...]:
    return tuple(int(m) for m in
                 os.environ.get("DISPATCH_MS", "1,16,64,128,256,512,1024,2048").split(","))


def env_reps() -> int:
    return int(os.environ.get("DISPATCH_REPS", "9"))


def make_layer(device, I=4096, O=4096, GS=128) -> QuantizedLinear:
    G = I // GS
    rng = np.random.default_rng(0)
    q = rng.integers(0, 16, size=(I, O), dtype=np.int32)
    return QuantizedLinear(
        qweight=pack_w4_tpu(q, GS).to(device),
        scales=tensor(rng.uniform(0.01, 0.05, (G, O)), torch.bfloat16, device),
        zeros=tensor(rng.integers(0, 16, (G, O)), torch.bfloat16, device),
        rot=tensor(rng.normal(size=(G, GS, GS)) / np.sqrt(GS), torch.bfloat16, device),
        bias=None,
    )


def main(device="cuda", ms: tuple[int, ...] | None = None, reps: int | None = None,
         I=4096, O=4096, GS=128) -> list[dict]:
    """Time both modes at each M (default $DISPATCH_MS), print the rows and
    the winner table, and return the rows."""
    dev = resolve_device(device)
    ms = ms or env_ms()
    reps = reps or env_reps()
    layer = make_layer(dev, I, O, GS)
    rng = np.random.default_rng(1)
    print(f"# {I}x{O} g{GS}, median of {reps} after an L2 flush [{device_name(dev)}]", flush=True)
    print(f"{'M':>6} {'fused us':>10} {'xla us':>10}  winner", flush=True)
    rows = []
    for M in ms:
        x = tensor(rng.normal(size=(M, I)), torch.bfloat16, dev)
        us = {mode: kernel_time_ms(lambda mode=mode: quantized_linear_forward(layer, x, mode=mode),
                                   reps, device=dev) * 1e3
              for mode in MODES}
        winner = "fused" if us["fused"] <= us["xla"] else "xla"
        rows.append({"M": M, "fused_us": us["fused"], "xla_us": us["xla"], "winner": winner})
        print(f"{M:>6} {us['fused']:>10.1f} {us['xla']:>10.1f}  {winner}", flush=True)
    won = {mode: ", ".join(str(r["M"]) for r in rows if r["winner"] == mode) or "none"
           for mode in MODES}
    print(f"winner table: fused at M {won['fused']}; xla at M {won['xla']}; "
          f"AUTO_FUSED_MAX_M = {AUTO_FUSED_MAX_M}", flush=True)
    return rows


if __name__ == "__main__":
    main()
