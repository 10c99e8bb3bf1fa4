"""A prefill-sized quantized matmul (M 512) three ways: the port of
`scripts/bench_prefill.py`.

    python -m paroquant_tpu_torch.scripts.bench_prefill

The JAX script's layer and draws: x [512, 4096] bf16, a dense bf16 weight
[4096, 4096], and a W4 g128 layer with 8 random rotations (angles drawn
with `np.random.default_rng(0)`). Arms: `torch.matmul` on the dense weight,
the W4 layer's plain path (`quantized_linear_forward`, mode "xla": the
rotation, then a matmul on the dequantized weight) and K1
(`kernels/rot_matmul.py::rot_w4_matmul`, which takes its three passes at
this M). Each arm is one call timed by `utils/profiling.py::kernel_time_ms`
(CUDA events after an L2 flush, median of the reps) where the JAX script
took the slope of chains; a row gives its µs and TFLOP/s (2 M I O
operations). The JAX script's fourth arm, the fused kernel at TM = 256,
has no counterpart: K1 takes no `block_m` (its tiles are chosen by
`rot_route`). `main(device="cpu", ...)` runs the plain versions on the
host clock, for the logic only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.rot_matmul import rot_w4_matmul
from ..ops.qlinear import make_quantized_linear, quantized_linear_forward
from ..ops.rotation import make_rotation_params
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms
from .bench_common import device_name, tensor


def main(device="cuda", M=512, I=4096, O=4096, GS=128, K=8, reps=30) -> list[dict]:
    """Time the three arms, print a row each and return the rows."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = tensor(rng.normal(size=(M, I)), torch.bfloat16, dev)
    w_dense = tensor(rng.normal(size=(I, O)), torch.bfloat16, dev)
    params = make_rotation_params(I, GS, K, 0)
    theta = np.where(np.asarray(params.mask), 0,
                     rng.normal(0, 0.2, tuple(params.theta.shape))).astype(np.float32)
    q = rng.integers(0, 16, size=(O, I), dtype=np.int32)
    sc = rng.uniform(0.01, 0.05, (O, I // GS)).astype(np.float32)
    zr = rng.integers(0, 16, (O, I // GS)).astype(np.float32)
    layer = make_quantized_linear(q, sc, zr, np.asarray(params.pairs), theta,
                                  np.ones(I, np.float32), GS, device=dev)
    flops = 2 * M * I * O
    arms = [
        ("bf16_dense", lambda: torch.matmul(x, w_dense)),
        ("w4 xla path", lambda: quantized_linear_forward(layer, x, mode="xla")),
        ("w4 fused kernel",
         lambda: rot_w4_matmul(x, layer.rot, layer.qweight, layer.scales, layer.zeros)),
    ]
    name = device_name(dev)
    rows = []
    for label, fn in arms:
        ms = kernel_time_ms(fn, reps, device=dev)
        row = {"label": label, "M": M, "us": ms * 1e3, "device": name,
               "tflops": flops / (ms * 1e-3) / 1e12 if dev.type == "cuda" else None}
        rate = f" {row['tflops']:>6.1f} TFLOP/s" if row["tflops"] is not None else ""
        print(f"{label:<26}{row['us']:>9.1f}us{rate}  [{name}]", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
