"""W4 kernel timings on the card: the port of `scripts/kernel_bench4.py`.

    python -m paroquant_tpu_torch.scripts.kernel_bench4

The JAX script's cases, labels, shapes and seed: M = 1, I = O = 4096, group
128, `np.random.default_rng(1)` drawn in the same order, then moved to
torch; a bf16 dense matmul (`torch.matmul`, the yardstick the script
defines), w4_matmul, rot_w4_matmul and rot_w4_matmul_mg at 16 and 32 groups
per step, bf16 scales and zeros. Timing and rows: `bench_common.py`.
`main(device="cpu")` runs the plain versions on the host clock, for the
logic only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rot_matmul as rm
from ..ops.packing import pack_w4_tpu
from ..utils.device import resolve_device
from .bench_common import Case, tensor, time_cases


def cases(device, M=1, I=4096, O=4096, GS=128) -> list[Case]:
    G = I // GS
    bf16 = torch.bfloat16
    rng = np.random.default_rng(1)
    x = tensor(rng.normal(size=(M, I)), bf16, device)
    qweight = pack_w4_tpu(rng.integers(0, 16, (I, O), dtype=np.int32), GS).to(device)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), bf16, device)
    zeros = tensor(rng.integers(0, 16, (G, O)).astype(np.float32), bf16, device)
    rot = tensor(rng.normal(size=(G, GS, GS)), bf16, device)
    w_dense = tensor(rng.normal(size=(I, O)), bf16, device)

    w4b = I * O // 2 + G * O * 4
    rotb = w4b + G * GS * GS * 2
    return [
        Case("xla_bf16_dense", lambda xv: torch.matmul(xv, w_dense), x, I * O * 2),
        Case("w4 (no rot)", lambda xv: rm.w4_matmul(xv, qweight, scales, zeros), x, w4b),
        Case("fused dense_rot", lambda xv: rm.rot_w4_matmul(xv, rot, qweight, scales, zeros),
             x, rotb),
    ] + [
        Case(f"mg dense_rot Gb={gb}",
             lambda xv, gb=gb: rm.rot_w4_matmul_mg(xv, rot, qweight, scales, zeros,
                                                   groups_per_step=gb), x, rotb)
        for gb in (16, 32)
    ]


def main(device="cuda", *, reps: int = 30, **shape) -> list[dict]:
    """Time the cases; returns their rows. `shape` (M, I, O, GS) shrinks them for a check."""
    dev = resolve_device(device)
    return time_cases(cases(dev, **shape), dev, reps)


if __name__ == "__main__":
    main()
