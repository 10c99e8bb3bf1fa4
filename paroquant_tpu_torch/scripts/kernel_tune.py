"""The M tile of the one-launch dense-rotation kernel: the port of `scripts/kernel_tune.py`.

    python -m paroquant_tpu_torch.scripts.kernel_tune

The JAX script times its `rot_w4_matmul_v2` at 16 and 8 rows per block
(and once more with a Mosaic grid-semantics hint). On the card that is K12
(`rot_w4_matmul_v2`) with `block_m` 16 and 8, the rows one block carries.
The hint has no counterpart on the card, so its "+sem" case is left out.
The script's cases and seed: M = 1, I = O = 4096, group 128,
`np.random.default_rng(0)` drawn in the same order (bf16 x from f32
draws, f32 scales and zeros, bf16 rotations from f32 draws), then moved to
torch; its unused f16/uint8 copies of the scales and zeros are not made.
A row's bytes are the script's (weight, f32 scales and zeros, bf16
rotations). Timing and rows: `bench_common.py`. `main(device="cpu")` runs
the plain version on the host clock, for the logic only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import w4_experiments as wx
from ..ops.packing import pack_w4_tpu
from ..utils.device import resolve_device
from .bench_common import Case, tensor, time_cases

BF16, F32 = torch.bfloat16, torch.float32


def cases(device, M=1, I=4096, O=4096, GS=128) -> list[Case]:
    """K12 at block_m 16, then 8, as the script runs them."""
    G = I // GS
    rng = np.random.default_rng(0)
    x16 = tensor(rng.normal(size=(M, I)), F32, device).to(BF16)
    qweight = pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), GS).to(device)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), F32, device)
    zeros = tensor(rng.integers(0, 16, (G, O)), F32, device)
    rot16 = tensor(rng.normal(size=(G, GS, GS)), F32, device).to(BF16)
    v2f_bytes = I * O // 2 + 2 * G * O * 4 + G * GS * GS * 2
    return [
        Case(f"v2 bf16rot TM{bm}",
             lambda xv, bm=bm: wx.rot_w4_matmul_v2(xv, rot16, qweight, scales, zeros, block_m=bm),
             x16, v2f_bytes)
        for bm in (16, 8)
    ]


def main(device="cuda", *, reps: int = 30, **shape) -> list[dict]:
    """Time the cases; returns their rows. `shape` (M, I, O, GS) shrinks them for a check."""
    dev = resolve_device(device)
    return time_cases(cases(dev, **shape), dev, reps)


if __name__ == "__main__":
    main()
