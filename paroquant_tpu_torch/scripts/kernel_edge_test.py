"""One launch against K1's passes: the port of `scripts/kernel_edge_test.py`.

    python -m paroquant_tpu_torch.scripts.kernel_edge_test

The JAX script asks what the fused W4 GEMV's per-call steps cost at M = 1
against M = 16 (its variant b does in one kernel what variant a leaves to
steps around it). On the card variant a is K1 (`rot_w4_matmul`: a rotate
pass, a GEMV pass and, when the groups are split across blocks, a reduce
pass) and variant b is K10 (`rot_w4_matmul_b`: one launch, each block
rotating its own groups). The script's cases and seed: M = 1 and 16, I = O
= 4096, group 128, `np.random.default_rng(0)` drawn in the same order,
then moved to torch. `main` first holds b against a (relative max error
below 1e-2, as the script asserts), then times both arms. A row's bytes
are those of the JAX kernel's cost estimate (the weight, the rotations,
x, the output, the scales and the zeros), which the script does not
print. Timing and rows: `bench_common.py`. `main(device="cpu")` runs the
plain versions on the host clock, for the logic only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rot_matmul as rm, w4_experiments as wx
from ..ops.packing import pack_w4_tpu
from ..utils.device import resolve_device
from .bench_common import Case, tensor, time_cases

BF16 = torch.bfloat16
REL_TOL = 1e-2  # the script's assert on a against b


def cases(device, I=4096, O=4096, GS=128, Ms=(1, 16)) -> list[Case]:
    """Variant a (K1) and variant b (K10) at each M, in the script's order."""
    G = I // GS
    rng = np.random.default_rng(0)
    qw = pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), GS).to(device)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), BF16, device)
    zeros = tensor(rng.integers(0, 16, (G, O)), BF16, device)
    rot = tensor(rng.normal(size=(G, GS, GS)) / np.sqrt(GS), BF16, device)
    out = []
    for M in Ms:
        x0 = tensor(rng.normal(size=(M, I)), BF16, device)
        nbytes = I * O // 2 + G * GS * GS * 2 + M * I * 2 + M * O * 2 + G * O * 4
        out += [
            Case(f"M={M} variant a", lambda xv: rm.rot_w4_matmul(xv, rot, qw, scales, zeros),
                 x0, nbytes),
            Case(f"M={M} variant b", lambda xv: wx.rot_w4_matmul_b(xv, rot, qw, scales, zeros),
                 x0, nbytes),
        ]
    return out


def main(device="cuda", *, reps: int = 30, **shape) -> list[dict]:
    """Hold b against a at each M, then time both; returns the rows. `shape`
    (I, O, GS, Ms) shrinks the cases for a check."""
    dev = resolve_device(device)
    cs = cases(dev, **shape)
    for a, b in zip(cs[::2], cs[1::2]):
        ya, yb = a.step(a.x).float(), b.step(b.x).float()
        err = ((ya - yb).abs().max() / (ya.abs().max() + 1e-9)).item()
        print(f"{a.label.split()[0]} rel err a-vs-b: {err:.2e}", flush=True)
        if not err < REL_TOL:
            raise RuntimeError(f"{b.label} is {err:.2e} off variant a (bound {REL_TOL})")
    return time_cases(cs, dev, reps)


if __name__ == "__main__":
    main()
