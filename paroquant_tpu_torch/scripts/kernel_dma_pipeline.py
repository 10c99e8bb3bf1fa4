"""A hand-scheduled weight stream against K1: the port of `scripts/kernel_dma_pipeline.py`.

    python -m paroquant_tpu_torch.scripts.kernel_dma_pipeline [--size 4096] [--m 1] [--gb 4]

The JAX script streams the W4 weight by hand through two buffers (chunks
of Gb groups, the next in flight while one is consumed) and compares that
with the automatically pipelined kernel. On the card the "dma" arm is K11
(`dma_rot_w4_matmul`: the weight copied into two shared-memory stages with
`cp.async`) and the "prod" arm is K1 (`rot_w4_matmul`, bf16 scales and
zeros). The script's cases and seed: `np.random.default_rng(0)` drawn in
the same order (x, rotations, random weight bytes, f32 scales and zeros),
then moved to torch. `main` first prints the script's two parity lines,
K11 against K8 (`rot_w4_matmul_mg` at groups_per_step = Gb, the same
numerics) and against K1, then times the arms. A row's bytes are the
script's (weight, f32 scales and zeros, bf16 rotations, x twice). Timing
and rows: `bench_common.py`. `main(device="cpu")` runs the plain versions
on the host clock, for the logic only.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import rot_matmul as rm, w4_experiments as wx
from ..utils.device import resolve_device
from .bench_common import Case, tensor, time_cases

BF16, F32, U8 = torch.bfloat16, torch.float32, torch.uint8
S = 128


def operands(device, size=4096, m=1):
    """x, rot, qweight, scales, zeros as the script draws them."""
    I = O = size
    G = size // S
    rng = np.random.default_rng(0)
    x = tensor(rng.standard_normal((m, I)), BF16, device)
    rot = tensor(rng.standard_normal((G, S, S)) / np.sqrt(S), BF16, device)
    qw = tensor(rng.integers(0, 256, (I // 2, O)), U8, device)
    scales = tensor(rng.uniform(0.001, 0.02, (G, O)), F32, device)
    zeros = tensor(rng.integers(0, 16, (G, O)), F32, device)
    return x, rot, qw, scales, zeros


def cases(device, size=4096, m=1, gb=4, ops=None) -> list[Case]:
    """The timed arms "dma" (K11) and "prod" (K1)."""
    x, rot, qw, scales, zeros = ops or operands(device, size, m)
    G = size // S
    nbytes = size * size // 2 + G * size * 4 + G * S * S * 2 + 2 * m * size
    sb, zb = scales.to(BF16), zeros.to(BF16)
    return [
        Case("dma", lambda xv: wx.dma_rot_w4_matmul(xv, rot, qw, scales, zeros, Gb=gb), x, nbytes),
        Case("prod", lambda xv: rm.rot_w4_matmul(xv, rot, qw, sb, zb), x, nbytes),
    ]


def main(device="cuda", *, reps: int = 30, size: int = 4096, m: int = 1, gb: int = 4) -> list[dict]:
    """Print the parity lines, then time the arms; returns the rows."""
    dev = resolve_device(device)
    ops = operands(dev, size, m)
    x, rot, qw, scales, zeros = ops
    sb, zb = scales.to(BF16), zeros.to(BF16)
    a = wx.dma_rot_w4_matmul(x, rot, qw, scales, zeros, Gb=gb).float()
    b = rm.rot_w4_matmul_mg(x, rot, qw, sb, zb, groups_per_step=gb).float()
    c = rm.rot_w4_matmul(x, rot, qw, sb, zb).float()
    denom = b.abs().mean()
    print(f"parity vs mg kernel (same semantics): max |d|/mean|y| "
          f"{((a - b).abs().max() / denom).item():.5f}", flush=True)
    print(f"vs prod kernel (f32 zp-decomposition): max |d|/mean|y| "
          f"{((a - c).abs().max() / denom).item():.5f} (bf16 dequant rounding)", flush=True)
    return time_cases(cases(dev, size, m, gb, ops), dev, reps)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--gb", type=int, default=4, help="groups per streamed chunk")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    main(reps=args.reps, size=args.size, m=args.m, gb=args.gb)
