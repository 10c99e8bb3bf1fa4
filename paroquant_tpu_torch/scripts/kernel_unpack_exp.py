"""What the nibble unpack costs in the W4 GEMV: the port of `scripts/kernel_unpack_exp.py`.

    python -m paroquant_tpu_torch.scripts.kernel_unpack_exp

The JAX script asks how much of the W4 GEMV's time at M = 1 goes to
unpacking the 4-bit weights rather than to streaming them (its docstring
gives the TPU's answer; none of its TPU figures is the port's). Its arms,
each a hand-written kernel on the card (`kernels/unpack_exp.py`):

1. stream only (K18): the same blocks of the weight, read and barely used;
   the bare-stream ceiling of this layout;
2. the baseline, K6 `w4_matmul` (int mask and shift unpack);
3. bitcast-u4 (K19): the weight packed in output-column pairs
   (`pack_w4_opair`), unpacked by the bf16 exponent-bias trick;
4. mulfloor (K20): the unpack in bf16 arithmetic;
5. splitdot (K21, twice: with and without the TPU cost estimate, which has
   no counterpart on the card) and i8 (K22);

and the production rotated kernel, K1 `rot_w4_matmul`. The script's draws:
`np.random.default_rng(1)`, in its order x (M, I), the nibbles (I, O),
scales, zeros, then the rotations (G, GS, GS), at M = 1, I = O = 4096, GS
= 128. The JAX script checks only splitdot against the baseline; the port
checks all five GEMV entry points and prints the script's line for each.
Its byte counts are the script's: I O / 2 for the stream, w4b = I O / 2 +
G O 4 for the W4 arms, w4b + G GS GS 2 with the rotations.

Timing: `bench_common.time_cases`, one call timed with CUDA events and
the L2 flushed before it. The JAX script takes the slope of host-clock
times of chained calls against 819 GB/s, its TPU's rate; on this card the
8 MB weight would sit in the 50 MB L2 between back-to-back calls, and the
rate is 3.35 TB/s. `main(device="cpu")` runs the plain versions on the host
clock, for the logic only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rot_matmul as rm, unpack_exp as ux
from ..ops.packing import pack_w4_tpu
from ..utils.device import resolve_device
from .bench_common import Case, tensor, time_cases

BF16 = torch.bfloat16
SHAPE = dict(M=1, I=4096, O=4096, GS=128)  # the script's main


def pack_w4_opair(q: np.ndarray, group_size: int = 128) -> np.ndarray:
    """[I, O] int4 values -> uint8 [I, O//2]: byte (i, j) holds columns
    (2j, 2j+1) as (lo, hi) nibbles, matching bitcast u8->u4 minor order."""
    lo = q[:, 0::2].astype(np.uint8)
    hi = q[:, 1::2].astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def draws(device, M=1, I=4096, O=4096, GS=128) -> dict:
    """The script's operands, drawn in its order, on `device`."""
    G = I // GS
    rng = np.random.default_rng(1)
    x = tensor(rng.normal(size=(M, I)), BF16, device)
    qint = rng.integers(0, 16, (I, O), dtype=np.int32)
    qweight = pack_w4_tpu(qint, GS).to(device)
    q_opair = torch.from_numpy(pack_w4_opair(qint, GS)).to(device)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), BF16, device)
    zeros = tensor(rng.integers(0, 16, (G, O)).astype(np.float32), BF16, device)
    rot = tensor(rng.normal(size=(G, GS, GS)), BF16, device)  # drawn after the check in the script
    return dict(x=x, qweight=qweight, q_opair=q_opair, scales=scales, zeros=zeros, rot=rot)


def checked(d: dict, GS: int = 128) -> dict:
    """The five GEMV entry points on the script's operands, by the script's names."""
    x, qw, s, z = d["x"], d["qweight"], d["scales"], d["zeros"]
    return {
        "splitdot": lambda: ux.w4_matmul_splitdot(x, qw, s, z, group_size=GS),
        "splitdot+CE": lambda: ux.w4_matmul_splitdot_ce(x, qw, s, z, group_size=GS),
        "bitcast": lambda: ux.w4_matmul_bitcast(x, d["q_opair"], s, z, group_size=GS),
        "mulfloor": lambda: ux.w4_matmul_mulfloor(x, qw, s, z, group_size=GS),
        "i8": lambda: ux.w4_matmul_i8(x, qw, s, z, group_size=GS),
    }


def cases(d: dict, GS: int = 128) -> list[Case]:
    """The script's eight timed cases, in its order, with its labels and bytes."""
    x, qw, qo, s, z, rot = (d[k] for k in ("x", "qweight", "q_opair", "scales", "zeros", "rot"))
    I, O = x.shape[1], qw.shape[1]
    G = I // GS
    w4b = I * O // 2 + G * O * 4
    rotb = w4b + G * GS * GS * 2
    return [
        Case("stream Gb=1", lambda xv: ux.stream_only(xv, qw, group_size=GS)[:1, :I], x, I * O // 2),
        Case("w4 uint8 (baseline)", lambda xv: rm.w4_matmul(xv, qw, s, z, group_size=GS), x, w4b),
        Case("w4 splitdot", lambda xv: ux.w4_matmul_splitdot(xv, qw, s, z, group_size=GS), x, w4b),
        Case("w4 splitdot+CE", lambda xv: ux.w4_matmul_splitdot_ce(xv, qw, s, z, group_size=GS),
             x, w4b),
        Case("w4 bitcast-u4", lambda xv: ux.w4_matmul_bitcast(xv, qo, s, z, group_size=GS), x, w4b),
        Case("w4 mulfloor", lambda xv: ux.w4_matmul_mulfloor(xv, qw, s, z, group_size=GS), x, w4b),
        Case("w4 i8-bitcast", lambda xv: ux.w4_matmul_i8(xv, qw, s, z, group_size=GS), x, w4b),
        Case("rot dense (prod)", lambda xv: rm.rot_w4_matmul(xv, rot, qw, s, z), x, rotb),
    ]


def main(device="cuda", *, reps: int = 30, **shape) -> tuple[dict, list[dict]]:
    """Hold each GEMV entry point against the baseline (K6), printing the
    script's line, then time the eight cases. Returns ({name: max rel err},
    rows). `shape` (M, I, O, GS) shrinks the operands for a check."""
    dev = resolve_device(device)
    shp = {**SHAPE, **shape}
    d = draws(dev, **shp)
    base = rm.w4_matmul(d["x"], d["qweight"], d["scales"], d["zeros"], group_size=shp["GS"]).float()
    errs = {}
    for name, fn in checked(d, shp["GS"]).items():
        got = fn().float()
        err = ((got - base).abs().max() / (base.abs().max() + 1e-9)).item()
        errs[name] = err
        print(f"{name}: max rel err vs baseline {err:.2e}", flush=True)
    return errs, time_cases(cases(d, shp["GS"]), dev, reps)


if __name__ == "__main__":
    main()
