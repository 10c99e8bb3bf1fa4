"""The int8-activation W4 GEMV against the W4A16 one: the port of `scripts/kernel_w4a8_exp.py`.

    python -m paroquant_tpu_torch.scripts.kernel_w4a8_exp

The JAX script quantizes the activations to int8 per (row, 128-group),
takes an exact int8 x nibble dot and A/Bs that against the W4A16 GEMV at
M = 1, 8 and 32. On the card the "w4a8" arm is K13 (`w4a8_matmul`) and the
"w4a16" arm K6 (`w4_matmul`). The script's cases and seed:
`np.random.default_rng(0)`, first a correctness case (M 4, I 256, O 512)
held against the f32 dequantized weight, then one case per M at I = O =
4096, each drawn as the script's `_mk_case` draws it (random weight bytes,
bf16 scales, uint8 zeros, bf16 x), then moved to torch. A row's bytes are
the script's: the weight alone. Timing and rows: `bench_common.py`.
`main(device="cpu")` runs the plain versions on the host clock, for the
logic only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rot_matmul as rm, w4_experiments as wx
from ..kernels.rot_matmul import _unpack_groups
from ..utils.device import resolve_device
from .bench_common import Case, tensor, time_cases

BF16, U8 = torch.bfloat16, torch.uint8
CHECK = (4, 256, 512)  # M, I, O of the script's correctness case


def _mk_case(rng, M, I, O, gs, device):
    G = I // gs
    qw = rng.integers(0, 256, (I // 2, O), dtype=np.uint8)
    scales = rng.random((G, O), dtype=np.float32) * 0.02 + 0.001
    zeros = rng.integers(0, 16, (G, O)).astype(np.uint8)
    x = (rng.standard_normal((M, I)) * 0.5).astype(np.float32)
    return (tensor(x, BF16, device), tensor(qw, U8, device), tensor(scales, BF16, device),
            tensor(zeros, U8, device))


def dequant(qw, scales, zeros, gs) -> torch.Tensor:
    """The f32 dequantized weight [I, O] of the half-split layout."""
    G, O = scales.shape
    q = _unpack_groups(qw, G, gs)
    w = (q - zeros.float()[:, None, :]) * scales.float()[:, None, :]
    return w.reshape(G * gs, O)


def check_case(device, gs=128):
    """The script's correctness case, the first draws of its stream."""
    return _mk_case(np.random.default_rng(0), *CHECK, gs, device)


def cases(device, Ms=(1, 8, 32), I=4096, O=4096, gs=128) -> list[Case]:
    """The w4a8 (K13) and w4a16 (K6) arms at each M."""
    rng = np.random.default_rng(0)
    _mk_case(rng, *CHECK, gs, "cpu")  # the correctness case comes first in the stream
    out = []
    for M in Ms:
        x, qw, s, z = _mk_case(rng, M, I, O, gs, device)
        out += [
            Case(f"M={M} w4a8", lambda xv, a=(qw, s, z): wx.w4a8_matmul(xv, *a, group_size=gs),
                 x, I * O // 2),
            Case(f"M={M} w4a16", lambda xv, a=(qw, s, z): rm.w4_matmul(xv, *a, group_size=gs),
                 x, I * O // 2),
        ]
    return out


def main(device="cuda", *, reps: int = 30, **shape) -> list[dict]:
    """Print the correctness line, time the arms and print each M's speedup;
    returns the rows. `shape` (Ms, I, O, gs) shrinks the timed cases."""
    dev = resolve_device(device)
    gs = shape.get("gs", 128)
    x, qw, s, z = check_case(dev, gs)
    y8 = wx.w4a8_matmul(x, qw, s, z, group_size=gs).float()
    yref = x.float() @ dequant(qw, s, z, gs)
    rel = (y8 - yref).abs() / (yref.abs().mean() + 1e-9)
    print(f"w4a8 vs f32-dequant: max rel err {rel.max().item():.4f} "
          f"mean {rel.mean().item():.5f} (int8 activation rounding)", flush=True)
    rows = time_cases(cases(dev, **shape), dev, reps)
    for a8, a16 in zip(rows[::2], rows[1::2]):
        print(f"{a8['label'].split()[0]}: w4a8 {a8['us']:.2f}us vs w4a16 {a16['us']:.2f}us "
              f"speedup {a16['us'] / a8['us']:.2f}x", flush=True)
    return rows


if __name__ == "__main__":
    main()
