"""Time the RA8 variant's group splits at Qwen3-0.6B's lm_head, on the card.

    python -m paroquant_tpu_torch.scripts.ra8_split_sweep [--M 1 8 16] [--reps 30]

K1's `a8` call at 1024 -> 151936 (random weights from a seeded
`torch.Generator`, g128, bf16 x, rot, scales and zeros) is wider than one
wave of one-launch blocks, so `kernels/rot_matmul.py::ra8_plan` gives each
block a run of column tiles. For each M this prints one JSON line: the
time of one call (`utils/profiling.py::kernel_time_ms`, L2 flushed) at 8, 4
and 2 splits (1, 2 and 4 groups a split; 512-column tiles, the shortest
runs that fit one wave), the plan `ra8_plan` picks, the three passes and
`torch.matmul` on the pre-rotated, dequantized bf16 weight, beside the
card's name and power limit. Each split's output is held to 2e-2 x max |y|
of the plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..kernels import rot_matmul as rm
from ..ops.packing import pack_w4_tpu
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms

I, O, S = 1024, 151936, 128  # Qwen3-0.6B's lm_head
FLUSH_BYTES = 256 << 20  # > the 50 MB L2
TOL = 2e-2  # chip_smoke.py's TOL_KERNEL


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _passes(M, I_, S_, out_splits, a8, rot_dtype, sms):
    n_tiles = sum(-(-n // rm.COLS_PER_TILE) for n in out_splits)
    KS = rm._group_splits(n_tiles, -(-M // rm.ROWS_PER_TILE), I_ // S_, sms)
    return "passes", KS, rm.COLS_PER_TILE


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--M", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G = I // S
    bf = torch.bfloat16
    q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
    scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(bf)
    zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(bf)
    rot = (torch.randn(1, G, S, S, generator=gen, device=dev) / S**0.5).to(bf)
    qw = pack_w4_tpu(q, S)
    wd = (q.reshape(G, S, O).float() - zeros[:, None].float()) * scales[:, None].float()
    w_eff = torch.einsum("gij,gio->gjo", rot[0].float(), wd).reshape(I, O).to(bf)
    del wd
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    sms = rm._sm_count(dev)
    card = _card()
    rows = []
    for M in args.M:
        x = torch.randn(M, I, generator=gen, device=dev).to(bf)
        y_ref = rm.rot_w4_matmul_plain(x, rot[0], qw, scales, zeros, a8=True).float()
        splits = {}
        for gps in (1, 2, 4):
            plan = rm.ra8_plan(M, I, S, (O,), sms, gps=gps)
            fn = lambda: rm.launch_ra8(x, rot, qw, scales, zeros, (O,), plan)
            err = (fn().float() - y_ref).abs().max().item() / y_ref.abs().max().item()
            if err > TOL:
                raise SystemExit(f"RA8 at M={M}, plan {plan}: error {err} of max |y|")
            splits[plan[0]] = {"plan": plan, "us": kernel_time_ms(fn, args.reps, flush) * 1e3,
                               "err_over_max": err}
        run = lambda: rm.rot_w4_matmul(x, rot[0], qw, scales, zeros, a8=True)
        real = rm.rot_route
        rm.rot_route = _passes
        try:
            passes_us = kernel_time_ms(run, args.reps, flush) * 1e3
        finally:
            rm.rot_route = real
        row = {"M": M, "I": I, "O": O, "S": S, "splits": splits,
               "rule": rm.ra8_plan(M, I, S, (O,), sms),
               "rule_us": kernel_time_ms(run, args.reps, flush) * 1e3, "passes_us": passes_us,
               "library_us": kernel_time_ms(lambda: torch.matmul(x, w_eff), args.reps, flush) * 1e3,
               "device": torch.cuda.get_device_name(dev), "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
