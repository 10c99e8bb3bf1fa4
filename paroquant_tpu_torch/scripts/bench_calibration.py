"""Calibration throughput at production layer scale, the port of
`scripts/bench_calibration.py`.

    python -m paroquant_tpu_torch.scripts.bench_calibration [--preset qwen3-8b]
        [--layers 2] [--tokens 65536] [--epochs 1] [--device cuda|cpu]

Times the layer-wise calibration pipeline (teacher capture -> pseudo-quant
optimization -> hard quantize -> student re-capture) on Qwen3-8B-geometry
layers (hidden 4096, intermediate 12288, random bf16 weights from seed 0)
with the canonical two-stage recipe cut to --epochs per stage, then
extrapolates to the full 36-layer model at the reference's 2048 x
2048-token protocol. Prints one JSON line with the JAX script's keys, plus
the peak device memory (`peak_mem_gib`, null on the CPU). `config` takes a
narrow model for tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..models import PRESETS, init_params
from ..optim import CalibConfig, calibrate_model
from ..utils.device import resolve_device


def main(argv=None, config=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--tokens", type=int, default=65536,
                    help="total calibration tokens (batches derived)")
    ap.add_argument("--epochs", type=int, default=1, help="epochs per stage")
    ap.add_argument("--act-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--resident-gb", type=float, default=8.0)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = config or PRESETS[args.preset]
    cfg = dataclasses.replace(base, num_hidden_layers=args.layers)
    full_layers = PRESETS[args.preset].num_hidden_layers
    params = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)

    n_batches = max(2, args.tokens // (args.batch * args.seqlen))
    rng = np.random.default_rng(0)
    token_batches = rng.integers(
        0, cfg.vocab_size, (n_batches, args.batch, args.seqlen)
    ).astype(np.int32)

    ccfg = CalibConfig(
        n_bits=4, group_size=128, num_rotations=8,
        stages=(
            ({"channel_scales": 5e-2, "angles": 5e-2}, args.epochs),
            ({"weight": 1e-5, "quantizer": 1e-6}, args.epochs),
        ),
        act_dtype=torch.bfloat16 if args.act_dtype == "bfloat16" else torch.float32,
        resident_act_bytes=int(args.resident_gb * 2**30),
    )
    per_layer_times: list[float] = []
    t_prev = time.perf_counter()

    def progress(li, n, info):
        nonlocal t_prev
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        per_layer_times.append(now - t_prev)
        t_prev = now

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    calibrate_model(params, cfg, token_batches, ccfg, progress_fn=progress, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    # steady state = the last layer (the first pays the one-time set-up)
    steady = per_layer_times[-1] if per_layer_times else wall
    ref_epochs = 5  # canonical recipe epochs per stage
    ref_tokens = 2048 * 2048
    scale = (ref_epochs / args.epochs) * (ref_tokens / (n_batches * args.batch * args.seqlen))
    est_full_h = full_layers * steady * scale / 3600
    out = {
        "metric": "calibration_layer_seconds_8b_geometry",
        "value": round(steady, 1),
        "unit": "s/layer",
        "tokens": int(n_batches * args.batch * args.seqlen),
        "epochs_per_stage": args.epochs,
        "first_layer_s": round(per_layer_times[0], 1) if per_layer_times else None,
        "wall_s": round(wall, 1),
        "est_full_recipe_hours_36L_4M_tokens": round(est_full_h, 2),
        "peak_mem_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 2)
                         if dev.type == "cuda" else None),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
