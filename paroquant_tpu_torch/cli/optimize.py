"""Calibration CLI: learn each layer's rotations and channel scales, then
write the per-layer results (and optionally a PARO-TPU checkpoint).

    python -m paroquant_tpu_torch.cli.optimize --model <dir|preset:NAME> \
        --output out/ --datasets synthetic --train-size 16 --seqlen 512 \
        [--save-checkpoint] [--device cpu]

The port of `paroquant_tpu/cli/optimize.py`, with its flags. Stage syntax:
--params "channel_scales:0.05,angles:0.05" "weight:1e-5,quantizer:1e-6"
with one --epochs value per stage. Per-layer results persist as
`<layer>.<name>.npz` in --output and --resume skips finished layers.
--device is cuda (the default) or cpu; --dp above 1 raises (data-parallel
calibration is ROADMAP §A 7). A preset's random weights come from the
port's seeded `init_params`, not JAX's.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import torch


def parse_stage(spec: str) -> dict[str, float]:
    groups = {}
    for part in spec.split(","):
        name, lr = part.split(":")
        groups[name.strip()] = float(lr)
    return groups


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="checkpoint dir or preset:<name>")
    ap.add_argument("--output", required=True)
    ap.add_argument("--datasets", nargs="+", default=["wikitext2", "c4", "redpajama"])
    ap.add_argument("--val-dataset", default="pileval")
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--val-size", type=int, default=64)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument(
        "--params", nargs="+",
        default=["channel_scales:0.05,angles:0.05", "weight:1e-5,quantizer:1e-6"],
    )
    ap.add_argument("--epochs", nargs="+", type=int, default=[5, 5])
    ap.add_argument("--n-bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--num-rotations", type=int, default=8)
    ap.add_argument("--pair-mode", default="random", choices=["random", "butterfly"],
                    help="'random' matches the reference protocol (seeded "
                    "independent pairs); 'butterfly' is the structured variant")
    ap.add_argument("--skip", nargs="*", default=["linear_attn.in_proj_ba"],
                    help="module names left dense (reference --skipped-modules)")
    ap.add_argument("--loss", default="mse", choices=["mse", "smooth_l1"])
    ap.add_argument("--resident-act-gb", type=float, default=4.0,
                    help="device budget for a layer's staged activations; "
                         "past it, batches stream host->device per step")
    ap.add_argument("--act-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="staging dtype for activations (bfloat16 halves memory "
                         "and copies at 8B+ scale)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--early-stop", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel devices for calibration (1 = single device)")
    ap.add_argument("--wandb", default=None, help="wandb project name (optional)")
    ap.add_argument("--save-checkpoint", action="store_true",
                    help="also write the quantized PARO-TPU checkpoint to <output>/model")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.dp > 1:
        raise NotImplementedError(
            "--dp > 1 (data-parallel calibration over a mesh) needs parallel/, which the port "
            "has not yet (ROADMAP §A 7)")
    if len(args.params) != len(args.epochs):
        raise SystemExit("--params and --epochs must pair up")
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "args.json").write_text(json.dumps(vars(args), indent=2, default=str))

    from ..models import PRESETS, init_params
    from ..optim import CalibConfig, calibrate_model
    from ..optim.data import get_mixed_calib_dataset
    from ..serve.generator import load_tokenizer

    tokenizer = None
    hf_config = None
    if args.model.startswith("preset:"):
        config = PRESETS[args.model.split(":", 1)[1]]
        params = init_params(config, args.seed, dtype=torch.float32, device=dev)
    else:
        from ..convert import load_checkpoint

        params, config = load_checkpoint(args.model, dtype=torch.float32, device=dev)
        tokenizer = load_tokenizer(args.model)
        hf_config = json.loads((Path(args.model) / "config.json").read_text())

    n_batches = max(args.train_size // args.batch_size, 1)
    tokens = get_mixed_calib_dataset(
        args.datasets, tokenizer, n_batches * args.batch_size, args.seqlen,
        args.seed, config.vocab_size,
    ).reshape(n_batches, args.batch_size, args.seqlen)

    stages = tuple((parse_stage(spec), ep) for spec, ep in zip(args.params, args.epochs))
    ccfg = CalibConfig(
        n_bits=args.n_bits, group_size=args.group_size,
        num_rotations=args.num_rotations, pair_mode=args.pair_mode,
        seed=args.seed, stages=stages, loss=args.loss,
        grad_accum=args.grad_accum, early_stop=args.early_stop,
        skip=tuple(args.skip),
        resident_act_bytes=int(args.resident_act_gb * (1 << 30)),
        act_dtype=torch.bfloat16 if args.act_dtype == "bfloat16" else torch.float32,
    )
    run = None
    if args.wandb:
        try:
            import wandb

            run = wandb.init(project=args.wandb, config=vars(args))
        except ImportError:
            print("wandb not installed; continuing without metric logging")

    t0 = time.time()
    _, exports = calibrate_model(
        params, config, tokens, ccfg, output_dir=out, resume=args.resume, device=dev,
        progress_fn=lambda li, n, info: (
            print(f"[{li+1}/{n}] layer done in {info['seconds']:.1f}s", flush=True),
            run.log({"layer": li, "layer_seconds": info["seconds"]}) if run else None,
        ),
    )
    print(f"calibration finished in {time.time()-t0:.1f}s; results in {out}")

    if args.save_checkpoint:
        from ..convert import save_paro_checkpoint

        save_paro_checkpoint(out / "model", params, config, exports, hf_config)
        print(f"quantized checkpoint written to {out/'model'}")


if __name__ == "__main__":
    main()
