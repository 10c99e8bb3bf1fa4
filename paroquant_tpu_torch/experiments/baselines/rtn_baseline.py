"""RTN W4 baseline driver: a dense checkpoint (or a preset with seeded
random weights) -> a round-to-nearest PARO-TPU checkpoint, no calibration.
The port of `experiments/baselines/rtn_baseline.py`; the directory it
writes loads in both packages.

    python -m paroquant_tpu_torch.experiments.baselines.rtn_baseline \
        --model preset:tiny --output /tmp/rtn_ckpt [--hadamard] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch


def load_dense(model: str, dev: torch.device):
    """(params f32, config) of `preset:<name>` (init_params, seed 0) or a
    dense checkpoint directory."""
    from ...convert import load_checkpoint
    from ...models import PRESETS, init_params

    if model.startswith("preset:"):
        config = PRESETS[model.split(":", 1)[1]]
        return init_params(config, 0, dtype=torch.float32, device=dev), config
    return load_checkpoint(model, dtype=torch.float32, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="dense checkpoint dir or preset:<name>")
    ap.add_argument("--output", required=True)
    ap.add_argument("--n-bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--quantize-lm-head", action="store_true",
                    help="accepted as the reference script accepts it; the export "
                         "leaves the lm_head dense either way")
    ap.add_argument("--hadamard", action="store_true",
                    help="rotate each group by the Hadamard-equivalent "
                         "butterfly before quantizing (QuaRot/SpinQuant-style)")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)

    from ...convert import rtn_export_model, save_paro_checkpoint
    from ...utils.device import resolve_device

    params, config = load_dense(args.model, resolve_device(args.device))
    exports = rtn_export_model(params, config, n_bits=args.n_bits, group_size=args.group_size,
                               hadamard=args.hadamard)
    save_paro_checkpoint(args.output, params, config, exports)
    kind = "Hadamard-RTN" if args.hadamard else "RTN"
    print(f"{kind} W4 checkpoint written to {args.output}")


if __name__ == "__main__":
    main()
