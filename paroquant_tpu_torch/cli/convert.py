"""Checkpoint conversion CLI: calibration results -> a checkpoint.

    python -m paroquant_tpu_torch.cli.convert --model <src> --results <npz dir> \
        --output <dst> --mode real [--format paro-tpu|awq] [--device cpu]

The port of `paroquant_tpu/cli/convert.py`. --mode real assembles a
quantized checkpoint from the per-layer results (`<layer>.<name>.npz`,
written by either package's calibration); --format awq writes the
reference's AWQ-packed layout. --mode pseudo bakes the pseudo-quantized
weights into a dense checkpoint. A preset's random weights come from the
port's seeded `init_params`, not JAX's.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch


def load_results(results_dir: Path) -> list[dict[str, dict]]:
    """Read {layer}.{name}.npz files into per-layer export dicts."""
    pat = re.compile(r"^(\d+)\.(.+)\.npz$")
    layers: dict[int, dict[str, dict]] = {}
    for f in sorted(Path(results_dir).glob("*.npz")):
        m = pat.match(f.name)
        if not m:
            continue
        li, name = int(m.group(1)), m.group(2)
        raw = dict(np.load(f, allow_pickle=True))
        exp = {k: (v.item() if v.ndim == 0 else v) for k, v in raw.items()}
        if not isinstance(exp.get("bias"), np.ndarray):
            exp["bias"] = None
        layers.setdefault(li, {})[name] = exp
    if not layers:
        raise FileNotFoundError(f"no <layer>.<name>.npz results in {results_dir}")
    return [layers.get(i, {}) for i in range(max(layers) + 1)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="source checkpoint dir or preset:<name>")
    ap.add_argument("--results", required=True, help="calibration output dir (npz files)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--mode", default="real", choices=["real", "pseudo"])
    ap.add_argument("--format", default="paro-tpu", choices=["paro-tpu", "awq"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)

    from ..convert import load_checkpoint, save_awq_checkpoint, save_paro_checkpoint
    from ..models import PRESETS, init_params
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    hf_config = None
    if args.model.startswith("preset:"):
        config = PRESETS[args.model.split(":", 1)[1]]
        params = init_params(config, args.seed, dtype=torch.float32, device=dev)
    else:
        params, config = load_checkpoint(args.model, dtype=torch.float32, device=dev)
        hf_config = json.loads((Path(args.model) / "config.json").read_text())

    exports = load_results(Path(args.results))

    if args.mode == "pseudo":
        from ..models.decoder import DenseLinear
        from ..ops.qlinear import effective_weight
        from ..optim.calibrate import _set_linear, quantized_from_export

        layers = list(params["layers"])
        for li, exp_layer in enumerate(exports):
            for name, exp in exp_layer.items():
                we = effective_weight(quantized_from_export(exp, device=dev), torch.float32)
                bias = None if exp["bias"] is None else torch.from_numpy(exp["bias"]).to(dev)
                layers[li] = _set_linear(layers[li], name, DenseLinear(we, bias))
        params = dict(params)
        params["layers"] = layers
        save_paro_checkpoint(Path(args.output), params, config, [], hf_config)
        # pseudo checkpoints are plain dense: drop the quantization_config
        cfgp = Path(args.output) / "config.json"
        cfg = json.loads(cfgp.read_text())
        cfg.pop("quantization_config", None)
        cfgp.write_text(json.dumps(cfg, indent=2) + "\n")
        print(f"pseudo (dense-baked) checkpoint written to {args.output}")
        return

    if args.format == "awq":
        save_awq_checkpoint(Path(args.output), params, config, exports, hf_config)
    else:
        save_paro_checkpoint(Path(args.output), params, config, exports, hf_config)
    n = sum(len(e) for e in exports)
    print(f"converted {n} quantized linears -> {args.output} ({args.format})")


if __name__ == "__main__":
    main()
