"""Model-level accuracy cost of the W4A8 activation rounding, the port of
`scripts/bench_a8_accuracy.py`.

    python -m paroquant_tpu_torch.scripts.bench_a8_accuracy [--preset qwen3-0.6b]
        [--outlier-scale 8] [--n-seq 4] [--seqlen 512] [--device cuda|cpu]

On an outlier-injected random model (f32 weights from seed 0, then
`experiments/baselines/quality_ladder.py::inject_outlier_channels`, then
RTN W4 g128), it measures the logits MSE against the dense model of the
exact W4A16 path ("xla") and of the activation-rounded path ("w4a8_xla":
every token's rotated activations rounded to int8 per 128-group, as the
serving decode kernels round them), the top-1 agreement of each with the
dense model, and of W4A8 with W4A16 directly. One JSON line with the JAX
script's keys, rounded as it rounds them. Both modes are the plain path, so
no kernel runs; the JAX script defaults to the CPU, the port to the card
(`--device cpu` drives it here). The tokens are numpy's
`default_rng(0)` draws, as JAX's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..experiments.baselines.quality_ladder import inject_outlier_channels
from ..models import PRESETS, init_params, model_forward
from ..utils.device import resolve_device


def build(config, outlier_scale: float, device):
    """The dense f32 model (seed 0) with injected outlier channels, and its
    RTN W4 g128 copy."""
    from ..convert.rtn import quantize_model_rtn

    dev = resolve_device(device)
    params = init_params(config, torch.Generator(device=dev).manual_seed(0), torch.float32, dev)
    params = inject_outlier_channels(params, config, outlier_scale)
    qparams = quantize_model_rtn(params, config, n_bits=4, group_size=128, device=dev)
    return params, qparams


def tokens(config, n_seq: int, seqlen: int, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, config.vocab_size, (n_seq, seqlen))
    return torch.from_numpy(toks).to(device=resolve_device(device), dtype=torch.int32)


@torch.no_grad()
def measure(params, qparams, config, toks: torch.Tensor, *, preset: str,
            outlier_scale: float) -> dict:
    """The JAX script's row, unrounded: the three logits sets of `toks`
    compared in f64."""

    def logits_of(p, mode):
        out, _ = model_forward(p, config, toks, None, quant_mode=mode)
        return out.to(torch.float32)

    dense = logits_of(params, "xla")
    w4 = logits_of(qparams, "xla")
    a8 = logits_of(qparams, "w4a8_xla")

    def mse(a, b):
        return float(torch.mean((a.double() - b.double()) ** 2))

    def top1(a, b):
        return float(torch.mean((torch.argmax(a, -1) == torch.argmax(b, -1)).double()))

    return {
        "metric": "w4a8_model_accuracy",
        "preset": preset,
        "outlier_scale": outlier_scale,
        "tokens": int(toks.numel()),
        "mse_w4a16_vs_dense": mse(w4, dense),
        "mse_w4a8_vs_dense": mse(a8, dense),
        "mse_ratio_a8_over_a16": mse(a8, dense) / max(mse(w4, dense), 1e-12),
        "top1_w4a16_vs_dense": top1(w4, dense),
        "top1_w4a8_vs_dense": top1(a8, dense),
        "top1_w4a8_vs_w4a16": top1(a8, w4),
        "mse_w4a8_vs_w4a16": mse(a8, w4),
    }


DIGITS = {"mse_w4a16_vs_dense": 5, "mse_w4a8_vs_dense": 5, "mse_ratio_a8_over_a16": 4,
          "top1_w4a16_vs_dense": 4, "top1_w4a8_vs_dense": 4, "top1_w4a8_vs_w4a16": 4,
          "mse_w4a8_vs_w4a16": 5}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen3-0.6b")
    ap.add_argument("--outlier-scale", type=float, default=8.0)
    ap.add_argument("--n-seq", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Build, measure, print the rounded line; return the unrounded row."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    config = PRESETS[args.preset]
    params, qparams = build(config, args.outlier_scale, dev)
    row = measure(params, qparams, config, tokens(config, args.n_seq, args.seqlen, dev),
                  preset=args.preset, outlier_scale=args.outlier_scale)
    print(json.dumps({k: round(v, DIGITS[k]) if k in DIGITS else v for k, v in row.items()}),
          flush=True)
    return row


if __name__ == "__main__":
    main()
