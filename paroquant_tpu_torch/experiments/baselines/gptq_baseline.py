"""GPTQ W4 baseline driver: a dense checkpoint (or a preset with seeded
random weights) + calibration tokens -> a Hessian-compensated PARO-TPU
checkpoint (identity rotation, or the Hadamard mixer with --hadamard: the
QuaRot recipe). The port of `experiments/baselines/gptq_baseline.py`; the
directory it writes loads in both packages.

    python -m paroquant_tpu_torch.experiments.baselines.gptq_baseline \
        --model preset:tiny --datasets synthetic --n-samples 16 --seqlen 128 \
        --output /tmp/gptq_ckpt [--device cpu]
"""

from __future__ import annotations

import argparse

from .rtn_baseline import load_dense


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="dense checkpoint dir or preset:<name>")
    ap.add_argument("--output", required=True)
    ap.add_argument("--datasets", default="wikitext2", help="comma-separated")
    ap.add_argument("--n-samples", type=int, default=128)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--n-bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--percdamp", type=float, default=0.01)
    ap.add_argument("--hadamard", action="store_true",
                    help="compose the Hadamard group mixer with GPTQ "
                         "(the QuaRot recipe)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)

    from ...convert import gptq_quantize_model, save_paro_checkpoint
    from ...optim.data import get_mixed_calib_dataset
    from ...serve.generator import load_tokenizer
    from ...utils.device import resolve_device

    dev = resolve_device(args.device)
    params, config = load_dense(args.model, dev)
    tokenizer = None if args.model.startswith("preset:") else load_tokenizer(args.model)
    tokens = get_mixed_calib_dataset(
        args.datasets.split(","), tokenizer, args.n_samples, args.seqlen,
        seed=args.seed, vocab_size=config.vocab_size,
    )
    _, exports = gptq_quantize_model(
        params, config, tokens, n_bits=args.n_bits, group_size=args.group_size,
        percdamp=args.percdamp, batch_size=args.batch_size, hadamard=args.hadamard,
        log_fn=lambda m: print(m, flush=True), device=dev,
    )
    save_paro_checkpoint(args.output, params, config, exports)
    kind = "QuaRot (Hadamard+GPTQ)" if args.hadamard else "GPTQ"
    print(f"{kind} W4 checkpoint written to {args.output}")


if __name__ == "__main__":
    main()
