"""Decode-throughput benchmark of a checkpoint: the port of
`paroquant_tpu/cli/benchmark.py`.

    python -m paroquant_tpu_torch.cli.benchmark --model DIR [--spec-k 4]
    python -m paroquant_tpu_torch.cli.benchmark --model DIR --device cpu

Single-stream greedy decode through `Generator` (a random prompt of
--prefill-len tokens, --decode-len new tokens), --warmup untimed runs and
--runs timed ones; prints the mean TTFT and tokens/s, and with --spec-k the
speculation's windows and acceptance. The flags and lines are the JAX
CLI's, but --device takes "cuda" (the default) or "cpu" and nothing else:
without a card "cuda" raises. --decode-burst defaults to 8 on the card and
1 on the CPU. The JAX CLI's --batch is left out: nothing read it, and the
Generator serves one stream. Prefills of 128 tokens or more take the flash
kernel.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--prefill-len", type=int, default=256)
    ap.add_argument("--decode-len", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--quant-mode", default=None, choices=["xla", "fused", "auto", "w4a8"])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--decode-burst", type=int, default=None,
                    help="sample+decode steps per host read (default: 8 on the card, 1 on the CPU)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help=">0: prompt-lookup speculative greedy decoding with "
                         "k-token drafts (the sequential greedy tokens on the CPU; on "
                         "the card a verify window may round apart at an argmax near-tie)")
    args = ap.parse_args(argv)

    from ..serve.generator import Generator
    from ..serve.sampling import SamplingParams
    from ..utils.cache import enable_compilation_cache
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    enable_compilation_cache(device=dev)
    on_card = dev.type == "cuda"
    burst = args.decode_burst if args.decode_burst is not None else (8 if on_card else 1)
    gen = Generator.from_pretrained(
        args.model,
        device=dev,
        max_len=args.prefill_len + args.decode_len + 8,
        quant_mode=args.quant_mode,
        attn_mode="flash",
        decode_burst=burst,
        lookup_spec_k=args.spec_k,
    )
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, gen.config.vocab_size, args.prefill_len)]
    sp = SamplingParams(max_tokens=args.decode_len, temperature=0.0, stop_token_ids=())

    print(f"backend={dev.type} quant_mode={gen.quant_mode}")
    for _ in range(args.warmup):
        gen.generate(prompt, sp)
    stats = [gen.generate(prompt, sp).stats for _ in range(args.runs)]
    tps = [s.tokens_per_second for s in stats]
    ttft = [s.ttft for s in stats]
    print(
        f"prefill={args.prefill_len} decode={args.decode_len} runs={args.runs}\n"
        f"ttft: {np.mean(ttft)*1e3:.1f} ms  decode: {np.mean(tps):.2f} tok/s "
        f"(min {min(tps):.2f}, max {max(tps):.2f})"
    )
    if args.spec_k:
        m = gen.spec_metrics
        rate = m["accepted"] / max(m["drafted"], 1)
        print(
            f"speculation: {m['windows']} windows, "
            f"{m['accepted']}/{m['drafted']} drafts accepted ({rate:.1%}), "
            f"{(m['accepted'] + m['windows']) / max(m['windows'], 1):.2f} tok/window"
        )


if __name__ == "__main__":
    main()
