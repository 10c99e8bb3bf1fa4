"""Prompt-lookup speculative decoding: acceptance and throughput by spec_k,
the port of `scripts/bench_spec.py`.

    python -m paroquant_tpu_torch.scripts.bench_spec [--tokens 256] [--reps 3]
    python -m paroquant_tpu_torch.scripts.bench_spec --preset tiny --device cpu

The speculative `Generator` on the W4 model of `bench.py` (random weights,
RTN W4 g128, W4 lm_head, merged projections; quant_mode "fused" on the
card, "xla" on the CPU) for spec_k in {0, 2, 4}, greedy, on two prompts of
128 tokens: "repeat" (a 24-token run six times over: the n-gram structure
speculation is for) and "random" (the acceptance floor: its overhead). One
JSON row per (prompt, spec_k) with the JAX script's keys, then each k's
speed against k = 0. In exact arithmetic the tokens are those of k = 0
(the CPU run asserts it); on the card a verify window of 1 + k rows rounds
apart from a one-row decode, so an argmax near-tie can flip: the row
reports the first divergence instead of failing, as JAX's does on the TPU.
The JAX script's --matmul-precision has no counterpart: it sets the
precision of XLA's own matmuls, and the port's plain matmuls on the card
run in bf16 or f32 as their operands are, with TF32 left off.
`main(device="cpu", ...)` drives the logic on the host clock.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..models import PRESETS
from ..utils.cache import enable_compilation_cache
from ..utils.device import resolve_device

SPEC_KS = (0, 2, 4)


def prompts(vocab_size: int) -> dict[str, list[int]]:
    rng = np.random.default_rng(0)
    base = [int(t) for t in rng.integers(0, vocab_size, 24)]
    return {"repeat": (base * 6)[:128],
            "random": [int(t) for t in rng.integers(0, vocab_size, 128)]}


def first_divergence(toks: list[int], ref: list[int]) -> int:
    """The first index where toks and ref differ (their common length if none)."""
    return next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
                min(len(toks), len(ref)))


def main(device="cuda", preset="qwen3-0.6b", tokens=256, reps=3) -> list[dict]:
    """Print and return one row per (prompt, spec_k)."""
    from ..bench import build_models
    from ..serve import Generator, SamplingParams

    dev = resolve_device(device)
    enable_compilation_cache(device=dev)
    on_card = dev.type == "cuda"
    config = PRESETS[preset]
    _, qparams = build_models(config, dev)
    qmode = "fused" if on_card else "xla"
    sp = SamplingParams(max_tokens=tokens, temperature=0.0)
    results = []
    for regime, prompt in prompts(config.vocab_size).items():
        ref = None
        for k in SPEC_KS:
            gen = Generator(qparams, config, quant_mode=qmode, max_len=512, lookup_spec_k=k,
                            device=dev)
            toks = list(gen.stream_generate(prompt, sp))  # warm-up
            if ref is None:
                ref = toks
            div = first_divergence(toks, ref)
            flips = sum(a != b for a, b in zip(toks, ref))
            if not on_card and toks != ref:
                raise AssertionError(f"{regime} k={k}: the tokens changed with speculation")
            best = 1e9
            for _ in range(reps):
                gen.spec_metrics.update(windows=0, drafted=0, accepted=0)
                t0 = time.perf_counter()
                out = list(gen.stream_generate(prompt, sp))
                best = min(best, time.perf_counter() - t0)
            m = dict(gen.spec_metrics)
            row = {
                "metric": "spec_decode",
                "precision": "default",
                "regime": regime,
                "spec_k": k,
                "tok_s": round(len(out) / best, 1),
                "acceptance": round(m["accepted"] / max(m["drafted"], 1), 3),
                "windows": m["windows"],
                "first_divergence_vs_k0": div,
                "mismatches_vs_k0": flips,
                "len": len(toks),
            }
            results.append(row)
            print(json.dumps(row), flush=True)
    base_rows = {r["regime"]: r["tok_s"] for r in results if r["spec_k"] == 0}
    for r in results:
        if r["spec_k"]:
            print(f"{r['regime']} k={r['spec_k']}: "
                  f"{r['tok_s'] / base_rows[r['regime']]:.2f}x vs k=0, "
                  f"acceptance {r['acceptance']:.0%}", flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen3-0.6b")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args()
    main(a.device, a.preset, a.tokens, a.reps)
