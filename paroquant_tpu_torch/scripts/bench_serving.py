"""Serving-engine benchmark: TTFT p50/p99 and aggregate tokens/s under load
(BASELINE.json config 3), the port of `scripts/bench_serving.py`.

    python -m paroquant_tpu_torch.scripts.bench_serving [--preset qwen3-0.6b]
        [--layers N] [--max-batch 8] [--max-len 1024] [--requests 24]
        [--max-tokens 48] [--decode-burst B] [--prefix-caching] [--spec-k K]
        [--distinct-prompts N] [--max-queue Q] [--arrival-mean 0.03]
        [--device cuda|cpu]

Continuous batching on `serve/engine.py::Engine` (pages of 64, prefill
chunks of 256) with mixed prompt lengths (24, 64, 160 and 420 tokens, as
fit max_len): requests arrive with exponential gaps while the engine
decodes, so TTFT holds real queueing and chunked prefill interleaved with
decode. The model is the preset (cut to `--layers`) with random bf16
weights from seed 0, RTN W4 g128 with a W4 lm_head and merged projections.
On the card the Engine runs quant_mode "auto" with bursts of 8 (K1/K2, K3
for prefill chunks of 128 tokens or more, K4, and K5 with `--spec-k`); on
the CPU "xla" with bursts of 1, as the JAX script runs on its CPU. A warm-up
request per prompt length runs first; the admission cap (`--max-queue`)
applies to the measured load only; a run longer than 600 s raises. One JSON
line with the JAX script's keys, then `Engine.step_time_stats()`'s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..models import PRESETS, init_params, merge_projections
from ..utils.device import resolve_device

TIMEOUT_S = 600


def build(config, device):
    """Random bf16 weights (seed 0), RTN W4 g128 with a W4 lm_head, merged."""
    from ..convert.rtn import quantize_model_rtn

    dev = resolve_device(device)
    params = init_params(config, 0, torch.bfloat16, dev)
    qparams = quantize_model_rtn(params, config, n_bits=4, group_size=128,
                                 quantize_lm_head=True, device=dev)
    return merge_projections(qparams, config)


def run(qparams, config, args, device="cuda"):
    """The protocol on a built model: (the JSON line's dict, the measured
    requests). `args` holds the parsed flags."""
    from ..serve import Engine, SamplingParams
    from ..serve.engine import EngineOverloaded

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    burst = args.decode_burst if args.decode_burst is not None else (8 if on_card else 1)
    eng = Engine(
        qparams, config, max_batch=args.max_batch, max_len=args.max_len,
        page_size=64, quant_mode="auto" if on_card else "xla",
        prefill_chunk=256, decode_burst=burst,
        prefix_caching=args.prefix_caching, spec_k=args.spec_k, device=dev,
    )
    rng = np.random.default_rng(0)
    # mixed lengths: short chat turns and long contexts
    pool = [n for n in (24, 64, 160, 420) if n + args.max_tokens < args.max_len]
    probs = {1: [1.0], 2: [0.6, 0.4], 3: [0.45, 0.35, 0.2],
             4: [0.4, 0.3, 0.2, 0.1]}[len(pool)]
    lengths = [int(n) for n in rng.choice(pool, args.requests, p=probs)]
    sp = SamplingParams(max_tokens=args.max_tokens, temperature=0.0)
    prompts: list[list[int]] | None = None
    if args.distinct_prompts:
        # long prompts (whole pages) so that prefix caching has something to share
        base_lens = sorted(pool, reverse=True)
        base = [list(rng.integers(0, config.vocab_size, base_lens[i % len(base_lens)]))
                for i in range(args.distinct_prompts)]
        prompts = [base[i % len(base)] for i in range(args.requests)]
        lengths = [len(p) for p in prompts]

    # warm-up: every prefill bucket, a full burst and the single-step tail
    warm_toks = burst + 1 if burst > 1 else 2
    for n in sorted(set(lengths)):
        eng.generate_sync(list(rng.integers(0, config.vocab_size, n)),
                          SamplingParams(max_tokens=warm_toks, temperature=0.0))
    if args.prefix_caching:
        # a repeated prompt takes the prefix-hit admission path for each bucket
        for n in sorted(set(lengths)):
            w = list(rng.integers(0, config.vocab_size, n))
            for _ in range(2):
                eng.generate_sync(w, SamplingParams(max_tokens=warm_toks, temperature=0.0))

    # the admission cap applies to the measured load only
    eng.max_queue = args.max_queue
    reqs = []
    rejected = 0
    t_start = time.perf_counter()
    next_submit = 0.0
    i = 0
    while i < args.requests or any(r.finish_time is None for r in reqs):
        now = time.perf_counter() - t_start
        if i < args.requests and now >= next_submit:
            p = (prompts[i] if prompts is not None
                 else list(rng.integers(0, config.vocab_size, lengths[i])))
            try:
                reqs.append(eng.submit(p, sp))
            except EngineOverloaded:  # shed, don't queue
                rejected += 1
            i += 1
            next_submit = now + float(rng.exponential(args.arrival_mean))
        if not eng.step():
            time.sleep(0.001)
        if time.perf_counter() - t_start > TIMEOUT_S:
            raise TimeoutError("bench did not finish")
    wall = time.perf_counter() - t_start

    if not reqs:
        return {"metric": "serving_ttft_and_throughput", "requests": 0, "rejected": rejected,
                "note": "all requests shed by max_queue"}, reqs
    ttfts = np.array([r.ttft for r in reqs])
    # queue: enqueue -> admission; service: admission -> first token
    queues = np.array([r.queue_time for r in reqs if r.queue_time is not None])
    servs = np.array([r.prefill_service_time for r in reqs if r.prefill_service_time is not None])
    total_tokens = eng.metrics["tokens_generated"]
    out = {
        "metric": "serving_ttft_and_throughput",
        "preset": args.preset,
        "requests": args.requests,
        "ttft_p50_ms": round(float(np.percentile(ttfts, 50)) * 1e3, 1),
        "ttft_p99_ms": round(float(np.percentile(ttfts, 99)) * 1e3, 1),
        "queue_p50_ms": round(float(np.percentile(queues, 50)) * 1e3, 1),
        "queue_p99_ms": round(float(np.percentile(queues, 99)) * 1e3, 1),
        "prefill_service_p50_ms": round(float(np.percentile(servs, 50)) * 1e3, 1),
        "prefill_service_p99_ms": round(float(np.percentile(servs, 99)) * 1e3, 1),
        "tokens_per_s": round(total_tokens / wall, 1),
        "wall_s": round(wall, 1),
        "decode_steps": eng.metrics["steps"],
        "decode_burst": burst,
        "prefix_hit_tokens": eng.metrics["prefix_hit_tokens"],
        "spec_accept_rate": round(
            eng.metrics["spec_accepted"] / max(eng.metrics["spec_drafted"], 1), 3
        ) if args.spec_k else None,
        "max_queue": args.max_queue,
        "rejected": rejected,
    }
    out.update(eng.step_time_stats())
    return out, reqs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=None, help="trim depth")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-tokens", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--decode-burst", type=int, default=None,
                    help="decode steps per tick (default: 8 on the card, 1 on the CPU)")
    ap.add_argument("--prefix-caching", action="store_true")
    ap.add_argument("--spec-k", type=int, default=0,
                    help=">0: prompt-lookup speculative decoding (greedy batches)")
    ap.add_argument("--distinct-prompts", type=int, default=None,
                    help="draw requests from a pool of N distinct prompts "
                         "(chat-like reuse; pairs with --prefix-caching)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-control queue cap: load past it is shed "
                         "(EngineOverloaded), counted and left out of TTFT")
    ap.add_argument("--arrival-mean", type=float, default=0.03,
                    help="mean inter-arrival seconds (exponential); 0.03 is a "
                         "saturating burst, ~0.3+ probes TTFT below capacity")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Parse, build, run the protocol; print and return its line."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    config = PRESETS[args.preset]
    if args.layers:
        config = dataclasses.replace(config, num_hidden_layers=args.layers)
    out, _ = run(build(config, dev), config, args, dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
