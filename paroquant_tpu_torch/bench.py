"""Decode throughput of the W4 model against its bf16 baseline, one JSON line.

    python -m paroquant_tpu_torch.bench                   # Qwen3-0.6B on the card
    python -m paroquant_tpu_torch.bench --preset tiny --device cpu

The port of the JAX package's root `bench.py` (which stays the JAX bench),
with its protocol: single-stream greedy decode of a `qwen3-0.6b`-geometry
model with random bf16 weights (seed 0), then RTN W4 g128 with a W4
lm_head and merged projections. Three arms run interleaved: bf16 through
the plain path ("xla"), W4 through the kernels ("fused") and W4A8 ("w4a8");
on the CPU all three take the plain versions ("xla", "xla", "w4a8_xla"). A
run prefills 16 tokens and syncs outside the timed region; the timed region
is `greedy_decode_scan` of n tokens, ended by fetching them to the host.
Two warm-up rounds, then interleaved reps over chains of 64 and 512 tokens
(48 and 16, 2 reps on the CPU); each arm scores its best rep, and the slope
between the two chain lengths estimates the device ms per token net of the
fixed cost of a chain. The line has the keys of the JAX bench's.

On the card the port's decode step is a Python loop of about 2500 kernel
launches a token, so the chain's slope measures the host's dispatch as
much as the device; `utils/profiling.py::profile_decode` reads the device's
busy time per token.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .models import PRESETS, KVCache, init_params, merge_projections
from .models.decoder import greedy_decode_scan, prefill
from .utils.cache import enable_compilation_cache
from .utils.device import resolve_device

N_LONG = 512
N_SHORT = 64
REPS = 8
WARMUP = 2
PROMPT_LEN = 16


def build_models(config, device):
    """The bf16 model (seed 0) and its RTN W4 g128 copy with a W4 lm_head
    and merged projections, both on `device`."""
    from .convert.rtn import quantize_model_rtn

    dev = resolve_device(device)
    params = init_params(config, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    qparams = quantize_model_rtn(params, config, n_bits=4, group_size=128,
                                 quantize_lm_head=True, device=dev)
    return params, merge_projections(qparams, config)


def arm_modes(device) -> dict[str, str]:
    """Each arm's quant_mode: the kernels on the card, the plain versions on the CPU."""
    on_card = resolve_device(device).type == "cuda"
    return {"bf16": "xla", "w4": "fused" if on_card else "xla",
            "w4a8": "w4a8" if on_card else "w4a8_xla"}


def make_decode_runner(params, config, quant_mode, device, n_long=N_LONG):
    """run(n_tokens) -> (wall seconds of one greedy-decode chain, its tokens
    [1, n_tokens] as numpy): the prefill is synced out of the timed region,
    and fetching the tokens ends it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, config.vocab_size, (1, PROMPT_LEN))).to(
        device=dev, dtype=torch.int32)
    max_len = PROMPT_LEN + n_long + 8

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(n_tokens):
        cache = KVCache.create(config, 1, max_len, torch.bfloat16, dev)
        logits, c = prefill(params, config, prompt, cache, quant_mode=quant_mode)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        sync()
        t0 = time.perf_counter()
        toks, c = greedy_decode_scan(params, config, tok, c, n_tokens, quant_mode=quant_mode)
        toks = toks.cpu().numpy()  # waits for the whole chain
        return time.perf_counter() - t0, toks

    return run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-long", type=int, default=None,
                    help=f"long chain ({N_LONG} on the card, 48 on the CPU)")
    ap.add_argument("--n-short", type=int, default=None,
                    help=f"short chain ({N_SHORT} on the card, 16 on the CPU)")
    ap.add_argument("--reps", type=int, default=None, help=f"({REPS} on the card, 2 on the CPU)")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    return ap.parse_args(argv)


def run(params, qparams, config, device, *, n_long=None, n_short=None, reps=None,
        warmup=WARMUP) -> dict:
    """The protocol on built models (`build_models`): print its JSON line
    and return it. The chain lengths and reps default to the card's or the
    CPU's."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n_long = n_long or (N_LONG if on_card else 48)
    n_short = n_short or (N_SHORT if on_card else 16)
    reps = reps or (REPS if on_card else 2)
    modes = arm_modes(dev)
    arms = [(arm, make_decode_runner(params if arm == "bf16" else qparams, config, mode, dev,
                                     n_long=n_long))
            for arm, mode in modes.items()]
    for _ in range(warmup):
        for n in (n_short, n_long):
            for _, run_chain in arms:
                run_chain(n)
    t = {(a, n): [] for a, _ in arms for n in (n_short, n_long)}
    for _ in range(reps):  # interleaved reps; the best of them is the score
        for n in (n_short, n_long):
            for a, run_chain in arms:
                t[(a, n)].append(run_chain(n)[0])

    def best(arm, n):
        return float(np.min(t[(arm, n)]))

    def dev_ms(arm):  # per token, from the slope between the chain lengths
        return (best(arm, n_long) - best(arm, n_short)) / (n_long - n_short) * 1e3

    tok_s = {a: n_long / best(a, n_long) for a in modes}
    ms = {a: dev_ms(a) for a in modes}
    result = {
        "metric": "qwen3_0.6b_w4_decode_throughput",
        "value": round(tok_s["w4"], 2),
        "unit": "tokens/s/chip",
        "vs_baseline": round(tok_s["w4"] / tok_s["bf16"], 4),
        "decode_chain_tokens": n_long,
        "reps": reps,
        "device_ms_per_token_w4": round(ms["w4"], 4),
        "device_ms_per_token_bf16": round(ms["bf16"], 4),
        "vs_baseline_device": round(max(ms["bf16"], 1e-9) / max(ms["w4"], 1e-9), 4),
        "tok_s_w4a8": round(tok_s["w4a8"], 2),
        "vs_baseline_w4a8": round(tok_s["w4a8"] / tok_s["bf16"], 4),
        "device_ms_per_token_w4a8": round(ms["w4a8"], 4),
        "vs_baseline_device_w4a8": round(max(ms["bf16"], 1e-9) / max(ms["w4a8"], 1e-9), 4),
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    """Parse the flags, build the models, run the protocol; return its line."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    enable_compilation_cache(device=dev)
    params, qparams = build_models(PRESETS[args.preset], dev)
    return run(params, qparams, PRESETS[args.preset], dev, n_long=args.n_long,
               n_short=args.n_short, reps=args.reps, warmup=args.warmup)


if __name__ == "__main__":
    main()
