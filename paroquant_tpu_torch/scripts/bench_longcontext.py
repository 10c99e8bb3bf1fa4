"""Long-context serving drive, the port of `scripts/bench_longcontext.py`.

    python -m paroquant_tpu_torch.scripts.bench_longcontext --arm ttft16k|gen32k|ppl16k
        [--prompt-len 16384] [--chunk 2048] [--gen-total 32768] [--window 16384]
        [--layers N] [--timeout 3000] [--device cuda|cpu]

Three arms, each printing one JSON line with the JAX script's keys:

  ttft16k  Engine chunked-prefill TTFT on a 16k-token prompt (flash prefill,
           K3, in chunks of 2048 against the request's whole cache); a cold
           run, then a warm one on another prompt
  gen32k   one request generating to a 32k total context through the paged
           pool (K4 over one slot's growing pages, bursts of 32); it reports
           what it reached if --timeout runs out first
  ppl16k   one 16k-token PPL window at Qwen3-8B geometry (RTN W4 random
           weights, K3 over the window, the lm_head and CE in chunks), with
           the peak device memory of the evaluation

`build_w4` draws the model's bf16 weights on the device (`init_params`,
seed 0), quantizes them (RTN W4 g128) and merges each layer's
projections; `config` takes a narrow model for tests. Each arm takes
`model=(params, config)` to run on weights built elsewhere. On the CPU
(`--device cpu`) the plain versions run on the host clock, for the logic
only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..cli.evaluate import perplexity
from ..convert.rtn import quantize_model_rtn
from ..models import PRESETS, init_params, merge_projections
from ..serve import Engine, SamplingParams
from ..utils.cache import enable_compilation_cache
from ..utils.device import resolve_device


def build_w4(preset: str, layers: int | None = None, config=None, device="cuda"):
    """(params, config): the preset's (or `config`'s) random bf16 weights
    from seed 0, RTN W4 g128, projections merged; the lm_head stays dense."""
    dev = resolve_device(device)
    cfg = config or PRESETS[preset]
    if layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    params = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    q = quantize_model_rtn(params, cfg, n_bits=4, group_size=128, device=dev)
    del params
    return merge_projections(q, cfg), cfg


def arm_ttft16k(args, device="cuda", model=None) -> dict:
    dev = resolve_device(device)
    q, cfg = model or build_w4("qwen3-0.6b", device=dev)
    eng = Engine(
        q, cfg, max_batch=2, max_len=args.prompt_len + 256,
        page_size=128, quant_mode="auto", prefill_chunk=args.chunk,
        decode_burst=8, device=dev,
    )
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(0, cfg.vocab_size, args.prompt_len))
    sp = SamplingParams(max_tokens=16, temperature=0.0)

    def run_once(p):
        t0 = time.perf_counter()
        req = eng.submit(p, sp)
        first = None
        toks = []
        while len(toks) < 16:
            eng.step()
            while not req.out_queue.empty():
                kind, t = req.out_queue.get_nowait()
                if kind == "token":
                    if first is None:
                        first = time.perf_counter() - t0
                    toks.append(t)
                elif kind == "done":
                    break
            if time.perf_counter() - t0 > 900:
                raise TimeoutError
        return first

    # cold includes the first calls at the 16k shapes; warm is the serving number
    cold = run_once(prompt)
    rng2 = np.random.default_rng(1)
    warm = run_once(list(rng2.integers(0, cfg.vocab_size, args.prompt_len)))
    n_chunks = (args.prompt_len + args.chunk - 1) // args.chunk
    out = {
        "metric": "long_context_ttft",
        "prompt_tokens": args.prompt_len,
        "prefill_chunk": args.chunk,
        "ttft_cold_s": round(cold, 2),
        "ttft_warm_s": round(warm, 2),
        "chunks": n_chunks,
        "warm_ms_per_chunk": round(warm * 1e3 / n_chunks, 1),
    }
    print(json.dumps(out), flush=True)
    return out


def arm_gen32k(args, device="cuda", model=None) -> dict:
    dev = resolve_device(device)
    q, cfg = model or build_w4("qwen3-0.6b", device=dev)
    total = args.gen_total  # prompt + generation target (default 32768)
    eng = Engine(
        q, cfg, max_batch=1, max_len=total + 64, page_size=128,
        quant_mode="auto", decode_burst=32, device=dev,
    )
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(0, cfg.vocab_size, 32))
    n_gen = total - len(prompt)
    sp = SamplingParams(max_tokens=n_gen, temperature=0.8, seed=7)
    req = eng.submit(prompt, sp)
    t0 = time.perf_counter()
    n = 0
    finish = None
    marks = {}
    while True:
        eng.step()
        drained = False
        while not req.out_queue.empty():
            kind, t = req.out_queue.get_nowait()
            drained = True
            if kind == "token":
                n += 1
                for m in (1024, 8192, 16384, 24576, n_gen):
                    if n == m:
                        marks[m] = round(n / (time.perf_counter() - t0), 1)
            elif kind == "done":
                finish = "done"
        if finish:
            break
        if not drained and time.perf_counter() - t0 > args.timeout:
            break
    wall = time.perf_counter() - t0
    out = {
        "metric": "long_context_generation",
        "target_total_context": total,
        "generated": n,
        "finish": finish,
        "wall_s": round(wall, 1),
        "tok_s_overall": round(n / wall, 1),
        "tok_s_at_mark": marks,
        "pages_used": len(eng.slots[0].pages) if eng.slots[0].request else "freed",
        **eng.step_time_stats(),
    }
    print(json.dumps(out), flush=True)
    return out


def arm_ppl16k(args, device="cuda", model=None) -> dict:
    dev = resolve_device(device)
    q, cfg = model or build_w4("qwen3-8b", layers=args.layers, device=dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, args.window).astype(np.int32)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ppl = perplexity(q, cfg, toks, args.window, "auto", batch=1)
    wall = time.perf_counter() - t0
    out = {
        "metric": "long_window_ppl_8b_geometry",
        "window_tokens": args.window,
        "layers": args.layers or "full",
        "ppl_random_weights": round(ppl, 1),
        "wall_s": round(wall, 1),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev) if on_cuda else None,
    }
    print(json.dumps(out), flush=True)
    return out


ARMS = {"ttft16k": arm_ttft16k, "gen32k": arm_gen32k, "ppl16k": arm_ppl16k}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", required=True, choices=list(ARMS))
    ap.add_argument("--prompt-len", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--gen-total", type=int, default=32768)
    ap.add_argument("--window", type=int, default=16384)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=3000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None, model=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    enable_compilation_cache(device=dev)  # nvcc before any timed region
    return ARMS[args.arm](args, dev, model)


if __name__ == "__main__":
    main()
