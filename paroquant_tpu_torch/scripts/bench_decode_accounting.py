"""Batched-decode accounting at 7B geometry, the port of
`scripts/bench_decode_accounting.py`.

    python -m paroquant_tpu_torch.scripts.bench_decode_accounting [--batch 32]
        [--tokens 64 128] [--preset llama-2-7b] [--full-width] [--device cuda|cpu]

It reads bench_7b's protocol (the same W4 model, prefill of 16 tokens, then
`greedy_decode_scan` with quant_mode "fused") at B 32 and splits one decode
chain's time two ways:

1. The device profile: `torch.profiler` around the `greedy_decode_scan`
   call and the fetch of its tokens only (the cache, the prefill and its
   argmax run outside the trace, so the buckets divided by N count decode
   work alone). Each kernel's self device time goes to a bucket by its name
   (`bucket_of`): the quantized matmuls (K1/K2 on any route), the attention
   dots (the plain attention's GEMM kernels), the KV update (index_copy /
   scatter), the sampler's argmax, the dtype and layout copies, the other
   elementwise and reduce kernels (norms, RoPE, softmax, residuals), and
   everything else. The buckets add up to the device's busy time, and wall
   minus busy is the host's share (the port's decode step is a Python loop
   of kernel launches). On the CPU the ops' self CPU time is bucketed
   instead (aten::mm, aten::index_copy_, ...), for the logic only.
2. An A/B ablation: the same chain with attention replaced by the identity
   (`identity_attn`, passed as attn_mode), which bounds the attention's
   share without trusting the names.

One JSON line per --tokens value, with the JAX script's keys; the step
times are the best of 3 runs after one warm-up. `--preset` other than
llama-2-7b builds a narrow model of that preset (hidden 256) for a smoke
run, as JAX's does; `--full-width` builds it at its own widths and depth
instead (the Qwen3-0.6B accounting beside the bench).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import time

import numpy as np
import torch

from ..models import PRESETS, KVCache
from ..models.decoder import greedy_decode_scan, merge_projections, prefill
from ..utils.device import resolve_device
from ..utils.profiling import k1k2_route

PROMPT_LEN = 16


def identity_attn(q, k, v, q_pos, valid, **kw):
    return q  # [B, T, Hq, D]: attention ablated, shapes kept


DOT = re.compile(r"gemm|gemv|xmma|cutlass|cublas|aten::(mm|bmm|addmm|matmul|einsum|linear|dot)$",
                 re.IGNORECASE)
GLUE = re.compile(r"elementwise|reduce|softmax|index_select|gather|indexSelect", re.IGNORECASE)
# host ops that allocate, view or wait: no arithmetic of the step
HOST_OTHER = ("aten::empty", "aten::empty_like", "aten::empty_strided", "aten::view",
              "aten::reshape", "aten::_reshape_alias", "aten::_unsafe_view", "aten::expand",
              "aten::slice", "aten::select", "aten::transpose", "aten::t", "aten::permute",
              "aten::as_strided", "aten::unsqueeze", "aten::squeeze", "aten::split",
              "aten::split_with_sizes", "aten::narrow", "aten::detach", "aten::alias",
              "aten::resize_", "aten::item", "aten::_local_scalar_dense", "aten::lift_fresh",
              "aten::unbind", "aten::result_type", "aten::is_nonzero")


def bucket_of(name: str) -> str:
    """Map a device kernel's name (or, on the CPU, a host op's) to a bucket."""
    if k1k2_route(name) is not None:  # K1/K2 on any route
        return "quant_matmuls"
    if "index_copy" in name or "scatter" in name or "index_put" in name:
        return "kv_update"
    if "argmax" in name.lower():
        return "sampler_argmax"
    if DOT.search(name):
        return "attention_dots"
    if "CatArray" in name:  # torch.cat (RoPE's halves): glue, though its kernel is named a copy
        return "fusions_glue"
    if "copy" in name.lower() or "Memcpy" in name or name in (
            "aten::to", "aten::_to_copy", "aten::clone", "aten::contiguous"):
        return "copies"
    if GLUE.search(name) or (name.startswith("aten::") and name not in HOST_OTHER):
        return "fusions_glue"
    return "other"


def profile_scan(run_once, device) -> dict:
    """Profile ONE decode chain (run_once(prof_ctx) wraps only the
    greedy_decode_scan call and its fetch in the context); aggregate each
    kernel's self device time (on the CPU: each op's self CPU time) by
    bucket, in ms."""
    from torch.profiler import ProfilerActivity, profile

    on_card = resolve_device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    prof = profile(activities=acts)
    run_once(prof)
    if on_card:
        events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    else:
        events = [(e.key, e.self_cpu_time_total) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0]
    buckets: dict[str, float] = {}
    top: dict[str, float] = {}
    for name, us in events:
        ms = us / 1e3
        b = bucket_of(name)
        buckets[b] = buckets.get(b, 0.0) + ms
        top[f"{b}:{name[:96]}"] = top.get(f"{b}:{name[:96]}", 0.0) + ms
    top_ops = sorted(top.items(), key=lambda kv: -kv[1])[:16]
    return {
        "buckets_ms": dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
        "top_ops_ms": top_ops,
    }


def make_run(params, cfg, prompt: torch.Tensor, N: int, attn_mode):
    """once(prof=None) -> (seconds per step of one N-token chain, its tokens)."""
    B = prompt.shape[0]
    dev = prompt.device

    def once(prof=None):
        cache = KVCache.create(cfg, B, PROMPT_LEN + N + 8, torch.bfloat16, dev)
        logits, c = prefill(params, cfg, prompt, cache, quant_mode="fused")
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tok.cpu()
        ctx = prof if prof is not None else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            toks, _ = greedy_decode_scan(params, cfg, tok, c, N, quant_mode="fused",
                                         attn_mode=attn_mode)
            toks = toks.cpu().numpy()
        return (time.perf_counter() - t0) / N, toks

    return once


def account(params, cfg, batch: int, tokens, device="cuda", *, reps: int = 3) -> list[dict]:
    """The accounting on a built model: print and return one row per N in tokens."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, PROMPT_LEN))).to(
        device=dev, dtype=torch.int32)
    rows = []
    for N in tokens:
        full_run = make_run(params, cfg, prompt, N, "einsum")
        full_run()  # warm-up
        full = min(full_run()[0] for _ in range(reps))
        noat_run = make_run(params, cfg, prompt, N, identity_attn)
        noat_run()
        no_attn = min(noat_run()[0] for _ in range(reps))

        prof = profile_scan(full_run, dev)
        dev_ms = sum(prof["buckets_ms"].values())
        out = {
            "metric": "b32_decode_accounting_7b",
            "batch": batch,
            "tokens": N,
            "step_ms_full": round(full * 1e3, 2),
            "attention_ms_ab (full - identity-attn)": round((full - no_attn) * 1e3, 2),
            "device_profile_per_step_ms": {
                k: round(v / N, 3) for k, v in prof["buckets_ms"].items()},
            "device_busy_ms_per_step": round(dev_ms / N, 2),
            "dispatch_overhead_ms_per_step (wall - device)": round(full * 1e3 - dev_ms / N, 2),
            "top_ops_us_per_step": {k: round(v / N * 1e3, 1) for k, v in prof["top_ops_ms"]},
            "agg_tok_s": round(batch / full, 1),
        }
        print(json.dumps(out), flush=True)
        rows.append(out)
    return rows


def build(preset: str, full_width: bool, device):
    """llama-2-7b: bench_7b's model; another preset: f32 random weights (seed
    0), RTN W4 g128 with a W4 lm_head, narrowed to hidden 256 unless
    full_width. Projections merged."""
    from ..convert.rtn import quantize_model_rtn
    from ..models import init_params
    from .bench_7b import build_quantized_llama7b

    dev = resolve_device(device)
    if preset == "llama-2-7b":
        params, cfg = build_quantized_llama7b(device=dev)
    else:
        cfg = PRESETS[preset]
        if not full_width:
            cfg = dataclasses.replace(cfg, hidden_size=256, intermediate_size=512,
                                      num_attention_heads=4, num_key_value_heads=2, head_dim=64)
        dense = init_params(cfg, 0, torch.float32, dev)
        params = quantize_model_rtn(dense, cfg, n_bits=4, group_size=128, quantize_lm_head=True,
                                    device=dev)
        del dense
    return merge_projections(params, cfg), cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tokens", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--preset", default="llama-2-7b",
                    help="llama-2-7b (protocol) or a narrow preset for smoke")
    ap.add_argument("--full-width", action="store_true",
                    help="build a preset other than llama-2-7b at its own widths")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.time()
    params, cfg = build(args.preset, args.full_width, dev)
    print(f"built {args.preset} in {time.time()-t0:.0f}s", flush=True)
    return account(params, cfg, args.batch, args.tokens, dev)


if __name__ == "__main__":
    main()
