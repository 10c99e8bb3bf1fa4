"""Where a decode step's time goes, on the card.

Counterpart of `paroquant_tpu/utils/profiling.py` for the port: runs
`decode_step` a few times, once plainly for the host wall time per step and
once under `torch.profiler` for the device time per kernel. The device's
idle share is 1 - device busy time / wall time, both from the profiled run;
the profiler's own host cost raises that run's wall time, so the plain
run's is reported beside it.
"""

from __future__ import annotations

import time

import torch

from ..kernels import attention as at, rot_matmul as rm
from ..models.config import ModelConfig
from ..models.decoder import KVCache, decode_step, prefill
from ..utils.device import resolve_device


def profile_decode(params, config: ModelConfig, *, prompt_len: int = 256, steps: int = 16,
                   quant_mode: str = "auto", device="cuda", top: int = 8) -> dict:
    """Wall ms per decode step (plain and profiled), device-busy ms per
    step, idle share, kernel launches per step (all, and the port's kernel wrappers' calls) and the
    `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    prompt = torch.randint(0, config.vocab_size, (1, prompt_len), generator=gen).to(dev)
    cache = KVCache.create(config, 1, prompt_len + 3 * steps + 4, torch.bfloat16, dev)
    logits, cache = prefill(params, config, prompt, cache, quant_mode=quant_mode)

    def run(n):
        nonlocal logits, cache
        for _ in range(n):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            logits, cache = decode_step(params, config, tok, cache, quant_mode=quant_mode)
        torch.cuda.synchronize(dev)

    run(2)  # warm-up
    before = {**rm.launch_counts, **at.launch_counts}
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    after = {**rm.launch_counts, **at.launch_counts}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    out = {
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_wall_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / steps if kernels else None,
        "launches_per_step": launches / steps if kernels else None,
        "port_kernel_calls_per_step": {k: (after[k] - before[k]) / steps for k in after},
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in kernels[:top]
        ],
    }
    if kernels:
        out["device_idle_share"] = 1.0 - out["device_busy_ms_per_step"] / profiled_wall_ms
    return out
