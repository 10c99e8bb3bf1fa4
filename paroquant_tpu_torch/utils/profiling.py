"""Where a decode step's or a prefill's time goes, on the card.

Counterpart of `paroquant_tpu/utils/profiling.py` for the port:
`profile_decode` runs the single-stream `decode_step`,
`profile_paged_decode` the engine's `paged_decode_step` at `batch` slots
and `profile_prefill` one prefill through the flash kernel (K3), a few
times plainly for the host wall time per step and once under
`torch.profiler` for the device time per kernel. The device's idle share
is 1 - device busy time / wall time, both from the profiled run; the
profiler's own host cost raises that run's wall time, so the plain run's
is reported beside it.

`kernel_time_ms` times one call of a kernel on the card: CUDA events around
the call, the L2 flushed before it, and the device kept busy by a spin
kernel while the host enqueues it, so that the events time the device's
work and not the host's; the median of the reps. The flush writes a buffer
larger than the L2, which leaves the L2 full of dirty lines: a call that
evicts one costs a write to device memory too. `clean_l2=True` flushes by
reading the buffer instead, for the same call beside a clean L2.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..kernels import attention as at, rot_matmul as rm
from ..models.config import ModelConfig
from ..models.decoder import KVCache, decode_step, prefill
from ..utils.device import resolve_device


FLUSH_BYTES = 256 << 20  # more than the H100's 50 MB L2
# K1/K2's kernels by route (kernels/rot_matmul.py::rot_route); the passes'
# kernels are shared with K6-K9, which no decode step runs
K1K2_KERNELS = {"one_launch": ("rot_w4_one_launch_kernel",),
                "passes": ("w4::rotate_kernel", "w4::gemv_kernel", "w4::reduce_kernel")}
SPIN_CYCLES = 2_000_000  # about 1 ms of device spin ahead of each timed call
_flush_buffers: dict[torch.device, torch.Tensor] = {}


def kernel_time_ms(fn, reps: int = 30, flush: torch.Tensor | None = None,
                   device="cuda", clean_l2: bool = False) -> float:
    """Median device time in ms of one call of fn (see the module doc), after
    two warm-up calls. `flush` is a CUDA buffer larger than the L2 (one of
    FLUSH_BYTES is kept per device when it is None). On the CPU
    (device="cpu") the host clock times the calls: for checking logic only,
    never a device time."""
    dev = resolve_device(device)
    fn()
    fn()
    times = []
    if dev.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    if flush is None:
        if dev not in _flush_buffers:
            _flush_buffers[dev] = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        flush = _flush_buffers[dev]
    torch.cuda.synchronize(dev)
    for _ in range(reps):
        if clean_l2:
            flush.view(torch.int32).max()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_decode(params, config: ModelConfig, *, prompt_len: int = 256, steps: int = 16,
                   quant_mode: str = "auto", device="cuda", top: int = 8) -> dict:
    """Wall ms per decode step (plain and profiled), device-busy ms per
    step, idle share, kernel launches per step (all, and the port's kernel wrappers' calls), K1/K2's
    calls and device ms per step by route and the `top` kernels by device time."""
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

    return _profile(run, steps, top)


def profile_prefill(params, config: ModelConfig, *, prompt_len: int = 512, steps: int = 4,
                    quant_mode: str = "auto", device="cuda", top: int = 8) -> dict:
    """`profile_decode` for one prefill of `prompt_len` tokens (a step here),
    run as `Generator` runs it (attn_mode "flash") into a bf16 cache of
    prompt_len + 128 rows, every time from position 0; `focus` gives the
    device ms and calls per prefill of the kernels named "flash" (K3)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    prompt = torch.randint(0, config.vocab_size, (1, prompt_len), generator=gen).to(dev)
    cache = KVCache.create(config, 1, prompt_len + 128, torch.bfloat16, dev)

    def run(n):
        for _ in range(n):
            prefill(params, config, prompt, cache, quant_mode=quant_mode, attn_mode="flash")
        torch.cuda.synchronize(dev)

    return _profile(run, steps, top, focus="flash")


def _profile(run, steps: int, top: int, focus: str | None = None) -> dict:
    """Time run(steps) plainly, then under torch.profiler (see module doc);
    with `focus`, the device time and calls of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    run(2)  # warm-up
    before = {**rm.launch_counts, **at.launch_counts}
    routes_before = {k: dict(v) for k, v in rm.route_counts.items()}
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    after = {**rm.launch_counts, **at.launch_counts}
    route_calls = {route: sum(rm.route_counts[k][route] - routes_before[k][route]
                              for k in rm.route_counts) / steps for route in ("one_launch", "passes")}
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
        "k1k2_calls_per_step": route_calls,
        "k1k2_device_ms_per_step": {
            route: sum(e.self_device_time_total for e in kernels
                       if any(n in e.key for n in names)) / 1e3 / steps
            for route, names in K1K2_KERNELS.items()},
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in kernels[:top]
        ],
    }
    if kernels:
        out["device_idle_share"] = 1.0 - out["device_busy_ms_per_step"] / profiled_wall_ms
    if focus is not None:
        named = [e for e in kernels if focus in e.key]
        out["focus"] = {"name": focus,
                        "device_ms_per_step": sum(e.self_device_time_total for e in named) / 1e3 / steps,
                        "calls_per_step": sum(e.count for e in named) / steps}
    return out


def profile_paged_decode(params, config: ModelConfig, *, batch: int = 8, context: int = 256,
                         steps: int = 16, device="cuda", top: int = 8) -> dict:
    """`profile_decode` for the engine's step: `paged_decode_step`
    (quant_mode "auto", a bf16 pool in pages of 128, as the engine's
    defaults) at `batch` slots, each holding `context` cached tokens (random
    K/V rows) and a greedy next token, over a shuffled page table."""
    from ..serve.paged import PagedKVCache, paged_decode_step

    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    page_size = 128
    max_pages = -(-(context + 3 * steps + 4) // page_size)
    cache = PagedKVCache.create(config, batch * max_pages + 1, page_size, torch.bfloat16,
                                device=dev)
    for pool in (cache.k, cache.v):
        pool.copy_(torch.randn(pool.shape, generator=gen).to(pool.dtype))
    table = torch.randperm(batch * max_pages, generator=gen).reshape(batch, max_pages)
    page_table = table.to(torch.int32).to(dev)
    seq_lens = torch.full((batch,), context, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, config.vocab_size, (batch,), generator=gen).to(torch.int32).to(dev)

    def run(n):
        nonlocal cache, seq_lens, tokens
        for _ in range(n):
            logits, cache = paged_decode_step(params, config, tokens, seq_lens, page_table, cache,
                                              quant_mode="auto")
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            seq_lens = seq_lens + 1
        torch.cuda.synchronize(dev)

    return _profile(run, steps, top)
