"""A/B: K4 (paged decode attention) over a bf16 KV pool against an int8 pool,
the port of `scripts/bench_kv_quant.py`.

    python -m paroquant_tpu_torch.scripts.bench_kv_quant

One query token (B 1, Hq 32, Hkv 8, D 128) against S = 16384 cached tokens
in pages of 128, the long-context regime the int8 cache is for. The pools
are numpy's `default_rng(0)` normals in bf16, and the int8 pool is
`serve/paged.py::kv_quantize` of them with its scales as K4 takes them,
[P, Hkv, ps] f32. Each arm is a chain of 64 K4 calls, each output feeding
the next query, as the JAX script's scan is. A spin kernel holds the device
while the host enqueues the chain, so that CUDA events around the chain
time the device's 64 calls and not the host's ctypes calls (about as long
as one K4 call at this size); the minimum over 5 reps, divided by 64. The
lines are the JAX script's; the speed of light is the bytes K4 must read
(K and V, plus an f32 scale a row for int8) over the H100 SXM's 3.35 TB/s,
and the first line names the card. `main(device="cpu", S=...)` runs the
plain version on the host clock, for the logic only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..kernels.attention import paged_decode_attention
from ..serve.paged import kv_quantize
from ..utils.device import resolve_device
from ..utils.profiling import SPIN_CYCLES
from .bench_common import HBM_BYTES_PER_S, device_name

B, HQ, HKV, D, PS = 1, 32, 8, 128, 128
S_DEFAULT = 16384
N_ITERS = 64
REPS = 5
SCALE = 0.08


def pools(S: int = S_DEFAULT, device="cuda") -> dict:
    """The query, both pools, the page table and the lengths, drawn as JAX's."""
    dev = resolve_device(device)
    maxP = S // PS
    rng = np.random.default_rng(0)

    def bf16(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)

    kf, vf = bf16((maxP, PS, HKV, D)), bf16((maxP, PS, HKV, D))
    kq, ks = kv_quantize(kf)
    vq, vs = kv_quantize(vf)
    return {"q": bf16((B, HQ, D)), "kf": kf, "vf": vf,
            "kq": kq, "ks": ks.transpose(-1, -2).contiguous(),
            "vq": vq, "vs": vs.transpose(-1, -2).contiguous(),
            "table": torch.arange(maxP, dtype=torch.int32, device=dev)[None].repeat(B, 1),
            "lens": torch.full((B,), S, dtype=torch.int32, device=dev)}


def chain(n_iters, k, v, table, lens, ks=None, vs=None):
    """run(q): n_iters K4 calls, each output (cast to q's dtype) the next query."""

    def run(q):
        for _ in range(n_iters):
            q = paged_decode_attention(q, k, v, table, lens, scale=SCALE, k_scales=ks,
                                       v_scales=vs).to(q.dtype)
        return q

    return run


def _spin_ms(dev) -> float:
    """Device ms of one spin of SPIN_CYCLES."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)  # warm
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bench(fn, q, dev, reps: int = REPS) -> float:
    """Best seconds of one fn(q) over reps (after one warm-up call): CUDA events
    behind a spin longer than twice the host's enqueue of the chain; the host
    clock on the CPU."""
    if dev.type != "cuda":
        fn(q)
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(q)
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn(q)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    spins = max(1, int(np.ceil(2 * enqueue_ms / _spin_ms(dev))))
    best = np.inf
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES * spins)
        start.record()
        fn(q)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def main(device="cuda", S: int = S_DEFAULT, n_iters: int = N_ITERS, reps: int = REPS) -> list[dict]:
    """Print the JAX script's four lines; return one row per pool."""
    dev = resolve_device(device)
    p = pools(S, dev)
    t_bf16 = bench(chain(n_iters, p["kf"], p["vf"], p["table"], p["lens"]), p["q"], dev,
                   reps) / n_iters
    t_int8 = bench(chain(n_iters, p["kq"], p["vq"], p["table"], p["lens"], p["ks"], p["vs"]),
                   p["q"], dev, reps) / n_iters

    bytes_bf16 = 2 * S * HKV * D * 2  # k+v bf16
    bytes_int8 = 2 * S * HKV * (D * 1 + 4)  # k+v int8 + f32 scale/row
    bw = HBM_BYTES_PER_S
    print(f"cached tokens S={S}, Hkv={HKV}, D={D} "
          f"[{device_name(dev)}; SoL at {bw / 1e12:.2f} TB/s]")
    print(f"bf16 KV: {t_bf16*1e6:8.1f} us/step  "
          f"(SoL {bytes_bf16/bw*1e6:.1f} us, {bytes_bf16/bw/t_bf16*100:.0f}%)")
    print(f"int8 KV: {t_int8*1e6:8.1f} us/step  "
          f"(SoL {bytes_int8/bw*1e6:.1f} us, {bytes_int8/bw/t_int8*100:.0f}%)")
    print(f"speedup: {t_bf16/t_int8:.2f}x (byte ratio {bytes_bf16/bytes_int8:.2f}x)", flush=True)
    return [{"pool": pool, "S": S, "us_per_step": t * 1e6, "bytes": nb,
             "sol_us": nb / bw * 1e6, "sol_share": nb / bw / t, "device": device_name(dev)}
            for pool, t, nb in (("bf16", t_bf16, bytes_bf16), ("int8", t_int8, bytes_int8))]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(ap.parse_args().device)
