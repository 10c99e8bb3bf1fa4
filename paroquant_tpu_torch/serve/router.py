"""Request-level data parallelism: a router over Engine replicas.

Counterpart of `paroquant_tpu/serve/router.py`. Each Engine owns one device
(`cli/serve.py --dp N` builds one a CUDA device); the router sends each
request to the replica with the least load (active slots, then queued
requests). It has the Engine's surface that the HTTP layer uses (submit,
cancel, score_sync, generate_sync, step, start, stop, metrics, tokenizer),
so `Server(EngineRouter([...]))` serves as over one Engine. Cancel is routed
by the Request itself (`Request.owner`), so the router keeps no state per
request.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from .engine import Engine, Request
from .sampling import SamplingParams


class EngineRouter:
    """Least-loaded dispatch over Engine replicas."""

    def __init__(self, engines: list[Engine]):
        if not engines:
            raise ValueError("EngineRouter needs at least one Engine")
        self.engines = list(engines)
        self._lock = threading.Lock()

    @property
    def tokenizer(self):
        return self.engines[0].tokenizer

    @property
    def max_len(self) -> int:
        return min(e.max_len for e in self.engines)

    @property
    def config(self):
        return self.engines[0].config

    @property
    def metrics(self) -> dict[str, int]:
        agg: dict[str, int] = {}
        for e in self.engines:
            for k, v in e.metrics.items():
                agg[k] = agg.get(k, 0) + v
        agg["replicas"] = len(self.engines)
        return agg

    def ttft_stats(self) -> dict:
        """TTFT percentiles (ms) pooled over the replicas' recent requests."""
        pooled = [t for e in self.engines for t in e._ttfts]
        if not pooled:
            return {}
        a = np.asarray(pooled) * 1e3
        return {
            "ttft_p50_ms": round(float(np.percentile(a, 50)), 1),
            "ttft_p99_ms": round(float(np.percentile(a, 99)), 1),
            "ttft_samples": int(a.size),
        }

    def step_time_stats(self) -> dict:
        """Decode-tick wall percentiles (ms) pooled over the replicas, with the
        slope of tick wall on steps where ticks of two sizes were seen."""
        pooled = [s for e in self.engines for s in e._step_samples]
        if not pooled:
            return {}
        a = np.asarray(pooled, np.float64)
        n, w = a[:, 0], a[:, 1] * 1e3
        out = {
            "decode_tick_wall_p50_ms": round(float(np.percentile(w, 50)), 2),
            "decode_tick_wall_p99_ms": round(float(np.percentile(w, 99)), 2),
            "decode_tick_samples": int(a.shape[0]),
        }
        if np.unique(n).size >= 2:
            slope, intercept = np.polyfit(n, w, 1)
            out["decode_step_device_ms_est"] = round(float(slope), 3)
            out["decode_dispatch_overhead_ms_est"] = round(float(intercept), 3)
        return out

    def _load(self, e: Engine) -> tuple[int, int]:
        active = sum(1 for s in e.slots if s.request is not None)
        return (active + len(e._pending) + e.waiting.qsize(), active)

    def _least_loaded(self) -> Engine:
        return min(self.engines, key=self._load)

    def submit(self, prompt_tokens: list[int], sampling: SamplingParams,
               pixel_values: np.ndarray | None = None) -> Request:
        with self._lock:
            eng = self._least_loaded()
            req = eng.submit(prompt_tokens, sampling, pixel_values=pixel_values)
            req.owner = eng
        return req

    def cancel(self, req: Request) -> None:
        if req.owner is not None:
            req.owner.cancel(req)

    def score_sync(self, prompt_tokens: list[int]) -> list[float | None]:
        with self._lock:
            eng = self._least_loaded()
        return eng.score_sync(prompt_tokens)

    def generate_sync(self, prompt_tokens: list[int], sampling: SamplingParams,
                      **kw: Any) -> list[int]:
        with self._lock:
            eng = self._least_loaded()
        return eng.generate_sync(prompt_tokens, sampling, **kw)

    def step(self) -> bool:
        busy = False
        for e in self.engines:
            busy = e.step() or busy
        return busy

    def start(self) -> None:
        for e in self.engines:
            e.start()

    def stop(self) -> None:
        for e in self.engines:
            e.stop()
