"""Continuous-batching engine over the paged KV cache.

Counterpart of `paroquant_tpu/serve/engine.py:38-1258`:

- fixed decode slots (max_batch); one paged decode step serves any mix of
  requests;
- prefill admission with pow-2 length buckets, chunked prefill that
  advances one chunk per tick with up to `max_inflight_prefills` running;
- a host-side page allocator with a trash page (index num_pages) that
  absorbs the writes of idle and finished slots;
- prefix caching: cumulative block hashes checked against the stored
  tokens, refcounts, and an LRU of idle pages;
- burst decode: `decode_burst` paged steps + batched samples in one tick,
  the sampled tokens fed back on the device and ONE device-to-host copy per
  burst;
- per-slot prompt-lookup speculation (`spec_k`), per-slot sampling
  parameters, logit bias, top logprobs, cancel and admission control.

The JAX engine's jitted pieces map to plain torch: prefill is the port's
`model_forward` on a contiguous `KVCache` (attn_mode "flash" on CUDA, K3;
"einsum" on the CPU), the burst is a Python loop of `paged_decode_step` and
`sample_batch`, and the prefill finish is a few torch ops. Per-slot draws
hash (the request's seed, its step), so a request's tokens do not depend on
the batch; they differ from the JAX engine's `jax.random` draws.
Tensor-parallel serving (a mesh) and images (`pixel_values`) are later
slices and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import KVCache, _unsupported, model_forward
from ..utils.device import resolve_device
from .generator import _lookup_draft
from .paged import (
    PagedKVCache,
    _no_mesh,
    gather_prefix_rows,
    paged_decode_step,
    paged_verify_step,
    scatter_prefill_kv,
)
from .sampling import TOPN, SamplingParams, sample_batch


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_tokens: list[int]
    sampling: SamplingParams
    out_queue: "queue.SimpleQueue[tuple[str, int | None]]" = dataclasses.field(
        default_factory=queue.SimpleQueue
    )
    enqueue_time: float = dataclasses.field(default_factory=time.perf_counter)
    # set when the scheduler admits the request: TTFT = queue wait (enqueue ->
    # here) + prefill service (here -> first token)
    prefill_start_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None
    # per generated token: its logprob under the raw model distribution
    logprobs: list[float] = dataclasses.field(default_factory=list)
    # per generated token: [(token_id, logprob)] x TOPN, kept only when
    # sampling.top_logprobs > 0
    top_logprobs: list[list[tuple[int, float]]] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.enqueue_time

    @property
    def queue_time(self) -> float | None:
        if self.prefill_start_time is None:
            return None
        return self.prefill_start_time - self.enqueue_time

    @property
    def prefill_service_time(self) -> float | None:
        if self.first_token_time is None or self.prefill_start_time is None:
            return None
        return self.first_token_time - self.prefill_start_time


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    n_generated: int = 0
    pages: list[int] = dataclasses.field(default_factory=list)
    prefilling: bool = False  # slot reserved, prompt still being chunk-prefilled
    # prompt + generated tokens (host-side), kept for prompt-lookup drafting
    ctx: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PrefillState:
    """An in-progress chunked prefill (one chunk advances per scheduler tick)."""

    request: Request
    slot_id: int
    pages: list[int]
    toks: np.ndarray  # [1, bucket] zero-padded prompt
    cache: KVCache  # contiguous cache being filled
    offset: int = 0  # tokens prefilled so far (starts past a cached prefix)
    n_matched: int = 0  # prefix-cache pages reused (head of `pages`)
    reg_keys: tuple = ()  # cumulative hashes of the full prompt pages


_GLOBAL_ID_COUNTER = itertools.count()


def _block_hash(h: int, block: tuple) -> int:
    """Cumulative prefix-page hash. A module-level hook so tests can force
    collisions; hits are always verified against the stored token block."""
    return hash((h, block))


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the waiting queue is at max_queue."""


class Engine:
    """Continuous-batching inference engine."""

    def __init__(
        self,
        params: dict,
        config: ModelConfig,
        tokenizer=None,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        page_size: int = 128,
        num_pages: int | None = None,
        quant_mode: str | None = None,
        cache_dtype=torch.bfloat16,
        kv_quant: str | None = None,
        mesh=None,
        prefill_chunk: int = 256,
        decode_burst: int = 1,
        prefix_caching: bool = False,
        spec_k: int = 0,
        max_inflight_prefills: int = 2,
        max_queue: int | None = None,
        device="cuda",
    ):
        _unsupported(config)
        _no_mesh(mesh)
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages_per_seq = (max_len + page_size - 1) // page_size
        if num_pages is None:
            num_pages = max_batch * self.max_pages_per_seq
        # "auto" (the kernels at decode-sized M) on CUDA, "xla" on the CPU
        self.quant_mode = quant_mode or ("auto" if on_cuda else "xla")
        self.kv_quant = kv_quant
        self.prefill_dtype = cache_dtype
        # one extra "trash" page absorbs the KV writes of inactive slots
        self.trash_page = num_pages
        self.cache = PagedKVCache.create(config, num_pages + 1, page_size, cache_dtype,
                                         kv_quant=kv_quant, device=self.device)
        self.free_pages: list[int] = list(range(num_pages))
        self.slots = [_Slot() for _ in range(max_batch)]
        self.waiting: "queue.SimpleQueue[Request]" = queue.SimpleQueue()
        self._pending: list[Request] = []
        self.max_queue = max_queue
        self.prefill_chunk = prefill_chunk
        self._prefill_states: list[_PrefillState] = []
        self.max_inflight_prefills = max_inflight_prefills
        self.decode_burst = max(1, decode_burst)
        self.prefix_caching = prefix_caching
        self.spec_k = max(0, spec_k)
        self.prefix_map: dict[int, int] = {}  # cumulative hash -> page id
        self.page_key: dict[int, int] = {}  # registered page -> its hash
        self.page_refs: dict[int, int] = {}  # registered page -> active refs
        self.page_tokens: dict[int, tuple] = {}  # registered page -> its token block
        self.cached_idle: "OrderedDict[int, int]" = OrderedDict()  # LRU idle
        # host-side slot state, shipped to the device as copies each tick
        self.tokens = np.zeros(max_batch, np.int32)
        self.seq_lens = np.zeros(max_batch, np.int32)
        self.page_table = np.full((max_batch, self.max_pages_per_seq), self.trash_page, np.int32)
        self.temps = np.zeros(max_batch, np.float32)
        self.top_ps = np.ones(max_batch, np.float32)
        self.top_ks = np.zeros(max_batch, np.int32)
        self.rep_pens = np.ones(max_batch, np.float32)
        self.slot_seeds = np.zeros(max_batch, np.int64)
        self.slot_steps = np.zeros(max_batch, np.int64)
        V = config.vocab_size
        # device-resident per-slot rows, rewritten at admission
        self.logit_biases = torch.zeros((max_batch, V), dtype=torch.float32, device=self.device)
        self._bias_dirty = np.zeros(max_batch, bool)
        self.token_counts = torch.zeros((max_batch, V), dtype=torch.int32, device=self.device)
        self._id_counter = _GLOBAL_ID_COUNTER
        self._cancelled: set[str] = set()
        self._stop_flag = False
        self._thread: threading.Thread | None = None
        self.eos_ids: set[int] = set()
        if tokenizer is not None and getattr(tokenizer, "eos_token_id", None) is not None:
            self.eos_ids.add(int(tokenizer.eos_token_id))
        self.metrics = {
            "requests": 0, "rejected": 0, "tokens_generated": 0, "steps": 0,
            "prefix_hit_tokens": 0,
            "spec_windows": 0, "spec_drafted": 0, "spec_accepted": 0,
        }
        self._ttfts: "deque[float]" = deque(maxlen=512)
        # (decode steps fused in the tick, tick wall seconds)
        self._step_samples: "deque[tuple[int, float]]" = deque(maxlen=512)
        self._last_tick_steps = 1
        self.prefill_attn = "flash" if on_cuda else "einsum"

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, prompt_tokens: list[int], sampling: SamplingParams,
               pixel_values=None) -> Request:
        if pixel_values is not None:
            raise NotImplementedError("image prompts (VLM prefill) come with slice 3 of the port")
        if len(prompt_tokens) + sampling.max_tokens > self.max_len:
            raise ValueError(
                f"prompt+max_tokens {len(prompt_tokens)}+{sampling.max_tokens} "
                f"exceeds engine max_len {self.max_len}"
            )
        if self.max_queue is not None and self.waiting.qsize() + len(self._pending) >= self.max_queue:
            self.metrics["rejected"] += 1
            raise EngineOverloaded(f"queue full ({self.max_queue} requests waiting); retry later")
        req = Request(f"req-{next(self._id_counter)}", list(prompt_tokens), sampling)
        self.waiting.put(req)
        self.metrics["requests"] += 1
        return req

    def run_forever(self):
        while not self._stop_flag:
            if not self.step():
                time.sleep(0.002)

    def start(self):
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop_flag = True
        if self._thread is not None:
            self._thread.join(timeout=5)

    def ttft_stats(self) -> dict:
        """Rolling TTFT percentiles (ms) over the last <=512 requests."""
        if not self._ttfts:
            return {}
        a = np.asarray(self._ttfts) * 1e3
        return {
            "ttft_p50_ms": round(float(np.percentile(a, 50)), 1),
            "ttft_p99_ms": round(float(np.percentile(a, 99)), 1),
            "ttft_samples": int(a.size),
        }

    def step_time_stats(self) -> dict:
        """Decode-tick wall percentiles (ms); with ticks of two sizes (1 and
        decode_burst steps), the least-squares slope of tick wall on steps
        estimates the per-step time net of the fixed per-tick overhead."""
        if not self._step_samples:
            return {}
        a = np.asarray(self._step_samples, np.float64)
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

    def cancel(self, req: Request) -> None:
        """Finish the request on the next tick ('done' emitted, slot and
        pages reclaimed). Safe from any thread."""
        self._cancelled.add(req.request_id)

    # ------------------------------------------------------------------
    # scheduler tick
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One tick: advance prefill by at most one chunk, admit requests,
        run one decode tick. Returns False when fully idle."""
        self._reap_cancelled()
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.request is not None and not s.prefilling]
        if active:
            t0 = time.perf_counter()
            self._decode(active)
            if self._last_tick_steps:  # speculative ticks are left out
                self._step_samples.append((self._last_tick_steps, time.perf_counter() - t0))
        return bool(active) or bool(self._prefill_states)

    # ------------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of host state (never an alias of the numpy buffer,
        which the scheduler mutates right after shipping it)."""
        return torch.tensor(a, device=self.device)

    def _num_free_pages(self) -> int:
        return len(self.free_pages) + len(self.cached_idle)

    def _take_free_page(self) -> int:
        if self.free_pages:
            return self.free_pages.pop()
        pid, key = self.cached_idle.popitem(last=False)  # least recently idle
        del self.prefix_map[key]
        del self.page_key[pid]
        self.page_refs.pop(pid, None)
        self.page_tokens.pop(pid, None)
        return pid

    def _match_prefix(self, toks: list[int]) -> tuple[list[int], tuple]:
        """(matched cached pages, cumulative keys of every full prompt page);
        matching stops one token short of the prompt end, and a hash hit
        counts only if the stored token block equals the prompt's."""
        ps = self.page_size
        n_full = (len(toks) - 1) // ps
        keys, blocks, h = [], [], 0
        for j in range(n_full):
            block = tuple(toks[j * ps : (j + 1) * ps])
            h = _block_hash(h, block)
            keys.append(h)
            blocks.append(block)
        pages: list[int] = []
        for key, block in zip(keys, blocks):
            pid = self.prefix_map.get(key)
            if pid is None or self.page_tokens.get(pid) != block:
                break
            pages.append(pid)
        return pages, tuple(keys)

    def _claim_cached(self, pages: list[int]) -> None:
        for pid in pages:
            self.page_refs[pid] = self.page_refs.get(pid, 0) + 1
            self.cached_idle.pop(pid, None)

    def _register_prefix(self, pages: list[int], reg_keys: tuple, n_matched: int, toks: list[int]):
        ps = self.page_size
        for j, key in enumerate(reg_keys):
            if j < n_matched or key in self.prefix_map:
                continue
            pid = pages[j]
            self.prefix_map[key] = pid
            self.page_key[pid] = key
            self.page_refs[pid] = self.page_refs.get(pid, 0) + 1
            self.page_tokens[pid] = tuple(toks[j * ps : (j + 1) * ps])

    def _admit(self):
        if self._prefill_states:
            self._advance_prefill(self._prefill_states[0])
        while True:
            if len(self._prefill_states) >= self.max_inflight_prefills:
                return
            free_slots = [i for i, s in enumerate(self.slots) if s.request is None]
            if not free_slots:
                return
            if not self._pending:
                try:
                    self._pending.append(self.waiting.get_nowait())
                except queue.Empty:
                    return
            req = self._pending[0]
            if req.request_id in self._cancelled:  # cancelled while queued
                self._pending.pop(0)
                self._cancelled.discard(req.request_id)
                req.out_queue.put(("done", None))
                continue
            T = len(req.prompt_tokens)
            need_pages = (T + req.sampling.max_tokens + self.page_size - 1) // self.page_size
            matched: list[int] = []
            reg_keys: tuple = ()
            if self.prefix_caching:
                matched, reg_keys = self._match_prefix(req.prompt_tokens)
            if need_pages - len(matched) > self._num_free_pages():
                return  # wait for pages to free up
            self._pending.pop(0)
            slot_id = free_slots[0]
            if T > self.prefill_chunk or matched:
                st = self._start_chunked_prefill(slot_id, req, matched, reg_keys)
                if matched and T - len(matched) * self.page_size <= self.prefill_chunk:
                    # a prefix hit with a one-chunk suffix finishes this tick
                    self._advance_prefill(st)
                continue
            self._prefill_into_slot(slot_id, req, reg_keys)

    def _alloc_pages(self, req: Request, n_matched: int = 0) -> list[int]:
        T = len(req.prompt_tokens)
        need = (T + req.sampling.max_tokens + self.page_size - 1) // self.page_size
        return [self._take_free_page() for _ in range(need - n_matched)]

    def _start_chunked_prefill(self, slot_id: int, req: Request, matched: list[int],
                               reg_keys: tuple = ()) -> _PrefillState:
        T = len(req.prompt_tokens)
        bucket = self._bucket(T)
        C = self.prefill_chunk
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :T] = req.prompt_tokens
        self._claim_cached(matched)
        pages = matched + self._alloc_pages(req, len(matched))
        # +C slack: a cached prefix starts chunks at page-aligned offsets, so
        # the last chunk may run past `bucket` rows
        if matched:
            n_gather = min(self.max_pages_per_seq, (bucket + C + self.page_size - 1) // self.page_size)
            page_vec = np.full(n_gather, self.trash_page, np.int32)
            page_vec[: min(len(pages), n_gather)] = pages[:n_gather]
            k0, v0 = gather_prefix_rows(self.cache, self._dev(page_vec), bucket + C,
                                        out_dtype=self.prefill_dtype)
            cache = KVCache(k0, v0, torch.zeros((), dtype=torch.int32, device=self.device))
            self.metrics["prefix_hit_tokens"] += len(matched) * self.page_size
        else:
            cache = KVCache.create(self.config, 1, bucket + C, self.prefill_dtype, self.device)
        slot = self.slots[slot_id]
        slot.request = req
        slot.prefilling = True
        if req.prefill_start_time is None:
            req.prefill_start_time = time.perf_counter()
        st = _PrefillState(request=req, slot_id=slot_id, pages=pages, toks=toks, cache=cache,
                           offset=len(matched) * self.page_size, n_matched=len(matched),
                           reg_keys=reg_keys)
        self._prefill_states.append(st)
        return st

    def _advance_prefill(self, st: _PrefillState):
        C = self.prefill_chunk
        T = len(st.request.prompt_tokens)
        chunk_np = st.toks[:, st.offset : st.offset + C]
        if chunk_np.shape[1] < C:  # pad to the chunk width
            chunk_np = np.pad(chunk_np, ((0, 0), (0, C - chunk_np.shape[1])))
        cache = KVCache(st.cache.k, st.cache.v,
                        torch.full((), st.offset, dtype=torch.int32, device=self.device))
        logits, st.cache = model_forward(
            self.params, self.config, self._dev(chunk_np), cache, quant_mode=self.quant_mode,
            attn_mode=self.prefill_attn)
        st.offset += C
        if st.offset >= T:  # the last chunk reached the final prompt token
            last_in_chunk = (T - 1) - (st.offset - C)
            self._finish_prefill(st.slot_id, st.request, st.cache, logits[:, last_in_chunk, :],
                                 st.pages, reg_keys=st.reg_keys, n_matched=st.n_matched)
            self.slots[st.slot_id].prefilling = False
            self._prefill_states.remove(st)

    def _bucket(self, T: int) -> int:
        b = 16
        while b < T:
            b *= 2
        return min(b, self.max_len)

    def _prefill_into_slot(self, slot_id: int, req: Request, reg_keys: tuple = ()):
        if req.prefill_start_time is None:
            req.prefill_start_time = time.perf_counter()
        T = len(req.prompt_tokens)
        bucket = self._bucket(T)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :T] = req.prompt_tokens
        cache = KVCache.create(self.config, 1, bucket, self.prefill_dtype, self.device)
        logits, cache = model_forward(self.params, self.config, self._dev(toks), cache,
                                      quant_mode=self.quant_mode, attn_mode=self.prefill_attn)
        self._finish_prefill(slot_id, req, cache, logits[:, T - 1, :], self._alloc_pages(req),
                             reg_keys=reg_keys)

    @torch.no_grad()
    def _finish_prefill(self, slot_id, req, cache, final_logits, pages, reg_keys: tuple = (),
                        n_matched: int = 0):
        """Scatter the prefilled KV into pages, sample the first token and
        arm the slot. A cached prefix occupies the first `n_matched` pages,
        owned by the prefix cache and never rewritten: their scatter writes
        go to the trash page. Unused table entries point at the trash page,
        not page 0, so a burst's overrun writes never land on another
        request's page."""
        T = len(req.prompt_tokens)
        dev = self.device
        page_vec = np.full(self.max_pages_per_seq, self.trash_page, np.int32)
        page_vec[: len(pages)] = pages
        scat_vec = np.full(self.max_pages_per_seq, self.trash_page, np.int32)
        scat_vec[: len(pages)] = [self.trash_page] * n_matched + pages[n_matched:]
        # contiguous cache: per-layer head-major [1, Hkv, S, D]; the pool is
        # token-major [L, P, ps, Hkv, D]. Trim to the table's capacity.
        max_rows = min(cache.k[0].shape[2], self.max_pages_per_seq * self.page_size)
        layer_k = torch.stack([k[0].transpose(0, 1)[:max_rows] for k in cache.k])
        layer_v = torch.stack([v[0].transpose(0, 1)[:max_rows] for v in cache.v])
        scatter_prefill_kv(self.config, self.cache, layer_k, layer_v, self._dev(scat_vec))
        if self.prefix_caching:
            self._register_prefix(pages, reg_keys, n_matched, req.prompt_tokens)
        sp = req.sampling
        seed = sp.seed if sp.seed is not None else abs(hash(req.request_id)) % (1 << 31)
        if sp.logit_bias or self._bias_dirty[slot_id]:
            bias_row = np.zeros(self.config.vocab_size, np.float32)
            for tid, b in sp.logit_bias:
                if 0 <= tid < self.config.vocab_size:
                    bias_row[tid] = b
            self.logit_biases[slot_id] = self._dev(bias_row)
            self._bias_dirty[slot_id] = bool(sp.logit_bias)
        # the prompt's token counts, built on the device
        row = torch.zeros((1, self.config.vocab_size), dtype=torch.int32, device=dev)
        prompt = self._dev(np.asarray(req.prompt_tokens, np.int64))
        row[0].index_add_(0, prompt, torch.ones_like(prompt, dtype=torch.int32))
        tok, lp, tids, tlps = sample_batch(
            final_logits, self._dev(np.array([seed], np.int64)),
            torch.zeros(1, dtype=torch.int64, device=dev),
            self._dev(np.array([sp.temperature], np.float32)),
            self._dev(np.array([sp.top_p], np.float32)),
            self._dev(np.array([sp.top_k], np.int32)),
            self._dev(np.array([sp.repetition_penalty], np.float32)),
            row, self.logit_biases[slot_id : slot_id + 1],
        )
        self.token_counts[slot_id] = row[0]
        packed = torch.cat([tok.view(torch.float32), lp, tids.view(torch.float32).reshape(-1),
                            tlps.reshape(-1)]).cpu().numpy()
        tok_i = int(packed[:1].view(np.int32)[0])
        tops = None
        if sp.top_logprobs:
            tops = list(zip(packed[2 : 2 + TOPN].view(np.int32).tolist(),
                            packed[2 + TOPN :].tolist()))
        slot = self.slots[slot_id]
        slot.request = req
        slot.n_generated = 1
        slot.pages = pages
        slot.ctx = list(req.prompt_tokens)  # _emit appends generated tokens
        self.tokens[slot_id] = tok_i
        self.seq_lens[slot_id] = T
        self.page_table[slot_id] = page_vec
        self.temps[slot_id] = sp.temperature
        self.top_ps[slot_id] = sp.top_p
        self.top_ks[slot_id] = sp.top_k
        self.rep_pens[slot_id] = sp.repetition_penalty
        self.slot_seeds[slot_id] = seed
        self.slot_steps[slot_id] = 1
        req.first_token_time = time.perf_counter()
        self._ttfts.append(req.ttft)
        self._emit(slot_id, tok_i, float(packed[1]), tops)

    def _sampler(self):
        """The batched sampler over every slot, its per-slot vectors shipped
        from the host state once (a copy to the device waits for the stream,
        so none may fall inside a burst): returns sample(logits, steps)."""
        seeds, temps, top_ps, top_ks, pens = (self._dev(a) for a in (
            self.slot_seeds, self.temps, self.top_ps, self.top_ks, self.rep_pens))
        return lambda logits, steps: sample_batch(
            logits, seeds, steps, temps, top_ps, top_ks, pens, self.token_counts,
            self.logit_biases)

    def _decode(self, active: list[int]):
        if self.spec_k and self._try_decode_spec(active):
            self._last_tick_steps = 0
            return
        burst = self._burst_size(active)
        self._last_tick_steps = burst
        self._decode_burst(active, burst)

    def _burst_size(self, active: list[int]) -> int:
        """Steps in this tick: 1 while admission work is pending (chunked
        prefill keeps interleaving), else decode_burst when every active
        slot has at least that many tokens left, else 1."""
        if self.decode_burst <= 1:
            return 1
        if self._prefill_states or self._pending or not self.waiting.empty():
            return 1
        remaining = min(
            self.slots[i].request.sampling.max_tokens - self.slots[i].n_generated for i in active
        )
        return self.decode_burst if remaining >= self.decode_burst else 1

    @torch.no_grad()
    def _decode_burst(self, active: list[int], n_steps: int):
        """n_steps paged decode + sample steps; the sampled tokens feed back
        on the device, and one device-to-host copy brings every step's
        tokens, logprobs and top alternatives. Slots that finish mid-burst
        keep decoding into their reserved pages (past them, the table's
        trash entries); the host drops their extra tokens."""
        tokens = self._dev(self.tokens)
        seq_lens = self._dev(self.seq_lens)
        page_table = self._dev(self.page_table)
        steps0 = self._dev(self.slot_steps)
        sample = self._sampler()
        outs = []
        for i in range(n_steps):
            logits, self.cache = paged_decode_step(
                self.params, self.config, tokens, seq_lens, page_table, self.cache,
                quant_mode=self.quant_mode)
            tokens, lps, tids, tlps = sample(logits, steps0 + i)
            seq_lens = seq_lens + 1
            outs.append(torch.cat([tokens.view(torch.float32)[:, None], lps[:, None],
                                   tids.view(torch.float32), tlps], dim=1))
        host = torch.stack(outs).cpu().numpy()  # [n_steps, B, 2 + 2 * TOPN]
        toks_host = host[:, :, 0].view(np.int32)
        tids_host = host[:, :, 2 : 2 + TOPN].copy().view(np.int32)
        self.metrics["steps"] += n_steps
        self.seq_lens[active] += n_steps
        self.slot_steps += n_steps
        for step in range(n_steps):
            for i in active:
                if self.slots[i].request is None:
                    continue  # finished earlier in this burst
                tok = int(toks_host[step, i])
                self.tokens[i] = tok
                self.slots[i].n_generated += 1
                tops = (list(zip(tids_host[step, i].tolist(), host[step, i, 2 + TOPN :].tolist()))
                        if self.slots[i].request.sampling.top_logprobs else None)
                self._emit(i, tok, float(host[step, i, 1]), tops)

    @torch.no_grad()
    def _try_decode_spec(self, active: list[int]) -> bool:
        """Speculative tick: greedy, unpenalized, unbiased slots without top
        logprobs that have a prompt-lookup draft verify [current + k drafts]
        in ONE paged forward and emit their accepted prefix + correction;
        the other slots draw one token each from the window-row-0 logits
        through the batched sampler, their step counter advancing by one as
        in the plain path. Returns False when no eligible slot drafted."""

        def _eligible(i: int) -> bool:
            sp = self.slots[i].request.sampling
            return (self.temps[i] == 0.0 and self.rep_pens[i] == 1.0
                    and not sp.top_logprobs and not sp.logit_bias)

        k = self.spec_k
        elig = [i for i in active if _eligible(i)]
        drafts = {i: _lookup_draft(self.slots[i].ctx, k) for i in elig}
        if not any(drafts.values()):
            return False
        others = [i for i in active if i not in drafts]
        windows = np.zeros((self.max_batch, 1 + k), np.int32)
        for i in active:
            windows[i, 0] = self.tokens[i]
            d = drafts.get(i, ())
            windows[i, 1 : 1 + len(d)] = d
        steps = self._dev(self.slot_steps)
        sample = self._sampler() if others else None
        pred, lps, logits0, self.cache = paged_verify_step(
            self.params, self.config, self._dev(windows), self._dev(self.seq_lens),
            self._dev(self.page_table), self.cache, self.trash_page, quant_mode=self.quant_mode)
        parts = [pred.view(torch.float32), lps]
        if others:
            s_toks, s_lps, s_tids, s_tlps = sample(logits0, steps)
            parts += [s_toks.view(torch.float32)[:, None], s_lps[:, None],
                      s_tids.view(torch.float32), s_tlps]
        host = torch.cat(parts, dim=1).cpu().numpy()  # one device-to-host copy
        W = 1 + k
        pred_h = host[:, :W].copy().view(np.int32)
        lps_h = host[:, W : 2 * W]
        self.metrics["steps"] += 1
        self.metrics["spec_windows"] += len(drafts)
        for i in elig:
            d = drafts[i]
            n_acc = 0
            while n_acc < len(d) and d[n_acc] == int(pred_h[i, n_acc]):
                n_acc += 1
            self.metrics["spec_drafted"] += len(d)
            self.metrics["spec_accepted"] += n_acc
            self.seq_lens[i] += n_acc + 1
            self.slot_steps[i] += n_acc + 1
            for j in range(n_acc + 1):
                if self.slots[i].request is None:
                    break  # finished (EOS/max_tokens) earlier in this window
                tok = int(pred_h[i, j])
                self.tokens[i] = tok
                self.slots[i].n_generated += 1
                self._emit(i, tok, float(lps_h[i, j]))
        if others:
            o = 2 * W
            s_toks_h = host[:, o].copy().view(np.int32)
            s_tids_h = host[:, o + 2 : o + 2 + TOPN].copy().view(np.int32)
            for i in others:
                self.seq_lens[i] += 1
                self.slot_steps[i] += 1
                tok = int(s_toks_h[i])
                self.tokens[i] = tok
                self.slots[i].n_generated += 1
                tops = (list(zip(s_tids_h[i].tolist(), host[i, o + 2 + TOPN :].tolist()))
                        if self.slots[i].request.sampling.top_logprobs else None)
                self._emit(i, tok, float(host[i, o + 1]), tops)
        return True

    def _emit(self, slot_id: int, tok: int, lp: float | None = None, tops: list | None = None):
        slot = self.slots[slot_id]
        req = slot.request
        self.metrics["tokens_generated"] += 1
        stop_ids = set(req.sampling.stop_token_ids) | self.eos_ids
        finished = tok in stop_ids or slot.n_generated >= req.sampling.max_tokens
        if lp is not None:
            req.logprobs.append(lp)
        if tops is not None:
            req.top_logprobs.append(tops)
        slot.ctx.append(tok)
        req.out_queue.put(("token", tok))
        if finished:
            self._finish_slot(slot_id, req)

    def _finish_slot(self, slot_id: int, req: Request):
        """Emit 'done', release the slot's pages (shared prefix pages go idle
        when their last user leaves) and zero the slot state."""
        slot = self.slots[slot_id]
        req.finish_time = time.perf_counter()
        req.out_queue.put(("done", None))
        for pid in slot.pages:
            if pid in self.page_key:
                self.page_refs[pid] -= 1
                if self.page_refs[pid] == 0:
                    self.cached_idle[pid] = self.page_key[pid]
            else:
                self.free_pages.append(pid)
        slot.request = None
        slot.pages = []
        slot.ctx = []
        self.seq_lens[slot_id] = 0
        self.tokens[slot_id] = 0
        self.temps[slot_id] = 0.0
        self.top_ps[slot_id] = 1.0
        self.top_ks[slot_id] = 0
        self.rep_pens[slot_id] = 1.0
        self.page_table[slot_id] = self.trash_page

    def _reap_cancelled(self):
        """Finish any slot or queued request whose id was cancel()ed. Slots
        mid-prefill finish on a later tick (their KV must land first). Ids
        that match no live request (cancel raced a natural finish) are
        dropped so the set stays bounded."""
        if not self._cancelled:
            return
        snapshot = set(self._cancelled)
        live: set[str] = set()
        for i, slot in enumerate(self.slots):
            r = slot.request
            if r is None:
                continue
            if not slot.prefilling and r.request_id in self._cancelled:
                self._cancelled.discard(r.request_id)
                self._finish_slot(i, r)
            else:
                live.add(r.request_id)
        for r in list(self._pending):
            if r.request_id in self._cancelled:
                self._pending.remove(r)
                self._cancelled.discard(r.request_id)
                r.out_queue.put(("done", None))
        if self._cancelled:
            kept = []
            while True:
                try:
                    r = self.waiting.get_nowait()
                except queue.Empty:
                    break
                if r.request_id in self._cancelled:
                    self._cancelled.discard(r.request_id)
                    r.out_queue.put(("done", None))
                else:
                    kept.append(r)
            for r in kept:
                self.waiting.put(r)
            self._cancelled -= {i for i in (snapshot & self._cancelled) if i not in live}

    @torch.no_grad()
    def score_sync(self, prompt_tokens: list[int]) -> list[float | None]:
        """Per-token prompt logprobs log p(tok_i | tok_<i) from one bucketed
        prefill; the first token has none (None, as OpenAI's echo)."""
        T = len(prompt_tokens)
        if T > self.max_len:
            raise ValueError(f"prompt {T} exceeds engine max_len {self.max_len}")
        if T < 2:
            return [None] * T
        bucket = self._bucket(T)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :T] = prompt_tokens
        cache = KVCache.create(self.config, 1, bucket, self.prefill_dtype, self.device)
        logits, _ = model_forward(self.params, self.config, self._dev(toks), cache,
                                  quant_mode=self.quant_mode, attn_mode=self.prefill_attn)
        lp = torch.log_softmax(logits[0, : T - 1].to(torch.float32), dim=-1)
        idx = self._dev(np.asarray(prompt_tokens[1:], np.int64))
        vals = lp.gather(1, idx[:, None])[:, 0]
        return [None] + vals.cpu().tolist()

    def generate_sync(self, prompt_tokens: list[int], sampling: SamplingParams,
                      timeout: float = 300.0) -> list[int]:
        """Submit one request and return its tokens, stepping the engine
        itself unless a background thread runs it."""
        req = self.submit(prompt_tokens, sampling)
        out: list[int] = []
        deadline = time.time() + timeout
        driving = self._thread is None
        while True:
            if driving:
                self.step()
                try:
                    while True:
                        kind, tok = req.out_queue.get_nowait()
                        if kind == "done":
                            return out
                        out.append(tok)
                except queue.Empty:
                    pass
            else:
                try:
                    kind, tok = req.out_queue.get(timeout=0.1)
                    if kind == "done":
                        return out
                    out.append(tok)
                except queue.Empty:
                    pass
            if time.time() > deadline:
                raise TimeoutError(req.request_id)
