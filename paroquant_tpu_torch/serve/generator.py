"""Single-stream generator: prefill, then sample -> decode_step per token,
in bursts, or by prompt-lookup speculation.

Counterpart of `paroquant_tpu/serve/generator.py`: the plain loop, decode
bursts (`_stream_burst_impl`: n sample+decode steps with no host sync, the
tokens brought to the host once a burst), greedy and sampled prompt-lookup
speculation (`_verify_window`, `_verify_window_sampled`,
`Generator._spec_stream`), `detect_backend`, `build_prompt` and
`create_generator`, and the prompt-lookup drafter `_lookup_draft`, which
the engine's speculative ticks use too. JAX's burst is one `lax.scan`
dispatch; here it is a loop of the same steps that the host does not wait
on. `pixel_values` runs the VLM prefill (`models/vision.py::
vlm_prefill_step`) in place of the text prefill; decoding goes on through
the text path. The tokenizer is optional.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import KVCache, decode_step, model_forward, prefill
from ..utils.device import resolve_device
from .sampling import SamplingParams, sample_token, spec_accept_sample

CACHE_ROWS_MULTIPLE = 128


@torch.no_grad()
def _stream_burst_impl(params, config, logits, cache, generator, counts, *, quant_mode,
                       n_steps, temperature, top_p, top_k, repetition_penalty):
    """n_steps sample+decode steps with the per-step loop's sampling chain
    (the same `generator` draws, the same counts update before each decode),
    so the tokens equal that loop's. Nothing here waits for the device.
    Returns (tokens [n_steps] int32 on the device, final logits, cache, counts)."""
    toks = []
    for _ in range(n_steps):
        tok = sample_token(
            logits, generator, counts if repetition_penalty != 1.0 else None,
            temperature=temperature, top_p=top_p, top_k=top_k,
            repetition_penalty=repetition_penalty,
        )
        if repetition_penalty != 1.0:
            counts[0, tok.long()] += 1
        logits, cache = decode_step(params, config, tok[:, None], cache, quant_mode=quant_mode)
        toks.append(tok[0])
    return torch.stack(toks), logits, cache, counts


@torch.no_grad()
def _verify_window(params, config, window, cache, quant_mode):
    """Speculative verify: one forward over [1, 1 + k] tokens (the current
    token and k drafts) from the cache's length. Returns the greedy next
    token after every window position [1 + k] int32, and the cache with the
    window's KV rows written."""
    logits, cache = model_forward(params, config, window, cache, quant_mode=quant_mode)
    return torch.argmax(logits[0].to(torch.float32), dim=-1).to(torch.int32), cache


@torch.no_grad()
def _verify_window_sampled(params, config, window, cache, generator, d_len, quant_mode,
                           temperature, top_p, top_k):
    """Sampled speculative verify: the forward of `_verify_window`, then
    `sampling.spec_accept_sample` on the device. Returns (tokens [1 + k],
    n_accepted, raw logprobs [1 + k], cache)."""
    logits, cache = model_forward(params, config, window, cache, quant_mode=quant_mode)
    toks, n_acc, lps = spec_accept_sample(
        logits[0].to(torch.float32), window[0, 1:], d_len, generator,
        temperature=temperature, top_p=top_p, top_k=top_k,
    )
    return toks, n_acc, lps, cache


def _lookup_draft(ctx: list[int], k: int, max_ngram: int = 3) -> list[int]:
    """Prompt-lookup drafting: find the most recent earlier occurrence of the
    longest suffix n-gram (n <= max_ngram) of the context and propose the k
    tokens that followed it; [] when no n-gram recurs. As in JAX, contexts
    over 512 tokens go through the C++ scan (native/paropack.cpp via
    `ops/native_packing.py`): this runs per slot per scheduler tick, up to
    32k-token contexts. Shorter ones, and every length when the native
    library is unavailable, take the numpy scan, with the same result."""
    L = len(ctx)
    if L > 512:
        from ..ops.native_packing import native_lookup_draft

        d = native_lookup_draft(np.asarray(ctx, np.int32), max_ngram, k)
        if d is not None:
            return d
    if L < 2:
        return []
    arr = np.asarray(ctx, np.int64)
    for n in range(min(max_ngram, L - 1), 0, -1):
        # windows starting at i = 0 .. L-n-1 (the suffix itself excluded)
        win = np.lib.stride_tricks.sliding_window_view(arr[: L - 1], n)
        hits = np.flatnonzero((win == arr[L - n :]).all(axis=1))
        if hits.size:
            i = int(hits[-1])
            return ctx[i + n : i + n + k]
    return []


@dataclasses.dataclass
class GenerationStats:
    ttft: float = 0.0  # seconds to first token
    latency: float = 0.0  # total seconds
    num_tokens: int = 0

    @property
    def tokens_per_second(self) -> float:
        decode_time = max(self.latency - self.ttft, 1e-9)
        return max(self.num_tokens - 1, 0) / decode_time


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[int]
    text: str
    stats: GenerationStats


def detect_backend() -> str:
    """"cuda" when a CUDA device is present, else "cpu" (the JAX function
    answers "tpu" or "cpu")."""
    return "cuda" if torch.cuda.is_available() else "cpu"


class Generator:
    """Single-stream generator over a (params, config) model.

    quant_mode defaults to "auto" on CUDA (the kernels at decode-sized M)
    and "xla" on the CPU, as the JAX generator picks by backend.
    attn_mode "flash" runs prefills of T >= 128 (T % 128 == 0) through the
    flash kernel. The KV cache is sized to the request, rounded up to a
    multiple of 128 rows (capped at max_len) so that such prefills meet the
    flash gate; the extra rows are masked and change no result.

    decode_burst > 1 samples and decodes that many tokens before the host
    reads them (full bursts, then single steps), with the tokens of
    decode_burst = 1. lookup_spec_k > 0 decodes by prompt-lookup
    speculation with k-token drafts: greedy requests get the tokens of the
    sequential greedy loop under the verify forward's numerics, sampled ones
    tokens of the same distribution. Requests with a repetition penalty, or
    whose prompt, max_tokens and k do not fit max_len, take the normal path,
    as do hybrid (delta-net) models, whose recurrent state cannot roll back
    rejected drafts, and gemma3n models (JAX keeps both off speculation);
    a hybrid's steps and bursts carry the delta-net states in the cache.
    """

    def __init__(
        self,
        params: dict[str, Any],
        config: ModelConfig,
        tokenizer=None,
        *,
        max_len: int = 4096,
        quant_mode: str | None = None,
        attn_mode: str = "einsum",
        cache_dtype=torch.bfloat16,
        decode_burst: int = 1,
        lookup_spec_k: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.attn_mode = attn_mode
        self.decode_burst = max(1, decode_burst)
        self.lookup_spec_k = max(0, lookup_spec_k)
        self.spec_metrics = {"windows": 0, "drafted": 0, "accepted": 0}
        if quant_mode is None:
            quant_mode = "auto" if self.device.type == "cuda" else "xla"
        self.quant_mode = quant_mode

    @classmethod
    def from_pretrained(cls, model_dir: str | Path, device="cuda", **kw) -> "Generator":
        from ..convert.checkpoint import load_checkpoint

        params, config = load_checkpoint(model_dir, device=device)
        return cls(params, config, load_tokenizer(model_dir), device=device, **kw)

    def build_prompt(self, messages: list[dict[str, str]], enable_thinking: bool = True) -> list[int]:
        """The tokenizer's chat template over messages, with the generation prompt."""
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer available")
        try:
            return self.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True, enable_thinking=enable_thinking)
        except TypeError:  # a template without thinking support
            return self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)

    def _cache_len(self, n_prompt: int, max_tokens: int, slack: int = 0) -> int:
        """Rows for a request; `slack` holds the k rows a speculative request's
        last verify window writes past its final token (the KV writes raise
        past the buffer, where JAX's clamp)."""
        need = n_prompt + max_tokens + slack
        rounded = -(-need // CACHE_ROWS_MULTIPLE) * CACHE_ROWS_MULTIPLE
        return max(min(self.max_len, rounded), min(self.max_len, need))

    def _speculates(self, n_prompt: int, sp: SamplingParams) -> bool:
        # a penalty changes the counts inside a window, which the one-shot
        # accept/reject cannot follow; the last window needs k rows of slack
        return (self.lookup_spec_k > 0 and sp.repetition_penalty == 1.0
                and self.config.num_linear_layers == 0 and not self.config.is_gemma3n
                and n_prompt + sp.max_tokens + self.lookup_spec_k <= self.max_len)

    @torch.no_grad()
    def stream_generate(
        self, prompt_tokens: list[int], sp: SamplingParams,
        generator: torch.Generator | None = None, pixel_values=None,
    ) -> Iterator[int]:
        """Yield token ids. `generator` draws the samples; by default one on
        the model's device seeded with sp.seed (0 when None). `pixel_values`
        [N_img, C, H, W] (numpy or a tensor, in the dtype the tower is to
        run in) takes the image-text path: the prompt's image_token_id runs
        are replaced by the images' soft tokens in the prefill."""
        if pixel_values is not None and self.config.vision is None:
            raise ValueError("model has no vision tower; cannot take images")
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(sp.seed if sp.seed is not None else 0)
        spec = self._speculates(len(prompt_tokens), sp)
        toks = torch.tensor([list(prompt_tokens)], dtype=torch.int32, device=self.device)
        cache = KVCache.create(
            self.config, 1,
            self._cache_len(toks.shape[1], sp.max_tokens, self.lookup_spec_k if spec else 0),
            self.cache_dtype, self.device,
        )
        counts = None
        if sp.repetition_penalty != 1.0:
            counts = torch.zeros((1, self.config.vocab_size), dtype=torch.int32, device=self.device)
            counts[0].index_add_(0, toks[0].long(), torch.ones_like(toks[0]))
        if pixel_values is not None:
            from ..models.vision import vlm_prefill_step

            logits, cache = vlm_prefill_step(
                self.params, self.config, toks, torch.as_tensor(pixel_values, device=self.device),
                cache, quant_mode=self.quant_mode)
        else:
            logits, cache = prefill(
                self.params, self.config, toks, cache,
                quant_mode=self.quant_mode, attn_mode=self.attn_mode,
            )
        stop = set(sp.stop_token_ids)
        if self.tokenizer is not None and getattr(self.tokenizer, "eos_token_id", None) is not None:
            stop.add(int(self.tokenizer.eos_token_id))
        if spec:
            if sp.greedy:
                first = int(torch.argmax(logits[0].to(torch.float32)))
                verify = self._verify_greedy
            else:
                first = int(sample_token(logits, generator, None, temperature=sp.temperature,
                                         top_p=sp.top_p, top_k=sp.top_k)[0])

                def verify(window, cache, draft):
                    toks, n_acc, _, cache = _verify_window_sampled(
                        self.params, self.config, window, cache, generator, len(draft),
                        self.quant_mode, sp.temperature, sp.top_p, sp.top_k)
                    return toks.tolist(), int(n_acc), cache

            yield from self._spec_stream(list(prompt_tokens), first, cache, sp, stop, verify)
            return
        if self.decode_burst > 1:
            remaining = sp.max_tokens
            while remaining > 0:
                # full bursts, then single steps
                n = self.decode_burst if remaining >= self.decode_burst else 1
                burst, logits, cache, counts = _stream_burst_impl(
                    self.params, self.config, logits, cache, generator, counts,
                    quant_mode=self.quant_mode, n_steps=n, temperature=sp.temperature,
                    top_p=sp.top_p, top_k=sp.top_k, repetition_penalty=sp.repetition_penalty,
                )
                for tid in burst.tolist():
                    yield tid
                    remaining -= 1
                    if tid in stop or remaining <= 0:
                        return
            return
        for i in range(sp.max_tokens):
            tok = sample_token(
                logits, generator, counts, temperature=sp.temperature, top_p=sp.top_p,
                top_k=sp.top_k, repetition_penalty=sp.repetition_penalty,
            )
            tid = int(tok[0])
            yield tid
            if tid in stop or i + 1 >= sp.max_tokens:
                break
            if counts is not None:
                counts[0, tid] += 1
            logits, cache = decode_step(
                self.params, self.config, tok[:, None], cache, quant_mode=self.quant_mode,
            )

    def _window(self, cur: int, draft: list[int]) -> torch.Tensor:
        window = torch.zeros((1, 1 + self.lookup_spec_k), dtype=torch.int32)
        window[0, 0] = cur
        window[0, 1 : 1 + len(draft)] = torch.tensor(draft, dtype=torch.int32)
        return window.to(self.device)

    def _at_length(self, cache: KVCache, L: int) -> KVCache:
        """The cache with its length set to L rows: the rows of rejected drafts
        past L are overwritten by the next window before they are attended."""
        return KVCache(cache.k, cache.v, torch.tensor(L, dtype=torch.int32, device=self.device))

    def _count_window(self, n_draft: int, n_acc: int) -> None:
        self.spec_metrics["windows"] += 1
        self.spec_metrics["drafted"] += n_draft
        self.spec_metrics["accepted"] += n_acc

    def _verify_greedy(self, window, cache, draft):
        """Greedy verify: the window's greedy tokens, and how many drafts lead
        them (the drafts the sequential greedy loop would have emitted)."""
        pred, cache = _verify_window(self.params, self.config, window, cache, self.quant_mode)
        pred = pred.tolist()  # pred[i]: the greedy token after window[: i + 1]
        n_acc = 0
        while n_acc < len(draft) and draft[n_acc] == pred[n_acc]:
            n_acc += 1
        return pred, n_acc, cache

    def _spec_stream(self, prompt_tokens, cur, cache, sp, stop, verify):
        """Prompt-lookup speculation after the first token `cur`: each window
        drafts k tokens from the context's own n-grams, and `verify(window,
        cache, draft)` runs the current token and the drafts in one forward
        and returns the window's tokens, the drafts it accepted and the cache;
        the accepted drafts and the token after them are emitted.

        Greedy (`_verify_greedy`): in exact arithmetic the sequential greedy
        tokens; on the card a verify of 1 + k rows rounds apart from a decode
        of one, so an argmax near-tie can flip (JAX's docstring records the
        same on the TPU). Sampled (`_verify_window_sampled`): rejection
        sampling under the request's temperature, top-k and top-p, so the
        tokens follow the sequential sampler's distribution, though not its
        draws."""
        yield cur
        emitted = 1
        if cur in stop:
            return
        ctx = list(prompt_tokens) + [cur]
        L = len(prompt_tokens)  # rows of valid KV in the cache
        while emitted < sp.max_tokens:
            draft = _lookup_draft(ctx, self.lookup_spec_k)
            toks, n_acc, cache = verify(self._window(cur, draft), self._at_length(cache, L), draft)
            self._count_window(len(draft), n_acc)
            L += n_acc + 1  # the accepted drafts' rows and cur's own
            for cur in toks[: n_acc + 1]:
                yield cur
                ctx.append(cur)
                emitted += 1
                if cur in stop or emitted >= sp.max_tokens:
                    return

    def generate(self, prompt_tokens: list[int], sp: SamplingParams,
                 generator: torch.Generator | None = None, pixel_values=None) -> GenerationResult:
        """Run stream_generate to its end and measure TTFT / latency / tokens per second."""
        stats = GenerationStats()
        out: list[int] = []
        start = time.perf_counter()
        for tid in self.stream_generate(prompt_tokens, sp, generator, pixel_values):
            if not out:
                stats.ttft = time.perf_counter() - start
            out.append(tid)
        stats.latency = time.perf_counter() - start
        stats.num_tokens = len(out)
        return GenerationResult(out, self.decode_text(out), stats)

    def decode_text(self, token_ids: list[int]) -> str:
        if self.tokenizer is None:
            return ""
        return self.tokenizer.decode(token_ids, skip_special_tokens=True)


def load_tokenizer(model_dir: str | Path):
    """HF tokenizer if its files and the transformers package are present, else None."""
    model_dir = Path(model_dir)
    if not (model_dir / "tokenizer.json").exists() and not (model_dir / "tokenizer.model").exists():
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    return AutoTokenizer.from_pretrained(str(model_dir))


def create_generator(model_dir: str | Path, **kw) -> Generator:
    """A Generator over the checkpoint in model_dir (Generator.from_pretrained)."""
    return Generator.from_pretrained(model_dir, **kw)
