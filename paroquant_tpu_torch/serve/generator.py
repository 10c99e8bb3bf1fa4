"""Single-stream generator: prefill, then sample -> decode_step per token.

Counterpart of `paroquant_tpu/serve/generator.py:129-333, 434-476` (the
plain loop). Burst decode, prompt-lookup speculation and the VLM prefill
wait for later slices. The tokenizer is optional.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Iterator

import torch

from ..models.config import ModelConfig
from ..models.decoder import KVCache, decode_step, prefill
from ..utils.device import resolve_device
from .sampling import SamplingParams, sample_token

CACHE_ROWS_MULTIPLE = 128


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


class Generator:
    """Single-stream generator over a (params, config) model.

    quant_mode defaults to "auto" on CUDA (the kernels at decode-sized M)
    and "xla" on the CPU, as the JAX generator picks by backend.
    attn_mode "flash" runs prefills of T >= 128 (T % 128 == 0) through the
    flash kernel. The KV cache is sized to the request, rounded up to a
    multiple of 128 rows (capped at max_len) so that such prefills meet the
    flash gate; the extra rows are masked and change no result.
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
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.attn_mode = attn_mode
        if quant_mode is None:
            quant_mode = "auto" if self.device.type == "cuda" else "xla"
        self.quant_mode = quant_mode

    @classmethod
    def from_pretrained(cls, model_dir: str | Path, device="cuda", **kw) -> "Generator":
        from ..convert.checkpoint import load_checkpoint

        params, config = load_checkpoint(model_dir, device=device)
        return cls(params, config, load_tokenizer(model_dir), device=device, **kw)

    def _cache_len(self, n_prompt: int, max_tokens: int) -> int:
        need = n_prompt + max_tokens
        rounded = -(-need // CACHE_ROWS_MULTIPLE) * CACHE_ROWS_MULTIPLE
        return max(min(self.max_len, rounded), min(self.max_len, need))

    @torch.no_grad()
    def stream_generate(
        self, prompt_tokens: list[int], sp: SamplingParams,
        generator: torch.Generator | None = None,
    ) -> Iterator[int]:
        """Yield token ids. `generator` draws the samples; by default one on
        the model's device seeded with sp.seed (0 when None)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(sp.seed if sp.seed is not None else 0)
        toks = torch.tensor([list(prompt_tokens)], dtype=torch.int32, device=self.device)
        cache = KVCache.create(
            self.config, 1, self._cache_len(toks.shape[1], sp.max_tokens),
            self.cache_dtype, self.device,
        )
        counts = None
        if sp.repetition_penalty != 1.0:
            counts = torch.zeros((1, self.config.vocab_size), dtype=torch.int32, device=self.device)
            counts[0].index_add_(0, toks[0].long(), torch.ones_like(toks[0]))
        logits, cache = prefill(
            self.params, self.config, toks, cache,
            quant_mode=self.quant_mode, attn_mode=self.attn_mode,
        )
        stop = set(sp.stop_token_ids)
        if self.tokenizer is not None and getattr(self.tokenizer, "eos_token_id", None) is not None:
            stop.add(int(self.tokenizer.eos_token_id))
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

    def generate(self, prompt_tokens: list[int], sp: SamplingParams,
                 generator: torch.Generator | None = None) -> GenerationResult:
        """Run stream_generate to its end and measure TTFT / latency / tokens per second."""
        stats = GenerationStats()
        out: list[int] = []
        start = time.perf_counter()
        for tid in self.stream_generate(prompt_tokens, sp, generator):
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
