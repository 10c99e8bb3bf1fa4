"""Token sampling: repetition penalty -> temperature -> top-k -> top-p.

Counterpart of `paroquant_tpu/serve/sampling.py:20-88`. Randomness comes
from an explicit `torch.Generator`; it gives other numbers than
`jax.random` for the same seed, so sampled tokens are reproducible run to
run within the port, not equal to the JAX package's. Greedy
(temperature 0) is the same argmax in both. `spec_accept_sample` and the
fields that only the engine and the HTTP layer read (`top_logprobs`,
`logit_bias`, string `stop`) wait for the serving slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_tokens: int = 512
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    repetition_penalty: float = 1.0
    seed: int | None = None
    stop_token_ids: tuple[int, ...] = ()

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def apply_repetition_penalty(
    logits: torch.Tensor, token_counts: torch.Tensor, penalty: float
) -> torch.Tensor:
    """HF-style: divide positive logits of seen tokens by p, multiply negative."""
    if penalty == 1.0:
        return logits
    seen = token_counts > 0
    return torch.where(seen, torch.where(logits > 0, logits / penalty, logits * penalty), logits)


def sample_token(
    logits: torch.Tensor,  # [B, V]
    generator: torch.Generator | None = None,
    token_counts: torch.Tensor | None = None,  # [B, V] int or None
    *,
    temperature: float = 1.0,
    top_p: float = 1.0,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """Returns sampled token ids [B] int32 (no host sync)."""
    logits = logits.to(torch.float32)
    if repetition_penalty != 1.0 and token_counts is not None:
        logits = apply_repetition_penalty(logits, token_counts, repetition_penalty)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability exceeds top_p (always the top 1)
        cutoff_mask = cum - probs > top_p
        cutoff_logit = torch.where(
            cutoff_mask, torch.tensor(float("inf"), device=logits.device), sorted_logits
        ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff_logit, neg_inf, logits)
    # Gumbel-max: argmax(logits + g) with g ~ Gumbel(0, 1) draws from softmax(logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
