"""Token sampling: repetition penalty -> temperature -> top-k -> top-p.

Counterpart of `paroquant_tpu/serve/sampling.py:20-88` and of the engine's
batched sampler (`paroquant_tpu/serve/engine.py::_sample_batch_impl`).
Single-stream randomness comes from an explicit `torch.Generator`; the
engine's per-slot draws come from a counter hash of (the request's seed,
its step), so a request's tokens do not depend on the other requests in
the batch. Both give other numbers than `jax.random` for the same seed:
sampled tokens are reproducible run to run within the port, not equal to
the JAX package's. Greedy (temperature 0) is the same argmax in both. `modified_probs` and `spec_accept_sample`
(`paroquant_tpu/serve/sampling.py:90-171`) serve the Generator's sampled
speculative stream; their draws come from a `torch.Generator` as well, so
their accepted tokens follow the JAX package's distribution, not its
numbers.
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
    # OpenAI top_logprobs: N alternative tokens per position (the engine
    # carries up to TOPN=8); 0 disables the host-side bookkeeping
    top_logprobs: int = 0
    # OpenAI logit_bias: ((token_id, bias), ...) added to logits before sampling
    logit_bias: tuple[tuple[int, float], ...] = ()
    stop_token_ids: tuple[int, ...] = ()
    # string stop sequences (OpenAI `stop`): matched against decoded text by
    # an HTTP layer, which cancels the engine request; the engine itself
    # stays token-level
    stop: tuple[str, ...] = ()

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


def _top_k_top_p(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Mask logits [..., V] below the k-th largest (k > 0), then outside the
    top-p nucleus (always keeping the top 1), with -inf. No host sync (the
    fills are scalars, not tensors copied to the device)."""
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability exceeds top_p (always the top 1)
        cutoff_logit = sorted_logits.masked_fill(cum - probs > top_p, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff_logit, float("-inf"))
    return logits


def _gumbel_argmax(logits: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row of logits [..., V] from softmax(logits) (int64):
    argmax(logits + g) with g ~ Gumbel(0, 1)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


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
    logits = _top_k_top_p(logits / temperature, top_k, top_p)
    return _gumbel_argmax(logits, generator).to(torch.int32)


def modified_probs(
    logits: torch.Tensor,  # [..., V]
    *,
    temperature: float,
    top_p: float = 1.0,
    top_k: int = 0,
) -> torch.Tensor:
    """The distribution sample_token draws from at temperature > 0 (the same
    masking order: temperature, top-k, top-p), as probabilities [..., V] f32.
    Speculative sampling needs it in closed form for its accept/reject math."""
    logits = _top_k_top_p(logits.to(torch.float32) / temperature, top_k, top_p)
    return torch.softmax(logits, dim=-1)


def spec_accept_sample(
    logits: torch.Tensor,  # [W, V]: verify-window logits (W = 1 + k)
    draft: torch.Tensor,  # [k] int: drafted tokens (a point-mass proposal)
    d_len: int,  # the number of real drafts (the rest is padding)
    generator: torch.Generator | None = None,
    *,
    temperature: float,
    top_p: float = 1.0,
    top_k: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative sampling (Leviathan et al., with a deterministic
    point-mass proposal): accept draft i with probability p_i(d_i) under the
    modified distribution p; at the first rejection emit one token from the
    residual (p_i without d_i's mass, renormalised); if every real draft is
    accepted, emit a bonus token from p at position d_len. Padding positions
    (i >= d_len) neither accept nor end the chain.

    Returns (tokens [W] int32, n_accepted 0-d int32, raw logprobs [W]); the
    caller emits tokens[: n_accepted + 1], laid out by position as the JAX
    function lays them out. The emitted tokens follow the sequential
    sampler's law (P(x) = p(d) 1[x = d] + (1 - p(d)) residual(x) = p(x)).
    JAX's `lax.scan` over the drafts is vectorised here: the uniforms, the
    residual draws and the bonus draw come from `generator` up front, and
    the chain is a cumulative product. No host sync."""
    W, _ = logits.shape
    k = draft.shape[0]
    dev = logits.device
    p = modified_probs(logits, temperature=temperature, top_p=top_p, top_k=top_k)
    raw_lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    draft = draft.to(device=dev, dtype=torch.int64)
    real = torch.arange(k, device=dev) < d_len
    p_draft = p[:k].gather(1, draft[:, None])[:, 0]
    u = torch.rand(k, generator=generator, device=dev)
    ok = u < p_draft
    resid = p[:k].scatter(1, draft[:, None], 0.0)
    resid_tok = _gumbel_argmax(torch.log(resid.clamp_min(1e-30)), generator)
    bonus = _gumbel_argmax(torch.log(p[d_len].clamp_min(1e-30)), generator)
    # the chain lives on through accepted and padding positions and dies at
    # the first real rejection; the accepted count is the leading run of
    # real, accepted drafts
    passed = (ok | ~real).to(torch.int32)
    alive = torch.cat([passed.new_ones(1), torch.cumprod(passed, dim=0)[:-1]]).bool()
    n_acc = torch.cumprod((real & ok).to(torch.int32), dim=0).sum()
    all_real_accepted = passed.bool().all()
    toks = torch.cat([torch.where(alive & real & ok, draft, resid_tok), draft.new_zeros(W - k)])
    at = n_acc.to(torch.int64).view(1)
    toks = toks.scatter(0, at, torch.where(all_real_accepted, bonus, toks.gather(0, at)[0]).view(1))
    lps = raw_lp.gather(1, toks[:, None])[:, 0]
    return toks.to(torch.int32), n_acc.to(torch.int32), lps


# ---------------------------------------------------------------------------
# Batched per-slot sampler (the engine's)
# ---------------------------------------------------------------------------

TOPN = 8  # top-logprob alternatives carried per step (OpenAI caps at 20)
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values below 2**32
    (every product stays below 2**63, so nothing overflows)."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def slot_uniforms(seeds: torch.Tensor, steps: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] uniforms in (0, 1), each a function of (seeds[b], steps[b], v)
    alone: a counter hash written in torch integer ops, so drawing makes no
    host sync and a slot's noise does not depend on the rest of the batch."""
    key = _mix32((seeds.to(torch.int64) & _M32) ^ 0x5BD1E995)
    key = _mix32(key ^ (steps.to(torch.int64) & _M32))
    vocab = torch.arange(V, dtype=torch.int64, device=seeds.device)
    x = _mix32((key[:, None] + vocab[None, :] * 0x9E3779B1) & _M32)
    x = _mix32(x ^ key[:, None])
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_batch(
    logits: torch.Tensor,  # [B, V]
    seeds: torch.Tensor,  # [B] int64: each request's seed
    steps: torch.Tensor,  # [B] int64: each request's step counter
    temps: torch.Tensor,  # [B] f32
    top_ps: torch.Tensor,  # [B] f32
    top_ks: torch.Tensor,  # [B] int
    rep_pens: torch.Tensor,  # [B] f32
    token_counts: torch.Tensor,  # [B, V] int32, updated in place
    logit_biases: torch.Tensor | None = None,  # [B, V] f32
):
    """Per-slot sampling in the order of the JAX engine: logit bias, raw
    log-softmax and its top-TOPN, repetition penalty, temperature, top-k,
    top-p, then a Gumbel-max draw. Greedy where temps == 0 (after the
    penalty, as in HF). Returns (tokens [B] int32, their raw logprobs [B],
    top ids [B, TOPN] int32, top logprobs [B, TOPN]); `token_counts` gains
    the drawn tokens. No host sync. The draw uses `slot_uniforms`, not
    `jax.random`, so sampled tokens differ from the JAX engine's."""
    B, V = logits.shape
    logits = logits.to(torch.float32)
    if logit_biases is not None:
        logits = logits + logit_biases
    raw_lp = torch.log_softmax(logits, dim=-1)
    top_lps, top_ids = torch.topk(raw_lp, TOPN, dim=-1)
    pen = rep_pens[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    logits = torch.where((token_counts > 0) & (pen != 1.0), penalized, logits)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    neg_inf = torch.full_like(scaled, float("-inf"))
    # top-k: mask below the k-th largest (k = 0 keeps all)
    k_idx = torch.where(top_ks > 0, top_ks.to(torch.int64), torch.full_like(top_ks, V, dtype=torch.int64)) - 1
    kth = torch.sort(scaled, dim=-1, descending=True).values.gather(1, k_idx[:, None])
    scaled = torch.where(scaled < kth, neg_inf, scaled)
    # top-p over the post-top-k distribution
    sorted_k = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.where(torch.isfinite(sorted_k), torch.softmax(sorted_k, dim=-1),
                        torch.zeros_like(sorted_k))
    cum = torch.cumsum(probs, dim=-1)
    cutoff = torch.where(cum - probs > top_ps[:, None], torch.full_like(sorted_k, float("inf")),
                         sorted_k).amin(dim=-1, keepdim=True)
    masked = torch.where(scaled < cutoff, neg_inf, scaled)
    gumbel = -torch.log(-torch.log(slot_uniforms(seeds, steps, V)))
    toks = torch.where(temps == 0, greedy, torch.argmax(masked + gumbel, dim=-1))
    token_counts[torch.arange(B, device=logits.device), toks] += 1
    lps = raw_lp.gather(1, toks[:, None])[:, 0]
    return toks.to(torch.int32), lps, top_ids.to(torch.int32), top_lps
