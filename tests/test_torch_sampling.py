"""The port's sampling pieces against the JAX package on the CPU: the
fields of SamplingParams, the batched per-slot sampler's greedy path and
raw logprobs against the JAX engine's `_sample_batch`, the law of its
sampled draws, and prompt-lookup drafting against JAX's `_lookup_draft`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.serve.engine import _sample_batch as j_sample_batch
from paroquant_tpu.serve.generator import _lookup_draft as j_lookup_draft
from paroquant_tpu.serve.sampling import SamplingParams as JSP
from paroquant_tpu_torch.serve.generator import _lookup_draft
from paroquant_tpu_torch.serve.sampling import TOPN, SamplingParams, sample_batch, slot_uniforms


def test_sampling_params_fields_match_jax():
    got = {f.name: f.default for f in dataclasses.fields(SamplingParams)}
    want = {f.name: f.default for f in dataclasses.fields(JSP)}
    assert got == want
    assert SamplingParams(temperature=0.0).greedy and not SamplingParams().greedy


def _batch(rng, B, V):
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = np.zeros((B, V), np.int32)
    counts[np.arange(B)[:, None], rng.integers(0, V, (B, 12))] += 1
    bias = np.zeros((B, V), np.float32)
    bias[0, rng.integers(0, V, 3)] = [5.0, -5.0, 2.0]
    return logits, counts, bias


def test_greedy_slots_match_jax_sample_batch():
    """Greedy slots (with and without penalty and bias) draw the JAX
    engine's tokens; raw logprobs and the top-TOPN agree in every slot."""
    rng = np.random.default_rng(1)
    B, V = 5, 96
    logits, counts, bias = _batch(rng, B, V)
    temps = np.array([0.0, 0.0, 0.8, 0.0, 1.1], np.float32)
    top_ps = np.array([1.0, 0.9, 0.9, 1.0, 0.5], np.float32)
    top_ks = np.array([0, 5, 10, 0, 0], np.int32)
    pens = np.array([1.0, 1.3, 1.0, 2.0, 1.2], np.float32)
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32)), np.uint32)
    jt, jc, jl, jids, jlps = j_sample_batch(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks), jnp.asarray(pens), jnp.asarray(counts), jnp.asarray(bias))
    tcounts = torch.from_numpy(counts.copy())
    tt, tl, tids, tlps = sample_batch(
        torch.from_numpy(logits), torch.arange(B), torch.zeros(B, dtype=torch.int64),
        torch.from_numpy(temps), torch.from_numpy(top_ps), torch.from_numpy(top_ks),
        torch.from_numpy(pens), tcounts, torch.from_numpy(bias))
    greedy = temps == 0
    np.testing.assert_array_equal(tt.numpy()[greedy], np.asarray(jt)[greedy])
    np.testing.assert_allclose(tl.numpy()[greedy], np.asarray(jl)[greedy], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tlps.numpy(), np.asarray(jlps), rtol=0, atol=1e-6)
    assert tids.shape == (B, TOPN)
    # the counts gained exactly the drawn tokens
    added = tcounts.numpy() - counts
    assert (added.sum(1) == 1).all() and (added[np.arange(B), tt.numpy()] == 1).all()


def test_slot_noise_depends_on_seed_and_step_only():
    seeds = torch.tensor([7, 7, 8, 123456789], dtype=torch.int64)
    steps = torch.tensor([3, 4, 3, 0], dtype=torch.int64)
    u = slot_uniforms(seeds, steps, 4096)
    assert ((u > 0) & (u < 1)).all()
    # the same (seed, step) in another batch gives the same row
    u2 = slot_uniforms(torch.tensor([8, 7]), torch.tensor([3, 3]), 4096)
    assert torch.equal(u2[0], u[2]) and torch.equal(u2[1], u[0])
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert abs(float(u.mean()) - 0.5) < 0.01 and abs(float(u.var()) - 1 / 12) < 0.005


def test_sampled_draws_follow_the_masked_distribution():
    """Over many steps, one slot's draws follow softmax(logits / T) restricted
    to the top-k / top-p set; tokens outside it are never drawn."""
    rng = np.random.default_rng(3)
    V, n = 16, 20000
    logits = rng.normal(0, 1.5, V).astype(np.float32)
    temp, top_k, top_p = 0.8, 8, 0.9
    scaled = logits / temp
    order = np.argsort(-scaled)
    keep = order[:top_k]
    p = np.exp(scaled[keep] - scaled[keep].max())
    p /= p.sum()
    cum = np.cumsum(p)
    keep = keep[(cum - p) <= top_p]
    probs = np.zeros(V)
    probs[keep] = np.exp(scaled[keep] - scaled[keep].max())
    probs /= probs.sum()
    toks, _, _, _ = sample_batch(
        torch.from_numpy(np.tile(logits, (n, 1))), torch.full((n,), 5), torch.arange(n),
        torch.full((n,), temp), torch.full((n,), top_p), torch.full((n,), top_k, dtype=torch.int32),
        torch.ones(n), torch.zeros((n, V), dtype=torch.int32))
    emp = np.bincount(toks.numpy(), minlength=V) / n
    assert emp[probs == 0].sum() == 0
    assert 0.5 * np.abs(emp - probs).sum() < 0.02


@pytest.mark.parametrize("length", [2, 40, 300, 700, 1500])
def test_lookup_draft_matches_jax(length):
    rng = np.random.default_rng(length)
    for trial in range(6):
        vocab = (4, 16, 64, 500)[trial % 4]
        ctx = rng.integers(0, vocab, length).tolist()
        if trial == 5 and length > 10:
            ctx = ctx[: length // 2] + ctx[: length - length // 2]  # a long repeat
        for k in (1, 4):
            assert _lookup_draft(ctx, k) == j_lookup_draft(ctx, k), (length, trial, k)
    assert _lookup_draft([5], 4) == j_lookup_draft([5], 4) == []
