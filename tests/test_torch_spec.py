"""The port's speculative sampling math and the rest of its Generator (decode
bursts, greedy and sampled prompt-lookup speculation) against the JAX
package on the CPU: `tiny` preset, f32, W4 Hadamard RTN weights shared
through params_from_jax."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.serve import sampling as js
from paroquant_tpu.serve.generator import Generator as JGenerator
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.serve import Generator, SamplingParams, detect_backend
from paroquant_tpu_torch.serve import sampling as ts

CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]
REPEATED = [7, 3, 9, 4] * 5


# ---------------------------------------------------------------------------
# modified_probs, spec_accept_sample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.3, 1.0, 1.7])
def test_modified_probs_matches_jax(temperature, top_p, top_k):
    logits = np.random.default_rng(3).normal(0, 2, (2, 3, 40)).astype(np.float32)
    want = np.asarray(js.modified_probs(jnp.asarray(logits), temperature=temperature,
                                        top_p=top_p, top_k=top_k))
    got = ts.modified_probs(torch.from_numpy(logits), temperature=temperature, top_p=top_p,
                            top_k=top_k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


V, K = 16, 4
TARGETS = [5, 9, 2, 11, 13]  # the one-hot target of each window row (W = K + 1)


def _one_hot_logits():
    logits = np.full((K + 1, V), -1e4, np.float32)
    logits[np.arange(K + 1), TARGETS] = 3.0
    return logits


# (drafts, d_len, n_accepted): every position's token is determined, so the
# whole layout is compared (after a rejection the drafts miss their targets,
# and padding drafts (0) miss theirs)
ONE_HOT_CASES = {
    "all_accept": ([5, 9, 2, 11], 4, 4),
    "reject_third": ([5, 9, 3, 1], 4, 2),
    "reject_first": ([6, 1, 1, 1], 4, 0),
    "padding_after_two": ([5, 9, 0, 0], 2, 2),
    "no_drafts": ([0, 0, 0, 0], 0, 0),
    "reject_then_padding": ([5, 1, 0, 0], 2, 1),
}


@pytest.mark.parametrize("case", sorted(ONE_HOT_CASES))
def test_spec_accept_sample_one_hot_matches_jax(case):
    drafts, d_len, n_acc = ONE_HOT_CASES[case]
    logits = _one_hot_logits()
    jt, jn, jl = js.spec_accept_sample(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32), jnp.asarray(d_len, jnp.int32),
        jax.random.PRNGKey(0), temperature=0.7, top_p=0.9, top_k=4)
    tt, tn, tl = ts.spec_accept_sample(
        torch.from_numpy(logits), torch.tensor(drafts), d_len, torch.Generator().manual_seed(0),
        temperature=0.7, top_p=0.9, top_k=4)
    assert int(tn) == int(jn) == n_acc
    assert tt.dtype == torch.int32 and tn.dtype == torch.int32
    assert tt.tolist() == np.asarray(jt).tolist()
    emitted = tt.tolist()[: n_acc + 1]
    assert emitted == drafts[:n_acc] + [TARGETS[n_acc]]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("draft0", ["mode", "rare"])
def test_spec_accept_sample_first_token_follows_modified_probs(draft0):
    """The first emitted token's law is modified_probs[0], whether the draft
    is the mode (mostly accepted) or a rare token (mostly rejected): a
    chi-square test over 6000 draws, cells under 5 expected merged."""
    rng = np.random.default_rng(41)
    temp, top_p, top_k = 0.8, 0.9, 8
    logits = torch.from_numpy(rng.normal(0, 2, (K + 1, 16)).astype(np.float32))
    p0 = ts.modified_probs(logits, temperature=temp, top_p=top_p, top_k=top_k)[0].numpy()
    support = np.flatnonzero(p0 > 0)
    d0 = int(np.argmax(p0)) if draft0 == "mode" else int(support[np.argmin(p0[support])])
    draft = torch.tensor([d0, 1, 2, 3])
    gen = torch.Generator().manual_seed(1234)
    n = 6000
    counts = np.zeros(16)
    accepted = 0
    for _ in range(n):
        toks, n_acc, _ = ts.spec_accept_sample(logits, draft, 1, gen, temperature=temp,
                                               top_p=top_p, top_k=top_k)
        counts[int(toks[0])] += 1
        accepted += int(n_acc)
    assert counts[p0 == 0].sum() == 0
    expected = p0 * n
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    obs, exp = obs[exp > 0], exp[exp > 0]
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < stats.chi2.ppf(0.999, len(obs) - 1), (chi2, obs, exp)
    assert abs(accepted / n - p0[d0]) < 4 * np.sqrt(p0[d0] * (1 - p0[d0]) / n) + 1e-3


# ---------------------------------------------------------------------------
# The Generator
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models():
    params = jd.init_params(JCFG, jax.random.PRNGKey(3), dtype=jnp.float32)
    qp = jd.merge_projections(j_rtn(params, JCFG, hadamard=True, quantize_lm_head=True), JCFG)
    return qp, params_from_jax(jax.tree.map(np.asarray, qp), CFG, device="cpu")


def _gen(**kw):
    kw.setdefault("max_len", 128)
    return Generator(_models()[1], CFG, quant_mode="xla", cache_dtype=torch.float32,
                     device="cpu", **kw)


def _jgen(**kw):
    kw.setdefault("max_len", 128)
    return JGenerator(_models()[0], JCFG, quant_mode="xla", cache_dtype=jnp.float32, **kw)


BURST_CASES = {
    "greedy": SamplingParams(max_tokens=10, temperature=0.0),
    "sampled": SamplingParams(max_tokens=10, temperature=0.9, top_p=0.8, top_k=16, seed=3),
    "penalty": SamplingParams(max_tokens=10, temperature=0.7, repetition_penalty=1.4, seed=3),
}


@pytest.mark.parametrize("case", sorted(BURST_CASES))
def test_burst_matches_single_step(case):
    """decode_burst=4 streams the per-step loop's tokens: the same draws of
    the generator and the same counts update, in the same order; 10 tokens
    are two full bursts and a tail of two single steps."""
    sp = BURST_CASES[case]
    prompt = np.random.default_rng(23).integers(0, CFG.vocab_size, 7).tolist()
    ref = list(_gen().stream_generate(prompt, sp))
    got = list(_gen(decode_burst=4).stream_generate(prompt, sp))
    assert got == ref and len(got) == sp.max_tokens


def test_burst_stops_at_a_stop_token():
    prompt = list(range(1, 12))
    greedy = list(_gen().stream_generate(prompt, SamplingParams(max_tokens=9, temperature=0.0)))
    sp = SamplingParams(max_tokens=9, temperature=0.0, stop_token_ids=(greedy[5],))
    got = list(_gen(decode_burst=4).stream_generate(prompt, sp))
    assert got == greedy[: greedy.index(greedy[5]) + 1]


@pytest.mark.parametrize("k", [2, 4])
def test_greedy_speculation_matches_sequential_and_jax(k):
    """Greedy speculation at k emits the sequential greedy tokens (k = 0), and
    the JAX speculative Generator's tokens with the same window counts."""
    sp = SamplingParams(max_tokens=24, temperature=0.0)
    ref = list(_gen().stream_generate(REPEATED, sp))
    gen = _gen(lookup_spec_k=k)
    got = list(gen.stream_generate(REPEATED, sp))
    jgen = _jgen(lookup_spec_k=k)
    jgot = list(jgen.stream_generate(REPEATED, js.SamplingParams(max_tokens=24, temperature=0.0)))
    assert got == ref == jgot
    assert gen.spec_metrics == jgen.spec_metrics
    assert gen.spec_metrics["accepted"] > 0 and gen.spec_metrics["windows"] > 0


def test_speculation_gate_refuses_penalty_and_missing_slack():
    """A repetition penalty, or a max_len without the k rows of slack the last
    window writes, takes the normal path (no window), with its tokens."""
    sp_pen = SamplingParams(max_tokens=10, temperature=0.0, repetition_penalty=1.4)
    spec = _gen(lookup_spec_k=4)
    assert (list(spec.stream_generate(REPEATED, sp_pen))
            == list(_gen().stream_generate(REPEATED, sp_pen)))
    assert spec.spec_metrics["windows"] == 0
    sp_full = SamplingParams(max_tokens=44, temperature=0.0)  # 20 + 44 fills max_len 64
    tight = _gen(max_len=64, lookup_spec_k=4)
    assert (list(tight.stream_generate(REPEATED, sp_full))
            == list(_gen(max_len=64).stream_generate(REPEATED, sp_full)))
    assert tight.spec_metrics["windows"] == 0
    roomy = _gen(max_len=68, lookup_spec_k=4)  # exactly the slack
    assert (list(roomy.stream_generate(REPEATED, sp_full))
            == list(_gen(max_len=68).stream_generate(REPEATED, sp_full)))
    assert roomy.spec_metrics["windows"] > 0


def test_speculation_cache_holds_the_slack():
    gen = _gen(max_len=4096, lookup_spec_k=4)
    assert gen._cache_len(20, 108, 4) == 256 and gen._cache_len(20, 104, 0) == 128


def test_sampled_speculation_runs_reproducibly():
    """Sampled speculation returns max_tokens tokens in range, the same ones
    for one generator seed, with drafts accepted on a repetitive prompt."""
    sp = SamplingParams(max_tokens=14, temperature=0.7, top_p=0.95, seed=11)

    def run(seed):
        g = _gen(lookup_spec_k=4)
        return list(g.stream_generate(REPEATED, sp, torch.Generator().manual_seed(seed))), \
            g.spec_metrics

    toks1, m1 = run(5)
    toks2, m2 = run(5)
    assert toks1 == toks2 and m1 == m2
    assert len(toks1) == sp.max_tokens and all(0 <= t < CFG.vocab_size for t in toks1)
    assert m1["windows"] > 0 and m1["drafted"] > 0


def test_pixel_values_and_backend():
    # a model with no vision tower refuses images with JAX's ValueError
    with pytest.raises(ValueError, match="no vision tower"):
        next(_gen().stream_generate([1, 2, 3], SamplingParams(max_tokens=2), None,
                                    np.zeros((1, 3, 8, 8), np.float32)))
    assert detect_backend() == ("cuda" if torch.cuda.is_available() else "cpu")


class _Tokenizer:
    eos_token_id = None

    def __init__(self, thinking: bool):
        self.thinking = thinking

    def apply_chat_template(self, messages, add_generation_prompt, **kw):
        if kw and not self.thinking:
            raise TypeError("no enable_thinking")
        return [len(messages), int(add_generation_prompt), int(kw.get("enable_thinking", -1))]


def test_build_prompt():
    msgs = [{"role": "user", "content": "hi"}]
    with pytest.raises(RuntimeError, match="no tokenizer"):
        _gen().build_prompt(msgs)
    gen = Generator(_models()[1], CFG, _Tokenizer(True), device="cpu")
    assert gen.build_prompt(msgs, enable_thinking=False) == [1, 1, 0]
    gen = Generator(_models()[1], CFG, _Tokenizer(False), device="cpu")
    assert gen.build_prompt(msgs) == [1, 1, -1]
