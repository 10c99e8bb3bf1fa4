"""A callable attn_mode: the port's decoder layer calls an injected attention
as JAX's does (q [B, T, Hq, D], head-major k/v [B, Hkv, S, D], the query
positions, the valid kv length, scale=, sliding_window=, logit_softcap=).

Both packages get the `tiny` preset's f32 weights (seed 0) through
params_from_jax and the same impl: the identity (returns q), and each
side's own `attention_kvmajor` passed through. Logits are held within 1e-5
of max |logit| of JAX's, the greedy tokens must be identical, and the
identity must move the logits away from "einsum"'s."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td

CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]
TOL = 1e-5  # max abs difference over max |logit|, f32 (tests/test_torch_model.py)
T_PROMPT = 6
N_DECODE = 5
MAX_LEN = 16


@functools.lru_cache(maxsize=None)
def _models():
    params = jd.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, params_from_jax(jax.tree.map(np.asarray, params), CFG, device="cpu")


def _tokens():
    return np.random.default_rng(3).integers(0, CFG.vocab_size, (2, T_PROMPT)).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


class Recorder:
    """An attention impl that records each call's arguments, then runs
    `inner` (None: the identity)."""

    def __init__(self, inner=None):
        self.inner = inner
        self.calls = []

    def __call__(self, q, k, v, q_positions, valid, **kw):
        traced = isinstance(valid, jax.core.Tracer)  # under JAX's jit: shapes only
        self.calls.append({"q": tuple(q.shape), "k": tuple(k.shape), "v": tuple(v.shape),
                           "q_positions": None if traced else np.asarray(q_positions).tolist(),
                           "valid": None if traced else int(np.asarray(valid)),
                           "kw": sorted(kw)})
        return q if self.inner is None else self.inner(q, k, v, q_positions, valid, **kw)


def _shapes(calls):
    return [{k: c[k] for k in ("q", "k", "v", "kw")} for c in calls]


IMPLS = {"identity": (None, None), "kvmajor": (jd.attention_kvmajor, td.attention_kvmajor)}


def _pair(impl):
    j_inner, t_inner = IMPLS[impl]
    return Recorder(j_inner), Recorder(t_inner)


def _forward(attn_j, attn_t, cached):
    jp, tp = _models()
    toks = _tokens()
    jc = jd.KVCache.create(JCFG, 2, MAX_LEN, jnp.float32) if cached else None
    tc = td.KVCache.create(CFG, 2, MAX_LEN, torch.float32, device="cpu") if cached else None
    jl, _ = jd.model_forward(jp, JCFG, jnp.asarray(toks), jc, attn_mode=attn_j)
    tl, _ = td.model_forward(tp, CFG, torch.from_numpy(toks), tc, attn_mode=attn_t)
    return np.asarray(jl), tl.numpy()


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("impl", list(IMPLS))
def test_model_forward_calls_the_impl_as_jax_does(impl, cached):
    rj, rt = _pair(impl)
    jl, tl = _forward(rj, rt, cached)
    assert len(rt.calls) == len(rj.calls) == CFG.num_hidden_layers
    assert rt.calls == rj.calls
    S = MAX_LEN if cached else T_PROMPT
    assert rt.calls[0]["k"] == (2, CFG.num_key_value_heads, S, CFG.head_dim)
    assert rt.calls[0]["q"] == (2, T_PROMPT, CFG.num_attention_heads, CFG.head_dim)
    assert rt.calls[0]["kw"] == ["logit_softcap", "scale", "sliding_window"]
    assert _rel(tl, jl) < TOL


@pytest.mark.parametrize("impl", list(IMPLS))
def test_prefill_and_greedy_decode_scan_with_an_impl(impl):
    jp, tp = _models()
    toks = _tokens()
    rj, rt = _pair(impl)
    jc = jd.KVCache.create(JCFG, 2, MAX_LEN, jnp.float32)
    tc = td.KVCache.create(CFG, 2, MAX_LEN, torch.float32, device="cpu")
    jl, jc = jd.prefill(jp, JCFG, jnp.asarray(toks), jc, attn_mode=rj)
    tl, tc = td.prefill(tp, CFG, torch.from_numpy(toks), tc, attn_mode=rt)
    assert _rel(tl.numpy(), jl) < TOL
    assert len(rt.calls) == len(rj.calls) == CFG.num_hidden_layers
    assert _shapes(rt.calls) == _shapes(rj.calls)
    assert all(c["valid"] == T_PROMPT and c["q_positions"] == [list(range(T_PROMPT))] * 2
               for c in rt.calls)
    first = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    assert np.asarray(first).tolist() == torch.argmax(tl, dim=-1).tolist()
    rj2, rt2 = _pair(impl)
    jt, jc = jd.greedy_decode_scan(jp, JCFG, first, jc, N_DECODE, attn_mode=rj2)
    tt, tc = td.greedy_decode_scan(tp, CFG, torch.from_numpy(np.array(first)), tc, N_DECODE,
                                   attn_mode=rt2)
    assert tt.tolist() == np.asarray(jt).tolist()
    # JAX traces the scan's body once; the port's loop calls the impl each step
    assert len(rj2.calls) == CFG.num_hidden_layers
    assert len(rt2.calls) == N_DECODE * CFG.num_hidden_layers
    assert _shapes(rt2.calls[:CFG.num_hidden_layers]) == _shapes(rj2.calls)
    assert [c["valid"] for c in rt2.calls[::CFG.num_hidden_layers]] == list(
        range(T_PROMPT + 1, T_PROMPT + N_DECODE + 1))
    for jk, tk in zip(jc.k, tc.k):
        assert _rel(tk.numpy(), jk) < TOL


def test_identity_moves_the_logits_and_strings_keep_einsum():
    ident_j, ident_t = _forward(Recorder(), Recorder(), cached=True)
    ein_j, ein_t = _forward("einsum", "einsum", cached=True)
    other_j, other_t = _forward("some_mode", "some_mode", cached=True)
    assert np.array_equal(other_t, ein_t) and _rel(ein_t, ein_j) < TOL
    assert _rel(other_j, ein_j) == 0.0
    # the identity ablates attention: far past the f32 parity bound
    assert float(np.max(np.abs(ident_t - ein_t))) > 0.1
    assert float(np.max(np.abs(ident_j - ein_j))) > 0.1
