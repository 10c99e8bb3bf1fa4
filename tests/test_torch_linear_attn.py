"""The gated delta-net functions (`models/linear_attn.py`) of the port against
the JAX package's, one by one, on the CPU, from the same seeded numpy
inputs: `_split_qkvz_ba`, `_l2norm`, `_gated_norm`, `_conv_mix` (from zero,
after a previous window, with a padded bucket's valid length as a Python
int and as a tensor), `_chunk_delta_rule` (T 64 and 128, from a zero and a
random state), `_recurrent_delta_rule`, and `delta_net_forward` (prefill,
decode, a padded bucket's states, its taps), f32 within 1e-5 of max |y|;
and K3's f32-query instance over bf16 k/v: its plain version against the
Pallas kernel in interpret mode on the same inputs.

The chunked rule's inputs here are l2-normed keys with moderate decays;
the solve's backends (LAPACK's trsm under XLA, torch's) round apart, which
stays well inside 1e-5 at these inputs (tests/test_torch_qwen3_next.py
states what the whole model's random decays do to it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels.attention import flash_attention as j_flash
from paroquant_tpu.models import from_hf_dict as j_from_hf_dict
from paroquant_tpu.models import init_params as j_init_params
from paroquant_tpu.models import linear_attn as jla
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.kernels.attention import flash_attention_plain
from paroquant_tpu_torch.models import from_hf_dict
from paroquant_tpu_torch.models import linear_attn as tla

TOL = 1e-5
j_init = jax.jit(j_init_params, static_argnames=("config", "dtype"))  # one compilation, not eager
HYBRID = dict(model_type="qwen3_next", vocab_size=64, hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, full_attention_interval=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.25,
              linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=16,
              linear_value_head_dim=16, linear_conv_kernel_dim=4, tie_word_embeddings=True)


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max() / max(np.abs(j).max(), 1e-30))


def _both(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(np.array(a))) for a in arrays]


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = j_from_hf_dict(HYBRID), from_hf_dict(HYBRID)
    jp = j_init(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp["layers"][0]["linear_attn"], tp["layers"][0]["linear_attn"]


def test_split_norms(layer):
    jcfg, cfg, _, _ = layer
    rng = np.random.default_rng(0)
    qkvz = rng.standard_normal((2, 5, 2 * 2 * 16 + 2 * 4 * 16)).astype(np.float32)
    ba = rng.standard_normal((2, 5, 8)).astype(np.float32)
    (jq, tq), (jb, tb) = _both(qkvz, ba)
    for j, t in zip(jla._split_qkvz_ba(jcfg, jq, jb), tla._split_qkvz_ba(cfg, tq, tb)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    x, z, w = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 4, 16), (2, 5, 4, 16), (16,)))
    (jx, tx), (jz, tz), (jw, tw) = _both(x, z, w)
    assert _rel(tla._gated_norm(tx, tz, tw, 1e-6), jla._gated_norm(jx, jz, jw, 1e-6)) < TOL
    assert _rel(tla._l2norm(tx), jla._l2norm(jx)) < TOL
    # the gated norm keeps its input's dtype (an f32 core stays f32)
    assert tla._gated_norm(tx.bfloat16(), tz, tw, 1e-6).dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["from_zero", "prev_window", "valid_len_int", "valid_len_tensor",
                                  "valid_len_past_end"])
def test_conv_mix(layer, case):
    jcfg, cfg, jp, tp = layer
    rng = np.random.default_rng(1)
    T, C = 9, cfg.linear_conv_dim
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    prev = rng.standard_normal((2, C, 3)).astype(np.float32) if case == "prev_window" else None
    vl = {"valid_len_int": 6, "valid_len_tensor": 6, "valid_len_past_end": 20}.get(case)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jm, jw = jla._conv_mix(jcfg, jx, jp["conv_w"], None if prev is None else jnp.asarray(prev),
                           None if vl is None else jnp.asarray(vl, jnp.int32))
    t_vl = torch.tensor(vl) if case == "valid_len_tensor" else vl
    tm, tw = tla._conv_mix(cfg, tx, tp["conv_w"], None if prev is None else torch.from_numpy(prev),
                           t_vl)
    assert _rel(tm, jm) < TOL
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))  # the window is a copy of inputs


def _delta_inputs(B, H, T, d, seed):
    rng = np.random.default_rng(seed)

    def unit(*s):
        a = rng.standard_normal(s).astype(np.float32)
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    q, k = unit(B, H, T, d) * d ** -0.5, unit(B, H, T, d)
    v = rng.standard_normal((B, H, T, d)).astype(np.float32)
    g = (-np.abs(rng.standard_normal((B, H, T))) * 0.3).astype(np.float32)
    beta = rng.uniform(0.0, 1.0, (B, H, T)).astype(np.float32)
    return q, k, v, g, beta


@pytest.mark.parametrize("state", ["zero", "random"])
@pytest.mark.parametrize("T", [64, 128])
def test_chunk_delta_rule(T, state):
    B, H, d = 2, 4, 16
    arrays = _delta_inputs(B, H, T, d, T)
    s0 = np.zeros((B, H, d, d), np.float32)
    if state == "random":
        s0 = np.random.default_rng(9).standard_normal((B, H, d, d)).astype(np.float32) * 0.5
    pairs = _both(*arrays, s0)
    jo, js = jla._chunk_delta_rule(*(j for j, _ in pairs))
    to, ts = tla._chunk_delta_rule(*(t for _, t in pairs))
    assert _rel(to, jo) < TOL and _rel(ts, js) < TOL


def test_recurrent_delta_rule():
    B, H, d = 2, 4, 16
    q, k, v, g, beta = (a[:, :, 0] for a in _delta_inputs(B, H, 1, d, 3))
    s0 = np.random.default_rng(4).standard_normal((B, H, d, d)).astype(np.float32)
    pairs = _both(q, k, v, g, beta, s0)
    jo, js = jla._recurrent_delta_rule(*(j for j, _ in pairs))
    to, ts = tla._recurrent_delta_rule(*(t for _, t in pairs))
    assert _rel(to, jo) < TOL and _rel(ts, js) < TOL


@pytest.mark.parametrize("mode", ["prefill", "decode", "padded_bucket", "taps"])
def test_delta_net_forward(layer, mode):
    jcfg, cfg, jp, tp = layer
    rng = np.random.default_rng(5)
    T = 1 if mode == "decode" else 70  # 70: across the 64-token chunk boundary
    x = rng.standard_normal((2, T, cfg.hidden_size)).astype(np.float32)
    conv = rec = None
    if mode == "decode":
        conv = rng.standard_normal((2, cfg.linear_conv_dim, 3)).astype(np.float32)
        rec = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 0.3
    vl = 37 if mode == "padded_bucket" else None
    j_out = jla.delta_net_forward(
        jp, jnp.asarray(x), jcfg, None if conv is None else jnp.asarray(conv),
        None if rec is None else jnp.asarray(rec), "xla",
        valid_len=None if vl is None else jnp.asarray(vl, jnp.int32), return_taps=mode == "taps")
    t_out = tla.delta_net_forward(
        tp, torch.from_numpy(x), cfg, None if conv is None else torch.from_numpy(conv),
        None if rec is None else torch.from_numpy(rec), "xla", valid_len=vl,
        return_taps=mode == "taps")
    for j, t in zip(j_out[:3], t_out[:3]):
        assert _rel(t, j) < TOL
    if mode == "taps":
        assert _rel(t_out[3]["la_out"], j_out[3]["la_out"]) < TOL
    if mode == "padded_bucket":
        # the padded bucket's states are the unpadded prompt's
        _, conv_u, rec_u = tla.delta_net_forward(tp, torch.from_numpy(x[:, :vl]), cfg, None, None,
                                                 "xla")
        np.testing.assert_array_equal(t_out[1].numpy(), conv_u.numpy())
        assert _rel(t_out[2], rec_u.numpy()) < TOL


def test_bf16_input_gives_f32():
    """As JAX's: a bf16 layer input leaves the delta net in f32 (the f32
    recurrence's core through the gated norm and out_proj)."""
    jcfg, cfg = j_from_hf_dict(HYBRID), from_hf_dict(HYBRID)
    jp = j_init(jcfg, jax.random.PRNGKey(6), dtype=jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    la_j, la_t = jp["layers"][0]["linear_attn"], tp["layers"][0]["linear_attn"]
    x = np.random.default_rng(7).standard_normal((1, 20, 64)).astype(np.float32)
    jy, _, _ = jla.delta_net_forward(la_j, jnp.asarray(x, jnp.bfloat16), jcfg, None, None, "xla")
    ty, _, _ = tla.delta_net_forward(la_t, torch.from_numpy(x).bfloat16(), cfg, None, None, "xla")
    assert jy.dtype == jnp.float32 and ty.dtype == torch.float32
    assert _rel(ty, jy) < 3e-2


@pytest.mark.parametrize("q_offset", [0, 128])
def test_flash_f32_query_over_bf16_kv(q_offset):
    """K3's mixed instance: f32 q over bf16 k/v, f32 out, every product in
    f32 (the Pallas body casts each block to f32); its plain version
    against the Pallas kernel in interpret mode on the same inputs."""
    rng = np.random.default_rng(8 + q_offset)
    B, Hq, Hkv, T, D = 1, 4, 2, 128, 32
    S = q_offset + T
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lens = np.full((B,), S, np.int32)
    jo = j_flash(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                 jnp.asarray(lens), scale=D ** -0.5, q_offset=q_offset, block_q=128, block_k=128,
                 interpret=True)
    to = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                               torch.from_numpy(v).bfloat16(), torch.from_numpy(lens),
                               scale=D ** -0.5, q_offset=q_offset)
    assert jo.dtype == jnp.float32 and to.dtype == torch.float32
    assert _rel(to, jo) < TOL
