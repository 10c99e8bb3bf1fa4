"""The port's flash_attention (K3; its plain version on the CPU) against the
JAX flash_attention in Pallas interpret mode, in f32 at the tolerance of
tests/test_attention_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels.attention import flash_attention as j_flash
from paroquant_tpu_torch.kernels.attention import flash_attention as t_flash

B, HQ, HKV, D = 2, 4, 2, 64  # GQA grp = 2

CASES = {
    "causal": dict(T=128, S=128),
    "q_offset_per_row": dict(T=64, S=256, q_offset=(64, 192), kv_lens=(128, 256)),
    "kv_lens_short": dict(T=128, S=128, kv_lens=(100, 57)),
    "window": dict(T=128, S=128, sliding_window=48),
    "softcap": dict(T=128, S=128, logit_softcap=20.0),
    "not_causal": dict(T=64, S=128, causal=False, kv_lens=(128, 90)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_plain_matches_pallas(case):
    c = dict(CASES[case])
    T, S = c.pop("T"), c.pop("S")
    kv_lens = np.asarray(c.pop("kv_lens", (S, S)), np.int32)
    q_offset = np.asarray(c.pop("q_offset", (0, 0)), np.int32)
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = rng.normal(size=(B, HQ, T, D)).astype(np.float32)
    k = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    scale = D**-0.5
    yj = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_lens),
                 scale=scale, q_offset=jnp.asarray(q_offset), block_q=64, block_k=64,
                 interpret=True, **c)
    yt = t_flash(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(kv_lens), scale=scale, q_offset=torch.from_numpy(q_offset), **c)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=3e-5, atol=3e-5)
