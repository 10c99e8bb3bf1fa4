"""The port's Generator against the JAX Generator on the `tiny` preset (f32,
W4 Hadamard RTN weights shared through params_from_jax)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.serve.generator import Generator as JGenerator
from paroquant_tpu.serve.sampling import SamplingParams as JSamplingParams
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.serve import Generator, SamplingParams

CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]


@functools.lru_cache(maxsize=None)
def _models():
    params = jd.init_params(JCFG, jax.random.PRNGKey(3), dtype=jnp.float32)
    qp = jd.merge_projections(j_rtn(params, JCFG, hadamard=True, quantize_lm_head=True), JCFG)
    return qp, params_from_jax(jax.tree.map(np.asarray, qp), CFG, device="cpu")


def _port_gen():
    _, tp = _models()
    return Generator(tp, CFG, max_len=256, quant_mode="xla", cache_dtype=torch.float32,
                     device="cpu")


def test_greedy_matches_jax_generator():
    jp, _ = _models()
    jgen = JGenerator(jp, JCFG, max_len=256, quant_mode="xla", cache_dtype=jnp.float32)
    tgen = _port_gen()
    rng = np.random.default_rng(5)
    for n in (3, 17, 40):
        prompt = rng.integers(0, CFG.vocab_size, size=n).tolist()
        jt = jgen.generate(prompt, JSamplingParams(max_tokens=12, temperature=0.0)).token_ids
        tt = tgen.generate(prompt, SamplingParams(max_tokens=12, temperature=0.0)).token_ids
        assert tt == jt, (n, tt, jt)


def test_sampling_reproducible_and_top_k_one_is_greedy():
    gen = _port_gen()
    prompt = list(range(1, 20))
    sp = SamplingParams(max_tokens=10, temperature=0.8, top_p=0.9, top_k=50)
    runs = [gen.generate(prompt, sp, torch.Generator().manual_seed(7)).token_ids for _ in range(2)]
    assert runs[0] == runs[1]
    other = gen.generate(prompt, sp, torch.Generator().manual_seed(8)).token_ids
    greedy = gen.generate(prompt, SamplingParams(max_tokens=10, temperature=0.0)).token_ids
    top1 = gen.generate(prompt, SamplingParams(max_tokens=10, temperature=0.8, top_k=1)).token_ids
    assert top1 == greedy
    assert len(other) == 10


def test_repetition_penalty_and_stop_tokens():
    gen = _port_gen()
    prompt = list(range(1, 12))
    greedy = gen.generate(prompt, SamplingParams(max_tokens=6, temperature=0.0)).token_ids
    stopped = gen.generate(
        prompt, SamplingParams(max_tokens=6, temperature=0.0, stop_token_ids=(greedy[2],))
    ).token_ids
    assert stopped == greedy[: greedy.index(greedy[2]) + 1]
    pen = gen.generate(prompt, SamplingParams(max_tokens=6, temperature=0.0,
                                              repetition_penalty=1.3)).token_ids
    assert len(pen) == 6
