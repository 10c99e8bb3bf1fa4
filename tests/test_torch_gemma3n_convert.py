"""gemma3n's conversion paths in the port against the JAX package, on the
CPU: RTN (codes bit for bit, the tail's unused k/v quantized as JAX's, the
AltUp / LAuReL / per-layer linears dense, a W4 lm_head from the tied
table), merged projections, the PARO-TPU and AWQ directories (bytes, and
each side loading the other's), GPTQ's refusal (JAX's own) and
`cli/evaluate.py::perplexity`, each from the same JAX weights
(calibration: tests/test_torch_gemma3n_calibrate.py); and the CLIs on a
gemma3n model: `cli.optimize` (calibration and its checkpoint),
`cli.convert` into both formats and `cli.evaluate` on each directory.

Tolerances: logits of one model in the two packages within 2e-4 of max
|logit| (tests/test_torch_gemma3n.py); perplexity within 1e-5 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.cli import evaluate as jeval
from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert import gptq as jgptq
from paroquant_tpu.convert import rtn as jrtn
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.cli import evaluate as teval
from paroquant_tpu_torch.convert import checkpoint as tck
from paroquant_tpu_torch.convert import gptq as tgptq
from paroquant_tpu_torch.convert import rtn as trtn
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS, from_hf_dict, merge_projections
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops.qlinear import MergedQuantizedLinear, QuantizedLinear

TOL = 2e-4
j_forward = jax.jit(jd.model_forward, static_argnames=("config", "quant_mode", "attn_mode"))
j_init = jax.jit(jd.init_params, static_argnames=("config", "dtype"))


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max() / np.abs(j).max())


def _models(jcfg, cfg, seed):
    jp = j_init(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    jp["layers"] = [dict(lp, altup=dict(lp["altup"], correct_output_scale=jnp.asarray(
        rng.normal(1.0, 0.1, cfg.hidden_size).astype(np.float32)))) for lp in jp["layers"]]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tiny(seed):
    jcfg, cfg = J_PRESETS["tiny-gemma3n"], PRESETS["tiny-gemma3n"]
    return (jcfg, cfg, *_models(jcfg, cfg, seed))


def _tokens(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(np.int32)


def test_rtn_bit_for_bit_and_merged():
    """Hadamard RTN with a W4 lm_head from the tied table: each quantized
    linear's leaves JAX's (the tail's unused k/v too), the AltUp, LAuReL and
    per-layer linears dense; the merged model (QKV merged before the tail
    only) gives the unmerged one's logits, and JAX's."""
    jcfg, cfg, jp, tp = _tiny(1)
    jq_dev = jrtn.quantize_model_rtn(jp, jcfg, hadamard=True, quantize_lm_head=True)
    jq = jax.tree.map(np.asarray, jq_dev)
    tq = trtn.quantize_model_rtn(tp, cfg, hadamard=True, quantize_lm_head=True, device="cpu")
    ref = params_from_jax(jq, cfg, "cpu")
    pairs = [(tq["lm_head"], ref["lm_head"])]
    for lp, rp in zip(tq["layers"], ref["layers"]):
        pairs += [(lp[n], rp[n]) for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
        pairs += [(lp["mlp"][n], rp["mlp"][n]) for n in ("gate_proj", "up_proj", "down_proj")]
        for dense in (lp["altup"]["modality_router"], lp["laurel"]["linear_left"],
                      lp["per_layer_input_gate"], lp["per_layer_projection"]):
            assert isinstance(dense, td.DenseLinear)
    assert isinstance(tq["layers"][5]["k_proj"], QuantizedLinear)
    for a, b in pairs:
        assert isinstance(a, QuantizedLinear)
        for leaf in ("qweight", "scales", "zeros", "rot"):
            assert torch.equal(getattr(a, leaf), getattr(b, leaf)), leaf
    assert all(isinstance(p, td.DenseLinear) for p in tq["altup_projections"])
    assert torch.equal(tq["embed_tokens"], tp["embed_tokens"])
    toks = _tokens(20, 2, cfg.vocab_size)
    tl, _ = td.model_forward(tq, cfg, torch.from_numpy(toks))
    jl, _ = j_forward(jq_dev, jcfg, jnp.asarray(toks))
    assert _rel(tl, jl) < TOL
    merged = merge_projections(tq, cfg)
    for li, lp in enumerate(merged["layers"]):
        tail = cfg.kv_share_source(li) is not None
        assert ("qkv_proj" in lp) != tail and isinstance(lp["mlp"]["gate_up_proj"],
                                                         MergedQuantizedLinear)
        assert tail == ("q_proj" in lp)
    ml, _ = td.model_forward(merged, cfg, torch.from_numpy(toks))
    assert _rel(ml, tl.numpy()) < 1e-5


@pytest.fixture(scope="module")
def directories(tmp_path_factory):
    """The port's and JAX's PARO-TPU and AWQ directories of the same weights
    and Hadamard RTN exports (`rtn_export_model`: q/k/v/o and the MLP)."""
    jcfg, cfg, jp, tp = _tiny(3)
    exports = trtn.rtn_export_model(tp, cfg, hadamard=True)
    jexports = jrtn.rtn_export_model(jp, jcfg, hadamard=True)
    assert [sorted(e) for e in exports] == [sorted(e) for e in jexports]
    for te, je in zip(exports, jexports):
        for name in te:
            for k in ("q", "scales", "zeros", "pairs", "theta"):
                np.testing.assert_array_equal(te[name][k], np.asarray(je[name][k]))
    root = tmp_path_factory.mktemp("gemma3n_ckpt")
    dirs = {}
    for fmt in ("paro", "awq"):
        for side, save in (("port", getattr(tck, f"save_{fmt}_checkpoint")),
                           ("jax", getattr(jck, f"save_{fmt}_checkpoint"))):
            d = root / f"{side}_{fmt}"
            save(d, tp if side == "port" else jp, cfg if side == "port" else jcfg, exports)
            dirs[side, fmt] = d
    return jcfg, cfg, dirs


@pytest.mark.parametrize("fmt", ["paro", "awq"])
def test_directory_bytes_and_cross_loading(directories, fmt):
    jcfg, cfg, dirs = directories
    for f in ("model.safetensors", "config.json"):
        assert (dirs["port", fmt] / f).read_bytes() == (dirs["jax", fmt] / f).read_bytes(), f
    hf = json.loads((dirs["port", fmt] / "config.json").read_text())
    assert hf["num_kv_shared_layers"] == 2 and hf["altup_num_inputs"] == 4
    tensors = tck.read_safetensors(dirs["port", fmt] / "model.safetensors")
    assert tensors["model.layers.0.altup.correct_output_scale"].dtype == torch.float32
    assert tensors["model.embed_tokens_per_layer.weight"].dtype == torch.float16
    toks = _tokens(24, 4, cfg.vocab_size)
    jp2, jcfg2 = jck.load_checkpoint(dirs["port", fmt], dtype=jnp.float32)
    jl, _ = j_forward(jp2, jcfg2, jnp.asarray(toks))
    tp2, cfg2 = tck.load_checkpoint(dirs["jax", fmt], dtype=torch.float32, device="cpu")
    assert cfg2 == from_hf_dict(hf) and cfg2.is_gemma3n and cfg2.first_kv_shared_layer == 4
    assert isinstance(tp2["layers"][5]["k_proj"], QuantizedLinear)
    assert isinstance(tp2["layers"][0]["laurel"]["linear_left"], td.DenseLinear)
    assert len(tp2["altup_unembed_projections"]) == 3
    tl, _ = td.model_forward(tp2, cfg2, torch.from_numpy(toks))
    assert _rel(tl, jl) < TOL


def test_gptq_refuses_as_jax():
    jcfg, cfg, jp, tp = _tiny(4)
    tokens = np.zeros((2, 16), np.int32)
    with pytest.raises(NotImplementedError, match="GPTQ baseline does not support gemma3n"):
        jgptq.gptq_quantize_model(jp, jcfg, tokens, batch_size=2)
    with pytest.raises(NotImplementedError, match="GPTQ baseline does not support gemma3n"):
        tgptq.gptq_quantize_model(tp, cfg, tokens, batch_size=2, device="cpu")


def test_perplexity_matches_jax():
    jcfg, cfg, jp, tp = _tiny(6)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, 3 * 32).astype(np.int32)
    jppl = jeval.perplexity(jp, jcfg, tokens, 32, "xla", batch=2)
    tppl = teval.perplexity(tp, cfg, tokens, 32, "xla", batch=2)
    assert abs(tppl - jppl) <= 1e-5 * jppl


def test_clis_run_on_gemma3n(tmp_path, capsys):
    """cli.optimize calibrates tiny-gemma3n (the tail's k/v skipped: 38
    linears of 6 x 7), cli.convert writes both formats from its results,
    and cli.evaluate reads each directory to a finite perplexity within 1%
    of the calibrated model's own."""
    from paroquant_tpu_torch.cli import convert as tconvert, optimize as toptimize

    out = tmp_path / "opt"
    toptimize.main(["--model", "preset:tiny-gemma3n", "--output", str(out), "--datasets",
                    "synthetic", "--train-size", "4", "--seqlen", "16", "--group-size", "64",
                    "--epochs", "1", "1", "--save-checkpoint", "--device", "cpu"])
    assert len(list(out.glob("*.npz"))) == 38
    assert not list(out.glob("5.k_proj.npz")) and list(out.glob("5.q_proj.npz"))
    ppl = []
    for d, fmt in ((out / "model", None), (tmp_path / "paro", "paro-tpu"), (tmp_path / "awq", "awq")):
        if fmt is not None:
            tconvert.main(["--model", "preset:tiny-gemma3n", "--results", str(out), "--output",
                           str(d), "--format", fmt, "--device", "cpu"])
        capsys.readouterr()
        teval.main(["--model", str(d), "--synthetic", "--seqlen", "32", "--num-tokens", "128",
                    "--device", "cpu"])
        ppl.append(float(capsys.readouterr().out.split("synthetic ppl:")[1].split()[0]))
    assert all(np.isfinite(ppl)) and max(ppl) <= 1.01 * min(ppl), ppl
