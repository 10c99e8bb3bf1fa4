"""The port's five bench scripts whose modules it already had (bench_a8_accuracy,
bench_kv_quant, bench_7b, bench_decode_accounting, bench_serving) on the CPU,
at small sizes, against the JAX scripts and the JAX package's functions:
their printed keys or lines (read from the JAX sources with `ast`, without
running them), their model builds, and what each arm computes."""

import ast
import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.serve import paged as jpaged
from paroquant_tpu.serve.engine import Engine as JEngine
from paroquant_tpu.serve.sampling import SamplingParams as JSP
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.experiments.baselines.quality_ladder import inject_outlier_channels
from paroquant_tpu_torch.kernels.attention import dequant_pages, paged_decode_attention_plain
from paroquant_tpu_torch.models import PRESETS, model_forward
from paroquant_tpu_torch.models import KVCache
from paroquant_tpu_torch.models.decoder import merge_projections, prefill
from paroquant_tpu_torch.scripts import (bench_7b, bench_a8_accuracy, bench_decode_accounting,
                                         bench_kv_quant, bench_serving)

ROOT = Path(__file__).resolve().parent.parent
CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]
# llama-2-7b narrowed for bench_7b's build: JAX's k/v projections are Hq * D
# wide whatever Hkv is, so Hkv = Hq as in the preset
NARROW = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
              num_key_value_heads=4, head_dim=64, num_hidden_layers=2, vocab_size=512)


@pytest.fixture(scope="module")
def js(tmp_path_factory):
    """The JAX scripts as modules (their compilation-cache directory in tmp)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PAROQUANT_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    mods = {}
    for name, path in (("bench_7b", "scripts"), ("bench_decode_accounting", "scripts"),
                       ("quality_ladder", "experiments/baselines")):
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                      ROOT / path / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mp.undo()
    return mods


def _json_keys(script: str) -> list[str]:
    """The keys of the largest dict literal with a "metric" key in a JAX script."""
    best = []
    for node in ast.walk(ast.parse((ROOT / "scripts" / script).read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys and len(keys) > len(best):
                best = keys
    assert best, script
    return best


def _printed_fstrings(script: str) -> list[list[str]]:
    """The literal pieces of each f-string a JAX script prints, in order."""
    out = []
    for node in ast.walk(ast.parse((ROOT / "scripts" / script).read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
                and node.args and isinstance(node.args[0], ast.JoinedStr)):
            out.append([v.value for v in node.args[0].values if isinstance(v, ast.Constant)])
    return out


def _has_line(lines: list[str], pieces: list[str]) -> bool:
    pattern = ".*".join(re.escape(p) for p in pieces)
    return any(re.match(pattern, ln) for ln in lines)


# ---------------------------------------------------------------------------
# bench_a8_accuracy and inject_outlier_channels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dense(dtype_name):
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    return jd.init_params(JCFG, jax.random.PRNGKey(0), dtype=jdt)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_inject_outlier_channels_bit_for_bit(js, dtype_name):
    j_inject = js["quality_ladder"].inject_outlier_channels
    dense = _dense(dtype_name)
    want = params_from_jax(jax.tree.map(np.asarray, j_inject(dense, JCFG, 8.0)), CFG, "cpu")
    got = inject_outlier_channels(params_from_jax(jax.tree.map(np.asarray, dense), CFG, "cpu"),
                                  CFG, 8.0)
    before = params_from_jax(jax.tree.map(np.asarray, dense), CFG, "cpu")
    for lw, lg, lb in zip(want["layers"], got["layers"], before["layers"]):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            assert torch.equal(lg[name].w, lw[name].w), name
            assert not torch.equal(lg[name].w, lb[name].w)
        for name in ("gate_proj", "up_proj", "down_proj"):
            assert torch.equal(lg["mlp"][name].w, lw["mlp"][name].w), name
    rows = (got["layers"][0]["q_proj"].w != before["layers"][0]["q_proj"].w).any(dim=1)
    assert int(rows.sum()) == max(1, int(CFG.hidden_size * 0.01))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_inject_outlier_channels_refuses_moe(js, dtype_name):
    """MoE layers used to be refused; the port now scales them as JAX does:
    one channel set per expert projection (axis 1 of [E, In, Out]), shared
    by every expert, and a shared expert's linears, bit for bit JAX's."""
    jcfg = dataclasses.replace(J_PRESETS["tiny-moe"], shared_expert_intermediate_size=256)
    cfg = dataclasses.replace(PRESETS["tiny-moe"], shared_expert_intermediate_size=256)
    dense = jd.init_params(jcfg, jax.random.PRNGKey(4), dtype=getattr(jnp, dtype_name))
    want = params_from_jax(jax.tree.map(np.asarray, js["quality_ladder"].inject_outlier_channels(
        dense, jcfg, 8.0)), cfg, "cpu")
    before = params_from_jax(jax.tree.map(np.asarray, dense), cfg, "cpu")
    got = inject_outlier_channels(before, cfg, 8.0)
    for lw, lg, lb in zip(want["layers"], got["layers"], before["layers"]):
        for name in ("gate_proj", "up_proj", "down_proj"):
            w, g, b = (lp["mlp"]["experts"][name] for lp in (lw, lg, lb))
            assert torch.equal(g, w), name
            moved = (g != b).any(dim=2)  # [E, In]: the same input channels in every expert
            assert moved.any() and torch.equal(moved, moved[:1].expand_as(moved)), name
            assert torch.equal(lg["mlp"]["shared_expert"][name].w,
                               lw["mlp"]["shared_expert"][name].w)
        assert torch.equal(lg["mlp"]["router"].w, lb["mlp"]["router"].w)


def test_bench_a8_accuracy_matches_jax(js):
    """The port's row on JAX's outlier-injected weights against the same numbers
    computed with JAX's model_forward: MSEs within 1e-4 relative, top-1
    agreements within one token."""
    j_inject = js["quality_ladder"].inject_outlier_channels
    params = j_inject(_dense("float32"), JCFG, 8.0)
    qparams = j_rtn(params, JCFG, n_bits=4, group_size=128)
    toks = np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, 24))
    logits = {name: np.asarray(jd.model_forward(p, JCFG, jnp.asarray(toks, jnp.int32), None,
                                                 quant_mode=mode)[0], np.float64)
              for name, p, mode in (("dense", params, "xla"), ("w4", qparams, "xla"),
                                    ("a8", qparams, "w4a8_xla"))}
    port = functools.partial(params_from_jax, config=CFG, device="cpu")
    row = bench_a8_accuracy.measure(
        port(jax.tree.map(np.asarray, params)), port(jax.tree.map(np.asarray, qparams)), CFG,
        torch.from_numpy(toks).to(torch.int32), preset="tiny", outlier_scale=8.0)
    assert list(row) == _json_keys("bench_a8_accuracy.py")
    assert row["tokens"] == toks.size

    def mse(a, b):
        return float(np.mean((logits[a] - logits[b]) ** 2))

    def top1(a, b):
        return float(np.mean(logits[a].argmax(-1) == logits[b].argmax(-1)))

    for key, want in (("mse_w4a16_vs_dense", mse("w4", "dense")),
                      ("mse_w4a8_vs_dense", mse("a8", "dense"))):
        assert abs(row[key] - want) <= 1e-4 * want, key
    assert abs(row["mse_ratio_a8_over_a16"] - mse("a8", "dense") / mse("w4", "dense")) <= (
        2e-4 * row["mse_ratio_a8_over_a16"])
    # W4A8 against W4A16 is the effect of the int8 roundings alone: where the
    # two packages' f32 rotations differ by an ulp, a rotated activation on a
    # half-integer of its scale rounds apart (RA8's a8_tolerance), which moves
    # this small MSE past 1e-4. Held instead by the triangle inequality on the
    # logits' RMS: |rms(a8 - w4) - rms(a8' - w4')| <= rms(a8 - a8') + rms(w4 - w4')
    tp = port(jax.tree.map(np.asarray, qparams))
    ours = {mode: model_forward(tp, CFG, torch.from_numpy(toks).to(torch.int32), None,
                                quant_mode=mode)[0].double().numpy()
            for mode in ("xla", "w4a8_xla")}
    slack = (np.sqrt(np.mean((ours["w4a8_xla"] - logits["a8"]) ** 2))
             + np.sqrt(np.mean((ours["xla"] - logits["w4"]) ** 2)))
    assert abs(np.sqrt(row["mse_w4a8_vs_w4a16"]) - np.sqrt(mse("a8", "w4"))) <= slack * (1 + 1e-6)
    for key, want in (("top1_w4a16_vs_dense", top1("w4", "dense")),
                      ("top1_w4a8_vs_dense", top1("a8", "dense")),
                      ("top1_w4a8_vs_w4a16", top1("a8", "w4"))):
        assert abs(row[key] - want) <= 1 / toks.size + 1e-12, key
    assert row["mse_w4a8_vs_w4a16"] > 0


def test_bench_a8_accuracy_main_prints_the_jax_keys(capsys):
    row = bench_a8_accuracy.main(["--preset", "tiny", "--n-seq", "1", "--seqlen", "16",
                                  "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(printed) == list(row) == _json_keys("bench_a8_accuracy.py")
    assert printed["mse_w4a16_vs_dense"] == round(row["mse_w4a16_vs_dense"], 5)
    args = bench_a8_accuracy.parse_args([])
    assert (args.preset, args.n_seq, args.seqlen, args.device) == ("qwen3-0.6b", 4, 512, "cuda")


# ---------------------------------------------------------------------------
# bench_kv_quant
# ---------------------------------------------------------------------------


def test_bench_kv_quant_pools_match_jax():
    p = bench_kv_quant.pools(512, "cpu")
    rng = np.random.default_rng(0)
    kf = jnp.asarray(rng.normal(size=(4, 128, 8, 128)), jnp.bfloat16)
    kq, ks = jpaged.kv_quantize(kf)
    assert np.array_equal(p["kf"].view(torch.int16).numpy(), np.asarray(kf).view(np.int16))
    assert np.array_equal(p["kq"].numpy(), np.asarray(kq))
    assert np.array_equal(p["ks"].numpy(), np.asarray(jnp.swapaxes(ks, -1, -2)))
    assert p["ks"].shape == (4, 8, 128) and p["table"].tolist() == [[0, 1, 2, 3]]


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_bench_kv_quant_arms_match_the_plain_version(pool):
    """Each arm's chain of 3 against paged_decode_attention_plain on the
    dequantized pool (the bf16 pool as it is)."""
    p = bench_kv_quant.pools(512, "cpu")
    if pool == "bf16":
        arm = bench_kv_quant.chain(3, p["kf"], p["vf"], p["table"], p["lens"])
        k, v = p["kf"], p["vf"]
    else:
        arm = bench_kv_quant.chain(3, p["kq"], p["vq"], p["table"], p["lens"], p["ks"], p["vs"])
        k, v = dequant_pages(p["kq"], p["ks"]), dequant_pages(p["vq"], p["vs"])
    q = p["q"]
    for _ in range(3):
        q = paged_decode_attention_plain(q, k, v, p["table"], p["lens"],
                                         scale=bench_kv_quant.SCALE).to(q.dtype)
    got = arm(p["q"])
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 128)
    np.testing.assert_allclose(got.float().numpy(), q.float().numpy(), rtol=0,
                               atol=1e-2 * float(q.float().abs().max()))


def test_bench_kv_quant_prints_the_jax_lines(capsys):
    rows = bench_kv_quant.main("cpu", S=256, n_iters=2, reps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    jax_lines = _printed_fstrings("bench_kv_quant.py")
    assert len(lines) == len(jax_lines) == 4
    assert all(_has_line(lines, pieces) for pieces in jax_lines)
    assert "3.35 TB/s" in lines[0] and "834" not in "".join(lines)
    assert [r["pool"] for r in rows] == ["bf16", "int8"]
    assert rows[0]["bytes"] == 2 * 256 * 8 * 128 * 2 and rows[1]["bytes"] == 2 * 256 * 8 * 132


# ---------------------------------------------------------------------------
# bench_7b
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _llama_narrow(js_7b):
    jcfg = dataclasses.replace(J_PRESETS["llama-2-7b"], **NARROW)
    old = js_7b.PRESETS
    js_7b.PRESETS = {"llama-2-7b": jcfg}
    try:
        jparams, _ = js_7b.build_quantized_llama7b()
    finally:
        js_7b.PRESETS = old
    cfg = dataclasses.replace(PRESETS["llama-2-7b"], **NARROW)
    tparams, _ = bench_7b.build_quantized_llama7b(config=cfg, device="cpu")
    return jparams, jcfg, tparams, cfg


def test_build_quantized_llama7b_matches_jax(js):
    jparams, _, tparams, cfg = _llama_narrow(js["bench_7b"])
    want = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    assert torch.equal(tparams["embed_tokens"], want["embed_tokens"])
    lins = [("lm_head", tparams["lm_head"], want["lm_head"])]
    for li, (lt, lw) in enumerate(zip(tparams["layers"], want["layers"])):
        lins += [(f"{li}.{n}", lt[n], lw[n]) for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
        lins += [(f"{li}.{n}", lt["mlp"][n], lw["mlp"][n])
                 for n in ("gate_proj", "up_proj", "down_proj")]
    for name, lt, lw in lins:
        for field in ("qweight", "scales", "zeros", "rot"):
            assert torch.equal(getattr(lt, field), getattr(lw, field)), (name, field)
    assert bench_7b.tree_bytes(tparams) == sum(
        a.size * a.dtype.itemsize for a in jax.tree.leaves(jparams) if hasattr(a, "dtype"))


def _f32_activations(params, cast):
    """The same weights with the embedding and norms in f32, so that the
    activations are f32 (bf16 activations round apart where JAX's jit fuses
    ops; tests/test_torch_model.py's bf16 bound)."""
    out = dict(params, embed_tokens=cast(params["embed_tokens"]), norm=cast(params["norm"]))
    out["layers"] = [dict(lp, input_layernorm=cast(lp["input_layernorm"]),
                          post_attention_layernorm=cast(lp["post_attention_layernorm"]))
                     for lp in params["layers"]]
    return out


def test_bench_7b_tokens_match_jax(js):
    """The merged model's bf16 prefill logits within test_torch_model.py's bf16
    bound (3e-2 of max) of JAX's, and with f32 activations the same greedy
    tokens over a short chain."""
    jparams, jcfg, tparams, cfg = _llama_narrow(js["bench_7b"])
    jparams, tparams = jd.merge_projections(jparams, jcfg), merge_projections(tparams, cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, bench_7b.PROMPT_LEN))
    n = 6

    def jax_chain(params, cache_dtype):
        cache = jd.KVCache.create(jcfg, 2, bench_7b.PROMPT_LEN + n + 8, cache_dtype)
        logits, cache = jd.prefill(params, jcfg, jnp.asarray(prompt, jnp.int32), cache,
                                   quant_mode="xla")
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return logits, jd.greedy_decode_scan(params, jcfg, tok, cache, n, quant_mode="xla")[0]

    jl, _ = jax_chain(jparams, jnp.bfloat16)
    cache = KVCache.create(cfg, 2, bench_7b.PROMPT_LEN + n + 8, torch.bfloat16, "cpu")
    tl, _ = prefill(tparams, cfg, torch.from_numpy(prompt).to(torch.int32), cache,
                    quant_mode="xla")
    jl = np.asarray(jl, np.float32)
    assert np.abs(tl.numpy() - jl).max() <= 3e-2 * np.abs(jl).max()

    jp32 = _f32_activations(jparams, lambda a: a.astype(jnp.float32))
    tp32 = _f32_activations(tparams, lambda t: t.float())
    _, want = jax_chain(jp32, jnp.bfloat16)
    _, toks = bench_7b.make_run(tp32, cfg, torch.from_numpy(prompt).to(torch.int32), n, "xla")()
    assert toks.tolist() == np.asarray(want).tolist()


def test_bench_7b_prints_the_jax_lines(js, capsys):
    _, _, tparams, cfg = _llama_narrow(js["bench_7b"])
    capsys.readouterr()
    rows = bench_7b.run(merge_projections(tparams, cfg), cfg, [1, 2], 3, ["fused", "w4a8"],
                        "cpu", warmup=1, rounds=1)
    lines = capsys.readouterr().out.strip().splitlines()
    # the JAX script's transfer to its TPU has no counterpart (built on the device)
    jax_lines = [p for p in _printed_fstrings("bench_7b.py")
                 if not p[0].startswith(("transferred", "  built layer", "built W4"))]
    assert len(jax_lines) == 2 and all(_has_line(lines, p) for p in jax_lines)
    results = [ln for ln in lines if ln.startswith("llama-2-7b W4 decode")]
    assert len(results) == 4 and all("SoL at 3.35 TB/s" in ln for ln in results)
    assert [(r["batch"], r["quant_mode"]) for r in rows] == [
        (1, "fused"), (1, "w4a8"), (2, "fused"), (2, "w4a8")]
    assert all(r["tok_s"] > 0 and r["sol_tok_s"] == r["batch"] * rows[0]["sol_tok_s"]
               for r in rows)
    args = bench_7b.parse_args([])
    assert (args.batch, args.tokens, args.quant_mode, args.no_merge, args.device) == (
        [1], 128, ["fused"], False, "cuda")


# ---------------------------------------------------------------------------
# bench_decode_accounting
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _accounting_models():
    """The JAX script's narrow path at preset tiny (already that narrow), f32."""
    dense = jd.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    jq = jd.merge_projections(j_rtn(dense, JCFG, n_bits=4, group_size=128,
                                    quantize_lm_head=True), JCFG)
    return jq, params_from_jax(jax.tree.map(np.asarray, jq), CFG, "cpu")


def test_decode_accounting_identity_ablation_matches_jax(js):
    jq, tq = _accounting_models()
    B, N = 2, 4
    prompt = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, 16))
    _, toks = bench_decode_accounting.make_run(
        tq, CFG, torch.from_numpy(prompt).to(torch.int32), N,
        bench_decode_accounting.identity_attn)()
    cache = jd.KVCache.create(JCFG, B, 16 + N + 8, jnp.bfloat16)
    logits, cache = jd.prefill(jq, JCFG, jnp.asarray(prompt, jnp.int32), cache,
                               quant_mode="fused")
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want, _ = jd.greedy_decode_scan(jq, JCFG, tok, cache, N, quant_mode="fused",
                                    attn_mode=js["bench_decode_accounting"].identity_attn)
    assert toks.tolist() == np.asarray(want).tolist()
    _, full = bench_decode_accounting.make_run(
        tq, CFG, torch.from_numpy(prompt).to(torch.int32), N, "einsum")()
    assert full[:, 0].tolist() == toks[:, 0].tolist()  # the first token is the prefill's


# kernel and op names the profiler gives, each with its bucket: the card's
# (the first 160 characters) from a chip run of chip_smoke.py's accounting
# phase (NVIDIA H100 80GB HBM3, 700 W), the CPU's ops below
CARD_NAMES = {
    "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 2, 2, false, false"
    ", cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, c":
        "attention_dots",
    "void gemv2N_kernel<int, int, float, float, float, float, 128, 1, 2, 4, 1, false, cublasG"
    "emvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemv":
        "attention_dots",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::Ten"
    "sorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#4}::opera":
        "copies",
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::native::dire"
    "ct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()()":
        "copies",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::Ten"
    "sorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::opera":
        "copies",
    "Memcpy DtoH (Device -> Pageable)":
        "copies",
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long"
    ", long, long, bool)":
        "fusions_glue",
    "void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::arange_cuda_o"
    "ut(c10::Scalar const&, c10::Scalar const&, c10::Scalar const&, at::Tenso":
        "fusions_glue",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<int>, std:"
    ":array<char*, 3ul> >(int, at::native::CUDAFunctor_add<int>, std::array<c":
        "fusions_glue",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anon"
    "ymous namespace)::OpaqueType<4u>, unsigned int, 4, 128, 1, 16, 4>(char*,":
        "fusions_glue",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::"
    "(anonymous namespace)::OpaqueType<4u>, unsigned int, 2, 128, 1, 16>(at::":
        "fusions_glue",
    "void at::native::index_elementwise_kernel<128, 4, at::native::index_copy_kernel_impl<at:"
    ":native::OpaqueType<2> >(at::TensorIterator&, long, long, long)::{lambda":
        "kv_update",
    "void paro::w4::rotate_kernel<__nv_bfloat16, __nv_bfloat16, false>(__nv_bfloat16 const*, "
    "__nv_bfloat16 const*, float*, signed char*, float*, float*, int, int, in":
        "quant_matmuls",
    "void paro::w4::gemv_kernel<__nv_bfloat16, 0>(float const*, signed char const*, float con"
    "st*, float const*, unsigned char const*, void const*, void const*, __nv_":
        "quant_matmuls",
    "void paro::w4::reduce_kernel<__nv_bfloat16>(float const*, __nv_bfloat16*, int, unsigned "
    "long)":
        "quant_matmuls",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::ArgMaxOps"
    "<float>, unsigned int, long, 4, 4> >(at::native::ReduceOp<float, at::nat":
        "sampler_argmax",
}
HOST_NAMES = {
    "aten::mm": "attention_dots", "aten::bmm": "attention_dots", "aten::einsum": "attention_dots",
    "aten::index_copy_": "kv_update", "aten::argmax": "sampler_argmax",
    "aten::copy_": "copies", "aten::_to_copy": "copies", "aten::to": "copies",
    "aten::add": "fusions_glue", "aten::softmax": "fusions_glue", "aten::cat": "fusions_glue",
    "aten::empty": "other", "aten::view": "other", "aten::transpose": "other",
}


@pytest.mark.parametrize("table", ["card", "host"])
def test_bucket_of_maps_the_ports_names(table):
    names = CARD_NAMES if table == "card" else HOST_NAMES
    assert {n: bench_decode_accounting.bucket_of(n) for n in names} == names


def test_decode_accounting_line(capsys):
    _, tq = _accounting_models()
    rows = bench_decode_accounting.account(tq, CFG, 2, [3], "cpu", reps=1)
    printed = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")][-1])
    assert list(printed) == list(rows[0]) == _json_keys("bench_decode_accounting.py")
    buckets = printed["device_profile_per_step_ms"]
    assert set(buckets) <= {"quant_matmuls", "kv_update", "sampler_argmax", "attention_dots",
                            "copies", "fusions_glue", "other"}
    assert {"kv_update", "sampler_argmax", "attention_dots"} <= set(buckets)
    assert abs(sum(buckets.values()) - printed["device_busy_ms_per_step"]) < 0.01 + 1e-3 * len(buckets)
    assert np.isfinite(printed["attention_ms_ab (full - identity-attn)"])
    args = bench_decode_accounting.parse_args([])
    assert (args.batch, args.tokens, args.preset, args.device) == (32, [64, 128], "llama-2-7b",
                                                                   "cuda")


# ---------------------------------------------------------------------------
# bench_serving
# ---------------------------------------------------------------------------


def test_bench_serving_requests_match_jax_engine():
    """bench_serving at preset tiny with 4 requests on JAX's f32 W4 weights:
    every request returns max_tokens greedy tokens, each equal to the JAX
    Engine's generate_sync on the same prompt and weights."""
    dense = jd.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    jq = jd.merge_projections(j_rtn(dense, JCFG, n_bits=4, group_size=128,
                                    quantize_lm_head=True), JCFG)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), CFG, "cpu")
    args = bench_serving.parse_args(["--preset", "tiny", "--requests", "4", "--max-tokens", "6",
                                     "--max-len", "256", "--device", "cpu"])
    out, reqs = bench_serving.run(tq, CFG, args, "cpu")
    assert len(reqs) == 4 and out["rejected"] == 0 and out["decode_burst"] == 1
    keys = _json_keys("bench_serving.py")
    assert list(out)[:len(keys)] == keys
    assert set(list(out)[len(keys):]) <= {"decode_tick_wall_p50_ms", "decode_tick_wall_p99_ms",
                                          "decode_tick_samples", "decode_step_device_ms_est",
                                          "decode_dispatch_overhead_ms_est"}
    eng = JEngine(jq, JCFG, max_batch=8, max_len=256, page_size=64, quant_mode="xla",
                  prefill_chunk=256, decode_burst=1)
    for r in reqs:
        toks = []
        while not r.out_queue.empty():
            kind, tok = r.out_queue.get_nowait()
            if kind == "token":
                toks.append(tok)
        assert len(toks) == 6
        want = eng.generate_sync([int(t) for t in r.prompt_tokens], JSP(max_tokens=6,
                                                                        temperature=0.0))
        assert toks == want


def test_bench_serving_main_and_flags(capsys):
    out = bench_serving.main(["--preset", "tiny", "--layers", "1", "--requests", "3",
                              "--max-tokens", "4", "--max-len", "128", "--device", "cpu",
                              "--max-queue", "1", "--arrival-mean", "0"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert printed["requests"] == 3 and printed["max_queue"] == 1
    args = bench_serving.parse_args([])
    assert (args.preset, args.max_batch, args.max_len, args.requests, args.max_tokens,
            args.device, args.decode_burst, args.spec_k, args.arrival_mean) == (
        "qwen3-0.6b", 8, 1024, 24, 48, "cuda", None, 0, 0.03)
