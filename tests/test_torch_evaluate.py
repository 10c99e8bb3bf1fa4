"""The port's cli/evaluate.py against the JAX package's: `perplexity` on the
same params (windows, batches with a short tail, the chunked lm_head + CE,
xla and w4a8_xla), and `main` on the PARO-TPU and AWQ checkpoints that the
JAX package writes, with --synthetic and --token-file."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paroquant_tpu.cli import evaluate as jev
from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.convert.rtn import rtn_export_model
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu_torch.cli import evaluate as tev
from paroquant_tpu_torch.convert.checkpoint import load_checkpoint
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS

ROOT = Path(__file__).resolve().parent.parent
JCFG = J_PRESETS["tiny"]
CFG = PRESETS["tiny"]
TOKENS = np.random.default_rng(1).integers(0, JCFG.vocab_size, 200).astype(np.int32)
# name: (seqlen, chunk_ce, batch); 200 tokens
CASES = {
    "unchunked_b1": (32, 2048, 1),
    "unchunked_b4_tail": (32, 2048, 4),  # 6 windows: 4, then 2
    "chunked_b1": (64, 16, 1),
    "chunked_b2_tail": (64, 16, 2),  # 3 windows: 2, then 1
    "not_a_multiple": (48, 32, 1),  # longer than chunk_ce, not a multiple: unchunked
}


@pytest.fixture(scope="module")
def models():
    """Hadamard RTN W4 of the tiny preset in f32, projections merged: JAX's
    params and the same weights in the port."""
    jp = jd.merge_projections(
        j_rtn(jd.init_params(JCFG, jax.random.PRNGKey(3), dtype=jnp.float32), JCFG, hadamard=True),
        JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_perplexity_matches_jax(models, case):
    jp, tp = models
    seqlen, chunk, batch = CASES[case]
    want = jev.perplexity(jp, JCFG, TOKENS, seqlen, "xla", batch=batch, chunk_ce=chunk)
    got = tev.perplexity(tp, CFG, TOKENS, seqlen, "xla", batch=batch, chunk_ce=chunk)
    assert abs(got - want) / want < 1e-5, (got, want)


def _token_ce(logits, tok) -> np.ndarray:
    """Per-token CE [W, T-1] in f64 of f32 logits [W, T, V] for windows tok [W, T]."""
    lg = np.asarray(logits, np.float64)[:, :-1]
    lg = lg - lg.max(-1, keepdims=True)
    logp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
    return -np.take_along_axis(logp, tok[:, 1:, None].astype(np.int64), -1)[..., 0]


@pytest.mark.parametrize("case", ["unchunked_b4_tail", "chunked_b2_tail"])
def test_perplexity_w4a8_xla_matches_jax(models, case):
    """w4a8_xla rounds each rotated activation to int8 per (token, group).
    The two packages' f32 activations differ in their last bits, so a value
    at a rounding boundary lands on the next int8 step in one package only,
    and the change flows through the later layers and positions (ROADMAP §C,
    recorded): the PPLs differ by up to 1.9e-4 relative, about as much as the
    rounding itself moves the PPL (1.9e-4 to 5.5e-4), because the rounding's
    per-token changes cancel in the mean. So the rounding is pinned per
    token: over the case's windows, the median |CE| gap between the port's
    and JAX's w4a8_xla forwards must be under a quarter of the median gap
    between the port's xla forward and JAX's w4a8_xla one (here 3e-7 against
    4.9e-3 at seqlen 32 and 7.3e-4 against 5.7e-3 at seqlen 64, where a
    longer window carries a flip to more positions); the port's w4a8_xla PPL
    must be exp(mean) of its own forward's per-token CE within 1e-5, and
    within 1e-3 relative of JAX's."""
    import torch

    from paroquant_tpu_torch.models.decoder import model_forward

    jp, tp = models
    seqlen, chunk, batch = CASES[case]
    want = jev.perplexity(jp, JCFG, TOKENS, seqlen, "w4a8_xla", batch=batch, chunk_ce=chunk)
    got = tev.perplexity(tp, CFG, TOKENS, seqlen, "w4a8_xla", batch=batch, chunk_ce=chunk)
    tok = TOKENS[: (len(TOKENS) // seqlen) * seqlen].reshape(-1, seqlen)
    ce_jax = _token_ce(jd.model_forward(jp, JCFG, jnp.asarray(tok), quant_mode="w4a8_xla")[0], tok)
    ce_port, ce_a16 = (
        _token_ce(model_forward(tp, CFG, torch.from_numpy(tok), quant_mode=m)[0].numpy(), tok)
        for m in ("w4a8_xla", "xla"))
    gap, gap_a16 = np.median(abs(ce_port - ce_jax)), np.median(abs(ce_a16 - ce_jax))
    assert gap < 0.25 * gap_a16, (gap, gap_a16)
    own = float(np.exp(ce_port.mean()))
    assert abs(got - own) / own < 1e-5, (got, own)
    assert abs(got - want) / want < 1e-3, (got, want)


@pytest.mark.parametrize("mode", ["xla", "w4a8_xla"])
def test_chunked_ce_equals_full_logits(models, mode):
    """The port's chunked CE against one log-softmax over the full logits of
    the port's own forward, window by window, in f64."""
    import torch

    _, tp = models
    seqlen, n_win = 64, 3
    from paroquant_tpu_torch.models.decoder import model_forward

    total = 0.0
    for w in range(n_win):
        tok = torch.from_numpy(TOKENS[w * seqlen : (w + 1) * seqlen][None])
        logits, _ = model_forward(tp, CFG, tok, quant_mode=mode)
        logp = torch.log_softmax(logits[0, :-1].double(), -1)
        total -= float(logp.gather(-1, tok[0, 1:, None].long()).sum())
    want = float(np.exp(total / (n_win * (seqlen - 1))))
    for chunk in (16, 32, 2048):
        got = tev.perplexity(tp, CFG, TOKENS, seqlen, mode, batch=1, chunk_ce=chunk)
        assert abs(got - want) / want < 1e-5, (chunk, got, want)


@pytest.mark.parametrize("kw", ["mesh", "sp_mesh"])
def test_perplexity_refuses_meshes(models, kw):
    with pytest.raises(NotImplementedError, match="§A 7"):
        tev.perplexity(models[1], CFG, TOKENS, 32, "xla", **{kw: object()})


def test_perplexity_needs_one_window(models):
    with pytest.raises(ValueError, match="one window"):
        tev.perplexity(models[1], CFG, TOKENS[:10], 32, "xla")


def test_load_eval_tokens_refuses_unknown_names():
    for fn in (jev.load_eval_tokens, tev.load_eval_tokens):
        with pytest.raises(ValueError):
            fn("ptb", None, 16)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    params = jd.init_params(JCFG, jax.random.PRNGKey(4), dtype=jnp.float32)
    exports = rtn_export_model(params, JCFG, hadamard=True)
    out = {}
    for fmt, save in (("paro_tpu", jck.save_paro_checkpoint), ("awq", jck.save_awq_checkpoint)):
        out[fmt] = tmp_path_factory.mktemp(fmt)
        save(out[fmt], params, JCFG, exports)
    tok_file = tmp_path_factory.mktemp("tokens") / "toks.npy"
    np.save(tok_file, TOKENS[:160].astype(np.int64))
    out["token_file"] = tok_file
    return out


def _ppl_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    label, value = lines[-1].rsplit(" ", 1)
    return label, float(value), lines


@pytest.mark.parametrize("fmt", ["paro_tpu", "awq"])
@pytest.mark.parametrize("source", ["synthetic", "token_file"])
def test_main_matches_jax(checkpoints, fmt, source, capsys):
    args = ["--model", str(checkpoints[fmt]), "--seqlen", "32", "--num-tokens", "128"]
    args += ["--synthetic"] if source == "synthetic" else ["--token-file", str(checkpoints["token_file"])]
    jev.main(args + ["--device", "cpu"])
    j_label, want, _ = _ppl_line(capsys)
    tev.main(args + ["--device", "cpu"])
    t_label, got, _ = _ppl_line(capsys)
    assert t_label == j_label
    assert abs(got - want) / want < 1e-2, (got, want)  # bf16 loads on both sides


def test_main_w4a8_prints_the_note_and_runs_w4a8_xla(checkpoints, capsys):
    args = ["--model", str(checkpoints["awq"]), "--synthetic", "--seqlen", "32",
            "--num-tokens", "96", "--quant-mode", "w4a8"]
    jev.main(args + ["--device", "cpu"])
    _, _, j_lines = _ppl_line(capsys)
    tev.main(args + ["--device", "cpu"])
    _, got, t_lines = _ppl_line(capsys)
    assert t_lines[0] == j_lines[0] and t_lines[0].startswith("note: --quant-mode w4a8")
    params, cfg = load_checkpoint(checkpoints["awq"], device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, 96).astype(np.int32)
    assert got == float(f"{tev.perplexity(params, cfg, toks, 32, 'w4a8_xla'):.4f}")


@pytest.mark.parametrize("flag", ["--dp", "--sp"])
def test_main_parallel_flags_raise(checkpoints, flag):
    with pytest.raises(NotImplementedError, match="§A 7"):
        tev.main(["--model", str(checkpoints["awq"]), "--synthetic", flag, "2", "--device", "cpu"])


def test_main_without_tokenizer_exits_2(checkpoints, capsys):
    args = ["--model", str(checkpoints["paro_tpu"]), "--seqlen", "32"]
    for main in (jev.main, tev.main):
        with pytest.raises(SystemExit) as e:
            main(args + ["--device", "cpu"])
        assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1] == err[-2] == "no tokenizer in model dir; use --token-file or --synthetic"


def _flags(path: Path) -> dict:
    """option -> its default, choices, action, nargs and type (as source
    text) for each add_argument call in a source file."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                  if k.arg in ("default", "choices", "action", "nargs", "type")}
            out[node.args[0].value] = kw
    return out


def test_flags_match_jax():
    j = _flags(ROOT / "paroquant_tpu" / "cli" / "evaluate.py")
    t = _flags(ROOT / "paroquant_tpu_torch" / "cli" / "evaluate.py")
    assert list(t) == list(j)
    assert t.pop("--device") == {"default": "'cuda'", "choices": "['cuda', 'cpu']"}
    j.pop("--device")
    assert t == j
