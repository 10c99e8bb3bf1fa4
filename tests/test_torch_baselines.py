"""The port's calibration data (`optim/data.py`) and baseline drivers
(`experiments/baselines/{rtn,gptq}_baseline.py`) against JAX's, on the CPU.

The synthetic and local-file calibration blocks must be JAX's bit for bit.
Both drivers run on a dense directory that JAX wrote (the `tiny` preset in
f16) beside JAX's own scripts (loaded by path; `experiments/` is not a
package), and on `preset:tiny`. RTN writes JAX's files byte for byte
(f16 weights hold many rounding ties, so this needs JAX's compiled scale,
test_torch_convert.py). GPTQ writes the same tensor
names, dtypes and shapes; its codes are not JAX's bit for bit (the f32
Cholesky factors differ in their last bits, and each layer's quantized
output feeds the next layer's Hessian, test_torch_gptq.py), so the logits'
error against the dense model is held within 10% of JAX's directory's.
Every directory the port writes loads in JAX to the port's f32 logits
within 1e-5 of max.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from paroquant_tpu.convert import checkpoint as jck
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.optim import data as jdata
from paroquant_tpu_torch.convert import load_checkpoint
from paroquant_tpu_torch.experiments.baselines import gptq_baseline, rtn_baseline
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.optim import data as tdata
from test_torch_api import byte_tokenizer
from test_torch_evaluate import _flags

ROOT = Path(__file__).resolve().parents[1]
JCFG = J_PRESETS["tiny"]
TOKENS = np.random.default_rng(9).integers(0, JCFG.vocab_size, (2, 24)).astype(np.int32)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "experiments" / "baselines" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("name", ("rtn_baseline", "gptq_baseline"))
def test_flags_match_jax(name):
    j = _flags(ROOT / "experiments" / "baselines" / f"{name}.py")
    t = _flags(ROOT / "paroquant_tpu_torch" / "experiments" / "baselines" / f"{name}.py")
    assert t.pop("--device") == {"default": "'cuda'", "choices": "['cpu', 'cuda']"}
    assert list(t) == list(j) and t == j


def test_synthetic_draws_match_jax():
    for args in ((5, 17, 3, 1000), (1, 64, 0, 512)):
        n, seqlen, seed, vocab = args
        want = jdata.get_calib_dataset("synthetic", None, n, seqlen, seed, vocab)
        got = tdata.get_calib_dataset("synthetic", None, n, seqlen, seed, vocab)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    want = jdata.get_mixed_calib_dataset(["synthetic"] * 3, None, 10, 8, seed=2, vocab_size=500)
    got = tdata.get_mixed_calib_dataset(["synthetic"] * 3, None, 10, 8, seed=2, vocab_size=500)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="needs a tokenizer"):
        tdata.get_calib_dataset("wikitext2", None, 1, 8)


def test_file_corpora_match_jax(tmp_path):
    tok = byte_tokenizer(tmp_path / "tok")
    docs = [f"document {i}: " + "lorem ipsum " * (i % 5 + 1) for i in range(9)]
    (tmp_path / "c.txt").write_text("\n\n".join(docs))
    (tmp_path / "c.jsonl").write_text("\n".join(json.dumps({"text": d}) for d in docs) + "\n\n")
    for names, n, seqlen in ((["file:" + str(tmp_path / "c.txt")], 3, 32),
                             (["file:" + str(tmp_path / "c.jsonl")], 2, 16),
                             (["file:" + str(tmp_path / "c.txt"), "synthetic"], 5, 40),
                             (["file:" + str(tmp_path / "c.jsonl")], 40, 64)):  # repeats the stream
        want = jdata.get_mixed_calib_dataset(names, tok, n, seqlen, seed=4, vocab_size=300)
        got = tdata.get_mixed_calib_dataset(names, tok, n, seqlen, seed=4, vocab_size=300)
        np.testing.assert_array_equal(got, want)
    (tmp_path / "empty.txt").write_text("\n\n")
    with pytest.raises(ValueError, match="no documents"):
        tdata.get_calib_dataset("file:" + str(tmp_path / "empty.txt"), tok, 1, 8)
    with pytest.raises(FileNotFoundError):
        tdata.get_calib_dataset("file:" + str(tmp_path / "none.txt"), tok, 1, 8)


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    """The `tiny` preset's random f32 weights, written dense (f16) by JAX."""
    params = jd.init_params(JCFG, jax.random.PRNGKey(2), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("dense") / "tiny"
    jck.save_paro_checkpoint(path, params, JCFG, [])
    return path


def _logits_both(path):
    """(JAX's f32 logits, the port's) of one directory."""
    jp, jc = jck.load_checkpoint(path, rot_dtype=jnp.float32, dtype=jnp.float32)
    tp, tc = load_checkpoint(path, rot_dtype=torch.float32, dtype=torch.float32, device="cpu")
    return (np.asarray(jd.model_forward(jp, jc, jnp.asarray(TOKENS))[0]),
            td.model_forward(tp, tc, torch.from_numpy(TOKENS))[0].numpy())


def assert_jax_loads_port_dir(path):
    want, got = _logits_both(path)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    return got


@pytest.mark.parametrize("hadamard", (False, True))
def test_rtn_baseline_matches_jax(dense_dir, tmp_path, hadamard):
    extra = ["--hadamard"] if hadamard else []
    args = ["--model", str(dense_dir), *extra]
    j_out = _run(_jax_script("rtn_baseline").main, args + ["--output", str(tmp_path / "j")])
    t_out = _run(rtn_baseline.main, args + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    assert [ln.replace(str(tmp_path / "t"), "X") for ln in t_out] == [
        ln.replace(str(tmp_path / "j"), "X") for ln in j_out]
    got, want = load_file(str(tmp_path / "t" / "model.safetensors")), load_file(
        str(tmp_path / "j" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert (json.loads((tmp_path / "t" / "config.json").read_text())
            == json.loads((tmp_path / "j" / "config.json").read_text()))
    assert_jax_loads_port_dir(tmp_path / "t")


@pytest.mark.parametrize("hadamard", (False, True))
def test_gptq_baseline_matches_jax(dense_dir, tmp_path, hadamard):
    extra = ["--hadamard"] if hadamard else []
    args = ["--model", str(dense_dir), "--datasets", "synthetic", "--n-samples", "8",
            "--seqlen", "64", *extra]
    j_out = _run(_jax_script("gptq_baseline").main, args + ["--output", str(tmp_path / "j")])
    t_out = _run(gptq_baseline.main, args + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    assert [ln.replace(str(tmp_path / "t"), "X") for ln in t_out] == [
        ln.replace(str(tmp_path / "j"), "X") for ln in j_out]
    got, want = load_file(str(tmp_path / "t" / "model.safetensors")), load_file(
        str(tmp_path / "j" / "model.safetensors"))
    assert {k: (v.dtype, v.shape) for k, v in got.items()} == {
        k: (v.dtype, v.shape) for k, v in want.items()}
    ref = _logits_both(dense_dir)[1]
    t_err = float(np.mean((assert_jax_loads_port_dir(tmp_path / "t") - ref) ** 2))
    j_err = float(np.mean((_logits_both(tmp_path / "j")[0] - ref) ** 2))
    assert abs(t_err - j_err) <= 0.1 * j_err, (t_err, j_err)


@pytest.mark.parametrize("script", ("rtn", "gptq"))
def test_baselines_on_a_preset(tmp_path, script):
    if script == "rtn":
        lines = _run(rtn_baseline.main, ["--model", "preset:tiny", "--output", str(tmp_path / "o"),
                                         "--device", "cpu", "--hadamard"])
        assert lines == [f"Hadamard-RTN W4 checkpoint written to {tmp_path / 'o'}"]
    else:
        lines = _run(gptq_baseline.main, ["--model", "preset:tiny", "--output",
                                          str(tmp_path / "o"), "--datasets", "synthetic",
                                          "--n-samples", "4", "--seqlen", "32", "--device", "cpu"])
        assert lines[-1] == f"GPTQ W4 checkpoint written to {tmp_path / 'o'}"
        assert lines[:2] == [f"gptq layer {i}: quantized ['k_proj', 'mlp.down_proj', "
                             "'mlp.gate_proj', 'mlp.up_proj', 'o_proj', 'q_proj', 'v_proj']"
                             for i in range(2)]
    assert_jax_loads_port_dir(tmp_path / "o")
