"""The port's calibration CLIs (`paroquant_tpu_torch/cli/optimize.py`,
`cli/convert.py`) against JAX's, on the CPU.

Both packages start from one dense directory that JAX writes into tmp_path
(JAX's `tiny` preset, f32 weights stored f16): a preset would give each
package its own random init. Stage 1 runs at LR 5e-3 (at the recipe's 5e-2
calibration is chaotic: tests/test_torch_calibrate_train.py).

Tolerances. The results: tests/test_torch_calibrate.py's (theta and the
inverse channel scales within 2e-3, codes equal in at least 99.5%, never
more than 1 apart). The checkpoints' logits: within 2% of max |logits|.
cli.convert from the same results: every file byte for byte equal to
JAX's, in real paro-tpu, real awq and pseudo mode.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.cli import convert as j_convert_cli
from paroquant_tpu.cli import optimize as j_optimize_cli
from paroquant_tpu.cli.convert import load_results as j_load_results
from paroquant_tpu.convert import load_checkpoint as j_load_checkpoint
from paroquant_tpu.convert import save_paro_checkpoint as j_save_paro
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import init_params as j_init_params
from paroquant_tpu.models import model_forward as j_model_forward
from paroquant_tpu_torch.cli import convert as convert_cli
from paroquant_tpu_torch.cli import optimize as optimize_cli
from paroquant_tpu_torch.cli.convert import load_results
from paroquant_tpu_torch.convert import load_checkpoint
from paroquant_tpu_torch.models import model_forward
from test_torch_calibrate import _exports_close, _logits_close

ARGS = ["--datasets", "synthetic", "--train-size", "8", "--batch-size", "2", "--seqlen", "16",
        "--group-size", "64", "--num-rotations", "4", "--epochs", "2", "1",
        "--params", "channel_scales:0.005,angles:0.005", "weight:1e-5,quantizer:1e-6",
        "--save-checkpoint", "--device", "cpu"]
TOKENS = np.random.default_rng(4).integers(0, 512, (1, 12)).astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    dense = root / "dense"
    cfg = J_PRESETS["tiny"]
    j_save_paro(dense, j_init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32), cfg, [])
    j_optimize_cli.main(["--model", str(dense), "--output", str(root / "jax")] + ARGS)
    optimize_cli.main(["--model", str(dense), "--output", str(root / "port"), "--wandb", "p"]
                      + ARGS)
    return root


def test_optimize_cli_results_match_jax(runs):
    assert _exports_close(j_load_results(runs / "jax"), load_results(runs / "port"))
    args = json.loads((runs / "port" / "args.json").read_text())
    assert args["device"] == "cpu" and args["epochs"] == [2, 1]


def test_optimize_cli_checkpoint_matches_jax(runs):
    jp, jc = j_load_checkpoint(runs / "jax" / "model", dtype=jnp.float32)
    tp, tc = load_checkpoint(runs / "port" / "model", rot_dtype=torch.float32,
                             dtype=torch.float32, device="cpu")
    want = np.asarray(j_model_forward(jp, jc, jnp.asarray(TOKENS))[0])
    with torch.no_grad():
        got = model_forward(tp, tc, torch.from_numpy(TOKENS))[0].numpy()
    assert _logits_close(want, got)
    assert json.loads((runs / "port" / "model" / "config.json").read_text())[
        "quantization_config"]["format"] == "paro-tpu"


@pytest.mark.parametrize("mode", ["real-paro-tpu", "real-awq", "pseudo"])
def test_convert_cli_byte_for_byte(runs, tmp_path, mode):
    """From the same results (JAX's), both CLIs write the same files."""
    m, fmt = ("pseudo", "paro-tpu") if mode == "pseudo" else mode.split("-", 1)
    common = ["--model", str(runs / "dense"), "--results", str(runs / "jax"), "--mode", m,
              "--format", fmt]
    j_convert_cli.main(common + ["--output", str(tmp_path / "jax"), "--device", "cpu"])
    convert_cli.main(common + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


def test_optimize_cli_wandb_missing(runs, capsys):
    optimize_cli.main(["--model", str(runs / "dense"), "--output", str(runs / "port"),
                       "--resume", "--wandb", "p"] + ARGS)
    assert "wandb not installed; continuing without metric logging" in capsys.readouterr().out


def test_optimize_cli_refuses_dp(tmp_path):
    with pytest.raises(NotImplementedError, match="§A 7"):
        optimize_cli.main(["--model", "preset:tiny", "--output", str(tmp_path), "--dp", "2",
                           "--device", "cpu"])
