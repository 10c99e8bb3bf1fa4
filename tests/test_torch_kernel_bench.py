"""The port's kernel benchmarks (`paroquant_tpu_torch/scripts/kernel_bench3.py`,
`kernel_bench4.py`, `experiments/plot_kernel_speedup.py`) against the JAX
scripts they port: each case, built at I = O = 256 from the same seeds in
the same order, gives the same one-step output as the JAX case (the JAX
kernels in Pallas interpret mode, the port's plain versions on the CPU).

Tolerances, relative to max |y| of the JAX output: one bf16 ulp (2**-7) for
the bf16 outputs; 2e-3 more where a bf16 rounding of a rotated activation
can flip (the rotating cases).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu.ops import butterfly as jbf
from paroquant_tpu.ops.packing import pack_w4_tpu
from paroquant_tpu_torch.experiments import plot_kernel_speedup
from paroquant_tpu_torch.scripts import kernel_bench3, kernel_bench4

M, I, O, K, GS = 1, 256, 256, 8, 128
G = I // GS
BF16_ULP = 2.0**-7
ROTATING = ("dense_rot", "butterfly", "rot_einsum", "mg ")


def _draw_common(rng):
    x = jnp.asarray(rng.normal(size=(M, I)), jnp.bfloat16)
    qweight = jnp.asarray(pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), GS))
    scales = jnp.asarray(rng.uniform(0.01, 0.05, (G, O)), jnp.bfloat16)
    return x, qweight, scales


def _jax_main():
    """scripts/kernel_bench3.py::main's cases at I = O = 256."""
    rng = np.random.default_rng(0)
    x, qweight, scales = _draw_common(rng)
    zeros = jnp.asarray(rng.integers(0, 16, (G, O)), jnp.uint8)
    inv_s = jnp.asarray(rng.uniform(0.5, 2.0, I), jnp.float32)
    theta = rng.normal(0, 0.3, (K, I // 2)).astype(np.float32)
    cos_t, sin_t = (jnp.asarray(a) for a in jbf.butterfly_tables(theta, GS))
    rot = jnp.asarray(rng.normal(size=(G, GS, GS)), jnp.bfloat16)
    rot_f32 = jnp.asarray(rng.normal(size=(G, GS, GS)), jnp.float32)
    scales_f32, zeros_f32 = scales.astype(jnp.float32), zeros.astype(jnp.float32)
    w_dense = jnp.asarray(rng.normal(size=(I, O)), jnp.bfloat16)
    steps = {
        "xla_bf16_dense": lambda xv: jnp.dot(xv, w_dense, preferred_element_type=jnp.float32),
        "w4_matmul": lambda xv: jk.w4_matmul(xv, qweight, scales, zeros, interpret=True),
        "w4_matmul (f32 s/z)": lambda xv: jk.w4_matmul(xv, qweight, scales_f32, zeros_f32,
                                                       interpret=True),
        "dense_rot_w4 (bf16)": lambda xv: jk.rot_w4_matmul(xv, rot, qweight, scales, zeros,
                                                           interpret=True),
        "dense_rot_w4 (f32)": lambda xv: jk.rot_w4_matmul(xv, rot_f32, qweight, scales_f32,
                                                          zeros_f32, interpret=True),
        "butterfly_w4 (K=8)": lambda xv: jk.butterfly_w4_matmul(
            xv, inv_s, cos_t, sin_t, qweight, scales, zeros, interpret=True),
    }
    for k_ab in (1, 2, 4):
        c2, s2 = (jnp.asarray(a) for a in jbf.butterfly_tables(theta[:k_ab], GS))
        steps[f"butterfly_w4 (K={k_ab})"] = lambda xv, c2=c2, s2=s2: jk.butterfly_w4_matmul(
            xv, inv_s, c2, s2, qweight, scales, zeros, interpret=True)
    return x, steps


def _jax_two_op():
    rng = np.random.default_rng(1)
    x, qweight, scales = _draw_common(rng)
    zeros = jnp.asarray(rng.integers(0, 16, (G, O)), jnp.uint8)
    rot = jnp.asarray(rng.normal(size=(G, GS, GS)), jnp.bfloat16)

    def two_op(xv):
        xr = jnp.einsum("gij,bgj->bgi", rot, xv.reshape(M, G, GS),
                        preferred_element_type=jnp.float32).reshape(M, I)
        return jk.w4_matmul(xr.astype(jnp.bfloat16), qweight, scales, zeros, interpret=True)

    return x, {"rot_einsum + w4": two_op,
               "fused dense_rot": lambda xv: jk.rot_w4_matmul(xv, rot, qweight, scales, zeros,
                                                              interpret=True)}


def _jax_mg_like(with_dense):
    """--mg's cases, or (with_dense) scripts/kernel_bench4.py's: the same draws."""
    rng = np.random.default_rng(1)
    x, qweight, scales = _draw_common(rng)
    zeros = jnp.asarray(rng.integers(0, 16, (G, O)).astype(np.float32), jnp.bfloat16)
    rot = jnp.asarray(rng.normal(size=(G, GS, GS)), jnp.bfloat16)
    steps = {f"mg dense_rot Gb={gb}": lambda xv, gb=gb: jk.rot_w4_matmul_mg(
        xv, rot, qweight, scales, zeros, groups_per_step=gb, interpret=True) for gb in (16, 32)}
    fused = lambda xv: jk.rot_w4_matmul(xv, rot, qweight, scales, zeros, interpret=True)
    w4 = lambda xv: jk.w4_matmul(xv, qweight, scales, zeros, interpret=True)
    if not with_dense:
        return x, {**steps, "old fused dense_rot": fused, "w4 (no rot)": w4}
    w_dense = jnp.asarray(rng.normal(size=(I, O)), jnp.bfloat16)
    dense = lambda xv: jnp.dot(xv, w_dense, preferred_element_type=jnp.float32)
    return x, {"xla_bf16_dense": dense, "w4 (no rot)": w4, "fused dense_rot": fused, **steps}


PORT = {
    "main": lambda: kernel_bench3.main_cases("cpu", M=M, I=I, O=O, K=K, GS=GS),
    "two-op": lambda: kernel_bench3.two_op_cases("cpu", M=M, I=I, O=O, GS=GS),
    "mg": lambda: kernel_bench3.mg_cases("cpu", M=M, I=I, O=O, GS=GS),
    "bench4": lambda: kernel_bench4.cases("cpu", M=M, I=I, O=O, GS=GS),
}
JAX = {"main": _jax_main, "two-op": _jax_two_op, "mg": lambda: _jax_mg_like(False),
       "bench4": lambda: _jax_mg_like(True)}


@pytest.mark.parametrize("script", list(PORT))
def test_bench_cases_match_the_jax_scripts(script):
    cases = PORT[script]()
    xj, steps = JAX[script]()
    assert [c.label for c in cases] == list(steps)
    np.testing.assert_array_equal(cases[0].x.float().numpy(), np.asarray(xj, np.float32))
    for case in cases:
        yt = case.step(case.x).float().numpy()
        yj = np.asarray(steps[case.label](xj), np.float32)
        rel = BF16_ULP + (2e-3 if any(k in case.label for k in ROTATING) else 0.0)
        np.testing.assert_allclose(yt, yj, rtol=0, atol=rel * np.abs(yj).max(), err_msg=case.label)


@pytest.mark.parametrize("mode", ["main", "two-op", "mg"])
def test_kernel_bench3_rows_on_the_cpu(mode, capsys):
    rows = kernel_bench3.main("cpu", mode, reps=1, M=M, I=I, O=O, GS=GS)
    assert [r["label"] for r in rows] == [c.label for c in PORT[mode]()]
    for r in rows:  # the host clock gives no device rate
        assert r["us"] > 0 and r["gbps"] is None and r["hbm_share"] is None
        assert r["device"] == "cpu (host clock)"
    assert "host clock" in capsys.readouterr().out


def test_kernel_bench4_rows_on_the_cpu():
    rows = kernel_bench4.main("cpu", reps=1, M=M, I=I, O=O, GS=GS)
    assert [r["label"] for r in rows] == [c.label for c in PORT["bench4"]()]
    assert rows[0]["bytes"] == I * O * 2


def test_plot_kernel_speedup_writes_its_json(tmp_path):
    payload = plot_kernel_speedup.main("cpu", out=tmp_path, sizes=[256, 512], O=128, reps=1)
    written = json.loads((tmp_path / "kernel_speedup.json").read_text())
    assert written == payload
    assert set(written["speedups"]) == {"256", "512"}
    assert written["reference_gpu_speedups"] == {"4096": 1.36, "8192": 2.06, "16384": 3.3,
                                                 "32768": 5.18}
    assert written["clock"].startswith("host")


def test_bench_tensor_rounds_like_jax():
    a = np.random.default_rng(3).normal(size=(4096,))
    from paroquant_tpu_torch.scripts.bench_common import tensor

    np.testing.assert_array_equal(tensor(a, torch.bfloat16, "cpu").float().numpy(),
                                  np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32))
