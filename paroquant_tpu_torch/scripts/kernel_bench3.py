"""W4 kernel timings on the card: the port of `scripts/kernel_bench3.py`.

    python -m paroquant_tpu_torch.scripts.kernel_bench3            # every W4 kernel beside a bf16 matmul
    python -m paroquant_tpu_torch.scripts.kernel_bench3 --two-op   # einsum rotation + w4_matmul vs fused
    python -m paroquant_tpu_torch.scripts.kernel_bench3 --mg       # rot_w4_matmul_mg vs rot_w4_matmul, w4_matmul

The JAX script's cases, labels, shapes and seeds: M = 1, I = O = 4096, group
128, K = 8 butterfly stages, `np.random.default_rng(0)` (the default mode)
or `(1)` (the other two) drawn in the same order, then moved to torch. Its
`xla_bf16_dense` arm is `torch.matmul` on the bf16 dense weight, a
yardstick that the script defines. Timing and rows: `bench_common.py`.
`main(device="cpu")` runs the plain versions on the host clock, for the
logic only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import rot_matmul as rm
from ..ops import butterfly as bf
from ..ops.packing import pack_w4_tpu
from ..utils.device import resolve_device
from .bench_common import Case, tensor, time_cases

BF16, F32, U8 = torch.bfloat16, torch.float32, torch.uint8


def main_cases(device, M=1, I=4096, O=4096, K=8, GS=128) -> list[Case]:
    """The default mode: a bf16 dense matmul, w4_matmul (bf16/uint8 and f32
    scales/zeros), rot_w4_matmul (bf16 and f32), butterfly_w4_matmul at
    K = 8, 1, 2, 4."""
    G = I // GS
    rng = np.random.default_rng(0)
    x = tensor(rng.normal(size=(M, I)), BF16, device)
    qweight = pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), GS).to(device)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), BF16, device)
    zeros = tensor(rng.integers(0, 16, (G, O)), U8, device)
    inv_s = tensor(rng.uniform(0.5, 2.0, I), F32, device)
    theta = rng.normal(0, 0.3, (K, I // 2)).astype(np.float32)
    cos_t, sin_t = (tensor(a, F32, device) for a in bf.butterfly_tables(theta, GS))
    rot = tensor(rng.normal(size=(G, GS, GS)), BF16, device)
    rot_f32 = tensor(rng.normal(size=(G, GS, GS)), F32, device)
    scales_f32, zeros_f32 = scales.to(F32), zeros.to(F32)
    w_dense = tensor(rng.normal(size=(I, O)), BF16, device)

    w4_bytes = I * O // 2 + G * O * 3
    w4_bytes_f32 = I * O // 2 + 2 * G * O * 4
    cases = [
        Case("xla_bf16_dense", lambda xv: torch.matmul(xv, w_dense), x, I * O * 2),
        Case("w4_matmul", lambda xv: rm.w4_matmul(xv, qweight, scales, zeros), x, w4_bytes),
        Case("w4_matmul (f32 s/z)", lambda xv: rm.w4_matmul(xv, qweight, scales_f32, zeros_f32),
             x, w4_bytes_f32),
        Case("dense_rot_w4 (bf16)", lambda xv: rm.rot_w4_matmul(xv, rot, qweight, scales, zeros),
             x, w4_bytes + G * GS * GS * 2),
        Case("dense_rot_w4 (f32)",
             lambda xv: rm.rot_w4_matmul(xv, rot_f32, qweight, scales_f32, zeros_f32),
             x, w4_bytes_f32 + G * GS * GS * 4),
        Case("butterfly_w4 (K=8)",
             lambda xv: rm.butterfly_w4_matmul(xv, inv_s, cos_t, sin_t, qweight, scales, zeros),
             x, w4_bytes + 2 * K * I * 4),
    ]
    # fewer stages, to isolate the stages' cost
    for k_ab in (1, 2, 4):
        c2, s2 = (tensor(a, F32, device) for a in bf.butterfly_tables(theta[:k_ab], GS))
        cases.append(Case(
            f"butterfly_w4 (K={k_ab})",
            lambda xv, c2=c2, s2=s2: rm.butterfly_w4_matmul(xv, inv_s, c2, s2, qweight, scales,
                                                            zeros),
            x, w4_bytes))
    return cases


def two_op_cases(device, M=1, I=4096, O=4096, GS=128) -> list[Case]:
    """--two-op: the rotation as one block-diagonal einsum, then w4_matmul,
    against the fused rot_w4_matmul."""
    G = I // GS
    rng = np.random.default_rng(1)
    x = tensor(rng.normal(size=(M, I)), BF16, device)
    qweight = pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), GS).to(device)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), BF16, device)
    zeros = tensor(rng.integers(0, 16, (G, O)), U8, device)
    rot = tensor(rng.normal(size=(G, GS, GS)), BF16, device)
    w4_bytes = I * O // 2 + G * O * 3 + G * GS * GS * 2

    def two_op(xv):
        xg = xv.reshape(M, G, GS).to(F32)
        xr = torch.einsum("gij,bgj->bgi", rot.to(F32), xg).reshape(M, I)
        return rm.w4_matmul(xr.to(BF16), qweight, scales, zeros)

    return [
        Case("rot_einsum + w4", two_op, x, w4_bytes),
        Case("fused dense_rot", lambda xv: rm.rot_w4_matmul(xv, rot, qweight, scales, zeros),
             x, w4_bytes),
    ]


def mg_cases(device, M=1, I=4096, O=4096, GS=128) -> list[Case]:
    """--mg: rot_w4_matmul_mg at 16 and 32 groups per step against
    rot_w4_matmul and w4_matmul, bf16 scales and zeros."""
    G = I // GS
    rng = np.random.default_rng(1)
    x = tensor(rng.normal(size=(M, I)), BF16, device)
    qweight = pack_w4_tpu(rng.integers(0, 16, size=(I, O), dtype=np.int32), GS).to(device)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), BF16, device)
    zeros = tensor(rng.integers(0, 16, (G, O)).astype(np.float32), BF16, device)
    rot = tensor(rng.normal(size=(G, GS, GS)), BF16, device)
    nbytes = I * O // 2 + G * O * 4 + G * GS * GS * 2
    cases = [
        Case(f"mg dense_rot Gb={gb}",
             lambda xv, gb=gb: rm.rot_w4_matmul_mg(xv, rot, qweight, scales, zeros,
                                                   groups_per_step=gb), x, nbytes)
        for gb in (16, 32)
    ]
    return cases + [
        Case("old fused dense_rot", lambda xv: rm.rot_w4_matmul(xv, rot, qweight, scales, zeros),
             x, nbytes),
        Case("w4 (no rot)", lambda xv: rm.w4_matmul(xv, qweight, scales, zeros), x,
             I * O // 2 + G * O * 4),
    ]


MODES = {"main": main_cases, "two-op": two_op_cases, "mg": mg_cases}


def main(device="cuda", mode: str = "main", *, reps: int = 30, **shape) -> list[dict]:
    """Time the cases of `mode` ("main", "two-op" or "mg"); returns their rows.
    `shape` (M, I, O, GS, and K for "main") shrinks them for a check."""
    dev = resolve_device(device)
    return time_cases(MODES[mode](dev, **shape), dev, reps)


if __name__ == "__main__":
    main(mode="two-op" if "--two-op" in sys.argv else "mg" if "--mg" in sys.argv else "main")
