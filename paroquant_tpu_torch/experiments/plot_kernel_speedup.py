"""Kernel speedup sweep: rot_w4_matmul_mg against a bf16 dense matmul.

    python -m paroquant_tpu_torch.experiments.plot_kernel_speedup [--out DIR]

The port of `experiments/plots/plot_kernel_speedup.py`, the repo's version
of the paper's kernel-speedup figure: the same sweep (M = 1, O = 4096, group
128, I in 4096..32768, `np.random.default_rng(0)` drawn in the same order),
each arm timed as one call on the card (`scripts/bench_common.py`). It
writes `kernel_speedup.json`, with the reference's own GPU speedups under
their own key, to DIR (default `bench_out/kernel_speedup/` at the repo
root, which git ignores), and `kernel_speedup.png` beside it where
matplotlib imports. `main(device="cpu")` times the plain versions on the
host clock, for the logic only.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..kernels import rot_matmul as rm
from ..ops.packing import pack_w4_tpu
from ..scripts.bench_common import device_name, tensor
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms

ROW_SIZES = [4096, 8192, 16384, 32768]
# the reference's speedups on its GPU, as the JAX script records them
REFERENCE_GPU_SPEEDUPS = {4096: 1.36, 8192: 2.06, 16384: 3.30, 32768: 5.18}
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "bench_out" / "kernel_speedup"


def sweep(device, sizes=ROW_SIZES, O=4096, M=1, GS=128, reps=30) -> dict:
    """{I: {"dense_us", "fused_us", "speedup"}} over the row sizes."""
    dev = resolve_device(device)
    bf16 = torch.bfloat16
    rng = np.random.default_rng(0)
    results = {}
    for I in sizes:
        G = I // GS
        x = tensor(rng.normal(size=(M, I)), bf16, dev)
        qweight = pack_w4_tpu(rng.integers(0, 16, (I, O), dtype=np.int32), GS).to(dev)
        scales = tensor(rng.uniform(0.01, 0.05, (G, O)), bf16, dev)
        zeros = tensor(rng.integers(0, 16, (G, O)).astype(np.float32), bf16, dev)
        rot = tensor(rng.normal(size=(G, GS, GS)), bf16, dev)
        w_dense = tensor(rng.normal(size=(I, O)), bf16, dev)

        t_dense = kernel_time_ms(lambda: torch.matmul(x, w_dense), reps, device=dev)
        t_fused = kernel_time_ms(lambda: rm.rot_w4_matmul_mg(x, rot, qweight, scales, zeros),
                                 reps, device=dev)
        results[I] = {"dense_us": t_dense * 1e3, "fused_us": t_fused * 1e3,
                      "speedup": t_dense / t_fused}
        print(f"I={I}: dense {t_dense * 1e3:.1f}us fused {t_fused * 1e3:.1f}us "
              f"speedup {t_dense / t_fused:.2f}x", flush=True)
        del x, qweight, scales, zeros, rot, w_dense
    return results


def main(device="cuda", out=None, **sweep_args) -> dict:
    """Run the sweep, write the JSON (and the PNG where matplotlib imports)
    to `out`, and return the payload."""
    dev = resolve_device(device)
    results = sweep(dev, **sweep_args)
    outdir = Path(out) if out else DEFAULT_OUT
    outdir.mkdir(parents=True, exist_ok=True)
    payload = {
        "device": device_name(dev),
        "clock": "cuda events" if dev.type == "cuda" else "host (logic check only)",
        "speedups": {str(k): v["speedup"] for k, v in results.items()},
        "detail": {str(k): v for k, v in results.items()},
        "reference_gpu_speedups": {str(k): v for k, v in REFERENCE_GPU_SPEEDUPS.items()},
    }
    (outdir / "kernel_speedup.json").write_text(json.dumps(payload, indent=2))
    try:
        import matplotlib
    except ImportError:
        print("plot skipped: matplotlib is not installed")
        return payload
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sizes = list(results)
    fig, ax = plt.subplots(figsize=(3.2, 2.2))
    ax.plot(sizes, [results[i]["speedup"] for i in sizes], marker=".",
            label="rot_w4_matmul_mg vs bf16 dense")
    ref = [i for i in sizes if i in REFERENCE_GPU_SPEEDUPS]
    ax.plot(ref, [REFERENCE_GPU_SPEEDUPS[i] for i in ref], marker="x", linestyle="--",
            label="reference (GPU)")
    ax.set_ylabel("Speedup")
    ax.set_xlabel("Channel dimension")
    ax.set_xscale("log", base=2)
    ax.set_xticks(sizes, [str(r) for r in sizes])
    ax.grid(True, alpha=0.3, linestyle="--")
    ax.legend(fontsize=7)
    fig.savefig(outdir / "kernel_speedup.png", bbox_inches="tight", dpi=160)
    plt.close(fig)
    print(f"wrote {outdir}/kernel_speedup.png")
    return payload


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help=f"output directory (default {DEFAULT_OUT})")
    main(out=parser.parse_args().out)
