"""K17's design choices on the card: ring depth, K rows a stage, B's L2 policy and the K split.

    python -m paroquant_tpu_torch.scripts.bf16_dot_sweep [--M 8] [--K 4096] [--N 4096] [--reps 30]

Builds copies of `kernels/csrc/int8_probe.cu` with the ring's stages
(`BF_NST`), its K rows a stage (`BF_BK`) and B's copies with or without
the L2 policy evict_first changed (`variant_source`), all with
`kernels/build.py`'s flags and in parallel, into `kernels/_build/sweep/`.
On integer operands made from a seeded `torch.Generator` it checks each
variant's output against the plain version (exact; raises where it
differs) and times it with the K range in 2, 4, 8 and 16 splits, after the
harness's L2 flush (a write of a buffer larger than the L2, which leaves
its lines dirty) and after a flush that leaves them clean (a read), beside
`torch.matmul` timed the same two ways (`utils/profiling.py::kernel_time_ms`).
Prints one JSON line a variant and split, then the library's. Runs where
nvcc is installed (the card's machine).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..kernels import build, int8_probe as ip
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms

VARIANTS = {  # name: (ring stages, K rows a stage, evict_first on B's copies)
    "committed": (4, 64, True), "no_evict_first": (4, 64, False), "stages3": (3, 64, True),
    "stages6": (6, 64, True), "rows32_stages8": (8, 32, True), "rows128": (4, 128, True),
}
SPLITS = (2, 4, 8, 16)
FLUSH_BYTES = 256 << 20  # > the 50 MB L2
# (the committed text, the same text with {} for the variant's value)
ANCHORS = {
    "stages": ("constexpr int BF_NST = 4;", "constexpr int BF_NST = {};"),
    "rows": ("constexpr int BF_BK = 64;", "constexpr int BF_BK = {};"),
    "policy": ("cp_async16_evict_first(dst, ok ? B + (size_t)k * N + n : B, ok ? 16 : 0, policy);",
               "cp_async16(dst, ok ? B + (size_t)k * N + n : B, ok ? 16 : 0);"),
}


def variant_source(stages: int, rows: int, evict_first: bool) -> str:
    """int8_probe.cu with the variant's constants; raises if an anchor is gone."""
    src = (build.CSRC / "int8_probe.cu").read_text()
    for key, (old, new) in ANCHORS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"int8_probe.cu no longer has the anchor {old!r}")
        if key == "policy":
            src = src if evict_first else src.replace(old, new)
        else:
            src = src.replace(old, new.format(stages if key == "stages" else rows))
    return src


def _libraries() -> dict:
    out = build.BUILD_ROOT / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, v in VARIANTS.items():
        (out / f"{name}.cu").write_text(variant_source(*v))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("nvcc failed on a variant")
    fns = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).paro_bf16_dot
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # the kernels run on the card only
    M, K, N = args.M, args.K, args.N
    fns = _libraries()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-8, 8, (M, K), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randint(-8, 8, (K, N), generator=gen, device=dev).to(torch.bfloat16)
    want = ip.bf16_dot_plain(a, b)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = ip.bf16_plan(M, K, N, ip._sm_count(dev))[2]
    n_tiles = -(-N // ip.BF16_TILE_N)
    counters = torch.zeros(n_tiles * -(-M // rows), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = []
    for name, (stages, bk, ef) in VARIANTS.items():
        chunks = -(-K // bk)
        for want_ks in SPLITS:
            per = -(-chunks // min(want_ks, chunks))
            ks = -(-chunks // per)
            y = torch.empty((M, N), dtype=torch.float32, device=dev)
            part = torch.empty((ks, M, n_tiles * ip.BF16_TILE_N), dtype=torch.float32, device=dev)
            call = lambda: fns[name](a.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(),
                                     counters.data_ptr(), M, K, N, per, ks, rows, stream)
            if call():
                raise RuntimeError(f"{name}: the launch failed")
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise RuntimeError(f"{name} at {ks} splits differs from the plain version")
            row = {"variant": name, "stages": stages, "rows_a_stage": bk, "evict_first": ef, "KS": ks,
                   "us": kernel_time_ms(call, args.reps, flush) * 1e3,
                   "us_clean_l2": kernel_time_ms(call, args.reps, flush, clean_l2=True) * 1e3}
            print(json.dumps(row), flush=True)
            out.append(row)
    lib = lambda: torch.matmul(a, b)
    row = {"variant": "torch.matmul", "us": kernel_time_ms(lib, args.reps, flush) * 1e3,
           "us_clean_l2": kernel_time_ms(lib, args.reps, flush, clean_l2=True) * 1e3,
           "M": M, "K": K, "N": N, "device": torch.cuda.get_device_name(dev), "card": card}
    print(json.dumps(row), flush=True)
    return out + [row]


if __name__ == "__main__":
    main()
