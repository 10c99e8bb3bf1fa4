"""Where K18's time goes on the card: its copies and its merge taken out in turn.

    python -m paroquant_tpu_torch.scripts.stream_only_phases [--I 4096] [--O 4096] [--reps 30]

Builds copies of `kernels/csrc/unpack_exp.cu` in which K18 (`stream_kernel`)
skips its merge (every block returns before it arrives on its tile's
counter), its copies (no bulk copy is issued or waited for; row 0 is read
from whatever the stage holds), or both (`variant_source`), all with
`kernels/build.py`'s flags and in parallel, into
`kernels/_build/stream_phases/`. On the script's draws (a seeded
`torch.Generator`, g128, Gb 1, bf16 x) it checks the committed kernel
against the plain version (bit for bit; the other variants' outputs are
not the function) and times every variant, twice in the order committed,
no merge, no copies, neither, then back, after the harness's L2 flush (a
write, which leaves the L2's lines dirty) and after a flush that leaves
them clean (a read; `utils/profiling.py::kernel_time_ms`). Prints one JSON
line a timing. Runs where nvcc is installed (the card's machine).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..kernels import build, rot_matmul as rm, unpack_exp as ux
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms
from .bf16_dot_sweep import FLUSH_BYTES

# the committed text and what each cut puts in its place
ARRIVAL = "  // every split of the tile has written its rows: the last block to arrive"
FIRST_FILLS = "  for (int q = 0; q < min(nst, nq); ++q) fill(q);\n"
WAIT = ("    if (vec)\n      mbar_wait(bars + q % nst, (q / nst) & 1);\n"
        "    else\n      __syncthreads();\n")
CUTS = {"merge": [(ARRIVAL, "  return;\n" + ARRIVAL)], "copies": [(FIRST_FILLS, ""), (WAIT, "")]}
VARIANTS = {"committed": (), "no_merge": ("merge",), "no_copies": ("copies",),
            "neither": ("merge", "copies")}


def variant_source(cuts) -> str:
    """unpack_exp.cu with K18's merge and / or copies cut; raises if an anchor is gone."""
    src = (build.CSRC / "unpack_exp.cu").read_text()
    for cut in cuts:
        for old, new in CUTS[cut]:
            if src.count(old) != 1:
                raise RuntimeError(f"unpack_exp.cu no longer has the anchor {old!r}")
            src = src.replace(old, new)
    return src


def _libraries() -> dict:
    out = build.BUILD_ROOT / "stream_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        (out / f"{name}.cu").write_text(variant_source(cuts))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("nvcc failed on a variant")
    fns = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).paro_stream_only
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--I", type=int, default=4096)
    ap.add_argument("--O", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # the kernels run on the card only
    I, O, S = args.I, args.O, 128
    fns = _libraries()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, I, generator=gen, device=dev).to(torch.bfloat16)
    qw = torch.randint(0, 256, (I // 2, O), generator=gen, device=dev, dtype=torch.uint8)
    NB, tiles = I // S, -(-O // ux.TILE_BYTES)
    KS = ux.stream_plan(O, NB, rm._sm_count(dev))
    out = torch.empty((1, O), dtype=torch.float32, device=dev)
    part = torch.empty((NB, tiles * ux.TILE_BYTES), dtype=torch.float32, device=dev)
    counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()

    def call(name):
        return lambda: fns[name](x.data_ptr(), qw.data_ptr(), out.data_ptr(), part.data_ptr(),
                                 counters.data_ptr(), I, S, O, 1, KS, 1, stream)

    if call("committed")():
        raise RuntimeError("the committed kernel's launch failed")
    torch.cuda.synchronize()
    if not torch.equal(out, ux.stream_only_plain(x, qw)):
        raise RuntimeError("the committed kernel differs from the plain version")
    rows = []
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        run = call(name)
        if run():
            raise RuntimeError(f"{name}: the launch failed")
        row = {"variant": name, "I": I, "O": O, "KS": KS,
               "us": kernel_time_ms(run, args.reps, flush) * 1e3,
               "us_clean_l2": kernel_time_ms(run, args.reps, flush, clean_l2=True) * 1e3, "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
