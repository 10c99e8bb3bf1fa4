"""K15's design choices on the card: ring depth, B's L2 policy and the K split.

    python -m paroquant_tpu_torch.scripts.int8_dot_sweep [--M 8] [--K 4096] [--N 4096] [--reps 30]

Builds copies of `kernels/csrc/int8_probe.cu` with K15's ring stages
(`I8_NST`) and B's copies with or without the L2 policy evict_first
changed (`variant_source`), all with `kernels/build.py`'s flags and in
parallel, into `kernels/_build/int8_sweep/`. On int8 operands over the
whole range made from a seeded `torch.Generator` it checks each variant's
output against the plain version (exact; raises where it differs) and times
it with the K range in 2, 4, 8 and 16 splits, after the harness's L2 flush
(a write of a buffer larger than the L2, which leaves its lines dirty) and
after a flush that leaves them clean (a read), beside `torch._int_mm` on A
padded to 32 rows timed the same two ways
(`utils/profiling.py::kernel_time_ms`). Prints the library's JSON line,
then one a variant and split, the plain variants first: a variant whose
call faults gets a line with the error, and the sweep stops there, since
the fault leaves the process's CUDA context unusable. Runs where nvcc is
installed (the card's machine).

Before any call, each variant's SASS (`cuobjdump -sass`) gives the uniform
registers its ring copies (LDGSTS) take their memory descriptor from: a
64-bit pair, the L2 policy where one is given. A variant with one at an odd
register is not called: its line gives the registers and the reason. On
the card's toolkit ptxas puts the evict_first arms' policy at UR1 (K17's
own copies take UR4), and that instruction raised CUDA error 715 (illegal
instruction) at its first call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess

import torch

from ..kernels import build, int8_probe as ip
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms
from .bf16_dot_sweep import FLUSH_BYTES, SPLITS

VARIANTS = {  # name: (ring stages, evict_first on B's copies)
    "committed": (4, False), "stages6": (6, False), "evict_first": (4, True),
    "stages6_evict_first": (6, True),
}
# (the committed text, the same text with {} for the variant's value); the
# policy is made once a block, beside the split's chunk range
ANCHORS = {
    "stages": ("constexpr int I8_NST = 4;", "constexpr int I8_NST = {};"),
    "make_policy": (
        "  const int c0 = ks * per, nc = min((K + I8_BK - 1) / I8_BK, c0 + per) - c0;  // >= 1\n",
        "  const int c0 = ks * per, nc = min((K + I8_BK - 1) / I8_BK, c0 + per) - c0;  // >= 1\n"
        "  uint64_t policy;\n"
        '  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));\n'),
    "policy": ("cp_async16(dst, ok ? B + (size_t)k * N + n : B, ok ? 16 : 0);",
               "cp_async16_evict_first(dst, ok ? B + (size_t)k * N + n : B, ok ? 16 : 0, policy);"),
}


def variant_source(stages: int, evict_first: bool) -> str:
    """int8_probe.cu with the variant's constants; raises if an anchor is gone."""
    src = (build.CSRC / "int8_probe.cu").read_text()
    for key, (old, new) in ANCHORS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"int8_probe.cu no longer has the anchor {old!r}")
        if key == "stages":
            src = src.replace(old, new.format(stages))
        elif evict_first:
            src = src.replace(old, new)
    return src


def descriptor_registers(sass: str) -> list[int]:
    """The uniform registers (n of `desc[URn]`) that a library's LDGSTS
    instructions take their memory descriptor from, in `cuobjdump -sass`
    text."""
    return sorted({int(n) for line in sass.splitlines() if "LDGSTS" in line
                   for n in re.findall(r"desc\[UR(\d+)\]", line)})


def _libraries() -> tuple[dict, dict]:
    out = build.BUILD_ROOT / "int8_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, v in VARIANTS.items():
        (out / f"{name}.cu").write_text(variant_source(*v))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("nvcc failed on a variant")
    fns, regs = {}, {}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in VARIANTS:
        lib = out / f"lib{name}.so"
        regs[name] = descriptor_registers(subprocess.run(
            [tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout)
        fn = ctypes.CDLL(str(lib)).paro_int8_dot
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fns[name] = fn
    return fns, regs


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # the kernels run on the card only
    M, K, N = args.M, args.K, args.N
    fns, regs = _libraries()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    want = ip.int8_dot_plain(a, b)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = ip.int8_plan(M, K, N, ip._sm_count(dev))[2]
    n_tiles = -(-N // ip.INT8_TILE_N)
    counters = torch.zeros(n_tiles * -(-M // rows), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    ap32 = torch.zeros((max(M, 32), K), dtype=torch.int8, device=dev)
    ap32[:M] = a
    lib = lambda: torch._int_mm(ap32, b)
    row = {"variant": "torch._int_mm on A padded to 32 rows",
           "us": kernel_time_ms(lib, args.reps, flush) * 1e3,
           "us_clean_l2": kernel_time_ms(lib, args.reps, flush, clean_l2=True) * 1e3,
           "M": M, "K": K, "N": N, "device": torch.cuda.get_device_name(dev), "card": card}
    print(json.dumps(row), flush=True)
    out = [row]
    chunks = -(-K // ip.INT8_CHUNK_K)
    for name, (stages, ef) in VARIANTS.items():
        odd = [n for n in regs[name] if n % 2]
        if odd:  # a 64-bit descriptor in an odd register: not called
            row = {"variant": name, "stages": stages, "evict_first": ef,
                   "ldgsts_descriptor_registers": regs[name],
                   "refused": f"LDGSTS takes its memory descriptor from UR{odd[0]}, an odd register"}
            print(json.dumps(row), flush=True)
            out.append(row)
            continue
        for want_ks in SPLITS:
            per = -(-chunks // min(want_ks, chunks))
            ks = -(-chunks // per)
            y = torch.empty((M, N), dtype=torch.int32, device=dev)
            part = torch.empty((ks, M, n_tiles * ip.INT8_TILE_N), dtype=torch.int32, device=dev)
            call = lambda: fns[name](a.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(),
                                     counters.data_ptr(), M, K, N, per, ks, rows, stream)
            row = {"variant": name, "stages": stages, "evict_first": ef, "KS": ks,
                   "ldgsts_descriptor_registers": regs[name]}
            try:  # a fault in the first call or in the timed ones
                if call():
                    raise RuntimeError(f"{name}: the launch failed")
                torch.cuda.synchronize()
                same = torch.equal(y, want)
                if same:
                    row.update(us=kernel_time_ms(call, args.reps, flush) * 1e3,
                               us_clean_l2=kernel_time_ms(call, args.reps, flush,
                                                          clean_l2=True) * 1e3)
            except RuntimeError as e:  # torch's CUDA errors too
                row["error"] = str(e).splitlines()[0]
                print(json.dumps(row), flush=True)
                return out + [row]
            if not same:
                raise ValueError(f"{name} at {ks} splits differs from the plain version")
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
