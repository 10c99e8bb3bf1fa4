"""The one-launch kernel's instances compiled here, against another tree's.

    python -m paroquant_tpu_torch.scripts.one_launch_sass --ref DIR

Compiles each source of this checkout that instantiates
`kernels/csrc/one_launch.cuh` (`ONE_LAUNCH_SOURCES`) and the same-named
source in DIR (the `csrc` directory of another checkout, or any directory
holding such a source with the headers it includes), all with
`kernels/build.py`'s flags and in parallel, and prints one JSON line a
source: for each `Variant` of `rot_w4_one_launch_kernel`, how many of DIR's
instances compile to the same SASS here, byte for byte (`cuobjdump -sass`),
and how many instances each variant has here (a variant new here, such as
RA8 in a source that DIR lacks, has none in DIR). A change meant to leave a
variant alone shows as all of its instances identical. Then one line of the
unpack experiment's readout: for each instance of PL, BC, MF and WM (the
four unpacks of `scripts/kernel_unpack_exp.py` on one skeleton), how many
of each unpack opcode (`UNPACK_OPS`: LOP3, PRMT, I2F, F2F, HMUL2, FRND, ...,
with their modifiers) its SASS holds, and whether each WM instance is PL's
same instance byte for byte (then the compiler already unpacks PL's bytes
word-wide, and WM adds nothing). Runs where
nvcc and cuobjdump are installed (the card's machine); the libraries go
under `kernels/_build/sass/`.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

from ..kernels import build

ONE_LAUNCH_SOURCES = ("rot_w4_matmul", "w4_experiments", "rot_w4_dequant", "w4_variants",
                      "rot_w4_a8", "w4_plain", "w4_opair", "w4_mulfloor", "w4_wordmask")
KERNEL = "rot_w4_one_launch_kernel"
UNPACKS = {8: "pl", 9: "bc", 10: "mf", 11: "wm"}  # the unpack variants: one::Variant -> name
UNPACK_OPS = ("LOP3", "SHF", "PRMT", "I2F", "I2FP", "F2F", "F2FP", "FADD", "FMUL", "HADD2",
              "HMUL2", "HFMA2", "FRND", "IMAD", "BMSK", "SGXT")


def sass_functions(text: str) -> dict[str, str]:
    """`cuobjdump -sass` output -> {mangled name: its SASS lines} for the
    one-launch kernel's instances."""
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name:
            funcs[name].append(line)
    return {f: "\n".join(body) for f, body in funcs.items() if KERNEL in f}


def variant_of(name: str) -> int:
    """The `Variant` of an instance: the template's last argument."""
    return int(re.search(r"Li(\d+)EEEvNS0_4ArgsE$", name).group(1))


def compare(ref: dict[str, str], new: dict[str, str]) -> dict[int, list[int]]:
    """{variant: [instances identical here, instances in ref]}."""
    out: dict[int, list[int]] = {}
    for name, body in ref.items():
        same, total = out.setdefault(variant_of(name), [0, 0])
        out[variant_of(name)] = [same + (new.get(name) == body), total + 1]
    return dict(sorted(out.items()))


def count_by_variant(funcs: dict[str, str]) -> dict[int, int]:
    """{variant: its instances} of a `sass_functions` listing."""
    out: dict[int, int] = {}
    for name in funcs:
        out[variant_of(name)] = out.get(variant_of(name), 0) + 1
    return dict(sorted(out.items()))


def opcode_counts(body: str) -> dict[str, int]:
    """{opcode with its modifiers: count} of a function's SASS, for the
    opcodes whose stem is in UNPACK_OPS (a predicate guard is dropped)."""
    out: dict[str, int] = {}
    for line in body.splitlines():
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and m.group(1).split(".")[0] in UNPACK_OPS:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return dict(sorted(out.items()))


def instance_args(name: str) -> str:
    """An instance's template arguments but the variant: "<x type><rot type>Li<MT>E"."""
    return re.search(r"kernelI(\w+?)Li\d+EEEvNS0_4ArgsE$", name).group(1)


def unpack_readout(funcs: dict[str, str]) -> dict:
    """PL's, BC's, MF's and WM's opcode counts by instance, and for each WM
    instance whether PL's same instance has the same SASS."""
    by_var: dict[str, dict[str, str]] = {}
    for name, body in funcs.items():
        if variant_of(name) in UNPACKS:
            by_var.setdefault(UNPACKS[variant_of(name)], {})[instance_args(name)] = body
    pl, wm = by_var.get("pl", {}), by_var.get("wm", {})
    return {"opcodes": {v: {a: opcode_counts(b) for a, b in sorted(inst.items())}
                        for v, inst in sorted(by_var.items())},
            "wm_identical_to_pl": {a: pl.get(a) == b for a, b in sorted(wm.items())}}


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or str(Path(build._nvcc()).parent / "cuobjdump")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", required=True, type=Path, help="a directory of the reference sources")
    args = ap.parse_args(argv)
    out = build.BUILD_ROOT / "sass"
    out.mkdir(parents=True, exist_ok=True)
    stems = [s for s in ONE_LAUNCH_SOURCES if (build.CSRC / f"{s}.cu").exists()]
    jobs = {(side, s): (src, out / f"{side}_{s}.so")
            for s in stems for side, src in (("ref", args.ref), ("here", build.CSRC))
            if (src / f"{s}.cu").exists()}
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src), "-o", str(lib),
                               str(src / f"{s}.cu")], stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT)
             for (_, s), (src, lib) in jobs.items()]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed on a source")
    rows, here = [], {}
    for s in stems:
        funcs = {side: sass_functions(subprocess.run(
            [_cuobjdump(), "-sass", str(jobs[side, s][1])], capture_output=True, text=True,
            check=True).stdout) if (side, s) in jobs else {} for side in ("ref", "here")}
        here.update(funcs["here"])
        row = {"source": f"{s}.cu", "ref": str(args.ref),
               "identical_of_instances_by_variant": compare(funcs["ref"], funcs["here"]),
               "instances_here_by_variant": count_by_variant(funcs["here"])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    row = {"unpack_opcodes": unpack_readout(here)}
    print(json.dumps(row), flush=True)
    return rows + [row]


if __name__ == "__main__":
    main()
