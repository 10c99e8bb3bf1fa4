"""The one-launch kernel's instances compiled here, against another tree's.

    python -m paroquant_tpu_torch.scripts.one_launch_sass --ref DIR

Compiles each source of this checkout that instantiates
`kernels/csrc/one_launch.cuh` (`ONE_LAUNCH_SOURCES`) and the same-named
source in DIR (the `csrc` directory of another checkout, or any directory
holding such a source with the headers it includes), all with
`kernels/build.py`'s flags and in parallel, and prints one JSON line a
source found in both: for each `Variant` of `rot_w4_one_launch_kernel`, how
many of DIR's instances compile to the same SASS here, byte for byte
(`cuobjdump -sass`), and how many instances each variant has here (a
variant new here, such as K9's I4, has none in DIR). A change meant to
leave a variant alone shows as all of its instances identical. Runs where
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

ONE_LAUNCH_SOURCES = ("rot_w4_matmul", "w4_experiments", "rot_w4_dequant", "w4_variants")
KERNEL = "rot_w4_one_launch_kernel"


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


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or str(Path(build._nvcc()).parent / "cuobjdump")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", required=True, type=Path, help="a directory of the reference sources")
    args = ap.parse_args(argv)
    out = build.BUILD_ROOT / "sass"
    out.mkdir(parents=True, exist_ok=True)
    stems = [s for s in ONE_LAUNCH_SOURCES if (args.ref / f"{s}.cu").exists()]
    jobs = {(side, s): (src, out / f"{side}_{s}.so")
            for s in stems for side, src in (("ref", args.ref), ("here", build.CSRC))}
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src), "-o", str(lib),
                               str(src / f"{s}.cu")], stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT)
             for (_, s), (src, lib) in jobs.items()]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed on a source")
    rows = []
    for s in stems:
        funcs = {side: sass_functions(subprocess.run(
            [_cuobjdump(), "-sass", str(jobs[side, s][1])], capture_output=True, text=True,
            check=True).stdout) for side in ("ref", "here")}
        row = {"source": f"{s}.cu", "ref": str(args.ref),
               "identical_of_instances_by_variant": compare(funcs["ref"], funcs["here"]),
               "instances_here_by_variant": count_by_variant(funcs["here"])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
