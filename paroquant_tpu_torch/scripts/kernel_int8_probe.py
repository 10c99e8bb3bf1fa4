"""The int8 tensor-core probe: the port of `scripts/kernel_int8_probe.py`.

    python -m paroquant_tpu_torch.scripts.kernel_int8_probe

The JAX script asks, before any kernel work, whether the TPU's int8 matrix
unit is usable for the W4 GEMV and whether it is faster than bf16. On the
card the matrix unit is the tensor cores, and the probes run the port's
kernels (`kernels/int8_probe.py`):

  P1  narrow_cast (K14): int32 -> int8 inside a kernel, on np.arange
  P2  int8_dot (K15, mma.sync s8): int8 x int8 -> int32 at a GEMV-ish shape
  P3  fused_unpack_int8_dot (K16): u8 nibbles -> int8 -> the same dot
  bench int8 (K15) against bf16 (K17, mma.sync bf16) at the W4 GEMV inner
      shape, M = 8, S = O = 4096

with the script's inputs (`np.random.default_rng(0)`, `(1)` and `(2)` in its
draw order) and its exact-equality checks. Each probe prints PROBE_OK with
its result or PROBE_FAIL with the error, as the script does.

Timing: the JAX script takes the min of 5 means of 50 back-to-back calls on
the host clock. On the card that reads the wrong thing: the int8 B is 16 MB
and the bf16 one 32 MB, both under the H100's 50 MB L2, so back-to-back
calls would be timed from L2. `bench_dots` times one call with the L2
flushed (`bench_common.time_cases`: CUDA events, the median of the reps). A
row's bytes are A and B read once and the output written once.
`main(device="cpu", reps=1, S=256, O=256)` runs the plain versions on the
host clock, for the logic only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import int8_probe as ip
from ..utils.device import resolve_device
from .bench_common import Case, device_name, tensor, time_cases

M_BENCH = 8  # the script's rows


def _run(name, fn):
    """Run one probe; print PROBE_OK with what it returns (where that is a
    line) or PROBE_FAIL with the error. Returns (ok, what it returned)."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - a probe reports every failure
        # the JAX script takes str(e).splitlines()[0], which fails on an
        # assertion without a message
        msg = (str(e).splitlines() or [""])[0][:160]
        print(f"PROBE_FAIL {name}: {type(e).__name__}: {msg}", flush=True)
        return False, None
    print(f"PROBE_OK   {name}" + (f": {out}" if isinstance(out, str) else ""), flush=True)
    return True, out


def probe_narrow_cast(device):
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    out = ip.narrow_cast(tensor(x, torch.int32, device))
    assert np.array_equal(out.cpu().numpy(), (x & 15).astype(np.int8))
    return "int32->int8 cast legal, values exact"


def probe_int8_dot(device):
    rng = np.random.default_rng(0)
    a = rng.integers(-8, 8, (8, 256), dtype=np.int8)
    b = rng.integers(-8, 8, (256, 128), dtype=np.int8)
    out = ip.int8_dot(tensor(a, torch.int8, device), tensor(b, torch.int8, device))
    assert np.array_equal(out.cpu().numpy(), a.astype(np.int32) @ b.astype(np.int32))
    return "int8xint8->int32 MXU dot legal, exact"


def probe_fused_unpack_int8_dot(device):
    rng = np.random.default_rng(1)
    S, O = 256, 512
    w = rng.integers(0, 256, (S // 2, O), dtype=np.uint8)
    x = rng.integers(-127, 127, (8, S), dtype=np.int8)
    out = ip.fused_unpack_int8_dot(tensor(x, torch.int8, device), tensor(w, torch.uint8, device))
    lo = (w.astype(np.int32) & 15) - 8
    hi = ((w.astype(np.int32) >> 4) & 15) - 8
    expect = x.astype(np.int32) @ np.concatenate([lo, hi], axis=0)
    assert np.array_equal(out.cpu().numpy(), expect)
    return "fused u8-unpack -> int8 MXU dot legal, exact"


def bench_cases(device, S=4096, O=4096) -> list[Case]:
    """The int8 (K15) and bf16 (K17) arms on the script's draws."""
    rng = np.random.default_rng(2)
    a8 = tensor(rng.integers(-8, 8, (M_BENCH, S), dtype=np.int8), torch.int8, device)
    b8 = tensor(rng.integers(-8, 8, (S, O), dtype=np.int8), torch.int8, device)
    bbf = b8.to(torch.bfloat16)
    return [
        Case("int8 dot", lambda a: ip.int8_dot(a, b8), a8, M_BENCH * S + S * O + 4 * M_BENCH * O),
        Case("bf16 dot", lambda a: ip.bf16_dot(a, bbf), a8.to(torch.bfloat16),
             2 * M_BENCH * S + 2 * S * O + 4 * M_BENCH * O),
    ]


def bench_dots(device, reps: int = 30, S: int = 4096, O: int = 4096) -> list[dict]:
    """Time both arms, print the script's line and return the rows."""
    rows = time_cases(bench_cases(device, S, O), device, reps)
    print(f"int8 dot {rows[0]['us']:.1f}us vs bf16 dot {rows[1]['us']:.1f}us "
          f"@ {S}x{O} M={M_BENCH}", flush=True)
    return rows


def main(device="cuda", *, reps: int = 30, **shape):
    """Print the device, then one PROBE_OK / PROBE_FAIL line per probe; the
    bench runs when the int8 dot passed. Returns ({probe: ok}, the bench's
    rows). `shape` (S, O) shrinks the bench."""
    dev = resolve_device(device)
    print("devices:", device_name(dev), flush=True)
    ok = {
        "narrow_cast": _run("narrow_cast(int32->int8)", lambda: probe_narrow_cast(dev))[0],
        "int8_dot": _run("int8_mxu_dot", lambda: probe_int8_dot(dev))[0],
        "fused_unpack_int8_dot": _run("fused_unpack_int8_dot",
                                      lambda: probe_fused_unpack_int8_dot(dev))[0],
    }
    rows = []
    if ok["int8_dot"]:
        ok["bench_dots"], rows = _run("bench int8 vs bf16 dot",
                                      lambda: bench_dots(dev, reps, **shape))
    return ok, rows or []


if __name__ == "__main__":
    main()
