"""Where a one-launch W4 call's time goes, phase by phase, on the card.

    python -m paroquant_tpu_torch.scripts.one_launch_phases [--kernel k10] [--M 1] [--I 4096] [--O 4096] [--Gb 4] [--K 8] [--reps 9]

Builds a copy of `kernels/csrc/one_launch.cuh` in which thread 0 of every
block writes `%globaltimer` (ns) at the end of each phase of
`rot_w4_one_launch_kernel` into a device array, with one `extern "C"` entry
for the seven variants (K1's one launch, K10, K12, K11's DQ in chunks of Gb
groups, K7's BF with K butterfly stages, K13's A8 and K9's I4), into the build
directory. At the given shape, with random weights from a seeded
`torch.Generator`, it runs one call after an L2 flush `reps` times and
prints for each phase the median over repetitions of the median over blocks
of the time since the first block started at which the phase ended, and
the latest block's end; beside them the kernel's own time (the wrapper, no
stamps, `utils/profiling.py::kernel_time_ms`, the same flush). Phases: x
staged, tables landed (K7 only), rotation (K7: its stages; K13: the
quantization), row sums (DQ: its scales and zeros packed as bf16 pairs),
dot (the ring consumed), partial written, counter, end (the merging
block's last store; none with one split); a phase a variant does not have
is null. The
stamps cost a few global stores a block. A change to the kernel that moves
an anchor the stamps go after fails here (`instrumented_source`), not
silently; the CPU tests check the anchors.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess

import torch

from ..kernels import build, rot_matmul as rm, w4_experiments as wx
from ..utils.device import resolve_device
from ..utils.profiling import kernel_time_ms

PHASES = ("x", "tables", "rotation", "row_sums", "dot", "partial", "counter", "end")
VARIANTS = {"k1": 0, "k10": 1, "k12": 2, "k11": 3, "k7": 4, "k13": 5, "k9": 6}  # one::Variant
SLOTS = len(PHASES) + 1  # the phases' ends, then the block's start
MAX_BLOCKS = 16384
FLUSH_BYTES = 256 << 20  # > the 50 MB L2

# (text of the kernel, the same text with the stamp of a phase's end in it)
STAMPS = (
    ("  __shared__ int last;\n", "  __shared__ int last;\n  PHASE_STAMP(8);\n"),  # the block's start
    ("  if (MT >= 8 || !K1_ORDER) store_sz(0);\n  __syncthreads();\n",
     "  if (MT >= 8 || !K1_ORDER) store_sz(0);\n  __syncthreads();\n  PHASE_STAMP(0);\n"),
    ("    cp_async_wait<NST>();  // the tables' group, committed before the ring's NST\n"
     "    __syncthreads();\n",
     "    cp_async_wait<NST>();  // the tables' group, committed before the ring's NST\n"
     "    __syncthreads();\n    PHASE_STAMP(1);\n"),
    ("    store_sz(k0);\n  }\n  __syncthreads();\n",
     "    store_sz(k0);\n  }\n  __syncthreads();\n  PHASE_STAMP(2);\n"),
    ("    if (lane == 0) rsum[e] = s;\n  }\n", "    if (lane == 0) rsum[e] = s;\n  }\n  PHASE_STAMP(3);\n"),
    ("  cp_async_wait<0>();\n", "  cp_async_wait<0>();\n  PHASE_STAMP(4);\n"),
    ("  if (KS == 1) return;\n", "  PHASE_STAMP(5);\n  if (KS == 1) return;\n"),
    ("  __syncthreads();\n  if (!last) return;\n", "  __syncthreads();\n  PHASE_STAMP(6);\n  if (!last) return;\n"),
    # the merge's last stores, in each of its three branches
    ("    out[(size_t)(m0 + m) * O + col] = from_f32<OT>(v);\n    return;\n",
     "    out[(size_t)(m0 + m) * O + col] = from_f32<OT>(v);\n    PHASE_STAMP(7);\n    return;\n"),
    ("    out[(size_t)m0 * O + col + 1] = from_f32<OT>(v.y);\n    return;\n",
     "    out[(size_t)m0 * O + col + 1] = from_f32<OT>(v.y);\n    PHASE_STAMP(7);\n    return;\n"),
    ("    store4(m, col, v);\n  }\n}\n", "    store4(m, col, v);\n  }\n  PHASE_STAMP(7);\n}\n"),
)
PRELUDE = """
__device__ unsigned long long g_phase_stamps[%d * %d];
#define PHASE_STAMP(k) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \\
  g_phase_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * %d + (k)] = t_; \\
  } } while (0)
""" % (MAX_BLOCKS, SLOTS, SLOTS)
ENTRY = """
using namespace paro;
extern "C" int phases_call(int var, const void* x, const void* rot, const void* qweight,
                           const void* scales, const void* zeros, void* out, void* partial,
                           void* counters, int M, int I, int S, int O, int KS, int cw, int x_bf16,
                           int rot_bf16, int sdt, int zdt, int chunk, int gps, const void* inv_s,
                           const void* cos_t, const void* sin_t, int K, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (var == one::BF)
    return (int)one::call<one::BF>(x, nullptr, qweight, scales, zeros, out, partial, counters, M, I,
                                   S, 1, &O, KS, cw, x_bf16, 0, sdt, zdt, st, 0, 0, inv_s, cos_t,
                                   sin_t, K);
  if (var == one::A8)
    return (int)one::call<one::A8>(x, nullptr, qweight, scales, zeros, out, partial, counters, M, I,
                                   S, 1, &O, KS, cw, x_bf16, 0, sdt, zdt, st);
  if (var == one::DQ)
    return (int)one::call<one::DQ>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                   1, &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, st, chunk, gps);
  if (var == one::K1)
    return (int)one::call<one::K1>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                   1, &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, st);
  if (var == one::I4)
    return (int)one::call<one::I4>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                   1, &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, st);
  if (var == one::B)
    return (int)one::call<one::B>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S,
                                  1, &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, st);
  return (int)one::call<one::V2>(x, rot, qweight, scales, zeros, out, partial, counters, M, I, S, 1,
                                 &O, KS, cw, x_bf16, rot_bf16, sdt, zdt, st);
}
extern "C" int phases_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_phase_stamps, (size_t)n * 8);
}
extern "C" int phases_clear() {
  static unsigned long long zero[%d * %d];
  return (int)cudaMemcpyToSymbol(g_phase_stamps, zero, sizeof(zero));
}
""" % (MAX_BLOCKS, SLOTS)


def instrumented_source() -> str:
    """one_launch.cuh with the stamps (each anchor found once) and an
    `extern "C"` entry; raises if the kernel no longer has an anchor."""
    src = (build.CSRC / "one_launch.cuh").read_text()
    src = src.replace('#include "w4_passes.cuh"\n', '#include "w4_passes.cuh"\n' + PRELUDE, 1)
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"one_launch.cuh no longer has the anchor {old!r}")
        src = src.replace(old, new)
    return src + ENTRY


def _library() -> ctypes.CDLL:
    src = instrumented_source()
    h = hashlib.sha256((src + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    out_dir = build.BUILD_ROOT / "phases" / h
    lib = out_dir / "libone_launch_phases.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "one_launch_phases.cu").write_text(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                        str(out_dir / "one_launch_phases.cu")], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.phases_call.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                                + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    dll.phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return dll


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=list(VARIANTS), default="k10")
    ap.add_argument("--M", type=int, default=1)
    ap.add_argument("--I", type=int, default=4096)
    ap.add_argument("--O", type=int, default=4096)
    ap.add_argument("--S", type=int, default=128)
    ap.add_argument("--Gb", type=int, default=4, help="K11's groups a chunk")
    ap.add_argument("--K", type=int, default=8, help="K7's butterfly stages")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # the phases are stamped on the card only
    M, I, S, O = args.M, args.I, args.S, args.O
    G = I // S
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(M, I, generator=gen, device=dev).to(bf)
    rot = (torch.randn(G, S, S, generator=gen, device=dev) / S**0.5).to(bf)
    qw = torch.randint(0, 256, (I // 2, O), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
    scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(bf)
    zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(bf)
    sms = rm._sm_count(dev)
    chunk, gps = G, 0  # K11 only
    K, tables = args.K, ()  # K7 only
    if args.kernel == "k1":
        route, KS, tile = rm.rot_route(M, I, S, (O,), False, bf, sms)
        if route != "one_launch":
            raise SystemExit(f"K1 takes the passes at M={M}, I={I}, S={S}, O={O}")
        rows = rm.one_launch_row_tile(M)
        call = lambda: rm.rot_w4_matmul(x, rot, qw, scales, zeros)
    elif args.kernel == "k11":
        chunk = args.Gb
        KS, tile, rows, gps = rm.dq_plan(M, I, S, O, sms, chunk)
        call = lambda: wx.dma_rot_w4_matmul(x, rot, qw, scales, zeros, Gb=chunk)
    elif args.kernel == "k7":
        route, plan = rm.bf_route(M, I, S, O, K, sms)
        if route != "one_launch":
            raise SystemExit(f"K7 takes the passes at M={M}, I={I}, S={S}, O={O}, K={K}")
        KS, tile, rows, _ = plan
        inv_s = torch.rand(I, generator=gen, device=dev) + 0.5
        angle = torch.randn(K, I, generator=gen, device=dev) * 0.3
        tables = (inv_s, torch.cos(angle), torch.sin(angle))
        call = lambda: rm.butterfly_w4_matmul(x, *tables, qw, scales, zeros, group_size=S)
    elif args.kernel == "k13":
        KS, tile, rows = wx.a8_plan(M, I, S, O, sms)
        call = lambda: wx.w4a8_matmul(x, qw, scales, zeros, group_size=S)
    elif args.kernel == "k9":  # the random bytes read as interleaved nibbles
        route, plan = rm.i4_route(M, I, S, O, sms)
        if route != "one_launch":
            raise SystemExit(f"K9 takes the passes at M={M}, I={I}, S={S}, O={O}")
        KS, tile, rows, _ = plan
        call = lambda: rm.rot_w4_matmul_i4(x, rot, qw, scales, zeros)
    else:
        KS, tile, rows = wx.one_launch_plan(M, I, S, O, sms)
        fn = wx.rot_w4_matmul_b if args.kernel == "k10" else wx.rot_w4_matmul_v2
        call = lambda: fn(x, rot, qw, scales, zeros)
    lib = _library()
    n = -(-O // tile) * KS * -(-M // rows)
    ptrs = [t.data_ptr() for t in tables] or [None] * 3
    if n > MAX_BLOCKS:
        raise SystemExit(f"{n} blocks: at most {MAX_BLOCKS} are stamped")
    out = torch.empty((M, O), dtype=torch.float32 if args.kernel == "k12" else bf, device=dev)
    partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=torch.float32, device=dev)
    counters = rm._counters(-(-O // tile) * -(-M // rows), dev)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_rep = []
    for _ in range(args.reps):
        lib.phases_clear()
        flush.zero_()
        torch.cuda.synchronize()
        err = lib.phases_call(VARIANTS[args.kernel], x.data_ptr(), rot.data_ptr(), qw.data_ptr(),
                              scales.data_ptr(), zeros.data_ptr(), out.data_ptr(), partial.data_ptr(),
                              counters.data_ptr(), M, I, S, O, KS, tile // rm.COLS_PER_TILE, 1, 1, 1, 1,
                              chunk, gps, *ptrs, K, stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"the stamped kernel failed with CUDA error {err}")
        buf = (ctypes.c_uint64 * (n * SLOTS))()
        lib.phases_read(buf, n * SLOTS)
        t = torch.tensor(list(buf), dtype=torch.float64).reshape(n, SLOTS)
        rel = (t - t[:, -1].min()) / 1e3  # µs since the first block started
        rel[t == 0] = float("nan")  # phases a block did not reach (the merge: one block a tile)
        end = len(PHASES) - 1
        per_rep.append([rel[:, k].nanmedian().item() for k in range(len(PHASES))]
                       + [torch.nan_to_num(rel[:, end], nan=-1.0).max().item()])
    med = [None if v != v else v for v in torch.tensor(per_rep).median(0).values.tolist()]
    us = kernel_time_ms(call, 30, flush) * 1e3
    row = {"kernel": args.kernel, "M": M, "I": I, "O": O, "S": S, "KS": KS, "tile": tile,
           **({"Gb": chunk, "groups_per_split": gps} if args.kernel == "k11" else {}),
           **({"K": K} if args.kernel == "k7" else {}),
           "rows_per_block": rows, "blocks": n, "us": us,
           "phase_end_us": dict(zip(PHASES, med[:-1])), "last_end_us": med[-1],
           "device": torch.cuda.get_device_name(dev), "card": _card()}
    print(json.dumps(row), flush=True)
    return [row]


if __name__ == "__main__":
    main()
