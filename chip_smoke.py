#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paroquant_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines:
  1. the device: torch's name for it, then nvidia-smi's name and power limit;
  2. the kernel build (seconds, cached or not, ptxas resource lines);
  3. every CUDA kernel against its plain PyTorch version at Qwen3-0.6B
     shapes, with max abs error, tolerance and median times (CUDA events,
     after warm-up, L2 flushed before each timed launch) beside the bound
     and one library call: K1/K2 (W4 GEMV at M 1, 8, 16 and 128, W4A16
     and a8, each row naming its route; on the one-launch and RA8 routes
     two calls bitwise equal, one kernel a call on the profiler's count,
     the three passes timed beside it; its edge grid and both sides of each
     limit of the route rule in `rot_route_edges`, RA8's edges in
     `ra8_edges`: the lm_head at M 1-16 with an all-zero row, runs of
     tiles over uneven partitions), K3 (flash prefill at a
     512-token prefill from offset 0 and 256 and with a window of 128; each
     query row held to its own output's scale, two calls bitwise equal,
     SDPA timed with the mask as a tensor and, from offset 0, with
     is_causal), K4/K5
     (paged decode / verify over 8 slots of mixed lengths, bf16 and int8
     pools; each query row held to its own output's scale; two calls on
     the same inputs bitwise equal; K4 also at the engine step's 8 slots
     of 256 tokens), K6-K9 (the
     kernel benchmarks' W4 variants, at their 4096 x 4096 shape with each
     scale/zero dtype pair and at o_proj; K8, K7, K9 and K6 at M <= 16 on the
     DQ, BF, I4 and PL variants of the one-launch kernel, two calls bitwise
     equal and one kernel a call, and each K8, K7, K9 and K6 row timed beside
     the other of its two routes; K6's edges in `k6_edges`), K10-K13 (the
     W4 GEMV experiments of the TPU scripts, at their 4096 x 4096 shape,
     dtypes and knobs: M, Gb, block_m; all four on the one-launch kernel
     (K13 its A8 variant), two calls bitwise equal and one kernel a call;
     K8 and K11, one function, held to TOL_DEQUANT here and in their edges),
     K14-K17 (the int8 probe's narrowing cast and tensor-core
     dots, at its shapes and on its integer inputs, exact; K15 and K17 one
     launch a call, two calls bitwise equal, and timed after a clean flush
     too); then their other branches (f32,
     ragged M, head_dim 64, softcap, window, page sizes, K1/K2 at group
     sizes 1024/2048 and one row-spanning group of 96/320 with f32, f16
     and uint8 scales/zeros, K8 and K11 on fractional zero points where
     a dequant that rounded once would miss TOL_DEQUANT, K9's odd shapes
     on both routes in `i4_edges`, ...) at small shapes, checked and not
     timed;
     then slice 3's path, the ported kernel benchmarks (kernel_bench3 in
     its three modes, kernel_bench4, the kernel-speedup sweep, K9 at the
     benchmarks' shape) with the launch counts reset just before and read
     just after: K1 (on f32 and uint8 scales/zeros) and K6-K9 must run,
     K6, K7, K8 and K9 at every call on the one-launch route;
     then slice 4's path, the ported experiment scripts (kernel_edge_test,
     kernel_dma_pipeline, kernel_tune, kernel_w4a8_exp), counted the same
     way: K10-K13 and their control arms K1, K6 and K8 must run;
     then slice 5's path, the ported int8 probe (kernel_int8_probe: P1-P3
     and the int8-against-bf16 bench), counted the same way: K14-K17 must
     run and every probe pass; then slice 6's path, the ported unpack
     experiments (kernel_unpack_exp), counted the same way: K18-K22 (all six
     entry points) and their control arms K6 and K1 must run, each GEMV
     within TOL_KERNEL of K6, and K19-K22 (BC, MF, PL, WM) on the
     one-launch route at every call. Before the checks, cuobjdump's SASS of the
     probe's library must show IMMA in K16 and in K15's three streaming
     instances (with their 16-byte cp.async, LDGSTS) and HMMA in K17, that
     of the unpack library K18's bulk copies (UBLKCP) in both of its
     instances, with 0 spill bytes in ptxas's lines for K15's and K18's, that of the K1/K2
     library 128-bit loads (LDG.E.128) and 16-byte cp.async (LDGSTS) in all
     16 one-launch instances, that of the experiments' library in all 32
     of K10/K12 and 8 of K13, that of the variants' library in all 8 of K7
     and 16 of K9, that of the a8 library in all 16 of RA8 (with its dp4a,
     IDP.4A), that of the plain library in all 8 of K6's PL, that of the
     output-pair library in all 8 of K19's BC, those of the mul-floor and
     word-mask libraries in all 8 of K20's MF and of K22's WM, and that of the
     dequant library in all 16 of K8/K11 (the same kernel,
     csrc/one_launch.cuh), with 0 spill bytes in ptxas's lines for all 144
     and, in K8/K11's, three bf16x2 operations for each pair
     of nibbles (the dequant's two roundings neither fused nor dropped),
     that of
     the paged
     library HMMA in every tensor-core instance of K4/K5 (bf16 queries over
     bf16 and int8 pools) and that of the flash library HMMA in all 14
     tensor-core instances of K3 (bf16 q/k/v). K3's edges (`flash_edges`):
     T 100 and 192, kv_lens ending inside a tile, a window skipping whole
     tiles, rows with no valid key, a grid of more blocks than SMs, each
     query row held to its own scale. K4/K5's split over pages is checked at its
     edges: maxP 1, slots ending on and inside a split, a window skipping
     whole splits, empty slots beside full ones, f32 queries over int8
     pools. K18-K22 are checked at
     the script's 4096 x 4096 draws (K18 bit for bit, one launch a call,
     two calls bitwise equal, timed after a clean flush too; K19-K22 at M 1, 8
     and 16 beside K6, each row naming its route, `unpack_route`, and the
     other route's time; two calls bitwise equal and one kernel a call on
     the one launch, K20's and K22's outputs bit for bit K21's) and at their
     edges (`unpack_edges`, K20 and K22 bit for bit K21 wherever the three
     take the one launch), K3 at head dims 16,
     32, 96 and 256, K4/K5 at 24, 32 and 256 and K5 at 80 query rows per kv
     head (and timed there at D = 128), and the refusal of head_dim 12;
  3b. the Engine on two small Gemma-class models with random weights
     (`serve_head_dims`): the JAX serve test's config (head_dim 32) and
     the same at head_dim 256 with 16 query heads per kv head and spec_k 4
     (80 rows in a verify window); K3, K4 and K5 must run for each, and
     each greedy request's logprobs stay within TOL_LOGPROB of
     Engine.score_sync;
  4. slice 1's path at full width: Qwen3-0.6B (28 layers, hidden 1024,
     vocab 151936) with random weights from a seeded torch.Generator,
     Hadamard RTN W4 with a W4 lm_head and merged projections, served by
     Generator(quant_mode="auto", attn_mode="flash"): 4 requests of 64 new
     tokens, three greedy and one sampled. Launch counts are reset just
     before and read just after; K1-K3 must have run, every W4A16 K1/K2
     call at M <= 16 must have taken the one-launch route and every a8 one
     (the lm_head) the RA8 route (the same holds in the serve phases). A decode step (launches, device time and
     K1/K2's by route in the `decode_profile` line) and a
     512-token prefill are profiled (`prefill_profile`: K3's calls, once a
     layer, and device time), then a decode step is run under torch's sync
     debug mode, which raises if it
     waits for the device, on this model and on a small Gemma-class one.
     Then the kernel path's teacher-forced logits are held against the
     same model under quant_mode="xla", attn_mode="einsum";
  5. slice 2's path, the same model served by the continuous-batching
     Engine (8 slots, pages of 128, chunked prefill, burst decode, prefix
     caching, prompt-lookup speculation): 12 requests of 16 to 1000 prompt
     tokens (a shared prefix, repetitive prompts, sampled ones, one
     cancelled), then 4 with an int8 KV pool. Launch counts are reset just
     before and read just after; K1-K5 (K1's a8 variant, K4/K5's int8
     variants) must have run, with prefix hits and speculative windows.
     Each greedy request's logprobs are held against one contiguous prefill
     of its prompt and tokens (Engine.score_sync). The paged kernel path's
     teacher-forced logits (prefill, 8 decode steps, a verify window) are
     held against the plain path, two paged decode steps run under sync
     debug mode "error", and one is profiled;
  6. the `kernels` JSON line, then the result line.
It imports nothing of JAX, catches no failure of the port (only a library
yardstick's refusal of a shape, `int_mm_yardstick`), and exits non-zero without
printing a result when CUDA is missing or the package is not beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core rates, H100 SXM
FLUSH_BYTES = 256 << 20  # > the 50 MB L2
KERNEL_REPS, PLAIN_REPS = 30, 5
TOL_KERNEL = 2e-2  # max abs error / max |plain output|; for K4/K5 per query row (slot, w, head)
# K8/K11: max abs error / max |plain output|, plus one bf16 rounding of each
# output (2**-7 |y|) where it is bf16: below what a dequant that rounds once,
# bf16((q - z) s), misses by on the fractional-zero edges (`dequant_edges`
# fails unless it does), far above f32 sums taken in another order (PERF.md §2)
TOL_DEQUANT = 5e-4
DEQUANT_KERNELS = ("rot_w4_matmul_mg", "dma_rot_w4_matmul")
TOL_E2E = 5e-2  # relative Frobenius error of the logits, kernel path vs reference path
TOL_LOGPROB = 0.25  # nats: an engine request's logprobs against a contiguous prefill's
ROT_SRC = "paroquant_tpu_torch/kernels/csrc/rot_w4_matmul.cu"
RA8_SRC = "paroquant_tpu_torch/kernels/csrc/rot_w4_a8.cu"
VARIANTS_SRC = "paroquant_tpu_torch/kernels/csrc/w4_variants.cu"
PLAIN_SRC = "paroquant_tpu_torch/kernels/csrc/w4_plain.cu"
OPAIR_SRC = "paroquant_tpu_torch/kernels/csrc/w4_opair.cu"
MULFLOOR_SRC = "paroquant_tpu_torch/kernels/csrc/w4_mulfloor.cu"
WORDMASK_SRC = "paroquant_tpu_torch/kernels/csrc/w4_wordmask.cu"
DEQUANT_SRC = "paroquant_tpu_torch/kernels/csrc/rot_w4_dequant.cu"
SLICE1_W4 = ("rot_w4_matmul", "merged_rot_w4_matmul")  # the W4 kernels of slices 1 and 2
FLASH_SRC = "paroquant_tpu_torch/kernels/csrc/flash_attention.cu"
PAGED_SRC = "paroquant_tpu_torch/kernels/csrc/paged_attention.cu"
EXPERIMENTS_SRC = "paroquant_tpu_torch/kernels/csrc/w4_experiments.cu"
INT8_SRC = "paroquant_tpu_torch/kernels/csrc/int8_probe.cu"
INT8_PROBE = ("narrow_cast", "int8_dot", "fused_unpack_int8_dot", "bf16_dot")
UNPACK_SRC = "paroquant_tpu_torch/kernels/csrc/unpack_exp.cu"
UNPACK = ("stream_only", "w4_matmul_bitcast", "w4_matmul_mulfloor", "w4_matmul_splitdot_ce",
          "w4_matmul_splitdot", "w4_matmul_i8")


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def median_ms(fn, reps, flush):
    """Median device time of one call of fn: the L2 is flushed first, and a
    spin kernel keeps the device busy while the host enqueues the call, so
    the events time the device work, not the host's Python overhead
    (`paroquant_tpu_torch/utils/profiling.py::kernel_time_ms`)."""
    from paroquant_tpu_torch.utils.profiling import kernel_time_ms

    return kernel_time_ms(fn, reps, flush)


def bound(bytes_moved, ops, kind):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_merged(I, splits, gen, dev, S=128):
    """A merged (P >= 1) quantized layer of group size S with random nibbles
    and an orthogonal-scale rotation, plus its effective bf16 weight [I, O]."""
    import torch

    from paroquant_tpu_torch.ops.packing import pack_w4_tpu

    G, O, P = I // S, sum(splits), len(splits)
    q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
    scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(torch.bfloat16)
    zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(torch.bfloat16)
    rot = (torch.randn(P, G, S, S, generator=gen, device=dev) / S**0.5).to(torch.bfloat16)
    qweight = pack_w4_tpu(q, S)
    wd = ((q.reshape(G, S, O).float() - zeros[:, None].float()) * scales[:, None].float())
    blocks, off = [], 0
    for p, n in enumerate(splits):  # W_eff[g*S+j, o] = sum_i rot[p,g,i,j] wd[g*S+i, o]
        blocks.append(torch.einsum("gij,gio->gjo", rot[p].float(), wd[:, :, off : off + n]))
        off += n
    w_eff = torch.cat(blocks, dim=-1).reshape(I, O).to(torch.bfloat16)
    return rot, qweight, scales, zeros, w_eff


ONE_LAUNCH_ROUTES = ("one_launch", "ra8")  # K1/K2's routes of one kernel a call


def routed(rm, fn):
    """fn()'s output and the route its one K1/K2 call took (route_counts)."""
    before = {k: dict(v) for k, v in rm.route_counts.items()}
    y = fn()
    taken = [(k, r) for k, v in rm.route_counts.items() for r in ("one_launch", "passes", "ra8")
             if v[r] != before[k][r]]
    if len(taken) != 1:
        raise SystemExit(f"expected one K1/K2 call, counted {taken}")
    return y, taken[0][1]


def passes_ms(rm, run, flush):
    """run's median time with K1/K2 sent to the three passes (rot_route
    swapped for the length of the timing): the old route beside the new one
    on the same card in the same run."""
    def route(M, I, S, out_splits, a8, rot_dtype, sms):
        n_tiles = sum(-(-n // rm.COLS_PER_TILE) for n in out_splits)
        KS = rm._group_splits(n_tiles, -(-M // rm.ROWS_PER_TILE), I // S, sms)
        return "passes", KS, rm.COLS_PER_TILE

    real = rm.rot_route
    rm.rot_route = route
    try:
        return median_ms(run, KERNEL_REPS, flush)
    finally:
        rm.rot_route = real


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC")  # the runtime's launch calls


def kernels_per_call(fn):
    """CUDA kernels one warm call of fn launches, on the profiler's count of
    kernels run on the device. Where the profile holds no device activity
    at all (the profiler on the card has been seen to record none for a K10
    call whose output was right), the count of the host's launch calls in
    the same profile stands in for it, and a `profiler_no_device_events`
    line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    n = sum(e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    if n:
        return n
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    emit({"phase": "profiler_no_device_events", "host_launches": launches,
          "events": [[e.key[:60], str(e.device_type), e.count] for e in events]})
    return launches


def check_matmuls(flush, gen, dev):
    """K1/K2 at Qwen3-0.6B's linears, M 1, 8 (the engine step), 16 and 128,
    W4A16 and a8: each row says which route it took (`rot_route`), how many
    kernels one call launched on the profiler's count (the one-launch and
    RA8 routes: 1) and, on those routes at M 1, 8 and 16, that two calls gave
    the same bits and the three passes' time at the same inputs (an RA8 row
    also its plan's tiles a block, `ra8_plan`)."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    shapes = [  # name, kernel, I, splits
        ("o_proj", "rot_w4_matmul", 2048, (1024,)),
        ("down_proj", "rot_w4_matmul", 3072, (1024,)),
        ("lm_head", "rot_w4_matmul", 1024, (151936,)),
        ("qkv_proj", "merged_rot_w4_matmul", 1024, (2048, 1024, 1024)),
        ("gate_up_proj", "merged_rot_w4_matmul", 1024, (3072, 3072)),
    ]
    rows = []
    for layer, kernel, I, splits in shapes:
        rot, qweight, scales, zeros, w_eff = random_merged(I, splits, gen, dev)
        O, P, G = sum(splits), len(splits), I // 128
        for M in (1, 8, 16, 128):
            x = torch.randn(M, I, generator=gen, device=dev).to(torch.bfloat16)
            for a8 in (False, True):
                if kernel == "rot_w4_matmul":
                    run = lambda: rm.rot_w4_matmul(x, rot[0], qweight, scales, zeros, a8=a8)
                    plain = lambda: rm.rot_w4_matmul_plain(x, rot[0], qweight, scales, zeros, a8=a8)
                else:
                    run = lambda: rm.merged_rot_w4_matmul(x, rot, qweight, scales, zeros,
                                                          out_splits=splits, a8=a8)
                    plain = lambda: rm.merged_rot_w4_matmul_plain(
                        x, rot, qweight, scales, zeros, out_splits=splits, a8=a8)
                y, route = routed(rm, run)
                y, y_ref = y.float(), plain().float()
                torch.cuda.synchronize()
                err = (y - y_ref).abs().max().item()
                tol = TOL_KERNEL * y_ref.abs().max().item()
                rel = ((y - y_ref).norm() / y_ref.norm()).item()
                _, KS, tile = rm.rot_route(M, I, 128, splits, a8, rot.dtype, rm._sm_count(x.device))
                same = None
                if route in ONE_LAUNCH_ROUTES:
                    same = torch.equal(run(), run())
                    emit({"phase": "rot_determinism", "layer": layer, "M": M, "KS": KS,
                          "bitwise_equal": same})
                    if not same:
                        raise SystemExit(f"{kernel} {layer} M={M}: two calls on the same inputs differ")
                n_kernels = kernels_per_call(run)
                if route in ONE_LAUNCH_ROUTES and n_kernels != 1:
                    raise SystemExit(f"{kernel} {layer} M={M}: the {route} route ran {n_kernels} kernels")
                ms = median_ms(run, KERNEL_REPS, flush)
                plain_ms = median_ms(plain, PLAIN_REPS, flush)
                lib_ms = median_ms(lambda: torch.matmul(x, w_eff), KERNEL_REPS, flush)
                old_ms = passes_ms(rm, run, flush) if route in ONE_LAUNCH_ROUTES else None
                nbytes = M * I * 2 + P * G * 128 * 128 * 2 + I * O // 2 + 2 * G * O * 2 + M * O * 2
                ops = 2 * M * I * O + 2 * P * M * I * 128
                b_ms, b_by = bound(nbytes, ops, "int8" if a8 else "bf16")
                row = dict(kernel=kernel, layer=layer, M=M, a8=a8, route=route, KS=KS, tile=tile,
                           kernels_per_call=n_kernels, bitwise_equal=same, max_abs_err=err,
                           tol=tol, rel_fro_err=rel, us=ms * 1e3,
                           passes_us=None if old_ms is None else old_ms * 1e3, plain_us=plain_ms * 1e3,
                           tiles_per_block=(rm.ra8_plan(M, I, 128, splits, rm._sm_count(x.device))[4]
                                            if route == "ra8" else None),
                           library_us=lib_ms * 1e3, bound_us=b_ms * 1e3, bound_by=b_by,
                           ok=err <= tol)
                emit({"phase": "kernel_check", **row})
                rows.append(row)
        del rot, qweight, scales, zeros, w_eff
    return rows


def sdpa_mask(T, S, q_offset, window, dev):
    import torch

    qp = q_offset + torch.arange(T, device=dev)[:, None]
    kp = torch.arange(S, device=dev)[None, :]
    m = kp <= qp
    if window:
        m &= kp > qp - window
    return m


def check_flash(flush, gen, dev):
    """K3 at Qwen3-0.6B's prefill (B 1, Hq 16, Hkv 8, D 128, T 512) from
    offset 0, from offset 256 and with a window of 128: each query row
    (batch, head, row) held to its own output's scale, two calls bitwise
    equal; timed beside the plain version, SDPA given the same mask as a
    tensor and, from offset 0, SDPA with is_causal=True and no mask tensor
    (what a user would call)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Hq, Hkv, D, T = 1, 16, 8, 128, 512
    rows = []
    for case, q_off, window in (("q_offset0", 0, None), ("q_offset256", 256, None),
                                ("window128", 0, 128)):
        S = T + q_off
        q = torch.randn(B, Hq, T, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        qo = torch.full((B,), q_off, dtype=torch.int32, device=dev)
        kw = dict(scale=D**-0.5, q_offset=qo, sliding_window=window)
        run = lambda: at.flash_attention(q, k, v, lens, **kw)
        plain = lambda: at.flash_attention_plain(q, k, v, lens, **kw)
        y, y_ref = run().float(), plain().float()
        torch.cuda.synchronize()
        err = (y - y_ref).abs().max().item()
        ratio = row_err_ratio(y, y_ref, 3)
        same = torch.equal(run(), run())  # no atomics: a second call gives the same bits
        emit({"phase": "flash_determinism", "case": case, "bitwise_equal": same})
        if not same:
            raise SystemExit(f"flash_attention {case}: two calls on the same inputs differ")
        mask = sdpa_mask(T, S, q_off, window, dev)
        lib = lambda: sdpa(q, k, v, attn_mask=mask, scale=D**-0.5, enable_gqa=True)
        ms = median_ms(run, KERNEL_REPS, flush)
        plain_ms = median_ms(plain, PLAIN_REPS, flush)
        lib_ms = median_ms(lib, KERNEL_REPS, flush)
        lib_causal_ms = None
        if q_off == 0 and window is None:  # S == T: is_causal's top-left diagonal is this mask
            lib_causal_ms = median_ms(
                lambda: sdpa(q, k, v, is_causal=True, scale=D**-0.5, enable_gqa=True),
                KERNEL_REPS, flush)
        pairs = int(mask.sum().item())  # the (query, key) pairs this input needs
        nbytes = 2 * (2 * B * Hq * T * D + 2 * B * Hkv * S * D)
        ops = 4 * B * Hq * pairs * D
        b_ms, b_by = bound(nbytes, ops, "bf16")
        row = dict(kernel="flash_attention", case=case, T=T, S=S,
                   key_groups=at.flash_key_groups(B, Hq, T, D, dev), max_abs_err=err,
                   row_err_ratio=ratio, tol=TOL_KERNEL, us=ms * 1e3, plain_us=plain_ms * 1e3,
                   library_us=lib_ms * 1e3,
                   library_causal_us=None if lib_causal_ms is None else lib_causal_ms * 1e3,
                   bound_us=b_ms * 1e3, bound_by=b_by,
                   ok=ratio <= TOL_KERNEL and bool(torch.isfinite(y).all()))
        emit({"phase": "kernel_check", **row})
        rows.append(row)
    return rows


def flash_edges(gen, dev, record):
    """K3's other branches at small shapes, f32 (the SIMT kernel) and bf16
    (the tensor-core kernel), each query row held to its own scale: head_dim
    64 with per-row q_offset and kv_lens (causal, softcap, window,
    non-causal) and 16, 32, 96 and 256 (causal, softcap, window); T not a
    multiple of 64 (100) and 192, kv_lens ending inside a tile, a window
    that skips whole tiles, rows with no valid key (all of one batch row,
    and the later rows of another: output 0), and a grid of more blocks
    than SMs (one key group; the small shapes take two)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    def check(case, B, Hq, Hkv, D, T, S, lens, qo, dts=(torch.float32, torch.bfloat16), **kw):
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        qo = torch.tensor(qo, dtype=torch.int32, device=dev)
        for dt in dts:
            q = torch.randn(B, Hq, T, D, generator=gen, device=dev).to(dt)
            k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
            v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
            kw2 = dict(scale=D**-0.5, q_offset=qo, **kw)
            kg = at.flash_key_groups(B, Hq, T, D, dev) if dt == torch.bfloat16 else 0
            groups.add(kg)
            record("flash_attention", f"{case} {dt} D={D} T={T} kg={kg}",
                   at.flash_attention(q, k, v, lens, **kw2),
                   at.flash_attention_plain(q, k, v, lens, **kw2), lead=3)

    groups = set()
    cases = {"causal": {}, "softcap": dict(logit_softcap=20.0), "window": dict(sliding_window=48),
             "not_causal": dict(causal=False)}
    for D in (64, 16, 32, 96, 256):  # 32, 64 and 256 fill their buckets; 16 and 96 do not
        for case, kw in cases.items():
            if D != 64 and case == "not_causal":
                continue
            check(case, 2, 4, 2, D, 128, 256, (192, 256), (64, 128), **kw)
    for D in (64, 128):
        check("T100", 2, 4, 2, D, 100, 128, (100, 128), (0, 28))
        check("T100_not_causal", 2, 4, 2, D, 100, 128, (77, 128), (0, 0), causal=False)
        check("T192", 2, 4, 2, D, 192, 320, (192, 300), (0, 100))
        check("kv_len_mid_tile", 2, 4, 2, D, 128, 256, (77, 200), (0, 100))
        check("window_skips_tiles", 2, 4, 2, D, 128, 512, (512, 428), (384, 300),
              sliding_window=48)
        check("rows_without_keys", 2, 4, 2, D, 128, 256, (0, 100), (0, 64), sliding_window=48)
        check("many_blocks", 2, 16, 8, D, 640, 640, (640, 600), (0, 0), dts=(torch.bfloat16,))
    if not {1, 2} <= groups:
        raise SystemExit(f"K3's edges ran key groups {sorted(groups)}, not both 1 and 2")


SZ_EDGE_DTYPES = ("float32", "bfloat16", "float16", "uint8")


def rot_route_edges(gen, dev, rot_case):
    """K1/K2's one-launch route over the grid `tests/test_torch_rot_w4_route.py`
    holds against JAX: S 64, 128 and 256, and 100 (a bf16 rotation row of
    200 bytes, read element by element); P 1-4 with widths that are not
    multiples of 4 or 16; M 1, 2, 5 and 16 (row tiles of 1, 2 and 8, two of
    8); every scale/zero dtype; x and rot in f32 and bf16; one group (KS 1)
    and three (KS > 1). Then shapes on
    both sides of the route rule's limits: M 16 / 17, S 256 / 512, a8 (RA8
    at M 16, S 256; the passes at M 17, S 512 and S 100), a width that
    fills one wave and one that does not; each row says which route it
    took, and the rule's side must be the one taken."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    def operands(I, splits, S, sz, xdt, rdt):
        rot, qweight, scales, zeros, _ = random_merged(I, splits, gen, dev, S)
        sdt = getattr(torch, sz)
        scales = (scales.float() * 1000).to(sdt) if sdt == torch.uint8 else scales.to(sdt)
        return rot.to(rdt), qweight, scales, zeros.to(sdt)

    dts = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32))
    grid = 0
    for S in (64, 100, 128, 256):
        for splits in ((66,), (66, 62), (128, 96, 160), (64, 34, 48, 78)):
            for n_groups in (1, 3):
                I = n_groups * S
                for j, sz in enumerate(SZ_EDGE_DTYPES):
                    xdt, rdt = dts[(j + n_groups) % 4]
                    rot, qweight, scales, zeros = operands(I, splits, S, sz, xdt, rdt)
                    for M in (1, 2, 5, 16):
                        x = torch.randn(M, I, generator=gen, device=dev).to(xdt)
                        case = f"S={S} P={len(splits)} {splits} G={n_groups} sz={sz} x={xdt} rot={rdt} M={M}"
                        if len(splits) == 1:
                            one = (x, rot[0], qweight, scales, zeros)
                            route = rot_case("rot_w4_matmul", case, lambda: rm.rot_w4_matmul(*one),
                                             lambda: rm.rot_w4_matmul_plain(*one))
                        else:
                            args = (x, rot, qweight, scales, zeros)
                            route = rot_case(
                                "merged_rot_w4_matmul", case,
                                lambda: rm.merged_rot_w4_matmul(*args, out_splits=splits),
                                lambda: rm.merged_rot_w4_matmul_plain(*args, out_splits=splits))
                        if route != "one_launch":
                            raise SystemExit(f"{case}: took {route}, not the one-launch route")
                        grid += 1
    sms = rm._sm_count(torch.device(dev))
    wide = rm.BLOCKS_PER_SM * sms * 128  # O of one wave of 128-column tiles (at 256: half a wave)
    sides = [  # case, M, I, S, splits, a8, expected route
        ("M16", 16, 256, 128, (128, 96), False, "one_launch"),
        ("M17", 17, 256, 128, (128, 96), False, "passes"),
        ("S256", 1, 512, 256, (128, 96), False, "one_launch"),
        ("S512", 1, 1024, 512, (128, 96), False, "passes"),
        ("a8", 1, 256, 128, (128, 96), True, "ra8"),
        ("a8_M17", 17, 256, 128, (128, 96), True, "passes"),
        ("a8_S512", 1, 1024, 512, (128, 96), True, "passes"),
        ("a8_S100", 1, 200, 100, (128, 96), True, "passes"),
        ("one_wave", 1, 128, 128, (wide,), False, "one_launch"),
        ("wider_than_a_wave", 1, 128, 128, (4 * wide + 128,), False, "passes"),
    ]
    for case, M, I, S, splits, a8, want in sides:
        rot, qweight, scales, zeros = operands(I, splits, S, "bfloat16", torch.bfloat16,
                                               torch.bfloat16)
        x = torch.randn(M, I, generator=gen, device=dev).to(torch.bfloat16)
        args = (x, rot, qweight, scales, zeros)
        kw = dict(out_splits=splits, a8=a8)
        route = rot_case("merged_rot_w4_matmul", f"route side {case}",
                         lambda: rm.merged_rot_w4_matmul(*args, **kw),
                         lambda: rm.merged_rot_w4_matmul_plain(*args, **kw))
        if route != want or rm.rot_route(M, I, S, splits, a8, rot.dtype, sms)[0] != want:
            raise SystemExit(f"route side {case}: took {route}, the rule says {want}")
    emit({"phase": "rot_route_edges", "grid_cases": grid, "side_cases": len(sides)})


def ra8_edges(gen, dev, record):
    """K1/K2's a8 on the RA8 variant at its edges, each call's route checked
    and held to TOL_KERNEL against the plain version: the 151936-wide lm_head
    (its last tile 384 columns wide) at every M from 1 to 16 with an
    all-zero row (sx = 1, output exactly 0); S 64 and 256; P 2-4 with
    widths that are not multiples of 16 or 512, in runs of two and three
    tiles forced past the plan, with splits of uneven groups; x and rot in
    f32 and bf16 and each scale/zero dtype."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.ops.packing import pack_w4_tpu

    def operands(I, splits, S, sz, rdt):
        G, O, P = I // S, sum(splits), len(splits)
        q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
        sdt = getattr(torch, sz)
        scales = (torch.randint(1, 4, (G, O), generator=gen, device=dev) if sdt == torch.uint8
                  else torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(sdt)
        zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(sdt)
        rot = (torch.randn(P, G, S, S, generator=gen, device=dev) / S**0.5).to(rdt)
        return rot, pack_w4_tpu(q, S), scales, zeros

    sms = rm._sm_count(torch.device(dev))
    rot, qw, s, z = operands(1024, (151936,), 128, "bfloat16", torch.bfloat16)
    for M in range(1, 17):
        x = torch.randn(M, 1024, generator=gen, device=dev).to(torch.bfloat16)
        zero = M // 2 if M > 1 else None  # at M 1 an all-zero x alone, below
        if zero is not None:
            x[zero] = 0
        one = (x, rot[0], qw, s, z)
        y, route = routed(rm, lambda: rm.rot_w4_matmul(*one, a8=True))
        record("rot_w4_matmul", f"RA8 lm_head M={M} zero row {zero} ({route})", y,
               rm.rot_w4_matmul_plain(*one, a8=True))
        if zero is None:
            y0, route0 = routed(rm, lambda: rm.rot_w4_matmul(torch.zeros_like(x), rot[0], qw, s, z, a8=True))
            zero_out = not bool(y0.any()) and route0 == "ra8"
        else:
            zero_out = not bool(y[zero].any())
        if route != "ra8" or not zero_out:
            raise SystemExit(f"RA8 lm_head M={M}: took {route}, or the zero row is not 0")
    del rot, qw, s, z
    f32, bf = torch.float32, torch.bfloat16
    cases = [  # S, G, splits, scale/zero dtype, x dtype, rot dtype
        (64, 5, (66, 62), "float32", f32, f32),
        (256, 3, (128, 96, 160), "float16", bf, bf),
        (128, 7, (1000, 34, 530, 78), "uint8", bf, f32),
        (64, 9, (1536, 1030), "bfloat16", f32, bf),
    ]
    for S, G, splits, sz, xdt, rdt in cases:
        rot, qw, s, z = operands(G * S, splits, S, sz, rdt)
        for M in (1, 2, 5, 9, 16):
            x = torch.randn(M, G * S, generator=gen, device=dev).to(xdt)
            args = (x, rot, qw, s, z)
            plain = rm.merged_rot_w4_matmul_plain(*args, out_splits=splits, a8=True)
            case = f"RA8 S={S} G={G} {splits} sz={sz} x={xdt} rot={rdt} M={M}"
            y, route = routed(rm, lambda: rm.merged_rot_w4_matmul(*args, out_splits=splits, a8=True))
            if route != "ra8":
                raise SystemExit(f"{case}: took {route}")
            record("merged_rot_w4_matmul", case, y, plain)
            for gps in (1, 2):  # forced past the plan: runs of 2 and 3 tiles, uneven splits
                for tpb in (2, 3):
                    KS, tile, mt, _, _ = rm.ra8_plan(M, G * S, S, splits, sms, gps=gps)
                    plan = (KS, tile, mt, -(-G // KS), tpb)
                    record("merged_rot_w4_matmul", f"{case} KS={KS} runs of {tpb}",
                           rm.launch_ra8(x, rot, qw, s, z, splits, plan), plain)


def k6_edges(gen, dev, record):
    """K6 on its PL variant at every M from 1 to 16 with each of the four
    scale/zero dtypes, at a width that is not a multiple of 16 and one group
    spanning 96 channels, each call's route checked against `w4_route`."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.ops.packing import pack_w4_tpu

    sms = rm._sm_count(torch.device(dev))
    for I, O, S in ((512, 130, 128), (384, 160, 96)):
        G = I // S
        q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
        qw = pack_w4_tpu(q, S)
        for sz in SZ_EDGE_DTYPES:
            sdt = getattr(torch, sz)
            scales = (torch.randint(1, 4, (G, O), generator=gen, device=dev) if sdt == torch.uint8
                      else torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(sdt)
            zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(sdt)
            for M in range(1, 17):
                x = torch.randn(M, I, generator=gen, device=dev).to(
                    torch.bfloat16 if M % 2 else torch.float32)
                y, taken = one_routed(rm, "w4_matmul",
                                      lambda: rm.w4_matmul(x, qw, scales, zeros, group_size=S))
                if taken != "one_launch" or rm.w4_route(M, I, S, O, sms)[0] != taken:
                    raise SystemExit(f"w4_matmul I={I} O={O} M={M}: took {taken}")
                record("w4_matmul", f"PL I={I} O={O} S={S} sz={sz} M={M} x={x.dtype}", y,
                       rm.w4_matmul_plain(x, qw, scales, zeros, group_size=S))


def check_edges(gen, dev):
    """The kernels' other branches at small shapes, checked and not timed:
    f32 activations and rotations, ragged M, uneven partitions, group sizes
    256 to 512; K3's edges (`flash_edges`); and the other kernels' edges."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    rows = []

    def record(name, case, y, y_ref, lead=None):
        """lead: hold each query row (the first `lead` dims) to its own scale;
        K8 and K11 are held to TOL_DEQUANT."""
        ratio = dequant_err_over_tol(y, y_ref) if name in DEQUANT_KERNELS else None
        y, y_ref = y.float(), y_ref.float()
        err = (y - y_ref).abs().max().item()
        if ratio is not None:
            rows.append(dict(kernel=name, case=case, max_abs_err=err,
                             tol=TOL_DEQUANT * y_ref.abs().max().item(), err_over_tol=ratio,
                             ok=ratio <= 1))
        elif lead is None:
            tol = TOL_KERNEL * y_ref.abs().max().item()
            rows.append(dict(kernel=name, case=case, max_abs_err=err, tol=tol,
                             err_over_tol=err / tol, ok=err <= tol))
        else:
            ratio = row_err_ratio(y, y_ref, lead)
            rows.append(dict(kernel=name, case=case, max_abs_err=err, row_err_ratio=ratio,
                             tol=TOL_KERNEL, err_over_tol=ratio / TOL_KERNEL,
                             ok=ratio <= TOL_KERNEL))

    def record_exact(name, case, y, y_ref):
        """The integer kernels: bit for bit, tolerance 0."""
        err = (y.double() - y_ref.double()).abs().max().item()
        ok = err == 0 and y.dtype == y_ref.dtype and y.shape == y_ref.shape
        rows.append(dict(kernel=name, case=case, max_abs_err=err, tol=0.0,
                         err_over_tol=0.0 if ok else float("inf"), ok=ok))

    def rot_case(name, case, fn, plain):
        y, route = routed(rm, fn)
        record(name, case, y, plain())
        rows[-1]["route"] = route
        return route

    splits = (128, 96, 160)
    rot, qweight, scales, zeros, _ = random_merged(256, splits, gen, dev)
    for xdt, rdt in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                     (torch.bfloat16, torch.float32)):
        r = rot.to(rdt)
        for M in (3, 17):
            x = torch.randn(M, 256, generator=gen, device=dev).to(xdt)
            for a8 in (False, True):
                case = f"x={xdt} rot={rdt} M={M} a8={a8}"
                one = (x, r[0], qweight[:, :128], scales[:, :128], zeros[:, :128])
                rot_case("rot_w4_matmul", case, lambda: rm.rot_w4_matmul(*one, a8=a8),
                         lambda: rm.rot_w4_matmul_plain(*one, a8=a8))
                kw = dict(out_splits=splits, a8=a8)
                rot_case("merged_rot_w4_matmul", case,
                         lambda: rm.merged_rot_w4_matmul(x, r, qweight, scales, zeros, **kw),
                         lambda: rm.merged_rot_w4_matmul_plain(x, r, qweight, scales, zeros, **kw))
    for S in (256, 384, 512):  # two groups each, so the groups split across blocks too
        rot, qweight, scales, zeros, _ = random_merged(2 * S, splits, gen, dev, S)
        for M in (1, 9):
            x = torch.randn(M, 2 * S, generator=gen, device=dev).to(torch.bfloat16)
            for a8 in (False, True):
                case = f"S={S} M={M} a8={a8}"
                one = (x, rot[0], qweight[:, :128], scales[:, :128], zeros[:, :128])
                rot_case("rot_w4_matmul", case, lambda: rm.rot_w4_matmul(*one, a8=a8),
                         lambda: rm.rot_w4_matmul_plain(*one, a8=a8))
                kw = dict(out_splits=splits, a8=a8)
                rot_case("merged_rot_w4_matmul", case,
                         lambda: rm.merged_rot_w4_matmul(x, rot, qweight, scales, zeros, **kw),
                         lambda: rm.merged_rot_w4_matmul_plain(x, rot, qweight, scales, zeros, **kw))
    rot_route_edges(gen, dev, rot_case)
    ra8_edges(gen, dev, record)
    k6_edges(gen, dev, record)

    flash_edges(gen, dev, record)
    head_dim_refusals(gen, dev)
    paged_edges(gen, dev, record)
    w4_edges(gen, dev, record)
    i4_edges(gen, dev, record)
    w4x_edges(gen, dev, record)
    dequant_edges(gen, dev, record)
    int8_edges(gen, dev, record, record_exact)
    unpack_edges(gen, dev, record, record_exact)
    torch.cuda.synchronize()
    worst = max(rows, key=lambda r: r["err_over_tol"])
    by_kernel = {}
    for r in rows:
        by_kernel[r["kernel"]] = max(by_kernel.get(r["kernel"], 0.0), r["err_over_tol"])
    emit({"phase": "kernel_edges", "cases": len(rows), "worst_err_over_tol": worst["err_over_tol"],
          "worst": {k: worst[k] for k in ("kernel", "case")}, "worst_by_kernel": by_kernel,
          "failed": [r for r in rows if not r["ok"]]})
    return rows


# ---------------------------------------------------------------------------
# phase 3c: the W4 variants of the kernel benchmarks (K6-K9)
# ---------------------------------------------------------------------------

W4_VARIANTS = ("w4_matmul", "butterfly_w4_matmul", "rot_w4_matmul_mg", "rot_w4_matmul_i4")
SZ_DTYPES = {"bf16/bf16": ("bfloat16", "bfloat16"), "bf16/u8": ("bfloat16", "uint8"),
             "f32/f32": ("float32", "float32")}


def w4_variant_inputs(kernel, I, O, gen, dev, S=128, K=8, sz="bf16/bf16", shift_tables=False):
    """Random operands of one W4 variant at group size S: (call, plain, the
    rotation map as a function of x [n, I] -> [n, I] f32 (None for K6), the
    dequantized weight [I, O] f32, the bytes the call must move beyond x and
    out, and the extra operations of its rotation per row). shift_tables:
    K7's tables start 4 bytes past a 16-byte boundary."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.ops.butterfly import butterfly_tables
    from paroquant_tpu_torch.ops.packing import pack_w4_i4, pack_w4_tpu

    G = I // S
    sdt, zdt = (getattr(torch, n) for n in SZ_DTYPES[sz])
    q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
    scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(sdt)
    zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(zdt)
    wd = ((q.reshape(G, S, O).float() - zeros[:, None].float()) * scales[:, None].float()).reshape(I, O)
    extra = I * O // 2 + G * O * (scales.element_size() + zeros.element_size())
    if kernel == "w4_matmul":
        qw = pack_w4_tpu(q, S)
        return (lambda x: rm.w4_matmul(x, qw, scales, zeros, group_size=S),
                lambda x: rm.w4_matmul_plain(x, qw, scales, zeros, group_size=S),
                None, wd, extra, 0)
    if kernel == "butterfly_w4_matmul":
        qw = pack_w4_tpu(q, S)
        inv_s = torch.rand(I, generator=gen, device=dev) * 1.5 + 0.5
        theta = torch.randn(K, I // 2, generator=gen, device=dev) * 0.3
        cos_t, sin_t = (torch.from_numpy(a).to(dev) for a in butterfly_tables(theta.cpu().numpy(), S))
        if shift_tables:
            inv_s, cos_t, sin_t = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                                   for t in (inv_s, cos_t, sin_t))
        args = (inv_s, cos_t, sin_t, qw, scales, zeros)
        return (lambda x: rm.butterfly_w4_matmul(x, *args, group_size=S),
                lambda x: rm.butterfly_w4_matmul_plain(x, *args, group_size=S),
                lambda x: rm.butterfly_rotate_plain(x, inv_s, cos_t, sin_t, S).reshape(x.shape[0], I),
                wd, extra + I * 4 + 2 * K * I * 4, 6 * I * K)
    rot = (torch.randn(G, S, S, generator=gen, device=dev) / S**0.5).to(torch.bfloat16)
    rotate = lambda x: torch.einsum("mgj,gij->mgi", x.float().reshape(-1, G, S),
                                    rot.float()).reshape(x.shape[0], I)
    extra += G * S * S * 2
    if kernel == "rot_w4_matmul_mg":
        qw = pack_w4_tpu(q, S)
        return (lambda x: rm.rot_w4_matmul_mg(x, rot, qw, scales, zeros),
                lambda x: rm.rot_w4_matmul_mg_plain(x, rot, qw, scales, zeros),
                rotate, wd, extra, 2 * I * S)
    qw = pack_w4_i4(q)
    return (lambda x: rm.rot_w4_matmul_i4(x, rot, qw, scales, zeros),
            lambda x: rm.rot_w4_matmul_i4_plain(x, rot, qw, scales, zeros),
            rotate, wd, extra, 2 * I * S)


def effective_weight(rotate, wd, I, dev):
    """The pre-rotated bf16 weight [I, O] of the library yardstick: x @ it
    is rotate(x) @ wd."""
    import torch

    if rotate is None:
        return wd.to(torch.bfloat16)
    return (rotate(torch.eye(I, device=dev)) @ wd).to(torch.bfloat16)


# the kernels whose one-launch variant a route rule picks: the rule, its counts
ROUTE_RULES = {"rot_w4_matmul_mg": ("mg_route", "mg_route_counts"),
               "butterfly_w4_matmul": ("bf_route", "bf_route_counts"),
               "rot_w4_matmul_i4": ("i4_route", "i4_route_counts"),
               "w4_matmul": ("w4_route", "w4_route_counts")}


def route_of(rm, kernel, M, I, O, sms, S=128):
    """The route rule's (route, plan) for K8 (chunks of K8's default 16
    groups a step), K7 (8 stages), K9 or K6 at group size S."""
    if kernel == "rot_w4_matmul_mg":
        return rm.mg_route(M, I, S, O, rm.mg_chunk(I // S, 16), sms)
    if kernel == "butterfly_w4_matmul":
        return rm.bf_route(M, I, S, O, 8, sms)
    if kernel == "w4_matmul":
        return rm.w4_route(M, I, S, O, sms)
    return rm.i4_route(M, I, S, O, sms)


def one_routed(rm, kernel, fn):
    """fn()'s output and the route its one call of K8, K7, K9 or K6 took
    (their route counts)."""
    counts = getattr(rm, ROUTE_RULES[kernel][1])
    before = dict(counts)
    y = fn()
    taken = [r for r, n in counts.items() if n != before[r]]
    if len(taken) != 1:
        raise SystemExit(f"expected one {kernel} call, counted {taken}")
    return y, taken[0]


def other_route_ms(rm, kernel, run, flush, taken):
    """run's median time with K8, K7, K9 or K6 sent to the route it did not
    take (mg_route, bf_route, i4_route or w4_route swapped for the length of
    the timing): both routes on the same card in the same run, for the
    choice the rule makes."""
    rule = ROUTE_RULES[kernel][0]

    def route(M, I, S, O, *rest):  # rest: K8's chunk or K7's stages (none for K9, K6), the SM count
        sms = rest[-1]
        if taken == "one_launch":
            return "passes", None
        if rule == "mg_route":
            return "one_launch", rm.dq_plan(M, I, S, O, sms, rest[0])
        if rule == "bf_route":
            return "one_launch", rm.dq_plan(M, I, S, O, sms, I // S,
                                            group_floats=S * (2 * rest[0] + 1))
        if rule == "w4_route":
            return "one_launch", rm.w4_plan(M, I, S, O, sms)
        return "one_launch", rm.i4_plan(M, I, S, O, sms)

    real = getattr(rm, rule)
    setattr(rm, rule, route)
    try:
        return median_ms(run, KERNEL_REPS, flush)
    finally:
        setattr(rm, rule, real)


def check_w4_variants(flush, gen, dev):
    """K6-K9 against their plain versions at the benchmarks' shape (4096 x
    4096, g128, K = 8) with each scale/zero dtype pair of the callers
    (bf16/bf16, bf16/uint8, f32/f32; K8 rounds them to bf16), and at
    Qwen3-0.6B's o_proj (2048 -> 1024), M = 1, 16, 128 (K8 also 17 and
    33, K9 8 and 17, K6 8), timed beside the bound and torch.matmul on the
    pre-rotated, dequantized bf16 weight. Each K8, K7, K9 and K6 row names its
    route (`mg_route`, `bf_route`, `i4_route`, `w4_route`) and the other route's time at
    the same inputs (K8 is held to TOL_DEQUANT); on the one-launch route it
    names its plan and fails unless two calls give the same bits and a call
    launches one kernel (profiler)."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    shapes = [("bench", 4096, 4096, sz) for sz in SZ_DTYPES] + [("o_proj", 2048, 1024, "bf16/bf16")]
    rows = []
    for kernel in W4_VARIANTS:
        mg = kernel == "rot_w4_matmul_mg"
        rule = kernel in ROUTE_RULES
        for layer, I, O, sz in shapes:
            if mg and sz != "bf16/bf16":
                continue
            run, plain, rotate, wd, extra, rot_ops = w4_variant_inputs(kernel, I, O, gen, dev, sz=sz)
            w_eff = effective_weight(rotate, wd, I, dev)
            Ms = ((1, 16, 17, 33, 128) if mg else (1, 8, 16, 17, 128) if kernel == "rot_w4_matmul_i4"
                  else (1, 8, 16, 128) if kernel == "w4_matmul" else (1, 16, 128))
            for M in Ms:
                x = torch.randn(M, I, generator=gen, device=dev).to(torch.bfloat16)
                route = {}
                if rule:
                    y, taken = one_routed(rm, kernel, lambda: run(x))
                    route = dict(route=taken, other_route_us=None)
                    if taken == "one_launch":
                        KS, tile, rows_per_block, gps = route_of(rm, kernel, M, I, O,
                                                                 rm._sm_count(dev))[1]
                        route.update(KS=KS, tile=tile, rows_per_block=rows_per_block,
                                     groups_per_split=gps, bitwise_equal=torch.equal(run(x), run(x)),
                                     kernels_per_call=kernels_per_call(lambda: run(x)))
                        emit({"phase": ROUTE_RULES[kernel][0][:2] + "_determinism",
                              "layer": layer, "sz": sz, "M": M, **route})
                        if not route["bitwise_equal"] or route["kernels_per_call"] != 1:
                            raise SystemExit(f"{kernel} {layer} M={M}: two calls differ or "
                                             f"a call ran {route['kernels_per_call']} kernels")
                else:
                    y = run(x)
                y_ref = plain(x)
                torch.cuda.synchronize()
                err = (y.float() - y_ref.float()).abs().max().item()
                scale = y_ref.float().abs().max().item()
                ratio = dequant_err_over_tol(y, y_ref) if mg else err / (TOL_KERNEL * scale)
                tol = (TOL_DEQUANT if mg else TOL_KERNEL) * scale
                ms = median_ms(lambda: run(x), KERNEL_REPS, flush)
                if rule:
                    route["other_route_us"] = other_route_ms(rm, kernel, lambda: run(x), flush,
                                                             route["route"]) * 1e3
                plain_ms = median_ms(lambda: plain(x), PLAIN_REPS, flush)
                lib_ms = median_ms(lambda: torch.matmul(x, w_eff), KERNEL_REPS, flush)
                b_ms, b_by = bound(extra + M * I * 2 + M * O * 2, 2 * M * I * O + M * rot_ops, "bf16")
                row = dict(kernel=kernel, layer=layer, sz=sz, M=M, **route, max_abs_err=err, tol=tol,
                           err_over_tol=ratio, us=ms * 1e3, plain_us=plain_ms * 1e3,
                           library_us=lib_ms * 1e3, bound_us=b_ms * 1e3, bound_by=b_by,
                           ok=ratio <= 1)
                emit({"phase": "kernel_check", **row})
                rows.append(row)
            del run, plain, rotate, wd, w_eff
    return rows


def w4_edges(gen, dev, record):
    """K6-K9 at small shapes (ragged M, f32 x, K = 1..8 stages, a partial last
    block of groups, group sizes 256 and 512, a width that is not a multiple
    of 4) and K1/K2 at the layouts beyond 128-512: S = 1024 and 2048 with one
    and two groups, one row-spanning group of 96 and of 320 channels, with
    f32, f16 and uint8 scales and zeros, P = 2, a8 on and off."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    def check(kernel, case, I, O, S=128, K=8, sz="bf16/bf16", Ms=(5, 17, 33), xdt=torch.bfloat16,
              **kw):
        run, plain, _, _, _, _ = w4_variant_inputs(kernel, I, O, gen, dev, S=S, K=K, sz=sz, **kw)
        for M in Ms:
            x = torch.randn(M, I, generator=gen, device=dev).to(xdt)
            record(kernel, f"{case} M={M} x={xdt}", run(x), plain(x))

    for kernel in W4_VARIANTS:
        check(kernel, "ragged", 256, 160)
        check(kernel, "f32 x", 256, 160, Ms=(1, 17), xdt=torch.float32)
        for S in (256, 512):
            check(kernel, f"S={S}", 2 * S, 128, S=S, Ms=(1, 9))
        check(kernel, "f32/f32 O=130", 256, 130, sz="f32/f32", Ms=(3,))
    for K in (1, 2, 4, 8):
        check("butterfly_w4_matmul", f"K={K}", 256, 128, K=K, Ms=(1, 9))
    check("butterfly_w4_matmul", "K=16 S=512", 2048, 160, S=512, K=16, Ms=(1, 16))
    # K7's tables at no 16-byte boundary: the BF variant copies them element by element
    check("butterfly_w4_matmul", "tables off 16-byte alignment", 256, 128, Ms=(3,),
          shift_tables=True)
    check("rot_w4_matmul_mg", "G=20 gps=16", 20 * 128, 128, Ms=(1, 9))
    # both sides of mg_route's, bf_route's and i4_route's cut at two widths:
    # the route taken must be the rule's, the one-launch variant at M 16 and
    # the passes at M 17
    sms = rm._sm_count(torch.device(dev))
    for kernel in ROUTE_RULES:
        for O in (1024, 160):
            run, plain, *_ = w4_variant_inputs(kernel, 20 * 128, O, gen, dev)
            routes = []
            for M in (rm.ONE_LAUNCH_MAX_M, rm.ONE_LAUNCH_MAX_M + 1):
                x = torch.randn(M, 20 * 128, generator=gen, device=dev).to(torch.bfloat16)
                y, taken = one_routed(rm, kernel, lambda: run(x))
                want = route_of(rm, kernel, M, 20 * 128, O, sms)[0]
                if taken != want:
                    raise SystemExit(f"{kernel} O={O} M={M}: took {taken}, the rule says {want}")
                record(kernel, f"route side O={O} M={M} ({taken})", y, plain(x))
                routes.append(taken)
            if routes != ["one_launch", "passes"]:
                raise SystemExit(f"{kernel} O={O}: M 16 / 17 took {routes}")

    for S, G in ((1024, 1), (1024, 2), (2048, 1), (2048, 2), (96, 1), (320, 1)):
        splits = (128, 96) if S >= 128 else (66, 62)
        rot, qweight, scales, zeros, _ = random_merged(G * S, splits, gen, dev, S)
        for sdt, zdt in ((torch.float32, torch.float32), (torch.float16, torch.uint8)):
            s, z = scales.to(sdt), zeros.to(zdt)
            x = torch.randn(5, G * S, generator=gen, device=dev).to(torch.bfloat16)
            for a8 in (False, True):
                case = f"S={S} G={G} s/z={sdt}/{zdt} a8={a8}"
                one = (x, rot[0], qweight[:, :splits[0]], s[:, :splits[0]], z[:, :splits[0]])
                record("rot_w4_matmul", case, rm.rot_w4_matmul(*one, a8=a8),
                       rm.rot_w4_matmul_plain(*one, a8=a8))
                record("merged_rot_w4_matmul", case,
                       rm.merged_rot_w4_matmul(x, rot, qweight, s, z, out_splits=splits, a8=a8),
                       rm.merged_rot_w4_matmul_plain(x, rot, qweight, s, z, out_splits=splits,
                                                     a8=a8))


def i4_edges(gen, dev, record):
    """K9's odd shapes on both routes: S 40 (not a multiple of 8) with a
    ragged last split (the plan forced to three splits of three groups of
    seven), S 96 and 256, O 130 and 160 (the byte-wise weight ring where
    O is not a multiple of 16), a qweight 4 bytes past a 16-byte boundary,
    scales and zeros in each of the four dtypes, rot in f32 and bf16, x in
    f32 and bf16; M 1, 5 and 16 on the one launch and 17 on the passes
    (each call's route checked against `i4_route`)."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.ops.packing import pack_w4_i4

    sms = rm._sm_count(torch.device(dev))
    f32, bf, f16, u8 = torch.float32, torch.bfloat16, torch.float16, torch.uint8
    for I, O, S, sdt, zdt, rdt, xdt in ((280, 160, 40, bf, u8, bf, bf),
                                        (256, 130, 128, f32, f32, f32, bf),
                                        (512, 160, 256, f16, u8, bf, f32),
                                        (768, 128, 96, bf, bf, f32, f32)):
        G = I // S
        q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
        scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(sdt)
        zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(zdt)
        rot = (torch.randn(G, S, S, generator=gen, device=dev) / S**0.5).to(rdt)
        qw = pack_w4_i4(q)
        flat = torch.empty(qw.numel() + 4, dtype=u8, device=dev)
        flat[4:] = qw.flatten()
        shifted = flat[4:].view(qw.shape)  # 4-byte aligned, not 16
        case = f"I={I} O={O} S={S} s/z={sdt}/{zdt} rot={rdt} x={xdt}"
        for M in (1, 5, 16, 17):
            x = torch.randn(M, I, generator=gen, device=dev).to(xdt)
            plain = rm.rot_w4_matmul_i4_plain(x, rot, qw, scales, zeros)
            for w, where in ((qw, ""), (shifted, " qweight off 16 bytes")):
                y, taken = one_routed(rm, "rot_w4_matmul_i4",
                                      lambda: rm.rot_w4_matmul_i4(x, rot, w, scales, zeros))
                if taken != rm.i4_route(M, I, S, O, sms)[0]:
                    raise SystemExit(f"rot_w4_matmul_i4 {case} M={M}: took {taken}")
                record("rot_w4_matmul_i4", f"{case} M={M}{where} ({taken})", y, plain)
            if S == 40 and M <= rm.ONE_LAUNCH_MAX_M:  # splits of 3, 3 and 1 groups
                _, tile, mt, _ = rm.i4_plan(M, I, S, O, sms)
                record("rot_w4_matmul_i4", f"{case} M={M} 3 splits, the last ragged",
                       rm.launch_i4(x, rot, qw, scales, zeros, (3, tile, mt, 3)), plain)


# ---------------------------------------------------------------------------
# phase 3d: the W4 GEMV experiments of the TPU scripts (K10-K13)
# ---------------------------------------------------------------------------

W4_EXPERIMENTS = ("rot_w4_matmul_b", "dma_rot_w4_matmul", "rot_w4_matmul_v2", "w4a8_matmul")
W4X_SZ = {**SZ_DTYPES, "f16/u8": ("float16", "uint8")}
W4X_CASES = [  # kernel, scales/zeros dtypes (the scripts'), knobs, Ms
    ("rot_w4_matmul_b", "bf16/bf16", {}, (1, 16)),
    *(("dma_rot_w4_matmul", "f32/f32", {"Gb": gb}, (1,)) for gb in (1, 2, 4, 8)),
    *(("rot_w4_matmul_v2", "f32/f32", {"block_m": bm}, (1, 16)) for bm in (8, 16)),
    ("w4a8_matmul", "bf16/u8", {}, (1, 8, 32)),
    ("rot_w4_matmul", "bf16/bf16", {}, (1, 16)),  # K1, K10's control arm ("variant a")
]


def w4x_inputs(kernel, I, O, gen, dev, S=128, sz="bf16/bf16", rot_dtype=None, block_m=None, Gb=4):
    """Random operands of one of K10-K13 (or K1, their control arm) at group
    size S: (call, plain, the rotation map x [n, I] -> [n, I] f32 (None for
    K13), the dequantized weight [I, O] f32, the bytes the call must move
    beyond x and out, and the extra operations of its rotation per row)."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm, w4_experiments as wx
    from paroquant_tpu_torch.ops.packing import pack_w4_tpu

    G = I // S
    sdt, zdt = (getattr(torch, n) for n in W4X_SZ[sz])
    q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
    qw = pack_w4_tpu(q, S)
    scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(sdt)
    zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(zdt)
    wd = ((q.reshape(G, S, O).float() - zeros[:, None].float()) * scales[:, None].float()).reshape(I, O)
    extra = I * O // 2 + G * O * (scales.element_size() + zeros.element_size())
    if kernel == "w4a8_matmul":
        return (lambda x: wx.w4a8_matmul(x, qw, scales, zeros, group_size=S),
                lambda x: wx.w4a8_matmul_plain(x, qw, scales, zeros, group_size=S), None, wd, extra, 0)
    rot = (torch.randn(G, S, S, generator=gen, device=dev) / S**0.5).to(rot_dtype or torch.bfloat16)
    rotate = lambda x: torch.einsum("mgj,gij->mgi", x.float().reshape(-1, G, S),
                                    rot.float()).reshape(x.shape[0], I)
    ops = (rot, qw, scales, zeros)
    run, plain = {
        "rot_w4_matmul_b": (lambda x: wx.rot_w4_matmul_b(x, *ops, block_m=block_m or 16),
                            lambda x: wx.rot_w4_matmul_b_plain(x, *ops)),
        "dma_rot_w4_matmul": (lambda x: wx.dma_rot_w4_matmul(x, *ops, Gb=Gb),
                              lambda x: wx.dma_rot_w4_matmul_plain(x, *ops, Gb=Gb)),
        "rot_w4_matmul_v2": (lambda x: wx.rot_w4_matmul_v2(x, *ops, block_m=block_m or 8),
                             lambda x: wx.rot_w4_matmul_v2_plain(x, *ops)),
        "rot_w4_matmul": (lambda x: rm.rot_w4_matmul(x, *ops),
                          lambda x: rm.rot_w4_matmul_plain(x, *ops)),
    }[kernel]
    return run, plain, rotate, wd, extra + G * S * S * rot.element_size(), 2 * I * S


# K10/K12/K11/K13: the one-launch kernel's variants (K11: DQ; K13: A8)
ONE_LAUNCH_W4X = ("rot_w4_matmul_b", "rot_w4_matmul_v2", "dma_rot_w4_matmul", "w4a8_matmul")


def check_w4_experiments(flush, gen, dev):
    """K10-K13 against their plain versions at the scripts' shape (4096 x
    4096, g128) and dtypes: K10 at M = 1 and 16, K11 at M = 1 with Gb = 1, 2,
    4, 8, K12 at block_m 8 and 16 with M = 1 and 16, K13 at M = 1, 8, 32,
    and K1, K10's control arm, at M = 1 and 16; timed beside the bound and
    torch.matmul on the pre-rotated (K10-K12, K1), dequantized bf16 weight. Each row names its launch plan (splits, tile,
    rows a block; K11 groups a split), and fails unless two calls give the
    same bits and a call launches one kernel (profiler); K11's rows are
    held to TOL_DEQUANT."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm, w4_experiments as wx

    I = O = 4096
    rows = []
    for kernel, sz, knobs, Ms in W4X_CASES:
        run, plain, rotate, wd, extra, rot_ops = w4x_inputs(kernel, I, O, gen, dev, sz=sz, **knobs)
        w_eff = effective_weight(rotate, wd, I, dev)
        out_bytes = 4 if kernel == "rot_w4_matmul_v2" else 2  # K12 returns float32
        for M in Ms:
            x = torch.randn(M, I, generator=gen, device=dev).to(torch.bfloat16)
            y, y_ref = run(x), plain(x)
            torch.cuda.synchronize()
            dq = kernel in DEQUANT_KERNELS
            ratio = dequant_err_over_tol(y, y_ref) if dq else None
            y, y_ref = y.float(), y_ref.float()
            err = (y - y_ref).abs().max().item()
            tol = (TOL_DEQUANT if dq else TOL_KERNEL) * y_ref.abs().max().item()
            ratio = err / tol if ratio is None else ratio
            one = {}
            if kernel in ONE_LAUNCH_W4X:
                sms = rm._sm_count(dev)
                if kernel == "dma_rot_w4_matmul":
                    KS, tile, rows_per_block, gps = rm.dq_plan(M, I, 128, O, sms, knobs["Gb"])
                    one = dict(groups_per_split=gps)
                elif kernel == "w4a8_matmul":
                    KS, tile, rows_per_block = wx.a8_plan(M, I, 128, O, sms)
                else:
                    KS, tile, rows_per_block = wx.one_launch_plan(M, I, 128, O, sms)
                one.update(KS=KS, tile=tile, rows_per_block=rows_per_block,
                           bitwise_equal=torch.equal(run(x), run(x)),
                           kernels_per_call=kernels_per_call(lambda: run(x)))
                emit({"phase": "w4x_determinism", "kernel": kernel, "M": M, **knobs, **one})
                if not one["bitwise_equal"] or one["kernels_per_call"] != 1:
                    raise SystemExit(f"{kernel} M={M} {knobs}: two calls differ or a call ran "
                                     f"{one['kernels_per_call']} kernels")
            ms = median_ms(lambda: run(x), KERNEL_REPS, flush)
            plain_ms = median_ms(lambda: plain(x), PLAIN_REPS, flush)
            lib_ms = median_ms(lambda: torch.matmul(x, w_eff), KERNEL_REPS, flush)
            b_ms, b_by = bound(extra + M * I * 2 + M * O * out_bytes, 2 * M * I * O + M * rot_ops,
                               "int8" if kernel == "w4a8_matmul" else "bf16")
            row = dict(kernel=kernel, layer="script", sz=sz, M=M, **knobs, **one, max_abs_err=err,
                       tol=tol, err_over_tol=ratio, us=ms * 1e3, plain_us=plain_ms * 1e3,
                       library_us=lib_ms * 1e3, bound_us=b_ms * 1e3, bound_by=b_by,
                       ok=ratio <= 1 and bool(torch.isfinite(y).all()))
            emit({"phase": "kernel_check", **row})
            rows.append(row)
        del run, plain, rotate, wd, w_eff
    return rows


def w4x_edges(gen, dev, record):
    """K10-K13 at small shapes: ragged M (5, 17, 33) at O = 160, f16/uint8
    scales and zeros at O = 130 (byte loads), f32 x with f32 rotations and
    scales, one group, groups of 256 (f32 rotation) and 96 channels, each
    block_m and the Gb that divide G; K13 at every M from 1 to 32 (its row
    tiles and plans), at groups of 8 channels with two groups a split (a
    ring stage spanning groups), and at M 1-32 with O = 4096; then K11's refusal of a chunk size that does not divide
    G and K13's all-zero row, which must come out exactly 0."""
    import torch

    f32, bf = torch.float32, torch.bfloat16

    def check(kernel, case, I, O, Ms, xdt=bf, **kw):
        run, plain, *_ = w4x_inputs(kernel, I, O, gen, dev, **kw)
        for M in Ms:
            x = torch.randn(M, I, generator=gen, device=dev).to(xdt)
            record(kernel, f"{case} M={M} x={xdt}", run(x), plain(x))

    for kernel, knobs in (("rot_w4_matmul_b", {"block_m": 8}), ("rot_w4_matmul_b", {"block_m": 16}),
                          ("dma_rot_w4_matmul", {"Gb": 1}), ("dma_rot_w4_matmul", {"Gb": 2}),
                          ("rot_w4_matmul_v2", {"block_m": 8}), ("rot_w4_matmul_v2", {"block_m": 16}),
                          ("w4a8_matmul", {})):
        tag = " ".join(f"{k}={v}" for k, v in knobs.items())
        check(kernel, f"ragged O=160 {tag}", 256, 160, (5, 17, 33), **knobs)
        check(kernel, f"f16/u8 O=130 {tag}", 256, 130, (3,), sz="f16/u8", **knobs)
        check(kernel, f"f32 rot f32/f32 {tag}", 256, 160, (1, 17), xdt=f32, sz="f32/f32",
              rot_dtype=f32, **knobs)
        if knobs.get("Gb", 1) == 1:
            check(kernel, f"G=1 {tag}", 128, 128, (1, 9), **knobs)
        # rows of M_g that do not split over a warp (one thread per row), K13's quad tail
        check(kernel, f"S=256 f32 rot {tag}", 512, 128, (1, 9), S=256, rot_dtype=f32, **knobs)
        check(kernel, f"S=96 {tag}", 192, 128, (1, 9), S=96, **knobs)

    check("w4a8_matmul", "O=160 every M", 512, 160, tuple(range(1, 33)))
    check("w4a8_matmul", "S=8 two groups a split", 64, 8192, (32,), S=8, sz="bf16/u8")
    check("w4a8_matmul", "O=4096", 1024, 4096, (1, 8, 16, 32), sz="bf16/u8")

    run, *_ = w4x_inputs("dma_rot_w4_matmul", 384, 128, gen, dev, Gb=2)
    try:
        run(torch.randn(1, 384, generator=gen, device=dev).to(bf))
    except ValueError as e:
        emit({"phase": "w4x_refusal", "kernel": "dma_rot_w4_matmul", "G": 3, "Gb": 2, "error": str(e)})
    else:
        raise SystemExit("dma_rot_w4_matmul ran a chunk size that does not divide the groups")
    run, plain, *_ = w4x_inputs("w4a8_matmul", 256, 160, gen, dev, sz="bf16/u8")
    x = torch.randn(5, 256, generator=gen, device=dev).to(bf)
    x[2] = 0
    y = run(x)
    if y[2].abs().max().item() != 0.0:
        raise SystemExit("w4a8_matmul gave a nonzero output for an all-zero row")
    record("w4a8_matmul", "all-zero row M=5", y, plain(x))


def dequant_err_over_tol(y, y_ref) -> float:
    """K8/K11 against their plain version: the largest |y - y_ref| over its
    limit, TOL_DEQUANT max |y_ref| plus, where the output is bf16, one
    rounding of it (2**-7 |y_ref|: a different f32 sum may round an output
    one bf16 ulp the other way)."""
    import torch

    yf, rf = y.float(), y_ref.float()
    limit = TOL_DEQUANT * rf.abs().max().clamp_min(1e-30)
    if y.dtype == torch.bfloat16:
        limit = limit + 2.0**-7 * rf.abs()
    return ((yf - rf).abs() / limit).max().item()


def one_rounding_plain(x, rot, qweight, scales, zeros):
    """K8/K11's function with the fault of a dequant that rounds once, w =
    bf16((q - z) s) with bf16 s and z, in one f32 dot: what the
    fractional-zero edges must tell apart from the plain version."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    bf = rm._bf16
    M = x.shape[0]
    G, S, _ = rot.shape
    xr = bf(torch.einsum("mgj,gij->mgi", bf(x).reshape(M, G, S), bf(rot)))
    w = bf((rm._unpack_groups(qweight, G, S) - bf(zeros)[:, None]) * bf(scales)[:, None])
    return (xr.reshape(M, -1) @ w.reshape(G * S, -1)).to(x.dtype)


DEQUANT_EDGES = [  # kernel, K8's groups_per_step or K11's Gb, S, G, O, scales/zeros, Ms
    ("rot_w4_matmul_mg", 16, 128, 20, 1024, "bf16/bf16", (1, 5, 16, 17, 33)),
    ("rot_w4_matmul_mg", 32, 64, 40, 130, "f32/f32", (1, 9, 17)),
    ("dma_rot_w4_matmul", 1, 128, 4, 160, "bf16/bf16", (1, 5, 17)),
    ("dma_rot_w4_matmul", 2, 64, 6, 160, "f32/f32", (1, 5, 17)),
    ("dma_rot_w4_matmul", 4, 128, 8, 160, "f32/f32", (1, 5, 17)),
    ("dma_rot_w4_matmul", 3, 96, 9, 160, "bf16/bf16", (1, 5, 17)),
]


def dequant_edges(gen, dev, record):
    """K8 (the DQ variant at M <= 16, the passes above) and K11 on fractional
    zero points ~ U(0, 15) with f32 x, so f32 out: q - z rounds to bf16
    before the product. Each row is held to TOL_DEQUANT (`record`), and the
    phase fails unless, on the same inputs, the dequant that rounds once
    (`one_rounding_plain`) misses that limit: every edge would catch it."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm, w4_experiments as wx
    from paroquant_tpu_torch.ops.packing import pack_w4_tpu

    errs, faults = [], []
    for kernel, knob, S, G, O, sz, Ms in DEQUANT_EDGES:
        I = G * S
        sdt, zdt = (getattr(torch, n) for n in SZ_DTYPES[sz])
        qw = pack_w4_tpu(torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32), S)
        scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(sdt)
        zeros = (torch.rand(G, O, generator=gen, device=dev) * 15).to(zdt)
        rot = (torch.randn(G, S, S, generator=gen, device=dev) / S**0.5).to(torch.bfloat16)
        ops = (rot, qw, scales, zeros)
        mg = kernel == "rot_w4_matmul_mg"
        for M in Ms:
            x = torch.randn(M, I, generator=gen, device=dev)
            case = f"fractional zeros {'gps' if mg else 'Gb'}={knob} S={S} G={G} {sz} M={M} f32 x"
            if mg:
                y, taken = one_routed(rm, kernel, lambda: rm.rot_w4_matmul_mg(x, *ops,
                                                                         groups_per_step=knob))
                y_ref = rm.rot_w4_matmul_mg_plain(x, *ops, groups_per_step=knob)
                case += f" ({taken})"
            else:
                y = wx.dma_rot_w4_matmul(x, *ops, Gb=knob)
                y_ref = wx.dma_rot_w4_matmul_plain(x, *ops, Gb=knob)
            fault = dequant_err_over_tol(one_rounding_plain(x, *ops), y_ref)
            if fault <= 1:
                raise SystemExit(f"{kernel} {case}: a dequant that rounds once is within "
                                 f"TOL_DEQUANT ({fault:.3f} of it), so the edge cannot show it")
            record(kernel, case, y, y_ref)
            errs.append(dequant_err_over_tol(y, y_ref))
            faults.append(fault)
    emit({"phase": "dequant_edges", "cases": len(faults), "tol": TOL_DEQUANT,
          "worst_err_over_tol": max(errs), "least_one_rounding_over_tol": min(faults)})


# ---------------------------------------------------------------------------
# phase 3e: the int8 tensor-core probe (K14-K17)
# ---------------------------------------------------------------------------


def int_mm_yardstick(a, b):
    """(one torch._int_mm call computing a @ b, what it is): on A padded to
    32 rows where this build refuses M <= 16; None where it refuses the shape."""
    import torch

    try:
        torch._int_mm(a, b)
        return (lambda: torch._int_mm(a, b)), "torch._int_mm"
    except RuntimeError:
        pass
    ap = torch.zeros((32, a.shape[1]), dtype=a.dtype, device=a.device)
    ap[: a.shape[0]] = a
    try:
        torch._int_mm(ap, b)
        return (lambda: torch._int_mm(ap, b)), "torch._int_mm on A padded to 32 rows"
    except RuntimeError as e:
        return None, f"torch._int_mm refused the shape: {str(e).splitlines()[0][:120]}"


def check_int8_probe(flush, gen, dev):
    """K14-K17 against their plain versions at the probe's shapes, on its
    kinds of integer inputs (every product and sum exact, so the tolerance
    is 0): K14 8 x 128, K15 8 x 256 x 128 and the bench's 8 x 4096 x 4096,
    K16 8 x 256 -> 512, K17 8 x 4096 x 4096; timed beside the bound and one
    library call (torch._int_mm for K15, and for K16 on the unpacked int8
    weight; torch.matmul on bf16, which returns bf16, for K17; none for K14).
    K15's rows and K17's name their plan and fail unless two calls give the
    same bits and a call launches one kernel (profiler: no memset); they are
    also timed, with the library call, after a flush that leaves the L2
    clean."""
    import torch

    from paroquant_tpu_torch.kernels import int8_probe as ip

    def ints(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=dtype)

    x32 = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    cases = [("narrow_cast", "8x128", lambda: ip.narrow_cast(x32), lambda: ip.narrow_cast_plain(x32),
              (None, "none: no single call computes it"), 5 * x32.numel(), 0, "int8")]
    for M, K, N in ((8, 256, 128), (8, 4096, 4096)):
        a, b = ints(-8, 8, (M, K)), ints(-8, 8, (K, N))
        cases.append(("int8_dot", f"{M}x{K}x{N}", lambda a=a, b=b: ip.int8_dot(a, b),
                      lambda a=a, b=b: ip.int8_dot_plain(a, b), int_mm_yardstick(a, b),
                      M * K + K * N + 4 * M * N, 2 * M * K * N, "int8"))
    x, w = ints(-127, 127, (8, 256)), ints(0, 256, (128, 512), torch.uint8)
    cases.append(("fused_unpack_int8_dot", "8x256->512", lambda: ip.fused_unpack_int8_dot(x, w),
                  lambda: ip.fused_unpack_int8_dot_plain(x, w),
                  int_mm_yardstick(x, ip.unpack_nibbles(w)), 8 * 256 + 128 * 512 + 4 * 8 * 512,
                  2 * 8 * 256 * 512, "int8"))
    abf, bbf = ints(-8, 8, (8, 4096)).to(torch.bfloat16), ints(-8, 8, (4096, 4096)).to(torch.bfloat16)
    cases.append(("bf16_dot", "8x4096x4096", lambda: ip.bf16_dot(abf, bbf),
                  lambda: ip.bf16_dot_plain(abf, bbf),
                  (lambda: torch.matmul(abf, bbf), "torch.matmul (bf16 out)"),
                  2 * 8 * 4096 + 2 * 4096 * 4096 + 4 * 8 * 4096, 2 * 8 * 4096 * 4096, "bf16"))
    rows = []
    for kernel, case, run, plain, (lib, lib_note), nbytes, ops, kind in cases:
        y, y_ref = run(), plain()
        torch.cuda.synchronize()
        err = (y.double() - y_ref.double()).abs().max().item()
        ms = median_ms(run, KERNEL_REPS, flush)
        plain_ms = median_ms(plain, PLAIN_REPS, flush)
        lib_ms = median_ms(lib, KERNEL_REPS, flush) if lib else None
        b_ms, b_by = bound(nbytes, ops, kind)
        row = dict(kernel=kernel, case=case, max_abs_err=err, tol=0.0, us=ms * 1e3,
                   plain_us=plain_ms * 1e3, library_us=None if lib_ms is None else lib_ms * 1e3,
                   library=lib_note, bound_us=b_ms * 1e3, bound_by=b_by,
                   ok=err == 0 and y.dtype == y_ref.dtype and y.shape == y_ref.shape)
        if kernel in ("int8_dot", "bf16_dot"):  # one launch a call, its splits merged in a fixed order
            from paroquant_tpu_torch.utils.profiling import kernel_time_ms

            M, K, N = (int(v) for v in case.split("x"))
            plan = ip.int8_plan if kernel == "int8_dot" else ip.bf16_plan
            KS, per, rows_per_block = plan(M, K, N, ip._sm_count(dev))
            row.update(KS=KS, chunks_per_split=per, rows_per_block=rows_per_block,
                       bitwise_equal=torch.equal(run(), run()), kernels_per_call=kernels_per_call(run),
                       us_clean_l2=kernel_time_ms(run, KERNEL_REPS, flush, clean_l2=True) * 1e3,
                       library_us_clean_l2=None if lib is None else
                       kernel_time_ms(lib, KERNEL_REPS, flush, clean_l2=True) * 1e3)
            if not row["bitwise_equal"] or row["kernels_per_call"] != 1:
                raise SystemExit(f"{kernel} {case}: two calls differ or a call ran "
                                 f"{row['kernels_per_call']} kernels")
        emit({"phase": "kernel_check", **row})
        rows.append(row)
    return rows


def int8_edges(gen, dev, record, record_exact):
    """K14-K17 at their edges, checked and not timed: M 1, 5, 16, 17, 32, 33; N
    130; K 96 and 200 (not multiples of 32; K16's S/2 = 99 puts a row quad
    across its two halves); K 16384 (split over 128 blocks); operands that
    are not 16-byte aligned; K15 on -128 and 127 everywhere, K16 on nibbles
    0 and 15 everywhere and at S = 4096; K17 on random bf16 within
    TOL_KERNEL, the integer kernels exact; K14 where R * C is not a multiple
    of 4; then K16's refusal of an odd S."""
    import torch

    from paroquant_tpu_torch.kernels import int8_probe as ip

    def ints(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=dtype)

    def shifted(t):
        """t's values one element past an aligned address (not 16-byte aligned)."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    def dots(case, M, K, N, misaligned=False):
        move = shifted if misaligned else (lambda t: t)
        a, b = move(ints(-128, 128, (M, K))), move(ints(-128, 128, (K, N)))
        record_exact("int8_dot", f"{case} {M}x{K}x{N}", ip.int8_dot(a, b), ip.int8_dot_plain(a, b))
        if K % 2 == 0:
            w = move(ints(0, 256, (K // 2, N), torch.uint8))
            record_exact("fused_unpack_int8_dot", f"{case} {M}x{K}->{N}",
                         ip.fused_unpack_int8_dot(a, w), ip.fused_unpack_int8_dot_plain(a, w))
        af = move(torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16))
        bf = move(b.float().div(37.0).to(torch.bfloat16))  # non-integer values
        record("bf16_dot", f"{case} {M}x{K}x{N}", ip.bf16_dot(af, bf), ip.bf16_dot_plain(af, bf))

    for M in (1, 5, 16, 17, 32, 33):
        dots("ragged M", M, 256, 128)
    dots("N=130", 5, 256, 130)
    for K in (96, 200, 198):
        dots("ragged K", 5, K, 128)
    dots("split K", 8, 16384, 256)
    dots("S=4096", 8, 4096, 512)
    for va, vb in ((-128, -128), (127, 127), (-128, 127)):
        a = torch.full((8, 4096), va, dtype=torch.int8, device=dev)
        b = torch.full((4096, 256), vb, dtype=torch.int8, device=dev)
        record_exact("int8_dot", f"all {va} x {vb}", ip.int8_dot(a, b), ip.int8_dot_plain(a, b))
    for v in (0, 255):  # nibbles 0 (q = -8) and 15 (q = 7) everywhere
        a = ints(-128, 128, (8, 4096))
        w = torch.full((2048, 256), v, dtype=torch.uint8, device=dev)
        record_exact("fused_unpack_int8_dot", f"nibbles all {v & 15} S=4096",
                     ip.fused_unpack_int8_dot(a, w), ip.fused_unpack_int8_dot_plain(a, w))
    dots("misaligned", 5, 256, 128, misaligned=True)  # widths that take 16-byte loads when aligned
    for R, C in ((8, 128), (3, 5), (7, 129)):
        x = torch.randint(-2**31, 2**31 - 1, (R, C), generator=gen, device=dev, dtype=torch.int32)
        record_exact("narrow_cast", f"{R}x{C}", ip.narrow_cast(x), ip.narrow_cast_plain(x))
        record_exact("narrow_cast", f"{R}x{C} misaligned", ip.narrow_cast(shifted(x)),
                     ip.narrow_cast_plain(x))
    try:
        ip.fused_unpack_int8_dot(ints(-8, 8, (2, 7)), ints(0, 256, (3, 4), torch.uint8))
    except ValueError as e:
        emit({"phase": "int8_refusal", "kernel": "fused_unpack_int8_dot", "S": 7, "error": str(e)})
    else:
        raise SystemExit("fused_unpack_int8_dot ran an odd S")


def sass_counts(lib_name, ops):
    """Per function of a built library (`cuobjdump -sass`), the number of
    SASS lines holding each of `ops`; None where the toolkit has no cuobjdump."""
    import shutil

    from paroquant_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    lib = Path(build.build_info["dir"]) / lib_name
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                counts[fn][op] += op in line
    return counts


def check_sass(lib_name, ops, expect):
    """Emit the `sass` line of one library and check that every instance of
    each kernel in `expect` ((name, op, instances), ...) holds its op."""
    counts = sass_counts(lib_name, ops)
    emit({"phase": "sass", "library": lib_name, "counts": counts})
    if counts is None:
        return
    for name, op, n in expect:
        found = [c[op] for f, c in counts.items() if name in f]
        if len(found) != n or min(found) == 0:
            raise SystemExit(f"{name}: expected {op} in {n} instance(s), found {found}")


MAGIC_SUB = "-128, -128"  # SASS of DQ's exact subtraction of the magic 128 (one per nibble pair)


def check_dequant_sass():
    """K8/K11's DQ instances (16) in the dequant library: the one-launch
    kernel's 16-byte loads (LDG.E.128, LDGSTS), and the dequant's bf16x2
    operations as compiled. Each pair of nibbles takes three, each rounding
    once: the exact subtraction of the magic 128, q - z and the product by
    s. ptxas issues the last two as HADD2/HMUL2 or as HFMA2.MMA (times 1,
    plus -0), all `BF16_V2`; so every instance must hold three bf16x2
    operations for each magic subtraction. A subtraction fused into the
    product, or one dropped, would break that count."""
    ops = ("LDG.E.128", "LDGSTS", "BF16_V2", MAGIC_SUB)
    counts = sass_counts("librot_w4_dequant.so", ops)
    emit({"phase": "sass", "library": "librot_w4_dequant.so", "counts": counts})
    if counts is None:
        return
    dq = {f: c for f, c in counts.items() if "rot_w4_one_launch_kernel" in f}
    bad = [f for f, c in dq.items() if not c["LDG.E.128"] or not c["LDGSTS"]
           or not c[MAGIC_SUB] or c["BF16_V2"] != 3 * c[MAGIC_SUB]]
    if len(dq) != 16 or bad:
        raise SystemExit(f"the DQ instances: {len(dq)} found, missing loads or bf16x2 roundings: {bad}")


def check_flash_spills(report):
    """K3's tensor-core instances at head-dim buckets up to 128 keep Q, S, P
    and O in registers: ptxas must report 0 spill bytes for each; the
    bucket-256 instances' spills are reported, not held."""
    import re

    fn, spills = None, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "flash_mma_kernel" in fn and "spill stores" in line:
            spills[fn] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
    bucket = {f: int(re.search(r"flash_mma_kernelILi(\d+)E", f).group(1)) for f in spills}
    emit({"phase": "flash_spills", "instances": len(spills),
          "spill_bytes_by_bucket": {db: [spills[f] for f in spills if bucket[f] == db]
                                    for db in sorted(set(bucket.values()))}})
    bad = [f for f in spills if bucket[f] <= 128 and spills[f]]
    if len(spills) != 14 or bad:
        raise SystemExit(f"K3's tensor-core instances: {len(spills)} found, spilling at D <= 128: {bad}")


def check_rot_spills(report):
    """The one-launch kernel (csrc/one_launch.cuh): every instance of K1/K2
    (4 row tiles x f32/bf16 x and rot, 16), of K10/K12 (the same for each,
    32), of K8/K11's DQ variant (16), of K7's BF and K13's A8 variants
    (4 row tiles x f32/bf16 x, 8 each), of K9's I4 variant (16), of K1/K2's
    a8 RA8 variant (16), of K6's PL variant (8), of K19's BC variant (8), of
    K20's MF variant (8) and of K22's WM variant (8) must report 0 spill
    bytes in ptxas's lines. The report names each library's kernels after a
    line naming its source's log."""
    import re

    fn, spills = None, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "rot_w4_one_launch_kernel" in fn and "spill stores" in line:
            spills[fn] = (int(re.search(r"(\d+) bytes spill stores", line).group(1))
                          + int(re.search(r"(\d+) bytes spill loads", line).group(1)))
    # the variant is the template's last argument: Li0E (K1), Li1E (K10), Li2E (K12), Li3E (DQ),
    # Li4E (BF), Li5E (A8), Li6E (I4), Li7E (RA8), Li8E (PL), Li9E (BC), Li10E (MF), Li11E (WM)
    by_var = {v: sorted(b for f, b in spills.items() if f.endswith(f"Li{v}EEEvNS0_4ArgsE"))
              for v in range(12)}
    emit({"phase": "rot_spills", "instances": len(spills),
          "spill_bytes": {name: by_var[v] for v, name in enumerate(("k1", "k10", "k12", "dq",
                                                                     "bf", "a8", "i4", "ra8",
                                                                     "pl", "bc", "mf", "wm"))}})
    if ([len(b) for b in by_var.values()] != [16, 16, 16, 16, 8, 8, 16, 16, 8, 8, 8, 8]
            or any(spills.values())):
        raise SystemExit(f"the one-launch kernel: {len(spills)} instances, spill bytes {spills}")


def check_stream_spills(report):
    """K15's streaming instances (int8_stream_kernel, NM 1, 2, 4) and K18's
    (stream_kernel, f32 and bf16 x) must report 0 spill bytes in ptxas's
    lines."""
    import re

    fn, spills = None, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "stream_kernel" in fn and "spill stores" in line:
            spills[fn] = (int(re.search(r"(\d+) bytes spill stores", line).group(1))
                          + int(re.search(r"(\d+) bytes spill loads", line).group(1)))
    k15 = [b for f, b in spills.items() if "int8_stream_kernel" in f]
    k18 = [b for f, b in spills.items() if "int8_stream_kernel" not in f]
    emit({"phase": "stream_spills", "spill_bytes": {"k15": k15, "k18": k18}})
    if len(k15) != 3 or len(k18) != 2 or any(spills.values()):
        raise SystemExit(f"K15/K18's instances: spill bytes {spills}")


def int8_probe(dev):
    """Slice 5's path: the ported int8 probe (kernel_int8_probe.main: P1-P3
    and the int8-against-bf16 bench at 4096 x 4096, M = 8) in this process.
    The launch counts are reset just before and read just after: K14-K17
    must have run, and every probe must pass."""
    import torch

    from paroquant_tpu_torch.kernels import int8_probe as ip
    from paroquant_tpu_torch.scripts import kernel_int8_probe

    torch.cuda.synchronize()
    ip.reset_launch_counts()
    t0 = time.perf_counter()
    ok, rows = kernel_int8_probe.main(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ip.launch_counts[k] for k in INT8_PROBE}
    for row in rows:
        emit({"phase": "kernel_bench", "script": "kernel_int8_probe", **row})
    emit({"phase": "int8_probe_launches", "counts": counts, "probes": ok, "wall_s": wall})
    failed = [k for k in ("narrow_cast", "int8_dot", "fused_unpack_int8_dot", "bench_dots")
              if not ok.get(k)]
    missing = [k for k, c in counts.items() if c == 0]
    if failed or missing:
        raise SystemExit(f"int8_probe: probes failed: {failed}; not launched: {missing}")
    return counts


def w4_experiments(dev):
    """Slice 4's path: the four ported experiment scripts at their own sizes,
    in this process. The launch counts are reset just before and read just
    after: K10-K13 and their control arms K1, K6 and K8 must have run."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm, w4_experiments as wx
    from paroquant_tpu_torch.scripts import (kernel_dma_pipeline, kernel_edge_test, kernel_tune,
                                             kernel_w4a8_exp)

    torch.cuda.synchronize()
    rm.reset_launch_counts()
    wx.reset_launch_counts()
    t0 = time.perf_counter()
    rows = {"kernel_edge_test": kernel_edge_test.main(dev),
            "kernel_dma_pipeline": kernel_dma_pipeline.main(dev),
            "kernel_tune": kernel_tune.main(dev),
            "kernel_w4a8_exp": kernel_w4a8_exp.main(dev)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: wx.launch_counts[k] for k in W4_EXPERIMENTS}
    counts.update({k: rm.launch_counts[k] for k in ("rot_w4_matmul", "w4_matmul", "rot_w4_matmul_mg")})
    for script, script_rows in rows.items():
        for row in script_rows:
            emit({"phase": "kernel_bench", "script": script, **row})
    emit({"phase": "w4_experiments_launches", "counts": counts, "wall_s": wall})
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise SystemExit(f"w4_experiments: not launched: {missing}")
    return counts


def kernel_bench(dev):
    """The ported kernel benchmarks, in this process: kernel_bench3 in its
    three modes, kernel_bench4, the kernel-speedup sweep, and K9 (which has
    no caller) at the benchmarks' shape. The launch counts are reset just
    before and read just after: K6-K9 must have run, K1 on f32 and on uint8
    scales/zeros, and every K8, K7 and K9 call (M 1) on the one-launch route."""
    import numpy as np
    import torch

    from paroquant_tpu_torch.experiments import plot_kernel_speedup
    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.ops.packing import pack_w4_i4
    from paroquant_tpu_torch.scripts import kernel_bench3, kernel_bench4
    from paroquant_tpu_torch.scripts.bench_common import Case, tensor, time_cases

    M, I, O, GS = 1, 4096, 4096, 128
    G = I // GS
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    x = tensor(rng.normal(size=(M, I)), bf, dev)
    qw_i4 = pack_w4_i4(rng.integers(0, 16, (I, O), dtype=np.int32)).to(dev)
    scales = tensor(rng.uniform(0.01, 0.05, (G, O)), bf, dev)
    zeros = tensor(rng.integers(0, 16, (G, O)), torch.uint8, dev)
    rot = tensor(rng.normal(size=(G, GS, GS)), bf, dev)
    k9 = Case("rot_w4_matmul_i4", lambda xv: rm.rot_w4_matmul_i4(xv, rot, qw_i4, scales, zeros),
              x, I * O // 2 + G * O * 3 + G * GS * GS * 2)
    torch.cuda.synchronize()

    rm.reset_launch_counts()
    t0 = time.perf_counter()
    rows = {f"kernel_bench3 {mode}": kernel_bench3.main(dev, mode) for mode in kernel_bench3.MODES}
    rows["kernel_bench4"] = kernel_bench4.main(dev)
    sweep = plot_kernel_speedup.main(dev)
    rows["rot_w4_matmul_i4 (no caller)"] = time_cases([k9], dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: rm.launch_counts[k] for k in ("rot_w4_matmul", *W4_VARIANTS)}
    sz = {k: dict(rm.sz_counts[k]) for k in counts}

    for script, script_rows in rows.items():
        for row in script_rows:
            emit({"phase": "kernel_bench", "script": script, **row})
    emit({"phase": "kernel_speedup", **sweep})
    routes = {k: dict(getattr(rm, ROUTE_RULES[k][1])) for k in ROUTE_RULES}
    emit({"phase": "kernel_bench_launches", "counts": counts, "sz_dtypes": sz,
          **{f"{k}_routes": v for k, v in routes.items()}, "wall_s": wall})
    missing = [k for k, c in counts.items() if c == 0]
    missing += [f"rot_w4_matmul on {k}" for k in ("float32/float32", "bfloat16/uint8")
                if k not in sz["rot_w4_matmul"]]
    for k, r in routes.items():
        if r["passes"] or r["one_launch"] != counts[k]:
            missing.append(f"{k} on the one-launch route at every call: {r}")
    if missing:
        raise SystemExit(f"kernel_bench: not launched: {missing}")
    return counts


# ---------------------------------------------------------------------------
# phase 3f: the W4 unpack experiments (K18-K22)
# ---------------------------------------------------------------------------


def unpack_routed(ux, name, fn):
    """fn()'s output and the route its one call of K19-K22 took
    (`unpack_route_counts`)."""
    before = dict(ux.unpack_route_counts[name])
    y = fn()
    taken = [r for r, n in ux.unpack_route_counts[name].items() if n != before[r]]
    if len(taken) != 1:
        raise SystemExit(f"expected one {name} call, counted {taken}")
    return y, taken[0]


def other_unpack_route_ms(ux, rm, run, flush, taken):
    """run's median time with K19-K22 sent to the route it did not take
    (`unpack_route` swapped for the length of the timing): both routes on
    the same card in the same run."""
    def route(M, I, S, O, sms):
        if taken == "one_launch":
            return "gemv", None
        return "one_launch", rm.w4_plan(M, I, S, O, sms)

    real = ux.unpack_route
    ux.unpack_route = route
    try:
        return median_ms(run, KERNEL_REPS, flush)
    finally:
        ux.unpack_route = real


UNPACK_MS = (1, 8, 16)  # K19-K22's rows (K6's on the same draws beside them)
HALF_SPLIT_UNPACKS = ("w4_matmul_mulfloor", "w4_matmul_i8")  # K20, K22: bit for bit K21 on the one launch


def check_unpack_exp(flush, dev):
    """K18-K22 (the six entry points) against their plain versions on the
    script's draws (4096 x 4096, g128, bf16 x, scales and zeros; M = 1, and
    K19, both K21 entries and K6 also at M 8 and 16): K18 bit for bit, the
    GEMVs within TOL_KERNEL; timed beside the bound and one library call
    (torch.matmul on the dequantized bf16 weight for the GEMVs; for K18,
    which no PyTorch call computes, a torch.sum over the same weight bytes,
    with its share of the HBM rate; K18's row names its splits, fails unless
    two calls give the same bits and a call launches one kernel (profiler:
    no second pass), and is timed, with its yardstick, after a clean flush
    too). Each K19-K22 row names its route
    (`unpack_route`), its plan and the other route's time at the same
    inputs; on the one-launch route it fails unless two calls give the same
    bits and a call launches one kernel (profiler). K20 and K22 (MF and WM:
    PL's skeleton and FMA order with their own unpacks) must take the one
    launch and give K21's output (PL) bit for bit on the same inputs."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm, unpack_exp as ux
    from paroquant_tpu_torch.scripts import kernel_unpack_exp as kue

    rows = []
    for M in UNPACK_MS:
        d = kue.draws(dev, M=M)
        x, qw, qo, s, z = (d[k] for k in ("x", "qweight", "q_opair", "scales", "zeros"))
        I, O, S = x.shape[1], qw.shape[1], 128
        G = I // S
        w = ((rm._unpack_groups(qw, G, S) - z.float()[:, None]) * s.float()[:, None])
        w = w.reshape(I, O).to(torch.bfloat16)
        gemv_bytes = (I * O // 2 + G * O * (s.element_size() + z.element_size()) + M * I * 2
                      + M * O * 2)
        cases = []
        if M == 1:
            cases.append(("stream_only", lambda: ux.stream_only(x, qw),
                          lambda: ux.stream_only_plain(x, qw),
                          lambda: torch.sum(qw, dim=0, dtype=torch.int32),
                          "torch.sum(qweight, dim=0, dtype=int32): the same weight bytes, another function",
                          I * O // 2 + M * I * 2 + O * 4, 0))
        names = UNPACK[1:] if M == 1 else tuple(ux.ONE_LAUNCH_ENTRY)
        k21, k21_route = unpack_routed(ux, "w4_matmul_splitdot",
                                       lambda: ux.w4_matmul_splitdot(x, qw, s, z))
        for name in names + ("w4_matmul",):
            wt = qo if name == "w4_matmul_bitcast" else qw
            mod = rm if name == "w4_matmul" else ux
            cases.append((name, lambda f=getattr(mod, name), wt=wt: f(x, wt, s, z),
                          lambda f=getattr(mod, name.replace("_ce", "") + "_plain"), wt=wt:
                          f(x, wt, s, z),
                          lambda: torch.matmul(x, w), "torch.matmul on the dequantized bf16 weight",
                          gemv_bytes, 2 * M * I * O))
        for kernel, run, plain, lib, lib_note, nbytes, ops in cases:
            route = {}
            if kernel in ux.ONE_LAUNCH_ENTRY:
                y, taken = unpack_routed(ux, kernel, run)
                route = dict(route=taken, other_route_us=None)
                if taken == "one_launch":
                    KS, tile, rows_per_block, gps = ux.unpack_route(M, I, S, O, rm._sm_count(dev))[1]
                    route.update(KS=KS, tile=tile, rows_per_block=rows_per_block,
                                 groups_per_split=gps, bitwise_equal=torch.equal(run(), run()),
                                 kernels_per_call=kernels_per_call(run))
                    if kernel in HALF_SPLIT_UNPACKS:
                        route["bitwise_equal_to_k21"] = (k21_route == "one_launch"
                                                         and torch.equal(y, k21))
                    emit({"phase": "unpack_determinism", "kernel": kernel, "M": M, **route})
                    if not route["bitwise_equal"] or route["kernels_per_call"] != 1:
                        raise SystemExit(f"{kernel} M={M}: two calls differ or a call ran "
                                         f"{route['kernels_per_call']} kernels")
                if kernel in HALF_SPLIT_UNPACKS and not route.get("bitwise_equal_to_k21"):
                    raise SystemExit(f"{kernel} M={M}: took {taken}, K21 {k21_route}; not K21's "
                                     "bits on the one launch")
            else:
                y = run()
            if kernel == "stream_only":  # one launch a call, its rows merged in g order
                from paroquant_tpu_torch.utils.profiling import kernel_time_ms

                route = dict(KS=ux.stream_plan(O, G, rm._sm_count(dev)),
                             bitwise_equal=torch.equal(run(), run()),
                             kernels_per_call=kernels_per_call(run),
                             us_clean_l2=kernel_time_ms(run, KERNEL_REPS, flush, clean_l2=True) * 1e3,
                             library_us_clean_l2=kernel_time_ms(lib, KERNEL_REPS, flush,
                                                                clean_l2=True) * 1e3)
                if not route["bitwise_equal"] or route["kernels_per_call"] != 1:
                    raise SystemExit(f"stream_only: two calls differ or a call ran "
                                     f"{route['kernels_per_call']} kernels")
            y_ref = plain()
            torch.cuda.synchronize()
            err = (y.double() - y_ref.double()).abs().max().item()
            exact = kernel == "stream_only"
            tol = 0.0 if exact else TOL_KERNEL * y_ref.float().abs().max().item()
            ms = median_ms(run, KERNEL_REPS, flush)
            if "route" in route:
                route["other_route_us"] = other_unpack_route_ms(ux, rm, run, flush,
                                                                route["route"]) * 1e3
            plain_ms = median_ms(plain, PLAIN_REPS, flush)
            lib_ms = median_ms(lib, KERNEL_REPS, flush)
            b_ms, b_by = bound(nbytes, ops, "bf16")
            row = dict(kernel=kernel, case=f"{I}x{O} M={M} g{S} bf16/bf16", M=M, **route,
                       max_abs_err=err, tol=tol, us=ms * 1e3, plain_us=plain_ms * 1e3,
                       library_us=lib_ms * 1e3, library=lib_note, bound_us=b_ms * 1e3,
                       bound_by=b_by, hbm_share=nbytes / (ms * 1e-3) / HBM_BYTES_PER_S,
                       ok=(err == 0 and y.dtype == y_ref.dtype and y.shape == y_ref.shape) if exact
                       else err <= tol and bool(torch.isfinite(y).all()))
            if exact:
                row["library_hbm_share"] = (I * O // 2) / (lib_ms * 1e-3) / HBM_BYTES_PER_S
            emit({"phase": "kernel_check", **row})
            rows.append(row)
        del d, x, qw, qo, s, z, w, k21
    return rows


def unpack_edges(gen, dev, record, record_exact):
    """K18-K22 at small shapes, checked and not timed: M 1, 5, 8, 16, 17; I
    256, 384 and 1024; group sizes 96, 128 and 256; O 256, 384, 160 and 130
    (K19's rows of 65 bytes and the gemv's rows take byte loads); a weight 4
    bytes past a 16-byte boundary; scales/zeros bf16/bf16, bf16/u8, f16/u8,
    f32/f32; f32 x; each K19-K22 call's route checked against
    `unpack_route` (the one launch to M 16, the gemv at 17), and K20's and
    K22's outputs bit for bit K21's wherever the three take the one launch;
    K18 bit for bit at Gb 1, 2 and 3 with G = 8 (Gb 3 leaves two groups
    unread), with the weight 16-byte aligned and 4 bytes past it, with f32
    x, where a block streams more chunks than its ring has stages (Gb 4 at
    I 8192; one split of 8 blocks of groups a block at O 153600), then its
    refusal of M = 17."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm, unpack_exp as ux
    from paroquant_tpu_torch.ops.packing import pack_w4_tpu
    from paroquant_tpu_torch.scripts.kernel_unpack_exp import pack_w4_opair

    def operands(I, O, S, sz):
        G = I // S
        sdt, zdt = (getattr(torch, n) for n in W4X_SZ[sz])
        q = torch.randint(0, 16, (I, O), generator=gen, device=dev, dtype=torch.int32)
        qo = torch.from_numpy(pack_w4_opair(q.cpu().numpy(), S)).to(dev)
        scales = (torch.rand(G, O, generator=gen, device=dev) * 0.04 + 0.01).to(sdt)
        zeros = torch.randint(0, 16, (G, O), generator=gen, device=dev).to(zdt)
        return pack_w4_tpu(q, S), qo, scales, zeros

    sms = rm._sm_count(torch.device(dev))

    same_as_k21 = []  # (kernel, case) of each K20 / K22 output compared with K21's

    def call(name, x, wt, s, z, S, case):
        fn = lambda: getattr(ux, name)(x, wt, s, z, group_size=S)
        y, taken = unpack_routed(ux, name, fn)
        want = ux.unpack_route(x.shape[0], x.shape[1], S, s.shape[1], sms)[0]
        if taken != want:
            raise SystemExit(f"{name} {case}: took {taken}, the rule says {want}")
        record(name, f"{case} ({taken})", y,
               getattr(ux, name.replace("_ce", "") + "_plain")(x, wt, s, z, group_size=S))
        return y, taken

    def calls(x, qw, qo, s, z, S, case):  # the five GEMVs; K20's and K22's bits against K21's
        ys = {name: call(name, x, qo if name == "w4_matmul_bitcast" else qw, s, z, S, case)
              for name in UNPACK[1:]}
        k21, k21_taken = ys["w4_matmul_splitdot"]
        for name in HALF_SPLIT_UNPACKS:
            y, taken = ys[name]
            if taken == k21_taken == "one_launch":
                if not torch.equal(y, k21):
                    raise SystemExit(f"{name} {case}: not K21's bits on the one launch")
                same_as_k21.append((name, case))

    for I, S, O in ((256, 128, 256), (1024, 128, 384), (1024, 256, 384), (256, 128, 130),
                    (384, 96, 160)):
        for sz in W4X_SZ:
            qw, qo, s, z = operands(I, O, S, sz)
            for M in (1, 5, 8, 16, 17):
                x = torch.randn(M, I, generator=gen, device=dev).to(torch.bfloat16)
                calls(x, qw, qo, s, z, S, f"I={I} S={S} O={O} s/z={sz} M={M}")
    qw, qo, s, z = operands(256, 256, 128, "bf16/bf16")
    # the weight 4 bytes past a 16-byte boundary: byte by byte
    qw, qo = (torch.cat([wt.new_zeros(4), wt.flatten()])[4:].view(wt.shape) for wt in (qw, qo))
    for M in (1, 8):
        x = torch.randn(M, 256, generator=gen, device=dev).to(torch.bfloat16)
        calls(x, qw, qo, s, z, 128, f"weight off 16-byte alignment M={M}")
    qw, qo, s, z = operands(256, 256, 128, "f32/f32")
    calls(torch.randn(3, 256, generator=gen, device=dev), qw, qo, s, z, 128, "f32 x M=3")
    emit({"phase": "unpack_edges_k21_bitwise", "compared": len(same_as_k21),
          "by_kernel": {n: sum(k == n for k, _ in same_as_k21) for n in HALF_SPLIT_UNPACKS}})
    for O in (256, 384, 130):
        qw = torch.randint(0, 256, (512, O), generator=gen, device=dev, dtype=torch.uint8)
        for M in (1, 16):
            x = torch.randn(M, 1024, generator=gen, device=dev).to(torch.bfloat16)
            for Gb in (1, 2, 3):
                record_exact("stream_only", f"G=8 Gb={Gb} O={O} M={M}",
                             ux.stream_only(x, qw, groups_per_step=Gb),
                             ux.stream_only_plain(x, qw, groups_per_step=Gb))
        qs = torch.cat([qw.new_zeros(4), qw.flatten()])[4:].view(qw.shape)  # off 16-byte alignment
        xf = torch.randn(3, 1024, generator=gen, device=dev)
        for Gb in (1, 2, 3):
            record_exact("stream_only", f"G=8 Gb={Gb} O={O} weight off 16-byte alignment",
                         ux.stream_only(x, qs, groups_per_step=Gb),
                         ux.stream_only_plain(x, qs, groups_per_step=Gb))
            record_exact("stream_only", f"G=8 Gb={Gb} O={O} f32 x",
                         ux.stream_only(xf, qw, groups_per_step=Gb),
                         ux.stream_only_plain(xf, qw, groups_per_step=Gb))
    for I, O, Gb in ((8192, 4096, 4), (1024, 153600, 1)):  # ring stages reused; one split (KS 1)
        qw = torch.randint(0, 256, (I // 2, O), generator=gen, device=dev, dtype=torch.uint8)
        x = torch.randn(1, I, generator=gen, device=dev).to(torch.bfloat16)
        KS = ux.stream_plan(O, I // 128 // Gb, sms)
        record_exact("stream_only", f"I={I} O={O} Gb={Gb} KS={KS}",
                     ux.stream_only(x, qw, groups_per_step=Gb),
                     ux.stream_only_plain(x, qw, groups_per_step=Gb))
    try:
        ux.stream_only(torch.zeros((17, 1024), dtype=torch.bfloat16, device=dev), qw)
    except ValueError as e:
        emit({"phase": "unpack_refusal", "kernel": "stream_only", "M": 17, "error": str(e)})
    else:
        raise SystemExit("stream_only ran x of 17 rows")


def head_dim_refusals(gen, dev):
    """K3-K5 refuse a head_dim that is not a multiple of 8 (12) or above 256
    (264) on the card with NotImplementedError, naming the bound."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    for D in (12, 264):
        q = torch.randn(1, 2, 128, D, generator=gen, device=dev).to(torch.bfloat16)
        lens = torch.full((1,), 128, dtype=torch.int32, device=dev)
        table, k, v, _, _ = paged_inputs(gen, dev, quant=False, B=1, Hq=2, Hkv=1, D=D, ps=8, maxP=2)
        calls = {"flash_attention": lambda: at.flash_attention(q, q[:, :1], q[:, :1], lens, scale=0.1),
                 "paged_decode_attention": lambda: at.paged_decode_attention(
                     q[:, :, 0], k, v, table, lens[:1] * 0 + 5, scale=0.1)}
        for name, call in calls.items():
            try:
                call()
            except NotImplementedError as e:
                emit({"phase": "head_dim_refusal", "kernel": name, "D": D, "error": str(e)})
            else:
                raise SystemExit(f"{name} ran head_dim {D}")


def unpack_exp(dev):
    """Slice 6's path: the ported unpack experiments (kernel_unpack_exp.main
    at 4096 x 4096, M = 1, g128) in this process. The launch counts are
    reset just before and read just after: the six entry points of K18-K22
    and the control arms K6 and K1 must have run, K19, K20, both K21 entries
    and K22 on the one-launch route at every call, and every GEMV must agree
    with K6 within TOL_KERNEL."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm, unpack_exp as ux
    from paroquant_tpu_torch.scripts import kernel_unpack_exp

    torch.cuda.synchronize()
    rm.reset_launch_counts()
    ux.reset_launch_counts()
    t0 = time.perf_counter()
    errs, rows = kernel_unpack_exp.main(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ux.launch_counts[k] for k in UNPACK}
    counts.update({k: rm.launch_counts[k] for k in ("w4_matmul", "rot_w4_matmul")})
    routes = {k: dict(v) for k, v in ux.unpack_route_counts.items()}
    for row in rows:
        emit({"phase": "kernel_bench", "script": "kernel_unpack_exp", **row})
    emit({"phase": "unpack_exp_launches", "counts": counts, "routes": routes,
          "max_rel_err_vs_baseline": errs, "bound": TOL_KERNEL, "wall_s": wall})
    missing = [k for k, c in counts.items() if c == 0]
    off = {k: e for k, e in errs.items() if not e <= TOL_KERNEL}
    off_route = {k: r for k, r in routes.items() if r["gemv"] or r["one_launch"] != counts[k]}
    if missing or off or off_route:
        raise SystemExit(f"unpack_exp: not launched: {missing}; off the baseline: {off}; "
                         f"off the one launch: {off_route}")
    return counts


# ---------------------------------------------------------------------------
# phase 3b': the Engine at other head dims (K3-K5)
# ---------------------------------------------------------------------------

# tests/test_serve.py::test_paged_decode_matches_contiguous_gemma's model
SERVE_GEMMA = dict(model_type="gemma3", vocab_size=256, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                   qk_norm=True, gemma_norm=True, post_norms=True, sliding_window=8,
                   sliding_window_pattern=2, logit_softcap=30.0, attn_logit_softcap=50.0,
                   tie_word_embeddings=True, rope_theta=1e6, rope_local_theta=1e4)
HEAD_DIM_MODELS = {"gemma3-hd32": {},
                   "gemma3-hd256-grp16": dict(head_dim=256, num_attention_heads=32)}


def serve_head_dims(dev):
    """The Engine on the card (pages of 64, chunked prefill, burst decode,
    prompt-lookup speculation with spec_k 4) serving two small Gemma-class
    models, W4 RTN of random bf16 weights: SERVE_GEMMA (head_dim 32, grp 2)
    and the same at head_dim 256 with 16 query heads per kv head (a verify
    window is 80 rows per kv head). Four greedy requests each, prompts of
    130-200 tokens so that K3 runs; the launch counts are reset before each
    model and read after its requests: K3, K4 and K5 must have run. Each
    request's logprobs are held against Engine.score_sync (one contiguous
    K3 prefill) within TOL_LOGPROB, and replacing half of the longest prompt
    must move them by more than the worst gap."""
    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.kernels import attention as at
    from paroquant_tpu_torch.models import ModelConfig, init_params, merge_projections
    from paroquant_tpu_torch.serve import Engine, SamplingParams

    out = {}
    for name, over in HEAD_DIM_MODELS.items():
        cfg = ModelConfig(**{**SERVE_GEMMA, **over})
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), torch.bfloat16, dev)
        qp = merge_projections(
            quantize_model_rtn(params, cfg, hadamard=True, quantize_lm_head=True, device=dev), cfg)
        eng = Engine(qp, cfg, max_batch=4, max_len=512, page_size=64, prefill_chunk=256,
                     quant_mode="auto", decode_burst=8, prefix_caching=True, spec_k=4, device=dev)
        g = torch.Generator().manual_seed(5)
        rand = lambda n: torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
        prompts = [rand(24) * 8, rand(200), rand(16) * 12, rand(130)]
        torch.cuda.synchronize()
        at.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [(eng.submit(p, SamplingParams(max_tokens=32, temperature=0.0)), p) for p in prompts]
        while eng.step():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(at.launch_counts)
        greedy = []
        for r, p in reqs:
            toks = []
            while not r.out_queue.empty():
                kind, t = r.out_queue.get_nowait()
                if kind == "token":
                    toks.append(t)
            if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
                raise SystemExit(f"serve_head_dims_{name}: a request returned {len(toks)} tokens")
            greedy.append((r, p, toks))
        emit({"phase": "serve_head_dims", "model": name, "head_dim": cfg.head_dim,
              "q_heads_per_kv_head": cfg.num_attention_heads // cfg.num_key_value_heads,
              "requests": len(reqs), "wall_s": wall, "metrics": eng.metrics, "launches": counts})
        missing = [k for k, c in counts.items() if c == 0]
        if missing or eng.metrics["spec_windows"] <= 0:
            raise SystemExit(f"serve_head_dims_{name}: not launched: {missing}; {eng.metrics}")
        check_logprobs(eng, greedy, cfg, f"serve_head_dims_{name}", context_bound=None)
        out[name] = counts
        del eng, qp, params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def teacher_forced(params, cfg, tokens, n_prompt, quant_mode, attn_mode, dev):
    """Prefill logits of the prompt's last position, then one logits row per
    teacher-forced decode step."""
    import torch

    from paroquant_tpu_torch.models.decoder import KVCache, decode_step, prefill

    cache = KVCache.create(cfg, 1, 384, torch.bfloat16, dev)
    logits, cache = prefill(params, cfg, tokens[:, :n_prompt], cache,
                            quant_mode=quant_mode, attn_mode=attn_mode)
    out = [logits]
    for i in range(n_prompt, tokens.shape[1]):
        logits, cache = decode_step(params, cfg, tokens[:, i : i + 1], cache, quant_mode=quant_mode)
        out.append(logits)
    return torch.cat(out).float()


# A Gemma-class dense model at small width: its embedding scale, post
# norms, sliding windows and softcaps run in decode_step too.
GEMMA_DENSE = dict(model_type="gemma3_text", vocab_size=512, hidden_size=256,
                   intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, gemma_norm=True, post_norms=True,
                   hidden_act="gelu_pytorch_tanh", sliding_window=8, sliding_window_pattern=2,
                   rope_local_theta=10_000.0, query_pre_attn_scalar=48.0, logit_softcap=30.0,
                   attn_logit_softcap=50.0)


def check_decode_has_no_sync(models, dev):
    """decode_step must not wait for the device (so that a CUDA graph can
    capture it later): torch raises on any synchronising call under sync
    debug mode "error". `models` maps a name to (params, config)."""
    import torch

    from paroquant_tpu_torch.models.decoder import KVCache, decode_step, prefill

    for name, (params, cfg) in models.items():
        cache = KVCache.create(cfg, 1, 160, torch.bfloat16, dev)
        tok = torch.ones((1, 128), dtype=torch.int32, device=dev)
        logits, cache = prefill(params, cfg, tok, cache, quant_mode="auto", attn_mode="flash")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                logits, cache = decode_step(params, cfg, nxt, cache, quant_mode="auto")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        emit({"phase": "decode_no_sync", "model": name, "steps": 2, "ok": True})


def gemma_dense_model(dev):
    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.models import ModelConfig, init_params, merge_projections

    cfg = ModelConfig(**GEMMA_DENSE)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), torch.bfloat16, dev)
    return merge_projections(
        quantize_model_rtn(params, cfg, hadamard=True, quantize_lm_head=True, device=dev), cfg), cfg


def qwen3_model(dev):
    """Qwen3-0.6B at full width: random bf16 weights from a seeded
    torch.Generator, Hadamard RTN W4 with a W4 lm_head, merged projections."""
    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.models import PRESETS, init_params, merge_projections

    cfg = PRESETS["qwen3-0.6b"]
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    qparams = merge_projections(
        quantize_model_rtn(params, cfg, hadamard=True, quantize_lm_head=True, device=dev), cfg)
    del params
    torch.cuda.synchronize()
    emit({"phase": "model", "preset": "qwen3-0.6b", "layers": cfg.num_hidden_layers,
          "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
          "build_s": time.perf_counter() - t0})
    return qparams, cfg


def check_routes(rm, phase):
    """K1/K2's calls by route since the counts were reset; every W4A16 call at
    M <= 16 must have taken the one-launch route, every a8 call at M <= 16
    the RA8 route (the lm_head's, once a decode step), and both must have
    run."""
    routes = {k: dict(v) for k, v in rm.route_counts.items()}
    stray = {k: (v["passes_w4a16_m16"], v["passes_a8_m16"]) for k, v in routes.items()
             if v["passes_w4a16_m16"] or v["passes_a8_m16"]}
    if stray:
        raise SystemExit(f"{phase}: K1/K2 calls at M <= 16 (W4A16, a8) took the passes: {stray}")
    for route in ONE_LAUNCH_ROUTES:
        if not any(v[route] for v in routes.values()):
            raise SystemExit(f"{phase}: no K1/K2 call took the {route} route")
    return routes


def main_path(qparams, cfg, dev):
    import torch

    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm
    from paroquant_tpu_torch.serve import Generator, SamplingParams

    gen = Generator(qparams, cfg, quant_mode="auto", attn_mode="flash", device=dev)
    prompt_gen = torch.Generator().manual_seed(1)
    requests = [  # prompt length, sampling
        (16, SamplingParams(max_tokens=64, temperature=0.0)),
        (256, SamplingParams(max_tokens=64, temperature=0.0)),
        (100, SamplingParams(max_tokens=64, temperature=0.0)),
        (512, SamplingParams(max_tokens=64, temperature=0.8, top_p=0.95, top_k=50)),
    ]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=prompt_gen).tolist()
               for n, _ in requests]
    gen.generate(prompts[0], SamplingParams(max_tokens=4, temperature=0.0))  # warm-up

    rm.reset_launch_counts()
    at.reset_launch_counts()
    results = []
    for prompt, (n, sp) in zip(prompts, requests):
        torch.cuda.synchronize()
        res = gen.generate(prompt, sp, torch.Generator(device=dev).manual_seed(2))
        results.append(res)
    torch.cuda.synchronize()
    counts = {k: rm.launch_counts[k] for k in SLICE1_W4}
    counts["flash_attention"] = at.launch_counts["flash_attention"]
    variants = {k: {"w4a16": v[0], "a8": v[1]} for k, v in rm.variant_counts.items()}
    routes = check_routes(rm, "main_path")
    for (n, sp), res in zip(requests, results):
        toks = res.token_ids
        ok = len(toks) == sp.max_tokens and all(0 <= t < cfg.vocab_size for t in toks)
        emit({"phase": "request", "prompt_tokens": n, "greedy": sp.greedy,
              "new_tokens": len(toks), "prefill_ms": res.stats.ttft * 1e3,
              "decode_tok_s": res.stats.tokens_per_second, "ok": ok, "first_tokens": toks[:8]})
        if not ok:
            raise SystemExit(f"request with a {n}-token prompt returned {len(toks)} tokens")
    emit({"phase": "launches", "counts": counts, "variants": variants, "routes": routes})
    missing = [k for k, c in counts.items() if c == 0]
    if missing or variants["rot_w4_matmul"]["a8"] == 0:
        raise SystemExit(f"kernels not launched on the main path: {missing or 'rot_w4_matmul a8'}")

    from paroquant_tpu_torch.utils.profiling import profile_decode, profile_prefill

    emit({"phase": "decode_profile", "prompt_tokens": 256, "quant_mode": "auto",
          **profile_decode(qparams, cfg, prompt_len=256, steps=16, device=dev)})
    # K3's share of a 512-token prefill (time to first token): one call a layer
    pre = profile_prefill(qparams, cfg, prompt_len=512, device=dev)
    emit({"phase": "prefill_profile", "prompt_tokens": 512, "quant_mode": "auto", **pre})
    if pre["port_kernel_calls_per_step"]["flash_attention"] != cfg.num_hidden_layers:
        raise SystemExit(f"a 512-token prefill called K3 "
                         f"{pre['port_kernel_calls_per_step']['flash_attention']} times, "
                         f"not once a layer")
    check_decode_has_no_sync(
        {"qwen3-0.6b": (qparams, cfg), "gemma3-dense-small": gemma_dense_model(dev)}, dev)

    # teacher-forced logits: kernel path vs the path JAX's tests hold the kernels to
    tokens = torch.tensor([prompts[1] + results[1].token_ids[:8]], dtype=torch.int32, device=dev)
    ker = teacher_forced(qparams, cfg, tokens, 256, "auto", "flash", dev)
    ref = teacher_forced(qparams, cfg, tokens, 256, "xla", "einsum", dev)
    rel = ((ker - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
    finite = bool(torch.isfinite(ker).all() and torch.isfinite(ref).all())
    agree = [int(a) == int(b) for a, b in zip(ker.argmax(-1), ref.argmax(-1))]
    emit({"phase": "logits_check", "rel_fro_err": rel, "bound": TOL_E2E, "finite": finite,
          "argmax_agree": sum(agree), "steps": len(agree), "shape": list(ker.shape)})
    if not finite or max(rel) > TOL_E2E or ker.shape != (9, cfg.vocab_size):
        raise SystemExit("kernel-path logits disagree with the reference path")
    return counts


# ---------------------------------------------------------------------------
# phase 3b: the paged attention kernels (K4, K5)
# ---------------------------------------------------------------------------

PAGED = dict(B=8, Hq=16, Hkv=8, D=128, ps=128, maxP=16)  # Qwen3-0.6B at max_len 2048
PAGED_LENS = (1, 130, 512, 1000, 2047, 64, 300, 777)  # K4: including the current token
PAGED_W = 5  # K5: current token + 4 drafts


def paged_inputs(gen, dev, *, B, Hq, Hkv, D, ps, maxP, quant, dtype=None, n_spare=1):
    """A pool with every slot's maxP pages at shuffled ids (plus spare
    pages), random rows, and int8 scales when `quant`."""
    import torch

    dtype = dtype or torch.bfloat16
    P = B * maxP + n_spare
    table = torch.randperm(P, generator=gen, device=dev)[: B * maxP].reshape(B, maxP).to(torch.int32)
    if quant:
        k = torch.randint(-127, 128, (P, ps, Hkv, D), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (P, ps, Hkv, D), generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand(P, Hkv, ps, generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(P, Hkv, ps, generator=gen, device=dev) * 0.02 + 1e-3
        return table, k, v, ks, vs
    k = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(P, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    return table, k, v, None, None


def paged_sdpa(q4, table, k, v, ks, vs, base, dev):
    """The library yardstick: K/V gathered to contiguous [B, Hkv, S, D] bf16
    BEFORE the timed call (the gather is not timed), then one
    scaled_dot_product_attention with enable_gqa and a boolean mask."""
    import torch

    B, W, Hq, D = q4.shape
    _, ps, Hkv, _ = k.shape
    t = table.long()
    kg, vg = k[t].float(), v[t].float()  # [B, maxP, ps, Hkv, D]
    if ks is not None:
        kg = kg * ks[t].transpose(-1, -2)[..., None]
        vg = vg * vs[t].transpose(-1, -2)[..., None]
    S = t.shape[1] * ps
    kc = kg.reshape(B, S, Hkv, D).transpose(1, 2).to(torch.bfloat16).contiguous()
    vc = vg.reshape(B, S, Hkv, D).transpose(1, 2).to(torch.bfloat16).contiguous()
    qc = q4.transpose(1, 2).to(torch.bfloat16).contiguous()  # [B, Hq, W, D]
    qpos = base.long()[:, None] + torch.arange(W, device=dev)[None, :]
    mask = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]  # [B,1,W,S]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=mask, scale=D**-0.5, enable_gqa=True)


def row_err_ratio(y, y_ref, lead):
    """Worst, over the query rows (the first `lead` dims of the output: slot,
    window row, head), of the row's max abs error over its max |plain
    output|. A row whose plain output is all 0 (no valid key) must come out
    exactly 0. Each row is held to its own scale, so a short slot's large
    output does not hide a long slot's misread page."""
    import torch

    e = (y - y_ref).abs().flatten(lead).amax(-1)
    r = y_ref.abs().flatten(lead).amax(-1)
    ratio = torch.where(r > 0, e / r.clamp_min(1e-30),
                        torch.where(e > 0, torch.full_like(e, float("inf")), torch.zeros_like(e)))
    return ratio.max().item()


def paged_bound(lens_keys, W, quant, *, B, Hq, Hkv, D, ps, maxP):
    """Bytes of the K/V rows the function needs (each slot's keys below its
    length, clamped to maxP * ps, plus their int8 scales), q, the output and
    the table, over the HBM rate; operations of the valid (query, key) pairs
    over the bf16 peak."""
    elem = 1 if quant else 2
    rows = sum(min(n, maxP * ps) for n in lens_keys)
    nbytes = rows * Hkv * (2 * D * elem + (2 * 4 if quant else 0))
    nbytes += 2 * B * W * Hq * D * 2 + B * maxP * 4 + B * 4
    pairs = sum(min(n - W + 1 + w, maxP * ps) for n in lens_keys for w in range(W))
    return bound(nbytes, 4 * Hq * D * pairs, "bf16")


def check_paged(flush, gen, dev):
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    shp = PAGED
    B, Hq, D = shp["B"], shp["Hq"], shp["D"]
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    rows = []
    for quant in (False, True):
        table, k, v, ks, vs = paged_inputs(gen, dev, quant=quant, **shp)
        for kernel in ("paged_decode_attention", "paged_window_attention_kernel"):
            W = 1 if kernel == "paged_decode_attention" else PAGED_W
            if W == 1:
                q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
                seq = lens
                run = lambda: at.paged_decode_attention(q, k, v, table, seq, scale=D**-0.5,
                                                        k_scales=ks, v_scales=vs)
                plain = lambda: at.paged_decode_attention_plain(q, k, v, table, seq, scale=D**-0.5,
                                                                k_scales=ks, v_scales=vs)
                q4, base = q[:, None], seq - 1
            else:
                q = torch.randn(B, W, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
                seq = lens - 1  # the window starts at the current token
                run = lambda: at.paged_window_attention_kernel(q, k, v, table, seq, scale=D**-0.5,
                                                               k_scales=ks, v_scales=vs)
                plain = lambda: at.paged_window_attention_plain(q, k, v, table, seq, scale=D**-0.5,
                                                                k_scales=ks, v_scales=vs)
                q4, base = q, seq
            y, y_ref = run().float(), plain().float()
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            ratio = row_err_ratio(y, y_ref, y.dim() - 1)
            # the split's partials merge in a fixed order: a second call gives the same bits
            same = torch.equal(run(), run())
            emit({"phase": "paged_determinism", "kernel": kernel,
                  "case": "int8" if quant else "bf16", "bitwise_equal": same})
            if not same:
                raise SystemExit(f"{kernel}: two calls on the same inputs differ")
            ms = median_ms(run, KERNEL_REPS, flush)
            plain_ms = median_ms(plain, PLAIN_REPS, flush)
            lib_ms = median_ms(paged_sdpa(q4, table, k, v, ks, vs, base, dev), KERNEL_REPS, flush)
            n_keys = [int(n) + W for n in base.tolist()]
            b_ms, b_by = paged_bound(n_keys, W, quant, **shp)
            row = dict(kernel=kernel, case="int8" if quant else "bf16", B=B, W=W,
                       lens=list(PAGED_LENS), split=at.paged_split(B, shp["Hkv"], 1, shp["maxP"],
                                                                   shp["ps"]),
                       max_abs_err=err, row_err_ratio=ratio,
                       tol=TOL_KERNEL, us=ms * 1e3,
                       plain_us=plain_ms * 1e3, library_us=lib_ms * 1e3,
                       library="sdpa(enable_gqa) on K/V gathered to contiguous bf16 beforehand; "
                               "the gather is not timed",
                       bound_us=b_ms * 1e3, bound_by=b_by,
                       ok=ratio <= TOL_KERNEL and bool(torch.isfinite(y).all()))
            emit({"phase": "kernel_check", **row})
            rows.append(row)
        del table, k, v, ks, vs
    rows += check_paged_step(flush, gen, dev)
    rows += check_paged_rows(flush, gen, dev)
    return rows


def check_paged_step(flush, gen, dev):
    """K4 at the engine step's own shape, the one `paged_decode_profile`
    runs (8 slots of 256 cached tokens and the current one, pages of 128,
    maxP 3 for 16 steps), so that this row and that line read together."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    shp = dict(PAGED, maxP=-(-(256 + 3 * 16 + 4) // 128))
    B, Hq, D = shp["B"], shp["Hq"], shp["D"]
    table, k, v, _, _ = paged_inputs(gen, dev, quant=False, **shp)
    seq = torch.full((B,), 257, dtype=torch.int32, device=dev)
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    run = lambda: at.paged_decode_attention(q, k, v, table, seq, scale=D**-0.5)
    plain = lambda: at.paged_decode_attention_plain(q, k, v, table, seq, scale=D**-0.5)
    y, y_ref = run().float(), plain().float()
    torch.cuda.synchronize()
    ratio = row_err_ratio(y, y_ref, 2)
    ms = median_ms(run, KERNEL_REPS, flush)
    plain_ms = median_ms(plain, PLAIN_REPS, flush)
    lib_ms = median_ms(paged_sdpa(q[:, None], table, k, v, None, None, seq - 1, dev),
                       KERNEL_REPS, flush)
    b_ms, b_by = paged_bound([257] * B, 1, False, **shp)
    row = dict(kernel="paged_decode_attention", case="step 8x256 bf16", B=B, W=1,
               maxP=shp["maxP"], split=at.paged_split(B, shp["Hkv"], 1, shp["maxP"], shp["ps"]),
               max_abs_err=(y - y_ref).abs().max().item(), row_err_ratio=ratio, tol=TOL_KERNEL,
               us=ms * 1e3, plain_us=plain_ms * 1e3, library_us=lib_ms * 1e3,
               bound_us=b_ms * 1e3, bound_by=b_by,
               ok=ratio <= TOL_KERNEL and bool(torch.isfinite(y).all()))
    emit({"phase": "kernel_check", **row})
    return [row]


def check_paged_rows(flush, gen, dev):
    """K5 at 16 query heads per kv head (Hq 32, Hkv 2, D 128, bf16 pool,
    PAGED_LENS): a window of 4 (64 rows, one chunk per slot and kv head)
    and of 5 (80 rows, split into two chunks of 40 that each read the
    slot's K/V), timed beside the bound: the cost of the row split."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    shp = dict(PAGED, Hq=32, Hkv=2)
    B, Hq, D = shp["B"], shp["Hq"], shp["D"]
    seq = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev) - 1
    table, k, v, _, _ = paged_inputs(gen, dev, quant=False, **shp)
    rows = []
    for W in (4, 5):
        q = torch.randn(B, W, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
        run = lambda: at.paged_window_attention_kernel(q, k, v, table, seq, scale=D**-0.5)
        plain = lambda: at.paged_window_attention_plain(q, k, v, table, seq, scale=D**-0.5)
        y, y_ref = run().float(), plain().float()
        torch.cuda.synchronize()
        ratio = row_err_ratio(y, y_ref, y.dim() - 1)
        ms = median_ms(run, KERNEL_REPS, flush)
        plain_ms = median_ms(plain, PLAIN_REPS, flush)
        lib_ms = median_ms(paged_sdpa(q, table, k, v, None, None, seq, dev), KERNEL_REPS, flush)
        b_ms, b_by = paged_bound([int(n) + W for n in seq.tolist()], W, False, **shp)
        row = dict(kernel="paged_window_attention_kernel", case=f"R{W * Hq // shp['Hkv']} bf16",
                   B=B, W=W, Hq=Hq, Hkv=shp["Hkv"], max_abs_err=(y - y_ref).abs().max().item(),
                   row_err_ratio=ratio, tol=TOL_KERNEL, us=ms * 1e3, plain_us=plain_ms * 1e3,
                   library_us=lib_ms * 1e3, bound_us=b_ms * 1e3, bound_by=b_by,
                   ok=ratio <= TOL_KERNEL and bool(torch.isfinite(y).all()))
        emit({"phase": "kernel_check", **row})
        rows.append(row)
    return rows


def paged_edges(gen, dev, record):
    """K4/K5's other branches at small shapes: sliding window, softcap, head
    dims 24, 32, 64 and 256, f32 pools and queries, page sizes 8/16/64, one
    kv head (grp 8), 16 query heads per kv head (K5: 80 rows), a K5 window
    that runs past maxP (clamped), an empty K4 slot (gives 0)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    cases = [
        ("window", dict(D=128, ps=128, Hq=16, Hkv=8), torch.bfloat16, dict(sliding_window=100)),
        ("softcap", dict(D=128, ps=128, Hq=16, Hkv=8), torch.bfloat16, dict(logit_softcap=30.0)),
        ("D64_ps16", dict(D=64, ps=16, Hq=4, Hkv=2), torch.bfloat16, {}),
        ("f32_ps64", dict(D=128, ps=64, Hq=8, Hkv=4), torch.float32, {}),
        ("ps8_grp8", dict(D=128, ps=8, Hq=8, Hkv=1), torch.bfloat16, dict(sliding_window=20)),
        # head dims outside 64/128 (24: 8-byte rows of an int8 pool), with f32
        # and bf16 queries and pools; each case also runs an int8 pool
        ("D24_ps8", dict(D=24, ps=8, Hq=4, Hkv=2), torch.bfloat16, dict(sliding_window=20)),
        ("D32_f32", dict(D=32, ps=16, Hq=4, Hkv=2), torch.float32, dict(logit_softcap=30.0)),
        ("D32_bf16", dict(D=32, ps=64, Hq=4, Hkv=2), torch.bfloat16, dict(sliding_window=100)),
        ("D256_f32", dict(D=256, ps=64, Hq=4, Hkv=2), torch.float32, {}),
        ("D256_bf16", dict(D=256, ps=128, Hq=8, Hkv=2), torch.bfloat16, dict(logit_softcap=30.0)),
        # 16 query heads per kv head: K5's window of 5 is 80 rows, two chunks
        ("R80_D128", dict(D=128, ps=64, Hq=32, Hkv=2), torch.bfloat16, {}),
        ("R80_D256", dict(D=256, ps=64, Hq=16, Hkv=1), torch.bfloat16, dict(sliding_window=50)),
    ]
    for name, dims, dt, kw in cases:
        B, maxP = 4, 6
        shp = dict(B=B, maxP=maxP, **dims)
        cap = maxP * dims["ps"]
        lens = torch.tensor([1, cap // 3, cap - 7, cap], dtype=torch.int32, device=dev)
        for quant in (False, True):
            table, k, v, ks, vs = paged_inputs(gen, dev, quant=quant, dtype=dt, **shp)
            kw2 = dict(scale=dims["D"] ** -0.5, k_scales=ks, v_scales=vs, **kw)
            q = torch.randn(B, dims["Hq"], dims["D"], generator=gen, device=dev).to(dt)
            tag = f"{name} {'int8' if quant else dt}"
            record("paged_decode_attention", tag, at.paged_decode_attention(q, k, v, table, lens, **kw2),
                   at.paged_decode_attention_plain(q, k, v, table, lens, **kw2), lead=2)
            qw = torch.randn(B, PAGED_W, dims["Hq"], dims["D"], generator=gen, device=dev).to(dt)
            wl = lens - 1  # the last slot's window runs 4 rows past maxP * ps
            record("paged_window_attention_kernel", tag,
                   at.paged_window_attention_kernel(qw, k, v, table, wl, **kw2),
                   at.paged_window_attention_plain(qw, k, v, table, wl, **kw2), lead=3)
    table, k, v, _, _ = paged_inputs(gen, dev, quant=False, B=2, maxP=2, D=128, ps=128, Hq=16, Hkv=8)
    q = torch.randn(2, 16, 128, generator=gen, device=dev).to(torch.bfloat16)
    empty = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    y = at.paged_decode_attention(q, k, v, table, empty, scale=0.1)
    if y[0].abs().max().item() != 0.0:
        raise SystemExit("K4 gave a nonzero output for a slot with seq_lens == 0")
    record("paged_decode_attention", "empty slot", y, at.paged_decode_attention_plain(
        q, k, v, table, empty, scale=0.1), lead=2)
    paged_split_edges(gen, dev, record)


def paged_split_edges(gen, dev, record):
    """K4/K5's split over pages: maxP 1 (one split, no merge); at B 8,
    Hkv 8, pages of 32, maxP 16 (paged_split: 8 splits of 2 pages, a tile
    of 64 keys spanning two pages) slots whose live pages end on a split
    boundary and mid-split, a sliding window that skips whole splits, an
    empty K4 slot beside full ones, and f32 queries over int8 pools; each
    with bf16 and int8 pools."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    one = dict(B=4, maxP=1, D=128, ps=128, Hq=16, Hkv=8)
    wide = dict(B=8, maxP=16, D=128, ps=32, Hq=16, Hkv=8)
    splits, pps = at.paged_split(8, 8, 1, 16, 32)
    if splits < 2 or pps < 2 or at.paged_split(4, 8, 1, 1, 128)[0] != 1:
        raise SystemExit(f"paged_split gave {splits} x {pps} pages at the split edges' shape")
    span, cap = pps * 32, 16 * 32  # keys of one split, of the table
    # K4 lengths (with the current token): 1 key; a split boundary; mid-split;
    # mid-page; the whole table; one page; a boundary of a later split; one
    # past it
    ends = [1, span, span + 32, 2 * span - 5, cap, 32, 3 * span, 3 * span + 1]
    cases = [
        ("maxP1", one, torch.bfloat16, {}, [1, 40, 127, 128]),
        ("split_ends", wide, torch.bfloat16, {}, ends),
        ("split_ends_softcap", wide, torch.bfloat16, dict(logit_softcap=30.0), ends),
        ("window_skips_splits", wide, torch.bfloat16, dict(sliding_window=100),
         [cap, 450, 3 * span + 7, 130, 64, 2 * span, 300, 500]),
        ("empty_beside_full", wide, torch.bfloat16, {}, [0, cap, 0, 450, 1, 0, 3 * span, 0]),
        ("f32_q", wide, torch.float32, dict(sliding_window=300), ends),
    ]
    for name, shp, dt, kw, lens in cases:
        B = shp["B"]
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        for quant in (False, True):
            table, k, v, ks, vs = paged_inputs(gen, dev, quant=quant, dtype=torch.bfloat16, **shp)
            if dt == torch.float32 and not quant:
                k, v = k.float(), v.float()
            kw2 = dict(scale=shp["D"] ** -0.5, k_scales=ks, v_scales=vs, **kw)
            q = torch.randn(B, shp["Hq"], shp["D"], generator=gen, device=dev).to(dt)
            tag = f"{name} {'int8' if quant else k.dtype}"
            y = at.paged_decode_attention(q, k, v, table, lens, **kw2)
            if (y[lens == 0] != 0).any():
                raise SystemExit(f"K4 gave a nonzero output for an empty slot ({tag})")
            record("paged_decode_attention", tag, y,
                   at.paged_decode_attention_plain(q, k, v, table, lens, **kw2), lead=2)
            # K5: the window's last row ends where K4's slot does
            qw = torch.randn(B, PAGED_W, shp["Hq"], shp["D"], generator=gen, device=dev).to(dt)
            wl = torch.clamp(lens - PAGED_W, min=0)
            record("paged_window_attention_kernel", tag,
                   at.paged_window_attention_kernel(qw, k, v, table, wl, **kw2),
                   at.paged_window_attention_plain(qw, k, v, table, wl, **kw2), lead=3)


# ---------------------------------------------------------------------------
# phase 5: the continuous-batching engine over the paged pool
# ---------------------------------------------------------------------------


def serve_requests(cfg, quick=False):
    """(prompt, SamplingParams, submitted late, cancel after its first
    tokens) of the serve phase: prompts of 16 to 1000 tokens, two sharing a
    512-token prefix, three greedy ones made of a repeated random block (so
    that prompt-lookup finds drafts), three sampled ones."""
    import torch

    from paroquant_tpu_torch.serve import SamplingParams

    g = torch.Generator().manual_seed(5)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    def greedy():
        return SamplingParams(max_tokens=64, temperature=0.0)

    if quick:  # serve_int8kv: a short mix, one request speculative
        return [(rand(24) * 8, greedy(), False, False), (rand(300), greedy(), False, False),
                (rand(40), SamplingParams(max_tokens=64, temperature=0.8, top_p=0.95, seed=3),
                 False, False), (rand(700), greedy(), False, False)]
    shared = rand(512)
    return [
        (shared + rand(100), greedy(), False, False),
        (rand(24) * 8, greedy(), False, False),
        (rand(16) * 12, greedy(), False, False),
        (rand(32) * 10, greedy(), False, False),
        (rand(16), greedy(), False, False),
        (rand(1000), greedy(), False, False),
        (rand(300), SamplingParams(max_tokens=64, temperature=0.8, top_p=0.95, top_k=50, seed=7),
         False, False),
        (rand(256), greedy(), False, True),
        (rand(128), SamplingParams(max_tokens=64, temperature=0.7, repetition_penalty=1.3, seed=8),
         True, False),
        (rand(64), SamplingParams(max_tokens=64, temperature=0.9, seed=9, top_logprobs=5,
                                  logit_bias=((11, 5.0), (12, -100.0))), True, False),
        (shared + rand(37), greedy(), True, False),
        (rand(700), greedy(), True, False),
    ]


def check_logprobs(eng, greedy, cfg, phase, context_bound=TOL_LOGPROB):
    """Hold each greedy request's per-token logprobs (its first token from
    the prefill, prefix-hit rows gathered from the pool included; the rest
    from burst decode through K4 and verify windows through K5, each fed the
    tokens sampled on the device) against eng.score_sync(prompt + tokens):
    one contiguous prefill of the whole sequence (K3 on the card), which
    never touches the paged pool. The worst gap must stay within
    TOL_LOGPROB, and a wrong context (the first half of the longest prompt
    replaced by other tokens) must move the scores by more than that on
    average, or the check could not see a misread context. `greedy` holds
    (request, prompt, tokens). context_bound None: the wrong context must
    move the scores by more than the worst gap (the small random models of
    serve_head_dims move them by only a few tenths of a nat)."""
    import torch

    gaps = []
    for r, p, toks in greedy:
        if len(r.logprobs) != len(toks):
            raise SystemExit(f"{phase}: {len(r.logprobs)} logprobs for {len(toks)} tokens")
        ref = eng.score_sync(p + toks)[len(p):]
        gaps.append(max(abs(a - b) for a, b in zip(r.logprobs, ref)))
    _, p, toks = max(greedy, key=lambda t: len(t[1]))
    half = len(p) // 2
    wrong = torch.randint(0, cfg.vocab_size, (half,), generator=torch.Generator().manual_seed(13))
    ref = eng.score_sync(p + toks)[len(p):]
    moved = eng.score_sync(wrong.tolist() + p[half:] + toks)[len(p):]
    context_move = statistics.mean(abs(a - b) for a, b in zip(ref, moved))
    emit({"phase": f"{phase}_logprob_check", "requests": len(greedy), "worst_gap": max(gaps),
          "gaps": gaps, "bound": TOL_LOGPROB, "wrong_context_mean_move": context_move})
    if max(gaps) > TOL_LOGPROB or context_move <= (context_bound or max(gaps)):
        raise SystemExit(f"{phase}: engine logprobs off the contiguous prefill's by {max(gaps)} "
                         f"(bound {TOL_LOGPROB}, a wrong context moves them {context_move})")


def serve(qparams, cfg, dev, *, kv_quant=None):
    """Drive Engine.step() over serve_requests() until every request is
    done; reset the launch counts just before and read them just after."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm
    from paroquant_tpu_torch.serve import Engine, SamplingParams

    phase = "serve" if kv_quant is None else "serve_int8kv"
    eng = Engine(qparams, cfg, max_batch=8, max_len=2048, page_size=128, prefill_chunk=256,
                 quant_mode="auto", decode_burst=8, prefix_caching=True, spec_k=4,
                 kv_quant=kv_quant, device=dev)
    eng.generate_sync(list(range(1, 300)), SamplingParams(max_tokens=10, temperature=0.0))  # warm-up
    for key in eng.metrics:
        eng.metrics[key] = 0
    eng._ttfts.clear()
    eng._step_samples.clear()
    stream = serve_requests(cfg, quick=kv_quant is not None)
    torch.cuda.synchronize()
    rm.reset_launch_counts()
    at.reset_launch_counts()
    t0 = time.perf_counter()
    pairs = [(eng.submit(p, sp), (p, sp, c)) for p, sp, late, c in stream if not late]
    cancelled = set()
    ticks = 0
    while True:
        busy = eng.step()
        ticks += 1
        if ticks == 2:  # these queue behind the first ones
            pairs += [(eng.submit(p, sp), (p, sp, c)) for p, sp, late, c in stream if late]
        for r, (_, _, cancel) in pairs:
            if cancel and r.request_id not in cancelled and len(r.logprobs) >= 2:
                eng.cancel(r)
                cancelled.add(r.request_id)
        if not busy and ticks > 2:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict({k: rm.launch_counts[k] for k in SLICE1_W4}, **at.launch_counts)
    variants = {k: {"w4a16": v[0], "a8": v[1]} for k, v in rm.variant_counts.items()}
    variants.update({k: {"float": v[0], "int8": v[1]} for k, v in at.variant_counts.items()})
    routes = check_routes(rm, phase)
    bad, greedy = [], []
    for r, (p, sp, cancel) in pairs:
        toks = []
        while not r.out_queue.empty():
            kind, t = r.out_queue.get_nowait()
            if kind == "token":
                toks.append(t)
        state = "cancelled" if cancel else ("length" if len(toks) == sp.max_tokens else "stop")
        ok = (cancel or len(toks) == sp.max_tokens) and all(0 <= t < cfg.vocab_size for t in toks)
        emit({"phase": f"{phase}_request", "prompt_tokens": len(p), "greedy": sp.greedy,
              "ttft_ms": r.ttft * 1e3, "queue_ms": r.queue_time * 1e3,
              "prefill_service_ms": r.prefill_service_time * 1e3, "new_tokens": len(toks),
              "finish": state, "top_logprobs": len(r.top_logprobs), "ok": ok})
        if not ok:
            bad.append(len(p))
        if sp.greedy and not cancel:
            greedy.append((r, p, toks))
    emit({"phase": phase, "requests": len(stream), "wall_s": wall, "ticks": ticks,
          "generated_tok_s": eng.metrics["tokens_generated"] / wall, "metrics": eng.metrics,
          "ttft": eng.ttft_stats(), "step_time": eng.step_time_stats(),
          "free_pages": len(eng.free_pages) + len(eng.cached_idle), "pool_pages": eng.trash_page})
    emit({"phase": f"{phase}_launches", "counts": counts, "variants": variants, "routes": routes})
    if bad:
        raise SystemExit(f"{phase}: requests with prompts of {bad} tokens did not return their tokens")
    if kv_quant is None:
        missing = [k for k, c in counts.items() if c == 0]
        if variants["rot_w4_matmul"]["a8"] == 0:
            missing.append("rot_w4_matmul a8")
        if missing:
            raise SystemExit(f"serve: kernels not launched: {missing}")
        if eng.metrics["prefix_hit_tokens"] <= 0 or eng.metrics["spec_windows"] <= 0:
            raise SystemExit(f"serve: no prefix hit or no speculative window: {eng.metrics}")
    else:
        missing = [k for k in ("paged_decode_attention", "paged_window_attention_kernel")
                   if variants[k]["int8"] == 0]
        if missing:
            raise SystemExit(f"serve_int8kv: int8 variants not launched: {missing}")
    if len(eng.free_pages) + len(eng.cached_idle) != eng.trash_page:
        raise SystemExit(f"{phase}: pages leaked")
    check_logprobs(eng, greedy, cfg, phase)
    del eng
    torch.cuda.empty_cache()
    return counts


def paged_teacher_forced(qparams, cfg, tokens, n_prompt, quant_mode, attn_mode, kv_quant, dev):
    """Prefill n_prompt tokens into pages, run the rest of `tokens` but the
    last PAGED_W teacher-forced through paged_decode_step, then one
    paged_verify_step window of PAGED_W. Returns the logits rows (prefill
    last, each decode step, the window's row 0) and the window's tokens."""
    import torch

    from paroquant_tpu_torch.models.decoder import KVCache, model_forward
    from paroquant_tpu_torch.serve.paged import (PagedKVCache, paged_decode_step,
                                                 paged_verify_step, scatter_prefill_kv)

    ps, maxP = 128, 4
    cache = PagedKVCache.create(cfg, maxP + 1, ps, torch.bfloat16, kv_quant=kv_quant, device=dev)
    table = torch.arange(maxP, dtype=torch.int32, device=dev)[None]
    kv = KVCache.create(cfg, 1, n_prompt, torch.bfloat16, dev)
    logits, kv = model_forward(qparams, cfg, tokens[:, :n_prompt], kv, quant_mode=quant_mode,
                               attn_mode="flash" if attn_mode == "kernel" else "einsum")
    rows = [logits[:, -1]]
    lk = torch.stack([k[0].transpose(0, 1) for k in kv.k])
    lv = torch.stack([v[0].transpose(0, 1) for v in kv.v])
    scatter_prefill_kv(cfg, cache, lk, lv, table[0])
    n_dec = tokens.shape[1] - n_prompt - PAGED_W
    for i in range(n_dec):
        pos = torch.full((1,), n_prompt + i, dtype=torch.int32, device=dev)
        lg, cache = paged_decode_step(qparams, cfg, tokens[:, n_prompt + i], pos, table, cache,
                                      quant_mode=quant_mode, attn_mode=attn_mode)
        rows.append(lg)
    pos = torch.full((1,), n_prompt + n_dec, dtype=torch.int32, device=dev)
    toks, _, lg0, cache = paged_verify_step(qparams, cfg, tokens[:, -PAGED_W:], pos, table, cache,
                                            maxP, quant_mode=quant_mode, attn_mode=attn_mode)
    rows.append(lg0)
    return torch.cat(rows).float(), toks


def check_paged_logits(qparams, cfg, dev):
    """The kernel path (auto, K1-K5) against the plain path (xla, the einsum
    paged attention) on a 256-token prompt, 8 teacher-forced decode steps
    and one verify window, with a bf16 and an int8 pool."""
    import torch

    g = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256 + 8 + PAGED_W), generator=g).to(torch.int32)
    tokens = tokens.to(dev)
    for kv_quant in (None, "int8"):
        ker, ktoks = paged_teacher_forced(qparams, cfg, tokens, 256, "auto", "kernel", kv_quant, dev)
        ref, rtoks = paged_teacher_forced(qparams, cfg, tokens, 256, "xla", "einsum", kv_quant, dev)
        rel = ((ker - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
        finite = bool(torch.isfinite(ker).all() and torch.isfinite(ref).all())
        agree = int((ker.argmax(-1) == ref.argmax(-1)).sum())
        emit({"phase": "paged_logits_check", "pool": kv_quant or "bf16", "rel_fro_err": rel,
              "bound": TOL_E2E, "finite": finite, "argmax_agree": agree, "rows": len(rel),
              "verify_tokens_agree": int((ktoks == rtoks).sum()), "window": PAGED_W})
        if not finite or max(rel) > TOL_E2E or ker.shape != (10, cfg.vocab_size):
            raise SystemExit(f"paged kernel-path logits disagree with the plain path ({kv_quant})")


def check_paged_decode_has_no_sync(qparams, cfg, dev):
    """Two paged_decode_steps at B = 8 (and the engine's sampler after each)
    under torch's sync debug mode "error"."""
    import torch

    from paroquant_tpu_torch.serve.paged import PagedKVCache, paged_decode_step
    from paroquant_tpu_torch.serve.sampling import sample_batch

    B, ps, maxP = 8, 128, 4
    cache = PagedKVCache.create(cfg, B * maxP + 1, ps, torch.bfloat16, device=dev)
    table = torch.arange(B * maxP, dtype=torch.int32, device=dev).reshape(B, maxP)
    lens = torch.full((B,), 200, dtype=torch.int32, device=dev)
    toks = torch.ones(B, dtype=torch.int32, device=dev)
    counts = torch.zeros((B, cfg.vocab_size), dtype=torch.int32, device=dev)
    seeds = torch.arange(B, dtype=torch.int64, device=dev)
    temps = torch.full((B,), 0.7, device=dev)
    ones = torch.ones(B, device=dev)
    top_ks = torch.zeros(B, dtype=torch.int32, device=dev)
    paged_decode_step(qparams, cfg, toks, lens, table, cache, quant_mode="auto")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2):
            logits, cache = paged_decode_step(qparams, cfg, toks, lens, table, cache,
                                              quant_mode="auto")
            toks, _, _, _ = sample_batch(logits, seeds, seeds * 0 + i, temps, ones, top_ks,
                                         ones, counts)
            lens = lens + 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "paged_decode_no_sync", "batch": B, "steps": 2, "sampler": True, "ok": True})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    root = Path(__file__).resolve().parent
    if not (root / "paroquant_tpu_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: the paroquant_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit(smi)

    from paroquant_tpu_torch.kernels import build

    build.build_all()
    emit({"phase": "build", **build.build_info})
    report = build.ptxas_report()
    emit({"phase": "ptxas", "lines": report.splitlines()})
    check_flash_spills(report)
    check_rot_spills(report)
    # the tensor-core instructions of K16 (IMMA), K15 (IMMA, its three row
    # tilings, with their ring's 16-byte cp.async) and K17 (HMMA); K18's bulk
    # copies (UBLKCP: cp.async.bulk into shared memory) for f32 and bf16 x
    check_sass("libint8_probe.so", ("IMMA", "HMMA", "LDGSTS"),
               (("int8_dot_kernel", "IMMA", 1), ("int8_stream_kernel", "IMMA", 3),
                ("int8_stream_kernel", "LDGSTS", 3), ("bf16_dot_kernel", "HMMA", 3)))
    check_sass("libunpack_exp.so", ("UBLKCP",), (("stream_kernel", "UBLKCP", 2),))
    check_stream_spills(report)
    # K4/K5's tensor-core instances: bf16 queries over bf16 and int8 pools, 9 tilings each
    check_sass("libpaged_attention.so", ("HMMA",), (("paged_mma_kernel", "HMMA", 18),))
    # K3's tensor-core instances: 4 head-dim buckets (3 with two key groups), exact or not
    check_sass("libflash_attention.so", ("HMMA",), (("flash_mma_kernel", "HMMA", 14),))
    # the one-launch K1/K2 kernel: the rotation's 16-byte loads (LDG.E.128) and
    # the weight ring's 16-byte cp.async (LDGSTS) in all 16 instances
    check_sass("librot_w4_matmul.so", ("LDG.E.128", "LDGSTS"),
               (("rot_w4_one_launch_kernel", "LDG.E.128", 16),
                ("rot_w4_one_launch_kernel", "LDGSTS", 16)))
    # and its K10/K12 instances (16 each) and K13's A8 (8) in the experiments' library
    check_sass("libw4_experiments.so", ("LDG.E.128", "LDGSTS"),
               (("rot_w4_one_launch_kernel", "LDG.E.128", 40),
                ("rot_w4_one_launch_kernel", "LDGSTS", 40)))
    # and K7's BF (8) and K9's I4 instances (16) in the variants' library
    check_sass("libw4_variants.so", ("LDG.E.128", "LDGSTS"),
               (("rot_w4_one_launch_kernel", "LDG.E.128", 24),
                ("rot_w4_one_launch_kernel", "LDGSTS", 24)))
    # and K1/K2's a8 RA8 instances (16), their dot on dp4a (IDP.4A), and K6's PL (8)
    check_sass("librot_w4_a8.so", ("LDG.E.128", "LDGSTS", "IDP.4A"),
               (("rot_w4_one_launch_kernel", "LDG.E.128", 16),
                ("rot_w4_one_launch_kernel", "LDGSTS", 16),
                ("rot_w4_one_launch_kernel", "IDP.4A", 16)))
    check_sass("libw4_plain.so", ("LDG.E.128", "LDGSTS"),
               (("rot_w4_one_launch_kernel", "LDG.E.128", 8),
                ("rot_w4_one_launch_kernel", "LDGSTS", 8)))
    # and K19's BC (8), K20's MF (8) and K22's WM (8)
    for lib in ("libw4_opair.so", "libw4_mulfloor.so", "libw4_wordmask.so"):
        check_sass(lib, ("LDG.E.128", "LDGSTS"),
                   (("rot_w4_one_launch_kernel", "LDG.E.128", 8),
                    ("rot_w4_one_launch_kernel", "LDGSTS", 8)))
    # and K8/K11's DQ instances, with the dequant's two roundings
    check_dequant_sass()

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(123)
    mm_rows = check_matmuls(flush, gen, dev)
    fa_rows = check_flash(flush, gen, dev)
    pa_rows = check_paged(flush, gen, dev)
    w4_rows = check_w4_variants(flush, gen, dev)
    w4x_rows = check_w4_experiments(flush, gen, dev)
    i8_rows = check_int8_probe(flush, gen, dev)
    ux_rows = check_unpack_exp(flush, dev)
    edge_rows = check_edges(gen, dev)
    bad = [r for r in mm_rows + fa_rows + pa_rows + w4_rows + w4x_rows + i8_rows + ux_rows
           + edge_rows if not r["ok"]]
    if bad:
        raise SystemExit(f"{len(bad)} kernel checks missed their tolerance")
    del flush
    bench_counts = kernel_bench(dev)  # slice 3: the kernel benchmarks (K1, K6-K9)
    exp_counts = w4_experiments(dev)  # slice 4: the experiment scripts (K10-K13)
    probe_counts = int8_probe(dev)  # slice 5: the int8 tensor-core probe (K14-K17)
    unpack_counts = unpack_exp(dev)  # slice 6: the unpack experiments (K18-K22)
    serve_head_dims(dev)  # K3-K5 at head dims 32 and 256, 80 rows

    qparams, cfg = qwen3_model(dev)
    counts = main_path(qparams, cfg, dev)  # slice 1: the Generator (K1-K3)
    counts.update({k: v for k, v in serve(qparams, cfg, dev).items()  # slice 2: the Engine (K1-K5)
                   if k.startswith("paged")})
    serve(qparams, cfg, dev, kv_quant="int8")
    check_paged_logits(qparams, cfg, dev)
    check_paged_decode_has_no_sync(qparams, cfg, dev)

    from paroquant_tpu_torch.utils.profiling import profile_paged_decode

    emit({"phase": "paged_decode_profile", "batch": 8, "context": 256, "quant_mode": "auto",
          **profile_paged_decode(qparams, cfg, batch=8, context=256, steps=16, device=dev)})

    counts.update({k: bench_counts[k] for k in W4_VARIANTS})  # their launches: the kernel_bench phase
    counts.update({k: exp_counts[k] for k in W4_EXPERIMENTS})  # and the w4_experiments phase
    counts.update(probe_counts)  # and the int8_probe phase
    counts.update({k: unpack_counts[k] for k in UNPACK})  # and the unpack_exp phase

    def entry(name, src, replaces, row):
        lib_us = row["library_us"]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": counts[name], "max_abs_err": row["max_abs_err"],
                "ms": row["us"] / 1e3, "plain_ms": row["plain_us"] / 1e3,
                "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
                "library_ms": None if lib_us is None else lib_us / 1e3,
                "at": {k: row[k] for k in ("layer", "M", "a8", "route", "sz", "case", "T", "S", "B",
                                           "W", "Gb", "block_m", "KS", "tile") if k in row}}

    def pick(rows, **kw):
        return next(r for r in rows if all(r.get(k) == v for k, v in kw.items()))

    emit({"kernels": [
        entry("rot_w4_matmul", RA8_SRC, "paroquant_tpu/kernels/rot_matmul.py:834",
              pick(mm_rows, layer="lm_head", M=1, a8=True)),
        entry("merged_rot_w4_matmul", ROT_SRC, "paroquant_tpu/kernels/rot_matmul.py:714",
              pick(mm_rows, layer="gate_up_proj", M=1, a8=False)),
        entry("flash_attention", FLASH_SRC, "paroquant_tpu/kernels/attention.py:509",
              pick(fa_rows, case="q_offset0")),
        entry("paged_decode_attention", PAGED_SRC, "paroquant_tpu/kernels/attention.py:143",
              pick(pa_rows, kernel="paged_decode_attention", case="bf16")),
        entry("paged_window_attention_kernel", PAGED_SRC, "paroquant_tpu/kernels/attention.py:337",
              pick(pa_rows, kernel="paged_window_attention_kernel", case="bf16")),
        *(entry(name, src, f"paroquant_tpu/kernels/rot_matmul.py:{line}",
                pick(w4_rows, kernel=name, layer="bench", sz=sz, M=1))
          for name, src, line, sz in (("w4_matmul", PLAIN_SRC, 387, "bf16/u8"),
                                      ("butterfly_w4_matmul", VARIANTS_SRC, 285, "bf16/u8"),
                                      ("rot_w4_matmul_mg", DEQUANT_SRC, 564, "bf16/bf16"),
                                      ("rot_w4_matmul_i4", VARIANTS_SRC, 464, "bf16/u8"))),
        *(entry(name, src, replaces, pick(w4x_rows, kernel=name, M=1, **knobs))
          for name, src, replaces, knobs in (
              ("rot_w4_matmul_b", EXPERIMENTS_SRC, "scripts/kernel_edge_test.py:76", {}),
              ("dma_rot_w4_matmul", DEQUANT_SRC, "scripts/kernel_dma_pipeline.py:102", {"Gb": 4}),
              ("rot_w4_matmul_v2", EXPERIMENTS_SRC, "scripts/kernel_tune.py:94", {"block_m": 16}),
              ("w4a8_matmul", EXPERIMENTS_SRC, "scripts/kernel_w4a8_exp.py:91", {}))),
        # int8_dot also replaces the int8 arm of bench_dots (:117), the case timed here
        *(entry(name, INT8_SRC, f"scripts/kernel_int8_probe.py:{line}",
                pick(i8_rows, kernel=name, case=case))
          for name, line, case in (("narrow_cast", 49, "8x128"), ("int8_dot", 69, "8x4096x4096"),
                                   ("fused_unpack_int8_dot", 95, "8x256->512"),
                                   ("bf16_dot", 117, "8x4096x4096"))),
        # at M <= 16 K19 on BC (w4_opair.cu), K20 on MF (w4_mulfloor.cu), K22 on WM
        # (w4_wordmask.cu); w4_matmul_splitdot_ce and w4_matmul_splitdot launch
        # the same kernel, K6's PL (w4_plain.cu)
        *(entry(name, src, f"scripts/kernel_unpack_exp.py:{line}",
                pick(ux_rows, kernel=name, M=1))
          for name, src, line in (("stream_only", UNPACK_SRC, 70),
                                  ("w4_matmul_bitcast", OPAIR_SRC, 126),
                                  ("w4_matmul_mulfloor", MULFLOOR_SRC, 177),
                                  ("w4_matmul_splitdot_ce", PLAIN_SRC, 229),
                                  ("w4_matmul_splitdot", PLAIN_SRC, 260),
                                  ("w4_matmul_i8", WORDMASK_SRC, 310))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
