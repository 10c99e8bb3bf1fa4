#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paroquant_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. the device: torch's name for it, then nvidia-smi's name and power limit;
  2. the kernel build (seconds, cached or not, ptxas resource lines);
  3. every CUDA kernel against its plain PyTorch version at Qwen3-0.6B
     shapes, with max abs error, tolerance and median times (CUDA events,
     after warm-up, L2 flushed before each timed launch), then their other
     branches (f32, ragged M, head_dim 64, softcap, window, ...) at small
     shapes, checked and not timed;
  4. the main path at full width: Qwen3-0.6B (28 layers, hidden 1024,
     vocab 151936) with random weights from a seeded torch.Generator,
     Hadamard RTN W4 with a W4 lm_head and merged projections, served by
     Generator(quant_mode="auto", attn_mode="flash"): 4 requests of 64 new
     tokens, three greedy and one sampled. Launch counts are reset just
     before and read just after; every kernel must have run. A decode
     step is profiled, then run under torch's sync debug mode, which
     raises if it waits for the device, on this model and on a small
     Gemma-class one. Then the kernel path's
     teacher-forced logits are held against the same model under
     quant_mode="xla", attn_mode="einsum";
  5. the `kernels` JSON line, then the result line.
It imports nothing of JAX, catches no failure, and exits non-zero without
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
SPIN_CYCLES = 2_000_000  # ~1 ms of device spin ahead of each timed call
KERNEL_REPS, PLAIN_REPS = 30, 5
TOL_KERNEL = 2e-2  # max abs error / max |plain output|
TOL_E2E = 5e-2  # relative Frobenius error of the logits, kernel path vs reference path
ROT_SRC = "paroquant_tpu_torch/kernels/csrc/rot_w4_matmul.cu"
FLASH_SRC = "paroquant_tpu_torch/kernels/csrc/flash_attention.cu"


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def median_ms(fn, reps, flush):
    """Median device time of one call of fn: the L2 is flushed first, and a
    spin kernel keeps the device busy while the host enqueues the call, so
    the events time the device work, not the host's Python overhead."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def check_matmuls(flush, gen, dev):
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
        for M in (1, 16, 128):
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
                y, y_ref = run().float(), plain().float()
                torch.cuda.synchronize()
                err = (y - y_ref).abs().max().item()
                tol = TOL_KERNEL * y_ref.abs().max().item()
                rel = ((y - y_ref).norm() / y_ref.norm()).item()
                ms = median_ms(run, KERNEL_REPS, flush)
                plain_ms = median_ms(plain, PLAIN_REPS, flush)
                lib_ms = median_ms(lambda: torch.matmul(x, w_eff), KERNEL_REPS, flush)
                nbytes = M * I * 2 + P * G * 128 * 128 * 2 + I * O // 2 + 2 * G * O * 2 + M * O * 2
                ops = 2 * M * I * O + 2 * P * M * I * 128
                b_ms, b_by = bound(nbytes, ops, "int8" if a8 else "bf16")
                row = dict(kernel=kernel, layer=layer, M=M, a8=a8, max_abs_err=err, tol=tol,
                           rel_fro_err=rel, us=ms * 1e3, plain_us=plain_ms * 1e3,
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
    import torch

    from paroquant_tpu_torch.kernels import attention as at

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
        tol = TOL_KERNEL * y_ref.abs().max().item()
        mask = sdpa_mask(T, S, q_off, window, dev)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=D**-0.5, enable_gqa=True)
        ms = median_ms(run, KERNEL_REPS, flush)
        plain_ms = median_ms(plain, PLAIN_REPS, flush)
        lib_ms = median_ms(lib, KERNEL_REPS, flush)
        pairs = int(mask.sum().item())  # the (query, key) pairs this input needs
        nbytes = 2 * (2 * B * Hq * T * D + 2 * B * Hkv * S * D)
        ops = 4 * B * Hq * pairs * D
        b_ms, b_by = bound(nbytes, ops, "bf16")  # the inputs' type, not the kernel's f32 math
        row = dict(kernel="flash_attention", case=case, T=T, S=S, max_abs_err=err, tol=tol,
                   us=ms * 1e3, plain_us=plain_ms * 1e3, library_us=lib_ms * 1e3,
                   bound_us=b_ms * 1e3, bound_by=b_by, ok=err <= tol)
        emit({"phase": "kernel_check", **row})
        rows.append(row)
    return rows


def check_edges(gen, dev):
    """The kernels' other branches at small shapes, checked and not timed:
    f32 activations and rotations, ragged M, uneven partitions, group sizes
    256 to 512; head_dim 64, per-row q_offset and kv_lens, softcap, window,
    non-causal, f32."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm

    rows = []

    def record(name, case, y, y_ref):
        y, y_ref = y.float(), y_ref.float()
        err = (y - y_ref).abs().max().item()
        tol = TOL_KERNEL * y_ref.abs().max().item()
        rows.append(dict(kernel=name, case=case, max_abs_err=err, tol=tol, ok=err <= tol))

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
                record("rot_w4_matmul", case, rm.rot_w4_matmul(*one, a8=a8),
                       rm.rot_w4_matmul_plain(*one, a8=a8))
                record("merged_rot_w4_matmul", case,
                       rm.merged_rot_w4_matmul(x, r, qweight, scales, zeros, out_splits=splits,
                                               a8=a8),
                       rm.merged_rot_w4_matmul_plain(x, r, qweight, scales, zeros,
                                                     out_splits=splits, a8=a8))
    for S in (256, 384, 512):  # two groups each, so the groups split across blocks too
        rot, qweight, scales, zeros, _ = random_merged(2 * S, splits, gen, dev, S)
        for M in (1, 9):
            x = torch.randn(M, 2 * S, generator=gen, device=dev).to(torch.bfloat16)
            for a8 in (False, True):
                case = f"S={S} M={M} a8={a8}"
                one = (x, rot[0], qweight[:, :128], scales[:, :128], zeros[:, :128])
                record("rot_w4_matmul", case, rm.rot_w4_matmul(*one, a8=a8),
                       rm.rot_w4_matmul_plain(*one, a8=a8))
                record("merged_rot_w4_matmul", case,
                       rm.merged_rot_w4_matmul(x, rot, qweight, scales, zeros, out_splits=splits,
                                               a8=a8),
                       rm.merged_rot_w4_matmul_plain(x, rot, qweight, scales, zeros,
                                                     out_splits=splits, a8=a8))

    B, Hq, Hkv, D, T, S = 2, 4, 2, 64, 128, 256
    lens = torch.tensor([192, 256], dtype=torch.int32, device=dev)
    qo = torch.tensor([64, 128], dtype=torch.int32, device=dev)
    cases = {"causal": {}, "softcap": dict(logit_softcap=20.0), "window": dict(sliding_window=48),
             "not_causal": dict(causal=False)}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(B, Hq, T, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
        for case, kw in cases.items():
            kw = dict(scale=D**-0.5, q_offset=qo, **kw)
            record("flash_attention", f"{case} {dt} D={D}", at.flash_attention(q, k, v, lens, **kw),
                   at.flash_attention_plain(q, k, v, lens, **kw))
    torch.cuda.synchronize()
    emit({"phase": "kernel_edges", "cases": len(rows),
          "worst_err_over_tol": max(r["max_abs_err"] / r["tol"] for r in rows),
          "failed": [r for r in rows if not r["ok"]]})
    return rows


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


def main_path(dev):
    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm
    from paroquant_tpu_torch.models import PRESETS, init_params, merge_projections
    from paroquant_tpu_torch.serve import Generator, SamplingParams

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
    counts = {**rm.launch_counts, **at.launch_counts}
    variants = {k: {"w4a16": v[0], "a8": v[1]} for k, v in rm.variant_counts.items()}
    for (n, sp), res in zip(requests, results):
        toks = res.token_ids
        ok = len(toks) == sp.max_tokens and all(0 <= t < cfg.vocab_size for t in toks)
        emit({"phase": "request", "prompt_tokens": n, "greedy": sp.greedy,
              "new_tokens": len(toks), "prefill_ms": res.stats.ttft * 1e3,
              "decode_tok_s": res.stats.tokens_per_second, "ok": ok, "first_tokens": toks[:8]})
        if not ok:
            raise SystemExit(f"request with a {n}-token prompt returned {len(toks)} tokens")
    emit({"phase": "launches", "counts": counts, "variants": variants})
    missing = [k for k, c in counts.items() if c == 0]
    if missing or variants["rot_w4_matmul"]["a8"] == 0:
        raise SystemExit(f"kernels not launched on the main path: {missing or 'rot_w4_matmul a8'}")

    from paroquant_tpu_torch.utils.profiling import profile_decode

    emit({"phase": "decode_profile", "prompt_tokens": 256, "quant_mode": "auto",
          **profile_decode(qparams, cfg, prompt_len=256, steps=16, device=dev)})
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
    emit({"phase": "ptxas", "lines": build.ptxas_report().splitlines()})

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(123)
    mm_rows = check_matmuls(flush, gen, dev)
    fa_rows = check_flash(flush, gen, dev)
    edge_rows = check_edges(gen, dev)
    bad = [r for r in mm_rows + fa_rows + edge_rows if not r["ok"]]
    if bad:
        raise SystemExit(f"{len(bad)} kernel checks missed their tolerance")
    del flush

    counts = main_path(dev)

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": counts[name], "max_abs_err": row["max_abs_err"],
                "ms": row["us"] / 1e3, "plain_ms": row["plain_us"] / 1e3,
                "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
                "library_ms": row["library_us"] / 1e3,
                "at": {k: row[k] for k in ("layer", "M", "a8", "case", "T", "S") if k in row}}

    def pick(rows, **kw):
        return next(r for r in rows if all(r.get(k) == v for k, v in kw.items()))

    emit({"kernels": [
        entry("rot_w4_matmul", ROT_SRC, "paroquant_tpu/kernels/rot_matmul.py:834",
              pick(mm_rows, layer="lm_head", M=1, a8=True)),
        entry("merged_rot_w4_matmul", ROT_SRC, "paroquant_tpu/kernels/rot_matmul.py:714",
              pick(mm_rows, layer="gate_up_proj", M=1, a8=False)),
        entry("flash_attention", FLASH_SRC, "paroquant_tpu/kernels/attention.py:509",
              pick(fa_rows, case="q_offset0")),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
