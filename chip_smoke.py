#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (paroquant_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines:
  1. the device: torch's name for it, then nvidia-smi's name and power limit;
  2. the kernel build (seconds, cached or not, ptxas resource lines);
  3. every CUDA kernel against its plain PyTorch version at Qwen3-0.6B
     shapes, with max abs error, tolerance and median times (CUDA events,
     after warm-up, L2 flushed before each timed launch) beside the bound
     and one library call: K1/K2 (W4 GEMV), K3 (flash prefill), K4/K5
     (paged decode / verify over 8 slots of mixed lengths, bf16 and int8
     pools; each query row held to its own output's scale); then their
     other branches (f32, ragged M, head_dim 64, softcap, window, page
     sizes, ...) at small shapes, checked and not timed;
  4. slice 1's path at full width: Qwen3-0.6B (28 layers, hidden 1024,
     vocab 151936) with random weights from a seeded torch.Generator,
     Hadamard RTN W4 with a W4 lm_head and merged projections, served by
     Generator(quant_mode="auto", attn_mode="flash"): 4 requests of 64 new
     tokens, three greedy and one sampled. Launch counts are reset just
     before and read just after; K1-K3 must have run. A decode step is
     profiled, then run under torch's sync debug mode, which raises if it
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
TOL_KERNEL = 2e-2  # max abs error / max |plain output|; for K4/K5 per query row (slot, w, head)
TOL_E2E = 5e-2  # relative Frobenius error of the logits, kernel path vs reference path
TOL_LOGPROB = 0.25  # nats: an engine request's logprobs against a contiguous prefill's
ROT_SRC = "paroquant_tpu_torch/kernels/csrc/rot_w4_matmul.cu"
FLASH_SRC = "paroquant_tpu_torch/kernels/csrc/flash_attention.cu"
PAGED_SRC = "paroquant_tpu_torch/kernels/csrc/paged_attention.cu"


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
    non-causal, f32; and K4/K5's (paged_edges)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm

    rows = []

    def record(name, case, y, y_ref, lead=None):
        """lead: hold each query row (the first `lead` dims) to its own scale."""
        y, y_ref = y.float(), y_ref.float()
        err = (y - y_ref).abs().max().item()
        if lead is None:
            tol = TOL_KERNEL * y_ref.abs().max().item()
            rows.append(dict(kernel=name, case=case, max_abs_err=err, tol=tol,
                             err_over_tol=err / tol, ok=err <= tol))
        else:
            ratio = row_err_ratio(y, y_ref, lead)
            rows.append(dict(kernel=name, case=case, max_abs_err=err, row_err_ratio=ratio,
                             tol=TOL_KERNEL, err_over_tol=ratio / TOL_KERNEL,
                             ok=ratio <= TOL_KERNEL))

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
    paged_edges(gen, dev, record)
    torch.cuda.synchronize()
    emit({"phase": "kernel_edges", "cases": len(rows),
          "worst_err_over_tol": max(r["err_over_tol"] for r in rows),
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
    counts = {**rm.launch_counts, "flash_attention": at.launch_counts["flash_attention"]}
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
            ms = median_ms(run, KERNEL_REPS, flush)
            plain_ms = median_ms(plain, PLAIN_REPS, flush)
            lib_ms = median_ms(paged_sdpa(q4, table, k, v, ks, vs, base, dev), KERNEL_REPS, flush)
            n_keys = [int(n) + W for n in base.tolist()]
            b_ms, b_by = paged_bound(n_keys, W, quant, **shp)
            row = dict(kernel=kernel, case="int8" if quant else "bf16", B=B, W=W,
                       lens=list(PAGED_LENS), max_abs_err=err, row_err_ratio=ratio,
                       tol=TOL_KERNEL, us=ms * 1e3,
                       plain_us=plain_ms * 1e3, library_us=lib_ms * 1e3,
                       library="sdpa(enable_gqa) on K/V gathered to contiguous bf16 beforehand; "
                               "the gather is not timed",
                       bound_us=b_ms * 1e3, bound_by=b_by,
                       ok=ratio <= TOL_KERNEL and bool(torch.isfinite(y).all()))
            emit({"phase": "kernel_check", **row})
            rows.append(row)
        del table, k, v, ks, vs
    return rows


def paged_edges(gen, dev, record):
    """K4/K5's other branches at small shapes: sliding window, softcap, head
    dim 64, f32 pools and queries, page sizes 8/16/64, one kv head (grp 8),
    a K5 window that runs past maxP (clamped), an empty K4 slot (gives 0)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    cases = [
        ("window", dict(D=128, ps=128, Hq=16, Hkv=8), torch.bfloat16, dict(sliding_window=100)),
        ("softcap", dict(D=128, ps=128, Hq=16, Hkv=8), torch.bfloat16, dict(logit_softcap=30.0)),
        ("D64_ps16", dict(D=64, ps=16, Hq=4, Hkv=2), torch.bfloat16, {}),
        ("f32_ps64", dict(D=128, ps=64, Hq=8, Hkv=4), torch.float32, {}),
        ("ps8_grp8", dict(D=128, ps=8, Hq=8, Hkv=1), torch.bfloat16, dict(sliding_window=20)),
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


def check_logprobs(eng, greedy, cfg, phase):
    """Hold each greedy request's per-token logprobs (its first token from
    the prefill, prefix-hit rows gathered from the pool included; the rest
    from burst decode through K4 and verify windows through K5, each fed the
    tokens sampled on the device) against eng.score_sync(prompt + tokens):
    one contiguous prefill of the whole sequence (K3 on the card), which
    never touches the paged pool. The worst gap must stay within
    TOL_LOGPROB, and a wrong context (the first half of the longest prompt
    replaced by other tokens) must move the scores by more than that on
    average, or the check could not see a misread context. `greedy` holds
    (request, prompt, tokens)."""
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
    if max(gaps) > TOL_LOGPROB or context_move <= TOL_LOGPROB:
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
    counts = dict(rm.launch_counts, **at.launch_counts)
    variants = {k: {"w4a16": v[0], "a8": v[1]} for k, v in rm.variant_counts.items()}
    variants.update({k: {"float": v[0], "int8": v[1]} for k, v in at.variant_counts.items()})
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
    emit({"phase": f"{phase}_launches", "counts": counts, "variants": variants})
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
    emit({"phase": "ptxas", "lines": build.ptxas_report().splitlines()})

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(123)
    mm_rows = check_matmuls(flush, gen, dev)
    fa_rows = check_flash(flush, gen, dev)
    pa_rows = check_paged(flush, gen, dev)
    edge_rows = check_edges(gen, dev)
    bad = [r for r in mm_rows + fa_rows + pa_rows + edge_rows if not r["ok"]]
    if bad:
        raise SystemExit(f"{len(bad)} kernel checks missed their tolerance")
    del flush

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

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": counts[name], "max_abs_err": row["max_abs_err"],
                "ms": row["us"] / 1e3, "plain_ms": row["plain_us"] / 1e3,
                "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
                "library_ms": row["library_us"] / 1e3,
                "at": {k: row[k] for k in ("layer", "M", "a8", "case", "T", "S", "B", "W")
                       if k in row}}

    def pick(rows, **kw):
        return next(r for r in rows if all(r.get(k) == v for k, v in kw.items()))

    emit({"kernels": [
        entry("rot_w4_matmul", ROT_SRC, "paroquant_tpu/kernels/rot_matmul.py:834",
              pick(mm_rows, layer="lm_head", M=1, a8=True)),
        entry("merged_rot_w4_matmul", ROT_SRC, "paroquant_tpu/kernels/rot_matmul.py:714",
              pick(mm_rows, layer="gate_up_proj", M=1, a8=False)),
        entry("flash_attention", FLASH_SRC, "paroquant_tpu/kernels/attention.py:509",
              pick(fa_rows, case="q_offset0")),
        entry("paged_decode_attention", PAGED_SRC, "paroquant_tpu/kernels/attention.py:143",
              pick(pa_rows, kernel="paged_decode_attention", case="bf16")),
        entry("paged_window_attention_kernel", PAGED_SRC, "paroquant_tpu/kernels/attention.py:337",
              pick(pa_rows, kernel="paged_window_attention_kernel", case="bf16")),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
