"""Llama-2-7B-geometry W4 decode benchmark (BASELINE.json config 2), the port
of `scripts/bench_7b.py`.

    python -m paroquant_tpu_torch.scripts.bench_7b [--batch 1 8 32] [--tokens 128]
        [--quant-mode fused w4a8 xla auto] [--no-merge] [--device cuda|cpu]

`build_quantized_llama7b` draws the model's f32 weights layer by layer with
numpy's `default_rng(0)` in the JAX script's order (embedding, lm_head,
then per layer q, k, v, o, gate, up, down) and quantizes each linear with
RTN W4 g128 on the device as it is drawn, so no full bf16 7B model is ever
held (W4 7B is about 4 GB). Projections are merged unless `--no-merge`.
For each batch size the arms (quant modes) run interleaved: 2 warm-up
rounds, then 5; each run prefills 16 prompt tokens, syncs, then times
`greedy_decode_scan` of `--tokens` tokens on the host clock, ended by
fetching them. The lines are the JAX script's; the speed of light is the
weight read set over the H100 SXM's 3.35 TB/s (a decode step reads every
weight once, whatever B), and each line names the card. The JAX script
builds on the host and ships the model to its TPU (a "transferred" line);
the port builds on the device, so that line has no counterpart. On the CPU
(`--device cpu`) the plain versions run on the host clock, for the logic
only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch import nn

from ..convert.rtn import quantize_linear_rtn
from ..models import PRESETS, KVCache
from ..models.decoder import DenseLinear, greedy_decode_scan, merge_projections, prefill
from ..utils.device import resolve_device
from .bench_common import HBM_BYTES_PER_S, device_name

PROMPT_LEN = 16
WARMUP = 2
ROUNDS = 5
QUANT_MODES = ("fused", "w4a8", "xla", "auto")


def build_quantized_llama7b(rot_dtype=torch.bfloat16, config=None, device="cuda"):
    """(params, config): RTN W4 g128 weights of the llama-2-7b geometry (or
    `config`, for narrow test models) from numpy's default_rng(0), with a W4
    lm_head. Like JAX's, every layer's k/v projections are Hq * D wide."""
    dev = resolve_device(device)
    cfg = config or PRESETS["llama-2-7b"]
    rng = np.random.default_rng(0)
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    Hq = cfg.num_attention_heads

    def qlin(fan_in, fan_out):
        w = (rng.standard_normal((fan_in, fan_out), np.float32) / np.sqrt(fan_in)).astype(np.float32)
        return quantize_linear_rtn(
            DenseLinear(torch.from_numpy(w).to(dev), None), n_bits=4, group_size=128,
            num_rotations=8, rot_dtype=rot_dtype,
        )

    def bf16(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.bfloat16)

    params = {
        "embed_tokens": bf16(rng.standard_normal((cfg.vocab_size, H), np.float32) * 0.02),
        "norm": torch.ones(H, dtype=torch.bfloat16, device=dev),
        # the W4 lm_head: the dense bf16 head would be most of a step's reads
        "lm_head": qlin(H, cfg.vocab_size),
        "layers": [],
    }
    t0 = time.time()
    for li in range(cfg.num_hidden_layers):
        lp = {
            "input_layernorm": torch.ones(H, dtype=torch.bfloat16, device=dev),
            "post_attention_layernorm": torch.ones(H, dtype=torch.bfloat16, device=dev),
            "q_proj": qlin(H, Hq * D),
            "k_proj": qlin(H, Hq * D),
            "v_proj": qlin(H, Hq * D),
            "o_proj": qlin(Hq * D, H),
            "mlp": {
                "gate_proj": qlin(H, I),
                "up_proj": qlin(H, I),
                "down_proj": qlin(I, H),
            },
        }
        params["layers"].append(lp)
        if li % 8 == 0:
            print(f"  built layer {li} ({time.time()-t0:.0f}s)", flush=True)
    return params, cfg


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a params tree (dicts, lists, modules' buffers)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, nn.Module):
        return sum(b.numel() * b.element_size() for b in tree.buffers())
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def make_run(params, cfg, prompt: torch.Tensor, n_tokens: int, qmode: str):
    """run() -> (aggregate tok/s of one decode chain, its tokens [B, n] as numpy)."""
    B = prompt.shape[0]
    dev = prompt.device

    def run():
        cache = KVCache.create(cfg, B, PROMPT_LEN + n_tokens + 8, torch.bfloat16, dev)
        logits, c = prefill(params, cfg, prompt, cache, quant_mode=qmode)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tok.cpu()
        t0 = time.perf_counter()
        toks, _ = greedy_decode_scan(params, cfg, tok, c, n_tokens, quant_mode=qmode)
        toks = toks.cpu().numpy()
        return B * n_tokens / (time.perf_counter() - t0), toks

    return run


def run(params, cfg, batches, n_tokens: int, quant_modes, device="cuda", *,
        warmup: int = WARMUP, rounds: int = ROUNDS) -> list[dict]:
    """The protocol on a built model: print the JAX script's lines, return a
    row per (batch, arm)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    weight_gb = tree_bytes(params) / 1e9
    sol = HBM_BYTES_PER_S / 1e9 / weight_gb  # tokens/s of one stream at the HBM rate
    card = device_name(dev)
    rows = []
    for B in batches:
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT_LEN))).to(
            device=dev, dtype=torch.int32)
        runs = {q: make_run(params, cfg, prompt, n_tokens, q) for q in quant_modes}
        for i in range(warmup):
            for q, run_arm in runs.items():
                r = run_arm()[0]
                print(f"B={B} [{q}] warmup {i}: {r:.1f} tok/s", flush=True)
        rates = {q: [] for q in runs}
        for _ in range(rounds):  # interleaved: drift hits all arms equally
            for q, run_arm in runs.items():
                rates[q].append(run_arm()[0])
        for q in runs:
            r = rates[q]
            print(f"llama-2-7b W4 decode B={B} [{q}]: {np.mean(r):.1f} tok/s agg "
                  f"(min {min(r):.1f}, max {max(r):.1f}); "
                  f"weight read set {weight_gb:.2f}GB -> B*SoL "
                  f"~{B*sol:.0f} tok/s; achieved "
                  f"{np.mean(r)/(B*sol)*100:.0f}% of SoL [{card}, SoL at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s]", flush=True)
            rows.append({"batch": B, "quant_mode": q, "tok_s": float(np.mean(r)),
                         "tok_s_min": float(min(r)), "tok_s_max": float(max(r)),
                         "weight_gb": weight_gb, "sol_tok_s": B * sol,
                         "sol_share": float(np.mean(r)) / (B * sol), "device": card})
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-merge", action="store_true")
    ap.add_argument("--batch", type=int, nargs="+", default=[1],
                    help="decode batch sizes to measure")
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--quant-mode", nargs="+", default=["fused"], choices=list(QUANT_MODES),
                    help="arms to measure (interleaved when >1); w4a8 rounds activations "
                         "to int8; xla dequantizes the weight for a plain matmul")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    merge = not args.no_merge
    t0 = time.time()
    params, cfg = build_quantized_llama7b(device=dev)
    if merge:
        params = merge_projections(params, cfg)
    print(f"built W4 7B in {time.time()-t0:.0f}s (merged={merge})", flush=True)
    return run(params, cfg, args.batch, args.tokens, args.quant_mode, dev)


if __name__ == "__main__":
    main()
