"""Perplexity evaluation CLI, the port of `paroquant_tpu/cli/evaluate.py`.

    python -m paroquant_tpu_torch.cli.evaluate --model DIR [--synthetic |
        --token-file F.npy | --datasets wikitext2 c4] [--seqlen 2048]
        [--num-tokens N] [--quant-mode xla|fused|auto|w4a8] [--batch B]
        [--device cuda|cpu]

Protocol parity with the reference: non-overlapping windows of --seqlen
tokens, mean token cross-entropy in f32, PPL = exp(mean CE). Datasets:
WikiText-2 test / C4 validation through the `datasets` package where its
cache holds them, a raw token .npy file via --token-file, or --synthetic
for infrastructure checks. Windows of more than `chunk_ce` tokens take
the lm_head and the CE a chunk of tokens at a time, so no [T, V] f32
logits tensor is ever held. `--dp` / `--sp` (data- and sequence-parallel
evaluation) wait for the port's parallel package and raise above 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

PARALLEL_LATER = ("data- and sequence-parallel evaluation wait for the port's parallel package "
                  "(ROADMAP.md §A 7)")


def load_eval_tokens(name: str, tokenizer, n_tokens: int, seed: int = 0) -> np.ndarray:
    if name == "wikitext2":
        from datasets import load_dataset

        data = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
        text = "\n\n".join(data["text"])
        return np.asarray(tokenizer(text).input_ids[:n_tokens], np.int32)
    if name == "c4":
        from datasets import load_dataset

        data = load_dataset(
            "allenai/c4", data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
            split="validation",
        )
        rng = np.random.default_rng(seed)
        ids: list[int] = []
        idx = rng.permutation(len(data))
        for i in idx:
            ids.extend(tokenizer(data[int(i)]["text"]).input_ids)
            if len(ids) >= n_tokens:
                break
        return np.asarray(ids[:n_tokens], np.int32)
    raise ValueError(name)


def _token_ce(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[tgt] in f32, per position."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, tgt.to(torch.int64)[..., None])[..., 0]


@torch.inference_mode()
def perplexity(params, config, tokens: np.ndarray, seqlen: int, quant_mode: str,
               batch: int = 1, mesh=None, sp_mesh=None, chunk_ce: int = 2048) -> float:
    """exp(mean CE) over non-overlapping seqlen windows, `batch` windows a
    forward (the last batch may be short). The windows run on the device
    of the params: flash prefill (K3) on CUDA, the einsum attention on the
    CPU. A window longer than chunk_ce (and a multiple of it) takes its
    final hidden states, then the lm_head and the CE chunk_ce tokens at a
    time; the window's last position has no target."""
    from ..models.decoder import lm_head_logits, model_forward

    if mesh is not None or sp_mesh is not None:
        raise NotImplementedError(PARALLEL_LATER)
    n_win = len(tokens) // seqlen
    if n_win <= 0:
        raise ValueError("not enough tokens for one window")
    dev = params["embed_tokens"].device
    attn_mode = "einsum" if dev.type == "cpu" else "flash"
    chunk = chunk_ce
    chunked = seqlen > chunk and seqlen % chunk == 0 and not getattr(config, "is_gemma3n", False)

    def window_ce(tok: torch.Tensor):
        if not chunked:
            logits, _ = model_forward(params, config, tok, None, quant_mode=quant_mode,
                                      attn_mode=attn_mode)
            ce = _token_ce(logits[:, :-1], tok[:, 1:])
            return ce.sum(), ce.numel()
        hidden, _ = model_forward(params, config, tok, None, quant_mode=quant_mode,
                                  attn_mode=attn_mode, return_hidden=True)
        padded = torch.nn.functional.pad(tok, (0, 1))
        pos = torch.arange(chunk, device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for t0 in range(0, seqlen, chunk):
            logits = lm_head_logits(params, config, hidden[:, t0 : t0 + chunk], quant_mode)
            ce = _token_ce(logits, padded[:, t0 + 1 : t0 + 1 + chunk])
            del logits
            valid = (t0 + pos) < seqlen - 1
            total = total + torch.sum(ce * valid[None, :])
        return total, tok.shape[0] * (seqlen - 1)

    total, count = 0.0, 0
    for w in range(0, n_win, batch):
        nb = min(batch, n_win - w)
        win = np.asarray(tokens[w * seqlen : (w + nb) * seqlen]).reshape(nb, seqlen)
        s, c = window_ce(torch.as_tensor(win, dtype=torch.int32, device=dev))
        total += float(s)
        count += int(c)
    return float(np.exp(total / count))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--datasets", nargs="+", default=["wikitext2", "c4"])
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--num-tokens", type=int, default=2048 * 128)
    ap.add_argument("--token-file", default=None, help=".npy int token ids")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--quant-mode", default=None, choices=["xla", "fused", "auto", "w4a8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=1, help="windows per forward")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel eval over --dp devices (not yet in the port: raises above 1)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel eval over an sp-device ring (not yet in the port: "
                         "raises above 1)")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.dp > 1 or args.sp > 1:
        raise NotImplementedError(PARALLEL_LATER)

    from ..convert.checkpoint import load_checkpoint
    from ..serve.generator import load_tokenizer

    params, config = load_checkpoint(args.model, device=dev)
    qmode = args.quant_mode or ("auto" if dev.type == "cuda" else "xla")
    if qmode == "w4a8":
        # Quality eval must reflect the numerics served at decode: full
        # 2048-token windows are far above the fused-kernel M crossover, so
        # "w4a8" would resolve to the exact W4A16 path and measure nothing.
        # Force the a8 activation-rounding simulation on every token instead:
        # the per-(token, group) quantizer does not depend on the batch, so
        # each token's numerics match the fused decode kernel up to f32
        # summation order.
        print("note: --quant-mode w4a8 evaluates the a8 activation-rounding "
              "numerics on all tokens (the served decode operating point)")
        qmode = "w4a8_xla"

    def run_ppl(toks):
        return perplexity(params, config, toks, args.seqlen, qmode, batch=args.batch)

    if args.synthetic:
        rng = np.random.default_rng(0)
        toks = rng.integers(0, config.vocab_size, args.num_tokens).astype(np.int32)
        print(f"synthetic ppl: {run_ppl(toks):.4f}")
        return
    if args.token_file:
        toks = np.load(args.token_file).astype(np.int32)
        print(f"{args.token_file} ppl: {run_ppl(toks):.4f}")
        return

    tokenizer = load_tokenizer(args.model)
    if tokenizer is None:
        print("no tokenizer in model dir; use --token-file or --synthetic", file=sys.stderr)
        sys.exit(2)
    for name in args.datasets:
        toks = load_eval_tokens(name, tokenizer, args.num_tokens)
        print(f"{name} ppl: {run_ppl(toks):.4f}")


if __name__ == "__main__":
    main()
