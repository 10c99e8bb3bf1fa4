"""Interactive chat, the port of `paroquant_tpu/cli/chat.py` (the reference's
cli/chat.py: rich console, history, /think toggle, /clear, per-turn
ttft/tok-s stats, <think> trace folding).

    python -m paroquant_tpu_torch.cli.chat --model DIR [--max-tokens 2048]
        [--temperature 0.6] [--top-p 0.95] [--quant-mode xla|fused|auto|w4a8]
        [--decode-burst N] [--spec-k K] [--device cuda|cpu]

`chat_turns` runs the turn loop over any line source and rich console,
so it can be driven without a terminal; `main` loads the model, warms it
up and hands it the terminal.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable


def chat_turns(gen, sp, read_line: Callable[[], str], console, *,
               history: list[dict[str, str]] | None = None) -> list[dict]:
    """Read lines until read_line raises EOFError. "/clear" empties the
    history, "/think" toggles reasoning; any other non-blank line is a user
    turn: its reply streams through a rich Live view with <think> traces
    folded, the answer after "</think>" joins the history, and a stats line
    follows. Returns one record per turn: the prompt's token ids, the
    reply's tokens, the history's answer, ttft (s) and tok/s."""
    from rich.live import Live
    from rich.markdown import Markdown

    history = [] if history is None else history
    turns = []
    thinking = True
    while True:
        try:
            user = read_line()
        except EOFError:
            break
        if not user.strip():
            continue
        if user.strip() == "/clear":
            history.clear()
            console.print("[dim]history cleared[/dim]")
            continue
        if user.strip() == "/think":
            thinking = not thinking
            console.print(f"[dim]thinking {'on' if thinking else 'off'}[/dim]")
            continue
        history.append({"role": "user", "content": user})
        prompt = gen.build_prompt(history, thinking)
        pieces: list[int] = []
        t0 = time.perf_counter()
        ttft = None
        with Live(console=console, refresh_per_second=8) as live:
            for tok in gen.stream_generate(prompt, sp):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                pieces.append(tok)
                text = gen.decode_text(pieces)
                # fold <think> traces like the reference's _ThinkingTracker
                if "</think>" in text:
                    shown = text.split("</think>", 1)[1]
                elif "<think>" in text:
                    shown = "[dim](thinking...)[/dim]"
                else:
                    shown = text
                live.update(Markdown(shown) if not shown.startswith("[dim]") else shown)
        latency = time.perf_counter() - t0
        text = gen.decode_text(pieces)
        answer = text.split("</think>", 1)[-1].strip()
        history.append({"role": "assistant", "content": answer})
        n = len(pieces)
        tps = (n - 1) / max(latency - (ttft or 0), 1e-9)
        console.print(f"[dim]ttft {1e3*(ttft or 0):.0f} ms · {n} tokens · {tps:.1f} tok/s[/dim]")
        turns.append({"prompt": prompt, "tokens": pieces, "answer": answer,
                      "ttft_s": ttft or 0.0, "tok_s": tps})
    return turns


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--max-tokens", type=int, default=2048)
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--quant-mode", default=None, choices=["xla", "fused", "auto", "w4a8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--decode-burst", type=int, default=1,
                    help=">1 streams tokens in bursts of N (no host sync inside a burst)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help=">0: prompt-lookup speculative decoding with k-token drafts")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    dev = resolve_device(args.device)

    from rich.console import Console

    from ..serve.generator import Generator
    from ..serve.sampling import SamplingParams

    console = Console()
    console.print(f"[dim]loading {args.model}...[/dim]")
    gen = Generator.from_pretrained(args.model, device=dev, quant_mode=args.quant_mode,
                                    max_len=args.max_tokens * 2 + 512,
                                    decode_burst=args.decode_burst,
                                    lookup_spec_k=args.spec_k)
    if gen.tokenizer is None:
        console.print("[red]model dir has no tokenizer; chat needs one[/red]")
        return
    sp = SamplingParams(max_tokens=args.max_tokens, temperature=args.temperature, top_p=args.top_p)
    console.print(
        "[bold]paroquant-tpu chat[/bold] — /think toggles reasoning, /clear resets, "
        "ctrl-d exits"
    )
    # warm-up, so that the first turn does not pay the first calls' costs
    list(gen.stream_generate(gen.build_prompt([{"role": "user", "content": "hi"}], True),
                             SamplingParams(max_tokens=2)))
    chat_turns(gen, sp, lambda: console.input("[bold cyan]>>> [/bold cyan]"), console)


if __name__ == "__main__":
    main()
