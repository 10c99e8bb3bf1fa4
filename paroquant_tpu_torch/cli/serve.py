"""OpenAI-compatible serving CLI, the port of `paroquant_tpu/cli/serve.py`.

    python -m paroquant_tpu_torch.cli.serve --model <dir> --port 8000

`build(argv)` loads the checkpoint and returns the Server (and the parsed
arguments); `main` builds and serves until interrupted. On CUDA the default
quant mode is "auto" and the decode burst 8; on the CPU (`--device cpu`)
"xla" and 1. `--dp N` serves N Engine replicas, one a CUDA device, behind an
EngineRouter; tensor parallelism (`--tp` > 1) is not ported yet. A VLM
checkpoint gets its directory's transformers AutoProcessor for chat
messages with images, where that package and the processor's files are
there; raw `pixel_values` are served without it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..serve.engine import Engine


class _DeviceEngine(Engine):
    """An Engine that makes its CUDA device current around its calls: the
    kernels launch on the calling thread's current device, and a replica of
    `--dp` lives on a device of its own. Every CUDA engine of the CLI is one,
    so one replica runs the same code as `--dp N`."""

    def run_forever(self):
        with torch.cuda.device(self.device):
            super().run_forever()

    def score_sync(self, prompt_tokens):
        with torch.cuda.device(self.device):
            return super().score_sync(prompt_tokens)

    def generate_sync(self, prompt_tokens, sampling, **kw):
        with torch.cuda.device(self.device):
            return super().generate_sync(prompt_tokens, sampling, **kw)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Serve a PARO-TPU model (OpenAI API)")
    ap.add_argument("--model", required=True, help="model directory (PARO/HF checkpoint)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--quant-mode", default=None, choices=["xla", "fused", "auto", "w4a8"],
                    help="default: auto on CUDA, xla on the CPU")
    ap.add_argument("--decode-burst", type=int, default=None,
                    help="decode steps fused per tick (default: 8 on CUDA, 1 on the CPU)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help=">0: prompt-lookup speculative decoding for "
                         "greedy request batches (exact outputs)")
    ap.add_argument("--prefix-caching", action="store_true",
                    help="share full prompt-prefix pages across requests (vLLM-style APC)")
    ap.add_argument("--kv-quant", default=None, choices=["int8"],
                    help="quantize the paged KV cache (vLLM --kv-cache-dtype "
                         "counterpart): ~2x KV capacity and ~2x less "
                         "attention HBM traffic at long context")
    ap.add_argument("--dp", type=int, default=1,
                    help="request-level data parallelism: N engine replicas, "
                         "one a CUDA device, least-loaded routing")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel size per replica (only 1 in the port)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: shed load (HTTP 429) once this "
                         "many requests wait per replica (default: unbounded)")
    ap.add_argument("--served-model-name", default=None)
    ap.add_argument("--warmup", action="store_true",
                    help="run the prefill buckets + decode once before "
                         "accepting traffic (first-request latency)")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    return ap.parse_args(argv)


def build(argv=None):
    """(Server, args): the engine (or router) over the checkpoint, ready to
    serve; args.quant_mode and args.decode_burst hold the values taken."""
    from ..convert import load_checkpoint
    from ..serve.api import Server
    from ..serve.generator import load_tokenizer
    from ..serve.router import EngineRouter
    from ..serve.sampling import SamplingParams
    from ..utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.tp is not None and args.tp > 1:
        raise NotImplementedError(
            "tensor-parallel serving (--tp > 1) needs parallel/tp.py, which the port has "
            "not yet (ROADMAP §A 7)")
    on_cuda = dev.type == "cuda"
    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if on_cuda else [dev])
    if args.dp > len(devices):
        raise SystemExit(
            f"--dp {args.dp} x tp 1 needs {args.dp} devices, have {len(devices)}")
    qmode = args.quant_mode = args.quant_mode or ("auto" if on_cuda else "xla")
    if args.decode_burst is None:
        args.decode_burst = 8 if on_cuda else 1
    burst = args.decode_burst
    tokenizer = load_tokenizer(args.model)

    def make_engine(d):
        params, config = load_checkpoint(args.model, device=d)
        cls = _DeviceEngine if on_cuda else Engine
        return cls(
            params, config, tokenizer,
            max_batch=args.max_batch, max_len=args.max_len, page_size=args.page_size,
            quant_mode=qmode, decode_burst=burst, prefix_caching=args.prefix_caching,
            spec_k=args.spec_k, kv_quant=args.kv_quant, max_queue=args.max_queue, device=d,
        )

    replicas = [make_engine(d) for d in (devices[: args.dp] if args.dp > 1 else [dev])]
    engine = replicas[0] if len(replicas) == 1 else EngineRouter(replicas)
    if args.warmup:
        rng = np.random.default_rng(0)
        vocab = replicas[0].config.vocab_size
        L = 16
        warm_toks = (burst + 1) if burst > 1 else 2
        while L < min(args.max_len, 2048):
            print(f"warmup: bucket {L}", flush=True)
            for e in replicas:
                e.generate_sync(rng.integers(0, vocab, L - 1).tolist(),
                                SamplingParams(max_tokens=warm_toks, temperature=0.0))
            L *= 2
    processor = None
    if replicas[0].config.is_vlm:  # image templating and pixel preprocessing for chat images
        try:
            from transformers import AutoProcessor

            processor = AutoProcessor.from_pretrained(str(args.model))
        except Exception:
            print("VLM checkpoint without loadable processor; chat image "
                  "content disabled (raw pixel_values still accepted)")
    name = args.served_model_name or str(args.model).rstrip("/").split("/")[-1]
    return Server(engine, name, processor), args


def main(argv=None):
    server, args = build(argv)
    print(f"serving {server.model_name} on {args.host}:{args.port} (quant_mode={args.quant_mode})")
    server.run(args.host, args.port)


if __name__ == "__main__":
    main()
