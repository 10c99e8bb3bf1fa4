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
     dots, at its shapes and on its integer inputs, exact, and K14 at 4096 x
     4096, K16 at 8 x 4096 -> 4096 beside K15 on the unpacked weight; K15,
     K16 and K17 one launch a call, two calls bitwise equal, and timed after
     a clean flush too; K14 and K16 beside the launch floor, an empty kernel
     and two events with nothing between them, in the `launch_floor`
     line); then their other branches (f32,
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
     probe's library must show IMMA in K15's and K16's three streaming
     instances each (with their 16-byte cp.async, LDGSTS), K15's SASS as it
     was before K16 joined its kernel (`K15_SASS_SHA256`), HMMA in K17 and
     no K16 of old (`int8_dot_kernel`), no library's ring copies may take
     their memory descriptor from an odd uniform register
     (`check_descriptors`), that of the unpack library K18's bulk copies
     (UBLKCP) in both of its instances, with 0 spill bytes in ptxas's lines
     for K15's, K16's and K18's, that of the K1/K2
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
  6. slice 20's paths, each with the counts reset just before and read
     just after: the port's `bench.py` at chains of 8 and 32 tokens, 1
     warm-up and 1 rep (its JSON line, with every key of the JAX bench's
     line), then each arm alone (K1/K2's routes: the W4 arm's lm_head on
     the passes, every linear of the w4a8 arm on RA8, no kernel of the
     port in the bf16 arm; and `profile_decode`'s device-busy ms per
     token); the Generator's decode bursts (8 against 1, greedy and
     sampled, token-identical, and a burst of each under sync debug mode
     "error"); greedy prompt-lookup speculation (k 4) on a
     repeated and a random prompt, equal to the sequential greedy run up
     to its first near-tie (NEAR_TIE), with drafts accepted on the repeated
     one, and a sampled speculative request; `kernel_dispatch` at M 1-512
     (K1 on the one launch and the passes), `bench_prefill` (K1's passes
     at M 512) and `bench_spec` at 32 tokens;
  7. slice 21's paths (`bench_scripts`), the five ported bench scripts, each
     with the counts reset just before and read just after: `bench_7b` at
     full llama-2-7b width cut to 2 layers (batch 1 and 8, arms fused and
     w4a8, 16 tokens; K1/K2 on the one launch and RA8), the decode
     accounting on that model (B 32, 16 tokens; K1/K2 on the passes; its
     buckets add up to its device-busy time, its attention ablation through
     a callable attn_mode finite), `bench_kv_quant` at its full size (K4 on
     bf16 and int8 pools), `bench_serving` on qwen3-0.6b cut to 4 layers
     (8 requests, spec_k 4; K1/K2, K4 and K5; every request returns its
     tokens) and `bench_a8_accuracy` on qwen3-0.6b (one sequence of 128
     tokens, the plain path);
  8. the user entry points' paths (`user_paths`): the native packer built from
     native/paropack.cpp (a missing library fails), the AWQ pair and
     pack_w4_tpu bit for bit the numpy path's on an 8 MB tensor, and
     `_lookup_draft` the numpy scan's drafts on 4096-token contexts; a
     Qwen3-0.6B AWQ directory (28 layers, random bf16 weights, Hadamard RTN
     W4 g128, written with `write_safetensors`) whose loaded logits and
     greedy tokens equal, bit for bit, those of the model built in memory
     from the same tensors; `cli/evaluate.main --synthetic --seqlen 2048
     --num-tokens 4096` on it printing `perplexity`'s PPL of the in-memory
     model (1e-5 relative; K3 once a layer a window), a 4096-token window
     chunked and unchunked (TOL_PPL_CHUNK); cli/chat's turn loop on the
     loaded model with a stand-in byte tokenizer (hi, /think, a turn,
     /clear, a turn; K1/K2); K3 at bench_longcontext's 16k chunk and
     window held against its plain version on one kv head's group, and K4
     over one slot of 32768 keys, each timed beside SDPA; then
     bench_longcontext's ttft16k at its defaults (K3 on every chunk of
     every layer, K4), gen32k at --gen-total 256 (224 tokens, "done";
     K4) and ppl16k at qwen3-8b width cut to 2 layers over the 16384-token
     window (K3; PPL and peak bytes finite);
  9. the conversion and HTTP serving paths, each with the counts reset
     just before and read just after: `convert_paths` (Qwen3-0.6B at full
     width, Hadamard RTN
     exports saved as PARO-TPU and AWQ directories, each loaded to the
     in-memory model's logits and greedy tokens bit for bit, K1 and K3;
     then `gptq_baseline.main` at full width, GPTQ_LAYERS deep, over 8 x
     512 synthetic tokens, each layer's output error below RTN's, the
     directory loaded and decoded) and `serve_http` (`cli/serve.build` on
     the PARO-TPU directory, served on a loopback port: /health,
     /v1/models, /metrics; 8 concurrent greedy completions by token ids,
     not streamed, streamed and on the Engine itself, each token its
     prefix's greedy choice up to a near-tie (NEAR_TIE_NATS), logprobs
     within TOL_LOGPROB of Engine.score_sync, first SSE bytes paired with
     each request's first token; n 2 with
     a seed; echo scoring; a 429; a stop-string chat over the
     ByteTokenizer; an EngineRouter over two Engines sharing merged weights
     with a W4 lm_head; K1-K5 and RA8 must run, every client call end
     within HTTP_TIMEOUT and every engine thread be alive);
  10. calibration (`calibrate_paths`, the counts reset just before and read
     just after): `calibrate_model` on Qwen3-0.6B at full width cut to
     CALIB_LAYERS layers (random f32 weights from a seeded torch.Generator,
     outlier input channels x6) over 4 x 2 x 256 synthetic tokens, the
     canonical two stages at 2 epochs each with GPTQ init (a line per layer:
     its seconds, each stage's validation loss before and after); every
     loss finite, its logits' MSE to the dense model's below RTN W4 g128's,
     a 1-layer hidden-256 calibration on the card within the CPU tests'
     tolerance of the same one on the host, the written directory loaded
     to the in-memory model's logits and tokens bit for bit and its kernel
     path within TOL_E2E of quant_mode "xla" with the einsum attention (K1,
     K3); then `cli.optimize` and `cli.convert` (real paro-tpu, real awq,
     pseudo; each output loaded and decoded) and `bench_calibration
     --tokens 2048`, each printing its line;
  11. the MoE family (`moe_paths`, the counts reset just before and read
     just after; K1-K5 must run): Qwen3-30B-A3B's published widths (128
     experts, top 8) at 6 of its 48 layers (MOE_LAYERS: the depth cut
     that keeps the script in its time limit beside phases 12-13), with random
     bf16 weights from a seeded
     torch.Generator, built layer by layer on the card (RTN W4 g128, the
     experts through quantize_experts_rtn, a W4 lm_head, merged
     projections; its seconds and peak bytes); the Generator (quant_mode
     "auto", flash) over four greedy requests of 16-512 prompt tokens, 32
     new each (tok/s, ms a step), its decode step under sync debug mode
     "error", profile_decode's busy ms, idle share and launches a step, and
     the kernel path's teacher-forced logits against "xla" + einsum within
     TOL_E2E; the Engine (8 slots, pages of 128, spec_k 4, bf16 pool) over
     eight greedy requests, each one's logprobs within TOL_LOGPROB of one
     contiguous prefill; at 2 layers a PARO-TPU directory
     (stacked experts) and an AWQ one (per-expert), each loaded to the
     in-memory model's logits and tokens bit for bit; GPTQ of one layer at
     this width over 4 x 512 tokens (its seconds, each projection's error
     below RTN's); and a 1-layer tiny-moe calibration on the card within
     the CPU tests' tolerance of the same one on the host;
  12. the qwen3_next hybrid (`hybrid_paths`, the counts reset just before
     and read just after; K1-K4 must run, K3 on its f32-query instance):
     Qwen3-Next-80B-A3B's published widths (every fourth layer full
     attention with a gated q, the others gated delta-net; 512 experts of
     512, top 10, a shared expert) at 8 of its 48 layers (HYBRID_LAYERS:
     the depth cut that keeps the script in its time limit) with random
     bf16 weights, built as in phase 11; the Generator over four greedy
     requests, its decode step under sync debug mode "error" and profiled;
     the kernel path's teacher-forced logits against the same computation
     with each kernel's plain version, routing pinned, within TOL_E2E on
     the first 4 layers and recorded at all 8 beside the noise floor; the
     Engine (8 slots, no speculation) over eight greedy requests at 8
     layers, and its
     logprobs within TOL_LOGPROB of one contiguous prefill on the first 4
     layers (W4A16); the paged step at 6 slots under sync debug mode
     "error"; PARO-TPU and AWQ directories at 2 layers (a delta-net and a
     full-attention layer) loaded bit for bit;
     GPTQ of a delta-net and a full-attention layer below RTN's error; and
     a 1-layer hybrid calibrated on the card within the CPU tests'
     tolerance of the host's. K1/K2 with f32 inputs at the hybrid's decode
     shapes, K3's f32-query instance and K4's SIMT instance for f32
     queries join phase 3's kernel checks;
  13. the gemma3n family (`gemma3n_paths`, the counts reset just before
     and read just after; K1-K4 must run, K3 and K4 on their tensor-core
     instances): Gemma 3n E4B's published widths (GEMMA3N_E4B: AltUp of 4,
     LAuReL, per-layer inputs of 256 over a 262144 vocab, 4 sliding layers
     of window 512 to 1 full, a 15-layer shared-KV tail, a tied 262400
     vocab) at 8 of its 35 layers (GEMMA3N_LAYERS: the depth cut that
     keeps the script in its time limit beside phase 14), random bf16
     weights built layer by layer
     (q_norm / k_norm at head_dim ** -0.25, `gemma3n_random_init`), RTN W4
     g128, a W4 lm_head from the tied table, merged projections; the
     Generator over four greedy requests, its decode step under sync debug
     mode "error" and profiled; the Engine (8 slots, chunked prefill,
     prefix caching, no speculation) over eight greedy requests with a
     prefix hit; the paged step at 8 slots under sync debug mode "error";
     the teacher-forced logits (the `auto` kernel path against the same
     computation on each kernel's plain version) and the Engine's logprobs
     held within TOL_E2E and TOL_LOGPROB on a 6-layer model with a tail
     layer (`auto` against "xla" + einsum recorded there), recorded at 8
     layers beside the noise floor; PARO-TPU and AWQ directories at 3
     layers (a source layer and its tail) loaded bit for bit; a source
     layer and its tail calibrated on card and host. K1/K2
     at E4B's decode shapes (M 1 and 8), K3 at D 256 with a window of 512
     from offset 0 and 256, and K4 at the Engine's step with the window
     join phase 3's kernel checks;
  14. the Gemma 3 VLM (`vlm_paths`, the counts reset just before and read
     just after; K1, K2 and K4 must run): Gemma 3 4B's widths (GEMMA3_4B,
     every width written out: a 34-layer LM of 2560, 5 sliding layers of
     window 1024 to 1 full, a tied 262208 vocab; a 27-layer SigLIP tower of
     1152 over 896 x 896 images in 14 x 14 patches, pooled to 256 soft
     tokens) at all layers, random bf16 weights (q_norm / k_norm at 1 + w
     = 1), Hadamard RTN W4 g128 on the LM with a W4 lm_head, the tower
     dense bf16, f32 pixels from a seeded generator; a profiled VLM
     prefill of one image and 64 text tokens (wall, device-busy ms,
     launches, the tower's device ms beside its f32 bound); the
     teacher-forced logits (a VLM prefill, then 8 decode steps) of the
     `auto` kernel path against each kernel's plain version, beside the
     noise floor (K1/K2 inputs perturbed by a bf16 rounding): held within
     TOL_E2E at 34 layers unless that floor passes TOL_E2E / 2, then on
     the first VLM_CHECK_LAYERS layers (34 recorded); a second image moving
     those logits by more than the kernel path's error; the Generator over
     requests with one and with two images (32 new tokens: TTFT, tok/s);
     the Engine (8 slots, chunked prefill, prefix caching) over 4 image and
     4 text requests (TTFT p50/p99 by kind, tok/s), no prefix hit on an
     image request, each image request's logprobs within TOL_LOGPROB of
     one contiguous VLM prefill at the held depth, and a wrong image moving
     them further than that at all 34 layers; one raw `pixel_values` request through the port's
     `Server` (its tokens the Engine's; the seconds its JSON body takes to
     parse); an HF-named directory (the LM at 2 layers, the whole tower)
     loaded through load_checkpoint to the in-memory model's logits bit
     for bit. K1/K2 at Gemma 3 4B's decode shapes (M 1 and 8) and K4 at the
     Engine's step with the window of 1024 join phase 3's kernel checks;
  15. a `phase_seconds` line after each phase, the `kernels` JSON line
     (each kernel's `hybrid_paths_launches`, `gemma3n_paths_launches` and
     `vlm_paths_launches` beside its launches), then the result line.
It imports nothing of JAX, catches no failure of the port (only a library
yardstick's refusal of a shape, `int_mm_yardstick`), and exits non-zero without
printing a result when CUDA is missing or the package is not beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12,  # dense tensor-core rates, H100 SXM
            "f32": 67e12}  # float32 outside the tensor cores
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


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


# a model's K1/K2 calls at decode: (the dtype of x, [(name, kernel, I, splits,
# a8)]), a8 what `auto` takes at M <= 16 (W4A8 where K x N >= 8M). The
# hybrid's (Qwen3-Next-80B-A3B), whose x is f32 after the first delta-net layer
HYBRID_MATMULS = ("f32", [
    ("in_proj_qkvz", "rot_w4_matmul", 2048, (12288,), True),
    ("out_proj/o_proj", "rot_w4_matmul", 4096, (2048,), True),
    ("qkv_proj (gated q)", "merged_rot_w4_matmul", 2048, (8192, 512, 512), True),
    ("shared_expert.gate_up_proj", "merged_rot_w4_matmul", 2048, (512, 512), False),
    ("shared_expert.down_proj", "rot_w4_matmul", 512, (2048,), False),
    ("lm_head", "rot_w4_matmul", 2048, (151936,), True),
])


# Gemma 3n E4B's (bf16 x): the merged QKV before the tail, the tail's own
# q_proj, o_proj, the merged gate-up, down_proj and the W4 lm_head from the
# tied table
GEMMA3N_MATMULS = ("bf16", [
    ("qkv_proj", "merged_rot_w4_matmul", 2048, (2048, 512, 512), False),
    ("q_proj (shared-KV tail)", "rot_w4_matmul", 2048, (2048,), False),
    ("o_proj", "rot_w4_matmul", 2048, (2048,), False),
    ("gate_up_proj", "merged_rot_w4_matmul", 2048, (16384, 16384), True),
    ("down_proj", "rot_w4_matmul", 16384, (2048,), True),
    ("lm_head", "rot_w4_matmul", 2048, (262400,), True),
])


# Gemma 3 4B's (bf16 x): the merged QKV and gate-up, o_proj, down_proj and
# the W4 lm_head from the tied table; o_proj (K x N 5.2M) is the one below
# AUTO_W4A8_MIN_KN
GEMMA3_MATMULS = ("bf16", [
    ("qkv_proj", "merged_rot_w4_matmul", 2560, (2048, 1024, 1024), True),
    ("o_proj", "rot_w4_matmul", 2048, (2560,), False),
    ("gate_up_proj", "merged_rot_w4_matmul", 2560, (10240, 10240), True),
    ("down_proj", "rot_w4_matmul", 10240, (2560,), True),
    ("lm_head", "rot_w4_matmul", 2560, (262208,), True),
])


def check_decode_matmuls(flush, gen, dev, model, matmuls):
    """K1/K2 at a model's decode shapes (`matmuls`: HYBRID_MATMULS,
    GEMMA3N_MATMULS, GEMMA3_MATMULS), M 1 and 8 (the Engine's step): each against its plain
    version within TOL_KERNEL of max |y|, its route, timed beside the plain
    version and `torch.matmul` on the pre-rotated effective weight (bf16, x
    cast)."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    x_dtype, shapes = matmuls
    xt = {"f32": torch.float32, "bf16": torch.bfloat16}[x_dtype]
    rows = []
    for layer, kernel, I, splits, a8 in shapes:
        rot, qweight, scales, zeros, w_eff = random_merged(I, splits, gen, dev)
        O, P, G = sum(splits), len(splits), I // 128
        for M in (1, 8):
            x = torch.randn(M, I, generator=gen, device=dev).to(xt)
            if kernel == "rot_w4_matmul":
                run = lambda: rm.rot_w4_matmul(x, rot[0], qweight, scales, zeros, a8=a8)
                plain = lambda: rm.rot_w4_matmul_plain(x, rot[0], qweight, scales, zeros, a8=a8)
            else:
                run = lambda: rm.merged_rot_w4_matmul(x, rot, qweight, scales, zeros,
                                                      out_splits=splits, a8=a8)
                plain = lambda: rm.merged_rot_w4_matmul_plain(x, rot, qweight, scales, zeros,
                                                              out_splits=splits, a8=a8)
            y, route = routed(rm, run)
            y, y_ref = y.float(), plain().float()
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            tol = TOL_KERNEL * y_ref.abs().max().item()
            ms = median_ms(run, KERNEL_REPS, flush)
            plain_ms = median_ms(plain, PLAIN_REPS, flush)
            xb = x.to(torch.bfloat16)
            lib_ms = median_ms(lambda: torch.matmul(xb, w_eff), KERNEL_REPS, flush)
            xe = x.element_size()
            nbytes = M * I * xe + P * G * 128 * 128 * 2 + I * O // 2 + 2 * G * O * 2 + M * O * xe
            b_ms, b_by = bound(nbytes, 2 * M * I * O + 2 * P * M * I * 128, "int8" if a8 else "bf16")
            row = dict(kernel=kernel, model=model, layer=layer, M=M, a8=a8, x=x_dtype, route=route,
                       max_abs_err=err, tol=tol,
                       rel_fro_err=((y - y_ref).norm() / y_ref.norm()).item(), us=ms * 1e3,
                       plain_us=plain_ms * 1e3, library_us=lib_ms * 1e3, bound_us=b_ms * 1e3,
                       bound_by=b_by, ok=err <= tol and bool(torch.isfinite(y).all()))
            emit({"phase": "kernel_check", **row})
            rows.append(row)
        del rot, qweight, scales, zeros, w_eff
        torch.cuda.empty_cache()
    return rows


def sdpa_mask(T, S, q_offset, window, dev):
    import torch

    qp = q_offset + torch.arange(T, device=dev)[:, None]
    kp = torch.arange(S, device=dev)[None, :]
    m = kp <= qp
    if window:
        m &= kp > qp - window
    return m


# case: (Hq, Hkv, T, S, q_offset, sliding window, held on one kv head's group);
# B 1, D 128, q_offset + T keys valid. Qwen3-0.6B's prefill from offset 0, from
# offset 256 and with a window of 128:
FLASH_CASES = {
    "q_offset0": (16, 8, 512, 512, 0, None, False),
    "q_offset256": (16, 8, 512, 768, 256, None, False),
    "window128": (16, 8, 512, 512, 0, 128, False),
}
# bench_longcontext's shapes: the Engine's last 2048-row chunk of a 16384-token
# prompt against a cache of bucket + chunk = 18432 rows (Qwen3-0.6B), and
# ppl16k's window (Qwen3-8B heads). The plain version cannot take the whole call
# (its f32 scores alone are 19-34 GB), so these are held on one kv head's group.
LONG_FLASH_CASES = {
    "chunk16k": (16, 8, 2048, 18432, 14336, None, True),
    "window16k": (32, 8, 16384, 16384, 0, None, True),
}
LONG_REPS = 5  # timed calls of K3 at the 16k shapes
# Gemma 3n E4B's prefill (Hq 8, Hkv 2, D 256, scale 1.0) on a sliding layer
# (window 512), from offset 0 and from 256; a tail layer calls it the same way
# over its source layer's cache
GEMMA3N_FLASH_CASES = {
    "gemma3n_window512": (8, 2, 512, 512, 0, 512, False),
    "gemma3n_window512_offset256": (8, 2, 512, 768, 256, 512, False),
}


def check_flash(flush, gen, dev, cases=FLASH_CASES, D=128, scale=None):
    """K3 on each case: each query row (batch, head, row) held to its own
    output's scale against the plain version, on the same inputs sliced to
    one kv head's group (the Hq/Hkv query heads and that kv head) where the
    case says so; two calls of the whole call bitwise equal; timed beside
    the plain version (on the group where held), SDPA given the same mask as
    a tensor and, from offset 0 without a window, SDPA with is_causal=True
    and no mask tensor (what a user would call). For the held cases SDPA
    takes K/V expanded to the query heads beforehand (not timed), and no
    [T, S] mask tensor where is_causal is the same mask. D and scale (by
    default D ** -0.5): the head dim and softmax scale of every case."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B = 1
    scale = D**-0.5 if scale is None else scale
    rows = []
    for case, (Hq, Hkv, T, S, q_off, window, held) in cases.items():
        kv_len = q_off + T
        reps, plain_reps = (LONG_REPS, LONG_REPS) if held else (KERNEL_REPS, PLAIN_REPS)
        q = torch.randn(B, Hq, T, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        lens = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
        qo = torch.full((B,), q_off, dtype=torch.int32, device=dev)
        kw = dict(scale=scale, q_offset=qo, sliding_window=window)
        qg, kg, vg = ((q[:, :Hq // Hkv].contiguous(), k[:, :1].contiguous(), v[:, :1].contiguous())
                      if held else (q, k, v))
        run = lambda: at.flash_attention(q, k, v, lens, **kw)
        run_held = lambda: at.flash_attention(qg, kg, vg, lens, **kw)
        plain = lambda: at.flash_attention_plain(qg, kg, vg, lens, **kw)
        y, y_ref = run_held().float(), plain().float()
        torch.cuda.synchronize()
        err = (y - y_ref).abs().max().item()
        ratio = row_err_ratio(y, y_ref, 3)
        y_finite = bool(torch.isfinite(y).all())
        del y, y_ref
        same = torch.equal(run(), run())  # no atomics: a second call gives the same bits
        emit({"phase": "flash_determinism", "case": case, "bitwise_equal": same})
        if not same:
            raise SystemExit(f"flash_attention {case}: two calls on the same inputs differ")
        ms = median_ms(run, reps, flush)
        group_ms = median_ms(run_held, reps, flush) if held else None
        plain_ms = median_ms(plain, plain_reps, flush)
        torch.cuda.empty_cache()
        if held:
            ke = k[:, :, :kv_len].repeat_interleave(Hq // Hkv, dim=1)
            ve = v[:, :, :kv_len].repeat_interleave(Hq // Hkv, dim=1)
            gqa, library = {}, "sdpa, K/V expanded to the query heads"
        else:
            ke, ve, gqa, library = k, v, dict(enable_gqa=True), "sdpa(enable_gqa)"
        causal = q_off == 0 and window is None  # is_causal's top-left diagonal is this mask
        lib_causal_ms = lib_mask_ms = None
        if causal:
            lib_causal_ms = median_ms(
                lambda: sdpa(q, ke, ve, is_causal=True, scale=scale, **gqa), reps, flush)
        if not (held and causal):
            mask = sdpa_mask(T, ke.shape[2], q_off, window, dev)
            lib_mask_ms = median_ms(
                lambda: sdpa(q, ke, ve, attn_mask=mask, scale=scale, **gqa), reps, flush)
            del mask
        del ke, ve
        # the (query, key) pairs this input needs: every key up to the row's position, in its window
        pairs = sum(min(q_off + t + 1, window or S) for t in range(T))
        nbytes = 2 * (2 * B * Hq * T * D + 2 * B * Hkv * kv_len * D)
        b_ms, b_by = bound(nbytes, 4 * B * Hq * pairs * D, "bf16")
        row = dict(kernel="flash_attention", case=case, Hq=Hq, Hkv=Hkv, D=D, scale=scale, T=T, S=S,
                   q_offset=q_off, window=window,
                   kv_len=kv_len, key_groups=at.flash_key_groups(B, Hq, T, D, dev),
                   held_on="one kv head's group" if held else "the whole call",
                   max_abs_err=err, row_err_ratio=ratio, tol=TOL_KERNEL, bitwise_equal=same,
                   us=ms * 1e3, group_us=None if group_ms is None else group_ms * 1e3,
                   plain_us=plain_ms * 1e3,
                   library_us=(lib_mask_ms if lib_mask_ms is not None else lib_causal_ms) * 1e3,
                   library_causal_us=None if lib_causal_ms is None else lib_causal_ms * 1e3,
                   library=library + (", mask tensor" if lib_mask_ms is not None else ", is_causal"),
                   bound_us=b_ms * 1e3, bound_by=b_by, ok=ratio <= TOL_KERNEL and y_finite)
        emit({"phase": "kernel_check", **row})
        rows.append(row)
        del q, k, v, qg, kg, vg
        torch.cuda.empty_cache()
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


# the hybrid's K3 instance: f32 q over a bf16 cache (after its first delta-net
# layer a bf16 hybrid's residual stream is f32, as JAX's), at Qwen3-Next-80B-A3B's
# full-attention shape (Hq 16, Hkv 2, D 256): T 512 from offset 0 and from 256
FLASH_MIXED_CASES = {"f32q_offset0": (512, 512, 0), "f32q_offset256": (512, 768, 256)}
TOL_F32_ATTN = 1e-4  # per query row, of its max |y|: f32 arithmetic on both sides


def check_flash_mixed(flush, gen, dev):
    """K3's f32-query instance over bf16 k/v against its plain version (each
    query row to its own scale, within TOL_F32_ATTN), two calls bitwise
    equal, timed beside the plain version and SDPA on k/v cast to f32 (the
    cast inside the timed call); the bound counts f32 q and output, bf16
    k/v, and the valid pairs' operations at the f32 (SIMT) peak."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Hq, Hkv, D = 1, 16, 2, 256
    rows = []
    for case, (T, S, q_off) in FLASH_MIXED_CASES.items():
        kv_len = q_off + T
        q = torch.randn(B, Hq, T, D, generator=gen, device=dev)
        k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
        lens = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
        kw = dict(scale=D**-0.5, q_offset=torch.full((B,), q_off, dtype=torch.int32, device=dev))
        before = at.flash_kinds["f32_q_bf16_kv"]
        run = lambda: at.flash_attention(q, k, v, lens, **kw)
        plain = lambda: at.flash_attention_plain(q, k, v, lens, **kw)
        y, y_ref = run(), plain()
        torch.cuda.synchronize()
        ratio = row_err_ratio(y, y_ref, 3)
        same = torch.equal(run(), run())
        instance_ok = at.flash_kinds["f32_q_bf16_kv"] == before + 3 and y.dtype == torch.float32
        ms = median_ms(run, KERNEL_REPS, flush)
        plain_ms = median_ms(plain, PLAIN_REPS, flush)
        mask = sdpa_mask(T, S, q_off, None, dev)
        lib_ms = median_ms(lambda: sdpa(q, k.float(), v.float(), attn_mask=mask, scale=D**-0.5,
                                        enable_gqa=True), KERNEL_REPS, flush)
        pairs = sum(q_off + t + 1 for t in range(T))
        nbytes = 4 * 2 * B * Hq * T * D + 2 * 2 * B * Hkv * kv_len * D
        b_ms, b_by = bound(nbytes, 4 * B * Hq * pairs * D, "f32")
        row = dict(kernel="flash_attention", case=case, instance="f32_q_bf16_kv", Hq=Hq, Hkv=Hkv,
                   D=D, T=T, S=S, q_offset=q_off, kv_len=kv_len,
                   max_abs_err=(y - y_ref).abs().max().item(), row_err_ratio=ratio,
                   tol=TOL_F32_ATTN, bitwise_equal=same, us=ms * 1e3, plain_us=plain_ms * 1e3,
                   library_us=lib_ms * 1e3, library="sdpa(enable_gqa) on k/v cast to f32, "
                   "the cast timed, mask tensor", bound_us=b_ms * 1e3, bound_by=b_by,
                   ok=(ratio <= TOL_F32_ATTN and same and instance_ok
                       and bool(torch.isfinite(y).all())))
        emit({"phase": "kernel_check", **row})
        rows.append(row)
        del q, k, v, mask
    return rows


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


def launch_floor(flush, dev):
    """What the harness charges any call (`kernel_time_ms`): an empty kernel
    (`int8_probe.empty_kernel`, one block that does nothing, launched through
    the same ctypes path as the kernels) and the two events with nothing
    between them, each after the harness's flush and after a clean one.
    Emits the `launch_floor` line beside the card's name and power limit."""
    import torch

    from paroquant_tpu_torch.kernels import int8_probe as ip
    from paroquant_tpu_torch.utils.profiling import kernel_time_ms

    empty = lambda: ip.empty_kernel(dev)
    nothing = lambda: None
    row = {"phase": "launch_floor", "device": torch.cuda.get_device_name(dev), "card": card()}
    for name, fn in (("empty_kernel", empty), ("events_only", nothing)):
        row[f"{name}_us"] = kernel_time_ms(fn, KERNEL_REPS, flush) * 1e3
        row[f"{name}_us_clean_l2"] = kernel_time_ms(fn, KERNEL_REPS, flush, clean_l2=True) * 1e3
    emit(row)
    return row


def check_int8_probe(flush, gen, dev):
    """K14-K17 against their plain versions on the probe's kinds of integer
    inputs (every product and sum exact, so the tolerance is 0): K14 at the
    probe's 8 x 128 and at 4096 x 4096, K15 at 8 x 256 x 128 and the bench's
    8 x 4096 x 4096, K16 at the probe's 8 x 256 -> 512 and at the bench's
    geometry 8 x 4096 -> 4096, K17 at 8 x 4096 x 4096; timed beside the
    bound and one library call (torch._int_mm for K15, and for K16 on the
    unpacked int8 weight; torch.matmul on bf16, which returns bf16, for K17;
    none for K14), K14's and K16's rows beside the launch floor
    (`launch_floor`), K16's also beside K15 on the unpacked weight. K15's,
    K16's and K17's rows name their plan and fail unless two calls give the
    same bits and a call launches one kernel (profiler: no memset); they
    are also timed, with the library call, after a flush that leaves the L2
    clean."""
    import torch

    from paroquant_tpu_torch.kernels import int8_probe as ip
    from paroquant_tpu_torch.utils.profiling import kernel_time_ms

    floor = launch_floor(flush, dev)

    def ints(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=dtype)

    # kernel, case, call, plain, (library call, what it is), bytes, operations, kind, plan's shape
    cases = []
    x32 = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    big32 = torch.randint(-2**31, 2**31 - 1, (4096, 4096), generator=gen, device=dev,
                          dtype=torch.int32)
    for case, x in (("8x128", x32), ("4096x4096", big32)):
        cases.append(("narrow_cast", case, lambda x=x: ip.narrow_cast(x),
                      lambda x=x: ip.narrow_cast_plain(x), (None, "none: no single call computes it"),
                      5 * x.numel(), 0, "int8", None))
    for M, K, N in ((8, 256, 128), (8, 4096, 4096)):
        a, b = ints(-8, 8, (M, K)), ints(-8, 8, (K, N))
        cases.append(("int8_dot", f"{M}x{K}x{N}", lambda a=a, b=b: ip.int8_dot(a, b),
                      lambda a=a, b=b: ip.int8_dot_plain(a, b), int_mm_yardstick(a, b),
                      M * K + K * N + 4 * M * N, 2 * M * K * N, "int8", (M, K, N)))
    unpacked = {}
    for M, S, O in ((8, 256, 512), (8, 4096, 4096)):
        x, w = ints(-127, 127, (M, S)), ints(0, 256, (S // 2, O), torch.uint8)
        unpacked[f"{M}x{S}->{O}"] = (x, ip.unpack_nibbles(w))
        cases.append(("fused_unpack_int8_dot", f"{M}x{S}->{O}",
                      lambda x=x, w=w: ip.fused_unpack_int8_dot(x, w),
                      lambda x=x, w=w: ip.fused_unpack_int8_dot_plain(x, w),
                      int_mm_yardstick(x, ip.unpack_nibbles(w)), M * S + S // 2 * O + 4 * M * O,
                      2 * M * S * O, "int8", (M, S, O)))
    abf, bbf = ints(-8, 8, (8, 4096)).to(torch.bfloat16), ints(-8, 8, (4096, 4096)).to(torch.bfloat16)
    cases.append(("bf16_dot", "8x4096x4096", lambda: ip.bf16_dot(abf, bbf),
                  lambda: ip.bf16_dot_plain(abf, bbf),
                  (lambda: torch.matmul(abf, bbf), "torch.matmul (bf16 out)"),
                  2 * 8 * 4096 + 2 * 4096 * 4096 + 4 * 8 * 4096, 2 * 8 * 4096 * 4096, "bf16",
                  (8, 4096, 4096)))
    plans = {"int8_dot": ip.int8_plan, "fused_unpack_int8_dot": ip.fused_plan,
             "bf16_dot": ip.bf16_plan}
    rows = []
    for kernel, case, run, plain, (lib, lib_note), nbytes, ops, kind, shape in cases:
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
        if kernel in ("narrow_cast", "fused_unpack_int8_dot"):
            row.update(floor_us=floor["empty_kernel_us"],
                       floor_us_clean_l2=floor["empty_kernel_us_clean_l2"])
        if kernel == "narrow_cast":  # and with its input left in the L2 (a 16-byte "flush")
            row.update(us_clean_l2=kernel_time_ms(run, KERNEL_REPS, flush, clean_l2=True) * 1e3,
                       us_l2_resident=kernel_time_ms(run, KERNEL_REPS, flush[:16]) * 1e3)
        if shape is not None:  # one launch a call, its splits merged in a fixed order
            KS, per, rows_per_block = plans[kernel](*shape, ip._sm_count(dev))
            row.update(KS=KS, chunks_per_split=per, rows_per_block=rows_per_block,
                       bitwise_equal=torch.equal(run(), run()), kernels_per_call=kernels_per_call(run),
                       us_clean_l2=kernel_time_ms(run, KERNEL_REPS, flush, clean_l2=True) * 1e3,
                       library_us_clean_l2=None if lib is None else
                       kernel_time_ms(lib, KERNEL_REPS, flush, clean_l2=True) * 1e3)
            if not row["bitwise_equal"] or row["kernels_per_call"] != 1:
                raise SystemExit(f"{kernel} {case}: two calls differ or a call ran "
                                 f"{row['kernels_per_call']} kernels")
        if kernel == "fused_unpack_int8_dot" and case == "8x4096->4096":  # K15 on the unpacked weight
            k15 = lambda xq=unpacked[case]: ip.int8_dot(*xq)
            row.update(k15_unpacked_us=median_ms(k15, KERNEL_REPS, flush) * 1e3,
                       k15_unpacked_us_clean_l2=kernel_time_ms(k15, KERNEL_REPS, flush,
                                                               clean_l2=True) * 1e3)
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


_SASS: dict[str, str] = {}


def sass_text(lib_path):
    """`cuobjdump -sass` of a built library, dumped once a library; None where
    the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    key = str(lib_path)
    if key not in _SASS:
        _SASS[key] = subprocess.run([tool, "-sass", key], capture_output=True, text=True,
                                    check=True, timeout=120).stdout
    return _SASS[key]


def prefetch_sass():
    """Every built library's SASS, one cuobjdump each, all started together
    (the checks below read them from `sass_text`'s cache)."""
    from concurrent.futures import ThreadPoolExecutor

    from paroquant_tpu_torch.kernels import build

    libs = sorted(Path(build.build_info["dir"]).glob("lib*.so"))
    with ThreadPoolExecutor(max(len(libs), 1)) as pool:
        list(pool.map(sass_text, libs))


def sass_counts(lib_name, ops):
    """Per function of a built library (`cuobjdump -sass`), the number of
    SASS lines holding each of `ops`; None where the toolkit has no cuobjdump."""
    from paroquant_tpu_torch.kernels import build

    text = sass_text(Path(build.build_info["dir"]) / lib_name)
    if text is None:
        return None
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                counts[fn][op] += op in line
    return counts


def check_sass(lib_name, ops, expect, absent=()):
    """Emit the `sass` line of one library and check that every instance of
    each kernel in `expect` ((name, op, instances), ...; the name a regular
    expression searched in the mangled one) holds its op, and that no
    function's name holds one of `absent`."""
    import re

    counts = sass_counts(lib_name, ops)
    emit({"phase": "sass", "library": lib_name, "counts": counts})
    if counts is None:
        return
    for name, op, n in expect:
        found = [c[op] for f, c in counts.items() if re.search(name, f)]
        if len(found) != n or min(found) == 0:
            raise SystemExit(f"{name}: expected {op} in {n} instance(s), found {found}")
    left = [f for f in counts for name in absent if name in f]
    if left:
        raise SystemExit(f"{lib_name}: functions that should be gone: {left}")


# K15's three instances (int8_stream_kernel<NM>, NM 1, 2, 4): the sha256 of
# their SASS (`stream_sass_digests`) as the card's toolkit built them before
# K16 became the kernel's nibble instance; adding it must leave them as they were
K15_SASS_SHA256 = {
    1: "7ce02393b4a8bbd1079c54dadbe0df85de16144b48aed156ef3e333cd6cc3125",
    2: "940e4a01e70443f53dceee0464c95b09ffe40244c0d5518b009689143bbb6b77",
    4: "49103c3ab8133685c397021ddc9246e409a0880703c4bedc0fc82e72ffa7a639",
}
STREAM_NAME = r"int8_stream_kernelILi(\d+)E(?:Lb([01])E)?"  # NM, and NIB where the name has it


def stream_sass_digests(lib_path):
    """{(NM, NIB): sha256 of the instance's SASS, instruction and encoding
    lines only} of int8_stream_kernel's instances in a built library, from
    `cuobjdump -sass`; None where the toolkit has no cuobjdump."""
    import hashlib
    import re

    text = sass_text(lib_path)
    if text is None:
        return None
    code = re.compile(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]{16} \*/")
    bodies, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            found = re.search(STREAM_NAME, line)
            key = (int(found.group(1)), found.group(2) == "1") if found else None
            if key:
                bodies[key] = []
        elif key and code.search(line):
            bodies[key].append(" ".join(line.split()))
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest() for k, v in bodies.items()}


def check_descriptors():
    """No ring copy (LDGSTS) of any built library takes its memory
    descriptor (`desc[URn]`, a 64-bit uniform register pair: the L2 cache
    policy of the copy) from an odd n. ptxas put one at UR1 in K15's ring
    copies built with K17's evict_first policy (`int8_dot_sweep`'s arms), and
    that instruction raised "illegal instruction" (CUDA error 715) on this
    card; K17's own copies take UR4. Emits the `descriptors` line: each
    library's descriptor registers."""
    from paroquant_tpu_torch.kernels import build
    from paroquant_tpu_torch.scripts.int8_dot_sweep import descriptor_registers

    libs = sorted(Path(build.build_info["dir"]).glob("lib*.so"))
    if libs and sass_text(libs[0]) is None:
        emit({"phase": "descriptors", "checked": False, "why": "no cuobjdump"})
        return
    found, odd = {}, []
    for lib in libs:
        regs = descriptor_registers(sass_text(lib))
        found[lib.name] = regs
        odd += [f"{lib.name}: UR{n}" for n in regs if n % 2]
    emit({"phase": "descriptors", "checked": True, "registers": found, "odd": odd})
    if odd:
        raise SystemExit(f"memory descriptors in odd uniform registers: {odd}")


def check_k15_sass():
    """K15's three instances against K15_SASS_SHA256: identical, instruction
    for instruction (the `k15_sass` line)."""
    from paroquant_tpu_torch.kernels import build

    digests = stream_sass_digests(Path(build.build_info["dir"]) / "libint8_probe.so")
    if digests is None:
        emit({"phase": "k15_sass", "identical": None, "why": "no cuobjdump"})
        return
    same = {nm: digests.get((nm, False)) == want for nm, want in K15_SASS_SHA256.items()}
    emit({"phase": "k15_sass", "identical": same,
          "digests": {f"{nm}{'_nib' if nib else ''}": d for (nm, nib), d in sorted(digests.items())}})
    if not all(same.values()):
        raise SystemExit(f"K15's SASS changed: {same}")


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
    """K15's streaming instances (int8_stream_kernel<NM, false>, NM 1, 2, 4),
    K16's (its nibble instances, <NM, true>) and K18's (stream_kernel, f32
    and bf16 x) must report 0 spill bytes in ptxas's lines."""
    import re

    fn, spills = None, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "stream_kernel" in fn and "spill stores" in line:
            spills[fn] = (int(re.search(r"(\d+) bytes spill stores", line).group(1))
                          + int(re.search(r"(\d+) bytes spill loads", line).group(1)))
    nib = {f: re.search(STREAM_NAME, f) for f in spills}
    k15 = [b for f, b in spills.items() if nib[f] and nib[f].group(2) != "1"]
    k16 = [b for f, b in spills.items() if nib[f] and nib[f].group(2) == "1"]
    k18 = [b for f, b in spills.items() if not nib[f]]
    emit({"phase": "stream_spills", "spill_bytes": {"k15": k15, "k16": k16, "k18": k18}})
    if len(k15) != 3 or len(k16) != 3 or len(k18) != 2 or any(spills.values()):
        raise SystemExit(f"K15/K16/K18's instances: spill bytes {spills}")


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


def check_routes(rm, phase, need=ONE_LAUNCH_ROUTES):
    """K1/K2's calls by route since the counts were reset; every W4A16 call at
    M <= 16 must have taken the one-launch route, every a8 call at M <= 16
    the RA8 route (the lm_head's, once a decode step), and each route of
    `need` must have run."""
    routes = {k: dict(v) for k, v in rm.route_counts.items()}
    stray = {k: (v["passes_w4a16_m16"], v["passes_a8_m16"]) for k, v in routes.items()
             if v["passes_w4a16_m16"] or v["passes_a8_m16"]}
    if stray:
        raise SystemExit(f"{phase}: K1/K2 calls at M <= 16 (W4A16, a8) took the passes: {stray}")
    for route in need:
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


def paged_sdpa(q4, table, k, v, ks, vs, base, dev, scale=None, window=None):
    """The library yardstick: K/V gathered to contiguous [B, Hkv, S, D] bf16
    BEFORE the timed call (the gather is not timed), then one
    scaled_dot_product_attention with enable_gqa and a boolean mask (causal,
    and within `window` keys of each query where given)."""
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
    kpos = torch.arange(S, device=dev)[None, None, :]
    mask = kpos <= qpos[:, :, None]
    if window:
        mask &= kpos > qpos[:, :, None] - window
    mask = mask[:, None]  # [B, 1, W, S]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=mask, scale=D**-0.5 if scale is None else scale, enable_gqa=True)


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


def paged_bound(lens_keys, W, quant, *, B, Hq, Hkv, D, ps, maxP, window=None):
    """Bytes of the K/V rows the function needs (each slot's keys below its
    length, clamped to maxP * ps, and within the window of its queries, plus
    their int8 scales), q, the output and the table, over the HBM rate;
    operations of the valid (query, key) pairs over the bf16 peak."""
    elem = 1 if quant else 2
    span = window + W - 1 if window else maxP * ps
    rows = sum(min(n, maxP * ps, span) for n in lens_keys)
    nbytes = rows * Hkv * (2 * D * elem + (2 * 4 if quant else 0))
    nbytes += 2 * B * W * Hq * D * 2 + B * maxP * 4 + B * 4
    pairs = sum(min(n - W + 1 + w, maxP * ps, window or maxP * ps)
                for n in lens_keys for w in range(W))
    return bound(nbytes, 4 * Hq * D * pairs, "bf16")


BOTH_PAGED = ("paged_decode_attention", "paged_window_attention_kernel")
# case: (pool shape, slot lengths (the current token included), int8 pool, kernels)
PAGED_CASES = {"bf16": (PAGED, PAGED_LENS, False, BOTH_PAGED),
               "int8": (PAGED, PAGED_LENS, True, BOTH_PAGED)}
# gen32k's one slot at its last step, 32768 keys (Qwen3-0.6B heads, pages of 128)
SLOT32K = {"slot32k": (dict(B=1, Hq=16, Hkv=8, D=128, ps=128, maxP=256), (32768,), False,
                       ("paged_decode_attention",))}
# Gemma 3n E4B's paged step in gemma3n_paths' Engine (8 slots, max_len 1024,
# pages of 128): Hq 8 Hkv 2 D 256, scale 1.0, a sliding layer's window of
# 512; (pool, lengths with the current token, int8, kernels, window, scale)
GEMMA3N_PAGED_CASES = {
    "gemma3n_window512": (dict(B=8, Hq=8, Hkv=2, D=256, ps=128, maxP=8),
                          (17, 130, 300, 513, 600, 640, 64, 1000), False,
                          ("paged_decode_attention",), 512, 1.0)}


# Gemma 3 4B's paged step in vlm_paths' Engine (8 slots, pages of 128): Hq 8
# Hkv 4 D 256, scale 256^-0.5, a sliding layer's window of 1024, lengths up
# to 2048 (so the window cuts the longest)
GEMMA3_PAGED_CASES = {
    "gemma3_window1024": (dict(B=8, Hq=8, Hkv=4, D=256, ps=128, maxP=16),
                          (17, 300, 1025, 1100, 1500, 2048, 64, 700), False,
                          ("paged_decode_attention",), 1024, 256 ** -0.5)}


def check_paged(flush, gen, dev, cases=PAGED_CASES):
    """K4 (one query row a slot) and K5 (a window of PAGED_W rows ending at
    each slot's current token) on each case's pool: each query row held to
    its own scale against the plain version, two calls bitwise equal, timed
    beside the plain version and SDPA on the K/V gathered beforehand. A case
    may end with a sliding window and a softmax scale (default D ** -0.5)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    rows = []
    for case, (shp, slot_lens, quant, kernels, *extra) in cases.items():
        B, Hq, D = shp["B"], shp["Hq"], shp["D"]
        window, scale = (extra + [None, None])[:2]
        scale = D**-0.5 if scale is None else scale
        kw = dict(scale=scale, sliding_window=window, k_scales=None, v_scales=None)
        lens = torch.tensor(slot_lens, dtype=torch.int32, device=dev)
        table, k, v, ks, vs = paged_inputs(gen, dev, quant=quant, **shp)
        kw.update(k_scales=ks, v_scales=vs)
        for kernel in kernels:
            W = 1 if kernel == "paged_decode_attention" else PAGED_W
            if W == 1:
                q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
                seq = lens
                run = lambda: at.paged_decode_attention(q, k, v, table, seq, **kw)
                plain = lambda: at.paged_decode_attention_plain(q, k, v, table, seq, **kw)
                q4, base = q[:, None], seq - 1
            else:
                q = torch.randn(B, W, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
                seq = lens - 1  # the window starts at the current token
                run = lambda: at.paged_window_attention_kernel(q, k, v, table, seq, **kw)
                plain = lambda: at.paged_window_attention_plain(q, k, v, table, seq, **kw)
                q4, base = q, seq
            y, y_ref = run().float(), plain().float()
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            ratio = row_err_ratio(y, y_ref, y.dim() - 1)
            # the split's partials merge in a fixed order: a second call gives the same bits
            same = torch.equal(run(), run())
            emit({"phase": "paged_determinism", "kernel": kernel, "case": case,
                  "bitwise_equal": same})
            if not same:
                raise SystemExit(f"{kernel}: two calls on the same inputs differ")
            ms = median_ms(run, KERNEL_REPS, flush)
            plain_ms = median_ms(plain, PLAIN_REPS, flush)
            lib_ms = median_ms(paged_sdpa(q4, table, k, v, ks, vs, base, dev, scale, window),
                               KERNEL_REPS, flush)
            n_keys = [int(n) + W for n in base.tolist()]
            b_ms, b_by = paged_bound(n_keys, W, quant, window=window, **shp)
            row = dict(kernel=kernel, case=case, B=B, W=W, Hq=Hq, Hkv=shp["Hkv"], D=D,
                       window=window, scale=scale,
                       lens=list(slot_lens), split=at.paged_split(B, shp["Hkv"], 1, shp["maxP"],
                                                                  shp["ps"]),
                       max_abs_err=err, row_err_ratio=ratio,
                       tol=TOL_KERNEL, bitwise_equal=same, us=ms * 1e3,
                       plain_us=plain_ms * 1e3, library_us=lib_ms * 1e3,
                       library="sdpa(enable_gqa) on K/V gathered to contiguous bf16 beforehand; "
                               "the gather is not timed",
                       bound_us=b_ms * 1e3, bound_by=b_by,
                       ok=ratio <= TOL_KERNEL and bool(torch.isfinite(y).all()))
            emit({"phase": "kernel_check", **row})
            rows.append(row)
        del table, k, v, ks, vs
        torch.cuda.empty_cache()
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


def check_paged_f32_queries(flush, gen, dev):
    """K4 with f32 queries over a bf16 pool, the hybrid Engine's step
    (Qwen3-Next-80B-A3B: 8 slots, Hq 16, Hkv 2, D 256, pages of 128, maxP 8,
    PAGED_LENS' first 8 lengths clamped to 1024): the SIMT instance
    (`paged_simt_kernel`; the tensor-core one takes bf16 queries), held to
    TOL_F32_ATTN per query row; SDPA on the gathered pages is the library
    call (bf16, as `paged_sdpa` gives it)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at

    shp = dict(B=8, Hq=16, Hkv=2, D=256, ps=128, maxP=8)
    B, Hq, D = shp["B"], shp["Hq"], shp["D"]
    table, k, v, _, _ = paged_inputs(gen, dev, quant=False, **shp)
    seq = torch.tensor([min(n, 1024) for n in PAGED_LENS], dtype=torch.int32, device=dev)
    q = torch.randn(B, Hq, D, generator=gen, device=dev)
    before = dict(at.paged_instances["paged_decode_attention"])
    run = lambda: at.paged_decode_attention(q, k, v, table, seq, scale=D**-0.5)
    plain = lambda: at.paged_decode_attention_plain(q, k, v, table, seq, scale=D**-0.5)
    y, y_ref = run(), plain()
    torch.cuda.synchronize()
    simt = at.paged_instances["paged_decode_attention"]["simt"] - before["simt"]
    ratio = row_err_ratio(y, y_ref, 2)
    ms = median_ms(run, KERNEL_REPS, flush)
    plain_ms = median_ms(plain, PLAIN_REPS, flush)
    lib_ms = median_ms(paged_sdpa(q[:, None], table, k, v, None, None, seq - 1, dev),
                       KERNEL_REPS, flush)
    rows_kv = sum(seq.tolist())
    nbytes = rows_kv * shp["Hkv"] * 2 * D * 2 + 2 * B * Hq * D * 4 + B * shp["maxP"] * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * Hq * D * rows_kv, "f32")
    row = dict(kernel="paged_decode_attention", case="hybrid step 8 slots f32 q, bf16 pool",
               instance="paged_simt_kernel" if simt == 1 else f"{simt} SIMT launches of 1",
               B=B, W=1, Hq=Hq, Hkv=shp["Hkv"], D=D, maxP=shp["maxP"],
               split=at.paged_split(B, shp["Hkv"], 1, shp["maxP"], shp["ps"]),
               max_abs_err=(y - y_ref).abs().max().item(), row_err_ratio=ratio, tol=TOL_F32_ATTN,
               us=ms * 1e3, plain_us=plain_ms * 1e3, library_us=lib_ms * 1e3,
               bound_us=b_ms * 1e3, bound_by=b_by,
               ok=ratio <= TOL_F32_ATTN and simt == 1 and bool(torch.isfinite(y).all()))
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


def check_logprobs(eng, greedy, cfg, phase, context_bound=TOL_LOGPROB, hold=True):
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
    serve_head_dims move them by only a few tenths of a nat). hold=False
    records the gaps without holding them; the wrong-context check holds at
    any depth."""
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
          "gaps": gaps, "bound": TOL_LOGPROB, "held": hold, "wrong_context_mean_move": context_move})
    if (hold and max(gaps) > TOL_LOGPROB) or context_move <= (context_bound or max(gaps)):
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


def check_paged_decode_has_no_sync(qparams, cfg, dev, B=8):
    """Two paged_decode_steps at B slots (and the engine's sampler after
    each) under torch's sync debug mode "error"."""
    import torch

    from paroquant_tpu_torch.serve.paged import PagedKVCache, paged_decode_step
    from paroquant_tpu_torch.serve.sampling import sample_batch

    ps, maxP = 128, 4
    cache = PagedKVCache.create(cfg, B * maxP + 1, ps, torch.bfloat16, device=dev, batch=B)
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
    emit({"phase": "paged_decode_no_sync", "model_type": cfg.model_type, "batch": B, "steps": 2,
          "sampler": True, "ok": True})


# ---------------------------------------------------------------------------
# phase 6: the decode-measurement entry points (bench.py, the Generator's
# bursts and speculation, kernel_dispatch, bench_prefill, bench_spec)
# ---------------------------------------------------------------------------

NEAR_TIE = 2.0 ** -7  # top-two logit gap, relative to the top one, where an argmax may flip


def reset_counts():
    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm

    rm.reset_launch_counts()
    at.reset_launch_counts()


def port_launches() -> dict:
    """The port's kernel wrappers' launches since the counts were reset, and
    K1/K2's calls by route."""
    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm

    counts = {k: v for k, v in {**rm.launch_counts, **at.launch_counts}.items() if v}
    return {"counts": counts, "routes": {k: {r: n for r, n in v.items() if n}
                                         for k, v in rm.route_counts.items()}}


def root_bench_keys(root: Path) -> list:
    """The keys of the line the JAX bench (root bench.py) prints, read with ast."""
    import ast

    for node in ast.walk(ast.parse((root / "bench.py").read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise SystemExit("bench: no json.dumps({...}) in bench.py")


def check_bench_arm(arm, launched, n_tokens):
    """The W4 arm's lm_head on K1's passes (W4A16 past one wave) and its other
    linears on the one launch; every K1/K2 call of the w4a8 arm (prefill of
    16 rows and decode at M 1) on RA8; no kernel of the port in the bf16 arm."""
    routes, counts = launched["routes"], launched["counts"]
    k1, k2 = routes.get("rot_w4_matmul", {}), routes.get("merged_rot_w4_matmul", {})
    if arm == "bf16":
        ok = not counts
    elif arm == "w4":
        ok = (k1.get("passes_w4a16_m16", 0) >= n_tokens and k1.get("one_launch", 0) > 0
              and set(k2) == {"one_launch"})
    else:
        ok = set(k1) == {"ra8"} and set(k2) == {"ra8"}
    if not ok:
        raise SystemExit(f"bench: the {arm} arm's kernels are not on their routes: {launched}")


def bench_phase(root, dev):
    """The bench's protocol (`bench.run`, on the models `bench.main` builds)
    at chains of 8 and 32 tokens, 1 warm-up and 1 rep (its JSON line printed
    as it is), then each arm alone on the same models: one 8-token chain
    with the counts reset before and read after (K1/K2's routes per arm),
    and profile_decode under the arm's quant_mode: device-busy ms per token
    (the chain's slope reads the host's dispatch as much as the device) and
    the host's time in torch's ops."""
    import torch

    from paroquant_tpu_torch import bench
    from paroquant_tpu_torch.models import PRESETS
    from paroquant_tpu_torch.utils.profiling import profile_decode

    t0 = time.perf_counter()
    cfg = PRESETS["qwen3-0.6b"]
    params, qparams = bench.build_models(cfg, dev)
    reset_counts()
    line = bench.run(params, qparams, cfg, dev, n_short=8, n_long=32, reps=1, warmup=1)
    launched = port_launches()
    missing = [k for k in root_bench_keys(root) if k not in line]
    bad = [k for k, v in line.items() if isinstance(v, float) and not (v == v and v > 0)]
    emit({"phase": "bench_launches", **launched, "missing_keys": missing, "not_positive": bad})
    if missing or bad:
        raise SystemExit(f"bench: keys missing {missing}, values not finite and positive {bad}")
    for arm, mode in bench.arm_modes(dev).items():
        p = params if arm == "bf16" else qparams
        reset_counts()
        secs, toks = bench.make_decode_runner(p, cfg, mode, dev, n_long=8)(8)
        arm_launched = port_launches()
        prof = profile_decode(p, cfg, prompt_len=bench.PROMPT_LEN, steps=4, quant_mode=mode,
                              device=dev)
        emit({"phase": "bench_arm", "arm": arm, "quant_mode": mode, "chain_tokens": 8,
              "chain_s": secs, "tokens_in_range": bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              **arm_launched,
              "device_busy_ms_per_token": prof["device_busy_ms_per_step"],
              "wall_ms_per_token": prof["wall_ms_per_step"],
              "device_idle_share": prof.get("device_idle_share"),
              "launches_per_token": prof["launches_per_step"],
              "k1k2_device_ms_per_token": prof["k1k2_device_ms_per_step"],
              "top_kernels": prof["top_kernels"][:5],
              "profiled_wall_ms_per_token": prof["profiled_wall_ms_per_step"],
              "host_op_ms_per_token": prof["host_op_ms_per_step"],
              "top_host_ops": prof["top_host_ops"]})
        check_bench_arm(arm, arm_launched, 8)
    del params, qparams
    torch.cuda.empty_cache()
    emit({"phase": "bench_seconds", "s": time.perf_counter() - t0})


def generator_burst(qparams, cfg, dev):
    """Generator(decode_burst=8) against decode_burst=1 on a 128-token prompt
    (K3's prefill) and 64 new tokens, greedy and sampled: the same kernels at
    the same shapes and the same draws, so the tokens must be identical."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.serve import Generator, SamplingParams

    gens = {n: Generator(qparams, cfg, quant_mode="auto", attn_mode="flash", decode_burst=n,
                         device=dev) for n in (1, 8)}
    prompt = torch.randint(0, cfg.vocab_size, (128,),
                           generator=torch.Generator().manual_seed(5)).tolist()
    for g in gens.values():  # warm-up
        g.generate(prompt, SamplingParams(max_tokens=9, temperature=0.0))
    cases = {"greedy": SamplingParams(max_tokens=64, temperature=0.0),
             "sampled": SamplingParams(max_tokens=64, temperature=0.8, top_p=0.95, top_k=50)}
    reset_counts()
    for name, sp in cases.items():
        res = {n: g.generate(prompt, sp, torch.Generator(device=dev).manual_seed(7))
               for n, g in gens.items()}
        same = res[1].token_ids == res[8].token_ids
        emit({"phase": "generator_burst", "case": name, "new_tokens": len(res[8].token_ids),
              "identical": same,
              "decode_tok_s": {f"burst{n}": r.stats.tokens_per_second for n, r in res.items()},
              "prefill_ms": {f"burst{n}": r.stats.ttft * 1e3 for n, r in res.items()}})
        if not same or len(res[8].token_ids) != sp.max_tokens:
            raise SystemExit(f"generator_burst: {name} tokens differ between bursts of 8 and 1")
    launched = port_launches()
    check_routes(rm, "generator_burst")
    emit({"phase": "generator_burst_launches", **launched})
    burst_has_no_sync(qparams, cfg, prompt, cases, dev)
    if not all(launched["counts"].get(k) for k in (*SLICE1_W4, "flash_attention")):
        raise SystemExit(f"generator_burst: K1, K2 or K3 not launched: {launched}")


def burst_has_no_sync(qparams, cfg, prompt, cases, dev):
    """A burst of 8 sample+decode steps, greedy and sampled, does not wait
    for the device: torch raises on a synchronising call under sync debug
    mode "error"."""
    import torch

    from paroquant_tpu_torch.models.decoder import KVCache, prefill
    from paroquant_tpu_torch.serve.generator import _stream_burst_impl

    for name, sp in cases.items():
        cache = KVCache.create(cfg, 1, 256, torch.bfloat16, dev)
        logits, cache = prefill(qparams, cfg, torch.tensor([prompt], dtype=torch.int32, device=dev),
                                cache, quant_mode="auto", attn_mode="flash")
        generator = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _stream_burst_impl(qparams, cfg, logits, cache, generator, None, quant_mode="auto",
                               n_steps=8, temperature=sp.temperature, top_p=sp.top_p,
                               top_k=sp.top_k, repetition_penalty=sp.repetition_penalty)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        emit({"phase": "burst_no_sync", "case": name, "steps": 8, "ok": True})


def sequential_greedy(params, cfg, prompt, n, dev):
    """The sequential greedy run (what Generator runs with lookup_spec_k 0:
    prefill, then argmax and decode_step), with the top two logits' gap
    relative to the top one at each token."""
    import torch

    from paroquant_tpu_torch.models.decoder import KVCache, decode_step, prefill

    cache = KVCache.create(cfg, 1, len(prompt) + n + 8, torch.bfloat16, dev)
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    logits, cache = prefill(params, cfg, toks, cache, quant_mode="auto")
    out, gaps = [], []
    for i in range(n):
        top = torch.topk(logits[0].float(), 2).values
        gaps.append(((top[0] - top[1]) / top[0].abs()).item())
        tok = torch.argmax(logits[0].float()).to(torch.int32)
        out.append(int(tok))
        if i + 1 < n:
            logits, cache = decode_step(params, cfg, tok.view(1, 1), cache, quant_mode="auto")
    return out, gaps


def spec_with_windows(gen, prompt, sp):
    """gen.generate(prompt, sp) with each verify forward's cache length and
    logits [1 + k, V] recorded (kept on the device: no host sync added)."""
    import paroquant_tpu_torch.serve.generator as generator

    forward, windows = generator.model_forward, []

    def recording(params, config, window, cache, **kw):
        logits, out = forward(params, config, window, cache, **kw)
        windows.append((cache.length.clone(), logits[0].float()))
        return logits, out

    generator.model_forward = recording
    try:
        res = gen.generate(prompt, sp)
    finally:
        generator.model_forward = forward
    return res, windows


def verify_rows(windows, n_prompt, n_emitted):
    """The verify row that emitted each token 1 .. n_emitted - 1: a window at
    cache length L holds sequence positions L .. L + k, and its row i (on
    the true prefix for i <= its accepted drafts, L_next - L - 1) predicts
    emitted token L + i + 1 - n_prompt. Token 0 comes from the prefill."""
    Ls = [int(L) for L, _ in windows]
    rows = {}
    for w, (L, (_, logits)) in enumerate(zip(Ls, windows)):
        n_rows = (Ls[w + 1] - L) if w + 1 < len(Ls) else logits.shape[0]
        for i in range(n_rows):
            j = L + i + 1 - n_prompt
            if 0 < j < n_emitted:
                rows[j] = logits[i]
    if sorted(rows) != list(range(1, n_emitted)):
        raise SystemExit(f"spec: the verify windows do not cover tokens 1-{n_emitted - 1}")
    return [rows[j] for j in range(1, n_emitted)]


def spec_phase(qparams, cfg, dev):
    """Greedy prompt-lookup speculation (k 4, quant_mode "auto": windows of 5
    rows on K1/K2's one launch and RA8's lm_head) on a repeated and a random
    prompt, 64 new tokens, against the sequential greedy run: equal up to
    its first near-tie (top two logits within NEAR_TIE of the top one,
    relative), where a verify of 5 rows may round apart from a decode of 1.
    Every token after the first is then held at its verify row: the token
    is that row's argmax, and the row's logits lie within TOL_E2E (relative
    Frobenius) of the sequential decode step's on the same prefix (the
    speculative tokens teacher-forced), so a wrong rollback of the cache's
    length, window offset or row shows at any of the 63 positions. The
    same rows held one position off (the sequential step before) must move
    further than the worst of those errors, or the check could not see an
    offset. Acceptance above 0 on the repeated prompt. Then one sampled
    speculative request."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.scripts.bench_spec import first_divergence, prompts
    from paroquant_tpu_torch.serve import Generator, SamplingParams

    gen = Generator(qparams, cfg, quant_mode="auto", lookup_spec_k=4, device=dev)
    sp = SamplingParams(max_tokens=64, temperature=0.0)
    gen.generate([1, 2, 3, 1, 2, 3], SamplingParams(max_tokens=8, temperature=0.0))  # warm-up
    reset_counts()
    for regime, prompt in prompts(cfg.vocab_size).items():
        seq, gaps = sequential_greedy(qparams, cfg, prompt, sp.max_tokens, dev)
        gen.spec_metrics.update(windows=0, drafted=0, accepted=0)
        res, windows = spec_with_windows(gen, prompt, sp)
        toks = res.token_ids
        m = dict(gen.spec_metrics)
        near = next((i for i, g in enumerate(gaps) if g <= NEAR_TIE), len(gaps))
        div = first_divergence(toks, seq)
        acceptance = m["accepted"] / max(m["drafted"], 1)
        if len(toks) != sp.max_tokens:
            raise SystemExit(f"spec: {regime} returned {len(toks)} tokens")
        ver = torch.stack(verify_rows(windows, len(prompt), len(toks)))
        forced = teacher_forced(qparams, cfg, torch.tensor([prompt + toks], dtype=torch.int32,
                                                           device=dev),
                                len(prompt), "auto", "einsum", dev)[1 : len(toks)]
        err = ((ver - forced).norm(dim=-1) / forced.norm(dim=-1)).tolist()
        off = ((ver[1:] - forced[:-1]).norm(dim=-1) / forced[:-1].norm(dim=-1)).tolist()
        own_argmax = ver.argmax(-1).tolist() == toks[1:]
        top = forced.max(dim=-1).values
        gap = (top - forced.gather(-1, torch.tensor(toks[1:], device=dev)[:, None])[:, 0]) / top.abs()
        emit({"phase": "spec", "regime": regime, "spec_k": 4, "new_tokens": len(toks),
              "acceptance": acceptance, **m, "first_near_tie": near, "first_divergence": div,
              "verify_rows": len(err), "tokens_are_their_rows_argmax": own_argmax,
              "rel_fro_err_max": max(err), "rel_fro_err_median": sorted(err)[len(err) // 2],
              "bound": TOL_E2E, "off_by_one_median": sorted(off)[len(off) // 2],
              "off_by_one_min": min(off),
              "not_sequential_argmax": int((gap > 0).sum()), "max_token_gap": float(gap.max()),
              "decode_tok_s": res.stats.tokens_per_second})
        if div < near:
            raise SystemExit(f"spec: {regime} diverged at {div}, before the first near-tie {near}")
        if not own_argmax or max(err) > TOL_E2E:
            raise SystemExit(f"spec: {regime}: a verify row is not its token's argmax, or its "
                             f"logits are over {TOL_E2E} from the sequential step's: {max(err)}")
        if sorted(off)[len(off) // 2] <= max(err):
            raise SystemExit(f"spec: {regime}: one position off moves the logits no more than "
                             f"the worst verify error ({max(err)}): the check cannot see it")
        if regime == "repeat" and not acceptance > 0:
            raise SystemExit("spec: no draft accepted on the repeated prompt")
    sampled = SamplingParams(max_tokens=64, temperature=0.8, top_p=0.95, top_k=50)
    gen.spec_metrics.update(windows=0, drafted=0, accepted=0)
    toks = gen.generate(prompts(cfg.vocab_size)["repeat"], sampled,
                        torch.Generator(device=dev).manual_seed(3)).token_ids
    in_range = len(toks) == 64 and all(0 <= t < cfg.vocab_size for t in toks)
    emit({"phase": "spec_sampled", "new_tokens": len(toks), "in_range": in_range,
          "windows": gen.spec_metrics["windows"], "first_tokens": toks[:8]})
    if not in_range:
        raise SystemExit("spec: the sampled speculative request's tokens are wrong")
    launched = port_launches()
    check_routes(rm, "spec")
    emit({"phase": "spec_launches", **launched})


def script_phase(name, fn, need):
    """Run a ported script with the counts reset before and read after; the
    kernels in `need` (name -> routes of K1/K2 that must be taken) must run."""
    reset_counts()
    t0 = time.perf_counter()
    rows = fn()
    launched = port_launches()
    emit({"phase": f"{name}_launches", **launched, "s": time.perf_counter() - t0})
    for kernel, routes in need.items():
        taken = launched["routes"].get(kernel, {})
        if not launched["counts"].get(kernel) or any(not taken.get(r) for r in routes):
            raise SystemExit(f"{name}: {kernel} did not run on {routes}: {launched}")
    return rows


def measurement_paths(root, qparams, cfg, dev):
    from paroquant_tpu_torch.scripts import bench_prefill, bench_spec, kernel_dispatch

    bench_phase(root, dev)
    generator_burst(qparams, cfg, dev)
    spec_phase(qparams, cfg, dev)
    rows = script_phase("kernel_dispatch",
                        lambda: kernel_dispatch.main(dev, ms=(1, 16, 64, 128, 256, 512)),
                        {"rot_w4_matmul": ("one_launch", "passes")})
    emit({"phase": "kernel_dispatch", "rows": rows})
    rows = script_phase("bench_prefill", lambda: bench_prefill.main(dev),
                        {"rot_w4_matmul": ("passes",)})
    emit({"phase": "bench_prefill", "rows": rows})
    rows = script_phase("bench_spec", lambda: bench_spec.main(dev, tokens=32, reps=1),
                        {"rot_w4_matmul": ("one_launch",), "merged_rot_w4_matmul": ("one_launch",)})
    if any(r["len"] != 32 for r in rows):
        raise SystemExit(f"bench_spec: a request did not return 32 tokens: {rows}")


def finite(x) -> bool:
    return isinstance(x, (int, float)) and x == x and abs(x) != float("inf")


def bench_scripts(dev):
    """Slice 21's paths, the five ported bench scripts at cut sizes, each
    through `script_phase` (counts reset before, read after): bench_7b at
    full llama-2-7b width with 2 layers (batch 1 and 8, arms fused and w4a8,
    16 tokens: K1/K2 on the one launch and RA8); bench_decode_accounting on
    the same model (B 32, 16 tokens: K1/K2 on the passes), whose buckets must
    add up to its device-busy time, with a finite attention ablation;
    bench_kv_quant at its full size (K4 on both pools); bench_serving on
    qwen3-0.6b cut to 4 layers, 8 requests, spec_k 4 (K1/K2, K4, K5; every
    request returns its max_tokens); bench_a8_accuracy on qwen3-0.6b, one
    sequence of 128 tokens (the plain path: no kernel), finite."""
    import dataclasses

    import torch

    from paroquant_tpu_torch.models import PRESETS, merge_projections
    from paroquant_tpu_torch.scripts import (bench_7b, bench_a8_accuracy,
                                             bench_decode_accounting as bda, bench_kv_quant,
                                             bench_serving)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(PRESETS["llama-2-7b"], num_hidden_layers=2)
    params, cfg = bench_7b.build_quantized_llama7b(config=cfg, device=dev)
    params = merge_projections(params, cfg)
    emit({"phase": "bench_7b_model", "layers": 2, "hidden": cfg.hidden_size,
          "build_s": time.perf_counter() - t0})
    rows = script_phase("bench_7b", lambda: bench_7b.run(params, cfg, [1, 8], 16,
                                                         ["fused", "w4a8"], dev),
                        {"rot_w4_matmul": ("one_launch", "ra8")})
    emit({"phase": "bench_7b", "rows": rows})
    if len(rows) != 4 or not all(finite(r["tok_s"]) and r["tok_s"] > 0 for r in rows):
        raise SystemExit(f"bench_7b: rows missing or not positive: {rows}")

    names: dict[str, str] = {}
    bucket_of = bda.bucket_of
    bda.bucket_of = lambda n: names.setdefault(n, bucket_of(n))
    try:
        rows = script_phase("bench_decode_accounting",
                            lambda: bda.account(params, cfg, 32, [16], dev),
                            {"rot_w4_matmul": ("passes",)})
    finally:
        bda.bucket_of = bucket_of
    emit({"phase": "bench_decode_accounting_names", "names": {n[:160]: b for n, b in names.items()}})
    row = rows[0]
    buckets = row["device_profile_per_step_ms"]
    gap = abs(sum(buckets.values()) - row["device_busy_ms_per_step"])
    if (not finite(row["attention_ms_ab (full - identity-attn)"])
            or gap > 0.005 + 0.0005 * len(buckets) or not buckets.get("quant_matmuls")):
        raise SystemExit(f"bench_decode_accounting: ablation not finite, buckets off their "
                         f"busy time by {gap} ms, or no quantized matmul: {row}")
    del params
    torch.cuda.empty_cache()

    rows = script_phase("bench_kv_quant", lambda: bench_kv_quant.main(dev),
                        {"paged_decode_attention": ()})
    if not all(finite(r["us_per_step"]) and r["us_per_step"] > 0 for r in rows):
        raise SystemExit(f"bench_kv_quant: {rows}")

    args = bench_serving.parse_args(["--preset", "qwen3-0.6b", "--layers", "4",
                                     "--requests", "8", "--spec-k", "4"])
    scfg = dataclasses.replace(PRESETS["qwen3-0.6b"], num_hidden_layers=4)
    qparams = bench_serving.build(scfg, dev)
    out, reqs = script_phase(
        "bench_serving", lambda: bench_serving.run(qparams, scfg, args, dev),
        {"rot_w4_matmul": (), "paged_decode_attention": (), "paged_window_attention_kernel": ()})
    lens = []
    for r in reqs:
        n = 0
        while not r.out_queue.empty():
            n += r.out_queue.get_nowait()[0] == "token"
        lens.append(n)
    emit({"phase": "bench_serving", **out, "tokens_per_request": lens})
    if len(reqs) != 8 or any(n != args.max_tokens for n in lens):
        raise SystemExit(f"bench_serving: a request did not return {args.max_tokens} tokens: {lens}")
    del qparams
    torch.cuda.empty_cache()

    row = script_phase("bench_a8_accuracy",
                       lambda: bench_a8_accuracy.main(["--n-seq", "1", "--seqlen", "128"]), {})
    if not all(finite(v) for k, v in row.items() if k not in ("metric", "preset")):
        raise SystemExit(f"bench_a8_accuracy: {row}")
    emit({"phase": "bench_scripts_seconds", "s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phase 8: the user entry points' paths (the native packer, an AWQ checkpoint at
# full width, cli/evaluate, cli/chat, bench_longcontext)
# ---------------------------------------------------------------------------

TOL_PPL_CHUNK = 1e-4  # a 4096-token window's PPL, chunked CE against unchunked


def native_packer():
    """The native packer is built and loaded from native/paropack.cpp (a
    missing library fails the phase); the AWQ pair and pack_w4_tpu give the
    numpy path's bits on an 8 MB tensor; _lookup_draft gives the numpy scan's
    drafts on random 4096-token contexts with planted repeats."""
    import numpy as np

    from paroquant_tpu_torch.ops import native_packing as nat, packing as pk
    from paroquant_tpu_torch.serve.generator import _lookup_draft

    t0 = time.perf_counter()
    if nat.library() is None:
        raise SystemExit(f"native packer: {nat.library_path()} did not build or load")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    q = rng.integers(0, 16, size=(1024, 2048)).astype(np.int32)  # 8 MB: past the 1 MB routing
    words = rng.integers(-(1 << 31), 1 << 31, size=(1024, 256)).astype(np.int32)

    def run_all():
        out, ms = {}, {}
        for name, fn in (("pack_awq", lambda: pk.pack_awq(q)),
                         ("unpack_awq", lambda: pk.unpack_awq(words)),
                         ("pack_w4_tpu", lambda: pk.pack_w4_tpu(q).numpy())):
            t = time.perf_counter()
            out[name] = fn()
            ms[name] = (time.perf_counter() - t) * 1e3
        return out, ms

    native, native_ms = run_all()
    saved = pk._NATIVE_MIN_BYTES
    pk._NATIVE_MIN_BYTES = 1 << 62  # every size on the numpy path
    try:
        plain, plain_ms = run_all()
    finally:
        pk._NATIVE_MIN_BYTES = saved
    equal = {k: bool(np.array_equal(native[k], plain[k])) for k in native}
    ctxs = []
    for _ in range(8):
        ctx = rng.integers(0, 2000, size=4096).tolist()
        for _ in range(16):  # planted repeats of 1-3 grams
            n = int(rng.integers(1, 4))
            i, j = sorted(rng.choice(4096 - n, size=2, replace=False).tolist())
            ctx[j : j + n] = ctx[i : i + n]
        ctx[-3:] = ctx[1000:1003]  # a suffix that recurs
        ctxs.append(ctx)
    t = time.perf_counter()
    drafts = [_lookup_draft(c, 4) for c in ctxs]
    draft_ms = (time.perf_counter() - t) * 1e3 / len(ctxs)
    library = nat.library
    nat.library = lambda: None  # the numpy scan
    try:
        t = time.perf_counter()
        scans = [_lookup_draft(c, 4) for c in ctxs]
        scan_ms = (time.perf_counter() - t) * 1e3 / len(ctxs)
    finally:
        nat.library = library
    row = {"phase": "native_packer", "library": str(nat.library_path()), "build_s": build_s,
           "bitwise_equal": equal, "native_host_ms": native_ms, "numpy_host_ms": plain_ms,
           "lookup_equal": drafts == scans, "lookup_drafted": sum(map(len, drafts)),
           "lookup_native_host_ms": draft_ms, "lookup_numpy_host_ms": scan_ms}
    emit(row)
    if not all(equal.values()) or drafts != scans or not any(drafts):
        raise SystemExit(f"native packer: the native path differs from the numpy path: {row}")


def qwen3_hf_config(cfg) -> dict:
    """config.json of a Qwen3 preset with the AWQ-format quantization_config."""
    keys = ("model_type", "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "head_dim", "rms_norm_eps", "rope_theta",
            "max_position_embeddings", "tie_word_embeddings")
    out = {k: getattr(cfg, k) for k in keys}
    out["quantization_config"] = {"quant_method": "paroquant", "bits": 4, "group_size": 128,
                                  "krot": 7}  # log2(128) butterfly stages
    return out


def write_awq_model(path, dev):
    """A Qwen3-0.6B AWQ directory (28 layers, random bf16 weights from seed 0,
    Hadamard RTN W4 g128): each linear's interchange tensors made from the
    port's RTN pieces (`convert/rtn.py::_rotation_params`, `ops/quant.py`),
    scales rounded to f16, packed with `pack_awq`, written with
    `write_safetensors`. Returns the model built in memory from the same
    tensors with `make_quantized_linear` (projections unmerged, as the loader
    leaves them)."""
    import math

    import torch

    from paroquant_tpu_torch.convert.checkpoint import write_safetensors
    from paroquant_tpu_torch.convert.rtn import _rotation_params
    from paroquant_tpu_torch.models import PRESETS
    from paroquant_tpu_torch.ops import quant, rotation as rot_ops
    from paroquant_tpu_torch.ops.packing import pack_awq
    from paroquant_tpu_torch.ops.qlinear import make_quantized_linear

    t0 = time.perf_counter()
    cfg = PRESETS["qwen3-0.6b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    bf16 = torch.bfloat16
    tensors = {}

    def ones(name, n):
        tensors[name] = torch.ones(n, dtype=bf16)
        return torch.ones(n, dtype=bf16, device=dev)

    def linear(prefix, fan_in, fan_out):
        w = (torch.randn(fan_in, fan_out, generator=gen, device=dev) / math.sqrt(fan_in)).to(bf16)
        w = w.to(torch.float32).T  # [O, I]
        rp, theta = _rotation_params(fan_in, 128, 8, 0, True)
        w_rot = rot_ops.apply_rotation_stages(w, theta.to(dev), rot_ops.to_permutation_form(
            rp.pairs, 128, dev))
        qp = quant.calc_scales_and_zero_points(w_rot, 128, 4)
        q, s, z = quant.quantize_to_int(w_rot, qp, 4, 128)
        s16, theta16 = s.to(torch.float16), theta.to(torch.float16)
        pairs16 = torch.as_tensor(rp.pairs).to(torch.int16)
        tensors[f"{prefix}.qweight"] = torch.from_numpy(pack_awq(q.T.cpu().numpy()))
        tensors[f"{prefix}.qzeros"] = torch.from_numpy(pack_awq(z.T.cpu().numpy()))
        tensors[f"{prefix}.scales"] = s16.T.contiguous().cpu()
        tensors[f"{prefix}.theta"] = theta16
        tensors[f"{prefix}.pairs"] = pairs16
        tensors[f"{prefix}.channel_scales"] = torch.ones(1, fan_in, dtype=torch.float16)
        return make_quantized_linear(q, s16.to(torch.float32), z.to(torch.float32),
                                     pairs16.to(torch.int32), theta16.to(torch.float32),
                                     torch.ones(fan_in), 128, device=dev)

    embed = (torch.randn(cfg.vocab_size, H, generator=gen, device=dev) * 0.02).to(bf16)
    tensors["model.embed_tokens.weight"] = embed.cpu()
    params = {"embed_tokens": embed, "norm": ones("model.norm.weight", H), "layers": []}
    for li in range(cfg.num_hidden_layers):
        b = f"model.layers.{li}"
        lp = {"input_layernorm": ones(f"{b}.input_layernorm.weight", H),
              "post_attention_layernorm": ones(f"{b}.post_attention_layernorm.weight", H),
              "q_norm": ones(f"{b}.self_attn.q_norm.weight", D),
              "k_norm": ones(f"{b}.self_attn.k_norm.weight", D)}
        for name, fi, fo in (("q_proj", H, Hq * D), ("k_proj", H, Hkv * D), ("v_proj", H, Hkv * D),
                             ("o_proj", Hq * D, H)):
            lp[name] = linear(f"{b}.self_attn.{name}", fi, fo)
        lp["mlp"] = {name: linear(f"{b}.mlp.{name}", fi, fo) for name, fi, fo in (
            ("gate_proj", H, I), ("up_proj", H, I), ("down_proj", I, H))}
        params["layers"].append(lp)
    path.mkdir(parents=True, exist_ok=True)
    write_safetensors(path / "model.safetensors", tensors)
    (path / "config.json").write_text(json.dumps(qwen3_hf_config(cfg)))
    emit({"phase": "awq_model", "preset": "qwen3-0.6b", "layers": cfg.num_hidden_layers,
          "tensors": len(tensors), "file_bytes": (path / "model.safetensors").stat().st_size,
          "build_s": time.perf_counter() - t0})
    return params


def prefill_and_decode(params, cfg, dev, n_prompt=256, n_new=8):
    """(logits, tokens): a prefill of n_prompt random tokens (seed 1; K3, the
    plain W4 path) and n_new greedy decode steps (K1/K2), quant_mode "auto"."""
    import torch

    from paroquant_tpu_torch.models import KVCache
    from paroquant_tpu_torch.models.decoder import greedy_decode_scan, model_forward

    toks = torch.randint(0, cfg.vocab_size, (1, n_prompt), generator=torch.Generator().manual_seed(1))
    toks = toks.to(device=dev, dtype=torch.int32)
    cache = KVCache.create(cfg, 1, 512, torch.bfloat16, dev)  # 512 keys: K3's tiles
    logits, cache = model_forward(params, cfg, toks, cache, quant_mode="auto", attn_mode="flash")
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    gen_toks, _ = greedy_decode_scan(params, cfg, first, cache, n_new, quant_mode="auto")
    return logits, gen_toks


def awq_logits(path, inmem, dev):
    """load_checkpoint on the AWQ directory against the model built in memory
    from the same tensors: a 256-token prefill (K3, the plain W4 path) and 8
    greedy decode steps (K1/K2). Identical inputs on one device: the logits
    and tokens must be equal, bit for bit."""
    import torch

    from paroquant_tpu_torch.convert.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    loaded, cfg = load_checkpoint(path, device=dev)
    load_s = time.perf_counter() - t0
    out = {name: prefill_and_decode(p, cfg, dev)
           for name, p in (("loaded", loaded), ("in_memory", inmem))}
    err = (out["loaded"][0] - out["in_memory"][0]).abs().max().item()
    same_toks = torch.equal(out["loaded"][1], out["in_memory"][1])
    row = {"phase": "awq_logits_check", "load_s": load_s, "max_abs_err": err, "bound": 0.0,
           "tokens_equal": same_toks, "finite": bool(torch.isfinite(out["loaded"][0]).all())}
    emit(row)
    if err != 0.0 or not same_toks or not row["finite"]:
        raise SystemExit(f"awq: the loaded model differs from the in-memory one: {row}")
    return loaded, cfg


def evaluate_paths(path, inmem, cfg, dev):
    """cli/evaluate.main on the AWQ directory (--synthetic --seqlen 2048
    --num-tokens 4096) prints the PPL of `perplexity` on the in-memory model
    within 1e-5 relative (its 4 decimals), with K3 once a layer a window; one
    4096-token window with chunk_ce 2048 and 8192 (unchunked) within
    TOL_PPL_CHUNK relative."""
    import contextlib
    import io

    import numpy as np

    from paroquant_tpu_torch.cli import evaluate

    buf = io.StringIO()
    args = ["--model", str(path), "--synthetic", "--seqlen", "2048", "--num-tokens", "4096"]

    def run_main():
        with contextlib.redirect_stdout(buf):
            evaluate.main(args)

    script_phase("evaluate_main", run_main, {"flash_attention": ()})
    launched = port_launches()["counts"]
    line = buf.getvalue().strip().splitlines()[-1]
    got = float(line.split()[-1])
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, 4096).astype(np.int32)
    t0 = time.perf_counter()
    want = evaluate.perplexity(inmem, cfg, toks, 2048, "auto")
    ppl_s = time.perf_counter() - t0
    chunked = evaluate.perplexity(inmem, cfg, toks, 4096, "auto", chunk_ce=2048)
    whole = evaluate.perplexity(inmem, cfg, toks, 4096, "auto", chunk_ce=8192)
    row = {"phase": "evaluate", "line": line, "ppl": got, "ppl_in_memory": want,
           "rel_err": abs(got - want) / want, "k3_launches": launched.get("flash_attention"),
           "perplexity_s_2_windows": ppl_s, "ppl_4096_chunked": chunked,
           "ppl_4096_unchunked": whole, "chunk_rel_err": abs(chunked - whole) / whole,
           "card": card()}
    emit(row)
    if (row["rel_err"] > 1e-5 or row["k3_launches"] != 2 * cfg.num_hidden_layers
            or row["chunk_rel_err"] > TOL_PPL_CHUNK or not finite(got)):
        raise SystemExit(f"evaluate: {row}")


class ByteTokenizer:
    """A stand-in tokenizer for the chat phase: bytes as ids 0-255, a chat
    template of tagged turns; other ids decode to nothing."""

    eos_token_id = 151645

    def apply_chat_template(self, messages, add_generation_prompt=True, enable_thinking=True):
        text = "".join(f"<|{m['role']}|>{m['content']}" for m in messages)
        text += "<|assistant|>" if add_generation_prompt else ""
        text += "" if enable_thinking else "<|nothink|>"
        return list(text.encode())

    def decode(self, ids, skip_special_tokens=True):
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def chat_phase(params, cfg, dev):
    """cli/chat's turn loop on the AWQ-loaded model (the Generator, W4 decode
    on K1/K2) with scripted lines: hi, /think, a second turn, /clear, a third
    turn; each turn streams at most --max-tokens tokens and prints its stats
    line, and the third turn's prompt holds only its own line."""
    import io

    from rich.console import Console

    from paroquant_tpu_torch.cli.chat import chat_turns
    from paroquant_tpu_torch.serve import Generator, SamplingParams

    max_tokens = 32
    gen = Generator(params, cfg, ByteTokenizer(), max_len=2 * max_tokens + 512, device=dev)
    sp = SamplingParams(max_tokens=max_tokens, temperature=0.6, top_p=0.95)
    lines = iter(["hi", "/think", "and a second turn", "/clear", "a third turn"])

    def read_line():
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    buf = io.StringIO()
    history = []
    console = Console(file=buf, width=120)
    turns = script_phase("chat", lambda: chat_turns(gen, sp, read_line, console, history=history),
                         {"rot_w4_matmul": ()})
    text = buf.getvalue()
    stats = [ln[ln.index("ttft"):].strip() for ln in text.splitlines() if "tok/s" in ln]
    row = {"phase": "chat",
           "turns": [{"prompt_tokens": len(t["prompt"]), "tokens": len(t["tokens"]),
                      "ttft_s": t["ttft_s"], "tok_s": t["tok_s"]} for t in turns],
           "stats_lines": stats, "thinking_toggled": "thinking off" in text,
           "cleared": "history cleared" in text}
    emit(row)
    third = gen.build_prompt([{"role": "user", "content": "a third turn"}], False)
    if (len(turns) != 3 or len(stats) != 3 or not row["thinking_toggled"] or not row["cleared"]
            or any(not 1 <= len(t["tokens"]) <= max_tokens for t in turns)
            or turns[2]["prompt"] != third or len(history) != 2):
        raise SystemExit(f"chat: {row}")


def long_attention(dev):
    """K3 at bench_longcontext's two 16k shapes (held on one kv head's
    group) and K4 over one slot of 32k keys, through check_flash's and
    check_paged's checks."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = check_flash(flush, gen, dev, LONG_FLASH_CASES) + check_paged(flush, gen, dev, SLOT32K)
    del flush
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"long_attention: {len(bad)} checks missed their tolerance: {bad}")
    return rows


GEN32K_TOTAL = 256  # gen32k's context: its 32-token prompt and 224 generated


def bench_longcontext_phase(dev):
    """The three arms through script_phase: ttft16k at its defaults (16384
    tokens in chunks of 2048: K3 on every chunk of each layer, twice, and K4
    in the decode), gen32k at --gen-total GEN32K_TOTAL (finish "done", K4),
    ppl16k at qwen3-8b width cut to 2 layers over the full 16384-token
    window (K3 once a layer; PPL and peak bytes finite)."""
    import torch

    from paroquant_tpu_torch.scripts import bench_longcontext as bl

    def build(preset, layers=None):
        """build_w4's model; prints its time and its peak device memory above
        what was allocated before it."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        model = bl.build_w4(preset, layers=layers, device=dev)
        torch.cuda.synchronize(dev)
        emit({"phase": "bench_longcontext_model", "preset": preset, "layers": layers,
              "build_s": time.perf_counter() - t0,
              "build_peak_bytes": torch.cuda.max_memory_allocated(dev) - before,
              "held_bytes": torch.cuda.memory_allocated(dev) - before})
        return model

    model = build("qwen3-0.6b")
    L = model[1].num_hidden_layers
    args = bl.parse_args(["--arm", "ttft16k"])
    out = script_phase("bench_longcontext_ttft16k", lambda: bl.arm_ttft16k(args, dev, model),
                       {"flash_attention": (), "paged_decode_attention": ()})
    k3 = port_launches()["counts"].get("flash_attention")
    if (k3 != 2 * out["chunks"] * L
            or not (finite(out["ttft_cold_s"]) and finite(out["ttft_warm_s"]))):
        raise SystemExit(f"ttft16k: K3 ran {k3} times, not {2 * out['chunks'] * L}: {out}")
    args = bl.parse_args(["--arm", "gen32k", "--gen-total", str(GEN32K_TOTAL)])
    out = script_phase("bench_longcontext_gen32k", lambda: bl.arm_gen32k(args, dev, model),
                       {"paged_decode_attention": (), "rot_w4_matmul": ()})
    if out["finish"] != "done" or out["generated"] != GEN32K_TOTAL - 32:
        raise SystemExit(f"gen32k: {out}")
    del model
    torch.cuda.empty_cache()
    args = bl.parse_args(["--arm", "ppl16k", "--layers", "2"])
    model = build("qwen3-8b", args.layers)
    out = script_phase("bench_longcontext_ppl16k", lambda: bl.arm_ppl16k(args, dev, model),
                       {"flash_attention": ()})
    del model
    k3 = port_launches()["counts"].get("flash_attention")
    if k3 != 2 or not finite(out["ppl_random_weights"]) or not finite(out["peak_bytes_in_use"]):
        raise SystemExit(f"ppl16k: K3 ran {k3} times, not 2: {out}")
    torch.cuda.empty_cache()


def user_paths(dev):
    """The user entry points' paths: the native packer, a Qwen3-0.6B AWQ checkpoint at
    full width loaded and held against the same model built in memory,
    cli/evaluate and its chunked CE, cli/chat's turn loop, K3 and K4 at the
    long-context shapes, and bench_longcontext's three arms."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    native_packer()
    with tempfile.TemporaryDirectory(prefix="paro_awq_") as tmp:
        path = Path(tmp) / "qwen3-0.6b-awq"
        inmem = write_awq_model(path, dev)
        loaded, cfg = awq_logits(path, inmem, dev)
        evaluate_paths(path, inmem, cfg, dev)
        chat_phase(loaded, cfg, dev)
    del inmem, loaded
    torch.cuda.empty_cache()
    rows = long_attention(dev)
    bench_longcontext_phase(dev)
    emit({"phase": "user_paths_seconds", "s": time.perf_counter() - t0})
    return rows


# ---------------------------------------------------------------------------
# conversion without calibration, and serving over HTTP
# ---------------------------------------------------------------------------

# GPTQ's depth, cut from Qwen3-0.6B's 28 layers (never the width): at 28 the
# step took 85.2 s of GPTQ alone in one run on an NVIDIA H100 80GB HBM3 at
# 700.00 W, over the ~90 s it may take
GPTQ_LAYERS = 2
GPTQ_SAMPLES, GPTQ_SEQLEN = 8, 512
HTTP_TIMEOUT = 120.0  # seconds a client call may take; an engine thread that died shows here
HTTP_NEW_TOKENS = 16  # each greedy completion of serve_http's rounds
# nats: a served token may sit this far below its prefix's top token in a
# prefill of the whole sequence (a near-tie that batching's arithmetic may
# flip): two steps of these bf16 logits (0.03125 at magnitudes 4-8), one for
# each side's rounding. On an NVIDIA H100 80GB HBM3 at 700.00 W, serve_http's
# tokens sat at most 0.044 below the top (the first forks between runs
# 0.0008-0.033), and the median top-two gap, which must stay above this
# limit, was 0.103 (0.078 in the router's rounds)
NEAR_TIE_NATS = 0.0625


def model_from_exports(params, exports, fmt, dev):
    """The model a saved directory should load to, built in memory from the
    exports: dense tensors rounded to f16 as the file holds them (loaded as
    bf16), theta and channel scales to f16, and the AWQ format's scales to
    f16 (the PARO-TPU format keeps them f32). A sparse layer's router (and
    an untied lm_head) are dense; its stacked experts come from the
    "mlp.experts" export through `quantized_moe_from_export`, a shared
    expert from its exports and its gate dense. A delta-net layer's linears
    come from their exports where exported, else dense; conv_w, dt_bias and
    A_log stay f32 as the file holds them. A gemma3n model's per-layer
    embedding module, AltUp, LAuReL and per-layer input linears are dense,
    correct_output_scale f32."""
    import torch

    from paroquant_tpu_torch.models import DenseLinear
    from paroquant_tpu_torch.ops.qlinear import make_quantized_linear
    from paroquant_tpu_torch.optim.pseudo_moe import quantized_moe_from_export

    def f16(t):
        return t.to(torch.float16).to(torch.bfloat16)

    def r16(a):
        return torch.from_numpy(a).to(torch.float16).to(torch.float32)

    def qlin(e):
        s = r16(e["scales"]) if fmt == "awq" else torch.from_numpy(e["scales"])
        return make_quantized_linear(e["q"], s, e["zeros"].astype("float32"), e["pairs"],
                                     r16(e["theta"]), r16(e["inv_channel_scales"]),
                                     e["group_size"], n_bits=e["n_bits"], device=dev)

    def experts(e):
        e = dict(e, **{k: r16(e[k]).numpy() for k in e if k.endswith(("_theta", "_scales"))})
        if fmt == "awq":
            e.update({p: dict(e[p], scales=r16(e[p]["scales"]).numpy())
                      for p in ("gate", "up", "down")})
        return quantized_moe_from_export(e, torch.bfloat16, dev)

    def dense(lin):
        return DenseLinear(f16(lin.w))

    out = {"embed_tokens": f16(params["embed_tokens"]), "norm": f16(params["norm"]), "layers": []}
    if "lm_head" in params:
        out["lm_head"] = dense(params["lm_head"])
    if "altup_projections" in params:  # gemma3n's per-layer embedding module and AltUp
        out["embed_tokens_per_layer"] = f16(params["embed_tokens_per_layer"])
        out["per_layer_model_projection"] = dense(params["per_layer_model_projection"])
        out["per_layer_projection_norm"] = f16(params["per_layer_projection_norm"])
        for key in ("altup_projections", "altup_unembed_projections"):
            out[key] = [dense(lin) for lin in params[key]]
    for lp, exp in zip(params["layers"], exports):
        nlp = {k: f16(v) for k, v in lp.items() if k.endswith("norm")}
        if "altup" in lp:  # a gemma3n layer's dense modules (correct_output_scale f32)
            ap, lau = lp["altup"], lp["laurel"]
            nlp["altup"] = {"correct_output_scale": ap["correct_output_scale"].to(torch.float32),
                            "router_norm": f16(ap["router_norm"]),
                            **{n: dense(ap[n]) for n in ("correction_coefs", "prediction_coefs",
                                                         "modality_router")}}
            nlp["laurel"] = {"linear_left": dense(lau["linear_left"]),
                             "linear_right": dense(lau["linear_right"]),
                             "post_laurel_norm": f16(lau["post_laurel_norm"])}
            nlp.update({n: dense(lp[n]) for n in ("per_layer_input_gate", "per_layer_projection")})
        if "linear_attn" in lp:
            la = lp["linear_attn"]
            nlp["linear_attn"] = {
                **{n: qlin(exp[f"linear_attn.{n}"]) if f"linear_attn.{n}" in exp
                   else DenseLinear(f16(la[n].w)) for n in ("in_proj_qkvz", "in_proj_ba", "out_proj")},
                **{n: la[n].to(torch.float32) for n in ("conv_w", "dt_bias", "A_log")},
                "norm": f16(la["norm"])}
        else:
            nlp.update({k: qlin(exp[k]) for k in ("q_proj", "k_proj", "v_proj", "o_proj")})
        if "mlp.experts" in exp:
            nlp["mlp"] = {"router": DenseLinear(f16(lp["mlp"]["router"].w)),
                          "experts": experts(exp["mlp.experts"])}
            if "shared_expert" in lp["mlp"]:
                nlp["mlp"]["shared_expert"] = {k: qlin(exp[f"mlp.shared_expert.{k}"])
                                               for k in ("gate_proj", "up_proj", "down_proj")}
                nlp["mlp"]["shared_expert_gate"] = DenseLinear(
                    f16(lp["mlp"]["shared_expert_gate"].w))
        else:
            nlp["mlp"] = {k: qlin(exp[f"mlp.{k}"]) for k in ("gate_proj", "up_proj", "down_proj")}
        out["layers"].append(nlp)
    return out


class LineClock:
    """A stdout stand-in that keeps each printed line with its perf_counter."""

    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, text):
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)

    def flush(self):
        pass


def gptq_layers_check(tmp, dev):
    """experiments/baselines/gptq_baseline.main on a dense directory of
    Qwen3-0.6B's width (GPTQ_LAYERS layers, random f32 weights from a seeded
    torch.Generator, written in f16) over GPTQ_SAMPLES synthetic sequences
    of GPTQ_SEQLEN tokens. On those tokens each layer's output error (GPTQ
    student chain, quant_mode "xla") must be below RTN's on the same
    inputs; the written directory loads, and its prefill and greedy decode
    (K3, K1) give finite logits and tokens in the vocabulary."""
    import contextlib
    import dataclasses

    import torch

    from paroquant_tpu_torch.convert import load_checkpoint, quantize_model_rtn, save_paro_checkpoint
    from paroquant_tpu_torch.experiments.baselines import gptq_baseline
    from paroquant_tpu_torch.models import PRESETS, init_params
    from paroquant_tpu_torch.models.decoder import embed, layer_forward, rope_tables_per_layer
    from paroquant_tpu_torch.optim.data import get_mixed_calib_dataset

    cfg = dataclasses.replace(PRESETS["qwen3-0.6b"], num_hidden_layers=GPTQ_LAYERS)
    dense_dir, gptq_dir = tmp / "qwen3-0.6b-dense", tmp / "qwen3-0.6b-gptq"
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(24), torch.float32, dev)
    save_paro_checkpoint(dense_dir, params, cfg, [])  # every linear dense, in f16
    del params
    clock = LineClock()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        gptq_baseline.main(["--model", str(dense_dir), "--output", str(gptq_dir), "--datasets",
                            "synthetic", "--n-samples", str(GPTQ_SAMPLES), "--seqlen",
                            str(GPTQ_SEQLEN), "--device", dev.type])
    main_s = time.perf_counter() - t0
    stamps = [t0] + [t for t, line in clock.lines if line.startswith("gptq layer")]
    layer_s = [b - a for a, b in zip(stamps, stamps[1:])]

    dense, _ = load_checkpoint(dense_dir, dtype=torch.float32, device=dev)
    gptq, _ = load_checkpoint(gptq_dir, dtype=torch.float32, device=dev)
    rtn = quantize_model_rtn(dense, cfg, device=dev)
    tokens = get_mixed_calib_dataset(["synthetic"], None, GPTQ_SAMPLES, GPTQ_SEQLEN,
                                     vocab_size=cfg.vocab_size)
    rows = []
    with torch.no_grad():
        x = embed(dense, cfg, torch.from_numpy(tokens).to(dev))
        pos = torch.arange(GPTQ_SEQLEN, dtype=torch.int32, device=dev)[None].expand(
            GPTQ_SAMPLES, GPTQ_SEQLEN)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        for li, (cos, sin) in enumerate(rope_tables_per_layer(pos, cfg)):
            out = {name: layer_forward(p["layers"][li], x, cfg, li, cos, sin, pos, None, zero,
                                       "xla")[0] for name, p in (("dense", dense), ("gptq", gptq),
                                                                 ("rtn", rtn))}
            ref = out["dense"].norm()
            rows.append({"layer": li, "gptq_rel_err": ((out["gptq"] - out["dense"]).norm() / ref).item(),
                         "rtn_rel_err": ((out["rtn"] - out["dense"]).norm() / ref).item()})
            x = out["gptq"]  # the inputs GPTQ calibrated the next layer on
    del dense, rtn
    gq, _ = load_checkpoint(gptq_dir, device=dev)
    logits, toks = prefill_and_decode(gq, cfg, dev)
    row = {"phase": "gptq_check", "preset": "qwen3-0.6b", "layers": cfg.num_hidden_layers,
           "cut": f"depth {cfg.num_hidden_layers} of 28" if cfg.num_hidden_layers < 28 else None,
           "samples": GPTQ_SAMPLES, "seqlen": GPTQ_SEQLEN, "main_s": main_s,
           "layer_s_median": statistics.median(layer_s), "layer_s": layer_s,
           "worse_than_rtn": [r["layer"] for r in rows if r["gptq_rel_err"] >= r["rtn_rel_err"]],
           "rel_err": rows, "finite": bool(torch.isfinite(logits).all()),
           "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "card": card()}
    emit(row)
    if (len(layer_s) != cfg.num_hidden_layers or row["worse_than_rtn"] or not row["finite"]
            or not row["tokens_in_vocab"]):
        raise SystemExit(f"gptq: {row}")


def convert_paths(tmp, dev):
    """Conversion without calibration at Qwen3-0.6B's full width
    (28 layers, random bf16 weights from a seeded torch.Generator):
    rtn_export_model(hadamard=True) through save_paro_checkpoint and
    save_awq_checkpoint, each directory loaded with load_checkpoint to the
    logits and greedy tokens, bit for bit, of the model built in memory from
    the same exports rounded as the file rounds them (K3 and K1 on the
    unmerged layers); then `gptq_layers_check`. Counts reset just before and
    read just after: K1 and K3 must run. Returns the PARO-TPU directory."""
    import dataclasses

    import torch

    from paroquant_tpu_torch.convert import (load_checkpoint, rtn_export_model,
                                             save_awq_checkpoint, save_paro_checkpoint)
    from paroquant_tpu_torch.models import PRESETS, init_params

    cfg = PRESETS["qwen3-0.6b"]
    reset_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(23), torch.bfloat16, dev)
    t = time.perf_counter()
    exports = rtn_export_model(params, cfg, hadamard=True)
    timings = {"export_s": time.perf_counter() - t}
    dirs = {"paro": tmp / "qwen3-0.6b-paro", "awq": tmp / "qwen3-0.6b-awq"}
    for fmt, save in (("paro", save_paro_checkpoint), ("awq", save_awq_checkpoint)):
        t = time.perf_counter()
        save(dirs[fmt], params, cfg, exports)
        timings[f"save_{fmt}_s"] = time.perf_counter() - t
        t = time.perf_counter()
        loaded, lcfg = load_checkpoint(dirs[fmt], device=dev)
        timings[f"load_{fmt}_s"] = time.perf_counter() - t
        inmem = model_from_exports(params, exports, fmt, dev)
        (la, lt), (ma, mt) = prefill_and_decode(loaded, lcfg, dev), prefill_and_decode(inmem, cfg, dev)
        err = (la - ma).abs().max().item()
        row = {"phase": f"convert_{fmt}_check", "file_bytes": (dirs[fmt] / "model.safetensors").stat().st_size,
               "config_equal": dataclasses.replace(lcfg, quantization_items=None) == cfg,
               "quantization": lcfg.quantization, "max_abs_err": err, "bound": 0.0,
               "tokens_equal": torch.equal(lt, mt), "finite": bool(torch.isfinite(la).all())}
        emit(row)
        if err != 0.0 or not row["tokens_equal"] or not row["finite"] or not row["config_equal"]:
            raise SystemExit(f"convert: the {fmt} directory loads to another model: {row}")
        del loaded, inmem
    del params, exports
    torch.cuda.empty_cache()
    gptq_layers_check(tmp, dev)
    launched = port_launches()
    emit({"phase": "convert_paths_launches", **launched, **timings,
          "s": time.perf_counter() - t0})
    for kernel in ("rot_w4_matmul", "flash_attention"):
        if not launched["counts"].get(kernel):
            raise SystemExit(f"convert_paths: {kernel} did not run: {launched}")
    torch.cuda.empty_cache()
    return dirs["paro"]


CALIB_LAYERS = 2  # of Qwen3-0.6B's 28
CALIB_TOKENS = (4, 2, 256)  # batches, batch size, sequence length
CALIB_STAGES = (({"channel_scales": 5e-2, "angles": 5e-2}, 2), ({"weight": 1e-5, "quantizer": 1e-6}, 2))
# tests/test_torch_calibrate.py's small calibration, with stage 1 at 4
# epochs, where the first layer's rotations move off their start (at 2 no
# epoch beats the first validation loss, and both devices return the start)
SMALL_CALIB = dict(n_bits=4, group_size=64, num_rotations=6,
                   stages=(({"channel_scales": 5e-3, "angles": 5e-3}, 4),
                           ({"weight": 1e-5, "quantizer": 1e-6}, 2)))


def linear_exports(layer: dict) -> dict:
    """A layer's exports with the stacked experts' export split into one
    entry a projection in the linears' keys (q, theta, inv_channel_scales)."""
    out = {k: v for k, v in layer.items() if k != "mlp.experts"}
    if "mlp.experts" in layer:
        e = layer["mlp.experts"]
        for p, side in (("gate", "gate_up"), ("up", "gate_up"), ("down", "down")):
            out[f"mlp.experts.{p}"] = {"q": e[p]["q"], "theta": e[f"{side}_theta"],
                                       "inv_channel_scales": e[f"{side}_inv_channel_scales"]}
    return out


def calib_exports_close(a, b) -> dict:
    """The CPU tests' rule between two calibrations' exports: theta and the
    inverse channel scales within 2e-3, codes equal in at least 99.5%, never
    more than 1 apart (stacked experts: each projection)."""
    worst = {"theta": 0.0, "inv_channel_scales": 0.0, "codes_equal": 1.0, "max_code_diff": 0}
    for la, lb in zip(map(linear_exports, a), map(linear_exports, b)):
        for name in la:
            for k in ("theta", "inv_channel_scales"):
                d = abs(la[name][k] - lb[name][k]).max() / max(abs(la[name][k]).max(), 1.0)
                worst[k] = max(worst[k], float(d))
            qa, qb = la[name]["q"].astype("int64"), lb[name]["q"].astype("int64")
            worst["codes_equal"] = min(worst["codes_equal"], float((qa == qb).mean()))
            worst["max_code_diff"] = max(worst["max_code_diff"], int(abs(qa - qb).max()))
    worst["ok"] = (worst["theta"] <= 2e-3 and worst["inv_channel_scales"] <= 2e-3
                   and worst["codes_equal"] >= 0.995 and worst["max_code_diff"] <= 1)
    return worst


def small_calibration_inputs(preset, layers, prepare=None):
    """(cfg, params, tokens, test) of the small calibration check: a small
    preset's first `layers` layers, or those of a ModelConfig given as
    `preset` (f32 on the host, outlier input channels), 4 x 2 x 16
    calibration tokens and a 16-token test sequence. prepare(params, cfg,
    generator), where given, adjusts the random weights first."""
    import dataclasses

    import numpy as np
    import torch

    from paroquant_tpu_torch.experiments.baselines.quality_ladder import inject_outlier_channels
    from paroquant_tpu_torch.models import PRESETS, init_params

    base = PRESETS[preset] if isinstance(preset, str) else preset
    cfg = dataclasses.replace(base, num_hidden_layers=layers)
    params = init_params(cfg, 5, torch.float32, torch.device("cpu"))
    if prepare is not None:
        prepare(params, cfg, torch.Generator().manual_seed(5))
    params = inject_outlier_channels(params, cfg, scale=6.0, frac=0.03)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (4, 2, 16)).astype(np.int32)
    return cfg, params, tokens, torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)))


def small_calibration(cfg, params, tokens, test, calib, device):
    """The port's calibration of params on `device`: (exports, the
    calibrated model's f32 logits of `test`, on the host)."""
    import torch

    from paroquant_tpu_torch.models.decoder import model_forward
    from paroquant_tpu_torch.optim import CalibConfig, calibrate_model

    q, exps = calibrate_model(params, cfg, tokens, CalibConfig(**calib), device=device)
    with torch.no_grad():
        return exps, model_forward(q, cfg, test.to(device))[0].float().cpu()


def small_calibration_on_both(dev, preset="tiny", calib=SMALL_CALIB, layers=1,
                              prepare=None) -> None:
    """The port's calibration of `small_calibration_inputs` on the card
    against the same calibration on the host."""
    cfg, params, tokens, test = small_calibration_inputs(preset, layers, prepare)
    preset = preset if isinstance(preset, str) else cfg.model_type
    host_exps, host = small_calibration(cfg, params, tokens, test, calib, "cpu")
    card_exps, card_logits = small_calibration(cfg, params, tokens, test, calib, dev)
    worst = calib_exports_close(host_exps, card_exps)
    err = ((card_logits - host).abs().max() / host.abs().max()).item()
    moved = max(float(abs(e["theta"]).max()) for e in linear_exports(host_exps[0]).values())
    row = {"phase": "calibrate_card_vs_host", "preset": preset, "layers": layers,
           "hidden": cfg.hidden_size, "stages": [[g, e] for g, e in calib["stages"]], **worst,
           "logits_rel_max_err": err, "bound": 0.02, "host_theta_max": moved}
    emit(row)
    if not worst["ok"] or err > 0.02 or moved == 0.0:
        raise SystemExit(f"calibrate: the card's calibration left the CPU tests' tolerance: {row}")


def calibrate_paths(tmp, dev):
    """Calibration at Qwen3-0.6B's full width cut to CALIB_LAYERS layers
    (random f32 weights from a seeded torch.Generator, outlier input
    channels x6), the canonical two stages at 2 epochs each with GPTQ init
    over 4 x 2 x 256 synthetic tokens: a line per layer (seconds, each
    stage's validation loss before and after); every loss finite; the
    calibrated model's logits MSE to the dense model below RTN W4 g128's;
    `small_calibration_on_both`; the directory written with
    save_paro_checkpoint loads to the in-memory model's logits and tokens
    bit for bit, and its kernel path (quant_mode "auto", flash) lies within
    TOL_E2E of quant_mode "xla" with the einsum attention. Then the CLIs
    (cli.optimize with --save-checkpoint on a dense directory of the same
    width, cli.convert in its three outputs, each loaded and decoded) and
    bench_calibration --tokens 2048. Counts reset just before, read just
    after: K1 and K3 must run."""
    import dataclasses

    import numpy as np
    import torch

    from paroquant_tpu_torch.cli import convert as convert_cli, optimize as optimize_cli
    from paroquant_tpu_torch.convert import load_checkpoint, quantize_model_rtn, save_paro_checkpoint
    from paroquant_tpu_torch.experiments.baselines.quality_ladder import inject_outlier_channels
    from paroquant_tpu_torch.models import KVCache, PRESETS, init_params
    from paroquant_tpu_torch.models.decoder import model_forward
    from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
    from paroquant_tpu_torch.scripts import bench_calibration

    reset_counts()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(PRESETS["qwen3-0.6b"], num_hidden_layers=CALIB_LAYERS)
    params = inject_outlier_channels(
        init_params(cfg, torch.Generator(device=dev).manual_seed(24), torch.float32, dev), cfg,
        scale=6.0)
    rng = np.random.default_rng(24)
    tokens = rng.integers(0, cfg.vocab_size, CALIB_TOKENS).astype(np.int32)
    test = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))).to(dev)
    logs, layer_s, precisions = [], [], set()

    def _log(m, step):
        logs.append(m)
        precisions.add(torch.get_float32_matmul_precision())

    # the caller allows TF32; calibrate_model must run its matmuls at "highest"
    # all the same (read from inside, at every logged loss and every layer's end)
    caller_precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    tc = time.perf_counter()
    try:
        qparams, exports = calibrate_model(
            params, cfg, tokens, CalibConfig(stages=CALIB_STAGES, gptq_init=True), device=dev,
            progress_fn=lambda li, n, info: (layer_s.append(info["seconds"]),
                                             precisions.add(torch.get_float32_matmul_precision())),
            log_fn=_log)
    finally:
        torch.set_float32_matmul_precision(caller_precision)
    calib_s = time.perf_counter() - tc
    for li, s_ in enumerate(layer_s):
        stages = []
        for si in range(len(CALIB_STAGES)):
            vals = [m["val_loss"] for m in logs if m["layer"] == li and m["stage"] == si
                    and "val_loss" in m]
            best = [m["best_val_loss"] for m in logs if m["layer"] == li and m["stage"] == si
                    and "best_val_loss" in m]
            stages.append({"stage": si, "val_before": vals[0], "val_after": best[-1],
                           "epochs_logged": len(vals) - 1})
        emit({"phase": "calibrate_layer", "layer": li, "s": s_, "stages": stages})
    losses = [v for m in logs for k, v in m.items() if k.endswith("loss")]
    with torch.no_grad():
        fp = model_forward(params, cfg, test)[0]
        cal = model_forward(qparams, cfg, test)[0]
        rtn = model_forward(quantize_model_rtn(params, cfg, device=dev), cfg, test)[0]
    e_cal, e_rtn = torch.mean((cal - fp) ** 2).item(), torch.mean((rtn - fp) ** 2).item()
    row = {"phase": "calibrate_check", "preset": "qwen3-0.6b", "layers": CALIB_LAYERS,
           "cut": f"depth {CALIB_LAYERS} of 28", "tokens": list(CALIB_TOKENS),
           "stages": [[g, e] for g, e in CALIB_STAGES], "gptq_init": True,
           "s": calib_s, "s_per_layer": layer_s, "losses_logged": len(losses),
           "losses_finite": all(np.isfinite(losses)), "logits_mse_calibrated": e_cal,
           "logits_mse_rtn_w4g128": e_rtn, "matmul_precision_inside": sorted(precisions),
           "card": card()}
    emit(row)
    if (not row["losses_finite"] or not losses or not e_cal < e_rtn
            or row["matmul_precision_inside"] != ["highest"]):
        raise SystemExit(f"calibrate: {row}")
    del qparams
    small_calibration_on_both(dev)

    # the written directory against the in-memory model built from the same exports
    calib_dir = tmp / "qwen3-0.6b-calibrated"
    save_paro_checkpoint(calib_dir, params, cfg, exports)
    loaded, lcfg = load_checkpoint(calib_dir, device=dev)
    (la, lt), (ma, mt) = (prefill_and_decode(loaded, lcfg, dev),
                          prefill_and_decode(model_from_exports(params, exports, "paro", dev), cfg, dev))
    with torch.no_grad():
        ker = model_forward(loaded, lcfg, test.to(torch.int32), KVCache.create(
            lcfg, 1, 512, torch.bfloat16, dev), quant_mode="auto", attn_mode="flash")[0].float()
        ref = model_forward(loaded, lcfg, test.to(torch.int32), KVCache.create(
            lcfg, 1, 512, torch.bfloat16, dev), quant_mode="xla", attn_mode="einsum")[0].float()
    rel = ((ker - ref).norm() / ref.norm()).item()
    row = {"phase": "calibrate_dir_check", "max_abs_err": (la - ma).abs().max().item(),
           "bound": 0.0, "tokens_equal": torch.equal(lt, mt), "finite": bool(torch.isfinite(la).all()),
           "kernel_vs_xla_rel_fro_err": rel, "e2e_bound": TOL_E2E}
    emit(row)
    if row["max_abs_err"] != 0.0 or not row["tokens_equal"] or not row["finite"] or rel > TOL_E2E:
        raise SystemExit(f"calibrate: the calibrated directory: {row}")
    del loaded, params, exports
    torch.cuda.empty_cache()

    # the CLIs, then the bench, at cut sizes
    dense_dir, out_dir = tmp / "calib-dense", tmp / "calib-cli"
    dense = init_params(cfg, torch.Generator(device=dev).manual_seed(25), torch.float32, dev)
    save_paro_checkpoint(dense_dir, dense, cfg, [])
    del dense
    t = time.perf_counter()
    optimize_cli.main(["--model", str(dense_dir), "--output", str(out_dir), "--datasets",
                       "synthetic", "--train-size", "8", "--batch-size", "2", "--seqlen", "256",
                       "--epochs", "1", "1", "--save-checkpoint", "--device", dev.type])
    cli_s = {"optimize_s": time.perf_counter() - t}
    outs = {"optimize": out_dir / "model"}
    for mode, fmt in (("real", "paro-tpu"), ("real", "awq"), ("pseudo", "paro-tpu")):
        name = f"{mode}-{fmt}"
        t = time.perf_counter()
        convert_cli.main(["--model", str(dense_dir), "--results", str(out_dir), "--output",
                          str(tmp / f"calib-{name}"), "--mode", mode, "--format", fmt,
                          "--device", dev.type])
        cli_s[f"convert_{name}_s"] = time.perf_counter() - t
        outs[name] = tmp / f"calib-{name}"
    loaded_rows = []
    for name, d in outs.items():
        m, mc = load_checkpoint(d, device=dev)
        logits, toks = prefill_and_decode(m, mc, dev)
        loaded_rows.append({"output": name, "quantized": mc.quantization is not None,
                            "finite": bool(torch.isfinite(logits).all()),
                            "tokens_in_vocab": bool(((toks >= 0) & (toks < mc.vocab_size)).all())})
        del m
    row = {"phase": "calibrate_cli_check", **cli_s, "outputs": loaded_rows}
    emit(row)
    if (not all(r["finite"] and r["tokens_in_vocab"] for r in loaded_rows)
            or [r["quantized"] for r in loaded_rows] != [True, True, True, False]):
        raise SystemExit(f"calibrate: the CLIs' outputs: {row}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    bench = bench_calibration.main(["--tokens", "2048", "--device", dev.type])
    bench_s = time.perf_counter() - t
    if not all(np.isfinite([bench["value"], bench["est_full_recipe_hours_36L_4M_tokens"]])):
        raise SystemExit(f"calibrate: bench_calibration: {bench}")
    launched = port_launches()
    emit({"phase": "calibrate_paths_launches", **launched, "bench_calibration_s": bench_s,
          "s": time.perf_counter() - t0})
    for kernel in ("rot_w4_matmul", "flash_attention"):
        if not launched["counts"].get(kernel):
            raise SystemExit(f"calibrate_paths: {kernel} did not run: {launched}")
    torch.cuda.empty_cache()


# Qwen3-30B-A3B's published widths (config.json of Qwen/Qwen3-30B-A3B on the
# Hugging Face hub), with random weights from seeds
QWEN3_30B_A3B = dict(model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
                     intermediate_size=6144, num_hidden_layers=48, num_attention_heads=32,
                     num_key_value_heads=4, head_dim=128, num_experts=128, num_experts_per_tok=8,
                     moe_intermediate_size=768, norm_topk_prob=True, decoder_sparse_step=1,
                     mlp_only_layers=[], rope_theta=1e6, rms_norm_eps=1e-6,
                     tie_word_embeddings=False)
MOE_LAYERS = 6  # the served model's depth: 6 of Qwen3-30B-A3B's 48, to leave room for the later phases
MOE_CKPT_LAYERS = 2  # the checkpoints' depth
MOE_PROMPTS = (16, 128, 256, 512)  # the Generator's requests, MOE_NEW_TOKENS each
MOE_NEW_TOKENS = 32
MOE_GPTQ_TOKENS = (4, 512)  # sequences x tokens
# the 1-layer calibration of tiny-moe, card against host (stage 1 at
# tests/test_torch_pseudo_moe.py's LR, one epoch a stage)
MOE_CALIB = dict(n_bits=4, group_size=64, num_rotations=4,
                 stages=(({"channel_scales": 5e-3, "angles": 5e-3}, 1),
                         ({"weight": 1e-5, "quantizer": 1e-6}, 1)))


def moe_config(layers):
    from paroquant_tpu_torch.models import from_hf_dict

    return from_hf_dict(dict(QWEN3_30B_A3B, num_hidden_layers=layers))


def moe_model(dev, layers):
    """Qwen3-30B-A3B at full width, built layer by layer on the card from a
    seeded torch.Generator: random bf16 weights, Hadamard RTN W4 g128 of the
    attention (the 128 experts through quantize_experts_rtn, identity
    rotations; the router dense), a W4 lm_head, merged projections. Emits
    the build's seconds, peak bytes and the model's bytes."""
    import dataclasses

    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.models import init_params, merge_projections
    from paroquant_tpu_torch.models.decoder import _init_layer

    cfg = moe_config(layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(30)
    outer = dataclasses.replace(cfg, num_hidden_layers=0)
    qparams = quantize_model_rtn(init_params(outer, gen, torch.bfloat16, dev), outer,
                                 hadamard=True, quantize_lm_head=True, device=dev)
    layers_q = []
    for i in range(cfg.num_hidden_layers):
        lp = _init_layer(cfg, gen, i, torch.bfloat16, dev)
        layers_q.append(quantize_model_rtn({"layers": [lp]}, cfg, hadamard=True,
                                           device=dev)["layers"][0])
        del lp
    qparams["layers"] = layers_q
    qparams = merge_projections(qparams, cfg)
    torch.cuda.synchronize()
    emit({"phase": "moe_model", "config": "Qwen3-30B-A3B", "layers": cfg.num_hidden_layers,
          "cut": None if layers == 48 else f"depth {layers} of 48",
          "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
          "build_s": time.perf_counter() - t0,
          "model_bytes": torch.cuda.memory_allocated(dev) - base,
          "peak_bytes": torch.cuda.max_memory_allocated(dev) - base})
    return qparams, cfg


def moe_generator(qparams, cfg, dev):
    """The Generator (quant_mode "auto", flash) over MOE_PROMPTS, greedy, with
    its tok/s and ms a step; the decode step under sync debug mode "error";
    profile_decode's busy ms, idle share and launches a step; then the
    teacher-forced logits (prefill of 256 + 8 steps) of the kernel path
    against quant_mode "xla" with the einsum attention, within TOL_E2E."""
    import torch

    from paroquant_tpu_torch.serve import Generator, SamplingParams
    from paroquant_tpu_torch.utils.profiling import profile_decode

    gen = Generator(qparams, cfg, max_len=1024, quant_mode="auto", attn_mode="flash", device=dev)
    g = torch.Generator().manual_seed(41)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in MOE_PROMPTS]
    gen.generate(prompts[0], SamplingParams(max_tokens=4, temperature=0.0))  # warm-up
    results = []
    for p in prompts:
        torch.cuda.synchronize()
        res = gen.generate(p, SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=0.0))
        toks = res.token_ids
        ok = len(toks) == MOE_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in toks)
        emit({"phase": "moe_request", "prompt_tokens": len(p), "new_tokens": len(toks),
              "prefill_ms": res.stats.ttft * 1e3, "decode_tok_s": res.stats.tokens_per_second,
              "decode_ms_per_step": 1e3 / res.stats.tokens_per_second, "ok": ok,
              "first_tokens": toks[:8]})
        if not ok:
            raise SystemExit(f"moe: a {len(p)}-token prompt returned {len(toks)} tokens")
        results.append(res)
    check_decode_has_no_sync({"qwen3-30b-a3b": (qparams, cfg)}, dev)
    prof = profile_decode(qparams, cfg, prompt_len=256, steps=4, device=dev)
    emit({"phase": "moe_decode_profile", "prompt_tokens": 256, "quant_mode": "auto",
          "card": card(), **prof})
    tokens = torch.tensor([prompts[2] + results[2].token_ids[:8]], dtype=torch.int32, device=dev)
    moe_logits_check(qparams, cfg, tokens, len(prompts[2]), dev)


def pinned_runs(ref, kern, *pinned_only):
    """ref() and kern() each compute logits through the MoE blocks; ref runs
    once with each `moe_apply` call's routing (ids and gates) recorded, kern
    runs free (its own routing) and pinned (given ref's routing, in call
    order). Returns (ref logits, free, pinned, routed rows whose expert set
    differs between ref and the free run, routed rows), then the logits of
    each further function of `pinned_only`, run pinned to ref's routing."""
    from paroquant_tpu_torch.ops import moe as moe_ops

    plain = moe_ops.moe_apply
    routes, replay = [], []

    def routed(experts, x, idx, gates, *a, **k):
        if replay:
            idx, gates = replay.pop(0)
        else:
            routes.append((idx.clone(), gates.clone()))
        return plain(experts, x, idx, gates, *a, **k)

    moe_ops.moe_apply = routed
    try:
        ref_logits = ref()
        ref_routes, routes = routes, []
        free = kern()
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for (a, _), (b, _) in zip(ref_routes, routes))
        others = []
        for fn in (kern, *pinned_only):
            replay[:] = ref_routes
            others.append(fn())
            if replay:
                raise SystemExit(f"{len(replay)} recorded routings were not replayed")
    finally:
        moe_ops.moe_apply = plain
    return (ref_logits, free, others[0], flips, sum(a.shape[0] for a, _ in ref_routes),
            *others[1:])


def logits_rows(phase, ref, free, pinned, flips, rows, n_steps, cfg, **extra):
    """The line of a pinned logits check: each row's relative Frobenius error
    (pinned, and free beside it); raises past TOL_E2E or on a bad shape."""
    import torch

    def rel(x):
        return ((x - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()

    finite = bool(torch.isfinite(pinned).all() and torch.isfinite(free).all()
                  and torch.isfinite(ref).all())
    agree = sum(int(a) == int(b) for a, b in zip(pinned.argmax(-1), ref.argmax(-1)))
    row = {"phase": phase, **extra, "rel_fro_err": rel(pinned), "bound": TOL_E2E,
           "free_rel_fro_err": rel(free), "free_routed_rows_flipped": flips, "routed_rows": rows,
           "finite": finite, "argmax_agree": agree, "steps": pinned.shape[0],
           "shape": list(pinned.shape)}
    emit(row)
    if (not finite or max(row["rel_fro_err"]) > TOL_E2E
            or pinned.shape != (n_steps, cfg.vocab_size)):
        raise SystemExit(f"{phase}: kernel-path logits disagree with the reference path")
    return row


def moe_logits_check(qparams, cfg, tokens, n, dev, phase="moe_logits_check"):
    """The kernel path's teacher-forced logits (a prefill of n tokens, then
    a decode step a token) against quant_mode "xla" with the einsum
    attention. An expert choice is a discontinuous function of the router's
    inputs, so where the two paths' hidden states differ in their last bits
    a token near a routing tie takes another expert in one path only, and
    the change flows through the later layers. So the kernel path runs
    twice: free (its own routing; its error and the share of routed rows
    whose expert set differs from the reference's are recorded) and pinned
    to the reference's routing (each MoE block given the reference's expert
    choices and gates, in call order), which holds the kernels' numerics:
    the pinned error must stay within TOL_E2E."""
    runs = pinned_runs(lambda: teacher_forced(qparams, cfg, tokens, n, "xla", "einsum", dev),
                       lambda: teacher_forced(qparams, cfg, tokens, n, "auto", "flash", dev))
    logits_rows(phase, *runs, tokens.shape[1] - n + 1, cfg,
                routing="pinned to the reference's")


def plain_kernels(perturb=0.0):
    """A context in which K1, K2 and K3's wrappers run their plain versions
    on the card (`rot_w4_matmul_plain`, `merged_rot_w4_matmul_plain`,
    `flash_attention_plain`): the kernel path's own computation, every
    choice of `auto` (W4A8 for the large matrices at M <= 16, the one
    launch for the others, the M cut) and of the flash gate kept, with each
    kernel replaced by its plain version. perturb > 0 multiplies each K1/K2
    input by (1 + perturb * N(0, 1)) first: the plain path's sensitivity
    to f32 rounding noise."""
    import contextlib

    import torch

    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm

    def noisy(fn):
        if not perturb:
            return fn
        return lambda x, *a, **k: fn(x * (1 + perturb * torch.randn_like(x)), *a, **k)

    @contextlib.contextmanager
    def ctx():
        swaps = [(rm, "rot_w4_matmul", noisy(rm.rot_w4_matmul_plain)),
                 (rm, "merged_rot_w4_matmul", noisy(rm.merged_rot_w4_matmul_plain)),
                 (at, "flash_attention", at.flash_attention_plain)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        try:
            for mod, name, fn in swaps:
                setattr(mod, name, fn)
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return ctx()


def first_layers(qparams, cfg, n):
    """The model's first n layers with its embedding, final norm and lm_head."""
    import dataclasses

    return ({**qparams, "layers": qparams["layers"][:n]},
            dataclasses.replace(cfg, num_hidden_layers=n, layer_types=cfg.layer_types[:n]))


HYBRID_NOISE = 1e-7  # relative noise on K1/K2's inputs: the size of an f32 rounding


def hybrid_logits_check(qparams, cfg, tokens, n, dev):
    """The hybrid's teacher-forced logits (a prefill of n tokens, then a
    decode step a token), routing pinned as in `moe_logits_check`: the
    kernel path ("auto", flash: K1/K2 on RA8 for the large matrices at
    decode, the one launch for the others, K3 over f32 queries) against the
    same computation with each kernel replaced by its plain version
    (`plain_kernels`). Held within TOL_E2E on the served model's first
    HYBRID_CHECK_LAYERS layers (3 delta-net layers and a full-attention
    one: every kernel of the path); recorded at all HYBRID_LAYERS. Beside each,
    the noise floor: the plain path against itself with every K1/K2 input
    perturbed by HYBRID_NOISE relative. W4A8 rounds each large matrix's
    activations to int8 at decode, so noise at the size of an f32 rounding
    flips some int8 values and moves a random hybrid's decode logits by
    percents; the floor grows with the depth, and the kernel path, whose
    f32 sums are ordered apart from the plain version's, sits at it.
    Recorded, not held: the kernel path against quant_mode "xla" with the
    einsum attention, free (W4A16 against W4A8, and the routing flips)."""
    def check(params, config, phase, hold):
        def tf():
            return teacher_forced(params, config, tokens, n, "auto", "flash", dev)

        def plain_ref(perturb=0.0):
            with plain_kernels(perturb):
                return tf()

        ref, free, pinned, flips, rows, noisy = pinned_runs(
            plain_ref, tf, lambda: plain_ref(HYBRID_NOISE))

        def rel(x):
            return ((x - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()

        extra = dict(layers=config.num_hidden_layers, held=hold, kernel_path="auto, flash",
                     reference="the same with each kernel's plain version",
                     routing="pinned to the reference's", noise_floor_rel_fro_err=rel(noisy),
                     noise=HYBRID_NOISE)
        if hold:
            logits_rows(phase, ref, free, pinned, flips, rows, tokens.shape[1] - n + 1, config,
                        **extra)
        else:
            emit({"phase": phase, **extra, "rel_fro_err": rel(pinned), "free_rel_fro_err": rel(free),
                  "free_routed_rows_flipped": flips, "routed_rows": rows})
        return free

    check(*first_layers(qparams, cfg, HYBRID_CHECK_LAYERS), "hybrid_logits_check", True)
    auto = check(qparams, cfg, "hybrid_logits_all_layers", False)
    xla = teacher_forced(qparams, cfg, tokens, n, "xla", "einsum", dev)
    emit({"phase": "hybrid_logits_auto_vs_xla", "layers": cfg.num_hidden_layers, "held": False,
          "routing": "free",
          "rel_fro_err": ((auto - xla).norm(dim=-1) / xla.norm(dim=-1)).tolist()})


class RoutingLog:
    """Records and replays the MoE blocks' routing by (request, position,
    layer). While installed, `ops.moe.moe_apply` is wrapped: `keys` names
    each row of the current forward (a (request, position) pair, or None
    for padding and idle slots) and `layer` counts the forward's MoE calls.
    Recording keeps each row's expert ids and gates (the last computation
    of a position wins, as it wrote the position's KV); replay hands each
    keyed row the recorded routing where there is one. The Engine's forwards
    are keyed by wrapping its model_forward (prefill: the request whose
    prompt holds the chunk at the cache's offset), paged_decode_step (slot
    b at seq_lens[b]) and paged_verify_step (slot b at seq_lens[b] + w);
    the rows of idle slots and of slots still prefilling are not keyed."""

    def __init__(self, eng, prompts):
        self.eng, self.prompts = eng, prompts
        self.keys, self.layer, self.replay = None, 0, None
        self.log, self.saved = {}, []

    def _apply(self, experts, x, idx, gates, *a, **k):
        keys, layer = self.keys, self.layer
        self.layer += 1
        if keys is not None:
            if self.replay is not None:
                import torch

                i_h, g_h = idx.cpu().numpy().copy(), gates.float().cpu().numpy().copy()
                for r, key in enumerate(keys):
                    got = self.replay.get((*key, layer)) if key else None
                    if got is not None:
                        i_h[r], g_h[r] = got
                idx = torch.from_numpy(i_h).to(idx.device)
                gates = torch.from_numpy(g_h).to(gates.device, gates.dtype)
            else:
                i_h, g_h = idx.cpu().numpy(), gates.float().cpu().numpy()
                for r, key in enumerate(keys):
                    if key:
                        self.log[(*key, layer)] = (i_h[r].copy(), g_h[r].copy())
        return self.plain(experts, x, idx, gates, *a, **k)

    def _keyed(self, fn, keys_of):
        def call(*args, **kw):
            self.keys, self.layer = keys_of(*args, **kw), 0
            try:
                return fn(*args, **kw)
            finally:
                self.keys = None
        return call

    def _prefill_keys(self, params, config, tokens, cache=None, **kw):
        toks = tokens.cpu().numpy()[0].tolist()
        off = 0 if cache is None else int(cache.length)
        for rid, p in enumerate(self.prompts):
            n = min(len(toks), len(p) - off)
            if n > 0 and p[off:off + n] == toks[:n]:
                return [(rid, off + t) if off + t < len(p) else None for t in range(len(toks))]
        return None

    def _slot_keys(self, width):
        def keys_of(params, config, tokens, seq_lens, *args, **kw):
            rid = {id(r): i for i, r in enumerate(self.requests)}
            lens = seq_lens.cpu().tolist()
            out = []
            for b, slot in enumerate(self.eng.slots):
                # a slot still prefilling computes a garbage row at length 0
                r = None if slot.prefilling else rid.get(id(slot.request))
                out += [None if r is None else (r, lens[b] + w) for w in range(width(tokens))]
            return out
        return keys_of

    def install(self, requests):
        from paroquant_tpu_torch.ops import moe as moe_ops
        from paroquant_tpu_torch.serve import engine as engine_mod

        self.requests = requests
        self.plain = moe_ops.moe_apply
        self.forward = engine_mod.model_forward
        self.saved = [(moe_ops, "moe_apply", moe_ops.moe_apply)] + [
            (engine_mod, n, getattr(engine_mod, n))
            for n in ("model_forward", "paged_decode_step", "paged_verify_step")]
        moe_ops.moe_apply = self._apply
        engine_mod.model_forward = self._keyed(self.forward, self._prefill_keys)
        engine_mod.paged_decode_step = self._keyed(engine_mod.paged_decode_step,
                                                   self._slot_keys(lambda t: 1))
        engine_mod.paged_verify_step = self._keyed(engine_mod.paged_verify_step,
                                                   self._slot_keys(lambda t: t.shape[1]))

    def uninstall(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        self.saved = []

    def score(self, rid, seq, replay):
        """eng.score_sync(seq) of request rid's sequence, its rows keyed, with
        the recorded routing replayed or not; returns (scores, its routing)."""
        from paroquant_tpu_torch.serve import engine as engine_mod

        n = len(seq)
        self.replay = self.log if replay else None
        own, self.log = self.log, {}
        engine_mod.model_forward = self._keyed(
            self.forward, lambda *a, **k: [(rid, t) if t < n else None
                                           for t in range(a[2].shape[1])])
        try:
            scores = self.eng.score_sync(seq)
        finally:
            engine_mod.model_forward = self._keyed(self.forward, self._prefill_keys)
            self.replay, routing, self.log = None, self.log, own
        return scores, routing


def moe_engine(qparams, cfg, dev, spec_k=4, phase="moe_serve", score=True, quant_mode="auto"):
    """The Engine (8 slots, pages of 128, chunked prefill, prompt-lookup
    speculation k 4, bf16 pool, quant_mode "auto") over eight greedy
    requests of 16-512 prompt tokens (three of them repeated blocks, so that
    drafts are found): every request returns its tokens. With spec_k 0 (the
    hybrid, which JAX keeps off speculation) no speculative window is run;
    with score=False the requests are served and their tokens checked only.
    quant_mode is the Engine's (and so score_sync's). Each one's
    logprobs against one contiguous prefill of its sequence
    (Engine.score_sync): free, and with the prefill's routing pinned to the
    Engine's (`RoutingLog`), which must lie within TOL_LOGPROB (routing
    flips between the two computations are recorded, not held; see
    `moe_logits_check`); a wrong context (the first half of the longest
    prompt replaced) must move the scores by more than TOL_LOGPROB on
    average. A decode step of 8 slots takes the experts' gather path (8 x
    top 8 = 64), a verify window of 8 x 5 rows the ragged one."""
    import numpy as np
    import torch

    from paroquant_tpu_torch.serve import Engine, SamplingParams

    eng = Engine(qparams, cfg, max_batch=8, max_len=1024, page_size=128, prefill_chunk=256,
                 quant_mode=quant_mode, decode_burst=8, spec_k=spec_k, device=dev)
    g = torch.Generator().manual_seed(42)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    prompts = [rand(16), rand(24) * 8, rand(100), rand(512), rand(16) * 12, rand(300),
               rand(32) * 10, rand(64)]
    sp = SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=0.0)
    eng.generate_sync(rand(40), SamplingParams(max_tokens=4, temperature=0.0))  # warm-up
    for key in eng.metrics:
        eng.metrics[key] = 0
    eng._ttfts.clear()
    eng._step_samples.clear()
    log = RoutingLog(eng, prompts)
    log.install(reqs := [])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs += [eng.submit(p, sp) for p in prompts]
        ticks = 0
        while eng.step():
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        emit({"phase": phase, "requests": len(prompts), "wall_s": wall, "ticks": ticks,
              "generated_tok_s": eng.metrics["tokens_generated"] / wall,
              "timing": "routing recorded (a host copy of each MoE block's routing)",
              "metrics": eng.metrics, "ttft": eng.ttft_stats(), "step_time": eng.step_time_stats()})
        outs = []
        for r, p in zip(reqs, prompts):
            toks = []
            while not r.out_queue.empty():
                kind, t = r.out_queue.get_nowait()
                if kind == "token":
                    toks.append(t)
            if len(toks) != MOE_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
                raise SystemExit(f"{phase}: a {len(p)}-token prompt returned {len(toks)} tokens")
            outs.append(toks)
        if spec_k and eng.metrics["spec_windows"] <= 0:
            raise SystemExit(f"{phase}: no speculative window: {eng.metrics}")
        if not score:
            return
        free, pinned, flips, scored = [], [], 0, 0
        for rid, (r, p, toks) in enumerate(zip(reqs, prompts, outs)):
            seq = p + toks
            ref_free, routing = log.score(rid, seq, replay=False)
            ref_pin, _ = log.score(rid, seq, replay=True)
            free.append(max(abs(a - b) for a, b in zip(r.logprobs, ref_free[len(p):])))
            pinned.append(max(abs(a - b) for a, b in zip(r.logprobs, ref_pin[len(p):])))
            for key, (i_e, _) in log.log.items():
                if key[0] == rid and key in routing:
                    scored += 1
                    flips += int(not np.array_equal(np.sort(i_e), np.sort(routing[key][0])))
    finally:
        log.uninstall()
    _, p, toks = max(zip(reqs, prompts, outs), key=lambda t: len(t[1]))
    half = len(p) // 2
    wrong = torch.randint(0, cfg.vocab_size, (half,), generator=torch.Generator().manual_seed(13))
    ref = eng.score_sync(p + toks)[len(p):]
    moved = eng.score_sync(wrong.tolist() + p[half:] + toks)[len(p):]
    context_move = statistics.mean(abs(a - b) for a, b in zip(ref, moved))
    row = {"phase": f"{phase}_logprob_check", "layers": cfg.num_hidden_layers,
           "quant_mode": quant_mode,
           "requests": len(prompts),
           "worst_gap": max(pinned), "gaps": pinned, "routing": "pinned to the Engine's",
           "free_worst_gap": max(free), "free_gaps": free, "bound": TOL_LOGPROB,
           "routed_rows_flipped": flips, "routed_rows": scored,
           "wrong_context_mean_move": context_move}
    emit(row)
    if max(pinned) > TOL_LOGPROB or context_move <= TOL_LOGPROB or not scored:
        raise SystemExit(f"{phase}: engine logprobs off the contiguous prefill's: {row}")
    del eng
    torch.cuda.empty_cache()


def moe_checkpoints(tmp, dev):
    """Qwen3-30B-A3B at MOE_CKPT_LAYERS layers (random bf16 weights): the
    attention's Hadamard RTN exports and the experts' export of pseudo
    experts with random shared rotations (`export_quantized_moe`), written
    as a PARO-TPU directory (stacked experts) and an AWQ one (per-expert
    buffers); each loads to the logits and greedy tokens, bit for bit, of
    the model built in memory from the same exports rounded as the file
    rounds them."""
    import dataclasses

    import torch

    from paroquant_tpu_torch.convert import (load_checkpoint, rtn_export_model,
                                             save_awq_checkpoint, save_paro_checkpoint)
    from paroquant_tpu_torch.models import init_params
    from paroquant_tpu_torch.ops import rotation as rot_ops
    from paroquant_tpu_torch.optim.pseudo_moe import export_quantized_moe, make_pseudo_moe

    cfg = moe_config(MOE_CKPT_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(31), torch.bfloat16, dev)
    exports = rtn_export_model(params, cfg, hadamard=True)
    g = torch.Generator(device=dev).manual_seed(32)
    for li, lp in enumerate(params["layers"]):
        ex = lp["mlp"]["experts"]
        H, I = ex["gate_proj"].shape[1:]
        pm = make_pseudo_moe(ex, rot_ops.make_rotation_params(H, 128, 8, li),
                             rot_ops.make_rotation_params(I, 128, 8, li + 1000))
        with torch.no_grad():
            for side in ("gate_up", "down"):
                th = getattr(pm, f"{side}_theta")
                th.copy_(0.1 * torch.randn(th.shape, generator=g, device=dev))
        exports[li]["mlp.experts"] = export_quantized_moe(pm)
        del pm
    timings = {"export_s": time.perf_counter() - t0}
    for fmt, save in (("paro", save_paro_checkpoint), ("awq", save_awq_checkpoint)):
        d = tmp / f"qwen3-30b-a3b-{fmt}"
        t = time.perf_counter()
        save(d, params, cfg, exports)
        timings[f"save_{fmt}_s"] = time.perf_counter() - t
        t = time.perf_counter()
        loaded, lcfg = load_checkpoint(d, device=dev)
        timings[f"load_{fmt}_s"] = time.perf_counter() - t
        inmem = model_from_exports(params, exports, fmt, dev)
        (la, lt), (ma, mt) = prefill_and_decode(loaded, lcfg, dev), prefill_and_decode(inmem, cfg, dev)
        row = {"phase": f"moe_{fmt}_check", "layers": MOE_CKPT_LAYERS,
               "file_bytes": (d / "model.safetensors").stat().st_size,
               "config_equal": dataclasses.replace(lcfg, quantization_items=None) == cfg,
               "experts_type": type(loaded["layers"][0]["mlp"]["experts"]).__name__,
               "max_abs_err": (la - ma).abs().max().item(), "bound": 0.0,
               "tokens_equal": torch.equal(lt, mt), "finite": bool(torch.isfinite(la).all())}
        emit(row)
        if (row["max_abs_err"] != 0.0 or not row["tokens_equal"] or not row["finite"]
                or not row["config_equal"] or row["experts_type"] != "QuantizedMoEExperts"):
            raise SystemExit(f"moe: the {fmt} directory loads to another model: {row}")
        del loaded, inmem
        torch.cuda.empty_cache()
    emit({"phase": "moe_checkpoint_seconds", **timings})
    del params, exports
    torch.cuda.empty_cache()


def moe_gptq(dev):
    """gptq_quantize_model on one Qwen3-30B-A3B layer at full width (random
    bf16 weights) over MOE_GPTQ_TOKENS synthetic tokens: its seconds, and
    each projection's output error on those tokens, tr(D^T H D) with D the
    weight's error and H its input's Hessian (the experts': summed over
    experts, the shared Hessian GPTQ uses), below RTN's."""
    import numpy as np
    import torch

    from paroquant_tpu_torch.convert.gptq import _tap_hessians, gptq_quantize_model
    from paroquant_tpu_torch.convert.rtn import quantize_experts_rtn, quantize_linear_rtn
    from paroquant_tpu_torch.models import init_params
    from paroquant_tpu_torch.models.decoder import embed, rope_tables_per_layer
    from paroquant_tpu_torch.ops.moe import _dequant_stacked
    from paroquant_tpu_torch.ops.qlinear import effective_weight

    cfg = moe_config(1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(33), torch.bfloat16, dev)
    N, T = MOE_GPTQ_TOKENS
    tokens = np.random.default_rng(33).integers(0, cfg.vocab_size, (N, T)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp, exports = gptq_quantize_model(params, cfg, tokens, batch_size=N, device=dev)
    torch.cuda.synchronize()
    gptq_s = time.perf_counter() - t0
    lp, qlp = params["layers"][0], qp["layers"][0]
    with torch.no_grad():
        x = embed(params, cfg, torch.from_numpy(tokens).to(dev))
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(N, T)
        cos, sin = rope_tables_per_layer(pos, cfg)[0]
        _, hs = _tap_hessians(lp, x, cfg, 0, cos, sin, pos)

        def err(w, we, h):  # w, we [..., I, O]: sum of (w - we)^T H (w - we)'s trace
            d = (we - w.to(torch.float32))
            return float(((h @ d) * d).sum())

        def experts_eff(q):  # the shared rotation applied back: M^T per group
            outs = []
            for p, rot in (("gate", q.gate_up_rot), ("up", q.gate_up_rot), ("down", q.down_rot)):
                wd = _dequant_stacked(getattr(q, f"{p}_qweight"), getattr(q, f"{p}_scales"),
                                      getattr(q, f"{p}_zeros"), q.group_size)
                E, I, O = wd.shape
                G, S, _ = rot.shape
                outs.append(torch.einsum("gji,egjo->egio", rot.to(torch.float32),
                                         wd.reshape(E, G, S, O)).reshape(E, I, O))
            return outs

        rows = []
        for name, tap in (("q_proj", "qkv"), ("k_proj", "qkv"), ("v_proj", "qkv"), ("o_proj", "o")):
            rtn = quantize_linear_rtn(lp[name])
            rows.append({"projection": name,
                         "gptq": err(lp[name].w, effective_weight(qlp[name]), hs[tap]),
                         "rtn": err(lp[name].w, effective_weight(rtn), hs[tap])})
        ex = lp["mlp"]["experts"]
        got = experts_eff(qlp["mlp"]["experts"])
        ref = experts_eff(quantize_experts_rtn(ex))
        for (p, tap), g_, r_ in zip((("gate_proj", "mlp"), ("up_proj", "mlp"),
                                     ("down_proj", "moe_down")), got, ref):
            rows.append({"projection": f"experts.{p}", "gptq": err(ex[p], g_, hs[tap]),
                         "rtn": err(ex[p], r_, hs[tap])})
    worse = [r["projection"] for r in rows if not r["gptq"] < r["rtn"]]
    row = {"phase": "moe_gptq_check", "layers": 1, "tokens": [N, T], "s": gptq_s,
           "exported": sorted(exports[0]), "errors": rows, "worse_than_rtn": worse,
           "card": card()}
    emit(row)
    if worse or "mlp.experts" not in exports[0]:
        raise SystemExit(f"moe: GPTQ {row}")
    del params, qp, exports, hs
    torch.cuda.empty_cache()


def moe_paths(tmp, dev):
    """The MoE family at Qwen3-30B-A3B's full width (`moe_model`): the
    Generator (`moe_generator`) and the Engine (`moe_engine`) at MOE_LAYERS
    layers, the checkpoints (`moe_checkpoints`), GPTQ of one layer
    (`moe_gptq`) and the card-against-host calibration of tiny-moe's
    experts. Counts reset just before, read just after: K1-K5 must run."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    reset_counts()
    t0 = time.perf_counter()
    qparams, cfg = moe_model(dev, MOE_LAYERS)
    moe_generator(qparams, cfg, dev)
    moe_engine(qparams, cfg, dev)
    # at this width `auto` gives every W4 linear int8 activations (K x N >=
    # AUTO_W4A8_MIN_KN), so at M <= 16 K1/K2 take RA8 only
    routes = check_routes(rm, "moe_paths", need=("ra8",))
    del qparams
    torch.cuda.empty_cache()
    moe_checkpoints(tmp, dev)
    moe_gptq(dev)
    small_calibration_on_both(dev, "tiny-moe", MOE_CALIB)
    launched = port_launches()
    emit({"phase": "moe_paths_launches", **launched, "routes_checked": routes,
          "s": time.perf_counter() - t0})
    missing = [k for k in ("rot_w4_matmul", "merged_rot_w4_matmul", "flash_attention",
                           "paged_decode_attention", "paged_window_attention_kernel")
               if not launched["counts"].get(k)]
    if missing:
        raise SystemExit(f"moe_paths: kernels not launched: {missing}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the qwen3_next hybrid family at Qwen3-Next-80B-A3B's full width
# ---------------------------------------------------------------------------

# Qwen3-Next-80B-A3B-Instruct's config.json
# (huggingface.co/Qwen/Qwen3-Next-80B-A3B-Instruct/blob/main/config.json): 48
# layers, every fourth one full attention (gated q, head_dim 256, partial
# rotary 0.25), the rest gated delta-net; every layer's MLP 512 experts of 512
# (top 10) and a shared expert of 512
QWEN3_NEXT_80B_A3B = dict(
    model_type="qwen3_next", vocab_size=151936, hidden_size=2048, intermediate_size=5120,
    num_hidden_layers=48, full_attention_interval=4, num_attention_heads=16,
    num_key_value_heads=2, head_dim=256, partial_rotary_factor=0.25, rope_theta=1e7,
    linear_num_key_heads=16, linear_num_value_heads=32, linear_key_head_dim=128,
    linear_value_head_dim=128, linear_conv_kernel_dim=4, num_experts=512,
    num_experts_per_tok=10, moe_intermediate_size=512, shared_expert_intermediate_size=512,
    norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[], rms_norm_eps=1e-6,
    tie_word_embeddings=False)
HYBRID_LAYERS = 8  # the served model's depth: 8 of Qwen3-Next-80B-A3B's 48 (6 delta-net,
# 2 full attention), the cut that keeps the script within its time limit
HYBRID_CKPT_LAYERS = 2  # the checkpoints' depth: a delta-net layer, then full attention
HYBRID_SYNC_BATCH = 6  # the paged step's sync check: 6 slots x top 10 <= 64, the gather path
HYBRID_CHECK_LAYERS = 4  # the held logits and Engine checks: the served model's first 4 layers
# a 1-layer hybrid (one delta-net layer, a dense MLP) calibrated on card and host
TINY_HYBRID = dict(model_type="qwen3_next", vocab_size=512, hidden_size=256,
                   intermediate_size=512, num_hidden_layers=1, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, linear_num_key_heads=2,
                   linear_num_value_heads=4, linear_key_head_dim=64, linear_value_head_dim=64,
                   linear_conv_kernel_dim=4, tie_word_embeddings=False)


def hybrid_config(layers, **kw):
    from paroquant_tpu_torch.models import from_hf_dict

    return from_hf_dict(dict(QWEN3_NEXT_80B_A3B, num_hidden_layers=layers, **kw))


class MoePaths:
    """Counts `ops.moe`'s dispatch paths (gather at T x top-k <= 64, ragged
    above) while installed, by the label set in `step`."""

    def __init__(self):
        self.counts, self.step, self.saved = {}, None, None

    def __enter__(self):
        from paroquant_tpu_torch.ops import moe as moe_ops

        self.saved = (moe_ops._moe_gather, moe_ops._moe_ragged)

        def counted(path, fn):
            def call(*a, **k):
                key = f"{self.step}:{path}"
                self.counts[key] = self.counts.get(key, 0) + 1
                return fn(*a, **k)
            return call

        moe_ops._moe_gather = counted("gather", self.saved[0])
        moe_ops._moe_ragged = counted("ragged", self.saved[1])
        return self

    def __exit__(self, *exc):
        from paroquant_tpu_torch.ops import moe as moe_ops

        moe_ops._moe_gather, moe_ops._moe_ragged = self.saved


def hybrid_model(dev, layers):
    """Qwen3-Next-80B-A3B at full width, built layer by layer on the card from
    a seeded torch.Generator: random bf16 weights, Hadamard RTN W4 g128 of
    the attention, in_proj_qkvz, out_proj and the shared expert (in_proj_ba,
    the router and the shared expert's gate dense; the 512 experts through
    quantize_experts_rtn, identity rotations), a W4 lm_head, merged
    projections (the gated QKV 2048 -> 8192 | 512 | 512). Emits the build's
    seconds, peak bytes and the model's bytes."""
    import dataclasses

    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.models import init_params, merge_projections
    from paroquant_tpu_torch.models.decoder import _init_layer

    cfg = hybrid_config(layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(50)
    outer = dataclasses.replace(cfg, num_hidden_layers=0, layer_types=())
    qparams = quantize_model_rtn(init_params(outer, gen, torch.bfloat16, dev), outer,
                                 hadamard=True, quantize_lm_head=True, device=dev)
    layers_q = []
    for i in range(cfg.num_hidden_layers):
        lp = _init_layer(cfg, gen, i, torch.bfloat16, dev)
        layers_q.append(quantize_model_rtn({"layers": [lp]}, cfg, hadamard=True,
                                           device=dev)["layers"][0])
        del lp
    qparams["layers"] = layers_q
    qparams = merge_projections(qparams, cfg)
    torch.cuda.synchronize()
    qkv = next(lp["qkv_proj"] for lp in qparams["layers"] if "qkv_proj" in lp)
    emit({"phase": "hybrid_model", "config": "Qwen3-Next-80B-A3B", "layers": cfg.num_hidden_layers,
          "cut": None if layers == 48 else f"depth {layers} of 48",
          "linear_layers": cfg.num_linear_layers, "full_layers": cfg.num_full_attn_layers,
          "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
          "qkv_out_splits": list(qkv.out_splits), "build_s": time.perf_counter() - t0,
          "model_bytes": torch.cuda.memory_allocated(dev) - base,
          "peak_bytes": torch.cuda.max_memory_allocated(dev) - base, "card": card()})
    if list(qkv.out_splits) != [8192, 512, 512]:
        raise SystemExit(f"hybrid: the gated QKV splits {qkv.out_splits}")
    return qparams, cfg


def hybrid_generator(qparams, cfg, dev, paths):
    """The Generator (quant_mode "auto", flash) over MOE_PROMPTS, greedy, 32
    new tokens each; the decode step under sync debug mode "error";
    profile_decode's busy ms, idle share and launches a step; then the
    teacher-forced logits (prefill of 256 + 8 steps) of the kernel path
    against the plain path, routing pinned, within TOL_E2E
    (`hybrid_logits_check`)."""
    import torch

    from paroquant_tpu_torch.serve import Generator, SamplingParams
    from paroquant_tpu_torch.utils.profiling import profile_decode

    gen = Generator(qparams, cfg, max_len=1024, quant_mode="auto", attn_mode="flash", device=dev)
    g = torch.Generator().manual_seed(51)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in MOE_PROMPTS]
    gen.generate(prompts[0], SamplingParams(max_tokens=4, temperature=0.0))  # warm-up
    results = []
    for p in prompts:
        torch.cuda.synchronize()
        paths.step = f"generator_{len(p)}"
        res = gen.generate(p, SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=0.0))
        toks = res.token_ids
        ok = len(toks) == MOE_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in toks)
        emit({"phase": "hybrid_request", "prompt_tokens": len(p), "new_tokens": len(toks),
              "prefill_ms": res.stats.ttft * 1e3, "decode_tok_s": res.stats.tokens_per_second,
              "decode_ms_per_step": 1e3 / res.stats.tokens_per_second, "ok": ok,
              "first_tokens": toks[:8]})
        if not ok:
            raise SystemExit(f"hybrid: a {len(p)}-token prompt returned {len(toks)} tokens")
        results.append(res)
    paths.step = "generator_no_sync"
    check_decode_has_no_sync({"qwen3-next-80b-a3b": (qparams, cfg)}, dev)
    paths.step = "profile_decode"
    prof = profile_decode(qparams, cfg, prompt_len=256, steps=4, device=dev)
    emit({"phase": "hybrid_decode_profile", "prompt_tokens": 256, "quant_mode": "auto",
          "card": card(), **prof})
    paths.step = "logits_check"
    tokens = torch.tensor([prompts[2] + results[2].token_ids[:8]], dtype=torch.int32, device=dev)
    hybrid_logits_check(qparams, cfg, tokens, len(prompts[2]), dev)


def hybrid_exports(params, cfg):
    """Exports of every quantized linear of a random hybrid: rtn_export_model's
    attention (Hadamard RTN), in_proj_qkvz, out_proj and the shared expert's
    projections by rtn_export_linear, and the experts' export of pseudo
    experts with random shared rotations (`export_quantized_moe`)."""
    import torch

    from paroquant_tpu_torch.convert import rtn_export_model
    from paroquant_tpu_torch.convert.rtn import rtn_export_linear
    from paroquant_tpu_torch.ops import rotation as rot_ops
    from paroquant_tpu_torch.optim.pseudo_moe import export_quantized_moe, make_pseudo_moe

    exports = rtn_export_model(params, cfg, hadamard=True)
    g = torch.Generator(device=params["embed_tokens"].device).manual_seed(53)
    for li, lp in enumerate(params["layers"]):
        if "linear_attn" in lp:
            for name in ("in_proj_qkvz", "out_proj"):
                exports[li][f"linear_attn.{name}"] = rtn_export_linear(lp["linear_attn"][name],
                                                                      hadamard=True)
        for name, lin in lp["mlp"]["shared_expert"].items():
            exports[li][f"mlp.shared_expert.{name}"] = rtn_export_linear(lin, hadamard=True)
        ex = lp["mlp"]["experts"]
        H, I = ex["gate_proj"].shape[1:]
        pm = make_pseudo_moe(ex, rot_ops.make_rotation_params(H, 128, 8, li),
                             rot_ops.make_rotation_params(I, 128, 8, li + 1000))
        with torch.no_grad():
            for side in ("gate_up", "down"):
                th = getattr(pm, f"{side}_theta")
                th.copy_(0.1 * torch.randn(th.shape, generator=g, device=th.device))
        exports[li]["mlp.experts"] = export_quantized_moe(pm)
        del pm
    return exports


def hybrid_checkpoints(tmp, dev):
    """Qwen3-Next-80B-A3B at HYBRID_CKPT_LAYERS layers (random bf16 weights,
    `hybrid_exports`) written as a PARO-TPU and an AWQ directory; each loads
    to the logits and greedy tokens, bit for bit, of the model built in
    memory from the same exports rounded as the file rounds them. The
    config.json, as JAX's, does not carry shared_expert_intermediate_size
    (the loader reads the shared expert from its tensors), so the loaded
    config is compared without it."""
    import dataclasses

    import torch

    from paroquant_tpu_torch.convert import load_checkpoint, save_awq_checkpoint, save_paro_checkpoint
    from paroquant_tpu_torch.models import init_params

    cfg = hybrid_config(HYBRID_CKPT_LAYERS, full_attention_interval=HYBRID_CKPT_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(52), torch.bfloat16, dev)
    exports = hybrid_exports(params, cfg)
    timings = {"export_s": time.perf_counter() - t0}
    for fmt, save in (("paro", save_paro_checkpoint), ("awq", save_awq_checkpoint)):
        d = tmp / f"qwen3-next-80b-a3b-{fmt}"
        t = time.perf_counter()
        save(d, params, cfg, exports)
        timings[f"save_{fmt}_s"] = time.perf_counter() - t
        t = time.perf_counter()
        loaded, lcfg = load_checkpoint(d, device=dev)
        timings[f"load_{fmt}_s"] = time.perf_counter() - t
        inmem = model_from_exports(params, exports, fmt, dev)
        (la, lt), (ma, mt) = prefill_and_decode(loaded, lcfg, dev), prefill_and_decode(inmem, cfg, dev)
        same_cfg = dataclasses.replace(
            lcfg, quantization_items=None,
            shared_expert_intermediate_size=cfg.shared_expert_intermediate_size) == cfg
        types = sorted({type(v).__name__ for lp in loaded["layers"] if "linear_attn" in lp
                        for k, v in lp["linear_attn"].items() if k.startswith(("in_", "out_"))})
        row = {"phase": f"hybrid_{fmt}_check", "layers": HYBRID_CKPT_LAYERS,
               "layer_types": list(lcfg.layer_types),
               "file_bytes": (d / "model.safetensors").stat().st_size, "config_equal": same_cfg,
               "linear_attn_types": types,
               "max_abs_err": (la - ma).abs().max().item(), "bound": 0.0,
               "tokens_equal": torch.equal(lt, mt), "finite": bool(torch.isfinite(la).all())}
        emit(row)
        if (row["max_abs_err"] != 0.0 or not row["tokens_equal"] or not row["finite"]
                or not same_cfg or types != ["DenseLinear", "QuantizedLinear"]):
            raise SystemExit(f"hybrid: the {fmt} directory loads to another model: {row}")
        del loaded, inmem
        torch.cuda.empty_cache()
    emit({"phase": "hybrid_checkpoint_seconds", **timings})
    del params, exports
    torch.cuda.empty_cache()


def hybrid_gptq(dev):
    """gptq_quantize_model on one delta-net layer and one full-attention layer
    at full width (random bf16 weights) over MOE_GPTQ_TOKENS synthetic
    tokens: its seconds, and each projection's output error on the inputs
    GPTQ saw (the second layer's: the quantized first layer's outputs),
    tr(D^T H D) with D the weight's error and H its input's Hessian (the
    experts': the shared Hessian), below RTN's."""
    import numpy as np
    import torch

    from paroquant_tpu_torch.convert.gptq import (_hybrid_layer_apply, _hybrid_tap_hessians,
                                                  _tap_hessians, gptq_quantize_model)
    from paroquant_tpu_torch.convert.rtn import quantize_experts_rtn, quantize_linear_rtn
    from paroquant_tpu_torch.models import init_params
    from paroquant_tpu_torch.models.decoder import embed, rope_tables_per_layer
    from paroquant_tpu_torch.ops.moe import _dequant_stacked
    from paroquant_tpu_torch.ops.qlinear import effective_weight

    cfg = hybrid_config(2, full_attention_interval=2)  # a delta-net layer, then full attention
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(54), torch.bfloat16, dev)
    N, T = MOE_GPTQ_TOKENS
    tokens = np.random.default_rng(54).integers(0, cfg.vocab_size, (N, T)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp, exports = gptq_quantize_model(params, cfg, tokens, batch_size=N, device=dev)
    torch.cuda.synchronize()
    gptq_s = time.perf_counter() - t0

    def err(w, we, h):  # w, we [..., I, O]: sum of (w - we)^T H (w - we)'s trace
        d = (we - w.to(torch.float32))
        return float(((h @ d) * d).sum())

    def experts_eff(q):  # the shared rotation applied back: M^T per group
        outs = []
        for p, rot in (("gate", q.gate_up_rot), ("up", q.gate_up_rot), ("down", q.down_rot)):
            wd = _dequant_stacked(getattr(q, f"{p}_qweight"), getattr(q, f"{p}_scales"),
                                  getattr(q, f"{p}_zeros"), q.group_size)
            E, I, O = wd.shape
            G, S, _ = rot.shape
            outs.append(torch.einsum("gji,egjo->egio", rot.to(torch.float32),
                                     wd.reshape(E, G, S, O)).reshape(E, I, O))
        return outs

    rows = []
    with torch.no_grad():
        x = embed(params, cfg, torch.from_numpy(tokens).to(dev))
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(N, T)
        for li, (lp, qlp) in enumerate(zip(params["layers"], qp["layers"])):
            if cfg.layer_is_linear(li):
                _, hs = _hybrid_tap_hessians(lp, x, cfg, li)
                named = [(f"linear_attn.{n}", lp["linear_attn"][n], qlp["linear_attn"][n], tap)
                         for n, tap in (("in_proj_qkvz", "la_qkvz"), ("out_proj", "la_out"))]
            else:
                cos, sin = rope_tables_per_layer(pos, cfg)[li]
                _, hs = _tap_hessians(lp, x, cfg, li, cos, sin, pos)
                named = [(n, lp[n], qlp[n], tap) for n, tap in
                         (("q_proj", "qkv"), ("k_proj", "qkv"), ("v_proj", "qkv"), ("o_proj", "o"))]
            se, qse = lp["mlp"]["shared_expert"], qlp["mlp"]["shared_expert"]
            named += [(f"shared_expert.{n}", se[n], qse[n], tap) for n, tap in
                      (("gate_proj", "mlp"), ("up_proj", "mlp"), ("down_proj", "shared_down"))]
            for name, lin, qlin, tap in named:
                rows.append({"layer": li, "projection": name,
                             "gptq": err(lin.w, effective_weight(qlin), hs[tap]),
                             "rtn": err(lin.w, effective_weight(quantize_linear_rtn(lin)), hs[tap])})
            ex = lp["mlp"]["experts"]
            got, ref = experts_eff(qlp["mlp"]["experts"]), experts_eff(quantize_experts_rtn(ex))
            for (p, tap), g_, r_ in zip((("gate_proj", "mlp"), ("up_proj", "mlp"),
                                         ("down_proj", "moe_down")), got, ref):
                rows.append({"layer": li, "projection": f"experts.{p}",
                             "gptq": err(ex[p], g_, hs[tap]), "rtn": err(ex[p], r_, hs[tap])})
            del got, ref, hs
            if li == 0:  # the next layer's inputs, as GPTQ computed them
                x = _hybrid_layer_apply(qlp, x, cfg, li)
    worse = [(r["layer"], r["projection"]) for r in rows if not r["gptq"] < r["rtn"]]
    row = {"phase": "hybrid_gptq_check", "layers": 2, "layer_types": list(cfg.layer_types),
           "tokens": [N, T], "s": gptq_s, "exported": [sorted(e) for e in exports],
           "errors": rows, "worse_than_rtn": worse, "card": card()}
    emit(row)
    if worse or "linear_attn.in_proj_qkvz" not in exports[0] or "q_proj" not in exports[1]:
        raise SystemExit(f"hybrid: GPTQ {row}")
    del params, qp, exports, x
    torch.cuda.empty_cache()


def hybrid_paths(tmp, dev):
    """The qwen3_next hybrid at Qwen3-Next-80B-A3B's full width
    (`hybrid_model`): the Generator (`hybrid_generator`), the Engine (8
    slots, no speculation, `moe_engine`) and the paged step's sync check at
    HYBRID_SYNC_BATCH slots at HYBRID_LAYERS layers, the Engine's logprob check on
    the first HYBRID_CHECK_LAYERS layers; the checkpoints
    (`hybrid_checkpoints`), GPTQ of a delta-net and a full-attention layer
    (`hybrid_gptq`) and the card-against-host calibration of TINY_HYBRID.
    Counts reset just before, read just after: K1-K4 must run. Each step
    type's MoE dispatch path is recorded (`MoePaths`)."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm
    from paroquant_tpu_torch.models import from_hf_dict

    reset_counts()
    t0 = time.perf_counter()
    qparams, cfg = hybrid_model(dev, HYBRID_LAYERS)
    with MoePaths() as paths:
        hybrid_generator(qparams, cfg, dev, paths)
        paths.step = "engine"
        moe_engine(qparams, cfg, dev, spec_k=0, phase="hybrid_serve", score=False)
        paths.step = f"paged_step_b{HYBRID_SYNC_BATCH}"
        check_paged_decode_has_no_sync(qparams, cfg, dev, B=HYBRID_SYNC_BATCH)
    routes = check_routes(rm, "hybrid_paths", need=("ra8",))
    # the Engine's logprobs held against one contiguous prefill: the first
    # layers, W4A16 ("fused") at decode as at prefill (under auto a decode
    # step's W4A8 rounding alone moves a random hybrid's logprobs from the
    # prefill's W4A16 ones by 0.14-0.31 nats at these 4 layers); after
    # check_routes, as fused's W4A16 lm_head takes the passes at M <= 16
    moe_engine(*first_layers(qparams, cfg, HYBRID_CHECK_LAYERS), dev, spec_k=0,
               phase="hybrid_serve_4_layers", quant_mode="fused")
    emit({"phase": "hybrid_moe_paths", "calls_by_step_and_path": paths.counts})
    if not paths.counts.get(f"paged_step_b{HYBRID_SYNC_BATCH}:gather"):
        raise SystemExit(f"hybrid: the paged step at {HYBRID_SYNC_BATCH} slots missed the "
                         f"gather path: {paths.counts}")
    kinds = {"flash": dict(at.flash_kinds), "paged": {k: dict(v) for k, v in
                                                      at.paged_instances.items()}}
    del qparams
    torch.cuda.empty_cache()
    hybrid_checkpoints(tmp, dev)
    hybrid_gptq(dev)
    small_calibration_on_both(dev, from_hf_dict(TINY_HYBRID), SMALL_CALIB)
    launched = port_launches()
    emit({"phase": "hybrid_paths_launches", **launched, "instances": kinds,
          "routes_checked": routes, "s": time.perf_counter() - t0})
    missing = [k for k in ("rot_w4_matmul", "merged_rot_w4_matmul", "flash_attention",
                           "paged_decode_attention") if not launched["counts"].get(k)]
    if missing or not kinds["flash"]["f32_q_bf16_kv"]:
        raise SystemExit(f"hybrid_paths: kernels not launched: {missing}, K3 by instance "
                         f"{kinds['flash']}")
    torch.cuda.empty_cache()
    return launched["counts"]


# ---------------------------------------------------------------------------
# the gemma3n family at Gemma 3n E4B's full width
# ---------------------------------------------------------------------------

# google/gemma-3n-E4B's text config (transformers' Gemma3nTextConfig defaults,
# transformers/models/gemma3n/configuration_gemma3n.py): 35 layers, 4 sliding
# (window 512) to 1 full, the last 15 a shared-KV tail; AltUp of 4, LAuReL
# rank 64, per-layer inputs of 256 over a per-layer vocab of 262144; MLP
# 16384 with activation sparsity 0.95 on layers 0-9; softcap 30, tied
# embeddings of 262400
GEMMA3N_E4B = dict(
    model_type="gemma3n_text", vocab_size=262400, vocab_size_per_layer_input=262144,
    hidden_size=2048, hidden_size_per_layer_input=256, num_hidden_layers=35,
    num_attention_heads=8, num_key_value_heads=2, head_dim=256, rms_norm_eps=1e-6,
    rope_theta=1_000_000.0, rope_local_base_freq=10_000.0, sliding_window=512,
    num_kv_shared_layers=15, altup_num_inputs=4, altup_active_idx=0, altup_coef_clip=120.0,
    altup_correct_scale=True, laurel_rank=64, final_logit_softcapping=30.0,
    hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True, attention_bias=False,
    max_position_embeddings=32768)
GEMMA3N_PATTERN = ("sliding_attention",) * 4 + ("full_attention",)


def gemma3n_config(layers, shared=None, **kw):
    """Gemma 3n E4B at `layers` layers: the first `layers` entries of its
    layer types, MLP widths and sparsity, and `shared` tail layers (15 at
    35 layers, else 15 * layers // 35 unless given)."""
    from paroquant_tpu_torch.models import from_hf_dict

    if shared is None:
        shared = 15 * layers // 35
    return from_hf_dict(dict(
        GEMMA3N_E4B, num_hidden_layers=layers, num_kv_shared_layers=shared,
        layer_types=[GEMMA3N_PATTERN[i % 5] for i in range(layers)],
        intermediate_size=[16384] * layers,
        activation_sparsity_pattern=[0.95 if i < 10 else 0.0 for i in range(layers)], **kw))


GEMMA3N_LAYERS = 8  # the served model's depth: 8 of Gemma 3n E4B's 35, to leave room for the VLM
# the held logits and Engine checks' depth and tail: layers 0-4, then layer 5
# reading layer 3 (at 35 layers a random model's noise floor passes TOL_E2E)
GEMMA3N_CHECK = (6, 1)
GEMMA3N_CKPT = (3, 1)  # the checkpoints' depth and tail: layers 0-1, then layer 2 reading layer 1
GEMMA3N_NOISE = 2.0 ** -8  # relative noise on K1/K2's inputs: the size of a bf16 rounding
# a source layer and its tail (layer 1 reads layer 0's k/v), calibrated on card and
# host, one epoch a stage: at SMALL_CALIB's 4+2 epochs two host runs with the
# embedding table one ulp apart already leave the check's rule on the tail
# (tests/test_torch_gemma3n_calibrate.py::test_small_calibration_one_ulp_apart)
GEMMA3N_CALIB = dict(n_bits=4, group_size=64, num_rotations=6,
                     stages=(({"channel_scales": 5e-3, "angles": 5e-3}, 1),
                             ({"weight": 1e-5, "quantizer": 1e-6}, 1)))
TINY_GEMMA3N = dict(
    model_type="gemma3n_text", vocab_size=512, vocab_size_per_layer_input=512, hidden_size=256,
    hidden_size_per_layer_input=32, intermediate_size=[512, 512], num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=64, sliding_window=16,
    layer_types=["sliding_attention", "sliding_attention"], num_kv_shared_layers=1,
    laurel_rank=16, activation_sparsity_pattern=[0.95, 0.0], final_logit_softcapping=30.0,
    hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True)


def gemma3n_random_init(params, cfg, gen):
    """The random model's two choices beside init_params, in place: each
    layer's altup.correct_output_scale (zeros at init, which would shut the
    per-layer input gate) to 1 + 0.1 N(0, 1) in f32, and q_norm and k_norm
    to head_dim ** -0.25. gemma3n scores q.k at scale 1.0 on q and k normed
    to unit RMS: random unit norms give scores of std sqrt(head_dim) (16 at
    E4B), a near-hard softmax under which a random model's logits
    decorrelate from any rounding; at head_dim ** -0.25 the scores have std
    1, the temperature of scaled dot-product attention."""
    import torch

    for lp in params["layers"]:
        s = lp["altup"]["correct_output_scale"]
        lp["altup"]["correct_output_scale"] = 1.0 + 0.1 * torch.randn(
            s.shape, generator=gen, device=s.device)
        for n in ("q_norm", "k_norm"):
            lp[n] = lp[n] * cfg.head_dim ** -0.25


def gemma3n_model(dev, layers, shared=None):
    """Gemma 3n E4B at full width, built layer by layer on the card from a
    seeded torch.Generator: random bf16 weights, Hadamard RTN W4 g128 of
    q/k/v/o and the MLP (the tail's unused k/v too; the AltUp, LAuReL and
    per-layer linears dense), a W4 lm_head from the tied table, merged
    projections (QKV 2048 -> 2048 | 512 | 512 before the tail, gate-up
    2048 -> 16384 | 16384). Emits the build's seconds, peak bytes and the
    model's bytes. `shared`: the tail's length (gemma3n_config's default
    unless given)."""
    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.models import merge_projections
    from paroquant_tpu_torch.models.gemma3n import init_gemma3n_layer, init_gemma3n_shared

    cfg = gemma3n_config(layers, shared)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(60)
    qparams = quantize_model_rtn(init_gemma3n_shared(cfg, gen, torch.bfloat16, dev), cfg,
                                 hadamard=True, quantize_lm_head=True, device=dev)
    for i in range(cfg.num_hidden_layers):
        lp = {"layers": [init_gemma3n_layer(cfg, gen, i, torch.bfloat16, dev)]}
        gemma3n_random_init(lp, cfg, gen)
        qparams["layers"].append(quantize_model_rtn(lp, cfg, hadamard=True,
                                                    device=dev)["layers"][0])
        del lp
    qparams = merge_projections(qparams, cfg)
    torch.cuda.synchronize()
    qkv = qparams["layers"][0]["qkv_proj"]
    tail = [i for i, lp in enumerate(qparams["layers"]) if "q_proj" in lp]
    emit({"phase": "gemma3n_model", "config": "Gemma 3n E4B", "layers": cfg.num_hidden_layers,
          "cut": None if layers == 35 else f"depth {layers} of 35",
          "shared_kv_layers": cfg.num_kv_shared_layers, "kv_pool_layers": cfg.num_full_attn_layers,
          "qkv_out_splits": list(qkv.out_splits), "unmerged_q_layers": tail,
          "build_s": time.perf_counter() - t0,
          "model_bytes": torch.cuda.memory_allocated(dev) - base,
          "peak_bytes": torch.cuda.max_memory_allocated(dev) - base, "card": card()})
    kv = cfg.num_key_value_heads * cfg.head_dim
    if list(qkv.out_splits) != [cfg.num_attention_heads * cfg.head_dim, kv, kv] or tail != list(
            range(cfg.first_kv_shared_layer, layers)):
        raise SystemExit(f"gemma3n: merged QKV {qkv.out_splits}, unmerged q_proj at {tail}")
    return qparams, cfg


def gemma3n_generator(qparams, cfg, dev):
    """The Generator (quant_mode "auto", flash) over MOE_PROMPTS, greedy, 32
    new tokens each (lookup speculation is off for gemma3n, as in JAX); the
    decode step under sync debug mode "error"; profile_decode's busy ms,
    idle share and launches a step. Returns the tokens of
    `gemma3n_logits_check`: the 256-token prompt and 8 of its tokens."""
    import torch

    from paroquant_tpu_torch.serve import Generator, SamplingParams
    from paroquant_tpu_torch.utils.profiling import profile_decode

    gen = Generator(qparams, cfg, max_len=1024, quant_mode="auto", attn_mode="flash", device=dev)
    g = torch.Generator().manual_seed(61)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in MOE_PROMPTS]
    gen.generate(prompts[0], SamplingParams(max_tokens=4, temperature=0.0))  # warm-up
    results = []
    for p in prompts:
        torch.cuda.synchronize()
        res = gen.generate(p, SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=0.0))
        toks = res.token_ids
        ok = len(toks) == MOE_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in toks)
        emit({"phase": "gemma3n_request", "prompt_tokens": len(p), "new_tokens": len(toks),
              "prefill_ms": res.stats.ttft * 1e3, "decode_tok_s": res.stats.tokens_per_second,
              "decode_ms_per_step": 1e3 / res.stats.tokens_per_second, "ok": ok,
              "first_tokens": toks[:8]})
        if not ok:
            raise SystemExit(f"gemma3n: a {len(p)}-token prompt returned {len(toks)} tokens")
        results.append(res)
    check_decode_has_no_sync({"gemma-3n-e4b": (qparams, cfg)}, dev)
    prof = profile_decode(qparams, cfg, prompt_len=256, steps=4, device=dev)
    emit({"phase": "gemma3n_decode_profile", "prompt_tokens": 256, "quant_mode": "auto",
          "card": card(), **prof})
    return torch.tensor([prompts[2] + results[2].token_ids[:8]], dtype=torch.int32, device=dev)


def gemma3n_logits_check(qparams, cfg, tokens, n, dev, hold=True):
    """The teacher-forced logits (a prefill of n tokens, then a decode step a
    token), each row's relative Frobenius error: held within TOL_E2E (with
    `hold`; else recorded), the `auto` kernel path (flash: K3; K1/K2 with
    W4A8 for the matrices of K x N >= 8M at decode, W4A16 elsewhere)
    against the same computation with each kernel's plain version
    (`plain_kernels`); recorded beside it, the noise floor (the plain
    `auto` path against itself with every K1/K2 input perturbed by
    GEMMA3N_NOISE relative) and, where held, `auto` against quant_mode
    "xla" with the einsum attention (other roundings, and W4A8's int8
    activations, which no kernel causes). Row 0 is the prefill's, where
    `auto` (M > 128) calls no K1/K2, so the noise leaves it alone."""
    import torch

    def tf(mode, attn="flash"):
        return teacher_forced(qparams, cfg, tokens, n, mode, attn, dev)

    def rel(x, ref):
        return ((x - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()

    auto = tf("auto")
    with plain_kernels():
        plain = tf("auto")
    with plain_kernels(GEMMA3N_NOISE):
        noisy = tf("auto")
    held = {"auto_vs_plain_kernels": rel(auto, plain)}
    row = {"phase": "gemma3n_logits_check", "layers": cfg.num_hidden_layers, "held": hold,
           "tail": [i for i in range(cfg.num_hidden_layers) if cfg.kv_share_source(i) is not None],
           "steps": auto.shape[0], "shape": list(auto.shape), **held, "bound": TOL_E2E,
           "noise_floor_rel_fro_err": rel(noisy, plain), "noise": GEMMA3N_NOISE}
    outs = [auto, plain]
    if hold:
        xla = tf("xla", "einsum")
        outs.append(xla)
        row.update(auto_vs_xla=rel(auto, xla), argmax_agree_auto_xla=sum(
            int(a) == int(b) for a, b in zip(auto.argmax(-1), xla.argmax(-1))))
    finite = all(bool(torch.isfinite(x).all()) for x in outs)
    row["finite"] = finite
    emit(row)
    if not finite or tuple(auto.shape) != (tokens.shape[1] - n + 1, cfg.vocab_size) or (
            hold and max(max(v) for v in held.values()) > TOL_E2E):
        raise SystemExit(f"gemma3n: kernel-path logits disagree with the reference path: {row}")


def gemma3n_engine(qparams, cfg, dev, hold=True):
    """The Engine (8 slots, pages of 128, chunked prefill of 256, prefix
    caching, no speculation, bf16 pool) over eight greedy requests of
    16-600 prompt tokens, 32 new each; two share a 256-token prefix, the
    second submitted once the first has prefilled, so that it takes its
    pages from the prefix cache; one is longer than the chunk. Every
    request returns its tokens, the prefix cache is hit, and each request's
    logprobs lie within TOL_LOGPROB of one contiguous prefill
    (`check_logprobs`; with hold=False recorded, not held)."""
    import torch

    from paroquant_tpu_torch.serve import Engine, SamplingParams

    eng = Engine(qparams, cfg, max_batch=8, max_len=1024, page_size=128, prefill_chunk=256,
                 quant_mode="auto", decode_burst=8, prefix_caching=True, device=dev)
    g = torch.Generator().manual_seed(62)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    shared = rand(256)
    first = [shared + rand(40), rand(16), rand(100), rand(600), rand(300), rand(64)]
    late = [shared + rand(90), rand(200)]
    sp = SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=0.0)
    eng.generate_sync(rand(40), SamplingParams(max_tokens=4, temperature=0.0))  # warm-up
    for key in eng.metrics:
        eng.metrics[key] = 0
    eng._ttfts.clear()
    eng._step_samples.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs = [(eng.submit(p, sp), p) for p in first]
    ticks = 0
    while eng.step() or ticks < 8:
        ticks += 1
        if ticks == 8:  # by now the shared prefix's pages are registered
            pairs += [(eng.submit(p, sp), p) for p in late]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    greedy = []
    for r, p in pairs:
        toks = []
        while not r.out_queue.empty():
            kind, t = r.out_queue.get_nowait()
            if kind == "token":
                toks.append(t)
        if len(toks) != MOE_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
            raise SystemExit(f"gemma3n_serve: a {len(p)}-token prompt returned {len(toks)} tokens")
        greedy.append((r, p, toks))
    emit({"phase": "gemma3n_serve", "layers": cfg.num_hidden_layers, "quant_mode": "auto",
          "requests": len(pairs),
          "wall_s": wall, "ticks": ticks,
          "generated_tok_s": eng.metrics["tokens_generated"] / wall, "metrics": eng.metrics,
          "ttft": eng.ttft_stats(), "step_time": eng.step_time_stats()})
    if eng.metrics["prefix_hit_tokens"] <= 0:
        raise SystemExit(f"gemma3n_serve: no prefix hit: {eng.metrics}")
    # a random model's flat attention (gemma3n_random_init) moves the scores under a
    # wrong context by a few tenths of a nat at 6 layers: held against the worst gap
    check_logprobs(eng, greedy, cfg, f"gemma3n_serve_{cfg.num_hidden_layers}_layers",
                   context_bound=None, hold=hold)
    del eng
    torch.cuda.empty_cache()


def gemma3n_checkpoints(tmp, dev):
    """Gemma 3n E4B at GEMMA3N_CKPT's depth (a source layer and its shared-KV
    tail; random bf16 weights, rtn_export_model's Hadamard RTN exports of
    q/k/v/o and the MLP) written as a PARO-TPU and an AWQ directory; each
    loads to the logits and greedy tokens, bit for bit, of the model built
    in memory from the same exports rounded as the file rounds them."""
    import dataclasses

    import torch

    from paroquant_tpu_torch.convert import load_checkpoint, save_awq_checkpoint, save_paro_checkpoint
    from paroquant_tpu_torch.convert.rtn import rtn_export_model
    from paroquant_tpu_torch.models import init_params

    cfg = gemma3n_config(*GEMMA3N_CKPT)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(63)
    params = init_params(cfg, gen, torch.bfloat16, dev)
    gemma3n_random_init(params, cfg, gen)
    exports = rtn_export_model(params, cfg, hadamard=True)
    timings = {"export_s": time.perf_counter() - t0}
    for fmt, save in (("paro", save_paro_checkpoint), ("awq", save_awq_checkpoint)):
        d = tmp / f"gemma-3n-e4b-{fmt}"
        t = time.perf_counter()
        save(d, params, cfg, exports)
        timings[f"save_{fmt}_s"] = time.perf_counter() - t
        t = time.perf_counter()
        loaded, lcfg = load_checkpoint(d, device=dev)
        timings[f"load_{fmt}_s"] = time.perf_counter() - t
        inmem = model_from_exports(params, exports, fmt, dev)
        (la, lt), (ma, mt) = prefill_and_decode(loaded, lcfg, dev), prefill_and_decode(inmem, cfg, dev)
        row = {"phase": f"gemma3n_{fmt}_check", "layers": cfg.num_hidden_layers,
               "tail": [i for i in range(cfg.num_hidden_layers) if cfg.kv_share_source(i) is not None],
               "file_bytes": (d / "model.safetensors").stat().st_size,
               "config_equal": dataclasses.replace(lcfg, quantization_items=None) == cfg,
               "max_abs_err": (la - ma).abs().max().item(), "bound": 0.0,
               "tokens_equal": torch.equal(lt, mt), "finite": bool(torch.isfinite(la).all())}
        emit(row)
        if (row["max_abs_err"] != 0.0 or not row["tokens_equal"] or not row["finite"]
                or not row["config_equal"] or not row["tail"]):
            raise SystemExit(f"gemma3n: the {fmt} directory loads to another model: {row}")
        del loaded, inmem
        torch.cuda.empty_cache()
    emit({"phase": "gemma3n_checkpoint_seconds", **timings})
    del params, exports
    torch.cuda.empty_cache()


def gemma3n_paths(tmp, dev):
    """The gemma3n family at Gemma 3n E4B's full width (`gemma3n_model`,
    GEMMA3N_LAYERS layers): the Generator (`gemma3n_generator`), the Engine
    (`gemma3n_engine`) and the paged step's sync check at 8 slots; the
    checkpoints (`gemma3n_checkpoints`) and the card-against-host
    calibration of TINY_GEMMA3N (a source layer and its tail). The logits
    and the Engine's logprobs are held on a second model at GEMMA3N_CHECK's
    depth (a tail layer included) and recorded at GEMMA3N_LAYERS, where a
    random model's noise floor passes TOL_E2E. Counts reset just before,
    read just after: K1-K4 must run, K3 and K4 on their tensor-core
    instances."""
    import torch

    from paroquant_tpu_torch.kernels import attention as at, rot_matmul as rm
    from paroquant_tpu_torch.models import from_hf_dict

    reset_counts()
    t0 = time.perf_counter()
    qparams, cfg = gemma3n_model(dev, GEMMA3N_LAYERS)
    tokens = gemma3n_generator(qparams, cfg, dev)
    gemma3n_engine(qparams, cfg, dev, hold=False)
    check_paged_decode_has_no_sync(qparams, cfg, dev, B=8)
    # at this width `auto` gives the MLP and the lm_head int8 activations (K x N
    # >= AUTO_W4A8_MIN_KN): K1/K2 take RA8 there and the one launch elsewhere
    routes = check_routes(rm, "gemma3n_paths")
    gemma3n_logits_check(qparams, cfg, tokens, tokens.shape[1] - 8, dev, hold=False)
    kinds = {"flash": dict(at.flash_kinds), "paged": {k: dict(v) for k, v in
                                                      at.paged_instances.items()}}
    del qparams
    torch.cuda.empty_cache()
    qparams, cfg = gemma3n_model(dev, *GEMMA3N_CHECK)
    gemma3n_logits_check(qparams, cfg, tokens, tokens.shape[1] - 8, dev)
    gemma3n_engine(qparams, cfg, dev)
    del qparams
    torch.cuda.empty_cache()
    gemma3n_checkpoints(tmp, dev)
    small_calibration_on_both(dev, from_hf_dict(TINY_GEMMA3N), GEMMA3N_CALIB, layers=2,
                              prepare=gemma3n_random_init)
    launched = port_launches()
    emit({"phase": "gemma3n_paths_launches", **launched, "instances": kinds,
          "routes_checked": routes, "s": time.perf_counter() - t0})
    missing = [k for k in ("rot_w4_matmul", "merged_rot_w4_matmul", "flash_attention",
                           "paged_decode_attention") if not launched["counts"].get(k)]
    if missing or not kinds["flash"]["bf16"] or not kinds["paged"]["paged_decode_attention"]["mma"]:
        raise SystemExit(f"gemma3n_paths: kernels not launched: {missing}, by instance {kinds}")
    torch.cuda.empty_cache()
    return launched["counts"]


# ---------------------------------------------------------------------------
# phase 14: the Gemma 3 VLM at Gemma 3 4B width
# ---------------------------------------------------------------------------


# Gemma 3 4B (google/gemma-3-4b-it): its config.json's text fields and the
# rest of Gemma3TextConfig's defaults, its SigLIP tower and the merge's
# tokens, every width written out (the card has no transformers to fill the
# defaults in). Its rope_scaling (linear, 8) is read by neither package.
GEMMA3_4B = dict(
    model_type="gemma3", mm_tokens_per_image=256, image_token_index=262144,
    boi_token_index=255999, eoi_token_index=256000,
    text_config=dict(
        model_type="gemma3_text", vocab_size=262208, hidden_size=2560, intermediate_size=10240,
        num_hidden_layers=34, num_attention_heads=8, num_key_value_heads=4, head_dim=256,
        query_pre_attn_scalar=256, rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
        sliding_window=1024, rms_norm_eps=1e-6, max_position_embeddings=131072,
        layer_types=["full_attention" if i % 6 == 5 else "sliding_attention" for i in range(34)],
        hidden_activation="gelu_pytorch_tanh", attention_bias=False, tie_word_embeddings=True,
        final_logit_softcapping=None, attn_logit_softcapping=None),
    vision_config=dict(
        model_type="siglip_vision_model", hidden_size=1152, intermediate_size=4304,
        num_hidden_layers=27, num_attention_heads=16, image_size=896, patch_size=14,
        num_channels=3, layer_norm_eps=1e-6))
VLM_LAYERS = 34  # the served model's depth: all of Gemma 3 4B's
# the held checks' depth where the noise floor at VLM_LAYERS passes TOL_E2E / 2:
# layers 0-5, full layer 5 included
VLM_CHECK_LAYERS = 6
VLM_CKPT_LAYERS = 2  # the checkpoint's LM depth (its tower whole)
VLM_NOISE = 2.0 ** -8  # relative noise on K1/K2's inputs: the size of a bf16 rounding
VLM_TEXT = 64  # text tokens after the image in the profiled and checked prompts
VLM_SEED = 70


def vlm_config(layers):
    """Gemma 3 4B with its LM cut to `layers` layers (the tower whole)."""
    from paroquant_tpu_torch.models import from_hf_dict

    text = GEMMA3_4B["text_config"]
    return from_hf_dict(dict(GEMMA3_4B, text_config=dict(
        text, num_hidden_layers=layers, layer_types=text["layer_types"][:layers])))


def vlm_tower(cfg, gen, dev):
    """Random SigLIP tower and projector weights in models/vision.py's
    layout: bf16 weights of fan-in scale, the residual branches' out_proj
    and fc2 also by 1 / sqrt(2 L) (GPT-2's init; at fan-in scale alone 27
    random layers collapse every patch of every image onto one direction,
    so that two images' soft tokens lie at cosine 0.93 and an image hardly
    moves the LM), f32 biases of std 0.02, unit layer norms, position
    embeddings of std 0.02, the projector's norm at 1 + w = 1."""
    import math

    import torch

    from paroquant_tpu_torch.models import DenseLinear
    from paroquant_tpu_torch.models.vision import VisionConfig

    vc = VisionConfig.from_hf_dict(cfg.vision)
    D, F, cpp = vc.hidden_size, vc.intermediate_size, vc.num_channels * vc.patch_size ** 2
    bf16 = dict(dtype=torch.bfloat16, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def dense(i, o, branch=1.0):
        return DenseLinear((randn(i, o) * (branch / math.sqrt(i))).to(torch.bfloat16),
                           randn(o) * 0.02)

    branch = (2 * vc.num_hidden_layers) ** -0.5

    vision = {"patch_embed_w": (randn(cpp, D) / math.sqrt(cpp)).to(torch.bfloat16),
              "patch_embed_b": randn(D) * 0.02,
              "pos_embed": (randn(vc.num_patches, D) * 0.02).to(torch.bfloat16),
              "post_ln_w": torch.ones(D, **bf16), "post_ln_b": torch.zeros(D, **bf16),
              "layers": []}
    for _ in range(vc.num_hidden_layers):
        vision["layers"].append({
            "ln1_w": torch.ones(D, **bf16), "ln1_b": torch.zeros(D, **bf16),
            "ln2_w": torch.ones(D, **bf16), "ln2_b": torch.zeros(D, **bf16),
            **{n: dense(D, D) for n in ("q_proj", "k_proj", "v_proj")},
            "out_proj": dense(D, D, branch), "fc1": dense(D, F), "fc2": dense(F, D, branch)})
    projector = {"mm_input_projection": (randn(D, cfg.hidden_size) / math.sqrt(D)).to(torch.bfloat16),
                 "mm_soft_emb_norm": torch.zeros(D, **bf16)}
    return {"vision": vision, "projector": projector}


def vlm_dense(cfg, seed, dev):
    """A dense bf16 Gemma 3 VLM from a seeded generator: init_params' LM with
    q_norm and k_norm at 1 + w = 1 (scores of std 1 at scale 256^-0.5 on
    unit-RMS q and k; init_params' ones give 1 + w = 2, a sharp softmax under
    which a random model's logits decorrelate from a rounding), and
    `vlm_tower`."""
    import torch

    from paroquant_tpu_torch.models import init_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, torch.bfloat16, dev)
    for lp in params["layers"]:
        lp["q_norm"], lp["k_norm"] = torch.zeros_like(lp["q_norm"]), torch.zeros_like(lp["k_norm"])
    params.update(vlm_tower(cfg, gen, dev))
    return params


def vlm_model(dev, layers):
    """Gemma 3 4B at full width: `vlm_dense`, then Hadamard RTN W4 g128 of
    the LM's q/k/v/o and MLP with a W4 lm_head from the tied table, merged
    projections (QKV 2560 -> 2048 | 1024 | 1024, gate-up 2560 -> 10240 |
    10240); the tower stays dense bf16. Emits the build's seconds, the
    model's and the tower's bytes and the peak."""
    import torch

    from paroquant_tpu_torch.convert.rtn import quantize_model_rtn
    from paroquant_tpu_torch.models import merge_projections

    cfg = vlm_config(layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    dense = vlm_dense(cfg, VLM_SEED, dev)
    qparams = merge_projections(quantize_model_rtn(dense, cfg, hadamard=True, quantize_lm_head=True,
                                                   device=dev), cfg)
    del dense
    torch.cuda.synchronize()

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        return sum(b.numel() * b.element_size() for b in tree.buffers())

    qkv = qparams["layers"][0]["qkv_proj"]
    emit({"phase": "vlm_model", "config": "Gemma 3 4B", "layers": layers,
          "cut": None if layers == 34 else f"depth {layers} of 34",
          "full_layers": [i for i in range(layers) if cfg.layer_sliding_window(i) is None],
          "qkv_out_splits": list(qkv.out_splits), "build_s": time.perf_counter() - t0,
          "model_bytes": torch.cuda.memory_allocated(dev) - base,
          "tower_bytes": nbytes(qparams["vision"]) + nbytes(qparams["projector"]),
          "peak_bytes": torch.cuda.max_memory_allocated(dev) - base, "card": card()})
    kv = cfg.num_key_value_heads * cfg.head_dim
    if list(qkv.out_splits) != [cfg.num_attention_heads * cfg.head_dim, kv, kv] or (
            "gate_up_proj" not in qparams["layers"][0]["mlp"]):
        raise SystemExit(f"vlm: merged QKV {qkv.out_splits}")
    return qparams, cfg


def vlm_text(gen, n):
    """n random text tokens (below the image markers' ids)."""
    import torch

    return torch.randint(0, GEMMA3_4B["boi_token_index"], (n,), generator=gen).tolist()


def vlm_prompt(cfg, gen, texts):
    """BOI, mm_tokens_per_image image tokens and EOI, then n text tokens,
    for each n of `texts` (one image each)."""
    out = []
    for n in texts:
        out += ([GEMMA3_4B["boi_token_index"]] + [cfg.image_token_id] * cfg.mm_tokens_per_image
                + [GEMMA3_4B["eoi_token_index"]] + vlm_text(gen, n))
    return out


def vlm_pixels(gen, n, dev):
    """n f32 images [n, 3, 896, 896] of N(0, 1) values from `gen`."""
    import torch

    return torch.randn(n, 3, 896, 896, generator=gen).to(dev)


def vlm_teacher_forced(params, cfg, tokens, pixels, n_prompt, quant_mode, dev):
    """The VLM prefill's last-position logits, then one row per
    teacher-forced decode step (the text path)."""
    import torch

    from paroquant_tpu_torch.models.decoder import KVCache, decode_step
    from paroquant_tpu_torch.models.vision import vlm_prefill_step

    cache = KVCache.create(cfg, 1, tokens.shape[1], torch.bfloat16, dev)
    logits, cache = vlm_prefill_step(params, cfg, tokens[:, :n_prompt], pixels, cache,
                                     quant_mode=quant_mode)
    out = [logits]
    for i in range(n_prompt, tokens.shape[1]):
        logits, cache = decode_step(params, cfg, tokens[:, i : i + 1], cache, quant_mode=quant_mode)
        out.append(logits)
    return torch.cat(out).float()


def vlm_prefill_profile(qparams, cfg, tokens, pixels, dev):
    """One image plus VLM_TEXT text tokens prefilled (`vlm_prefill_step`,
    quant_mode "auto") under `profiling._profile`: wall and device-busy ms,
    launches and the top kernels; then the tower and projector alone, whose
    device ms stand beside their f32 bound (the FLOPs of its linears and
    attention over PEAK_OPS["f32"]). The record of an image request's
    time to first token."""
    import torch

    from paroquant_tpu_torch.models.decoder import KVCache
    from paroquant_tpu_torch.models.vision import (VisionConfig, gemma3_project, siglip_encode,
                                                   vlm_prefill_step)
    from paroquant_tpu_torch.utils.profiling import _profile

    cache = KVCache.create(cfg, 1, tokens.shape[1], torch.bfloat16, dev)
    vc = VisionConfig.from_hf_dict(cfg.vision)

    def prefill(n):
        for _ in range(n):
            vlm_prefill_step(qparams, cfg, tokens, pixels, cache, quant_mode="auto")
        torch.cuda.synchronize(dev)

    def tower(n):
        with torch.no_grad():
            for _ in range(n):
                gemma3_project(qparams["projector"], siglip_encode(qparams["vision"], vc, pixels), vc,
                               cfg.mm_tokens_per_image, vc.layer_norm_eps)
        torch.cuda.synchronize(dev)

    P, D, F = vc.num_patches, vc.hidden_size, vc.intermediate_size
    flops = vc.num_hidden_layers * (2 * P * (4 * D * D + 2 * D * F) + 4 * P * P * D)
    flops += 2 * P * vc.num_channels * vc.patch_size ** 2 * D
    pre = _profile(prefill, 2, 8)
    tw = _profile(tower, 2, 8)
    emit({"phase": "vlm_prefill_profile", "prompt_tokens": tokens.shape[1], "images": 1,
          "quant_mode": "auto", **pre,
          "tower_device_ms": tw["device_busy_ms_per_step"], "tower_wall_ms": tw["wall_ms_per_step"],
          "tower_launches": tw["launches_per_step"], "tower_top_kernels": tw["top_kernels"],
          "tower_flops": flops, "tower_bound_ms": flops / PEAK_OPS["f32"] * 1e3,
          "tower_dtype": str(pixels.dtype), "card": card()})


def vlm_logits_check(qparams, cfg, tokens, pixels, n, dev):
    """The teacher-forced logits (a VLM prefill of n tokens, one image, then
    8 decode steps), each row's relative Frobenius error: the `auto` kernel
    path (K1/K2 at decode: RA8 for QKV, gate-up, down and the lm_head, the
    one launch for o_proj; the prefill at M > 128 on the plain path, the
    einsum attention with the image run attended both ways) against the
    same computation with each kernel's plain version (`plain_kernels`),
    beside the noise floor (the plain path against itself with every
    K1/K2 input perturbed by VLM_NOISE relative). Held within TOL_E2E at
    VLM_LAYERS where that floor stays within TOL_E2E / 2, else recorded
    there and held on the first VLM_CHECK_LAYERS layers; `auto` against
    quant_mode "xla" recorded at the held depth. Returns (params, config)
    of the held depth and the kernel path's worst row there."""
    import torch

    def run(params, config, perturb=None, mode="auto", px=pixels):
        if perturb is None:
            return vlm_teacher_forced(params, config, tokens, px, n, mode, dev)
        with plain_kernels(perturb):
            return vlm_teacher_forced(params, config, tokens, px, n, mode, dev)

    def rel(x, ref):
        return ((x - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()

    def check(params, config, hold):
        auto, plain = run(params, config), run(params, config, 0.0)
        noisy = run(params, config, VLM_NOISE)
        err, floor = rel(auto, plain), rel(noisy, plain)
        if hold is None:
            hold = max(floor) <= TOL_E2E / 2
        row = {"phase": "vlm_logits_check", "layers": config.num_hidden_layers,
               "held": hold, "steps": auto.shape[0], "shape": list(auto.shape),
               "auto_vs_plain_kernels": err, "bound": TOL_E2E,
               "noise_floor_rel_fro_err": floor, "noise": VLM_NOISE}
        outs = [auto, plain, noisy]
        if hold:
            xla = run(params, config, mode="xla")
            outs.append(xla)
            row.update(auto_vs_xla=rel(auto, xla), argmax_agree_auto_xla=sum(
                int(a) == int(b) for a, b in zip(auto.argmax(-1), xla.argmax(-1))))
        row["finite"] = all(bool(torch.isfinite(x).all()) for x in outs)
        emit(row)
        if not row["finite"] or tuple(auto.shape) != (tokens.shape[1] - n + 1, cfg.vocab_size) or (
                hold and max(err) > TOL_E2E):
            raise SystemExit(f"vlm: kernel-path logits disagree with their plain version: {row}")
        return hold, max(err), auto

    held = (qparams, cfg)
    hold, err, auto = check(qparams, cfg, None)
    if not hold:
        held = first_layers(qparams, cfg, VLM_CHECK_LAYERS)
        _, err, auto = check(*held, True)
    return held, err, auto


def vlm_image_check(params, cfg, tokens, other, n, err, auto, dev):
    """At the held depth: the teacher-forced logits with another image must
    move every row (the prefill's last position and the 8 decode steps,
    all after the image) by more than the kernel path's worst error `err`,
    or the check above could not see an image that never reached the LM."""
    moved = vlm_teacher_forced(params, cfg, tokens, other, n, "auto", dev)
    rel = ((moved - auto).norm(dim=-1) / auto.norm(dim=-1)).tolist()
    emit({"phase": "vlm_image_check", "layers": cfg.num_hidden_layers, "rel_fro_move": rel,
          "kernel_path_worst_err": err})
    if min(rel) <= err:
        raise SystemExit(f"vlm: another image moves the logits by {min(rel)}, within the kernel "
                         f"path's error {err}")


def vlm_request(qparams, cfg, gen, dev):
    """The Generator (quant_mode "auto", decode through K1/K2) over a request
    with one image and one with two, 32 new tokens each: TTFT (the VLM
    prefill and the first sample) and decode tok/s."""
    import torch

    from paroquant_tpu_torch.serve import Generator, SamplingParams

    g = Generator(qparams, cfg, max_len=1024, quant_mode="auto", attn_mode="flash", device=dev)
    g.generate(vlm_prompt(cfg, gen, [8]), SamplingParams(max_tokens=4, temperature=0.0),
               pixel_values=vlm_pixels(gen, 1, dev))  # warm-up
    for texts in ([VLM_TEXT], [32, 32]):
        prompt, px = vlm_prompt(cfg, gen, texts), vlm_pixels(gen, len(texts), dev)
        torch.cuda.synchronize()
        res = g.generate(prompt, SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=0.0),
                         pixel_values=px)
        toks = res.token_ids
        ok = len(toks) == MOE_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in toks)
        emit({"phase": "vlm_request", "images": len(texts), "prompt_tokens": len(prompt),
              "new_tokens": len(toks), "ttft_ms": res.stats.ttft * 1e3,
              "decode_tok_s": res.stats.tokens_per_second, "ok": ok, "first_tokens": toks[:8]})
        if not ok:
            raise SystemExit(f"vlm: a {len(texts)}-image request returned {len(toks)} tokens")


def vlm_logprobs(params, cfg, prompt, toks, pixels, dev):
    """Each generated token's logprob in one contiguous VLM prefill of the
    prompt and the tokens (quant_mode "auto": the plain W4A16 path at M >
    128)."""
    import torch

    from paroquant_tpu_torch.models.vision import vlm_prefill

    seq = torch.tensor([prompt + toks], dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, _ = vlm_prefill(params, cfg, seq, pixels, quant_mode="auto")
    lp = torch.log_softmax(logits[0, len(prompt) - 1 : -1].float(), dim=-1)
    return lp.gather(-1, torch.tensor(toks, device=dev)[:, None])[:, 0].tolist()


def vlm_serve(qparams, cfg, gen, dev, hold_gaps, hold_move):
    """The Engine (8 slots, pages of 128, chunked prefill of 256, decode
    bursts of 8, prefix caching, bf16 pool) over 4 image requests (one
    image and 16-200 text tokens: each longer than the chunk, so prefilled
    whole; two share their tokens and differ by their image; sampled at
    temperature 1 from seeds, since a random model's greedy decode locks
    onto one repeated token whose logprob hardly depends on the context)
    and 4 greedy text requests of 16-512 tokens, 32 new tokens each,
    submitted together: tok/s and TTFT p50/p99 by kind. No prefix hit may
    fall on an image request. Each image request's logprobs lie within
    TOL_LOGPROB of `vlm_logprobs` (held with `hold_gaps`: at the logits
    check's depth) and a wrong image moves them by more than TOL_LOGPROB on
    average over the 4 requests (held with `hold_move`: at the served
    depth; a random LM's first 6 layers read an image too weakly, 0.02-0.10
    nats, for the move to show there). Each is recorded where not held.
    Returns the Engine and one image request's (prompt, pixels, tokens)."""
    import numpy as np
    import torch

    from paroquant_tpu_torch.serve import Engine, SamplingParams

    eng = Engine(qparams, cfg, max_batch=8, max_len=1024, page_size=128, prefill_chunk=256,
                 quant_mode="auto", decode_burst=8, prefix_caching=True, device=dev)
    twin = vlm_prompt(cfg, gen, [64])
    images = [(vlm_prompt(cfg, gen, [16]), vlm_pixels(gen, 1, dev)), (twin, vlm_pixels(gen, 1, dev)),
              (vlm_prompt(cfg, gen, [200]), vlm_pixels(gen, 1, dev)), (twin, vlm_pixels(gen, 1, dev))]
    texts = [(vlm_text(gen, n), None) for n in (16, 100, 300, 512)]
    sp = SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=0.0)
    eng.generate_sync(vlm_prompt(cfg, gen, [8]), SamplingParams(max_tokens=4, temperature=0.0),
                      pixel_values=vlm_pixels(gen, 1, dev))  # warm-up
    eng.generate_sync(vlm_text(gen, 200), SamplingParams(max_tokens=4, temperature=0.0))
    for key in eng.metrics:
        eng.metrics[key] = 0
    eng._ttfts.clear()
    eng._step_samples.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jobs = [(eng.submit(p, SamplingParams(max_tokens=MOE_NEW_TOKENS, temperature=1.0, seed=i),
                        pixel_values=px), p, px) for i, (p, px) in enumerate(images)]
    jobs += [(eng.submit(p, sp), p, None) for p, _ in texts]
    ticks = 0
    while eng.step():
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = []
    for r, p, px in jobs:
        toks = []
        while not r.out_queue.empty():
            kind, t = r.out_queue.get_nowait()
            if kind == "token":
                toks.append(t)
        if len(toks) != MOE_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
            raise SystemExit(f"vlm_serve: a {len(p)}-token prompt returned {len(toks)} tokens")
        out.append((r, p, px, toks))

    def ms(rs):
        a = [r.ttft * 1e3 for r, *_ in rs]
        return {"p50": statistics.median(a), "p99": float(np.percentile(a, 99)), "all": a}

    emit({"phase": "vlm_serve", "layers": cfg.num_hidden_layers, "quant_mode": "auto",
          "requests": len(jobs), "image_requests": len(images), "wall_s": wall, "ticks": ticks,
          "generated_tok_s": eng.metrics["tokens_generated"] / wall, "metrics": eng.metrics,
          "ttft_image_ms": ms(out[:4]), "ttft_text_ms": ms(out[4:]),
          "prompt_tokens": [len(p) for _, p, _, _ in out], "step_time": eng.step_time_stats()})
    if eng.metrics["prefix_hit_tokens"]:
        raise SystemExit(f"vlm_serve: a prefix-cache hit with no text prompt sharing a page: "
                         f"{eng.metrics}")
    gaps, moves = [], []
    for r, p, px, toks in out[:4]:
        if len(r.logprobs) != len(toks):
            raise SystemExit(f"vlm_serve: {len(r.logprobs)} logprobs for {len(toks)} tokens")
        ref = vlm_logprobs(qparams, cfg, p, toks, px, dev)
        gaps.append(max(abs(a - b) for a, b in zip(r.logprobs, ref)))
        wrong = vlm_logprobs(qparams, cfg, p, toks, vlm_pixels(gen, 1, dev), dev)
        moves.append(statistics.mean(abs(a - b) for a, b in zip(ref, wrong)))
    emit({"phase": f"vlm_serve_{cfg.num_hidden_layers}_layers_logprob_check", "requests": 4,
          "worst_gap": max(gaps), "gaps": gaps, "bound": TOL_LOGPROB, "held": hold_gaps,
          "wrong_image_mean_move": moves, "move_held": hold_move})
    if (hold_gaps and max(gaps) > TOL_LOGPROB) or (
            hold_move and statistics.mean(moves) <= TOL_LOGPROB):
        raise SystemExit(f"vlm_serve: image requests' logprobs off the contiguous prefill's by "
                         f"{max(gaps)} (bound {TOL_LOGPROB}; a wrong image moves them {moves})")
    r, p, px, toks = out[0]
    return eng, (p, px, toks)


def vlm_http(eng, request, dev):
    """One raw `pixel_values` request (prompt_token_ids and the image as
    nested JSON lists, about 2.4 M numbers) through the port's `Server`
    over the Engine, on its own thread: its tokens must be the Engine's
    for the same request (`generate_sync` before the thread starts, the
    same 8-slot step). Records the body's bytes, the seconds json.loads and
    the float32 array take on it, and the request's wall seconds."""
    import numpy as np

    from paroquant_tpu_torch.serve import SamplingParams
    from paroquant_tpu_torch.serve.api import Server

    prompt, px, _ = request
    sp = SamplingParams(max_tokens=HTTP_NEW_TOKENS, temperature=0.0)
    want = eng.generate_sync(prompt, sp, pixel_values=px)
    t0 = time.perf_counter()
    body = json.dumps({"prompt_token_ids": prompt, "pixel_values": px.cpu().numpy().tolist(),
                       "max_tokens": HTTP_NEW_TOKENS, "temperature": 0.0}).encode()
    dump_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = json.loads(body)
    loads_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr = np.asarray(parsed["pixel_values"], np.float32)
    array_s = time.perf_counter() - t0
    same_pixels = bool(np.array_equal(arr, px.cpu().numpy()))
    del parsed, arr
    server = Server(eng, "gemma-3-4b")
    eng.start()
    try:
        t0 = time.perf_counter()
        resp = server.handle("POST", "/v1/completions", body)
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    got = json.loads(resp.body)["choices"][0]["token_ids"] if resp.status == 200 else None
    emit({"phase": "vlm_http", "status": resp.status, "body_bytes": len(body),
          "numbers": int(px.numel()) + len(prompt), "json_dumps_s": dump_s,
          "json_loads_s": loads_s, "float32_array_s": array_s, "request_wall_s": wall,
          "tokens_equal": got == want, "same_pixels": same_pixels, "tokens": got})
    if resp.status != 200 or got != want or not same_pixels:
        raise SystemExit(f"vlm_http: {resp.status}, tokens {got} against the Engine's {want}")


def vlm_hf_tensors(params, cfg):
    """A dense VLM's params under transformers' Gemma3ForConditionalGeneration
    names (the LM under model.language_model, [out, in] weights, the patch
    embedding [D, C, p, p]); tied embeddings, so no lm_head."""
    from paroquant_tpu_torch.models.vision import VisionConfig

    lm, t = "model.language_model", {}
    t[f"{lm}.embed_tokens.weight"] = params["embed_tokens"]
    t[f"{lm}.norm.weight"] = params["norm"]
    for i, lp in enumerate(params["layers"]):
        b = f"{lm}.layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                  "post_feedforward_layernorm"):
            t[f"{b}.{n}.weight"] = lp[n]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            t[f"{b}.self_attn.{n}.weight"] = lp[n].w.T
        for n in ("q_norm", "k_norm"):
            t[f"{b}.self_attn.{n}.weight"] = lp[n]
        for n in ("gate_proj", "up_proj", "down_proj"):
            t[f"{b}.mlp.{n}.weight"] = lp["mlp"][n].w.T
    vc, v = VisionConfig.from_hf_dict(cfg.vision), params["vision"]
    vt = "model.vision_tower.vision_model"
    t[f"{vt}.embeddings.patch_embedding.weight"] = v["patch_embed_w"].T.reshape(
        vc.hidden_size, vc.num_channels, vc.patch_size, vc.patch_size)
    t[f"{vt}.embeddings.patch_embedding.bias"] = v["patch_embed_b"]
    t[f"{vt}.embeddings.position_embedding.weight"] = v["pos_embed"]
    t[f"{vt}.post_layernorm.weight"], t[f"{vt}.post_layernorm.bias"] = v["post_ln_w"], v["post_ln_b"]
    for i, lp in enumerate(v["layers"]):
        b = f"{vt}.encoder.layers.{i}"
        for j in (1, 2):
            t[f"{b}.layer_norm{j}.weight"], t[f"{b}.layer_norm{j}.bias"] = lp[f"ln{j}_w"], lp[f"ln{j}_b"]
        for n, name in (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                        ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.out_proj"),
                        ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            t[f"{b}.{name}.weight"], t[f"{b}.{name}.bias"] = lp[n].w.T, lp[n].b
    mp = "model.multi_modal_projector"
    t[f"{mp}.mm_input_projection_weight"] = params["projector"]["mm_input_projection"]
    t[f"{mp}.mm_soft_emb_norm.weight"] = params["projector"]["mm_soft_emb_norm"]
    return t


def vlm_checkpoint(tmp, gen, dev):
    """A dense bf16 Gemma 3 4B at VLM_CKPT_LAYERS LM layers with its whole
    tower (`vlm_dense`), written as an HF-named directory (`write_safetensors`,
    the nested config.json) and loaded through load_checkpoint: the same
    config, and the VLM prefill's logits of the in-memory model bit for bit."""
    import torch

    from paroquant_tpu_torch.convert import load_checkpoint
    from paroquant_tpu_torch.convert.checkpoint import write_safetensors
    from paroquant_tpu_torch.models.vision import vlm_prefill

    cfg = vlm_config(VLM_CKPT_LAYERS)
    params = vlm_dense(cfg, VLM_SEED + 1, dev)
    d = tmp / "gemma-3-4b-hf"
    d.mkdir()
    t0 = time.perf_counter()
    write_safetensors(d / "model.safetensors", vlm_hf_tensors(params, cfg))
    text = dict(GEMMA3_4B["text_config"], num_hidden_layers=VLM_CKPT_LAYERS,
                layer_types=GEMMA3_4B["text_config"]["layer_types"][:VLM_CKPT_LAYERS])
    (d / "config.json").write_text(json.dumps(dict(GEMMA3_4B, text_config=text)))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, lcfg = load_checkpoint(d, device=dev)
    load_s = time.perf_counter() - t0
    tokens = torch.tensor([vlm_prompt(cfg, gen, [VLM_TEXT])], dtype=torch.int32, device=dev)
    px = vlm_pixels(gen, 1, dev)
    with torch.no_grad():
        la, _ = vlm_prefill(loaded, lcfg, tokens, px, quant_mode="xla")
        ma, _ = vlm_prefill(params, cfg, tokens, px, quant_mode="xla")
    row = {"phase": "vlm_checkpoint", "layers": VLM_CKPT_LAYERS,
           "tower_layers": len(loaded.get("vision", {}).get("layers", [])),
           "file_bytes": (d / "model.safetensors").stat().st_size, "save_s": save_s,
           "load_s": load_s, "config_equal": lcfg == cfg,
           "max_abs_err": (la - ma).abs().max().item(), "bound": 0.0,
           "finite": bool(torch.isfinite(la).all())}
    emit(row)
    if row["max_abs_err"] != 0.0 or not row["finite"] or not row["config_equal"] or (
            row["tower_layers"] != GEMMA3_4B["vision_config"]["num_hidden_layers"]):
        raise SystemExit(f"vlm: the HF directory loads to another model: {row}")
    del params, loaded
    torch.cuda.empty_cache()


def vlm_paths(tmp, dev):
    """The Gemma 3 VLM at Gemma 3 4B's full width (`vlm_model`, all
    VLM_LAYERS layers and the 27-layer tower): the profiled VLM prefill,
    the logits and image checks, the Generator's image requests, the
    Engine's mix of image and text requests (its logprobs held at the
    logits check's depth), a raw `pixel_values` request over the HTTP
    server, and the HF directory's load. Counts reset just before, read
    just after: K1, K2 and K4 must run."""
    import torch

    from paroquant_tpu_torch.kernels import rot_matmul as rm

    reset_counts()
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(VLM_SEED)
    qparams, cfg = vlm_model(dev, VLM_LAYERS)
    prompt = vlm_prompt(cfg, gen, [VLM_TEXT])
    px, other = vlm_pixels(gen, 1, dev), vlm_pixels(gen, 1, dev)
    tokens = torch.tensor([prompt + vlm_text(gen, 8)], dtype=torch.int32, device=dev)
    vlm_prefill_profile(qparams, cfg, tokens[:, : len(prompt)], px, dev)
    (hp, hcfg), err, auto = vlm_logits_check(qparams, cfg, tokens, px, len(prompt), dev)
    vlm_image_check(hp, hcfg, tokens, other, len(prompt), err, auto, dev)
    vlm_request(qparams, cfg, gen, dev)
    held = hcfg.num_hidden_layers == cfg.num_hidden_layers
    eng, request = vlm_serve(qparams, cfg, gen, dev, hold_gaps=held, hold_move=True)
    vlm_http(eng, request, dev)
    del eng
    if not held:
        vlm_serve(hp, hcfg, gen, dev, hold_gaps=True, hold_move=False)
    routes = check_routes(rm, "vlm_paths")
    del qparams, hp
    torch.cuda.empty_cache()
    vlm_checkpoint(tmp, gen, dev)
    launched = port_launches()
    emit({"phase": "vlm_paths_launches", **launched, "routes_checked": routes,
          "s": time.perf_counter() - t0})
    missing = [k for k in ("rot_w4_matmul", "merged_rot_w4_matmul", "paged_decode_attention")
               if not launched["counts"].get(k)]
    if missing:
        raise SystemExit(f"vlm_paths: kernels not launched: {missing}")
    torch.cuda.empty_cache()
    return launched["counts"]


def http_call(url, method, path, body=None, stream=False):
    """(status, headers, body bytes, seconds to the first body bytes, seconds
    in all) of one call on a fresh connection, within HTTP_TIMEOUT."""
    import http.client

    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        first = r.read1(1 << 16) if stream else b""
        t_first = time.perf_counter() - t0
        data = first + r.read()
        return r.status, dict(r.getheaders()), data, t_first, time.perf_counter() - t0
    finally:
        conn.close()


def sse_tokens(data: bytes) -> tuple:
    """(token ids, finish reason) of a token-ids-only SSE stream."""
    toks, reason = [], None
    for block in data.decode().split("\n\n"):
        if not block or block == "data: [DONE]":
            continue
        choice = json.loads(block[len("data: "):])["choices"][0]
        toks += choice.get("token_ids", [])
        reason = choice["finish_reason"] or reason
    return toks, reason


def greedy_deficits(params, cfg, prompt, toks, quant_mode) -> tuple:
    """(deficits, top-two gaps) at each of `toks`' positions, from one
    prefill of prompt + toks: how far each token's logprob sits below its
    prefix's top one, and the gap between the two most likely tokens."""
    import torch

    from paroquant_tpu_torch.models.decoder import model_forward

    dev = params["embed_tokens"].device
    with torch.no_grad():
        logits, _ = model_forward(params, cfg, torch.tensor([prompt + toks], device=dev),
                                  quant_mode=quant_mode)
    lp = torch.log_softmax(logits[0, len(prompt) - 1:-1].float(), -1)
    top = torch.topk(lp, 2, dim=-1).values
    chosen = lp.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0]
    return (top[:, 0] - chosen).tolist(), (top[:, 0] - top[:, 1]).tolist()


def check_greedy(runs, prompts, params, cfg, quant_mode, phase) -> dict:
    """runs: {name: tokens of each prompt}, the first the reference. Every
    token of every run must be its prefix's greedy choice up to a near-tie
    (NEAR_TIE_NATS) in a prefill of the run's own sequence, so a token
    dropped, repeated or out of order anywhere fails, also after two runs
    part. The runs must have the reference's lengths, and the median top-two
    gap must exceed NEAR_TIE_NATS. Returns each run's worst deficit and
    first fork from the reference, and the gaps' median."""
    ref = next(iter(runs.values()))
    out, gaps = {}, []
    for name, seqs in runs.items():
        worst, forks = 0.0, []
        for p, toks, r in zip(prompts, seqs, ref):
            if len(toks) != len(r):
                raise SystemExit(f"{phase} {name}: {len(toks)} tokens, not {len(r)}")
            deficits, top2 = greedy_deficits(params, cfg, p, toks, quant_mode)
            worst = max(worst, *deficits)
            gaps += top2 if seqs is ref else []
            forks.append(next((i for i, (x, y) in enumerate(zip(toks, r)) if x != y), None))
        out[name] = {"worst_deficit": worst, "forks": forks}
    out["median_top_two_gap"] = statistics.median(gaps)
    out["share_gaps_below_limit"] = sum(g <= NEAR_TIE_NATS for g in gaps) / len(gaps)
    emit({"phase": f"{phase} greedy", "limit": NEAR_TIE_NATS, **out})
    bad = {k: v["worst_deficit"] for k, v in out.items()
           if isinstance(v, dict) and v["worst_deficit"] > NEAR_TIE_NATS}
    if bad or out["median_top_two_gap"] <= NEAR_TIE_NATS:
        raise SystemExit(f"{phase}: tokens off the greedy choice {bad}, or near-ties too common "
                         f"for the check ({out})")
    return out


def http_prompts(cfg):
    """8 prompts of 16 to 1000 tokens; two repeat a block, so prompt lookup
    finds drafts (K5)."""
    import torch

    g = torch.Generator().manual_seed(31)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    return [rand(16), rand(24) * 8, rand(100), rand(300), rand(32) * 10, rand(550), rand(800),
            rand(1000)]


def serve_http(paro_dir, dev):
    """Serving over HTTP: `cli/serve.build` on the 28-layer PARO-TPU
    directory of `convert_paths` (spec_k 4, prefix caching, 8 slots; the
    checkpoint's layout, unmerged with a dense tied head, as JAX serves it:
    K1, K3, K4, K5), served on a loopback port from a thread. /health,
    /v1/models, /metrics; 8 concurrent greedy completions by
    prompt_token_ids (HTTP_NEW_TOKENS each) not streamed (with logprobs), then
    streamed, then submitted to the Engine directly: every token of every
    round is its prefix's greedy choice up to a near-tie (check_greedy), the
    logprobs within TOL_LOGPROB of Engine.score_sync; the Engine's own round
    first, so that every timed round finds the prompts' pages cached; each
    streamed request's first SSE bytes against its own Request's first
    token, on one clock; n 2 with a seed; echo scoring; a 429 from a --max-queue 1 server; chat with
    a stop string on a Server over the ByteTokenizer; an EngineRouter over two Engines on the card sharing
    one merged copy of the weights with a W4 lm_head (K2 and RA8), whose
    greedy outputs are greedy choices as one Engine's are. Counts reset just
    before and read just after: K1-K5 must run; every client call finishes
    within HTTP_TIMEOUT and every engine thread is alive at the end."""
    import concurrent.futures as cf

    import torch

    from paroquant_tpu_torch.cli import serve as cli_serve
    from paroquant_tpu_torch.convert.rtn import quantize_linear_rtn
    from paroquant_tpu_torch.kernels import rot_matmul as rm
    from paroquant_tpu_torch.models import merge_projections
    from paroquant_tpu_torch.models.decoder import DenseLinear
    from paroquant_tpu_torch.serve import Engine, EngineRouter, SamplingParams
    from paroquant_tpu_torch.serve.api import Server

    t_phase = time.perf_counter()
    base = ["--model", str(paro_dir), "--host", "127.0.0.1", "--port", "0", "--max-len", "2048",
            "--device", dev.type]
    server, args = cli_serve.build(base + ["--spec-k", "4", "--prefix-caching", "--max-batch", "8"])
    eng, cfg = server.engine, server.engine.config
    engines = [eng]
    prompts = http_prompts(cfg)
    greedy = {"max_tokens": HTTP_NEW_TOKENS, "temperature": 0.0}
    calls = []

    def call(url, method, path, body=None, stream=False):
        status, headers, data, t_first, t_all = http_call(url, method, path, body, stream)
        calls.append(t_all)
        return status, headers, data, t_first

    reset_counts()
    eng.start()
    row = {"phase": "serve_http", "quant_mode": args.quant_mode, "decode_burst": args.decode_burst}
    with server.serving() as url, cf.ThreadPoolExecutor(8) as pool:
        for path in ("/health", "/v1/models", "/metrics"):
            status, _, data, _ = call(url, "GET", path)
            if status != 200:
                raise SystemExit(f"serve_http: GET {path} gave {status}: {data[:200]}")
        row["models"] = json.loads(call(url, "GET", "/v1/models")[2])["data"][0]["id"]

        def completion(p, stream):
            body = {"prompt_token_ids": p, **greedy, "stream": stream}
            if not stream:
                # each token's logprob; no top ones, which would turn the
                # request's speculation off and so change its arithmetic
                body["logprobs"] = True
            t_start = time.perf_counter()
            return (*call(url, "POST", "/v1/completions", body, stream), t_start)

        def engine_round():
            """The same requests submitted to the Engine itself."""
            t0 = time.perf_counter()
            reqs = [eng.submit(p, SamplingParams(**greedy)) for p in prompts]
            toks = []
            for r in reqs:
                out = []
                while (item := r.out_queue.get(timeout=HTTP_TIMEOUT))[0] != "done":
                    out.append(item[1])
                toks.append(out)
            wall = time.perf_counter() - t0
            return {"tokens": toks, "wall_s": wall, "tok_s": sum(len(t) for t in toks) / wall,
                    "ttft_ms": sorted(r.ttft * 1e3 for r in reqs)}

        def recording_submit(prompt_tokens, *args, **kw):
            req = Engine.submit(eng, prompt_tokens, *args, **kw)
            submitted[tuple(prompt_tokens)] = req
            return req

        rounds = {"engine_cold": engine_round()}  # fills the prefix cache
        for name, stream in (("http", False), ("http_stream", True)):
            submitted = {}  # the Server's Requests by prompt, to pair timings per request
            eng.submit = recording_submit
            t0 = time.perf_counter()
            try:
                answers = list(pool.map(lambda p: completion(p, stream), prompts))
            finally:
                del eng.submit
            wall = time.perf_counter() - t0
            if any(a[0] != 200 for a in answers):
                raise SystemExit(f"serve_http: {[a[0] for a in answers]}")
            reqs = [submitted[tuple(p)] for p in prompts]
            if stream:
                outs = [sse_tokens(a[2]) for a in answers]
                # per request, on the process's one clock: client send to
                # Engine enqueue, the Engine's TTFT, and its first token to
                # the client's first SSE bytes
                rounds[name] = {
                    "tokens": [o[0] for o in outs], "finish": [o[1] for o in outs],
                    "submit_ms": [(r.enqueue_time - a[4]) * 1e3 for r, a in zip(reqs, answers)],
                    "ttft_ms": [r.ttft * 1e3 for r in reqs],
                    "first_bytes_after_first_token_ms": [
                        (a[4] + a[3] - r.first_token_time) * 1e3 for r, a in zip(reqs, answers)]}
            else:
                choices = [json.loads(a[2])["choices"][0] for a in answers]
                rounds[name] = {"tokens": [c["token_ids"] for c in choices],
                                "finish": [c["finish_reason"] for c in choices],
                                "lps": [c["logprobs"]["token_logprobs"] for c in choices]}
            n_tok = sum(len(t) for t in rounds[name]["tokens"])
            rounds[name].update(wall_s=wall, tok_s=n_tok / wall,
                                client_first_bytes_ms=[a[3] * 1e3 for a in answers])
        rounds["engine"] = engine_round()
        ref = rounds["http"]
        if any(len(t) != HTTP_NEW_TOKENS for t in ref["tokens"]) or set(ref["finish"]) != {"length"}:
            raise SystemExit(f"serve_http: {ref['finish']}, {[len(t) for t in ref['tokens']]}")
        row["greedy"] = check_greedy(
            {k: rounds[k]["tokens"] for k in ("http", "http_stream", "engine", "engine_cold")},
            prompts, eng.params, cfg, eng.quant_mode, "serve_http")
        gaps = [max(abs(a - b) for a, b in zip(lps, eng.score_sync(p + toks)[len(p):]))
                for p, toks, lps in zip(prompts, ref["tokens"], ref["lps"])]
        row["logprob_worst_gap"] = max(gaps)
        if max(gaps) > TOL_LOGPROB:
            raise SystemExit(f"serve_http: logprobs off score_sync by {gaps}")
        metrics = json.loads(call(url, "GET", "/metrics")[2])
        row.update({f"{k}_{m}": v for k, r in rounds.items() for m, v in r.items()
                    if m not in ("tokens", "finish", "lps")})
        row["metrics"] = metrics

        # n 2 with a seed: two draws, the same again
        body = {"prompt_token_ids": prompts[2], "n": 2, "max_tokens": 16, "temperature": 0.8,
                "seed": 7}
        a, b = (json.loads(call(url, "POST", "/v1/completions", body)[2])["choices"]
                for _ in range(2))
        row["n2_lengths"] = [len(c["token_ids"]) for c in a]
        if ([c["token_ids"] for c in a] != [c["token_ids"] for c in b]
                or a[0]["token_ids"] == a[1]["token_ids"] or row["n2_lengths"] != [16, 16]):
            raise SystemExit(f"serve_http: n 2 with a seed: {a}, {b}")
        # echo scoring: the prompt's logprobs, Engine.score_sync's
        status, _, data, _ = call(url, "POST", "/v1/completions", {
            "prompt_token_ids": prompts[3], "echo": True, "max_tokens": 0, "logprobs": 1})
        lps = json.loads(data)["choices"][0]["logprobs"]["token_logprobs"]
        want = eng.score_sync(prompts[3])
        row["echo_worst_gap"] = max(abs(x - y) for x, y in zip(lps[1:], want[1:]))
        if status != 200 or lps[0] is not None or row["echo_worst_gap"] > TOL_LOGPROB:
            raise SystemExit(f"serve_http: echo {status}, {row['echo_worst_gap']}")
    shared = server.engine.params

    # a --max-queue 1 server: its engine not started, one request fills the queue
    full, _ = cli_serve.build(base + ["--max-queue", "1"])
    blocker = full.engine.submit(prompts[0], SamplingParams(max_tokens=2, temperature=0.0))
    with full.serving() as url:
        status, headers, data, _ = call(url, "POST", "/v1/completions",
                                        {"prompt_token_ids": prompts[0], "max_tokens": 2})
    full.engine.cancel(blocker)
    row["overloaded"] = [status, headers.get("Retry-After")]
    if row["overloaded"] != [429, "1"]:
        raise SystemExit(f"serve_http: a full queue gave {status} {headers}: {data}")
    del full, blocker

    # chat with a stop string, over the ByteTokenizer; the bias keeps the
    # greedy answer to lowercase letters
    chat = Engine(shared, cfg, ByteTokenizer(), max_batch=2, max_len=1024, device=dev)
    engines.append(chat)
    chat.start()
    body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 24,
            "temperature": 0.0, "logit_bias": {str(c): 30.0 for c in range(97, 123)}}
    with Server(chat, "chat").serving() as url:
        text = json.loads(call(url, "POST", "/v1/chat/completions", body)[2])
        text = text["choices"][0]["message"]["content"]
        stop = text[6:8]
        want = text[:text.find(stop)]
        got = json.loads(call(url, "POST", "/v1/chat/completions", {**body, "stop": stop})[2])
        streamed = call(url, "POST", "/v1/chat/completions", {**body, "stop": stop, "stream": True},
                        stream=True)[2]
    events = [json.loads(b[len("data: "):]) for b in streamed.decode().split("\n\n")
              if b and b != "data: [DONE]"]
    row["chat"] = {"text": text, "stop": stop, "stopped_text": got["choices"][0]["message"]["content"],
                   "finish": got["choices"][0]["finish_reason"],
                   "streamed_text": "".join(e["choices"][0]["delta"]["content"] for e in events),
                   "stream_finish": events[-1]["choices"][0]["finish_reason"]}
    c = row["chat"]
    if (len(text) != 24 or not text.isalpha() or c["stopped_text"] != want or c["finish"] != "stop"
            or c["streamed_text"] != want or c["stream_finish"] != "stop"):
        raise SystemExit(f"serve_http: chat with a stop string: {c}")

    # an EngineRouter over two Engines sharing one merged copy of the weights
    # with a W4 lm_head: its greedy outputs are one Engine's
    merged = merge_projections(dict(shared, lm_head=quantize_linear_rtn(
        DenseLinear(shared["embed_tokens"].T, None), hadamard=True, seed=10_000)), cfg)
    pair = [Engine(merged, cfg, max_batch=4, max_len=2048, decode_burst=8, device=dev)
            for _ in range(2)]
    engines += pair
    sp = SamplingParams(max_tokens=32, temperature=0.0)
    four = prompts[2:6]
    solo = [pair[0].submit(p, sp) for p in four]
    while pair[0].step():
        pass
    solo_toks = [[t for kind, t in iter(r.out_queue.get_nowait, ("done", None))] for r in solo]
    before = [e.metrics["requests"] for e in pair]
    router = EngineRouter(pair)
    router.start()
    with Server(router, "router").serving() as url:
        body = {"max_tokens": 32, "temperature": 0.0}
        answers = list(cf.ThreadPoolExecutor(4).map(lambda p: json.loads(call(
            url, "POST", "/v1/completions", {"prompt_token_ids": p, **body})[2]), four))
        rmetrics = json.loads(call(url, "GET", "/metrics")[2])
    got = [a["choices"][0]["token_ids"] for a in answers]
    row["greedy_router"] = check_greedy({"engine": solo_toks, "router": got}, four, merged, cfg,
                                        "auto", "serve_http router")
    row["router_requests"] = [e.metrics["requests"] - b for e, b in zip(pair, before)]
    row["router_replicas"] = rmetrics["replicas"]
    if rmetrics["replicas"] != 2 or min(row["router_requests"]) == 0:
        raise SystemExit(f"serve_http: router placement {row['router_requests']}")

    launched = port_launches()
    routes = check_routes(rm, "serve_http")
    row.update(calls=len(calls), slowest_call_s=max(calls), threads_alive=[
        e._thread.is_alive() for e in engines], launches=launched, routes=routes,
        s=time.perf_counter() - t_phase, card=card())
    emit(row)
    for e in engines:
        e.stop()
    missing = [k for k in SLICE1_W4 + ("flash_attention", "paged_decode_attention",
                                      "paged_window_attention_kernel")
               if not launched["counts"].get(k)]
    if missing or not all(row["threads_alive"]):
        raise SystemExit(f"serve_http: kernels not launched {missing} or an engine thread died: "
                         f"{row['threads_alive']}")
    del server, chat, pair, router, merged, shared
    torch.cuda.empty_cache()


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
    t_start = t_mark = time.perf_counter()

    def mark(name):
        """A `phase_seconds` line: the seconds since the last mark and since
        the start, so that a phase's share of the time limit is on record."""
        nonlocal t_mark
        now = time.perf_counter()
        emit({"phase": "phase_seconds", "name": name, "s": now - t_mark, "total_s": now - t_start})
        t_mark = now

    smi = card()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit(smi)

    from paroquant_tpu_torch.kernels import build

    build.build_all()
    emit({"phase": "build", **build.build_info})
    mark("build")
    report = build.ptxas_report()
    emit({"phase": "ptxas", "lines": report.splitlines()})
    check_flash_spills(report)
    check_rot_spills(report)
    prefetch_sass()
    # the tensor-core instructions of K15 and K16 (IMMA, three row tilings
    # each, with their ring's 16-byte cp.async, LDGSTS) and K17 (HMMA), with
    # K16's former kernel (int8_dot_kernel) gone, and K15's SASS as it was
    # before K16 joined its kernel; K18's bulk copies (UBLKCP: cp.async.bulk
    # into shared memory) for f32 and bf16 x
    k15, k16 = r"int8_stream_kernelILi\dELb0E", r"int8_stream_kernelILi\dELb1E"
    check_sass("libint8_probe.so", ("IMMA", "HMMA", "LDGSTS"),
               ((k15, "IMMA", 3), (k15, "LDGSTS", 3), (k16, "IMMA", 3), (k16, "LDGSTS", 3),
                ("bf16_dot_kernel", "HMMA", 3)), absent=("int8_dot_kernel",))
    check_k15_sass()
    check_descriptors()
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
    mark("sass")

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(123)
    mm_rows = (check_matmuls(flush, gen, dev)
               + check_decode_matmuls(flush, gen, dev, "hybrid", HYBRID_MATMULS)
               + check_decode_matmuls(flush, gen, dev, "gemma-3n-e4b", GEMMA3N_MATMULS)
               + check_decode_matmuls(flush, gen, dev, "gemma-3-4b", GEMMA3_MATMULS))
    fa_rows = (check_flash(flush, gen, dev) + check_flash_mixed(flush, gen, dev)
               + check_flash(flush, gen, dev, GEMMA3N_FLASH_CASES, D=256, scale=1.0))
    pa_rows = (check_paged(flush, gen, dev) + check_paged_step(flush, gen, dev)
               + check_paged_rows(flush, gen, dev) + check_paged_f32_queries(flush, gen, dev)
               + check_paged(flush, gen, dev, GEMMA3N_PAGED_CASES)
               + check_paged(flush, gen, dev, GEMMA3_PAGED_CASES))
    w4_rows = check_w4_variants(flush, gen, dev)
    w4x_rows = check_w4_experiments(flush, gen, dev)
    i8_rows = check_int8_probe(flush, gen, dev)
    ux_rows = check_unpack_exp(flush, dev)
    edge_rows = check_edges(gen, dev)
    bad = [r for r in mm_rows + fa_rows + pa_rows + w4_rows + w4x_rows + i8_rows + ux_rows
           + edge_rows if not r["ok"]]
    if bad:
        raise SystemExit(f"{len(bad)} kernel checks missed their tolerance")
    mark("kernel_checks")
    del flush
    bench_counts = kernel_bench(dev)  # slice 3: the kernel benchmarks (K1, K6-K9)
    exp_counts = w4_experiments(dev)  # slice 4: the experiment scripts (K10-K13)
    probe_counts = int8_probe(dev)  # slice 5: the int8 tensor-core probe (K14-K17)
    unpack_counts = unpack_exp(dev)  # slice 6: the unpack experiments (K18-K22)
    mark("slices_3_6")
    serve_head_dims(dev)  # K3-K5 at head dims 32 and 256, 80 rows
    mark("serve_head_dims")

    qparams, cfg = qwen3_model(dev)
    counts = main_path(qparams, cfg, dev)  # slice 1: the Generator (K1-K3)
    mark("main_path")
    counts.update({k: v for k, v in serve(qparams, cfg, dev).items()  # slice 2: the Engine (K1-K5)
                   if k.startswith("paged")})
    serve(qparams, cfg, dev, kv_quant="int8")
    check_paged_logits(qparams, cfg, dev)
    check_paged_decode_has_no_sync(qparams, cfg, dev)

    from paroquant_tpu_torch.utils.profiling import profile_paged_decode

    emit({"phase": "paged_decode_profile", "batch": 8, "context": 256, "quant_mode": "auto",
          **profile_paged_decode(qparams, cfg, batch=8, context=256, steps=16, device=dev)})
    mark("serve")
    measurement_paths(root, qparams, cfg, dev)  # slice 20: bench, bursts, speculation, scripts
    mark("measurement_paths")
    del qparams
    torch.cuda.empty_cache()
    bench_scripts(dev)  # slice 21: bench_7b, decode accounting, kv quant, serving, a8 accuracy
    mark("bench_scripts")
    user_paths(dev)  # native packer, AWQ load, evaluate, chat, bench_longcontext
    mark("user_paths")
    with tempfile.TemporaryDirectory(prefix="paro_convert_") as tmp:
        paro_dir = convert_paths(Path(tmp), dev)  # RTN / GPTQ checkpoints written and loaded
        mark("convert_paths")
        serve_http(paro_dir, dev)  # the OpenAI API over HTTP, the router
        mark("serve_http")
        calibrate_paths(Path(tmp), dev)  # calibration, its CLIs and its bench
        mark("calibrate_paths")
        moe_paths(Path(tmp), dev)  # the MoE family at Qwen3-30B-A3B width
        mark("moe_paths")
        hybrid_counts = hybrid_paths(Path(tmp), dev)  # the qwen3_next hybrid at Qwen3-Next-80B-A3B width
        mark("hybrid_paths")
        gemma3n_counts = gemma3n_paths(Path(tmp), dev)  # the gemma3n family at Gemma 3n E4B width
        mark("gemma3n_paths")
        vlm_counts = vlm_paths(Path(tmp), dev)  # the Gemma 3 VLM at Gemma 3 4B width
        mark("vlm_paths")

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
                "hybrid_paths_launches": hybrid_counts.get(name, 0),
                "gemma3n_paths_launches": gemma3n_counts.get(name, 0),
                "vlm_paths_launches": vlm_counts.get(name, 0),
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
