"""Calibration token blocks: the port's copy of `paroquant_tpu/optim/data.py`.

Token-block packing (tokenize documents, concatenate, cut into [n_samples,
seqlen] blocks), even mixing of several datasets and a seeded shuffle,
all numpy, with the same draws as JAX's in the same order. Dataset names
match the reference recipes (pileval, wikitext2, c4, redpajama, read with
the `datasets` package), plus `synthetic` (uniform random tokens) and
`file:<path>` (a local .txt or .jsonl corpus, shuffled by document) for
machines without the hub's datasets.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

DATASET_SPECS = {
    "pileval": ("mit-han-lab/pile-val-backup", None, "validation", "text"),
    "wikitext2": ("wikitext", "wikitext-2-raw-v1", "train", "text"),
    "c4": ("allenai/c4", "en", "train", "text"),
    "redpajama": ("togethercomputer/RedPajama-Data-1T-Sample", None, "train", "text"),
}


def _pack_blocks(token_stream: list[int], n_samples: int, seqlen: int) -> np.ndarray:
    total = n_samples * seqlen
    if len(token_stream) < total:
        reps = total // max(len(token_stream), 1) + 1
        token_stream = (token_stream * reps)[:total]
    return np.asarray(token_stream[:total], np.int32).reshape(n_samples, seqlen)


def get_calib_dataset(
    name: str,
    tokenizer,
    n_samples: int,
    seqlen: int,
    seed: int = 0,
    vocab_size: int = 32000,
) -> np.ndarray:
    """Returns [n_samples, seqlen] int32."""
    if name == "synthetic":
        rng = np.random.default_rng(seed)
        return rng.integers(0, vocab_size, (n_samples, seqlen)).astype(np.int32)
    if tokenizer is None:
        raise ValueError(f"dataset {name} needs a tokenizer")
    if name.startswith("file:"):
        return _file_calib_dataset(name[5:], tokenizer, n_samples, seqlen, seed)
    from datasets import load_dataset

    repo, subset, split, field = DATASET_SPECS[name]
    if name == "c4":
        ds = load_dataset(
            repo, data_files={"train": "en/c4-train.00000-of-01024.json.gz"}, split="train"
        )
    else:
        ds = load_dataset(repo, subset, split=split)
    rng = np.random.default_rng(seed)
    stream: list[int] = []
    for i in rng.permutation(len(ds)):
        text = ds[int(i)][field]
        if not text:
            continue
        stream.extend(tokenizer(text).input_ids)
        if len(stream) >= n_samples * seqlen:
            break
    return _pack_blocks(stream, n_samples, seqlen)


def _file_calib_dataset(
    path: str, tokenizer, n_samples: int, seqlen: int, seed: int
) -> np.ndarray:
    """A local corpus: .jsonl / .ndjson ({"text": ...} a line) or plain text
    (documents separated by blank lines), shuffled by document before packing."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"calibration corpus not found: {path}")
    docs: list[str] = []
    if p.suffix in (".jsonl", ".ndjson"):
        for line in p.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            text = row.get("text") if isinstance(row, dict) else None
            if text:
                docs.append(text)
    else:
        docs = [d.strip() for d in p.read_text().split("\n\n") if d.strip()]
    if not docs:
        raise ValueError(f"no documents in {path}")
    rng = np.random.default_rng(seed)
    stream: list[int] = []
    for i in rng.permutation(len(docs)):
        stream.extend(tokenizer(docs[int(i)]).input_ids)
        if len(stream) >= n_samples * seqlen:
            break
    return _pack_blocks(stream, n_samples, seqlen)


def get_mixed_calib_dataset(
    names: list[str],
    tokenizer,
    n_samples: int,
    seqlen: int,
    seed: int = 0,
    vocab_size: int = 32000,
) -> np.ndarray:
    """Even mixing across datasets, then a seeded shuffle of the blocks."""
    if len(names) == 1:
        return get_calib_dataset(names[0], tokenizer, n_samples, seqlen, seed, vocab_size)
    per = n_samples // len(names)
    parts = []
    for j, name in enumerate(names):
        take = per if j < len(names) - 1 else n_samples - per * (len(names) - 1)
        parts.append(get_calib_dataset(name, tokenizer, take, seqlen, seed + j, vocab_size))
    blocks = np.concatenate(parts, axis=0)
    rng = np.random.default_rng(seed)
    return blocks[rng.permutation(len(blocks))]
