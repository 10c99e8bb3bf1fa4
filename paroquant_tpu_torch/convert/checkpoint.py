"""Checkpoint loading: PARO-TPU and HF-dense directories of the dense families.

Counterpart of the load side of `paroquant_tpu/convert/checkpoint.py`
(`load_checkpoint`, :476). The safetensors format is read here directly,
without the `safetensors` package: an 8-byte little-endian header length, a
JSON header mapping each name to its dtype, shape and byte range, then the
raw buffer, viewed with `torch.frombuffer` (BF16 included).

AWQ-format import and the save side wait for later slices.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any

import torch

from ..models.config import ModelConfig, from_hf_dict
from ..models.decoder import DenseLinear, _unsupported
from ..ops.packing import unpack_w4_tpu
from ..ops.qlinear import make_quantized_linear
from ..utils.device import resolve_device

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """All tensors of one .safetensors file, on the CPU."""
    data = bytearray(Path(path).read_bytes())
    (n,) = struct.unpack("<Q", bytes(data[:8]))
    header = json.loads(bytes(data[8 : 8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        dt = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        numel = 1
        for d in shape:
            numel *= d
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        itemsize = torch.empty((), dtype=dt).element_size()
        if end - start != numel * itemsize:
            raise ValueError(f"{path}: tensor {name} byte range does not match its shape")
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - start, offset=base + start)
        out[name] = raw.clone().view(dt).reshape(shape)
    return out


def _open_all(model_dir: Path) -> dict[str, torch.Tensor]:
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    tensors: dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return {k.replace("language_model.", ""): v for k, v in tensors.items()}


def load_checkpoint(
    model_dir: str | Path, rot_dtype=torch.bfloat16, dtype=torch.bfloat16, device="cuda",
) -> tuple[dict[str, Any], ModelConfig]:
    """Load a PARO-TPU or plain HF-dense model directory onto `device`."""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    config = from_hf_dict(json.loads((model_dir / "config.json").read_text()))
    _unsupported(config)
    if config.is_vlm:
        raise NotImplementedError("VLM checkpoints come with slice 3 of the port")
    tensors = _open_all(model_dir)

    qc = config.quantization or {}
    is_quant = qc.get("quant_method") in ("paroquant", "awq")
    fmt = qc.get("format", "awq" if qc.get("quant_method") else None)
    if is_quant and fmt != "paro-tpu":
        raise NotImplementedError("AWQ-format checkpoints come with the AWQ import of the port")
    group_size = int(qc.get("group_size", 128))
    n_bits = int(qc.get("bits", 4))

    def dense(name):
        return tensors[name].to(device=dev, dtype=dtype)

    def dense_linear(prefix):
        w = tensors[f"{prefix}.weight"].T.contiguous().to(device=dev, dtype=dtype)
        bk = f"{prefix}.bias"
        b = tensors[bk].to(device=dev, dtype=torch.float32) if bk in tensors else None
        return DenseLinear(w, b)

    def quant_linear(prefix):
        bk = f"{prefix}.bias"
        bias = tensors[bk].to(torch.float32) if bk in tensors else None
        q = unpack_w4_tpu(tensors[f"{prefix}.qweight"].to(dev), group_size)  # [I, O]
        return make_quantized_linear(
            q.T,
            tensors[f"{prefix}.scales"].to(torch.float32).T,
            tensors[f"{prefix}.zeros"].to(torch.float32).T,
            tensors[f"{prefix}.pairs"].to(torch.int32),
            tensors[f"{prefix}.theta"].to(torch.float32),
            tensors[f"{prefix}.channel_scales"].to(torch.float32).reshape(-1),
            group_size, bias=bias, rot_dtype=rot_dtype, n_bits=n_bits, device=dev,
        )

    def pick_linear(prefix):
        if is_quant and f"{prefix}.qweight" in tensors:
            return quant_linear(prefix)
        return dense_linear(prefix)

    params: dict[str, Any] = {
        "embed_tokens": dense("model.embed_tokens.weight"),
        "norm": dense("model.norm.weight"),
        "layers": [],
    }
    if "lm_head.weight" in tensors:
        params["lm_head"] = dense_linear("lm_head")
    for li in range(config.num_hidden_layers):
        lbase = f"model.layers.{li}"
        lp: dict[str, Any] = {
            "input_layernorm": dense(f"{lbase}.input_layernorm.weight"),
            "post_attention_layernorm": dense(f"{lbase}.post_attention_layernorm.weight"),
        }
        for name in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
            if f"{lbase}.{name}.weight" in tensors:
                lp[name] = dense(f"{lbase}.{name}.weight")
        for name in ("q_norm", "k_norm"):
            if f"{lbase}.self_attn.{name}.weight" in tensors:
                lp[name] = dense(f"{lbase}.self_attn.{name}.weight")
        for name in _ATTN:
            lp[name] = pick_linear(f"{lbase}.self_attn.{name}")
        lp["mlp"] = {name: pick_linear(f"{lbase}.mlp.{name}") for name in _MLP}
        params["layers"].append(lp)
    return params, config
