"""Checkpoint I/O: PARO-TPU, AWQ-format PARO and HF-dense directories of
the dense, MoE, qwen3_next hybrid and gemma3n families.

Counterpart of `paroquant_tpu/convert/checkpoint.py`: the save side
(`hf_prefix`, `save_paro_checkpoint`, `save_awq_checkpoint`, :55-453) and
the load side (`load_checkpoint`, :476). The safetensors format is read and written here
directly, without the `safetensors` package: an 8-byte little-endian
header length, a JSON header mapping each name to its dtype, shape and
byte range, then the raw little-endian buffer (`read_safetensors` views it
with `torch.frombuffer`, BF16 included; `write_safetensors` writes it).

AWQ-format checkpoints (the reference's published layout, z-lab/*-PARO):
qweight int32 [I, O//8] with the (0,2,4,6,1,3,5,7) nibble reorder, qzeros
int32 [G, O//8], scales f16 [G, O], and theta / pairs / channel_scales as
in the PARO-TPU format; imported by undoing the AWQ packing
(`ops/packing.py::unpack_awq`).

The save side writes JAX's tensor names, dtypes, shapes and bytes and an
equal config.json, from the per-layer export dicts of
`convert/rtn.py::rtn_export_model` or `convert/gptq.py::gptq_quantize_model`;
dense tensors go to f16 as JAX's do (the reference forces fp16).

MoE layers, as JAX's: the router is `mlp.gate`; quantized experts are
stacked PARO-TPU buffers (`mlp.experts.{gate,up,down}_{qweight,scales,
zeros}` with the shared rotations `mlp.experts.{gate_up,down}_{theta,pairs,
channel_scales}`) or the reference's per-expert AWQ layout
(`mlp.experts.{e}.{proj}.{qweight,qzeros,scales}`, rotations
`{side}_weight_*`); dense experts are per-expert HF weights, and the HF
Mixtral layout (`block_sparse_moe.gate`, `experts.{e}.{w1,w3,w2}`) loads
into stacked dense experts. A shared expert is saved like any GLU and its
gate dense. A hybrid's delta-net layers: `linear_attn.{in_proj_qkvz,
in_proj_ba, out_proj}` (each quantized where exported, else a dense f16
weight), `conv1d.weight` f32 [conv_dim, Kc], `dt_bias` and `A_log` f32,
`norm.weight` f16; its config.json carries `layer_types` and the
linear-attention widths. A gemma3n model's per-layer embedding, its
projection and norm, the AltUp projections and each layer's `altup.*`,
`laurel.*` and per-layer input linears are dense f16 (`altup.
correct_output_scale` f32), as JAX's `_save_gemma3n_shared` /
`_save_gemma3n_layer` write them; its config.json carries the AltUp,
LAuReL, per-layer and shared-KV keys.

A VLM directory (Gemma3 image-text, config.json with `text_config` and
`vision_config`) also loads the SigLIP tower and the projector from their
HF names (`model.vision_tower.vision_model.*`,
`model.multi_modal_projector.*`), dense whatever the LM's format, as JAX's
loader does: the patch embedding's [D, C, p, p] weight flattened and
transposed to [C*p*p, D], the tower's biases and the patch embedding's in
f32. The writers, as JAX's, save no tower: a quantized VLM directory takes
the tower's HF tensors beside the LM's.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig, from_hf_dict
from ..models.decoder import DenseLinear
from ..ops.moe import QuantizedMoEExperts, pack_stacked, shared_rotation
from ..ops.packing import pack_awq, pack_wq_tpu, unpack_awq, unpack_w4_tpu
from ..ops.qlinear import make_quantized_linear
from ..utils.device import resolve_device

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
_LINEAR_ATTN = ("in_proj_qkvz", "in_proj_ba", "out_proj")  # a gated delta-net layer's linears
# a shared expert is quantized like any GLU; only its sigmoid gate stays dense
_SHARED_EXPERT = tuple(sorted(f"mlp.shared_expert.{m}" for m in _MLP))
_PROJ = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}


def hf_prefix(layer_idx: int, name: str) -> str:
    """The port's layer-param name -> HF tensor prefix."""
    if name.startswith("mlp.") or name.startswith("linear_attn."):
        return f"model.layers.{layer_idx}.{name}"
    if name in _ATTN:
        return f"model.layers.{layer_idx}.self_attn.{name}"
    raise ValueError(name)


def _holder_for(lp: dict, name: str):
    """Walk a dotted module path inside a layer dict -> (container, leaf),
    or (None, None) when any segment is absent."""
    parts = name.split(".")
    holder = lp
    for p in parts[:-1]:
        if not isinstance(holder, dict) or p not in holder:
            return None, None
        holder = holder[p]
    if not isinstance(holder, dict) or parts[-1] not in holder:
        return None, None
    return holder, parts[-1]


def _host(a, dtype=None) -> torch.Tensor:
    """A CPU tensor of a numpy array or tensor (optionally cast)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    t = t.detach().to("cpu")
    return t if dtype is None else t.to(dtype)


def _to_f16(a) -> torch.Tensor:
    """f16 through f32, as JAX's `np.asarray(a, np.float32).astype(np.float16)`."""
    return _host(a, torch.float32).to(torch.float16)


def _dense_tensors(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The tensors outside the layers: embedding, final norm, lm_head."""
    tensors = {"model.embed_tokens.weight": _to_f16(params["embed_tokens"]),
               "model.norm.weight": _to_f16(params["norm"])}
    if "lm_head" in params:
        tensors["lm_head.weight"] = _to_f16(params["lm_head"].w.T)
    return tensors


def _layer_dense_tensors(tensors: dict, li: int, lp: dict) -> None:
    for name in ("input_layernorm", "post_attention_layernorm",
                 "pre_feedforward_layernorm", "post_feedforward_layernorm"):
        if name in lp:
            tensors[f"model.layers.{li}.{name}.weight"] = _to_f16(lp[name])
    for name in ("q_norm", "k_norm"):
        if name in lp:
            tensors[f"model.layers.{li}.self_attn.{name}.weight"] = _to_f16(lp[name])
    if "linear_attn" in lp:  # a gated delta-net layer's extras (conv_w as [C, Kc])
        la, lab = lp["linear_attn"], f"model.layers.{li}.linear_attn"
        for key, name in (("conv1d.weight", "conv_w"), ("dt_bias", "dt_bias"), ("A_log", "A_log")):
            tensors[f"{lab}.{key}"] = _host(la[name], torch.float32)
        tensors[f"{lab}.norm.weight"] = _to_f16(la["norm"])


def _gemma3n_shared_tensors(tensors: dict, params: dict) -> None:
    """A gemma3n model's per-layer embedding module and AltUp projections (dense)."""
    tensors["model.embed_tokens_per_layer.weight"] = _to_f16(params["embed_tokens_per_layer"])
    tensors["model.per_layer_model_projection.weight"] = _to_f16(
        params["per_layer_model_projection"].w.T)
    tensors["model.per_layer_projection_norm.weight"] = _to_f16(params["per_layer_projection_norm"])
    for key in ("altup_projections", "altup_unembed_projections"):
        for i, lin in enumerate(params[key]):
            tensors[f"model.{key}.{i}.weight"] = _to_f16(lin.w.T)


def _gemma3n_layer_tensors(tensors: dict, li: int, lp: dict) -> None:
    """A gemma3n layer's AltUp, LAuReL and per-layer input modules (dense)."""
    base = f"model.layers.{li}"
    ap, lau = lp["altup"], lp["laurel"]
    tensors[f"{base}.altup.correct_output_scale"] = _host(ap["correct_output_scale"], torch.float32)
    for n in ("correction_coefs", "prediction_coefs", "modality_router"):
        tensors[f"{base}.altup.{n}.weight"] = _to_f16(ap[n].w.T)
    tensors[f"{base}.altup.router_norm.weight"] = _to_f16(ap["router_norm"])
    for n in ("linear_left", "linear_right"):
        tensors[f"{base}.laurel.{n}.weight"] = _to_f16(lau[n].w.T)
    tensors[f"{base}.laurel.post_laurel_norm.weight"] = _to_f16(lau["post_laurel_norm"])
    for n in ("per_layer_input_gate", "per_layer_projection"):
        tensors[f"{base}.{n}.weight"] = _to_f16(lp[n].w.T)
    tensors[f"{base}.post_per_layer_input_norm.weight"] = _to_f16(lp["post_per_layer_input_norm"])


def _layer_linears(tensors: dict, li: int, lp: dict, exp_layer: dict, quant_tensors) -> tuple:
    """Each linear of a layer: quant_tensors(tensors, prefix, export) for an
    exported one, else its dense f16 weight (and bias). Returns the last
    export's (n_bits, group_size, krot), or None when the layer exported
    nothing."""
    meta = None
    for name in (list(_ATTN) + [f"linear_attn.{n}" for n in _LINEAR_ATTN]
                 + [f"mlp.{m}" for m in _MLP] + list(_SHARED_EXPERT)):
        holder, base = _holder_for(lp, name)
        if holder is None:
            continue
        prefix = hf_prefix(li, name)
        if name in exp_layer:
            exp = exp_layer[name]
            meta = (int(exp["n_bits"]), int(exp["group_size"]), int(exp["theta"].shape[0]))
            quant_tensors(tensors, prefix, exp)
            tensors[f"{prefix}.theta"] = _host(exp["theta"], torch.float16)
            tensors[f"{prefix}.pairs"] = _host(exp["pairs"], torch.int16)
            tensors[f"{prefix}.channel_scales"] = _host(
                exp["inv_channel_scales"], torch.float16).reshape(1, -1)
            if exp.get("bias") is not None:
                tensors[f"{prefix}.bias"] = _to_f16(exp["bias"])
        else:
            lin = holder[base]
            tensors[f"{prefix}.weight"] = _to_f16(lin.w.T)
            if lin.b is not None:
                tensors[f"{prefix}.bias"] = _to_f16(lin.b)
    return meta


def _moe_tensors(tensors: dict, li: int, mlp: dict, exp_layer: dict, awq: bool) -> tuple:
    """A sparse layer's router, experts and shared-expert gate. Exported
    experts go in the PARO-TPU stacked or the per-expert AWQ layout; dense
    experts as per-expert HF weights. Returns the experts' (n_bits,
    group_size, krot), or None where they exported nothing."""
    base = f"model.layers.{li}.mlp"
    if "router" in mlp:
        tensors[f"{base}.gate.weight"] = _to_f16(mlp["router"].w.T)
    meta = None
    if "mlp.experts" in exp_layer:
        exp = exp_layer["mlp.experts"]
        n_bits, gs = int(exp["n_bits"]), int(exp["group_size"])
        meta = (n_bits, gs, int(exp["gate_up_theta"].shape[0]))
        for pn, proj in _PROJ.items():
            sub = exp[pn]
            q = _host(sub["q"])  # [E, O, In]
            scales = _host(sub["scales"], torch.float32)  # [E, O, G]
            zeros = _host(sub["zeros"])
            if awq:
                # pack_awq packs each row on its own: every expert's rows in one call
                E = q.shape[0]
                qw = torch.from_numpy(pack_awq(q.transpose(1, 2).reshape(-1, q.shape[1]).numpy(),
                                               n_bits)).reshape(E, -1, q.shape[1] * n_bits // 32)
                qz = torch.from_numpy(pack_awq(zeros.transpose(1, 2).reshape(-1, q.shape[1]).numpy(),
                                               n_bits)).reshape(E, -1, q.shape[1] * n_bits // 32)
                for e in range(E):
                    eb = f"{base}.experts.{e}.{proj}"
                    tensors[f"{eb}.qweight"], tensors[f"{eb}.qzeros"] = qw[e], qz[e]
                    tensors[f"{eb}.scales"] = scales[e].T.to(torch.float16)
            else:
                tensors[f"{base}.experts.{pn}_qweight"] = pack_stacked(q.transpose(1, 2), n_bits, gs)
                tensors[f"{base}.experts.{pn}_scales"] = scales.transpose(1, 2).contiguous()
                tensors[f"{base}.experts.{pn}_zeros"] = zeros.to(torch.uint8).transpose(
                    1, 2).contiguous()
        for side in ("gate_up", "down"):
            key = f"{base}.experts.{side}_weight" if awq else f"{base}.experts.{side}"
            tensors[f"{key}_theta"] = _host(exp[f"{side}_theta"], torch.float16)
            tensors[f"{key}_pairs"] = _host(exp[f"{side}_pairs"], torch.int16)
            tensors[f"{key}_channel_scales"] = _host(
                exp[f"{side}_inv_channel_scales"], torch.float16).reshape(1, -1)
    elif isinstance(mlp.get("experts"), dict):
        ex = mlp["experts"]
        for e in range(ex["gate_proj"].shape[0]):
            for pn in _MLP:
                tensors[f"{base}.experts.{e}.{pn}.weight"] = _to_f16(ex[pn][e].T)
    elif awq and "experts" in mlp:
        raise NotImplementedError(
            "AWQ export of already-quantized stacked experts requires the calibration "
            "export dicts (run convert from optimizer results); re-exporting runtime "
            "QuantizedMoEExperts to AWQ is not supported")
    if "shared_expert_gate" in mlp:
        tensors[f"{base}.shared_expert_gate.weight"] = _to_f16(mlp["shared_expert_gate"].w.T)
    return meta


def _save(path, params, config, layer_exports, hf_config, quant_tensors, qconfig,
          awq: bool) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tensors = _dense_tensors(params)
    if config.is_gemma3n:
        _gemma3n_shared_tensors(tensors, params)
    n_bits, group_size, krot = 4, 128, 8
    for li, lp in enumerate(params["layers"]):
        exp_layer = layer_exports[li] if li < len(layer_exports) else {}
        if config.is_gemma3n:
            _gemma3n_layer_tensors(tensors, li, lp)
        _layer_dense_tensors(tensors, li, lp)
        for meta in (_moe_tensors(tensors, li, lp.get("mlp", {}), exp_layer, awq),
                     _layer_linears(tensors, li, lp, exp_layer, quant_tensors)):
            if meta is not None:
                n_bits, group_size, krot = meta
    write_safetensors(path / "model.safetensors", tensors)
    cfg = dict(hf_config) if hf_config else _config_to_hf(config)
    cfg["quantization_config"] = {**qconfig, "bits": n_bits, "group_size": group_size,
                                  "krot": krot}
    (path / "config.json").write_text(json.dumps(cfg, indent=2) + "\n")


def _paro_tensors(tensors: dict, prefix: str, exp: dict) -> None:
    n_bits, group_size = int(exp["n_bits"]), int(exp["group_size"])
    tensors[f"{prefix}.qweight"] = pack_wq_tpu(_host(exp["q"]).T, n_bits, group_size)
    tensors[f"{prefix}.scales"] = _host(exp["scales"], torch.float32).T.contiguous()
    tensors[f"{prefix}.zeros"] = _host(exp["zeros"], torch.uint8).T.contiguous()


def _awq_tensors(tensors: dict, prefix: str, exp: dict) -> None:
    n_bits = int(exp["n_bits"])
    tensors[f"{prefix}.qweight"] = torch.from_numpy(pack_awq(np.asarray(exp["q"]).T, n_bits))
    tensors[f"{prefix}.qzeros"] = torch.from_numpy(pack_awq(np.asarray(exp["zeros"]).T, n_bits))
    tensors[f"{prefix}.scales"] = _host(exp["scales"], torch.float32).T.to(torch.float16)


def save_paro_checkpoint(
    path: str | Path,
    params: dict[str, Any],
    config: ModelConfig,
    layer_exports: list[dict[str, dict[str, Any]]],
    hf_config: dict[str, Any] | None = None,
) -> None:
    """Write a PARO-TPU checkpoint: per exported linear, qweight uint8 [I//2,
    O] (the half-split packing), scales f32 [G, O], zeros uint8 [G, O],
    theta f16, pairs i16, channel_scales f16 [1, I]; every other tensor in
    f16. `layer_exports[i][name]` are export dicts (`rtn_export_model`,
    `gptq_quantize_model`)."""
    _save(path, params, config, layer_exports, hf_config, _paro_tensors,
          {"quant_method": "paroquant", "format": "paro-tpu"}, awq=False)


def save_awq_checkpoint(
    path: str | Path,
    params: dict[str, Any],
    config: ModelConfig,
    layer_exports: list[dict[str, dict[str, Any]]],
    hf_config: dict[str, Any] | None = None,
) -> None:
    """Write the reference's AWQ-packed layout: qweight int32 [I, O//8]
    nibble-reordered, qzeros int32 [G, O//8], scales f16 [G, O], and
    theta / pairs / channel_scales as in the PARO-TPU format. A hybrid's
    delta-net layers are written as in the PARO-TPU format (their linears
    AWQ-packed where exported): JAX's AWQ writer leaves them out, so its
    hybrid directory loads in neither package; every tensor it does write,
    the port writes with the same bytes."""
    _save(path, params, config, layer_exports, hf_config, _awq_tensors,
          {"quant_method": "paroquant"}, awq=True)


def _config_to_hf(config: ModelConfig) -> dict[str, Any]:
    """config.json of a dense-, MoE-, hybrid- or gemma3n-family config (JAX's
    keys, in JAX's order; gemma3n's layer_types bring the hybrid's keys too,
    as in JAX)."""
    out: dict[str, Any] = {}
    if config.layer_types is not None:  # the hybrid (gated delta-net) family
        out.update(
            layer_types=list(config.layer_types),
            partial_rotary_factor=config.partial_rotary_factor,
            linear_num_value_heads=config.linear_num_value_heads,
            linear_num_key_heads=config.linear_num_key_heads,
            linear_key_head_dim=config.linear_key_head_dim,
            linear_value_head_dim=config.linear_value_head_dim,
            linear_conv_kernel_dim=config.linear_conv_kernel_dim,
        )
    if config.is_moe:
        out.update(
            num_experts=config.num_experts,
            num_experts_per_tok=config.num_experts_per_tok,
            moe_intermediate_size=config.moe_intermediate_size,
            norm_topk_prob=config.norm_topk_prob,
            decoder_sparse_step=config.decoder_sparse_step,
        )
    if config.is_gemma3n:
        out.update(
            altup_num_inputs=config.altup_num_inputs,
            altup_active_idx=config.altup_active_idx,
            altup_correct_scale=config.altup_correct_scale,
            laurel_rank=config.laurel_rank,
            hidden_size_per_layer_input=config.hidden_size_per_layer_input,
            vocab_size_per_layer_input=config.vocab_size_per_layer_input,
            num_kv_shared_layers=config.num_kv_shared_layers,
            sliding_window=config.sliding_window,
            rope_local_base_freq=config.rope_local_theta,
            final_logit_softcapping=config.logit_softcap,
            hidden_activation=config.hidden_act,
        )
        if config.activation_sparsity is not None:
            out["activation_sparsity_pattern"] = list(config.activation_sparsity)
        if config.intermediate_sizes is not None:
            out["intermediate_size"] = list(config.intermediate_sizes)
    # the family's keys win (gemma3n's per-layer intermediate_size list)
    return {
        "model_type": config.model_type,
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.head_dim,
        "rms_norm_eps": config.rms_norm_eps,
        "rope_theta": config.rope_theta,
        "max_position_embeddings": config.max_position_embeddings,
        "tie_word_embeddings": config.tie_word_embeddings,
    } | out


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


_DTYPE_NAMES = {dt: name for name, dt in _DTYPES.items()}
# the safetensors library's order of the tensors in a file: by dtype, in
# this order, then by name (its Dtype enum, descending)
_DTYPE_ORDER = ("I64", "F64", "F32", "I32", "BF16", "F16", "I16", "I8", "U8", "BOOL")


def write_safetensors(path: str | Path, tensors: dict[str, torch.Tensor]) -> None:
    """Write tensors (any device; the dtypes of `_DTYPES`) as one .safetensors
    file laid out as the safetensors library lays it out (so a file equals
    the library's byte for byte): the header's JSON, no metadata, padded
    with spaces to 8 bytes, then each tensor's raw little-endian bytes,
    ordered by dtype (`_DTYPE_ORDER`) and then by name."""
    if sys.byteorder != "little":
        raise RuntimeError("write_safetensors writes the host's byte order, "
                           "which must be little-endian")
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"tensor {name} has unsupported dtype {t.dtype}")
    order = sorted(tensors, key=lambda n: (_DTYPE_ORDER.index(_DTYPE_NAMES[tensors[n].dtype]), n))
    header: dict[str, Any] = {}
    flat = {}
    offset = 0
    for name in order:
        t = tensors[name]
        flat[name] = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
        n = flat[name].numel()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in order:
            f.write(memoryview(flat[name].numpy()))


def _open_all(model_dir: Path) -> dict[str, torch.Tensor]:
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    tensors: dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return {k.replace("language_model.", ""): v for k, v in tensors.items()}


def _vision_params(tensors: dict, vt: str, dtype, dev) -> dict[str, Any]:
    """The SigLIP tower (`vision`) and the Gemma3 projector (`projector`)
    from HF-named tensors, in models/vision.py's layout: weights in `dtype`,
    biases in f32."""
    def dense(name):
        return tensors[name].to(device=dev, dtype=dtype)

    def dense_linear(prefix):
        b = tensors.get(f"{prefix}.bias")
        return DenseLinear(tensors[f"{prefix}.weight"].T.contiguous().to(device=dev, dtype=dtype),
                           None if b is None else b.to(device=dev, dtype=torch.float32))

    pe = tensors[f"{vt}.embeddings.patch_embedding.weight"]  # [D, C, p, p]
    vision: dict[str, Any] = {
        "patch_embed_w": pe.reshape(pe.shape[0], -1).T.contiguous().to(device=dev, dtype=dtype),
        "patch_embed_b": tensors[f"{vt}.embeddings.patch_embedding.bias"].to(
            device=dev, dtype=torch.float32),
        "pos_embed": dense(f"{vt}.embeddings.position_embedding.weight"),
        "post_ln_w": dense(f"{vt}.post_layernorm.weight"),
        "post_ln_b": dense(f"{vt}.post_layernorm.bias"),
        "layers": [],
    }
    while f"{vt}.encoder.layers.{len(vision['layers'])}.layer_norm1.weight" in tensors:
        vb = f"{vt}.encoder.layers.{len(vision['layers'])}"
        vision["layers"].append({
            **{f"ln{i}_{wb}": dense(f"{vb}.layer_norm{i}.{name}")
               for i in (1, 2) for wb, name in (("w", "weight"), ("b", "bias"))},
            **{n: dense_linear(f"{vb}.self_attn.{n}") for n in ("q_proj", "k_proj", "v_proj",
                                                               "out_proj")},
            "fc1": dense_linear(f"{vb}.mlp.fc1"),
            "fc2": dense_linear(f"{vb}.mlp.fc2"),
        })
    mp = "model.multi_modal_projector"
    projector = {"mm_input_projection": dense(f"{mp}.mm_input_projection_weight"),
                 "mm_soft_emb_norm": dense(f"{mp}.mm_soft_emb_norm.weight")}
    return {"vision": vision, "projector": projector}


def load_checkpoint(
    model_dir: str | Path, rot_dtype=torch.bfloat16, dtype=torch.bfloat16, device="cuda",
) -> tuple[dict[str, Any], ModelConfig]:
    """Load a PARO-TPU, AWQ-format PARO or plain HF-dense model directory
    (dense, MoE, hybrid or gemma3n family, HF Mixtral, and a Gemma3 VLM's
    tower and projector) onto `device`."""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    config = from_hf_dict(json.loads((model_dir / "config.json").read_text()))
    tensors = _open_all(model_dir)

    qc = config.quantization or {}
    is_quant = qc.get("quant_method") in ("paroquant", "awq")
    fmt = qc.get("format", "awq" if qc.get("quant_method") else None)
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
        if fmt == "paro-tpu":
            q = unpack_w4_tpu(tensors[f"{prefix}.qweight"].to(dev), group_size)  # [I, O]
            zeros = tensors[f"{prefix}.zeros"]  # [G, O]
        else:  # AWQ layout from reference checkpoints
            q = torch.from_numpy(unpack_awq(tensors[f"{prefix}.qweight"].numpy(), n_bits)).to(dev)
            zeros = torch.from_numpy(unpack_awq(tensors[f"{prefix}.qzeros"].numpy(), n_bits))
        return make_quantized_linear(
            q.T,
            tensors[f"{prefix}.scales"].to(torch.float32).T,
            zeros.to(torch.float32).T,
            tensors[f"{prefix}.pairs"].to(torch.int32),
            tensors[f"{prefix}.theta"].to(torch.float32),
            tensors[f"{prefix}.channel_scales"].to(torch.float32).reshape(-1),
            group_size, bias=bias, rot_dtype=rot_dtype, n_bits=n_bits, device=dev,
        )

    def pick_linear(prefix):
        if is_quant and f"{prefix}.qweight" in tensors:
            return quant_linear(prefix)
        return dense_linear(prefix)

    def router(name):
        return DenseLinear(tensors[name].T.contiguous().to(device=dev, dtype=dtype))

    def dense_experts(key_of):
        """Stacked dense experts from per-expert HF weights [O, In]: key_of(e,
        proj) names expert e's weight, as long as the gate's exists."""
        stacks: dict[str, list] = {pn: [] for pn in _MLP}
        e = 0
        while key_of(e, "gate_proj") in tensors:
            for pn in _MLP:
                stacks[pn].append(tensors[key_of(e, pn)].T)
            e += 1
        return {pn: torch.stack(ws).to(device=dev, dtype=dtype) for pn, ws in stacks.items()}

    def mixtral_mlp(base):
        """HF Mixtral: block_sparse_moe.gate and experts.{e}.{w1, w3, w2}
        (gate, up, down) -> the router and stacked dense experts."""
        names = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
        return {"router": router(f"{base}.gate.weight"),
                "experts": dense_experts(lambda e, pn: f"{base}.experts.{e}.{names[pn]}.weight")}

    def quant_experts(eb, awq_moe):
        """Stacked PARO-TPU buffers, or the reference's per-expert AWQ
        buffers repacked, as QuantizedMoEExperts (bf16 scales and zeros, as
        `optim/pseudo_moe.py::quantized_moe_from_export` stores them)."""
        def rot(side):
            key = f"{eb}.{side}_weight" if awq_moe else f"{eb}.{side}"
            return shared_rotation(tensors[f"{key}_pairs"], tensors[f"{key}_theta"],
                                   tensors[f"{key}_channel_scales"], group_size, rot_dtype, dev)

        def stack(pn):
            if not awq_moe:
                return (tensors[f"{eb}.{pn}_qweight"].to(dev),
                        tensors[f"{eb}.{pn}_scales"].to(torch.float32).to(dev, torch.bfloat16),
                        tensors[f"{eb}.{pn}_zeros"].to(torch.float32).to(dev, torch.bfloat16))
            pbs = []
            while f"{eb}.{len(pbs)}.{_PROJ[pn]}.qweight" in tensors:
                pbs.append(f"{eb}.{len(pbs)}.{_PROJ[pn]}")

            def unpacked(leaf):  # unpack_awq works row by row: every expert's rows in one call
                packed = torch.stack([tensors[f"{pb}.{leaf}"] for pb in pbs])
                rows = unpack_awq(packed.reshape(-1, packed.shape[-1]).numpy(), n_bits)
                return torch.from_numpy(rows).reshape(len(pbs), packed.shape[1], -1)

            scales = torch.stack([tensors[f"{pb}.scales"].to(torch.float32) for pb in pbs])
            return (pack_stacked(unpacked("qweight").to(dev), n_bits, group_size),
                    scales.to(dev, torch.bfloat16),
                    unpacked("qzeros").to(torch.float32).to(dev, torch.bfloat16))

        return QuantizedMoEExperts(*stack("gate"), *stack("up"), *stack("down"),
                                   rot("gate_up"), rot("down"))

    def moe_mlp(base):
        """The router `mlp.gate`, the experts (stacked PARO-TPU, per-expert
        AWQ or dense), and a shared expert with its dense sigmoid gate."""
        eb = f"{base}.experts"
        awq_moe = f"{eb}.0.gate_proj.qweight" in tensors
        mlp: dict[str, Any] = {"router": router(f"{base}.gate.weight")}
        if f"{eb}.gate_qweight" in tensors or awq_moe:
            mlp["experts"] = quant_experts(eb, awq_moe)
        else:
            mlp["experts"] = dense_experts(lambda e, pn: f"{eb}.{e}.{pn}.weight")
        sb = f"{base}.shared_expert"
        if f"{sb}.gate_proj.weight" in tensors or f"{sb}.gate_proj.qweight" in tensors:
            mlp["shared_expert"] = {name: pick_linear(f"{sb}.{name}") for name in _MLP}
            mlp["shared_expert_gate"] = router(f"{base}.shared_expert_gate.weight")
        return mlp

    params: dict[str, Any] = {
        "embed_tokens": dense("model.embed_tokens.weight"),
        "norm": dense("model.norm.weight"),
        "layers": [],
    }
    if "lm_head.weight" in tensors:
        params["lm_head"] = dense_linear("lm_head")
    vt = "model.vision_tower.vision_model"
    if config.is_vlm and f"{vt}.post_layernorm.weight" in tensors:
        params.update(_vision_params(tensors, vt, dtype, dev))
    if config.is_gemma3n:  # the per-layer embedding module and the AltUp projections
        params["embed_tokens_per_layer"] = dense("model.embed_tokens_per_layer.weight")
        params["per_layer_model_projection"] = dense_linear("model.per_layer_model_projection")
        params["per_layer_projection_norm"] = dense("model.per_layer_projection_norm.weight")
        for key in ("altup_projections", "altup_unembed_projections"):
            params[key] = [dense_linear(f"model.{key}.{i}")
                           for i in range(config.altup_num_inputs - 1)]
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
        if config.layer_is_linear(li):
            la = f"{lbase}.linear_attn"

            def f32(name):
                return tensors[name].to(device=dev, dtype=torch.float32)

            lp["linear_attn"] = {
                **{name: pick_linear(f"{la}.{name}") for name in _LINEAR_ATTN},
                "conv_w": f32(f"{la}.conv1d.weight").reshape(
                    config.linear_conv_dim, config.linear_conv_kernel_dim),
                "dt_bias": f32(f"{la}.dt_bias"),
                "A_log": f32(f"{la}.A_log"),
                "norm": dense(f"{la}.norm.weight"),
            }
        else:
            for name in _ATTN:
                lp[name] = pick_linear(f"{lbase}.self_attn.{name}")
        if config.is_gemma3n:
            ab = f"{lbase}.altup"
            lp["altup"] = {
                "correct_output_scale": tensors[f"{ab}.correct_output_scale"].to(
                    device=dev, dtype=torch.float32),
                **{n: dense_linear(f"{ab}.{n}")
                   for n in ("correction_coefs", "prediction_coefs", "modality_router")},
                "router_norm": dense(f"{ab}.router_norm.weight"),
            }
            lp["laurel"] = {
                "linear_left": dense_linear(f"{lbase}.laurel.linear_left"),
                "linear_right": dense_linear(f"{lbase}.laurel.linear_right"),
                "post_laurel_norm": dense(f"{lbase}.laurel.post_laurel_norm.weight"),
            }
            for n in ("per_layer_input_gate", "per_layer_projection"):
                lp[n] = dense_linear(f"{lbase}.{n}")
            lp["post_per_layer_input_norm"] = dense(f"{lbase}.post_per_layer_input_norm.weight")
        if f"{lbase}.block_sparse_moe.gate.weight" in tensors:
            lp["mlp"] = mixtral_mlp(f"{lbase}.block_sparse_moe")
        elif f"{lbase}.mlp.gate.weight" in tensors:
            lp["mlp"] = moe_mlp(f"{lbase}.mlp")
        else:
            lp["mlp"] = {name: pick_linear(f"{lbase}.mlp.{name}") for name in _MLP}
        params["layers"].append(lp)
    return params, config
