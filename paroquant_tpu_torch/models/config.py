"""Model configuration, mapped from HF config.json.

The port's own copy of `paroquant_tpu/models/config.py` (importing that one
would import jax through its package). Every field is kept, so the later
model families load through the same dataclass; the dense-family decoder of
this package reads only the fields it supports and raises on the rest.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str = "qwen3"
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 40960
    tie_word_embeddings: bool = True
    # family quirks
    qk_norm: bool = True  # Qwen3: RMSNorm on per-head q/k
    attention_bias: bool = False  # Qwen2: bias on q/k/v projections
    mlp_bias: bool = False
    gemma_norm: bool = False  # Gemma: (1 + w) RMSNorm weights + embed scaling
    post_norms: bool = False  # Gemma: post-attention/post-mlp extra norms
    sliding_window: int | None = None
    sliding_window_pattern: int | None = None  # Gemma: 1 global layer every N
    query_pre_attn_scalar: float | None = None  # Gemma3: attn scale = qpas^-0.5
    hidden_act: str = "silu"  # Gemma: gelu_pytorch_tanh
    rope_local_theta: float | None = None  # Gemma: different theta for local layers
    logit_softcap: float | None = None
    attn_logit_softcap: float | None = None
    # qwen3_next hybrid family (gated delta-net linear attention interleaved
    # with gated full attention, HF modeling_qwen3_next.py)
    layer_types: tuple | None = None  # per-layer "linear_attention"/"full_attention"
    partial_rotary_factor: float = 1.0
    attn_gate: bool = False  # q_proj emits (query, gate); out *= sigmoid(gate)
    linear_num_value_heads: int = 0
    linear_num_key_heads: int = 0
    linear_key_head_dim: int = 0
    linear_value_head_dim: int = 0
    linear_conv_kernel_dim: int = 4
    # gemma-4-class (HF Gemma3n) per-layer-embedding family: AltUp stacked
    # hidden states, laurel residual, per-layer input embeddings, shared-KV
    # tail layers (reference optim/util.py:17,83-103 handles this family's
    # extra modules/kwargs; the model itself lives in the HF zoo there)
    altup_num_inputs: int = 0  # >0 selects the gemma3n decoder path
    altup_active_idx: int = 0
    altup_correct_scale: bool = True
    laurel_rank: int = 0
    hidden_size_per_layer_input: int = 0
    vocab_size_per_layer_input: int = 0
    num_kv_shared_layers: int = 0
    activation_sparsity: tuple | None = None  # per-layer sparsity fraction
    intermediate_sizes: tuple | None = None  # per-layer MLP width override
    # MoE (0 experts => dense)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    decoder_sparse_step: int = 1
    # layers forced to a dense MLP regardless of the sparse step
    # (HF Qwen2MoE/Qwen3MoE `mlp_only_layers`)
    mlp_only_layers: tuple = ()
    shared_expert_intermediate_size: int = 0
    # VLM (image-text): frozen vision_config items + merge parameters
    vision_items: tuple | None = None
    mm_tokens_per_image: int = 0
    image_token_id: int | None = None
    # quantization config, stored as a frozen tuple of (key, value) pairs so
    # ModelConfig stays hashable (the same as the JAX package's); use
    # .quantization for the dict view
    quantization_items: tuple | None = None

    @property
    def vision(self) -> dict[str, Any] | None:
        if self.vision_items is None:
            return None
        return dict(self.vision_items)

    @property
    def is_vlm(self) -> bool:
        return self.vision_items is not None

    @property
    def quantization(self) -> dict[str, Any] | None:
        if self.quantization_items is None:
            return None
        return dict(self.quantization_items)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_gemma3n(self) -> bool:
        return self.altup_num_inputs > 0

    @property
    def first_kv_shared_layer(self) -> int:
        """Layers >= this index reuse the KV of an earlier layer (gemma3n
        shared-KV tail; HF Gemma3nTextAttention.is_kv_shared_layer)."""
        return self.num_hidden_layers - self.num_kv_shared_layers

    def kv_share_source(self, layer_idx: int) -> int | None:
        """For a shared-KV layer: index of the last non-shared layer of the
        same attention type (whose cache rows this layer reads). None for
        layers that compute their own KV."""
        first = self.first_kv_shared_layer
        if not (self.num_kv_shared_layers and layer_idx >= first > 0):
            return None
        lt = self.layer_types[layer_idx]
        prev = [i for i in range(first) if self.layer_types[i] == lt]
        return prev[-1]

    def layer_intermediate_size(self, layer_idx: int) -> int:
        if self.intermediate_sizes is not None:
            return self.intermediate_sizes[layer_idx]
        return self.intermediate_size

    def layer_activation_sparsity(self, layer_idx: int) -> float:
        if self.activation_sparsity is None:
            return 0.0
        return float(self.activation_sparsity[layer_idx])

    def layer_is_sparse(self, layer_idx: int) -> bool:
        if not self.is_moe or layer_idx in self.mlp_only_layers:
            return False
        step = max(self.decoder_sparse_step, 1)
        return (layer_idx + 1) % step == 0

    @property
    def zero_centered_norm(self) -> bool:
        """(1 + w) RMSNorm weights: Gemma-class AND qwen3_next (HF
        Qwen3NextRMSNorm stores zero-init weights). gemma_norm alone keeps
        controlling the sqrt(H) embedding scale, which qwen3_next lacks.
        gemma3n norms store plain weights (HF Gemma3nRMSNorm init ones)."""
        if self.is_gemma3n:
            return False
        return self.gemma_norm or self.model_type == "qwen3_next"

    def layer_is_linear(self, layer_idx: int) -> bool:
        return (
            self.layer_types is not None
            and self.layer_types[layer_idx] == "linear_attention"
        )

    def kv_layer_index(self, layer_idx: int) -> int:
        """Index of this attention layer within the KV cache stack (hybrid
        models allocate KV only for non-linear layers; sliding_attention
        layers have KV like full ones)."""
        if self.layer_types is None:
            return layer_idx
        return sum(
            1 for i in range(layer_idx) if self.layer_types[i] != "linear_attention"
        )

    def linear_layer_index(self, layer_idx: int) -> int:
        if self.layer_types is None:
            return 0
        return sum(
            1 for i in range(layer_idx) if self.layer_types[i] == "linear_attention"
        )

    @property
    def num_full_attn_layers(self) -> int:
        """Layers that keep a KV cache (everything except linear-attention
        layers and the gemma3n shared-KV tail, which reads earlier rows)."""
        if self.num_kv_shared_layers:
            return self.first_kv_shared_layer
        if self.layer_types is None:
            return self.num_hidden_layers
        return sum(1 for t in self.layer_types if t != "linear_attention")

    @property
    def num_linear_layers(self) -> int:
        if self.layer_types is None:
            return 0
        return sum(1 for t in self.layer_types if t == "linear_attention")

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def linear_conv_dim(self) -> int:
        return (
            2 * self.linear_num_key_heads * self.linear_key_head_dim
            + self.linear_num_value_heads * self.linear_value_head_dim
        )

    def layer_sliding_window(self, layer_idx: int) -> int | None:
        """Per-layer sliding window. HF layer_types ("sliding_attention" /
        "full_attention") wins when present; else the Gemma interval pattern
        (global every Nth layer)."""
        if self.sliding_window is None:
            return None
        if self.layer_types is not None:
            lt = self.layer_types[layer_idx]
            return self.sliding_window if lt == "sliding_attention" else None
        if self.sliding_window_pattern is None:
            return self.sliding_window
        if (layer_idx + 1) % self.sliding_window_pattern == 0:
            return None  # global attention layer
        return self.sliding_window

    @property
    def attn_scale(self) -> float:
        if self.is_gemma3n:
            return 1.0  # HF Gemma3nTextAttention passes scaling=1.0
        if self.query_pre_attn_scalar is not None:
            return float(self.query_pre_attn_scalar) ** -0.5
        return float(self.head_dim) ** -0.5


def _freeze(d: dict[str, Any] | None) -> tuple | None:
    if d is None:
        return None
    return tuple(
        (k, _freeze(v) if isinstance(v, dict) else tuple(v) if isinstance(v, list) else v)
        for k, v in sorted(d.items())
    )


def from_hf_dict(cfg: dict[str, Any]) -> ModelConfig:
    """Map an HF config.json dict onto ModelConfig."""
    # VLM checkpoints nest the LM config; keep the vision tower + merge params
    vlm_extra: dict[str, Any] = {}
    if "text_config" in cfg:
        outer = cfg
        cfg = dict(cfg["text_config"])
        cfg.setdefault("model_type", outer.get("model_type", "llama"))
        if "quantization_config" in outer:
            cfg.setdefault("quantization_config", outer["quantization_config"])
        if "vision_config" in outer:
            vlm_extra = dict(
                vision_items=_freeze(outer["vision_config"]),
                mm_tokens_per_image=outer.get("mm_tokens_per_image", 256),
                image_token_id=outer.get("image_token_index",
                                         outer.get("image_token_id")),
            )
    mt = cfg.get("model_type", "llama")
    heads = cfg.get("num_attention_heads", 32)
    hidden = cfg.get("hidden_size", 4096)
    head_dim = cfg.get("head_dim") or hidden // heads
    is_gemma = mt.startswith("gemma")
    kwargs: dict[str, Any] = dict(
        model_type=mt,
        vocab_size=cfg.get("vocab_size", 32000),
        hidden_size=hidden,
        intermediate_size=cfg.get("intermediate_size", 11008),
        num_hidden_layers=cfg.get("num_hidden_layers", 32),
        num_attention_heads=heads,
        num_key_value_heads=cfg.get("num_key_value_heads", heads),
        head_dim=head_dim,
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        qk_norm=mt in ("qwen3", "qwen3_moe", "qwen3_next") or is_gemma and mt >= "gemma3",
        attention_bias=cfg.get("attention_bias", mt == "qwen2"),
        mlp_bias=cfg.get("mlp_bias", False),
        query_pre_attn_scalar=cfg.get("query_pre_attn_scalar"),
        hidden_act=cfg.get(
            "hidden_activation",
            cfg.get("hidden_act", "gelu_pytorch_tanh" if is_gemma else "silu"),
        ),
        gemma_norm=is_gemma,
        post_norms=is_gemma,
        sliding_window=cfg.get("sliding_window"),
        sliding_window_pattern=cfg.get("sliding_window_pattern"),
        rope_local_theta=cfg.get("rope_local_base_freq"),
        logit_softcap=cfg.get("final_logit_softcapping"),
        attn_logit_softcap=cfg.get("attn_logit_softcapping"),
        quantization_items=_freeze(cfg.get("quantization_config")),
    )
    if mt in ("qwen3_moe", "qwen2_moe", "qwen3_next"):
        kwargs.update(
            num_experts=cfg.get("num_experts", 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 0),
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
            norm_topk_prob=cfg.get("norm_topk_prob", True),
            decoder_sparse_step=cfg.get("decoder_sparse_step", 1),
            mlp_only_layers=tuple(cfg.get("mlp_only_layers", ()) or ()),
            shared_expert_intermediate_size=cfg.get("shared_expert_intermediate_size", 0),
        )
    if mt == "mixtral":
        # HF Mixtral: experts are full-width GLUs (w1/w3/w2), router logits
        # softmaxed over ALL experts then top-k renormalized — exactly our
        # norm_topk_prob semantics (decoder.moe_forward)
        kwargs.update(
            num_experts=cfg.get("num_local_experts", 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
            moe_intermediate_size=cfg.get("intermediate_size", 0),
            norm_topk_prob=True,
        )
    layer_types = cfg.get("layer_types")
    if mt == "qwen3_next":
        # hybrid gated-delta-net family (HF modeling_qwen3_next.py): 3 of
        # every `full_attention_interval` layers are linear attention
        n_layers = kwargs["num_hidden_layers"]
        if layer_types is None:
            interval = cfg.get("full_attention_interval", 4)
            layer_types = [
                "linear_attention" if (i + 1) % interval else "full_attention"
                for i in range(n_layers)
            ]
        kwargs.update(
            layer_types=tuple(layer_types),
            partial_rotary_factor=cfg.get("partial_rotary_factor", 0.25),
            attn_gate=True,
            linear_num_value_heads=cfg.get("linear_num_value_heads", 32),
            linear_num_key_heads=cfg.get("linear_num_key_heads", 16),
            linear_key_head_dim=cfg.get("linear_key_head_dim", 128),
            linear_value_head_dim=cfg.get("linear_value_head_dim", 128),
            linear_conv_kernel_dim=cfg.get("linear_conv_kernel_dim", 4),
        )
    elif layer_types is not None and "linear_attention" in layer_types:
        raise NotImplementedError(
            f"model_type {mt!r} declares linear_attention layers; only the "
            "qwen3_next delta-net family is implemented"
        )
    elif layer_types is not None:
        # Gemma3-style "sliding_attention"/"full_attention" per-layer list
        kwargs.update(layer_types=tuple(layer_types))
    if mt.startswith("gemma3n"):
        # gemma-4-class: per-layer MLP widths, AltUp, laurel, per-layer
        # embeddings, shared-KV tail (HF Gemma3nTextConfig)
        inter = cfg.get("intermediate_size", 16384)
        if isinstance(inter, (list, tuple)):
            kwargs["intermediate_size"] = int(inter[0])
            kwargs["intermediate_sizes"] = tuple(int(v) for v in inter)
        asp = cfg.get("activation_sparsity_pattern")
        kwargs.update(
            altup_num_inputs=cfg.get("altup_num_inputs", 4),
            altup_active_idx=cfg.get("altup_active_idx", 0),
            altup_correct_scale=cfg.get("altup_correct_scale", True),
            laurel_rank=cfg.get("laurel_rank", 64),
            hidden_size_per_layer_input=cfg.get("hidden_size_per_layer_input", 256),
            vocab_size_per_layer_input=cfg.get("vocab_size_per_layer_input", 262144),
            num_kv_shared_layers=cfg.get("num_kv_shared_layers", 0),
            activation_sparsity=(
                None if asp is None else tuple(float(v) for v in asp)
            ),
        )
    kwargs.update(vlm_extra)
    return ModelConfig(**kwargs)


def load_config(model_dir: str | Path) -> ModelConfig:
    with open(Path(model_dir) / "config.json") as f:
        return from_hf_dict(json.load(f))


# Small presets for tests/benchmarks (shapes follow the public model cards).
PRESETS: dict[str, ModelConfig] = {
    "qwen3-0.6b": ModelConfig(
        model_type="qwen3", vocab_size=151936, hidden_size=1024,
        intermediate_size=3072, num_hidden_layers=28, num_attention_heads=16,
        num_key_value_heads=8, head_dim=128, tie_word_embeddings=True,
    ),
    "qwen3-8b": ModelConfig(
        model_type="qwen3", vocab_size=151936, hidden_size=4096,
        intermediate_size=12288, num_hidden_layers=36, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128, tie_word_embeddings=False,
    ),
    "llama-2-7b": ModelConfig(
        model_type="llama", vocab_size=32000, hidden_size=4096,
        intermediate_size=11008, num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, head_dim=128, rope_theta=10000.0,
        qk_norm=False, tie_word_embeddings=False,
    ),
    "tiny": ModelConfig(
        model_type="qwen3", vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, tie_word_embeddings=True,
    ),
    "tiny-gemma3n": ModelConfig(
        model_type="gemma3n_text", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_hidden_layers=6, num_attention_heads=4,
        num_key_value_heads=2, head_dim=32, tie_word_embeddings=True,
        hidden_act="gelu_pytorch_tanh", gemma_norm=True, post_norms=True,
        rope_theta=1_000_000.0, rope_local_theta=10_000.0,
        sliding_window=16, logit_softcap=30.0,
        layer_types=(
            "sliding_attention", "sliding_attention", "full_attention",
            "sliding_attention", "sliding_attention", "full_attention",
        ),
        altup_num_inputs=4, laurel_rank=16, hidden_size_per_layer_input=32,
        vocab_size_per_layer_input=256, num_kv_shared_layers=2,
        activation_sparsity=(0.95, 0.95, 0.0, 0.0, 0.0, 0.0),
    ),
    "tiny-moe": ModelConfig(
        model_type="qwen3_moe", vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, tie_word_embeddings=True,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128,
    ),
}
