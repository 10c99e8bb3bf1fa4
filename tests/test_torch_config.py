"""The port's own copy of ModelConfig against the JAX package's: every preset
and a set of HF config.json dicts map to the same fields and properties."""

import dataclasses

import pytest

from paroquant_tpu.models import config as jc
from paroquant_tpu_torch.models import config as tc

HF_DICTS = {
    "qwen3": {"model_type": "qwen3", "vocab_size": 1000, "hidden_size": 256,
              "intermediate_size": 512, "num_hidden_layers": 3, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 64, "rope_theta": 1e6,
              "tie_word_embeddings": True},
    "qwen2_bias": {"model_type": "qwen2", "hidden_size": 128, "num_attention_heads": 4,
                   "num_hidden_layers": 2, "sliding_window": 64},
    "llama_paro": {"model_type": "llama", "hidden_size": 512, "num_attention_heads": 8,
                   "quantization_config": {"quant_method": "paroquant", "format": "paro-tpu",
                                           "bits": 4, "group_size": 128}},
    "gemma3_layers": {"model_type": "gemma3_text", "hidden_size": 256, "num_attention_heads": 4,
                      "num_hidden_layers": 3, "query_pre_attn_scalar": 64,
                      "rope_local_base_freq": 1e4, "final_logit_softcapping": 30.0,
                      "layer_types": ["sliding_attention", "sliding_attention",
                                      "full_attention"], "sliding_window": 32},
    "qwen3_moe": {"model_type": "qwen3_moe", "num_experts": 8, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 64, "mlp_only_layers": [0]},
    "mixtral": {"model_type": "mixtral", "num_local_experts": 4, "intermediate_size": 256},
    "qwen3_next": {"model_type": "qwen3_next", "num_hidden_layers": 8,
                   "full_attention_interval": 4, "num_experts": 4},
    "vlm": {"model_type": "gemma3", "text_config": {"hidden_size": 256,
                                                     "num_attention_heads": 4},
            "vision_config": {"hidden_size": 64, "patch_size": 14},
            "mm_tokens_per_image": 16, "image_token_index": 7},
}

PROPS = ("is_moe", "is_vlm", "is_gemma3n", "attn_scale", "rotary_dim",
         "num_full_attn_layers", "quantization")


def _same(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for p in PROPS:
        assert getattr(t, p) == getattr(j, p), p
    for i in range(j.num_hidden_layers):
        assert t.layer_sliding_window(i) == j.layer_sliding_window(i)
        assert t.kv_share_source(i) == j.kv_share_source(i)


@pytest.mark.parametrize("name", sorted(jc.PRESETS))
def test_presets_match(name):
    assert sorted(tc.PRESETS) == sorted(jc.PRESETS)
    _same(tc.PRESETS[name], jc.PRESETS[name])


@pytest.mark.parametrize("name", sorted(HF_DICTS))
def test_from_hf_dict_matches(name):
    _same(tc.from_hf_dict(HF_DICTS[name]), jc.from_hf_dict(HF_DICTS[name]))
