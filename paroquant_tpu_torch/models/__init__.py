from .config import PRESETS, ModelConfig, from_hf_dict, load_config
from .decoder import (
    DenseLinear,
    KVCache,
    apply_linear,
    decode_step,
    greedy_decode_scan,
    greedy_generate,
    init_params,
    merge_projections,
    model_forward,
    prefill,
)
