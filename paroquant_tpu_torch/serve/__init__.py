from .engine import Engine, EngineOverloaded, Request
from .generator import (
    GenerationResult,
    GenerationStats,
    Generator,
    create_generator,
    detect_backend,
    load_tokenizer,
)
from .paged import PagedKVCache, paged_decode_step, paged_verify_step
from .router import EngineRouter
from .sampling import SamplingParams, sample_batch, sample_token
