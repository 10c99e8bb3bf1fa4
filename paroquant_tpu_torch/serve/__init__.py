from .engine import Engine, EngineOverloaded, Request
from .generator import GenerationResult, GenerationStats, Generator
from .paged import PagedKVCache, paged_decode_step, paged_verify_step
from .sampling import SamplingParams, sample_batch, sample_token
