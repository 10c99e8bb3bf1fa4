from .generator import GenerationResult, GenerationStats, Generator
from .sampling import SamplingParams, sample_token
