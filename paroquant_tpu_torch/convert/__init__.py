from .checkpoint import load_checkpoint
from .interop import params_from_jax
from .rtn import quantize_linear_rtn, quantize_model_rtn
