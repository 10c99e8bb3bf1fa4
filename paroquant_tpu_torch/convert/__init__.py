from .checkpoint import load_checkpoint, save_awq_checkpoint, save_paro_checkpoint
from .gptq import gptq_quantize_model, gptq_quantize_weight
from .interop import params_from_jax
from .rtn import quantize_linear_rtn, quantize_model_rtn, rtn_export_linear, rtn_export_model
