"""Calibration: pseudo-quantized linears, the block-wise distillation loop
and the layer-wise loop over a model (dense decoders), and the calibration data."""

from .calibrate import CalibConfig, calibrate_model
from .pseudo import (
    PseudoQuantLinear,
    export_quantized,
    init_quantizer,
    make_pseudo_linear,
    pseudo_linear_forward,
    pseudo_quantized_weight,
)
from .train import optimize_linears
