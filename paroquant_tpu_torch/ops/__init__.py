"""Quantization, packing and rotation math, and the runtime quantized linear."""
