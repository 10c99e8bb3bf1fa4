"""PyTorch/CUDA port of paroquant_tpu (W4 inference with learned pairwise rotations).

The JAX package `paroquant_tpu` is the reference; this package mirrors its
sub-packages and module names (`models/`, `ops/`, `kernels/`, `convert/`,
`serve/`, `utils/`) and imports torch, numpy and the standard library only.
Every entry point takes `device=` ("cuda" by default; it raises when CUDA is
missing and the caller did not ask for "cpu").
"""
