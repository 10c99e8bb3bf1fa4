"""Turn the JAX package's params, given as numpy arrays, into the port's params.

`params_from_jax(tree, config, device)` takes the JAX param tree after
`jax.tree.map(np.asarray, params)`: nested dicts and lists whose linears are
`DenseLinear`, `QuantizedLinear` or `MergedQuantizedLinear` objects with
numpy leaves. The classes are recognised by name, so this module imports
nothing of JAX and both packages can compute from the same weights. bf16
leaves arrive as numpy arrays of the ml_dtypes `bfloat16` type and are
reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import DenseLinear, _unsupported
from ..ops.qlinear import MergedQuantizedLinear, QuantizedLinear
from ..utils.device import resolve_device


def to_torch(a, device) -> torch.Tensor:
    """numpy (bf16 included) -> tensor on `device`, same bits."""
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _convert(node, dev):
    kind = type(node).__name__
    if kind == "DenseLinear":
        return DenseLinear(to_torch(node.w, dev), None if node.b is None else to_torch(node.b, dev))
    if kind == "QuantizedLinear":
        return QuantizedLinear(
            to_torch(node.qweight, dev), to_torch(node.scales, dev), to_torch(node.zeros, dev),
            to_torch(node.rot, dev), None if node.bias is None else to_torch(node.bias, dev),
        )
    if kind == "MergedQuantizedLinear":
        return MergedQuantizedLinear(
            to_torch(node.qweight, dev), to_torch(node.scales, dev), to_torch(node.zeros, dev),
            to_torch(node.rot, dev), None if node.bias is None else to_torch(node.bias, dev),
            tuple(node.out_splits),
        )
    if isinstance(node, dict):
        return {k: _convert(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, dev) for v in node]
    if isinstance(node, np.ndarray) or type(node).__module__ == "numpy":
        return to_torch(node, dev)
    raise TypeError(f"unsupported param node {kind}")


def params_from_jax(tree: dict[str, Any], config: ModelConfig, device="cuda") -> dict[str, Any]:
    """The port's params dict for a dense-family JAX param tree of numpy leaves."""
    _unsupported(config)
    return _convert(tree, resolve_device(device))
