"""Turn the JAX package's params, given as numpy arrays, into the port's params.

`params_from_jax(tree, config, device)` takes the JAX param tree after
`jax.tree.map(np.asarray, params)`: nested dicts and lists whose linears are
`DenseLinear`, `QuantizedLinear` or `MergedQuantizedLinear` objects with
numpy leaves; a sparse layer's router and shared-expert gate are
`DenseLinear`s, its experts a dict of stacked arrays or a
`QuantizedMoEExperts`; a hybrid's delta-net layer a `linear_attn` dict of
linears and arrays; a gemma3n tree its `altup_projections` /
`altup_unembed_projections` lists and each layer's `altup` / `laurel` dicts;
a VLM tree its `vision` dict (the SigLIP tower: arrays, a list of layer
dicts of `DenseLinear`s with biases) and its `projector` dict, carried as
they are. The classes are recognised by name, so this module
imports nothing of JAX and both packages can compute from the same
weights. bf16
leaves arrive as numpy arrays of the ml_dtypes `bfloat16` type and are
reinterpreted bit for bit.

`paged_cache_from_jax(cache, device)` does the same for a JAX serving
`PagedKVCache` (as numpy; a hybrid's per-slot `conv` / `rec` states too),
so that both packages can start from the same page pool, and
`kv_cache_from_jax(cache, device)` for a contiguous `KVCache` with its
`LinearAttnStates`.

`w4_i4_from_jax(qweight, device)` takes the numpy view of the weight of
JAX's native-int4 kernel (`jnp.uint4 [I, O]`, one ml_dtypes `uint4` per
element) to the port's interleaved uint8 [I//2, O] layout
(`ops/packing.py::pack_w4_i4`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import DenseLinear
from ..ops.moe import QuantizedMoEExperts
from ..ops.packing import pack_w4_i4
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
    if kind == "QuantizedMoEExperts":
        return QuantizedMoEExperts(*(to_torch(a, dev) for a in node))
    if isinstance(node, dict):
        return {k: _convert(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, dev) for v in node]
    if isinstance(node, np.ndarray) or type(node).__module__ == "numpy":
        return to_torch(node, dev)
    raise TypeError(f"unsupported param node {kind}")


def params_from_jax(tree: dict[str, Any], config: ModelConfig, device="cuda") -> dict[str, Any]:
    """The port's params dict for a JAX param tree of numpy leaves (the dense,
    MoE, hybrid and gemma3n families, and a VLM's tower and projector)."""
    return _convert(tree, resolve_device(device))


def paged_cache_from_jax(cache, device="cuda"):
    """The port's PagedKVCache holding the same pool as a JAX PagedKVCache
    whose leaves are numpy arrays (k/v [Lf, P, ps, Hkv, D], int8 scales
    [Lf, P, Hkv, ps]; a hybrid's slot states conv [Ll, B, conv_dim, Kc-1]
    and rec [Ll, B, Hv, dk, dv])."""
    from ..serve.paged import PagedKVCache

    dev = resolve_device(device)

    def opt(a):
        return None if a is None else to_torch(a, dev)

    return PagedKVCache(to_torch(cache.k, dev), to_torch(cache.v, dev), opt(cache.k_scale),
                        opt(cache.v_scale), opt(getattr(cache, "conv", None)),
                        opt(getattr(cache, "rec", None)))


def kv_cache_from_jax(cache, device="cuda"):
    """The port's KVCache holding a JAX KVCache whose leaves are numpy arrays
    (per-layer k/v [B, Hkv, S, D], the length, a hybrid's `linear` states)."""
    from ..models.decoder import KVCache
    from ..models.linear_attn import LinearAttnStates

    dev = resolve_device(device)
    linear = None
    if cache.linear is not None:
        linear = LinearAttnStates(to_torch(cache.linear.conv, dev), to_torch(cache.linear.rec, dev))
    return KVCache(tuple(to_torch(k, dev) for k in cache.k), tuple(to_torch(v, dev) for v in cache.v),
                   to_torch(np.asarray(cache.length, np.int32), dev), linear)


def w4_i4_from_jax(qweight, device="cuda") -> torch.Tensor:
    """JAX's uint4 [I, O] weight (as numpy) -> interleaved uint8 [I//2, O]."""
    q = np.asarray(qweight).astype(np.uint8)
    return pack_w4_i4(torch.from_numpy(q)).to(resolve_device(device))
