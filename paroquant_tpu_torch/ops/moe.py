"""Token-choice MoE expert dispatch (Qwen3-MoE semantics), in torch.

Counterpart of `paroquant_tpu/ops/moe.py`. Expert weights are stacked
tensors: gate_proj / up_proj [E, H, I], down_proj [E, I, H], or their
quantized form `QuantizedMoEExperts` (one shared rotation per projection
across experts). Every product is computed in f32, as JAX's are.

`moe_apply` takes JAX's cut: the gather path when T * K <= 64 and no
activations are asked for (decode), the ragged path otherwise (prefill,
verify windows, GPTQ's taps).

- gather (`_moe_gather`): the selected experts' weights per token (for
  quantized experts the packed buffers are gathered first, then only those
  slices dequantized), batched products per (token, slot). It makes no host
  sync, so the decode step stays free of them.
- ragged (`_moe_ragged`): JAX sorts the token-expert assignments by expert
  and runs `lax.ragged_dot`. torch has no ragged dot, so the assignments are
  sorted stably (rows in JAX's order), the segment lengths go to the host
  once a call, and each expert with rows gets one `torch.matmul` on its
  contiguous segment. Only those experts are dequantized. The weighted rows
  go back to assignment order and each token's K rows are summed, with no
  atomic adds, so the result is the same on every run.
- capacity (`_moe_capacity`): JAX's capacity-bucketed ablation, which drops
  the assignments past an expert's capacity.

JAX runs these products outside any Pallas kernel (`lax.ragged_dot`,
einsums, `vmap`), so plain torch is their port.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class QuantizedMoEExperts(NamedTuple):
    """Stacked quantized experts with ONE shared rotation per projection:
    gate and up share the hidden-side rotation, down has its own. Packed
    weights keep the expert dim leading (PARO-TPU packing per expert)."""

    gate_qweight: torch.Tensor  # uint8 [E, H//2, I_moe]
    gate_scales: torch.Tensor  # bf16 [E, G_h, I_moe]
    gate_zeros: torch.Tensor  # bf16 [E, G_h, I_moe]
    up_qweight: torch.Tensor  # [E, H//2, I_moe]
    up_scales: torch.Tensor
    up_zeros: torch.Tensor
    down_qweight: torch.Tensor  # [E, I_moe//2, H]
    down_scales: torch.Tensor  # [E, G_i, H]
    down_zeros: torch.Tensor
    gate_up_rot: torch.Tensor  # [G_h, S, S] shared, 1/channel_scale folded in
    down_rot: torch.Tensor  # [G_i, S, S] shared

    @property
    def group_size(self) -> int:
        return self.gate_up_rot.shape[-1]

    def to(self, device) -> "QuantizedMoEExperts":
        return QuantizedMoEExperts(*(t.to(device) for t in self))


def pack_stacked(q: torch.Tensor, n_bits: int, group_size: int) -> torch.Tensor:
    """q int [E, In, Out] in [0, 2^bits) -> each expert packed as
    `ops/packing.py::pack_wq_tpu` packs [In, Out]: uint8 [E, In//2, Out]
    (4 bits, group-aligned half-split) or [E, In, Out] (8 bits)."""
    E, In, Out = q.shape
    if n_bits == 8:
        return q.to(torch.uint8).contiguous()
    if n_bits != 4:
        raise ValueError(f"unsupported n_bits={n_bits} (4 or 8)")
    if In % group_size:
        raise ValueError(f"in_features {In} is not a multiple of group_size {group_size}")
    half = group_size // 2
    qg = q.reshape(E, In // group_size, group_size, Out).to(torch.uint8)
    return ((qg[:, :, :half] & 0xF) | ((qg[:, :, half:] & 0xF) << 4)).reshape(
        E, In // 2, Out).contiguous()


def _unpack_stacked(packed: torch.Tensor, in_features: int, group_size: int) -> torch.Tensor:
    """Inverse of pack_stacked, as uint8 [E, In, Out]."""
    E, rows, Out = packed.shape
    if rows == in_features:
        return packed
    half = group_size // 2
    p = packed.reshape(E, rows // half, half, Out)
    return torch.cat([p & 0xF, p >> 4], dim=2).reshape(E, in_features, Out)


def _dequant_stacked(qweight, scales, zeros, group_size) -> torch.Tensor:
    """[E, I//2, O] packed -> [E, I, O] float32: (q - z) * s per group."""
    E, G, O = scales.shape
    q = _unpack_stacked(qweight, G * group_size, group_size)
    qg = q.reshape(E, G, group_size, O).to(torch.float32)
    w = (qg - zeros[:, :, None, :].to(torch.float32)) * scales[:, :, None, :].to(torch.float32)
    return w.reshape(E, G * group_size, O)


def _rotate_tokens(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x [T, H] -> rotated by per-group matrices [G, S, S] (scales folded),
    in f32, back to x's dtype."""
    G, S, _ = rot.shape
    xg = x.reshape(-1, G, S).to(torch.float32)
    y = torch.einsum("gij,tgj->tgi", rot.to(torch.float32), xg)
    return y.reshape(x.shape).to(x.dtype)


def _projections(experts):
    """((qweight, scales, zeros) or the dense stack) of gate, up and down,
    and the shared rotations (None for dense experts)."""
    if isinstance(experts, QuantizedMoEExperts):
        e = experts
        return ((e.gate_qweight, e.gate_scales, e.gate_zeros),
                (e.up_qweight, e.up_scales, e.up_zeros),
                (e.down_qweight, e.down_scales, e.down_zeros),
                e.gate_up_rot, e.down_rot)
    return (experts["gate_proj"], experts["up_proj"], experts["down_proj"], None, None)


def _weights(proj, group_size, select=None) -> torch.Tensor:
    """One projection's f32 weights [E', In, Out]: the experts in `select`
    (a LongTensor; all when None), dequantized where quantized."""
    if isinstance(proj, tuple):
        qw, s, z = proj if select is None else (t.index_select(0, select) for t in proj)
        return _dequant_stacked(qw, s, z, group_size)
    w = proj if select is None else proj.index_select(0, select)
    return w.to(torch.float32)


def _expert_weights(experts: dict[str, Any] | QuantizedMoEExperts):
    """(gate [E, H, I], up [E, H, I], down [E, I, H], gate_up rot, down rot);
    quantized experts dequantized to f32, the rotations None for dense ones."""
    gate, up, down, rot_gu, rot_d = _projections(experts)
    gs = experts.group_size if isinstance(experts, QuantizedMoEExperts) else None
    if gs is None:
        return gate, up, down, None, None
    return _weights(gate, gs), _weights(up, gs), _weights(down, gs), rot_gu, rot_d


def moe_apply(
    experts: dict[str, Any] | QuantizedMoEExperts,
    x: torch.Tensor,  # [T, H]
    idx: torch.Tensor,  # int [T, K] selected experts
    gates: torch.Tensor,  # [T, K] combine weights
    quant_mode: str = "xla",
    capacity_factor: float = 2.0,
    return_act: bool = False,  # also return the down_proj inputs [T*K, I_moe]
):
    """The routed experts' output [T, H] (x's dtype); with return_act=True
    also the down_proj inputs, pooled over the assignments in expert order
    (GPTQ's shared Hessian). quant_mode and capacity_factor are JAX's
    arguments; neither changes the path taken."""
    T, K = idx.shape
    if T * K <= 64 and not return_act:
        return _moe_gather(experts, x, idx, gates)
    return _moe_ragged(experts, x, idx, gates, return_act=return_act)


def _moe_ragged(experts, x, idx, gates, return_act=False):
    """Every assignment, grouped by expert: a stable sort by expert id, one
    host read of the segment lengths, then one matmul per expert segment."""
    gate, up, down, rot_gu, rot_d = _projections(experts)
    gs = experts.group_size if isinstance(experts, QuantizedMoEExperts) else None
    E = (gate[0] if isinstance(gate, tuple) else gate).shape[0]
    T, H = x.shape
    K = idx.shape[1]
    xr = x if rot_gu is None else _rotate_tokens(x, rot_gu)

    flat_e = idx.reshape(-1).to(torch.int64)
    order = torch.argsort(flat_e, stable=True)
    src_tok = order // K  # the token of each sorted assignment
    xs = xr.index_select(0, src_tok).to(torch.float32)  # [N, H]
    counts = torch.bincount(flat_e, minlength=E).tolist()  # the call's one host sync
    present = [e for e in range(E) if counts[e]]
    select = None if len(present) == E else torch.tensor(present, device=x.device)
    spans, start = [], 0
    for e in present:
        spans.append((start, start + counts[e]))
        start += counts[e]

    def grouped(inp, proj):
        w = _weights(proj, gs, select)  # [P, In, Out] f32, this projection only
        return torch.cat([inp[a:b] @ w[j] for j, (a, b) in enumerate(spans)])

    act = torch.nn.functional.silu(grouped(xs, gate)) * grouped(xs, up)  # [N, I] f32
    if rot_d is not None:
        act = _rotate_tokens(act.to(x.dtype), rot_d).to(torch.float32)
    ys = grouped(act, down)  # [N, H]
    w = gates.reshape(-1).index_select(0, order).to(torch.float32)[:, None]
    # back to assignment order, then each token's K rows summed: JAX's
    # scatter-add without atomics, so a call is deterministic on the card
    y = torch.empty_like(ys).index_copy_(0, order, ys * w).reshape(T, K, H).sum(dim=1)
    y = y.to(x.dtype)
    return (y, act) if return_act else y


def _moe_gather(experts, x, idx, gates):
    """Per token, the selected experts' weights (packed buffers gathered
    before the dequant); no host sync."""
    T, K = idx.shape
    flat = idx.reshape(-1).to(torch.int64)
    gate, up, down, rot_gu, rot_d = _projections(experts)
    gs = experts.group_size if isinstance(experts, QuantizedMoEExperts) else None

    def picked(proj):
        w = _weights(proj, gs, flat)  # [T*K, In, Out] f32
        return w.reshape(T, K, *w.shape[1:])

    xr = x if rot_gu is None else _rotate_tokens(x, rot_gu)
    xk = xr.to(torch.float32)[:, None, None, :]  # [T, 1, 1, H]
    g = torch.matmul(xk, picked(gate))[:, :, 0]  # [T, K, I]
    u = torch.matmul(xk, picked(up))[:, :, 0]
    act = (torch.nn.functional.silu(g) * u).to(x.dtype)
    if rot_d is not None:
        G, S, _ = rot_d.shape
        ag = act.reshape(T, K, G, S).to(torch.float32)
        act = torch.einsum("gij,tkgj->tkgi", rot_d.to(torch.float32), ag).reshape(
            act.shape).to(x.dtype)
    y = torch.matmul(act.to(torch.float32)[:, :, None, :], picked(down))[:, :, 0]  # [T, K, H]
    return torch.sum(y * gates[..., None].to(torch.float32), dim=1).to(x.dtype)


def _moe_capacity(experts, x, idx, gates, capacity_factor):
    """JAX's capacity-bucketed ablation: each expert takes at most
    `capacity` assignments, in token order; the rest are dropped."""
    gate_w, up_w, down_w, rot_gu, rot_d = _expert_weights(experts)
    E = gate_w.shape[0]
    T, H = x.shape
    K = idx.shape[1]
    capacity = min(max(int(T * K * capacity_factor / E), 8), T)
    xr = x if rot_gu is None else _rotate_tokens(x, rot_gu)

    flat_e = idx.reshape(-1).to(torch.int64)  # [T*K]
    onehot = torch.nn.functional.one_hot(flat_e, E)  # [T*K, E]
    pos = torch.cumsum(onehot, dim=0) - onehot  # prior count per expert
    slot = torch.sum(pos * onehot, dim=1)
    keep = slot < capacity
    dest = torch.where(keep, flat_e * capacity + slot, torch.full_like(slot, E * capacity))
    token_of = torch.arange(T, device=x.device).repeat_interleave(K)
    xe = torch.zeros((E * capacity + 1, H), dtype=xr.dtype, device=x.device)
    xe[dest] = xr[token_of]
    xe = xe[:-1].reshape(E, capacity, H).to(torch.float32)

    g = torch.bmm(xe, gate_w.to(torch.float32))
    u = torch.bmm(xe, up_w.to(torch.float32))
    act = (torch.nn.functional.silu(g) * u).to(x.dtype)
    if rot_d is not None:
        G, S, _ = rot_d.shape
        ag = act.reshape(E, capacity, G, S).to(torch.float32)
        act = torch.einsum("gij,ecgj->ecgi", rot_d.to(torch.float32), ag).reshape(
            act.shape).to(x.dtype)
    ye = torch.bmm(act.to(torch.float32), down_w.to(torch.float32))  # [E, C, H]
    ye_flat = torch.cat([ye.reshape(E * capacity, H), torch.zeros((1, H), device=x.device)])
    per_assign = ye_flat[dest]  # dropped assignments read the zero row
    w = (gates.reshape(-1) * keep.to(gates.dtype))[:, None].to(torch.float32)
    return (per_assign * w).reshape(T, K, H).sum(dim=1).to(x.dtype)


def shared_rotation(pairs, theta, inv_channel_scales, group_size: int, rot_dtype,
                    device) -> torch.Tensor:
    """The shared rotation of one projection side, [G, S, S] in rot_dtype:
    the composed Givens stages (in f32) with 1/channel_scale folded into the
    columns, as `QuantizedMoEExperts` stores it."""
    from . import rotation as rot_ops

    def host(a, dtype):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.detach().to("cpu", dtype)

    form = rot_ops.to_permutation_form(host(pairs, torch.int32), group_size, device)
    R = rot_ops.build_rotation_matrices(host(theta, torch.float32).to(device), form, group_size,
                                        dtype=torch.float32)
    inv = host(inv_channel_scales, torch.float32).reshape(-1, group_size).to(device)
    return (R * inv[:, None, :]).to(rot_dtype)
