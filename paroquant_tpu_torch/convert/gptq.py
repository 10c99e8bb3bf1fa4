"""GPTQ baseline: Hessian-compensated round-to-nearest W4 quantization.

Counterpart of `paroquant_tpu/convert/gptq.py` for the dense, MoE and hybrid families:
classic GPTQ (Frantar et al., arXiv 2210.17323). Per output row, input
channels are quantized in order and each column's rounding error is
compensated into the columns not yet quantized through the upper Cholesky
factor of the damped inverse Hessian. The output is the RTN baseline's
format (identity rotation, theta = 0, unit channel scales; or the
Hadamard-equivalent mixer with hadamard=True, the QuaRot recipe), so its
checkpoints load through the standard loaders.

- `gptq_quantize_weight` is JAX's two loops in plain torch: a Python loop
  over a group's columns (rank-1 updates of the group's later columns, no
  host sync inside it) and one matmul per group that carries the group's
  error into every later column. The group's quantizer is taken from the
  compensated weights when the group is reached.
- The Hessians are X^T X of each linear's input, from
  `models.decoder.layer_forward(..., return_taps=True)`: the layer math the
  runtime runs.
- JAX computes each product here at `Precision.HIGHEST`; these are f32
  products with TF32 off (torch's default for matmuls).
- The group quantizer is `ops/quant.py::calc_scales_and_zero_points(...,
  jit=True)`, JAX's as XLA compiles it, so an identity Hessian gives the
  port's RTN bit for bit.
- `torch.linalg.cholesky` raises on a matrix that is not positive definite,
  where JAX's returns NaN.

- MoE layers (`_gptq_moe`): each stacked projection is GPTQ'd against ONE
  Hessian shared by the experts (gate/up the layer input's, down the routed
  down_proj inputs pooled over every assignment), the counterpart of the
  runtime's shared rotations. JAX runs the experts one by one under
  `lax.map`; with a shared Hessian every output row is quantized on its own,
  so the port runs the [E * O, I] rows of all experts in one pass. A shared
  expert is GPTQ'd as a standard GLU; the router and the shared expert's
  gate stay dense.

- A hybrid's delta-net layers (`_hybrid_tap_hessians`, JAX's
  `_hybrid_layer_body`): in_proj_qkvz and out_proj are GPTQ'd against the
  Hessians of their inputs, the taps "la_qkvz" and "la_out"; in_proj_ba
  stays dense, and the layer's MLP or MoE block is GPTQ'd as on any layer.

gemma3n raises JAX's NotImplementedError in `gptq_quantize_model`: JAX's
GPTQ baseline does not support that family either.
"""

from __future__ import annotations

import functools
import logging
from typing import Any

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import (DenseLinear, embed, layer_forward, linear_layer_forward,
                              rope_tables_per_layer)
from ..ops import quant, rotation as rot_ops
from ..ops.moe import QuantizedMoEExperts
from ..ops.qlinear import QuantizedLinear, make_quantized_linear
from ..utils.device import resolve_device
from .rtn import _rotation_params, _to_device

__all__ = ["gptq_quantize_weight", "gptq_quantize_model"]

logger = logging.getLogger("paroquant_tpu_torch.convert")


def _hessian_chol(hessian: torch.Tensor, percdamp: float = 0.01):
    """(U, dead): the upper Cholesky factor of the damped inverse Hessian and
    the dead-channel mask (channels never activated)."""
    H = hessian.to(torch.float32)
    n = H.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=H.device)
    dead = torch.diagonal(H) <= 0.0
    H = H + torch.diag(dead.to(torch.float32))
    damp = percdamp * torch.mean(torch.diagonal(H))
    Hd = H + damp * eye
    Hd = (Hd + Hd.T) * 0.5
    L = torch.linalg.cholesky(Hd)
    Hinv = torch.cholesky_solve(eye, L)
    Hinv = (Hinv + Hinv.T) * 0.5
    U = torch.linalg.cholesky(Hinv).T  # upper triangular, U[j, j] > 0
    return U, dead


def gptq_quantize_weight(
    w: torch.Tensor,
    hessian: torch.Tensor,
    n_bits: int = 4,
    group_size: int = 128,
    percdamp: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPTQ-quantize one weight. w [O, I] (y = x @ w.T), hessian [I, I] = the
    sum of X^T X over the calibration inputs X.

    Returns (q int32 [O, I], scales f32 [O, G], zeros int32 [O, G]) with
    dequant(q) = (q - zeros) * scales per group, on w's device.
    """
    U, dead = _hessian_chol(hessian.to(w.device), percdamp)
    return _gptq_core(w, U, dead, n_bits=n_bits, group_size=group_size)


def _gptq_core(w: torch.Tensor, U: torch.Tensor, dead: torch.Tensor, *, n_bits: int,
               group_size: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    O, I = w.shape
    if I % group_size:
        raise ValueError(f"in_features {I} is not a multiple of group_size {group_size}")
    G = I // group_size
    qmax = 2**n_bits - 1
    dev = w.device
    # dead input channels: pin the weight to 0
    wbuf = torch.where(dead[None, :], 0.0, w.to(torch.float32))
    q = torch.empty((O, I), dtype=torch.int32, device=dev)
    scales = torch.empty((O, G), dtype=torch.float32, device=dev)
    zeros = torch.empty((O, G), dtype=torch.int32, device=dev)
    for g in range(G):
        lo, hi = g * group_size, (g + 1) * group_size
        wg = wbuf[:, lo:hi].clone()
        # the group's quantizer, from the compensated weights at arrival
        qp = quant.calc_scales_and_zero_points(wg, group_size, n_bits, jit=True)
        scale = torch.clamp(qp.scale.reshape(O), 1e-5, 1e5)
        zero = torch.clamp(-torch.round(qp.zero_point_float.reshape(O)), 0, qmax)
        ug = U[lo:hi, lo:hi]
        diag = torch.diagonal(ug)
        qg = torch.empty((O, group_size), dtype=torch.float32, device=dev)
        err = torch.empty((O, group_size), dtype=torch.float32, device=dev)
        for j in range(group_size):
            wj = wg[:, j]
            qj = torch.clamp(torch.round(wj / scale) + zero, 0, qmax)
            e = (wj - (qj - zero) * scale) / diag[j]
            # compensate into the not-yet-quantized columns of this group
            wg[:, j + 1:] -= e[:, None] * ug[j, j + 1:][None, :]
            qg[:, j] = qj
            err[:, j] = e
        # carry the group's error into all later groups: one matmul
        if hi < I:
            wbuf[:, hi:] -= err @ U[lo:hi, hi:]
        q[:, lo:hi] = qg.to(torch.int32)
        scales[:, g] = scale
        zeros[:, g] = zero.to(torch.int32)
    return q, scales, zeros


# ---------------------------------------------------------------------------
# Model-level driver
# ---------------------------------------------------------------------------

# tap name -> the linears fed by that activation
_TAP_LINEARS = {
    "qkv": ("q_proj", "k_proj", "v_proj"),
    "o": ("o_proj",),
    "mlp": ("gate_proj", "up_proj"),
    "down": ("down_proj",),
}


def _hessians(taps: dict) -> dict:
    """Each tap's X^T X (f32)."""
    hs = {}
    for name, tap in taps.items():
        xt = tap.reshape(-1, tap.shape[-1]).to(torch.float32)
        hs[name] = xt.T @ xt
    return hs


@torch.no_grad()
def _tap_hessians(lp, x, config, layer_idx, cos, sin, positions):
    """One layer forward (dense weights) returning each tap's X^T X and the
    layer output."""
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    out, _, taps = layer_forward(lp, x, config, layer_idx, cos, sin, positions, None, zero,
                                 "xla", return_taps=True)
    return out, _hessians(taps)


@torch.no_grad()
def _hybrid_tap_hessians(lp, x, config, layer_idx):
    """A delta-net layer's forward (dense weights, states from zero): the
    output and each tap's X^T X ("la_qkvz", "la_out", "mlp", "down" /
    "moe_down" / "shared_down")."""
    out, _, _, taps = linear_layer_forward(lp, x, config, layer_idx, None, None, "xla",
                                           return_taps=True)
    return out, _hessians(taps)


@torch.no_grad()
def _hybrid_layer_apply(lp, x, config, layer_idx):
    return linear_layer_forward(lp, x, config, layer_idx, None, None, "xla")[0]


@torch.no_grad()
def _layer_apply(lp, x, config, layer_idx, cos, sin, positions):
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    out, _ = layer_forward(lp, x, config, layer_idx, cos, sin, positions, None, zero, "xla")
    return out


@functools.lru_cache(maxsize=8)
def _hadamard_matrices(in_features: int, group_size: int, device: str) -> torch.Tensor:
    """Composed per-group Hadamard-equivalent mixers M [G, S, S] f32."""
    params, theta = _rotation_params(in_features, group_size, 8, 0, True)
    form = rot_ops.to_permutation_form(params.pairs, group_size, device)
    return rot_ops.build_rotation_matrices(theta.to(device), form, group_size,
                                           dtype=torch.float32)


def _rotate_weight_and_hessian(w: torch.Tensor, H: torch.Tensor, M: torch.Tensor):
    """Move (w [O, I], H [I, I]) into the coordinates of the per-group mixers
    M [G, S, S]: the runtime computes y = (M x) @ Wd, so GPTQ must see Wd's
    coordinates: w_rot = w @ Mb^T and H_rot = Mb H Mb^T (Mb block-diagonal),
    symmetrized against rounding."""
    O, I = w.shape
    G, S, _ = M.shape
    w_rot = torch.einsum("ogj,gij->ogi", w.to(torch.float32).reshape(O, G, S), M).reshape(O, I)
    h = torch.einsum("gij,gjX->giX", M, H.to(torch.float32).reshape(G, S, I)).reshape(I, I)
    h_rot = torch.einsum("Xgj,gij->Xgi", h.reshape(I, G, S), M).reshape(I, I)
    return w_rot, (h_rot + h_rot.T) * 0.5


def _gptq_linear(
    lin: DenseLinear, hessian: torch.Tensor, *, n_bits: int, group_size: int, percdamp: float,
    rot_dtype, hadamard: bool = False,
) -> tuple[QuantizedLinear, dict[str, Any]]:
    """Quantize one dense linear; returns (runtime layer, export dict).

    hadamard=True composes the Hadamard-equivalent group mixer with GPTQ (the
    QuaRot recipe) in the PARO pairs/theta checkpoint schema."""
    w = lin.w.to(torch.float32).T  # [O, I]
    dev = w.device
    I = w.shape[1]
    params, theta = _rotation_params(I, group_size, 8, 0, hadamard)
    if hadamard:
        M = _hadamard_matrices(I, group_size, str(dev))
        w, hessian = _rotate_weight_and_hessian(w, hessian, M)
    else:
        theta = torch.zeros_like(params.theta)
    q, s, z = gptq_quantize_weight(w, hessian, n_bits=n_bits, group_size=group_size,
                                   percdamp=percdamp)
    bias = None if lin.b is None else lin.b.to(torch.float32)
    runtime = make_quantized_linear(
        q, s, z, params.pairs, theta, torch.ones(I, dtype=torch.float32, device=dev), group_size,
        bias=bias, rot_dtype=rot_dtype, n_bits=n_bits, device=dev,
    )
    export = {
        "q": q.cpu().numpy(), "scales": s.cpu().numpy(), "zeros": z.cpu().numpy(),
        "pairs": params.pairs.cpu().numpy(), "theta": theta.to(torch.float32).cpu().numpy(),
        "inv_channel_scales": np.ones(I, np.float32),
        "bias": None if bias is None else bias.cpu().numpy(),
        "n_bits": n_bits, "group_size": group_size,
    }
    return runtime, export


def _gptq_moe(
    experts: dict[str, Any], h_gu: torch.Tensor, h_down: torch.Tensor, *, n_bits: int,
    group_size: int, percdamp: float, rot_dtype, hadamard: bool,
) -> tuple[QuantizedMoEExperts, dict[str, Any]]:
    """GPTQ the stacked expert projections with a SHARED Hessian per
    projection across experts. Returns (QuantizedMoEExperts, export dict in
    `optim/pseudo_moe.py::export_quantized_moe`'s schema with identity or
    Hadamard rotations)."""
    from ..optim.pseudo_moe import quantized_moe_from_export

    dev = experts["gate_proj"].device
    E, H, I_moe = experts["gate_proj"].shape

    def quantize_stack(w_stack, hessian, in_dim):
        """w_stack [E, in_dim, O] GPTQ'd row by row against one Hessian."""
        O = w_stack.shape[2]
        ws = w_stack.to(torch.float32).transpose(1, 2).reshape(E * O, in_dim)
        if hadamard:
            M = _hadamard_matrices(in_dim, group_size, str(dev))
            ws, hessian = _rotate_weight_and_hessian(ws, hessian, M)
        U, dead = _hessian_chol(hessian, percdamp)
        q, s, z = _gptq_core(ws, U, dead, n_bits=n_bits, group_size=group_size)
        del ws
        return {"q": q.reshape(E, O, in_dim).cpu().numpy(),
                "scales": s.reshape(E, O, -1).cpu().numpy(),
                "zeros": z.reshape(E, O, -1).cpu().numpy()}

    export: dict[str, Any] = {"moe": True, "n_bits": n_bits, "group_size": group_size}
    # gate/up share the layer input's Hessian
    export["gate"] = quantize_stack(experts["gate_proj"], h_gu, H)
    export["up"] = quantize_stack(experts["up_proj"], h_gu, H)
    export["down"] = quantize_stack(experts["down_proj"], h_down, I_moe)
    for side, in_dim in (("gate_up", H), ("down", I_moe)):
        prm, theta = _rotation_params(in_dim, group_size, 8, 0, hadamard)
        theta = torch.zeros_like(prm.theta) if theta is None else theta
        export[f"{side}_theta"] = theta.to(torch.float32).cpu().numpy()
        export[f"{side}_pairs"] = prm.pairs.cpu().numpy()
        export[f"{side}_inv_channel_scales"] = np.ones(in_dim, np.float32)
    return quantized_moe_from_export(export, rot_dtype, dev), export


@torch.no_grad()
def gptq_quantize_model(
    params: dict[str, Any],
    config: ModelConfig,
    tokens: np.ndarray,  # int32 [N, T] calibration token blocks
    *,
    n_bits: int = 4,
    group_size: int = 128,
    percdamp: float = 0.01,
    batch_size: int = 4,
    rot_dtype=torch.bfloat16,
    hadamard: bool = False,
    log_fn=None,
    device="cuda",
) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Sequential GPTQ over the decoder stack, on `device`.

    Layer l's Hessians come from the inputs that the already-quantized
    layers 0..l-1 produce; then every eligible linear is GPTQ-quantized and
    swapped in before the next layer. The last batch takes the remainder
    N mod batch_size, so every sample counts.

    MoE layers: the routed experts' stacks with a shared Hessian per
    projection, the shared expert as a standard GLU.

    Returns (quantized runtime params on `device`, per-layer export dicts
    for save_paro_checkpoint: the schema of convert/rtn.py::rtn_export_model).
    """
    if config.is_gemma3n:
        raise NotImplementedError("GPTQ baseline does not support gemma3n")
    dev = resolve_device(device)
    params = _to_device(params, dev)
    tokens = np.asarray(tokens, np.int32)
    N, T = tokens.shape
    bs = min(batch_size, N)
    batch_sizes = [bs] * (N // bs) + ([N % bs] if N % bs else [])
    rope_by_bs = {}
    for b in set(batch_sizes):
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(b, T)
        rope_by_bs[b] = (pos, rope_tables_per_layer(pos, config))
    offs = np.cumsum([0] + batch_sizes)
    xs = [embed(params, config, torch.from_numpy(tokens[offs[i]:offs[i + 1]]).to(dev))
          for i in range(len(batch_sizes))]

    out_layers: list[dict[str, Any]] = []
    exports: list[dict[str, Any]] = []
    for li, lp in enumerate(params["layers"]):
        is_linear = config.layer_is_linear(li)
        # 1) each tap's Hessian, with the dense layer
        hs_acc: dict[str, torch.Tensor] | None = None
        for x in xs:
            if is_linear:
                _, hs = _hybrid_tap_hessians(lp, x, config, li)
            else:
                positions, rope_by_layer = rope_by_bs[x.shape[0]]
                cos, sin = rope_by_layer[li]
                _, hs = _tap_hessians(lp, x, config, li, cos, sin, positions)
            hs_acc = hs if hs_acc is None else {k: hs_acc[k] + hs[k] for k in hs_acc}

        # 2) GPTQ every eligible linear of this layer
        nlp = dict(lp)
        mlp = dict(lp["mlp"])
        if "gate_up_proj" in mlp:
            (log_fn or logger.warning)(
                f"gptq layer {li}: mlp.gate_up_proj is merged — left dense "
                "(run GPTQ before merge_projections)")
        exp: dict[str, Any] = {}
        for tap, names in _TAP_LINEARS.items():
            for name in names:
                holder = nlp if tap in ("qkv", "o") else mlp
                key = name if tap in ("qkv", "o") else f"mlp.{name}"
                lin = holder.get(name)
                if not isinstance(lin, DenseLinear):
                    continue
                if lin.w.shape[0] % group_size or tap not in hs_acc:
                    continue
                holder[name], exp[key] = _gptq_linear(
                    lin, hs_acc[tap], n_bits=n_bits, group_size=group_size,
                    percdamp=percdamp, rot_dtype=rot_dtype, hadamard=hadamard,
                )
        kw = dict(n_bits=n_bits, group_size=group_size, percdamp=percdamp,
                  rot_dtype=rot_dtype, hadamard=hadamard)
        # a delta-net layer: in_proj_qkvz and out_proj; in_proj_ba (the
        # decay/gate projection) stays dense
        if is_linear and "linear_attn" in nlp:
            la = dict(nlp["linear_attn"])
            for name, hkey in (("in_proj_qkvz", "la_qkvz"), ("out_proj", "la_out")):
                lin = la.get(name)
                if (not isinstance(lin, DenseLinear) or lin.w.shape[0] % group_size
                        or hkey not in hs_acc):
                    continue
                la[name], exp[f"linear_attn.{name}"] = _gptq_linear(lin, hs_acc[hkey], **kw)
            nlp["linear_attn"] = la
        # MoE: the routed experts, one shared Hessian per projection
        if isinstance(mlp.get("experts"), dict) and "moe_down" in hs_acc:
            mlp["experts"], exp["mlp.experts"] = _gptq_moe(
                mlp["experts"], hs_acc["mlp"], hs_acc["moe_down"], **kw)
        # a shared expert: a standard GLU whose gate/up see the layer input
        if isinstance(mlp.get("shared_expert"), dict) and "shared_down" in hs_acc:
            se = dict(mlp["shared_expert"])
            for name, hkey in (("gate_proj", "mlp"), ("up_proj", "mlp"),
                               ("down_proj", "shared_down")):
                lin = se.get(name)
                if not isinstance(lin, DenseLinear) or lin.w.shape[0] % group_size:
                    continue
                se[name], exp[f"mlp.shared_expert.{name}"] = _gptq_linear(
                    lin, hs_acc[hkey], **kw)
            mlp["shared_expert"] = se
        nlp["mlp"] = mlp
        out_layers.append(nlp)
        exports.append(exp)

        # 3) feed the next layer the quantized layer's outputs
        if is_linear:
            xs = [_hybrid_layer_apply(nlp, x, config, li) for x in xs]
        else:
            xs = [_layer_apply(nlp, x, config, li, *rope_by_bs[x.shape[0]][1][li],
                               rope_by_bs[x.shape[0]][0]) for x in xs]
        if log_fn is not None:
            log_fn(f"gptq layer {li}: quantized {sorted(exp)}")

    out = dict(params)
    out["layers"] = out_layers
    return out, exports
