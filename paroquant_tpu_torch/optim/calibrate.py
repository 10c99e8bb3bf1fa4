"""Layer-wise calibration of the dense, MoE, hybrid and gemma3n decoders, in torch.

Counterpart of `paroquant_tpu/optim/calibrate.py`:
  1. embed the calibration token batches once
  2. per decoder layer:
     a. run the FP layer -> teacher outputs
     b. swap each eligible linear for a PseudoQuantLinear with fresh rotation
        params (seeded random independent pairs, seed cfg.seed + layer, or
        the butterfly); a sparse layer's stacked experts for one
        PseudoQuantMoEExperts (optim/pseudo_moe.py: shared rotations, the
        down side seeded cfg.seed + layer + 1000)
     c. run the optimization stages (default: stage 1 channel_scales+angles
        @5e-2, stage 2 weight@1e-5 + quantizer@1e-6), optionally
        GPTQ-initializing the last one
     d. hard-quantize -> runtime QuantizedLinear; re-run the layer quantized
        so the student's outputs feed the next layer
  3. return the quantized params and the per-layer export dicts, also
     written as `{layer}.{name}.npz` (the files JAX's `cli/convert.py::
     load_results` reads), from which a rerun resumes layer by layer

Every layer runs with quant_mode "xla" and the einsum attention, as JAX's
calibration does, so no hand-written kernel is on this path; the kernels
serve the checkpoint it writes. The matmuls run at f32 precision "highest"
(no TF32), the precision of JAX's CPU reference.

Activations stay on the device while a layer's set (inputs and teacher
targets) fits `resident_act_bytes`; past it they are staged on the host and
each batch is copied to the device when a step takes it.

A hybrid's delta-net layers run through `models/decoder.py::
linear_layer_forward` (JAX's delta-net layer body); their in_proj_qkvz and
out_proj are calibrated, in_proj_ba is skipped by default (`CalibConfig.
skip`, the reference's `--skipped-modules`). A gemma3n layer's input is
the AltUp stack [A, B, T, H] (its batch on axis 1) with its slice of the
per-layer inputs; its q/k/v/o and MLP are calibrated (the AltUp, LAuReL
and per-layer linears stay dense), a shared-KV tail layer skips k_proj and
v_proj (never applied) and attends over the (k, v) that its source layer's
quantized student emitted, as JAX's branch does. A data-parallel `mesh`
raises NotImplementedError (ROADMAP §A 7). GPTQ init re-initializes the
standard linears only, as JAX's does (the experts, a shared expert, the
delta-net projections and every gemma3n layer keep the plain init); on a
delta-net layer its Hessians come from that layer's own taps (JAX's init
there calls the attention layer's forward and fails).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.decoder import (DenseLinear, apply_linear, layer_forward, layer_rope_theta,
                              linear_layer_forward, rope_tables)
from ..ops import rotation as rot_ops
from ..ops.butterfly import make_butterfly_params
from ..convert.rtn import _to_device
from ..ops.qlinear import make_quantized_linear
from ..utils.device import resolve_device
from .pseudo import PseudoQuantLinear, export_quantized, make_pseudo_linear
from .pseudo_moe import export_quantized_moe, make_pseudo_moe, quantized_moe_from_export
from .train import optimize_linears

logger = logging.getLogger("paroquant_tpu_torch.optim")

LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_NAMES = ("gate_proj", "up_proj", "down_proj")
# gated delta-net (qwen3_next hybrid) projections; the fused in_proj_ba
# (decay/gate) is skipped by default, as the reference skips it
LINEAR_ATTN_NAMES = ("in_proj_qkvz", "in_proj_ba", "out_proj")


@dataclasses.dataclass
class CalibConfig:
    n_bits: int = 4
    group_size: int = 128
    num_rotations: int = 8
    num_pairs_factor: float = 0.5
    # "random" = the reference's seeded independent pairs (the default);
    # "butterfly" = the structured variant
    pair_mode: str = "random"
    seed: int = 0
    # stages: (param-group -> lr, epochs), the canonical two-stage recipe
    stages: tuple = (
        ({"channel_scales": 5e-2, "angles": 5e-2}, 5),
        ({"weight": 1e-5, "quantizer": 1e-6}, 5),
    )
    loss: str = "mse"
    grad_accum: int = 1
    early_stop: int | None = None
    val_fraction: float = 0.1
    rot_dtype: torch.dtype = torch.float32
    # device budget for a layer's activation set (inputs + teacher targets);
    # past it, batches stage on the host and stream to the device per step
    resident_act_bytes: int = 4 << 30
    # staging dtype of the activations (bfloat16 halves memory and copies)
    act_dtype: torch.dtype = torch.float32
    # module names (as _layer_linear_names emits them) left dense
    skip: tuple = ("linear_attn.in_proj_ba",)
    # GPTQ-initialize the final (weight + quantizer) stage in the learned
    # rotated coordinates (standard attention + GLU layers)
    gptq_init: bool = False


@contextlib.contextmanager
def _f32_highest():
    """f32 matmuls at full precision (no TF32) for the block, restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _rotation_for(cfg: CalibConfig, in_features: int, layer_seed: int) -> rot_ops.RotationParams:
    if cfg.pair_mode == "butterfly":
        return make_butterfly_params(in_features, cfg.group_size, cfg.num_rotations)
    return rot_ops.make_rotation_params(
        in_features, cfg.group_size, cfg.num_rotations, layer_seed, cfg.num_pairs_factor
    )


def _layer_linear_names(layer_params: dict[str, Any], skip: tuple = ()) -> list[str]:
    names = [n for n in LINEAR_NAMES if n in layer_params]
    la = layer_params.get("linear_attn", {})
    names += [f"linear_attn.{n}" for n in LINEAR_ATTN_NAMES if n in la]
    mlp = layer_params.get("mlp", {})
    names += [f"mlp.{n}" for n in MLP_NAMES if n in mlp]
    if "experts" in mlp:
        names.append("mlp.experts")
    names += [f"mlp.shared_expert.{n}" for n in MLP_NAMES if n in mlp.get("shared_expert", {})]
    return [n for n in names if n not in skip]


def flatten_export(exp: dict[str, Any]) -> dict[str, Any]:
    """Flatten (possibly nested) export dicts for npz storage."""
    out = {}
    for k, v in exp.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{k}.{k2}"] = v2
        elif v is not None:
            out[k] = v
    return out


def unflatten_export(flat: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in flat.items():
        if hasattr(v, "ndim") and v.ndim == 0:
            v = v.item()
        if "." in k:
            k1, k2 = k.split(".", 1)
            out.setdefault(k1, {})[k2] = v
        else:
            out[k] = v
    if not isinstance(out.get("bias"), np.ndarray):
        out["bias"] = None
    return out


class _HostPagedBatches:
    """Lazy (input, target) batch sequence: activations stay on the host and
    each iteration copies one batch to the device (again every epoch)."""

    def __init__(self, make_batch, indices):
        self._make = make_batch
        self._idx = indices

    def __len__(self):
        return len(self._idx)

    def __iter__(self):
        for i in self._idx:
            yield self._make(i)


def _get_linear(layer_params, name):
    node = layer_params
    for part in name.split("."):
        node = node[part]
    return node


def _set_linear(layer_params, name, value):
    """Functional set along a dotted path (copies every dict on the way)."""
    parts = name.split(".")
    lp = dict(layer_params)
    node = lp
    for part in parts[:-1]:
        node[part] = dict(node[part])
        node = node[part]
    node[parts[-1]] = value
    return lp


@torch.no_grad()
def gptq_init_linear(lin: PseudoQuantLinear, hessian: torch.Tensor,
                     percdamp: float = 0.01) -> PseudoQuantLinear:
    """Re-initialize a pseudo linear's weight and quantizer at the GPTQ-
    compensated point in the learned rotated coordinates, in place.

    The runtime computes y = (Mb x) @ Wq with Mb = R diag(1/cs) per group, so
    the rotated-space Hessian is H_r = Mb H Mb^T; GPTQ of W_r = R(cs W)
    against H_r gives the compensated grid, and the new continuous weight is
    its inverse transform. The quantizer starts exactly on that grid."""
    from ..convert.gptq import _gptq_core, _hessian_chol, _rotate_weight_and_hessian
    from ..ops import quant
    from .pseudo import rotated_scaled_weight

    gs = lin.group_size
    theta = rot_ops.effective_theta(lin.rotation_params)
    R = rot_ops.build_rotation_matrices(theta, lin.form, gs, dtype=torch.float32)
    inv_s = (1.0 / lin.channel_scales).reshape(-1, gs)
    M = R * inv_s[:, None, :]
    _, h_rot = _rotate_weight_and_hessian(
        torch.zeros((1, lin.weight.shape[1]), device=M.device), hessian, M)
    w_rot = rotated_scaled_weight(lin)
    U, dead = _hessian_chol(h_rot, percdamp)
    q, s_q, z = _gptq_core(w_rot, U, dead, n_bits=lin.n_bits, group_size=gs)
    w_deq = quant.dequantize_int(q, s_q, z, gs)
    w_new = rot_ops.apply_rotation_stages(w_deq, theta, lin.form, inverse=True) \
        / lin.channel_scales[None, :]
    lin.weight.copy_(w_new)
    # pseudo_quantize rounds the zero point as clip(-round(zp_float)): zp_float = -z
    lin.set_quantizer(s_q.reshape(-1, 1), (-z.to(torch.float32)).reshape(-1, 1))
    return lin


def quantized_from_export(exp: dict[str, Any], rot_dtype=torch.float32, device=None):
    """The runtime QuantizedLinear (QuantizedMoEExperts for stacked experts)
    of an export dict (numpy or tensors)."""
    if exp.get("moe"):
        return quantized_moe_from_export(exp, rot_dtype, device)
    return make_quantized_linear(
        exp["q"], exp["scales"], exp["zeros"], exp["pairs"], exp["theta"],
        exp["inv_channel_scales"], exp["group_size"], bias=exp["bias"],
        rot_dtype=rot_dtype, n_bits=exp["n_bits"], device=device,
    )


def _refuse(config: ModelConfig, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel calibration over a mesh needs parallel/, which the port has not "
            "yet (ROADMAP §A 7)")


# which tap (the input of a layer's linears) feeds each standard linear
_TAP_OF = {
    "q_proj": "qkv", "k_proj": "qkv", "v_proj": "qkv", "o_proj": "o",
    "mlp.gate_proj": "mlp", "mlp.up_proj": "mlp", "mlp.down_proj": "down",
}


def _tagged(log_fn, tags, metrics, step):
    log_fn({**tags, **metrics}, step)


def calibrate_model(
    params: dict[str, Any],
    config: ModelConfig,
    token_batches: np.ndarray,  # [N, B, T] int32 calibration batches
    cfg: CalibConfig = CalibConfig(),
    *,
    output_dir: str | Path | None = None,
    resume: bool = True,
    progress_fn: Callable[[int, int, dict], None] | None = None,
    mesh: Any | None = None,
    log_fn: Callable[[dict, int], None] | None = None,
    device="cuda",
) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Calibrate and quantize a dense, MoE, hybrid or gemma3n model on
    `device` (params are copied there). Returns (quantized params, per-layer
    export dicts).

    With output_dir, each layer's results are written as
    `{layer_idx}.{name}.npz`, and with resume=True a layer whose files are
    all there is rebuilt from them instead of optimized. log_fn(metrics,
    step) receives optimize_linears' losses with "layer" and "stage" added."""
    _refuse(config, mesh)
    dev = resolve_device(device)
    params = _to_device(params, dev)
    with _f32_highest():
        return _calibrate(params, config, token_batches, cfg, output_dir, resume,
                          progress_fn, log_fn, dev)


def _calibrate(params, config, token_batches, cfg, output_dir, resume, progress_fn, log_fn,
               dev):
    out = dict(params)
    layers = list(params["layers"])
    token_batches = np.asarray(token_batches, np.int32)
    N, B, T = token_batches.shape
    adt = cfg.act_dtype
    itemsize = torch.empty((), dtype=adt).element_size()
    H = config.hidden_size
    is_g3n = config.is_gemma3n
    x_mult = 2 * config.altup_num_inputs if is_g3n else 2  # inputs and targets: the AltUp stack
    on_device = N * B * T * H * itemsize * x_mult <= cfg.resident_act_bytes

    def _stage(a):
        """Device activation -> staging (on the device, or on the host)."""
        return a.to(adt) if on_device else a.to(adt).cpu()

    scale = float(np.sqrt(config.hidden_size)) if config.gemma_norm else 1.0
    embed = params["embed_tokens"]
    with torch.no_grad():
        xs = [_stage(embed[torch.from_numpy(tb).to(dev).long()].to(torch.float32) * scale)
              for tb in token_batches]
    if is_g3n:
        # a gemma3n layer takes the AltUp stack and its slice of the per-layer
        # inputs; a shared-KV tail layer also takes its source layer's (k, v),
        # emitted by the source's quantized student (`shared_store`)
        from ..models.gemma3n import _magnitude_match, gemma3n_layer, per_layer_inputs

        with torch.no_grad():
            plis = []
            for i, tb in enumerate(token_batches):
                x0 = xs[i].to(dev)
                plis.append(_stage(per_layer_inputs(params, config, torch.from_numpy(tb).to(dev),
                                                    x0)))
                xs[i] = _stage(torch.stack([x0] + [_magnitude_match(apply_linear(p, x0), x0)
                                                   for p in params["altup_projections"]]))
        shared_store: dict[int, list] = {}
        srcs_needed = {config.kv_share_source(j) for j in range(config.num_hidden_layers)} - {None}

    positions = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n_val = max(int(N * cfg.val_fraction), 1) if N > 1 else 0

    results: list[dict[str, Any]] = []
    outdir = Path(output_dir) if output_dir is not None else None
    if outdir is not None:
        outdir.mkdir(parents=True, exist_ok=True)

    for li, lp in enumerate(layers):
        t_start = time.time()
        names = _layer_linear_names(lp, cfg.skip)
        cos, sin = rope_tables(positions, config.rotary_dim, layer_rope_theta(config, li))
        is_linear = config.layer_is_linear(li)
        src = config.kv_share_source(li)
        if src is not None:  # the shared-KV tail never applies its k/v projections
            names = [n for n in names if n not in ("k_proj", "v_proj")]

        def _batch_in(i):
            if not is_g3n:
                return xs[i].to(dev)
            shared = None if src is None else tuple(a.to(dev) for a in shared_store[src][i])
            return xs[i].to(dev), plis[i][:, :, li].to(dev), shared

        def g3n_layer(lp_, x):
            h, pli_l, shared = x
            return gemma3n_layer(lp_, h, pli_l, config, li, cos, sin, positions, None, zero,
                                 shared, "xla")

        def layer_taps(lp_, x):
            """(output, taps) of one decoder layer, dense or substituted params
            (no cache): a delta-net layer through linear_layer_forward."""
            if is_linear:
                y, _, _, taps = linear_layer_forward(lp_, x, config, li, None, None, "xla",
                                                     return_taps=True)
                return y, taps
            y, _, taps = layer_forward(lp_, x, config, li, cos, sin, positions, None, zero, "xla",
                                       return_taps=True)
            return y, taps

        def apply_with(lp_, x):
            """One decoder layer, dense or substituted params (no cache)."""
            if is_g3n:
                return g3n_layer(lp_, x)[0]
            if is_linear:
                return linear_layer_forward(lp_, x, config, li, None, None, "xla")[0]
            y, _ = layer_forward(lp_, x, config, li, cos, sin, positions, None, zero, "xla")
            return y

        with torch.no_grad():
            teacher = [_stage(apply_with(lp, _batch_in(i))) for i in range(N)]

        layer_result: dict[str, Any] = {}
        saved = {}
        if outdir is not None and resume:
            for name in names:
                f = outdir / f"{li}.{name}.npz"
                if f.exists():
                    saved[name] = dict(np.load(f, allow_pickle=True))
        if len(saved) == len(names) and names:
            # resume: rebuild the quantized layer from the saved results
            new_lp = lp
            for name in names:
                exp = unflatten_export(saved[name])
                new_lp = _set_linear(new_lp, name,
                                     quantized_from_export(exp, cfg.rot_dtype, dev))
                layer_result[name] = exp
            layers[li] = new_lp
        else:
            linears: dict[str, Any] = {}
            for name in names:
                if name == "mlp.experts":
                    experts = lp["mlp"]["experts"]
                    H, I_moe = experts["gate_proj"].shape[1:]
                    linears[name] = make_pseudo_moe(
                        experts, _rotation_for(cfg, H, cfg.seed + li),
                        _rotation_for(cfg, I_moe, cfg.seed + li + 1000),
                        n_bits=cfg.n_bits, group_size=cfg.group_size, device=dev)
                    continue
                dense = _get_linear(lp, name)
                w = dense.w.to(torch.float32).T  # [O, I]
                rot = _rotation_for(cfg, w.shape[1], cfg.seed + li)
                linears[name] = make_pseudo_linear(
                    w, rot, bias=None if dense.b is None else dense.b.to(torch.float32),
                    n_bits=cfg.n_bits, group_size=cfg.group_size, device=dev,
                )

            def pseudo_layer_apply(linear_dict, x, lp_ctx):
                new_lp = lp_ctx
                for name, lin in linear_dict.items():
                    new_lp = _set_linear(new_lp, name, lin)
                return apply_with(new_lp, x)

            def _make_batch(i):
                return (_batch_in(i), teacher[i].to(dev))

            train_idx = list(range(N - n_val)) if n_val else list(range(N))
            val_idx = list(range(N - n_val, N)) if n_val else [0]
            if on_device:
                cached = [_make_batch(i) for i in range(N)]
                train_b = [cached[i] for i in train_idx]
                val_b = [cached[i] for i in val_idx]
            else:
                train_b = _HostPagedBatches(_make_batch, train_idx)
                val_b = _HostPagedBatches(_make_batch, val_idx)

            @torch.no_grad()
            def _gptq_init_all(lins):
                """Hessian-compensated init of the weight + quantizer stage:
                each tap's Hessian through the current student layer (pseudo
                weights baked dense), then gptq_init_linear per linear."""
                from .pseudo import pseudo_quantized_weight

                pql = {n: l for n, l in lins.items() if isinstance(l, PseudoQuantLinear)}
                todo = [n for n in pql if n in _TAP_OF]
                if not todo:
                    return
                eff = lp
                for n2, l2 in pql.items():
                    eff = _set_linear(eff, n2, DenseLinear(
                        pseudo_quantized_weight(l2).T,
                        None if l2.bias is None else l2.bias.detach()))
                hs = None
                for i2 in range(N):
                    _, taps = layer_taps(eff, _batch_in(i2))
                    h_i = {}
                    for k, t in taps.items():
                        tt = t.reshape(-1, t.shape[-1]).to(torch.float32)
                        h_i[k] = tt.T @ tt
                    hs = h_i if hs is None else {k: hs[k] + h_i[k] for k in hs}
                for n2 in todo:
                    h2 = hs.get(_TAP_OF[n2])
                    if h2 is not None:
                        gptq_init_linear(lins[n2], h2)

            step = 0
            for si, (stage_groups, epochs) in enumerate(cfg.stages):
                if (cfg.gptq_init and si == len(cfg.stages) - 1 and not is_g3n
                        and ("weight" in stage_groups or "quantizer" in stage_groups)):
                    _gptq_init_all(linears)
                stage_log = None if log_fn is None else functools.partial(
                    _tagged, log_fn, {"layer": li, "stage": si})
                linears, step = optimize_linears(
                    pseudo_layer_apply, linears, train_b, val_b, dict(stage_groups),
                    n_epochs=epochs, loss=cfg.loss, grad_accum=cfg.grad_accum,
                    early_stop=cfg.early_stop, start_step=step, apply_ctx=lp,
                    log_fn=stage_log,
                )

            # export, and swap in the runtime quantized linears
            new_lp = lp
            for name, lin in linears.items():
                exp = export_quantized_moe(lin) if name == "mlp.experts" else export_quantized(lin)
                layer_result[name] = exp
                if outdir is not None:
                    np.savez(outdir / f"{li}.{name}.npz", **flatten_export(exp))
                new_lp = _set_linear(new_lp, name,
                                     quantized_from_export(exp, cfg.rot_dtype, dev))
            layers[li] = new_lp
            linears = train_b = val_b = cached = None  # noqa: F841

        # free the teacher targets before the student re-capture
        teacher = None

        # the student's outputs feed the next layer
        qlp = layers[li]
        with torch.no_grad():
            if is_g3n and li in srcs_needed:  # a source layer: its (k, v) for the tail
                outs = [g3n_layer(qlp, _batch_in(i)) for i in range(N)]
                xs = [_stage(o) for o, _, _ in outs]
                shared_store[li] = [tuple(_stage(a) for a in kv) for _, _, kv in outs]
                del outs
            else:
                xs = [_stage(apply_with(qlp, _batch_in(i))) for i in range(N)]
        results.append(layer_result)
        if progress_fn:
            progress_fn(li, len(layers), {"seconds": time.time() - t_start})
        logger.info("layer %d/%d calibrated in %.1fs", li + 1, len(layers), time.time() - t_start)

    out["layers"] = layers
    return out, results
