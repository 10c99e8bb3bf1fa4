"""Block-wise distillation optimizer, in torch.

Counterpart of `paroquant_tpu/optim/train.py`:
- AdamW (torch.optim.AdamW, weight decay 0.01 on every group as
  `optax.adamw`), one param group per stage group, each group's LR on
  `optax.cosine_decay_schedule(lr, total_steps, alpha=1/20)` indexed by the
  count of applied updates from 0, total_steps = n_epochs *
  ceil(n_train / grad_accum)
- MSE or SmoothL1 loss against the FP teacher's layer outputs
- grad_accum > 1 as `optax.MultiSteps`: the mean of k gradients (Welford's
  running mean, as optax) makes one update; a partial window carries over
  the epoch boundary and is never flushed
- the validation loss before the first step sets the first best; each epoch
  ends with a validation pass, a better loss snapshots a copy of the
  trainable tensors, `early_stop` counts stalled epochs, and the best
  snapshot is written back at the end (a stage that never improves returns
  its inputs bit for bit)

The training and validation steps run inside `pseudo.jit_form()`, the
quantizer form of JAX's jitted steps.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from .pseudo import PARAM_GROUPS, PseudoQuantLinear, init_quantizer, jit_form

LinearDict = dict[str, PseudoQuantLinear]  # and optim/pseudo_moe.py's PseudoQuantMoEExperts


def split_trainable(
    linears: LinearDict, groups: dict[str, float]
) -> dict[str, dict[str, dict[str, torch.Tensor]]]:
    """{group: {linear_name: {field: parameter}}} for the stage's groups
    (the parameters themselves, not copies). Field names per group come
    from each module's PARAM_FIELDS."""
    out: dict[str, dict[str, dict[str, torch.Tensor]]] = {}
    for gname in groups:
        gdict = {}
        for lname, lin in linears.items():
            fields = getattr(type(lin), "PARAM_FIELDS", {}).get(gname, PARAM_GROUPS.get(gname, ()))
            fdict = {f: getattr(lin, f) for f in fields if getattr(lin, f) is not None}
            if fdict:
                gdict[lname] = fdict
        out[gname] = gdict
    return out


@torch.no_grad()
def merge_trainable(linears: LinearDict, trainable) -> LinearDict:
    """Write the tensors of `trainable` (as split_trainable lays them out)
    into the linears' parameters, in place."""
    for gdict in trainable.values():
        for lname, fdict in gdict.items():
            for f, v in fdict.items():
                getattr(linears[lname], f).copy_(v)
    return linears


def make_loss_fn(apply_fn: Callable[..., torch.Tensor], loss: str = "mse"):
    """loss_fn(linears, ctx, batch_in, batch_target): apply_fn(linears,
    batch_in[, ctx]) against the target, in f32."""
    if loss == "mse":
        def loss_op(a, b):
            return torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2)
    elif loss == "smooth_l1":
        def loss_op(a, b):
            d = a.to(torch.float32) - b.to(torch.float32)
            ad = torch.abs(d)
            return torch.mean(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5))
    else:
        raise ValueError(loss)

    def loss_fn(linears, ctx, batch_in, batch_target):
        out = apply_fn(linears, batch_in) if ctx is None else apply_fn(linears, batch_in, ctx)
        return loss_op(out, batch_target)

    return loss_fn


def cosine_lr(lr: float, count: int, total_steps: int, alpha: float = 1 / 20) -> float:
    """optax.cosine_decay_schedule(lr, total_steps, alpha) at `count`."""
    c = min(count, total_steps)
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / total_steps)) + alpha)


def _ensure_quantizer(lin):
    from .pseudo_moe import PseudoQuantMoEExperts, init_moe_quantizers

    if isinstance(lin, PseudoQuantMoEExperts):
        return lin if lin.gate_up_q_scale is not None else init_moe_quantizers(lin)
    return lin if lin.q_scale is not None else init_quantizer(lin)


def _snapshot(trainable):
    """A copy of the trainable tensors (split_trainable's layout): the
    optimizer updates the parameters in place."""
    return {g: {l: {f: t.detach().clone() for f, t in fd.items()} for l, fd in gd.items()}
            for g, gd in trainable.items()}


def optimize_linears(
    apply_fn: Callable[..., torch.Tensor],
    linears: LinearDict,
    train_batches,
    val_batches,
    stage_groups: dict[str, float],
    *,
    n_epochs: int,
    loss: str = "mse",
    grad_accum: int = 1,
    early_stop: int | None = None,
    weight_decay: float = 0.01,
    log_fn: Callable[[dict[str, float], int], None] | None = None,
    start_step: int = 0,
    apply_ctx: Any = None,  # forwarded to apply_fn as its third argument
) -> tuple[LinearDict, int]:
    """Run one optimization stage on the linears' parameters (updated in
    place). Returns (linears, step count)."""
    if "quantizer" in stage_groups:
        linears = {n: _ensure_quantizer(lin) for n, lin in linears.items()}

    trainable = split_trainable(linears, stage_groups)
    num_train = len(train_batches)
    steps_per_epoch = int(np.ceil(num_train / grad_accum))
    total_steps = max(n_epochs * steps_per_epoch, 1)

    for lin in linears.values():
        lin.requires_grad_(False)
    groups, params = [], []
    for g, lr in stage_groups.items():
        ps = [t for fdict in trainable.get(g, {}).values() for t in fdict.values()]
        for p in ps:
            p.requires_grad_(True)
        if ps:
            groups.append({"params": ps, "lr": lr, "base_lr": lr})
            params += ps
    opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    loss_fn = make_loss_fn(apply_fn, loss)
    applied = 0
    acc: list[torch.Tensor] | None = None
    mini = 0

    def apply_update(grads):
        nonlocal applied
        for grp in opt.param_groups:
            grp["lr"] = cosine_lr(grp["base_lr"], applied, total_steps)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        applied += 1

    def val_loss() -> float:
        tot = 0.0
        with torch.no_grad(), jit_form():
            for bin_, btgt in val_batches:
                tot += float(loss_fn(linears, apply_ctx, bin_, btgt))
        return tot / max(len(val_batches), 1)

    best_val = val_loss()
    best = _snapshot(trainable)
    step = start_step
    if log_fn:
        log_fn({"val_loss": best_val, "best_val_loss": best_val}, step)

    stall = 0
    for _ in range(n_epochs):
        for bin_, btgt in train_batches:
            with jit_form():
                lval = loss_fn(linears, apply_ctx, bin_, btgt)
            grads = torch.autograd.grad(lval, params)
            if grad_accum > 1:
                # optax.MultiSteps: the running mean of the window's gradients
                if acc is None:
                    acc = [torch.zeros_like(g) for g in grads]
                acc = [a + (g - a) / (mini + 1) for a, g in zip(acc, grads)]
                mini += 1
                if mini == grad_accum:
                    apply_update(acc)
                    acc, mini = None, 0
            else:
                apply_update(grads)
            step += 1
            if log_fn:
                log_fn({"loss": float(lval.detach())}, step)
        v = val_loss()
        if v < best_val:
            best_val = v
            best = _snapshot(trainable)
            stall = 0
        else:
            stall += 1
            if early_stop is not None and stall >= early_stop:
                break
        if log_fn:
            log_fn({"val_loss": v, "best_val_loss": best_val}, step)

    merge_trainable(linears, best)
    for lin in linears.values():
        lin.requires_grad_(False)
    for p in params:
        p.grad = None
    return linears, step
