"""The port's calibration building blocks (`paroquant_tpu_torch/ops/quant.py`'s
STE ops, `ops/rotation.py`, `optim/pseudo.py`, `optim/train.py`) against
JAX's, on the CPU, from the same seeded numpy inputs, and calibrate_model's
own properties in the port (it beats RTN W4 at tests/test_optim.py's
recipe; GPTQ init; host-paged staging equals resident; the unported
branches raise). tests/test_torch_calibrate.py and
tests/test_torch_calibrate_gptq.py hold calibrate_model against JAX's.

Tolerances, and why.
- Bit for bit: the STE ops; both quantizer forms (the port's jit=True
  against JAX under `jax.jit`, its default against JAX's eager call);
  `init_quantizer`; export codes on equal inputs.
- Rotations: 1e-6 of max |y| (the cos/sin and the sums differ in their last
  bits); gradients 1e-5 of max |g|.
- Gradients of the pseudo-quantized weight: 1e-4 of max |g|, against JAX's
  eager `jax.grad`. Under `jax.jit` XLA:CPU recomputes the rotated weight
  in the backward pass with other roundings, so jnp.min/jnp.max's
  `eq(x, min)` selects nothing in some groups and their cotangent drops out
  (`test_jax_jit_drops_min_max_cotangent` shows it). The port keeps the
  math: amin/amax, whose gradient is eager JAX's.
- The LR schedule: 1e-6 relative to optax's. AdamW steps: 1e-6 of max |p|
  against optax.adamw (the same update in another order of operations).
- Loss trajectories: each logged loss within 1% of JAX's. Stage 1 runs at
  LR 5e-3: at the recipe's 5e-2 the dynamics are chaotic (Adam's first
  steps are +-lr per element, and the hard rounding turns a one-ulp
  difference into ~17% within a dozen steps, between JAX's own jitted and
  eager runs too), so no tolerance tighter than the losses themselves would
  hold there.

Each tolerance that is not bit for bit has a negative control, a
deliberately wrong port that the same check fails: min/max without a
gradient, the cosine without alpha, weight decay 0, the snapshot aliased,
jit=True in init_quantizer.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import from_hf_dict as j_from_hf_dict
from paroquant_tpu.models import init_params as j_init_params
from paroquant_tpu.ops import quant as jq
from paroquant_tpu.ops import rotation as jrot
from paroquant_tpu.ops.butterfly import make_butterfly_params as j_butterfly
from paroquant_tpu.optim import pseudo as jpseudo
from paroquant_tpu.optim.calibrate import gptq_init_linear as j_gptq_init_linear
from paroquant_tpu.optim.train import optimize_linears as j_optimize
from paroquant_tpu_torch.convert import quantize_model_rtn
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS, from_hf_dict, model_forward
from paroquant_tpu_torch.ops import quant as tq
from paroquant_tpu_torch.ops import rotation as trot
from paroquant_tpu_torch.ops.butterfly import make_butterfly_params
from paroquant_tpu_torch.optim import CalibConfig, calibrate_model
from paroquant_tpu_torch.optim import calibrate as tcal
from paroquant_tpu_torch.optim import pseudo as tpseudo
from paroquant_tpu_torch.optim import train as ttrain

GS = 128


def _np(t):
    return t.detach().cpu().numpy()


def _outlier_weight(O, I, seed):
    """tests/test_optim.py's weight: a few input channels 8x larger."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (O, I)).astype(np.float32)
    w[:, rng.choice(I, size=max(I // 32, 1), replace=False)] *= 8.0
    return w


def _rotations(mode, I=256, K=8, gs=GS, seed=0):
    if mode == "butterfly":
        return j_butterfly(I, gs, K), make_butterfly_params(I, gs, K)
    return jrot.make_rotation_params(I, gs, K, seed), trot.make_rotation_params(I, gs, K, seed)


def _linears(mode="random", theta_std=0.1, scales=True, O=64, I=256, seed=0):
    """The same pseudo linear in both packages (random theta and channel scales)."""
    jr, tr = _rotations(mode, I)
    rng = np.random.default_rng(seed + 5)
    th = (rng.normal(0, theta_std, np.asarray(jr.theta).shape).astype(np.float32)
          if theta_std else np.zeros(np.asarray(jr.theta).shape, np.float32))
    cs = rng.uniform(0.5, 2.0, I).astype(np.float32) if scales else None
    bias = rng.normal(size=O).astype(np.float32)
    w = _outlier_weight(O, I, seed + 1)
    jl = jpseudo.make_pseudo_linear(w, jr._replace(theta=jnp.asarray(th)), bias=bias,
                                    channel_scales=cs, group_size=GS)
    tl = tpseudo.make_pseudo_linear(torch.from_numpy(w), tr._replace(theta=torch.from_numpy(th)),
                                    bias=torch.from_numpy(bias), channel_scales=cs, group_size=GS)
    return jl, tl


# ---------------------------------------------------------------------------
# STE ops and the quantizer's two forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["round", "clamp"])
def test_ste_ops_bit_for_bit(op):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 4, 4093), [0.5, 1.5, -2.5, 2.5]]).astype(np.float32)
    jf = jq.round_ste if op == "round" else functools.partial(jq.clamp_ste, min=-3.0, max=5.0)
    tf = tq.round_ste if op == "round" else functools.partial(tq.clamp_ste, min=-3.0, max=5.0)
    np.testing.assert_array_equal(_np(tf(torch.from_numpy(x))), np.asarray(jf(jnp.asarray(x))))
    c = rng.normal(size=x.shape).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(jf(a) * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tf(xt) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(gj))


@pytest.mark.parametrize("form", ["jit", "eager"])
def test_quantizer_forms_bit_for_bit(form):
    """jit=True is JAX's pseudo_quantize under jax.jit (the training step);
    the default is JAX's eager call (init_quantizer, export). The other form
    is the negative control."""
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(64, 256)) * rng.uniform(0.01, 3, (1, 256))).astype(np.float32)
    f = functools.partial(jq.pseudo_quantize, n_bits=4, group_size=GS)
    want = np.asarray((jax.jit(f) if form == "jit" else f)(jnp.asarray(w)))
    got = tq.pseudo_quantize(torch.from_numpy(w), 4, GS, jit=form == "jit")
    np.testing.assert_array_equal(_np(got), want)
    other = tq.pseudo_quantize(torch.from_numpy(w), 4, GS, jit=form != "jit")
    assert (_np(other) != want).mean() > 0.01


def test_calc_scales_gradient_splits_ties():
    """The span's gradient goes through min and max (clamp_ste), and a tie
    shares it as jnp.min/jnp.max do (amin/amax, not torch.max(dim))."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(8, 256)).astype(np.float32)
    w[0, 3] = w[0, 7] = w[0, :128].max() + 1.0  # a tied max
    w[1, 130] = w[1, 200] = w[1, 128:].min() - 1.0  # a tied min

    def jloss(a):
        p = jq.calc_scales_and_zero_points(a, GS, 4)
        return jnp.sum(p.scale * 3.0 + p.zero_point_float)

    for jit in (False, True):
        gj = (jax.jit(jax.grad(jloss)) if jit else jax.grad(jloss))(jnp.asarray(w))
        wt = torch.from_numpy(w).requires_grad_()
        p = tq.calc_scales_and_zero_points(wt, GS, 4, jit=jit)
        (p.scale * 3.0 + p.zero_point_float).sum().backward()
        np.testing.assert_allclose(_np(wt.grad), np.asarray(gj), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(gj)).max())
    assert wt.grad[0, 3] == wt.grad[0, 7] != 0


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------


def test_effective_theta_and_scaled_rotation():
    jr, tr = _rotations("random")
    rng = np.random.default_rng(3)
    th = rng.normal(0, 0.3, np.asarray(jr.theta).shape).astype(np.float32)
    jr, tr = jr._replace(theta=jnp.asarray(th)), tr._replace(theta=torch.from_numpy(th))
    np.testing.assert_array_equal(_np(trot.effective_theta(tr)), np.asarray(jrot.effective_theta(jr)))
    jf, tf = jrot.to_permutation_form(jr, GS), trot.to_permutation_form(tr.pairs, GS)
    x = rng.normal(size=(16, 256)).astype(np.float32)
    s = rng.uniform(0.5, 2, 256).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)

    def jloss(th_, x_, s_):
        y = jrot.scaled_pairwise_rotation(x_, jrot.effective_theta(jr._replace(theta=th_)), jf, s_)
        return jnp.sum(y * c), y

    (_, yj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(th), jnp.asarray(x), jnp.asarray(s))
    ts = [torch.from_numpy(a).requires_grad_() for a in (th, x, s)]
    yt = trot.scaled_pairwise_rotation(ts[1], trot.effective_theta(tr._replace(theta=ts[0])), tf, ts[2])
    (yt * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=0, atol=1e-6 * np.abs(yj).max())
    for t, g in zip(ts, gj):
        g = np.asarray(g)
        np.testing.assert_allclose(_np(t.grad), g, rtol=0, atol=1e-5 * np.abs(g).max())
    # the masked (dummy) pairs' angles get no gradient
    assert (_np(ts[0].grad)[np.asarray(jr.mask)] == 0).all()


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_rotation_matrices(inverse):
    jr, tr = _rotations("random")
    th = np.random.default_rng(4).normal(0, 0.3, np.asarray(jr.theta).shape).astype(np.float32)
    rj = jrot.build_rotation_matrices(jnp.asarray(th), jrot.to_permutation_form(jr, GS), GS)
    x = np.random.default_rng(5).normal(size=(3, 5, 256)).astype(np.float32)
    want = np.asarray(jrot.apply_rotation_matrices(jnp.asarray(x), rj, inverse=inverse))
    got = trot.apply_rotation_matrices(torch.from_numpy(x), torch.from_numpy(np.array(rj)),
                                       inverse=inverse)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Pseudo-quantized linear
# ---------------------------------------------------------------------------

FIELDS = ("weight", "channel_scales", "theta", "q_scale", "q_zero_point", "bias")


def _pqw_grads(jl, tl, x, detach_minmax=False, monkeypatch=None):
    """Gradients of sum(pseudo_linear_forward(lin, x) * c) in every trainable
    field: eager jax.grad and the port's autograd (eager form)."""
    c = np.random.default_rng(6).normal(size=(x.shape[0], jl.weight.shape[0])).astype(np.float32)
    names = [f for f in FIELDS if getattr(jl, f) is not None]

    def jloss(vals):
        lin = jl.replace(**dict(zip(names, vals)))
        return jnp.sum(jpseudo.pseudo_linear_forward(lin, jnp.asarray(x)) * c)

    gj = jax.grad(jloss)([getattr(jl, f) for f in names])
    for f in names:
        getattr(tl, f).requires_grad_(True).grad = None
    (tpseudo.pseudo_linear_forward(tl, torch.from_numpy(x)) * torch.from_numpy(c)).sum().backward()
    return {f: (np.asarray(g), _np(getattr(tl, f).grad)) for f, g in zip(names, gj)}


def _grads_close(grads):
    return all(np.abs(a - b).max() <= 1e-4 * np.abs(a).max() for a, b in grads.values())


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
@pytest.mark.parametrize("mode", ["random", "butterfly"])
def test_pseudo_quantized_weight_values_and_grads(mode, stage):
    jl, tl = _linears(mode)
    if stage == "stage2":
        jl = jpseudo.init_quantizer(jl)
        tpseudo.init_quantizer(tl)
    # values: the jitted JAX weight against the port's jit form, 1e-5 of max
    want = np.asarray(jax.jit(jpseudo.pseudo_quantized_weight)(jl))
    with tpseudo.jit_form():
        got = _np(tpseudo.pseudo_quantized_weight(tl))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    x = np.random.default_rng(7).normal(size=(16, 256)).astype(np.float32)
    grads = _pqw_grads(jl, tl, x)
    assert set(grads) == ({"weight", "channel_scales", "theta", "bias"}
                          | ({"q_scale", "q_zero_point"} if stage == "stage2" else set()))
    assert _grads_close(grads), {f: np.abs(a - b).max() / np.abs(a).max()
                                 for f, (a, b) in grads.items()}


def test_grads_negative_control_min_max_without_gradient(monkeypatch):
    """A port whose min/max carry no gradient fails the gradient check."""
    orig = tq.calc_scales_and_zero_points

    def detached(weight, group_size, n_bits, *, jit=False):
        x = weight.to(torch.float32).reshape(-1, group_size)
        span = tq.clamp_ste((x.amax(1, keepdim=True) - x.amin(1, keepdim=True)).detach(), min=1e-5)
        scale = span / (2**n_bits - 1)
        return tq.QuantizerParams(scale, x.amin(1, keepdim=True).detach() / scale)

    jl, tl = _linears("random")
    x = np.random.default_rng(7).normal(size=(16, 256)).astype(np.float32)
    assert _grads_close(_pqw_grads(jl, tl, x))
    monkeypatch.setattr(tq, "calc_scales_and_zero_points", detached)
    assert tq.calc_scales_and_zero_points is not orig
    assert not _grads_close(_pqw_grads(jl, tl, x))


def test_jax_jit_drops_min_max_cotangent():
    """Why the gradient tests hold the port against eager jax.grad: under
    jax.jit, jnp.min's cotangent through the rotation vanishes in some
    groups on XLA:CPU, where eager JAX and the port keep it in every group."""
    jr, _ = _rotations("random")
    th = np.random.default_rng(5).normal(0, 0.1, np.asarray(jr.theta).shape).astype(np.float32)
    form = jrot.to_permutation_form(jr, GS)
    x = jnp.asarray(_outlier_weight(64, 256, 1))

    def f(a):
        r = jrot.apply_rotation_stages(a, jnp.asarray(th), form).reshape(-1, GS)
        return jnp.sum(jnp.min(r, axis=1))

    def per_group(g):  # the cotangent on the rotated weight, summed per group
        return np.asarray(jrot.apply_rotation_stages(g, jnp.asarray(th), form)).reshape(-1, GS).sum(1)

    assert np.allclose(per_group(jax.grad(f)(x)), 1.0, atol=1e-4)
    jit_sums = per_group(jax.jit(jax.grad(f))(x))
    assert np.isclose(jit_sums, 0.0, atol=1e-4).sum() > 0


def test_init_quantizer_and_export_bit_for_bit(monkeypatch):
    """Equal inputs (theta 0, so the rotation is exact in both; channel
    scales not 1): init_quantizer's eager division and the export codes are
    JAX's bit for bit. jit=True in init_quantizer is the negative control."""
    jl, tl = _linears("random", theta_std=0.0)
    ji = jpseudo.init_quantizer(jl)
    tpseudo.init_quantizer(tl)
    np.testing.assert_array_equal(_np(tl.q_scale), np.asarray(ji.q_scale))
    np.testing.assert_array_equal(_np(tl.q_zero_point), np.asarray(ji.q_zero_point))
    for jlin, tlin in ((jl, tpseudo.make_pseudo_linear(tl.weight, tl.rotation_params,
                                                       bias=tl.bias, channel_scales=tl.channel_scales,
                                                       group_size=GS)), (ji, tl)):
        je, te = jpseudo.export_quantized(jlin), tpseudo.export_quantized(tlin)
        for k in ("q", "scales", "zeros", "pairs", "theta", "inv_channel_scales", "bias"):
            np.testing.assert_array_equal(te[k], je[k], err_msg=k)
            assert te[k].dtype == je[k].dtype, k
    _, tl2 = _linears("random", theta_std=0.0)
    jit_calc = functools.partial(tq.calc_scales_and_zero_points, jit=True)
    monkeypatch.setattr(tpseudo.quant, "calc_scales_and_zero_points",
                        lambda w, gs, nb: jit_calc(w, gs, nb))
    tpseudo.init_quantizer(tl2)
    assert not np.array_equal(_np(tl2.q_zero_point), np.asarray(ji.q_zero_point))


def test_export_codes_equal_with_learned_rotation():
    jl, tl = _linears("random", theta_std=0.2)
    je, te = jpseudo.export_quantized(jl), tpseudo.export_quantized(tl)
    np.testing.assert_array_equal(te["q"], je["q"])
    np.testing.assert_array_equal(te["zeros"], je["zeros"])
    np.testing.assert_allclose(te["scales"], je["scales"], rtol=1e-6)


# ---------------------------------------------------------------------------
# The optimizer: schedule, AdamW, trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total", [1, 7, 48])
def test_cosine_lr_matches_optax(total):
    sched = optax.cosine_decay_schedule(5e-2, total, alpha=1 / 20)
    want = np.array([float(sched(c)) for c in range(total + 3)])
    got = np.array([ttrain.cosine_lr(5e-2, c, total) for c in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    no_alpha = np.array([ttrain.cosine_lr(5e-2, c, total, alpha=0.0) for c in range(total + 3)])
    assert not np.allclose(no_alpha, want, rtol=1e-6)


def test_applied_lr_follows_applied_updates(monkeypatch):
    """With grad_accum=2 over 5 batches and 3 epochs, 7 updates apply
    (windows cross the epoch boundaries; the last half window is never
    flushed) on a schedule of 3 * ceil(5 / 2) = 9 steps, counted from 0."""
    seen = []
    orig = torch.optim.AdamW.step

    def step(self, *a, **k):
        seen.append([g["lr"] for g in self.param_groups])
        return orig(self, *a, **k)

    monkeypatch.setattr(torch.optim.AdamW, "step", step)
    _, tl = _linears("random")
    rng = np.random.default_rng(8)
    batches = [(torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)),
                torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))) for _ in range(6)]
    ttrain.optimize_linears(lambda L, x: tpseudo.pseudo_linear_forward(L["lin"], x), {"lin": tl},
                            batches[:5], batches[5:], {"channel_scales": 0.1, "angles": 0.2},
                            n_epochs=3, grad_accum=2)
    for lr in (0.1, 0.2):
        sched = optax.cosine_decay_schedule(lr, 9, alpha=1 / 20)
        assert len(seen) == 7
        want = [float(sched(c)) for c in range(7)]
        got = [s[(0.1, 0.2).index(lr)] for s in seen]
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_adamw_steps_match_optax(wd):
    """Three steps of torch.optim.AdamW (weight decay 0.01, as the port
    runs it) against optax.adamw; the port with weight decay 0 is the
    negative control."""
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(32, 16)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(optax.cosine_decay_schedule(5e-2, 3, alpha=1 / 20), weight_decay=0.01)
    pj, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.AdamW([{"params": [pt], "lr": 5e-2}], betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    for c, g in enumerate(grads):
        u, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, u)
        opt.param_groups[0]["lr"] = ttrain.cosine_lr(5e-2, c, 3)
        pt.grad = torch.from_numpy(g)
        opt.step()
    close = np.abs(_np(pt) - np.asarray(pj)).max() <= 1e-6 * np.abs(p0).max()
    assert close == (wd == 0.01)


TRAJ = {
    # name: (n_train, grad_accum, early_stop, loss, stage-2 epochs)
    "plain": (6, 1, None, "mse", 4),
    "grad_accum2_odd": (5, 2, None, "mse", 4),
    "early_stop": (6, 1, 1, "mse", 6),
    "smooth_l1": (6, 1, None, "smooth_l1", 4),
}


def _trajectories(case, weight_decay=0.01):
    """Both stages of tests/test_optim.py's 64 x 256 outlier linear (stage 1
    at 5e-3, see the module docstring) in both packages: (JAX's logged
    values, the port's, and the port's final weight)."""
    n_train, ga, es, loss, ep2 = TRAJ[case]
    w = _outlier_weight(64, 256, 1)
    xs = np.random.default_rng(2).normal(size=(8, 16, 256)).astype(np.float32)
    y = np.einsum("bth,oh->bto", xs, w)
    jr, tr = _rotations("random")
    stages = (({"channel_scales": 5e-3, "angles": 5e-3}, 8), ({"weight": 1e-5, "quantizer": 1e-6}, ep2))
    kw = dict(grad_accum=ga, early_stop=es, loss=loss)
    logs = {"j": [], "t": []}
    jb = [(jnp.asarray(xs[i]), jnp.asarray(y[i])) for i in range(8)]
    L = {"lin": jpseudo.make_pseudo_linear(w, jr, group_size=GS)}
    for groups, ep in stages:
        L, _ = j_optimize(lambda d, x: jpseudo.pseudo_linear_forward(d["lin"], x), L,
                          jb[:n_train], jb[6:], groups, n_epochs=ep,
                          log_fn=lambda m, s: logs["j"].append((s, m)), **kw)
    tb = [(torch.from_numpy(xs[i]), torch.from_numpy(y[i])) for i in range(8)]
    T = {"lin": tpseudo.make_pseudo_linear(torch.from_numpy(w), tr, group_size=GS)}
    for groups, ep in stages:
        T, _ = ttrain.optimize_linears(lambda d, x: tpseudo.pseudo_linear_forward(d["lin"], x), T,
                                       tb[:n_train], tb[6:], groups, n_epochs=ep,
                                       weight_decay=weight_decay,
                                       log_fn=lambda m, s: logs["t"].append((s, m)), **kw)
    return logs["j"], logs["t"]


def _rel_gap(lj, lt):
    assert [(s, sorted(m)) for s, m in lj] == [(s, sorted(m)) for s, m in lt]
    return max(abs(mj[k] - mt[k]) / abs(mj[k]) for (_, mj), (_, mt) in zip(lj, lt) for k in mj)


@pytest.mark.parametrize("case", sorted(TRAJ))
def test_loss_trajectory_matches_jax(case):
    lj, lt = _trajectories(case)
    assert _rel_gap(lj, lt) <= 0.01
    if case == "early_stop":  # stage 2 stalls and stops before its 6 epochs
        assert sum("val_loss" in m for _, m in lj) < 1 + 8 + 1 + 6


def test_loss_trajectory_negative_control_weight_decay_0():
    lj, lt = _trajectories("plain", weight_decay=0.0)
    assert _rel_gap(lj, lt) > 0.01


@pytest.mark.parametrize("aliased", [False, True])
def test_stage_that_never_improves_returns_its_inputs(aliased, monkeypatch):
    """Validation targets made by the initial linear itself: the first val
    loss is 0, no epoch beats it, and the stage must hand back its inputs
    bit for bit. An aliased snapshot (the negative control) hands back the
    last step's tensors instead."""
    if aliased:
        monkeypatch.setattr(ttrain, "_snapshot", lambda trainable: trainable)
    _, tl = _linears("random")
    before = {k: v.detach().clone() for k, v in tl.named_parameters()}
    rng = np.random.default_rng(10)
    xv = torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32))
    with torch.no_grad(), tpseudo.jit_form():
        yv = tpseudo.pseudo_linear_forward(tl, xv)
    train = [(torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))) for _ in range(3)]
    ttrain.optimize_linears(lambda d, x: tpseudo.pseudo_linear_forward(d["lin"], x), {"lin": tl},
                            train, [(xv, yv)], {"channel_scales": 5e-2, "angles": 5e-2,
                                                "weight": 1e-3}, n_epochs=2)
    same = all(torch.equal(before[k], v) for k, v in tl.named_parameters())
    assert same != aliased


# ---------------------------------------------------------------------------
# calibrate_model in the port alone (tests/test_torch_calibrate.py holds it
# against JAX's)
# ---------------------------------------------------------------------------

J_CFG = dataclasses.replace(J_PRESETS["tiny"], num_hidden_layers=2, hidden_size=256,
                            intermediate_size=512)
T_CFG = dataclasses.replace(PRESETS["tiny"], num_hidden_layers=2, hidden_size=256,
                            intermediate_size=512)
STAGES = (({"channel_scales": 5e-3, "angles": 5e-3}, 2), ({"weight": 1e-5, "quantizer": 1e-6}, 2))
CALIB = dict(n_bits=4, group_size=64, num_rotations=6, stages=STAGES)


def _tiny_setup():
    params = j_init_params(J_CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    for lp in params["layers"]:
        for n in ("gate_proj", "up_proj"):
            w = np.array(lp["mlp"][n].w)
            w[rng.choice(w.shape[0], 8, replace=False), :] *= 6.0
            lp["mlp"][n] = lp["mlp"][n]._replace(w=jnp.asarray(w))
    tokens = rng.integers(0, J_CFG.vocab_size, (4, 2, 16)).astype(np.int32)
    test_tokens = rng.integers(0, J_CFG.vocab_size, (1, 16)).astype(np.int32)
    return params, tokens, test_tokens


def _t_logits(params, tokens):
    with torch.no_grad():
        return _np(model_forward(params, T_CFG, torch.from_numpy(tokens))[0])


# tests/test_optim.py's recipe for the property that calibration beats RTN
RECIPE = (({"channel_scales": 5e-2, "angles": 5e-2}, 4), ({"weight": 1e-5, "quantizer": 1e-6}, 2))


@pytest.fixture(scope="module")
def port_tiny():
    """tests/test_optim.py's tiny two-layer setup in the port alone: the
    weights, tokens, dense logits and the CALIB calibration's exports."""
    params, tokens, test_tokens = _tiny_setup()
    tparams = params_from_jax(jax.tree.map(np.asarray, params), T_CFG, device="cpu")
    _, exports = calibrate_model(tparams, T_CFG, tokens, CalibConfig(**CALIB), device="cpu")
    return dict(tparams=tparams, tokens=tokens, test_tokens=test_tokens, t_exports=exports,
                fp_logits=_t_logits(tparams, test_tokens))


def test_calibration_beats_rtn(port_tiny):
    cfg = CalibConfig(**{**CALIB, "stages": RECIPE})
    q, _ = calibrate_model(port_tiny["tparams"], T_CFG, port_tiny["tokens"], cfg, device="cpu")
    rtn = quantize_model_rtn(port_tiny["tparams"], T_CFG, n_bits=4, group_size=64, device="cpu")
    fp = port_tiny["fp_logits"]
    e_cal = np.mean((_t_logits(q, port_tiny["test_tokens"]) - fp) ** 2)
    e_rtn = np.mean((_t_logits(rtn, port_tiny["test_tokens"]) - fp) ** 2)
    assert e_cal < e_rtn, (e_cal, e_rtn)


def test_gptq_init_calibration_runs(port_tiny):
    """gptq_init=True: the last stage starts on each linear's GPTQ grid. On
    this tiny set (128 tokens, group 64) neither package's GPTQ-initialized
    calibration beats RTN, so the check is that it runs, stays finite and
    takes the GPTQ grid; tests/test_torch_gptq.py and
    test_gptq_init_linear_matches_jax hold the grid against JAX's, and
    tests/test_torch_calibrate_gptq.py the whole of GPTQ init."""
    cfg = CalibConfig(**{**CALIB, "gptq_init": True})
    q, exps = calibrate_model(port_tiny["tparams"], T_CFG, port_tiny["tokens"], cfg,
                              device="cpu")
    assert np.isfinite(_t_logits(q, port_tiny["test_tokens"])).all()
    assert all((exps[0][n]["q"] != port_tiny["t_exports"][0][n]["q"]).any() for n in exps[0])


def test_host_paged_equals_resident():
    """resident_act_bytes=0 stages on the host and copies a batch per step:
    the same math in the same order, so the same params exactly."""
    jcfg = dataclasses.replace(J_PRESETS["tiny"], num_hidden_layers=1, hidden_size=128,
                               intermediate_size=256)
    tcfg = dataclasses.replace(PRESETS["tiny"], num_hidden_layers=1, hidden_size=128,
                               intermediate_size=256)
    params = params_from_jax(jax.tree.map(
        np.asarray, j_init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)), tcfg, "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, tcfg.vocab_size, (3, 2, 16)).astype(np.int32)
    base = CalibConfig(n_bits=4, group_size=64, num_rotations=4,
                       stages=(({"channel_scales": 5e-2, "angles": 5e-2}, 2),))
    q_res, _ = calibrate_model(params, tcfg, tokens, base, device="cpu")
    q_pag, _ = calibrate_model(params, tcfg, tokens, dataclasses.replace(base, resident_act_bytes=0),
                               device="cpu")
    tt = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (1, 16)))
    with torch.no_grad():
        a = model_forward(q_res, tcfg, tt)[0]
        b = model_forward(q_pag, tcfg, tt)[0]
    assert torch.equal(a, b)


def _gptq_codes_close(jn, tl):
    je, te = jpseudo.export_quantized(jn), tpseudo.export_quantized(tl)
    return (te["q"] != je["q"]).mean() <= 1e-3 and np.abs(te["q"] - je["q"]).max() <= 1


@pytest.mark.parametrize("unrotated_hessian", [False, True])
def test_gptq_init_linear_matches_jax(unrotated_hessian, monkeypatch):
    """GPTQ init in learned rotated coordinates: the Cholesky factors of the
    two packages differ in their last bits (tests/test_torch_gptq.py), so
    codes may differ in at most 0.1% of entries, by 1. A port that feeds
    GPTQ the Hessian unrotated is the negative control."""
    jl, tl = _linears("random")
    rng = np.random.default_rng(11)
    mix = rng.normal(size=(256, 256)) / 16 + 0.5 * np.eye(256)
    x = (rng.normal(size=(512, 256)) @ mix).astype(np.float32)
    H = (x.T @ x).astype(np.float32)
    jn = j_gptq_init_linear(jl, jnp.asarray(H))
    if unrotated_hessian:
        from paroquant_tpu_torch.convert import gptq as tgptq

        monkeypatch.setattr(tgptq, "_rotate_weight_and_hessian", lambda w, h, m: (w, h))
    tcal.gptq_init_linear(tl, torch.from_numpy(H))
    assert _gptq_codes_close(jn, tl) != unrotated_hessian
    if not unrotated_hessian:
        np.testing.assert_allclose(_np(tl.q_scale), np.asarray(jn.q_scale), rtol=1e-5)
        assert (_np(tl.q_zero_point) != np.asarray(jn.q_zero_point)).mean() <= 1e-3


HYBRID = dict(model_type="qwen3_next", vocab_size=64, hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, full_attention_interval=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.25,
              linear_num_value_heads=4, linear_num_key_heads=2, linear_key_head_dim=16,
              linear_value_head_dim=16, linear_conv_kernel_dim=4, tie_word_embeddings=True)


@pytest.mark.parametrize("kind", ["mesh", "gemma3n", "delta_net", "moe"])
def test_unported_branches_raise(kind):
    cfg = {"mesh": T_CFG, "gemma3n": PRESETS["tiny-gemma3n"], "moe": PRESETS["tiny-moe"],
           "delta_net": from_hf_dict(HYBRID)}[kind]
    if kind == "moe":
        # ported: a one-layer tiny-moe calibrates its experts into
        # QuantizedMoEExperts (tests/test_torch_pseudo_moe.py holds the
        # calibration against JAX's)
        cfg = dataclasses.replace(cfg, num_hidden_layers=1)
        jp = j_init_params(dataclasses.replace(J_PRESETS["tiny-moe"], num_hidden_layers=1),
                           jax.random.PRNGKey(1), dtype=jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 1, 8)).astype(np.int32)
        q, exps = calibrate_model(tp, cfg, tokens, CalibConfig(
            group_size=64, num_rotations=4, stages=(({"channel_scales": 5e-3}, 1),)), device="cpu")
        assert exps[0]["mlp.experts"]["moe"] and exps[0]["mlp.experts"]["gate"]["q"].shape == (
            cfg.num_experts, cfg.moe_intermediate_size, cfg.hidden_size)
        assert type(q["layers"][0]["mlp"]["experts"]).__name__ == "QuantizedMoEExperts"
        return
    if kind == "delta_net":
        # ported: a one-layer hybrid (a delta-net layer) calibrates in_proj_qkvz,
        # out_proj and its MLP; in_proj_ba stays dense by CalibConfig.skip's default
        # (tests/test_torch_qwen3_next_convert.py holds the calibration against JAX's)
        cfg = from_hf_dict(dict(HYBRID, num_hidden_layers=1))
        assert cfg.layer_is_linear(0)
        jcfg = j_from_hf_dict(dict(HYBRID, num_hidden_layers=1))
        jp = j_init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 1, 8)).astype(np.int32)
        q, exps = calibrate_model(tp, cfg, tokens, CalibConfig(
            group_size=32, num_rotations=4, stages=(({"channel_scales": 5e-3}, 1),)), device="cpu")
        assert sorted(exps[0]) == ["linear_attn.in_proj_qkvz", "linear_attn.out_proj",
                                   "mlp.down_proj", "mlp.gate_proj", "mlp.up_proj"]
        assert exps[0]["linear_attn.in_proj_qkvz"]["q"].shape == (
            2 * cfg.linear_num_key_heads * cfg.linear_key_head_dim
            + 2 * cfg.linear_num_value_heads * cfg.linear_value_head_dim, cfg.hidden_size)
        la = q["layers"][0]["linear_attn"]
        assert type(la["in_proj_qkvz"]).__name__ == type(la["out_proj"]).__name__ == "QuantizedLinear"
        assert type(la["in_proj_ba"]).__name__ == "DenseLinear"
        test = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8)))
        assert torch.isfinite(model_forward(q, cfg, test)[0]).all()
        return
    if kind == "gemma3n":
        # ported: tiny-gemma3n cut to a source layer and its shared-KV tail
        # calibrates both; the tail skips its unused k/v projections and
        # attends over the source student's (k, v)
        # (tests/test_torch_gemma3n_convert.py holds the calibration against JAX's)
        cut = dict(num_hidden_layers=2, num_kv_shared_layers=1, layer_types=cfg.layer_types[:2],
                   activation_sparsity=cfg.activation_sparsity[:2])
        cfg = dataclasses.replace(cfg, **cut)
        assert cfg.kv_share_source(1) == 0
        jp = j_init_params(dataclasses.replace(J_PRESETS["tiny-gemma3n"], **cut),
                           jax.random.PRNGKey(1), dtype=jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 1, 8)).astype(np.int32)
        q, exps = calibrate_model(tp, cfg, tokens, CalibConfig(
            group_size=64, num_rotations=4, stages=(({"channel_scales": 5e-3}, 1),)), device="cpu")
        mlp = ["mlp.down_proj", "mlp.gate_proj", "mlp.up_proj"]
        assert sorted(exps[0]) == ["k_proj", *mlp, "o_proj", "q_proj", "v_proj"]
        assert sorted(exps[1]) == [*mlp, "o_proj", "q_proj"]
        assert type(q["layers"][1]["k_proj"]).__name__ == "DenseLinear"
        assert type(q["layers"][1]["q_proj"]).__name__ == "QuantizedLinear"
        test = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8)))
        assert torch.isfinite(model_forward(q, cfg, test)[0]).all()
        return
    with pytest.raises(NotImplementedError, match="§A 7"):
        calibrate_model({"layers": []}, cfg, np.zeros((1, 1, 8), np.int32), CalibConfig(),
                        mesh=object(), device="cpu")


def test_moe_quantizer_init_raises():
    """The experts' quantizer init used to raise; a quantizer stage now
    initializes a PseudoQuantMoEExperts' both sides (gate_up over the
    concatenated gate and up rows, down) as JAX's init_moe_quantizers does,
    bit for bit."""
    from paroquant_tpu.optim import pseudo_moe as jpm
    from paroquant_tpu_torch.optim import pseudo_moe as tpm

    rng = np.random.default_rng(12)
    ex = {"gate_proj": rng.normal(size=(2, 128, 64)).astype(np.float32),
          "up_proj": rng.normal(size=(2, 128, 64)).astype(np.float32),
          "down_proj": rng.normal(size=(2, 64, 128)).astype(np.float32)}
    jr = (jrot.make_rotation_params(128, 64, 4, 0), jrot.make_rotation_params(64, 64, 4, 1))
    tr = (trot.make_rotation_params(128, 64, 4, 0), trot.make_rotation_params(64, 64, 4, 1))
    jm = jpm.init_moe_quantizers(jpm.make_pseudo_moe(ex, *jr, group_size=64))
    tm = tpm.make_pseudo_moe({k: torch.from_numpy(v) for k, v in ex.items()}, *tr, group_size=64)
    x = torch.zeros(1)
    ttrain.optimize_linears(lambda d, b: x, {"experts": tm}, [], [(x, x)],
                            {"quantizer": 1e-6}, n_epochs=0)
    for f in ("gate_up_q_scale", "gate_up_q_zp", "down_q_scale", "down_q_zp"):
        np.testing.assert_array_equal(_np(getattr(tm, f)), np.asarray(getattr(jm, f)), f)
    assert tm.gate_up_q_scale.shape == (2 * 2 * 64 * 2, 1)
