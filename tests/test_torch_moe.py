"""The port's MoE dispatch (`paroquant_tpu_torch/ops/moe.py`) and routing
(`models/decoder.py::moe_forward`) against JAX's, on the CPU, from the same
seeded numpy inputs: dense experts and `QuantizedMoEExperts` (JAX's RTN of
the same weights, handed over through params_from_jax).

Tolerances, and why. Every product runs in f32 in both packages; they
differ in the order of the sums (a matmul's blocking, the scatter-add of a
token's K contributions), a few ulps, so outputs are held within 1e-5 of
max |y|. Expert choices are held exactly wherever the k-th and (k+1)-th
router probabilities are more than ROUTE_MARGIN apart (the f32 noise of the
two packages' router inputs is far below it); the tokens inside the margin
are counted and reported, not avoided. Exact ties take the lower expert
index in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert.rtn import quantize_experts_rtn as j_quantize_experts
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.ops import moe as jmoe
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.ops import moe as tmoe

E, H, I = 8, 256, 128
TOL = 1e-5
ROUTE_MARGIN = 1e-6  # router probabilities closer than this may order apart


def _experts(seed=0, std=0.1):
    rng = np.random.default_rng(seed)
    return {"gate_proj": rng.normal(0, std, (E, H, I)).astype(np.float32),
            "up_proj": rng.normal(0, std, (E, H, I)).astype(np.float32),
            "down_proj": rng.normal(0, std, (E, I, H)).astype(np.float32)}


def _both(kind, seed=0):
    """(JAX experts, port experts) of the same weights."""
    ex = _experts(seed)
    if kind == "dense":
        return {k: jnp.asarray(v) for k, v in ex.items()}, {k: torch.from_numpy(v)
                                                            for k, v in ex.items()}
    jq = j_quantize_experts({k: jnp.asarray(v) for k, v in ex.items()})
    tree = params_from_jax({"layers": [{"mlp": {"experts": jax.tree.map(np.asarray, jq)}}]},
                           PRESETS["tiny-moe"], "cpu")
    return jq, tree["layers"][0]["mlp"]["experts"]


def _inputs(T, K, seed=1, routing=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, H)).astype(np.float32)
    if routing is None:  # K distinct experts a token
        idx = np.stack([rng.choice(E, K, replace=False) for _ in range(T)]).astype(np.int32)
    else:
        idx = routing.astype(np.int32)
    gates = rng.uniform(0, 1, (T, K)).astype(np.float32)
    return x, idx, gates


def _close(t, j):
    j = np.asarray(j, np.float32)
    return np.abs(t.detach().numpy() - j).max() <= TOL * np.abs(j).max()


def _run(path, je, te, x, idx, gates, cf=2.0):
    jx, ji, jg = jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates)
    tx, ti, tg = torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates)
    if path == "capacity":
        return (jmoe._moe_capacity(je, jx, ji, jg, cf), tmoe._moe_capacity(te, tx, ti, tg, cf))
    jf, tf = {"gather": (jmoe._moe_gather, tmoe._moe_gather),
              "ragged": (jmoe._moe_ragged, tmoe._moe_ragged)}[path]
    return jf(je, jx, ji, jg), tf(te, tx, ti, tg)


@pytest.mark.parametrize("path", ["gather", "ragged", "capacity"])
@pytest.mark.parametrize("kind", ["dense", "quantized"])
def test_paths_match_jax(kind, path):
    je, te = _both(kind)
    x, idx, gates = _inputs(24, 2)
    jy, ty = _run(path, je, te, x, idx, gates)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (24, H)
    assert _close(ty, jy)


@pytest.mark.parametrize("kind", ["dense", "quantized"])
def test_return_act_rows_in_jax_order(kind):
    """The down_proj inputs come back one row per assignment, sorted stably
    by expert: JAX's rows in JAX's order (GPTQ pools them)."""
    je, te = _both(kind)
    x, idx, gates = _inputs(20, 2, seed=4)
    jy, ja = jmoe.moe_apply(je, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates),
                            return_act=True)
    ty, ta = tmoe.moe_apply(te, torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(gates), return_act=True)
    assert tuple(ta.shape) == (40, I) and ta.dtype == torch.float32
    assert _close(ty, jy) and _close(ta, ja)
    # a row out of place fails: the rows of the first two assignments swapped
    swapped = ta.clone()
    swapped[[0, 1]] = ta[[1, 0]]
    assert not _close(swapped, ja)


@pytest.mark.parametrize("T", [32, 33])  # T * K = 64 (gather) and 66 (ragged), K = 2
@pytest.mark.parametrize("kind", ["dense", "quantized"])
def test_cut_between_gather_and_ragged(kind, T, monkeypatch):
    je, te = _both(kind)
    x, idx, gates = _inputs(T, 2, seed=5)
    taken = []
    for name in ("_moe_gather", "_moe_ragged"):
        fn = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _f=fn, _n=name, **k: (taken.append(_n),
                                                                       _f(*a, **k))[1])
    ty = tmoe.moe_apply(te, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates))
    jy = jmoe.moe_apply(je, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates))
    assert taken == (["_moe_gather"] if T * 2 <= 64 else ["_moe_ragged"])
    assert _close(ty, jy)


@pytest.mark.parametrize("kind", ["dense", "quantized"])
def test_ragged_equals_gather_under_imbalance(kind):
    """Every token on experts 0 and 1, and balanced routing: the ragged path
    drops nothing, so it equals the gather path (both packages)."""
    _, te = _both(kind, seed=2)
    T = 48
    skew = np.stack([np.zeros(T), np.ones(T)], axis=1)
    for routing in (skew, None):
        x, idx, gates = _inputs(T, 2, seed=6, routing=routing)
        args = (te, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates))
        g, r = tmoe._moe_gather(*args), tmoe._moe_ragged(*args)
        assert torch.abs(g - r).max() <= TOL * torch.abs(g).max()


def test_capacity_drops_what_jax_drops():
    """Under the skewed routing the capacity path at factor 2.0 drops most
    assignments: it moves far from the gather path, and exactly as JAX's."""
    je, te = _both("dense", seed=2)
    T = 48
    x, idx, gates = _inputs(T, 2, seed=6, routing=np.stack([np.zeros(T), np.ones(T)], axis=1))
    jy, ty = _run("capacity", je, te, x, idx, gates)
    assert _close(ty, jy)
    g = tmoe._moe_gather(te, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates))
    assert torch.abs(ty - g).max() > 1e-3
    # the dropped assignments contribute nothing: tokens past the capacity
    # (min(max(int(48 * 2 * 2 / 8), 8), 48) = 24 a expert) come out zero
    assert torch.count_nonzero(ty[24:]) == 0 and torch.count_nonzero(ty[:24]) > 0


def test_dequant_stacked_bit_for_bit():
    jq, tq = _both("quantized", seed=3)
    for p in ("gate", "up", "down"):
        j = jmoe._dequant_stacked(getattr(jq, f"{p}_qweight"), getattr(jq, f"{p}_scales"),
                                  getattr(jq, f"{p}_zeros"), jq.group_size)
        t = tmoe._dequant_stacked(getattr(tq, f"{p}_qweight"), getattr(tq, f"{p}_scales"),
                                  getattr(tq, f"{p}_zeros"), tq.group_size)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        packed = tmoe.pack_stacked(tmoe._unpack_stacked(getattr(tq, f"{p}_qweight"),
                                                        t.shape[1], 128), 4, 128)
        assert torch.equal(packed, getattr(tq, f"{p}_qweight"))


# ---------------------------------------------------------------------------
# Routing: moe_forward's router, softmax, top-k and renormalization
# ---------------------------------------------------------------------------

MOE_CFG = dataclasses.replace(PRESETS["tiny-moe"], shared_expert_intermediate_size=256)
J_MOE_CFG = dataclasses.replace(J_PRESETS["tiny-moe"], shared_expert_intermediate_size=256)


def _moe_layer(seed=0, tie_columns=False):
    lp = jd.init_params(J_MOE_CFG, jax.random.PRNGKey(seed), dtype=jnp.float32)["layers"][0]
    mlp = lp["mlp"]
    if tie_columns:  # experts 2 and 5 get the same router column: exact ties
        w = np.array(mlp["router"].w)
        w[:, 5] = w[:, 2]
        w *= 40.0  # and make them the top two for most tokens
        w[:, [0, 1, 3, 4, 6, 7]] *= 0.01
        mlp = dict(mlp, router=mlp["router"]._replace(w=jnp.asarray(w)))
    tmlp = params_from_jax({"layers": [{"mlp": jax.tree.map(np.asarray, mlp)}]}, MOE_CFG,
                           "cpu")["layers"][0]["mlp"]
    return mlp, tmlp


def _routes(mlp, tmlp, x, monkeypatch):
    """Each package's (idx, gates) as handed to moe_apply, and the outputs."""
    seen = {}

    def spy(key, fn):
        def f(experts, xt, idx, gates, *a, **k):
            seen[key] = (np.asarray(idx), np.asarray(gates))
            return fn(experts, xt, idx, gates, *a, **k)
        return f

    monkeypatch.setattr(jmoe, "moe_apply", spy("jax", jmoe.moe_apply))
    monkeypatch.setattr(tmoe, "moe_apply", spy("port", tmoe.moe_apply))
    jy = jd.moe_forward(mlp, jnp.asarray(x), J_MOE_CFG, "xla")
    ty = td.moe_forward(tmlp, torch.from_numpy(x), MOE_CFG, "xla")
    return seen["jax"], seen["port"], jy, ty


def test_router_choices_match_jax_outside_the_margin(monkeypatch):
    mlp, tmlp = _moe_layer(seed=1)
    x = np.random.default_rng(7).normal(size=(2, 40, H)).astype(np.float32)
    (jidx, jg), (tidx, tg), jy, ty = _routes(mlp, tmlp, x, monkeypatch)
    xt = x.reshape(-1, H)
    logits = xt @ np.asarray(mlp["router"].w, np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ps = -np.sort(-p, axis=-1)
    K = MOE_CFG.num_experts_per_tok
    clear = (ps[:, K - 1] - ps[:, K]) > ROUTE_MARGIN
    print(f"tokens within {ROUTE_MARGIN} of a routing tie: {int((~clear).sum())} of {len(clear)}")
    np.testing.assert_array_equal(tidx[clear], jidx[clear])
    assert np.abs(tg[clear] - jg[clear]).max() <= TOL
    if clear.all():
        assert _close(ty, jy)


def test_routing_ties_take_the_lower_expert_index(monkeypatch):
    """Experts 2 and 5 share a router column: their probabilities tie
    exactly, and both packages put expert 2 first (lax.top_k's rule)."""
    mlp, tmlp = _moe_layer(seed=2, tie_columns=True)
    x = np.random.default_rng(8).normal(size=(1, 30, H)).astype(np.float32)
    (jidx, _), (tidx, _), jy, ty = _routes(mlp, tmlp, x, monkeypatch)
    tied = (jidx == 2).any(-1) & (jidx == 5).any(-1)
    assert tied.sum() >= 10
    np.testing.assert_array_equal(tidx, jidx)
    assert (np.argmax(jidx == 2, -1) < np.argmax(jidx == 5, -1))[tied].all()
    assert _close(ty, jy)


def test_moe_forward_return_act_and_shared_expert(monkeypatch):
    mlp, tmlp = _moe_layer(seed=3)
    x = np.random.default_rng(9).normal(size=(1, 24, H)).astype(np.float32)
    jy, ja, jsa = jd.moe_forward(mlp, jnp.asarray(x), J_MOE_CFG, "xla", return_act=True)
    ty, ta, tsa = td.moe_forward(tmlp, torch.from_numpy(x), MOE_CFG, "xla", return_act=True)
    assert _close(ty, jy) and _close(ta, ja) and _close(tsa, jsa)
    assert tuple(tsa.shape) == (24, 256)
    # without the shared expert's gate the output moves
    no_gate = dict(tmlp, shared_expert_gate=td.DenseLinear(torch.full((H, 1), -40.0)))
    assert not _close(td.moe_forward(no_gate, torch.from_numpy(x), MOE_CFG, "xla"), jy)
