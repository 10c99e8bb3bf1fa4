"""The quality ladder's synthetic outlier channels, the port of
`experiments/baselines/quality_ladder.py::inject_outlier_channels`.

Gaussian random weights have no outlier channels, the dynamic range that
makes group quantization hard in trained LLMs. `inject_outlier_channels`
scales a random ~1% of the input channels of every decoder linear by
`scale`, drawing the channels with numpy's `default_rng(seed)` in JAX's
order (per layer: q, k, v, o, then gate, up, down; on an MoE layer the
experts' gate, up and down stacks, then the shared expert's linears), so
that both packages scale the same channels of the same weights. The rest
of the ladder (its quantizer arms and perplexity protocol) is a later
slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.decoder import DenseLinear

ATTN_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_NAMES = ("gate_proj", "up_proj", "down_proj")


def inject_outlier_channels(params, config, scale: float, frac: float = 0.01, seed: int = 17):
    """A new params dict whose dense decoder linears (w [I, O]) have
    max(1, int(I * frac)) input channels, drawn without replacement, scaled
    by `scale`. On an MoE layer the stacked experts [E, In, Out] get one
    channel set per projection, shared by every expert (outlier channels in
    trained MoEs follow the activations, so the same input channels are hot
    in every expert of a layer), and a shared expert's linears their own."""
    rng = np.random.default_rng(seed)

    def _scale(lin: DenseLinear) -> DenseLinear:
        n_in = lin.w.shape[0]
        ch = rng.choice(n_in, max(1, int(n_in * frac)), replace=False)
        w = lin.w.clone()
        w[torch.from_numpy(ch).to(w.device)] *= scale
        return DenseLinear(w, lin.b)

    layers = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for n in ATTN_NAMES:
            if isinstance(nlp.get(n), DenseLinear):
                nlp[n] = _scale(nlp[n])
        mlp = dict(nlp["mlp"])
        for n in MLP_NAMES:
            if isinstance(mlp.get(n), DenseLinear):
                mlp[n] = _scale(mlp[n])
        if "experts" in mlp:
            experts = dict(mlp["experts"])
            for n in MLP_NAMES:
                w = experts[n].clone()
                ch = rng.choice(w.shape[1], max(1, int(w.shape[1] * frac)), replace=False)
                w[:, torch.from_numpy(ch).to(w.device)] *= scale
                experts[n] = w
            mlp["experts"] = experts
            if "shared_expert" in mlp:
                sh = dict(mlp["shared_expert"])
                for n in MLP_NAMES:
                    if isinstance(sh.get(n), DenseLinear):
                        sh[n] = _scale(sh[n])
                mlp["shared_expert"] = sh
        nlp["mlp"] = mlp
        layers.append(nlp)
    out = dict(params)
    out["layers"] = layers
    return out
