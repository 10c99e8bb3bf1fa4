"""Pairwise (Givens) rotation math, in torch.

Counterpart of `paroquant_tpu/ops/rotation.py:43-332`. Each 128-channel
group's K Givens stages compose into one dense orthogonal [S, S] matrix;
inference folds that matrix (with the inverse channel scales) into the
quantized linear, and the kernels apply it per group.

Interchange layout (the reference checkpoint schema):
  pairs  int32 [K, H]    group-major, entries [g*S:(g+1)*S] hold S/2 local
                         (i, j) pairs of group g, values in [0, S)
  theta  f32   [K, H/2]  one angle per pair
  mask   bool  [K, H/2]  True for dummy (identity-padding) pairs

Calibration differentiates through `apply_rotation_stages` in theta, x and
the channel scales (`scaled_pairwise_rotation`) by plain autograd, as JAX's
calibration differentiates through its twin: each stage's `perm` is a
permutation, so the `index_select` backward adds one contribution per
channel.

Pair generation and packing run on the host with numpy and Python's
`random.Random(seed)`, line for line as in the JAX package, so a seed gives
the same pairs in both.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import numpy as np
import torch


class RotationParams(NamedTuple):
    """Compact rotation parameterization (one linear layer's input dim)."""

    pairs: torch.Tensor  # int32 [K, H], local in-group indices
    theta: torch.Tensor  # float32 [K, H//2]
    mask: torch.Tensor  # bool [K, H//2]; True = dummy pair (angle pinned to 0)

    @property
    def num_rotations(self) -> int:
        return self.pairs.shape[0]

    @property
    def in_features(self) -> int:
        return self.pairs.shape[1]


# ---------------------------------------------------------------------------
# Pair generation and packing (host-side, numpy)
# ---------------------------------------------------------------------------


def generate_random_pairs(
    in_features: int,
    group_size: int,
    num_rotations: int,
    seed: int,
    num_pairs_factor: float = 0.5,
) -> list[list[tuple[int, int]]]:
    """Seeded random independent pair selection.

    Per group, shuffle all C(S, 2) unordered pairs with one shared
    random.Random(seed) stream, then greedily pick `int(S * num_pairs_factor)`
    pairs per rotation such that within a rotation no channel repeats and
    across rotations no pair repeats. Returns K lists of global (i, j) pairs.
    """
    assert in_features % group_size == 0
    num_groups = in_features // group_size
    num_pairs_each = int(group_size * num_pairs_factor)
    rand = random.Random(seed)

    per_group_shuffled: list[list[tuple[int, int]]] = []
    for _ in range(num_groups):
        all_pairs = [
            (i, j) for i in range(group_size) for j in range(i + 1, group_size)
        ]
        rand.shuffle(all_pairs)
        per_group_shuffled.append(all_pairs)

    rotations: list[list[tuple[int, int]]] = [[] for _ in range(num_rotations)]
    for g in range(num_groups):
        offset = g * group_size
        used_pairs: set[tuple[int, int]] = set()
        for r in range(num_rotations):
            used_channels: set[int] = set()
            selected: list[tuple[int, int]] = []
            for i, j in per_group_shuffled[g]:
                if len(selected) == num_pairs_each:
                    break
                if (i, j) in used_pairs or i in used_channels or j in used_channels:
                    continue
                selected.append((i, j))
                used_channels.update((i, j))
                used_pairs.add((i, j))
            rotations[r].extend((i + offset, j + offset) for i, j in selected)
    return rotations


def pack_pairs(
    rotations: list[list[tuple[int, int]]],
    in_features: int,
    group_size: int,
    angles: list[np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-rotation global pair lists into the [K, H] kernel layout.

    Validates the independence invariant and pads each group to exactly S/2
    pairs with dummy identity pairs (theta=0, mask=True).

    Returns (pairs int32 [K, H], theta float32 [K, H//2], mask bool [K, H//2]).
    """
    assert in_features % group_size == 0
    num_groups = in_features // group_size
    half = group_size // 2
    K = len(rotations)
    pairs_out = np.zeros((K, in_features), dtype=np.int32)
    theta_out = np.zeros((K, in_features // 2), dtype=np.float32)
    mask_out = np.zeros((K, in_features // 2), dtype=bool)

    for r, pair_list in enumerate(rotations):
        ang = angles[r] if angles is not None else np.zeros(len(pair_list), np.float32)
        assert len(ang) == len(pair_list), (len(ang), len(pair_list))
        per_group: list[list[tuple[int, int, float]]] = [[] for _ in range(num_groups)]
        for (i, j), a in zip(pair_list, ang):
            gi, gj = i // group_size, j // group_size
            if gi != gj:
                raise ValueError(f"pair ({i},{j}) crosses a group boundary")
            per_group[gi].append((i % group_size, j % group_size, float(a)))
        for g in range(num_groups):
            taken = np.zeros(group_size, dtype=bool)
            slot = 0
            for i, j, a in per_group[g]:
                if taken[i] or taken[j]:
                    raise ValueError(f"illegal pair: channel reuse in rotation {r} group {g}")
                if slot >= half:
                    raise ValueError(f"too many pairs in rotation {r} group {g}")
                taken[[i, j]] = True
                pairs_out[r, g * group_size + 2 * slot] = i
                pairs_out[r, g * group_size + 2 * slot + 1] = j
                theta_out[r, g * half + slot] = a
                slot += 1
            free = np.flatnonzero(~taken)
            for k in range(0, len(free), 2):
                pairs_out[r, g * group_size + 2 * slot] = free[k]
                pairs_out[r, g * group_size + 2 * slot + 1] = free[k + 1]
                mask_out[r, g * half + slot] = True
                slot += 1
            assert slot == half
    return pairs_out, theta_out, mask_out


def make_rotation_params(
    in_features: int,
    group_size: int,
    num_rotations: int,
    seed: int,
    num_pairs_factor: float = 0.5,
) -> RotationParams:
    """Random independent pairs packed into RotationParams (theta = 0), on the CPU."""
    rotations = generate_random_pairs(
        in_features, group_size, num_rotations, seed, num_pairs_factor
    )
    pairs, theta, mask = pack_pairs(rotations, in_features, group_size)
    return RotationParams(
        pairs=torch.from_numpy(pairs), theta=torch.from_numpy(theta),
        mask=torch.from_numpy(mask),
    )


# ---------------------------------------------------------------------------
# Permutation form (static, host-side given static pairs)
# ---------------------------------------------------------------------------


def pairs_to_permutation(pairs, group_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-stage channel-wise view of the pair table.

    For stage r and global channel c with pair (i, j), returns
      perm      int32 [K, H] global index of c's partner
      sign      float32 [K, H] +1 if c is the first element (i), -1 if second (j)
      theta_idx int32 [K, H] index into theta[r] ([K, H//2]) of c's angle
    so that y[c] = cos(th[c]) * x[c] + sign[c] * sin(th[c]) * x[perm[c]].
    """
    pairs = np.asarray(pairs)
    K, H = pairs.shape
    num_groups = H // group_size
    half = group_size // 2
    p = pairs.reshape(K, num_groups, half, 2).astype(np.int64)
    base = (np.arange(num_groups) * group_size)[None, :, None]
    gi = p[..., 0] + base  # [K, G, half] global first elements
    gj = p[..., 1] + base
    slot = (np.arange(num_groups)[:, None] * half + np.arange(half)[None, :])[None]
    slot = np.broadcast_to(slot, gi.shape)
    rows = np.broadcast_to(np.arange(K)[:, None, None], gi.shape)
    perm = np.zeros((K, H), dtype=np.int32)
    sign = np.zeros((K, H), dtype=np.float32)
    theta_idx = np.zeros((K, H), dtype=np.int32)
    perm[rows, gi] = gj
    perm[rows, gj] = gi
    sign[rows, gi] = 1.0
    sign[rows, gj] = -1.0
    theta_idx[rows, gi] = slot
    theta_idx[rows, gj] = slot
    return perm, sign, theta_idx


class PermutationForm(NamedTuple):
    """Stage-wise permutation representation (all [K, H])."""

    perm: torch.Tensor  # int64, partner channel (global)
    sign: torch.Tensor  # float32, +1 / -1
    theta_idx: torch.Tensor  # int64, per-channel index into theta[r]


def to_permutation_form(pairs, group_size: int, device=None) -> PermutationForm:
    perm, sign, theta_idx = pairs_to_permutation(
        pairs.cpu().numpy() if isinstance(pairs, torch.Tensor) else pairs, group_size
    )
    return PermutationForm(
        torch.from_numpy(perm).long().to(device),
        torch.from_numpy(sign).to(device),
        torch.from_numpy(theta_idx).long().to(device),
    )


# ---------------------------------------------------------------------------
# Stage application
# ---------------------------------------------------------------------------


def effective_theta(params: RotationParams) -> torch.Tensor:
    """theta with the dummy pairs' angles pinned to zero (masked inside the
    forward, so no step needs to re-zero them)."""
    return torch.where(params.mask, torch.zeros_like(params.theta), params.theta)


def apply_rotation_stages(
    x: torch.Tensor,
    theta: torch.Tensor,
    form: PermutationForm,
    *,
    inverse: bool = False,
) -> torch.Tensor:
    """Apply K Givens stages to the last dim of x, in float32.

    theta: [K, H//2]. `inverse=True` applies the transposed rotation (stages
    reversed, angles negated).
    """
    K = theta.shape[0]
    orig_dtype = x.dtype
    y = x.to(torch.float32)
    theta = theta.to(torch.float32)
    order = range(K - 1, -1, -1) if inverse else range(K)
    for r in order:
        th_ch = theta[r][form.theta_idx[r]]  # [H]
        if inverse:
            th_ch = -th_ch
        c = torch.cos(th_ch)
        s = torch.sin(th_ch) * form.sign[r]
        y = c * y + s * torch.index_select(y, -1, form.perm[r])
    return y.to(orig_dtype)


def scaled_pairwise_rotation(
    x: torch.Tensor,
    theta: torch.Tensor,
    form: PermutationForm,
    channel_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scale, then rotate: y = R (x * channel_scales) rowwise."""
    if channel_scales is not None:
        x = x * channel_scales.to(x.dtype)
    return apply_rotation_stages(x, theta, form)


# ---------------------------------------------------------------------------
# Dense composed form (inference path)
# ---------------------------------------------------------------------------


def build_rotation_matrices(
    theta: torch.Tensor,
    form: PermutationForm,
    group_size: int,
    *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Compose the K Givens stages into dense per-group matrices.

    Returns R [G, S, S] with y_group = R_g @ x_group, R = S_{K-1} @ ... @ S_0.
    """
    K, H = form.perm.shape
    G = H // group_size
    dev = theta.device
    eye = torch.eye(group_size, dtype=torch.float32, device=dev)
    R = eye.expand(G, group_size, group_size)
    local_perm_all = (form.perm % group_size).reshape(K, G, group_size)
    theta = theta.to(torch.float32)
    for r in range(K):
        th_ch = theta[r][form.theta_idx[r]]  # [H]
        c = torch.cos(th_ch).reshape(G, group_size)
        s = (torch.sin(th_ch) * form.sign[r]).reshape(G, group_size)
        onehot = torch.nn.functional.one_hot(local_perm_all[r], group_size).to(torch.float32)
        stage = c[..., None] * eye + s[..., None] * onehot
        R = torch.bmm(stage, R)
    return R.to(dtype)


def apply_rotation_matrices(
    x: torch.Tensor, rot: torch.Tensor, *, inverse: bool = False
) -> torch.Tensor:
    """y[..., g*S+i] = sum_j rot[g, i, j] * x[..., g*S+j] (rot^T with
    inverse=True), accumulated in f32 and cast back to x's dtype."""
    G, S, _ = rot.shape
    shape = x.shape
    xg = x.reshape(*shape[:-1], G, S).to(rot.dtype).to(torch.float32)
    eq = "gji,...gj->...gi" if inverse else "gij,...gj->...gi"
    y = torch.einsum(eq, rot.to(torch.float32), xg)
    return y.reshape(shape).to(x.dtype)
