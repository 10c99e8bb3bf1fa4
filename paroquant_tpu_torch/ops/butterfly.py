"""Butterfly pair structure (stage r pairs lane l with l XOR 2^r).

Counterpart of `paroquant_tpu/ops/butterfly.py`. The RTN Hadamard baseline
builds its rotation from these pairs: log2(S) butterfly stages at theta =
pi/4 compose to a dense +-1/sqrt(S) mixer per group. `butterfly_tables`
gives the per-channel cos / signed-sin tables that the butterfly kernel
(`kernels/rot_matmul.py::butterfly_w4_matmul`, K7) reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .rotation import RotationParams, pack_pairs, pairs_to_permutation


def butterfly_distances(num_rotations: int, group_size: int) -> list[int]:
    """Stage partner distances: 1, 2, 4, ... wrapping back to 1."""
    n_pow = max(int(np.log2(group_size)), 1)
    return [2 ** (r % n_pow) for r in range(num_rotations)]


def make_butterfly_params(
    in_features: int, group_size: int, num_rotations: int
) -> RotationParams:
    """Butterfly pairs packed into RotationParams (theta = 0), on the CPU."""
    if group_size & (group_size - 1):
        raise ValueError(f"butterfly needs a power-of-2 group, got {group_size}")
    num_groups = in_features // group_size
    rotations: list[list[tuple[int, int]]] = []
    for d in butterfly_distances(num_rotations, group_size):
        stage = []
        for g in range(num_groups):
            base = g * group_size
            for lane in range(group_size):
                if lane & d == 0 and (lane ^ d) < group_size:
                    stage.append((base + lane, base + (lane ^ d)))
        rotations.append(stage)
    pairs, theta, mask = pack_pairs(rotations, in_features, group_size)
    return RotationParams(
        torch.from_numpy(pairs), torch.from_numpy(theta), torch.from_numpy(mask)
    )


def is_butterfly_pairs(pairs, group_size: int) -> bool:
    """True if `pairs` [K, H] matches the butterfly structure exactly."""
    pairs = np.asarray(pairs)
    K, H = pairs.shape
    ref = make_butterfly_params(H, group_size, K).pairs.numpy()
    return bool((pairs == ref).all())


def butterfly_tables(theta, group_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel cos / signed-sin tables [K, H] float32 of theta [K, H//2]
    (angles in butterfly pack order): for channel l and its partner
    p = l ^ d_r, stage r sets y[l] = cos[r, l] x[l] + sin[r, l] x[p], the
    sine's sign +1 when bit d_r of l is clear, -1 when it is set."""
    theta = np.asarray(theta, np.float32)
    K, half_h = theta.shape
    params = make_butterfly_params(half_h * 2, group_size, K)
    _, sign, theta_idx = pairs_to_permutation(params.pairs.numpy(), group_size)
    theta_ch = theta[np.arange(K)[:, None], theta_idx]  # [K, H]
    return (
        np.cos(theta_ch).astype(np.float32),
        (np.sin(theta_ch) * sign).astype(np.float32),
    )
