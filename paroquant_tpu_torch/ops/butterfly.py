"""Butterfly pair structure (stage r pairs lane l with l XOR 2^r).

Counterpart of `paroquant_tpu/ops/butterfly.py:26-52`. The RTN Hadamard
baseline builds its rotation from these pairs: log2(S) butterfly stages at
theta = pi/4 compose to a dense +-1/sqrt(S) mixer per group.
"""

from __future__ import annotations

import numpy as np
import torch

from .rotation import RotationParams, pack_pairs


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
