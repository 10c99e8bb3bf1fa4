"""K1/K2's plain versions (`paroquant_tpu_torch/kernels/rot_matmul.py`)
against the Pallas kernels (`paroquant_tpu/kernels/rot_matmul.py`, interpret
mode) on Gaussian draws, and the tolerance every rotated-W4 parity test of
the port holds: `rot_tolerance`.

Both sides round xr = x_g @ M_g^T to bf16 after an f32 sum, and the two f32
sums run in different orders (XLA's dot, torch's einsum). Where the exact
value of an element lies close to a bf16 rounding midpoint, the two f32
values can fall on either side of it and round one bf16 ulp apart. On
numpy seeds 0-399 of the draws below (x ~ N(0, 1), rotations ~ N(0, 1/S),
G 3, O 160, S 64/128/256 and M 1/5/16 by seed), 22 of the 400 miss 1e-5 x
max |y|; the worst misses it by 51 times (5.07e-4 x max |y|, seed 308, S
256, M 1), with one such element in its row.

The bound, derived so that it holds whatever order either side sums in:
for any order, an f32 dot of S terms lies within
gamma_S * sum_j |x_j r_ij| of the exact value, gamma_S = S u / (1 - S u),
u = 2**-24. So where the exact value (float64 here) lies farther than that
from every bf16 midpoint, both sides round to the same bf16; where it lies
within it, they may differ by one bf16 ulp of it, 2**(floor(log2 |v|) - 7).
The element's coefficient in y[m, o] is (q[i, o] - z[o]) s[o] (xr feeds the
dot and the zero point's row sum), or q[i, o] s[o] where the row sum takes
the unrounded f32 value (K10), or the dequantized weight w[i, o] =
bf16(bf16(q[i, o] - z[o]) s[o]) where the dot takes the weight whole and
there is no row sum (K8, K11). So

    |y - y_ref| <= 1e-5 max |y_ref|
                   + sum over such elements i of ulp_i |coefficient[i, o]|
                   (+ 2**-7 |y_ref| where y is bf16: a different f32 sum may
                   round the output one bf16 ulp the other way)

where the first term, as before, covers the other f32 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels import rot_matmul as jk
from paroquant_tpu_torch.kernels import rot_matmul as tk

U32 = 2.0**-24  # f32 unit roundoff


def _f64(t) -> np.ndarray:
    return (t.float() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
            .float()).numpy().astype(np.float64)


def flip_bound(x, rot, qweight, scales, zeros, out_splits=None, *, variant="k1") -> np.ndarray:
    """The bf16-flip term of `rot_tolerance`, float64 [M, O]. x [M, I] as
    the caller passes it, rot [G, S, S] or [P, G, S, S], qweight uint8
    [I//2, O], scales/zeros [G, O] (torch tensors). variant "k1" (K1/K2),
    "b" (K10: x in rot's dtype, the row sum unrounded), "v2" (K12: x not
    rounded) or "dq" (K8/K11: x and rot rounded to bf16, the coefficient the
    dequantized weight |bf16(bf16(q - z) s)| with s and z in bf16)."""
    rot = rot if rot.dim() == 4 else rot[None]
    P, G, S, _ = rot.shape
    M = x.shape[0]
    out_splits = out_splits or (qweight.shape[1],)
    if variant == "dq":
        xg, rot = _f64(tk._bf16(x)).reshape(M, G, S), tk._bf16(rot)
        w = tk._bf16(tk._bf16(tk._unpack_groups(qweight, G, S) - tk._bf16(zeros)[:, None])
                     * tk._bf16(scales)[:, None])
        coef = np.abs(_f64(w))
    else:
        xg = _f64(x if variant == "v2" else x.to(rot.dtype)).reshape(M, G, S)
        q = _f64(tk._unpack_groups(qweight, G, S))  # [G, S, O]
        s, z = _f64(scales), _f64(zeros)
        coef = np.abs(q * s[:, None] if variant == "b" else (q - z[:, None]) * s[:, None])
    gamma = S * U32 / (1 - S * U32)
    parts, off = [], 0
    for p, n in enumerate(out_splits):
        r = _f64(rot[p])
        v = np.einsum("mgj,gij->mgi", xg, r)
        eps = gamma * np.einsum("mgj,gij->mgi", np.abs(xg), np.abs(r))
        with np.errstate(divide="ignore", invalid="ignore"):
            ulp = 2.0 ** (np.floor(np.log2(np.abs(v) + eps)) - 7)
            d = np.abs(v / ulp - (np.floor(v / ulp) + 0.5)) * ulp  # to the nearest midpoint
        flips = np.where((eps > 0) & (d <= eps), ulp, 0.0)
        parts.append(np.einsum("mgi,gio->mo", flips, coef[:, :, off:off + n]))
        off += n
    return np.concatenate(parts, axis=1)


def rot_tolerance(y_ref, x, rot, qweight, scales, zeros, out_splits=None, *, variant="k1",
                  bf16_out=False) -> np.ndarray:
    """The elementwise bound of the module docstring around y_ref (numpy)."""
    y_ref = np.asarray(y_ref, np.float64)
    tol = 1e-5 * np.abs(y_ref).max() + flip_bound(x, rot, qweight, scales, zeros, out_splits,
                                                  variant=variant)
    return tol + (2.0**-7 * np.abs(y_ref) if bf16_out else 0.0)


SS, MS = (64, 128, 256), (1, 5, 16)
MERGED_SPLITS = ((66, 62), (128, 96, 160), (64, 34, 48, 78))  # tests/test_torch_rot_w4_route.py's
G = 3


def gaussian_draw(seed: int, merged: bool):
    """Seed i: S = SS[i % 3], M = MS[i // 3 % 3]; K1 one partition of 160
    columns, K2 the splits MERGED_SPLITS[i // 9 % 3]. numpy arrays."""
    S, M = SS[seed % 3], MS[seed // 3 % 3]
    splits = MERGED_SPLITS[seed // 9 % 3] if merged else (160,)
    I, O = G * S, sum(splits)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, I)).astype(np.float32)
    shape = (len(splits), G, S, S) if merged else (G, S, S)
    rot = (rng.normal(size=shape) / np.sqrt(S)).astype(np.float32)
    qw = rng.integers(0, 256, size=(I // 2, O)).astype(np.uint8)
    s = rng.uniform(0.01, 0.05, size=(G, O)).astype(np.float32)
    z = rng.integers(0, 16, size=(G, O)).astype(np.float32)
    return (x, rot, qw, s, z), splits


def _both(ops, splits, merged):
    """(JAX output, port output, port operands) of K1 or K2, float64 numpy."""
    jops = [jnp.asarray(a) for a in ops]
    tops = [torch.from_numpy(a) for a in ops]
    if merged:
        yj = jk.merged_rot_w4_matmul(*jops, out_splits=splits, interpret=True)
        yt = tk.merged_rot_w4_matmul(*tops, out_splits=splits)
    else:
        yj = jk.rot_w4_matmul(*jops, interpret=True)
        yt = tk.rot_w4_matmul(*tops)
    return np.asarray(yj, np.float64), yt.numpy().astype(np.float64), tops


@pytest.mark.parametrize("chunk", range(8))
@pytest.mark.parametrize("kernel", ["rot_w4_matmul", "merged_rot_w4_matmul"])
def test_plain_meets_the_flip_bound_on_gaussian_draws(kernel, chunk):
    """Seeds 50 * chunk .. 50 * chunk + 49: every one within rot_tolerance."""
    merged = kernel == "merged_rot_w4_matmul"
    for seed in range(50 * chunk, 50 * chunk + 50):
        ops, splits = gaussian_draw(seed, merged)
        yj, yt, tops = _both(ops, splits, merged)
        tol = rot_tolerance(yj, *tops, out_splits=splits)
        assert np.all(np.abs(yt - yj) <= tol), (seed, (np.abs(yt - yj) / tol).max())


def test_the_worst_draw_needs_the_flip_term():
    """Seed 308 (S 256, M 1), the worst of the 400 K1 draws: the plain
    version misses 1e-5 x max |y| alone, by about 50 times, and meets the
    bound with the flip term."""
    ops, splits = gaussian_draw(308, False)
    yj, yt, tops = _both(ops, splits, False)
    err = np.abs(yt - yj).max() / np.abs(yj).max()
    assert 2e-4 < err < 1e-3
    assert np.all(np.abs(yt - yj) <= rot_tolerance(yj, *tops))
