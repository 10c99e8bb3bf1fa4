"""The port's flash_attention (K3; its plain version on the CPU) against the
JAX flash_attention in Pallas interpret mode, in f32 at the tolerance of
tests/test_attention_kernels.py, at head_dim 64 and at the other head dims
the kernels take (16, 32, 256); a numpy model of K3's tensor-core
arithmetic (bf16 P, the live tiles, key groups) against the same Pallas
kernel per query row; and the live-tile range against the mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.kernels.attention import flash_attention as j_flash
from paroquant_tpu_torch.kernels.attention import flash_attention as t_flash

B, HQ, HKV, D = 2, 4, 2, 64  # GQA grp = 2

CASES = {
    "causal": dict(T=128, S=128),
    "q_offset_per_row": dict(T=64, S=256, q_offset=(64, 192), kv_lens=(128, 256)),
    "kv_lens_short": dict(T=128, S=128, kv_lens=(100, 57)),
    "window": dict(T=128, S=128, sliding_window=48),
    "softcap": dict(T=128, S=128, logit_softcap=20.0),
    "not_causal": dict(T=64, S=128, causal=False, kv_lens=(128, 90)),
}


def _check(case, seed, D):
    c = dict(CASES[case])
    T, S = c.pop("T"), c.pop("S")
    kv_lens = np.asarray(c.pop("kv_lens", (S, S)), np.int32)
    q_offset = np.asarray(c.pop("q_offset", (0, 0)), np.int32)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, HQ, T, D)).astype(np.float32)
    k = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    scale = D**-0.5
    yj = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_lens),
                 scale=scale, q_offset=jnp.asarray(q_offset), block_q=64, block_k=64,
                 interpret=True, **c)
    yt = t_flash(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(kv_lens), scale=scale, q_offset=torch.from_numpy(q_offset), **c)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_plain_matches_pallas(case):
    _check(case, sorted(CASES).index(case), D)


@pytest.mark.parametrize("case", ["q_offset_per_row", "window", "softcap"])
@pytest.mark.parametrize("head_dim", [16, 32, 256])
def test_flash_attention_plain_matches_pallas_head_dims(head_dim, case):
    _check(case, 100 + head_dim + sorted(CASES).index(case), head_dim)


# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (bf16 q/k/v), modelled in numpy
# ---------------------------------------------------------------------------

from paroquant_tpu_torch.kernels.attention import NEG_INF, FLASH_TILE, flash_live_tiles  # noqa: E402

TOL_KERNEL = 2e-2  # per query row: max abs error / the row's max |y| (chip_smoke.TOL_KERNEL)


def _bf16(x):
    """x rounded to bf16 (nearest even), kept in float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)).view(np.float32)


def _valid(qpos, keys, kv_end, window, causal):
    ok = keys[None, :] < kv_end
    if causal:
        ok = ok & (keys[None, :] <= qpos[:, None])
    if window:
        ok = ok & (keys[None, :] > qpos[:, None] - window)
    return ok


def flash_bf16_model(q, k, v, kv_lens, q_offset, *, scale, sliding_window=None,
                     logit_softcap=None, causal=True, key_groups=1):
    """K3's tensor-core kernel (csrc/flash_attention.cu) in numpy f32: per
    block of 64 query rows, the tiles of 64 keys `flash_live_tiles` gives,
    split over `key_groups` (group j takes tiles j, j + key_groups, ...);
    per group an online softmax in f32 with P rounded to bf16 for the PV
    product and l summed from the f32 P; the groups merged in order; the
    output rounded to bf16. Key rows at or past min(kv_len, S) are zeros."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = np.float32(scale)
    out = np.zeros_like(q)
    for b in range(B):
        kv_end = max(min(int(kv_lens[b]), S), 0)
        for h in range(Hq):
            kh, vh = k[b, h // (Hq // Hkv)], v[b, h // (Hq // Hkv)]
            for q0 in range(0, T, FLASH_TILE):
                rows = np.arange(q0, min(q0 + FLASH_TILE, T))
                qpos = int(q_offset[b]) + rows
                t_lo, n = flash_live_tiles(int(qpos[0]), int(qpos[-1]), kv_end, sliding_window,
                                           causal)
                parts = []
                for grp in range(key_groups):
                    m = np.full(len(rows), NEG_INF, np.float32)
                    l = np.zeros(len(rows), np.float32)
                    acc = np.zeros((len(rows), D), np.float32)
                    for i in range(grp, n, key_groups):
                        keys = np.arange((t_lo + i) * FLASH_TILE, (t_lo + i + 1) * FLASH_TILE)
                        live = (keys < kv_end)[:, None]
                        kt = np.where(live, kh[np.minimum(keys, S - 1)], np.float32(0))
                        vt = np.where(live, vh[np.minimum(keys, S - 1)], np.float32(0))
                        s = (q[b, h, rows] @ kt.T) * scale
                        if logit_softcap:
                            s = np.tanh(s / np.float32(logit_softcap)) * np.float32(logit_softcap)
                        ok = _valid(qpos, keys, kv_end, sliding_window, causal)
                        s = np.where(ok, s, np.float32(NEG_INF))
                        m_new = np.maximum(m, s.max(axis=1))
                        alpha = np.exp(m - m_new)
                        p = np.where(ok, np.exp(s - m_new[:, None]), np.float32(0))
                        l = alpha * l + p.sum(axis=1)
                        acc = alpha[:, None] * acc + _bf16(p) @ vt
                        m = m_new
                    parts.append((m, l, acc))
                m_all = np.max([m for m, _, _ in parts], axis=0)
                l_all = np.zeros_like(m_all)
                acc_all = np.zeros((len(rows), D), np.float32)
                for m, l, acc in parts:
                    w = np.exp(m - m_all)
                    l_all = l_all + w * l
                    acc_all = acc_all + w[:, None] * acc
                out[b, h, rows] = acc_all / np.maximum(l_all, np.float32(1e-30))[:, None]
    return _bf16(out)


def _row_ratio(y, y_ref):
    """Worst over query rows of max |y - y_ref| / max |y_ref| (a row whose
    reference is all 0 must be exactly 0), as chip_smoke.row_err_ratio."""
    e = np.abs(y - y_ref).max(axis=-1)
    r = np.abs(y_ref).max(axis=-1)
    ratio = np.where(r > 0, e / np.maximum(r, 1e-30), np.where(e > 0, np.inf, 0.0))
    return float(ratio.max())


_bf16_ref = {}


def _bf16_inputs_and_reference(case, D):
    """bf16-rounded inputs from a numpy seed and the Pallas kernel's output
    on them (interpret mode, f32), computed once per case and head dim."""
    if (case, D) not in _bf16_ref:
        c = dict(CASES[case])
        T, S = c.pop("T"), c.pop("S")
        kv_lens = np.asarray(c.pop("kv_lens", (S, S)), np.int32)
        q_offset = np.asarray(c.pop("q_offset", (0, 0)), np.int32)
        rng = np.random.default_rng(1000 + 7 * D + sorted(CASES).index(case))
        q, k, v = (_bf16(rng.normal(size=shape).astype(np.float32))
                   for shape in ((B, HQ, T, D), (B, HKV, S, D), (B, HKV, S, D)))
        yj = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_lens),
                     scale=D**-0.5, q_offset=jnp.asarray(q_offset), block_q=64, block_k=64,
                     interpret=True, **c)
        _bf16_ref[(case, D)] = (q, k, v, kv_lens, q_offset, c, np.asarray(yj))
    return _bf16_ref[(case, D)]


@pytest.mark.parametrize("key_groups", [1, 2])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bf16_model_matches_pallas(case, head_dim, key_groups):
    """The tensor-core kernel's arithmetic (bf16 P, online softmax over the
    live tiles, key groups merged) within TOL_KERNEL of the Pallas kernel
    per query row, on the same bf16-rounded inputs."""
    q, k, v, kv_lens, q_offset, c, yj = _bf16_inputs_and_reference(case, head_dim)
    y = flash_bf16_model(q, k, v, kv_lens, q_offset, scale=head_dim**-0.5,
                         key_groups=key_groups, **c)
    assert _row_ratio(y, yj) <= TOL_KERNEL


LIVE_CASES = {  # T, S, q_offset, kv_len, window, causal
    "q_offset0": (128, 128, 0, 128, None, True),
    "q_offset256": (128, 384, 256, 384, None, True),
    "window48": (192, 192, 0, 192, 48, True),
    "window128": (192, 192, 0, 192, 128, True),
    "window128_q_offset256": (128, 384, 256, 384, 128, True),
    "kv_len_mid_tile": (128, 256, 100, 200, None, True),
    "kv_len_mid_tile_window48": (128, 256, 64, 100, 48, True),  # later rows see no key
    "empty": (128, 128, 0, 0, None, True),
    "not_causal_mid_tile": (100, 128, 0, 77, None, False),
}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_flash_live_tiles_hold_every_valid_pair(case):
    """For every block of 64 query rows: no tile outside flash_live_tiles'
    range holds a valid (query, key) pair and every tile inside holds one;
    the block's last row's last valid key lies in the last tile, and with a
    window the first row's first valid key in the first tile."""
    T, S, q_offset, kv_len, window, causal = LIVE_CASES[case]
    keys = np.arange(S)
    for q0 in range(0, T, FLASH_TILE):
        qpos = q_offset + np.arange(q0, min(q0 + FLASH_TILE, T))
        ok = _valid(qpos, keys, min(kv_len, S), window, causal)
        t_lo, n = flash_live_tiles(int(qpos[0]), int(qpos[-1]), min(kv_len, S), window, causal)
        per_tile = [ok[:, t * FLASH_TILE:(t + 1) * FLASH_TILE].any() for t in range(-(-S // FLASH_TILE))]
        assert [t for t, hit in enumerate(per_tile) if hit] == list(range(t_lo, t_lo + n))
        if ok[-1].any():
            assert np.flatnonzero(ok[-1])[-1] // FLASH_TILE == t_lo + n - 1
        if window and ok[0].any():
            assert np.flatnonzero(ok[0])[0] // FLASH_TILE == t_lo
    if case == "empty":
        assert n == 0
