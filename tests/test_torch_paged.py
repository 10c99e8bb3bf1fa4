"""The port's paged serving pieces against the JAX package on the CPU.

K4/K5 (their plain versions on the CPU) against `paged_decode_attention` /
`paged_window_attention_kernel` in Pallas interpret mode and the einsum
references, `kv_quantize`, `scatter_prefill_kv` / `gather_prefix_rows`, and
`paged_decode_step` / `paged_verify_step` of the `tiny` preset (f32, W4
Hadamard RTN, merged projections), the same weights and the same page pool
handed to both packages through params_from_jax and paged_cache_from_jax.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paroquant_tpu.convert.rtn import quantize_model_rtn as j_rtn
from paroquant_tpu.kernels import attention as jka
from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.serve import paged as jpg
from paroquant_tpu_torch.convert.interop import paged_cache_from_jax, params_from_jax, to_torch
from paroquant_tpu_torch.kernels import attention as tka
from paroquant_tpu_torch.models import PRESETS
from paroquant_tpu_torch.serve import paged as tpg

CFG = PRESETS["tiny"]
JCFG = J_PRESETS["tiny"]
# f32 on both sides: only the order of the sums differs
ATOL = 1e-5

# K4/K5 inputs: GQA grp 2, pages of 8 rows, a shuffled table whose tails
# point at a trash page (index P - 1) that holds NaN, ragged lengths
B, HQ, HKV, D, PS, P, MAXP = 4, 4, 2, 64, 8, 24, 5
LENS_INCL = np.array([1, 9, 23, 40], np.int32)  # K4: including the current token
LENS_WIN = np.array([0, 8, 19, 36], np.int32)  # K5: before a window of 4
W = 4


def _pool(rng, quant, d=D, hkv=HKV):
    table = np.full((B, MAXP), P - 1, np.int32)
    perm = rng.permutation(P - 1)
    for b, n in enumerate((1, 2, 3, 5)):
        table[b, :n] = perm[b * 5 : b * 5 + n]
    if quant:
        k = rng.integers(-127, 128, (P, PS, hkv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (P, PS, hkv, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (P, hkv, PS)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (P, hkv, PS)).astype(np.float32)
        return table, k, v, ks, vs
    k = rng.standard_normal((P, PS, hkv, d)).astype(np.float32)
    v = rng.standard_normal((P, PS, hkv, d)).astype(np.float32)
    k[P - 1] = np.nan  # the trash page is never read
    v[P - 1] = np.nan
    return table, k, v, None, None


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


KERNEL_CASES = [(w, c, qn) for qn in (False, True) for w in (None, 6) for c in (None, 20.0)]


@pytest.mark.parametrize("window,softcap,quant", KERNEL_CASES)
def test_paged_decode_plain_matches_pallas(window, softcap, quant):
    rng = np.random.default_rng(KERNEL_CASES.index((window, softcap, quant)))
    table, k, v, ks, vs = _pool(rng, quant)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    kw = dict(scale=0.125, sliding_window=window, logit_softcap=softcap)
    want = jka.paged_decode_attention(
        jnp.asarray(q), _j(k), _j(v), jnp.asarray(table), jnp.asarray(LENS_INCL),
        k_scales=_j(ks), v_scales=_j(vs), interpret=True, **kw)
    got = tka.paged_decode_attention(_t(q), _t(k), _t(v), _t(table), _t(LENS_INCL),
                                     k_scales=_t(ks), v_scales=_t(vs), **kw)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("window,softcap,quant", KERNEL_CASES)
def test_paged_window_plain_matches_pallas(window, softcap, quant):
    rng = np.random.default_rng(10 + KERNEL_CASES.index((window, softcap, quant)))
    table, k, v, ks, vs = _pool(rng, quant)
    q = rng.standard_normal((B, W, HQ, D)).astype(np.float32)
    kw = dict(scale=0.125, sliding_window=window, logit_softcap=softcap)
    want = jka.paged_window_attention_kernel(
        jnp.asarray(q), _j(k), _j(v), jnp.asarray(table), jnp.asarray(LENS_WIN),
        k_scales=_j(ks), v_scales=_j(vs), interpret=True, **kw)
    got = tka.paged_window_attention_kernel(_t(q), _t(k), _t(v), _t(table), _t(LENS_WIN),
                                            k_scales=_t(ks), v_scales=_t(vs), **kw)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# head dims and query-row counts beyond D = 64 and W * grp = 8: (D, Hq, Hkv, W)
SHAPES = {"D32": (32, 4, 2, W), "D256": (256, 4, 2, W), "R80_D128": (128, 32, 2, 5),
          "R80_D256": (256, 16, 1, 5)}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", ["D32", "D256"])
def test_paged_decode_plain_matches_pallas_head_dims(shape, quant):
    d, hq, hkv, _ = SHAPES[shape]
    rng = np.random.default_rng(200 + d + quant)
    table, k, v, ks, vs = _pool(rng, quant, d, hkv)
    q = rng.standard_normal((B, hq, d)).astype(np.float32)
    kw = dict(scale=d**-0.5, sliding_window=6, logit_softcap=20.0)
    want = jka.paged_decode_attention(
        jnp.asarray(q), _j(k), _j(v), jnp.asarray(table), jnp.asarray(LENS_INCL),
        k_scales=_j(ks), v_scales=_j(vs), interpret=True, **kw)
    got = tka.paged_decode_attention(_t(q), _t(k), _t(v), _t(table), _t(LENS_INCL),
                                     k_scales=_t(ks), v_scales=_t(vs), **kw)
    assert got.shape == (B, hq, d) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_paged_window_plain_matches_pallas_head_dims(shape, quant):
    """R80: W 5 x 16 query heads per kv head, 80 rows (the engine at spec_k 4)."""
    d, hq, hkv, wn = SHAPES[shape]
    rng = np.random.default_rng(300 + list(SHAPES).index(shape) * 2 + quant)
    table, k, v, ks, vs = _pool(rng, quant, d, hkv)
    q = rng.standard_normal((B, wn, hq, d)).astype(np.float32)
    kw = dict(scale=d**-0.5)
    want = jka.paged_window_attention_kernel(
        jnp.asarray(q), _j(k), _j(v), jnp.asarray(table), jnp.asarray(LENS_WIN),
        k_scales=_j(ks), v_scales=_j(vs), interpret=True, **kw)
    got = tka.paged_window_attention_kernel(_t(q), _t(k), _t(v), _t(table), _t(LENS_WIN),
                                            k_scales=_t(ks), v_scales=_t(vs), **kw)
    assert got.shape == (B, wn, hq, d) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_einsum_references_match_jax(quant):
    """The port's einsum references, and K4/K5's plain versions, against
    JAX's einsum references on the gathered (dequantized) pages."""
    rng = np.random.default_rng(30 + quant)
    table, k, v, ks, vs = _pool(rng, quant)
    k[P - 1] = 0  # the einsum references gather every page of the table
    v[P - 1] = 0
    jk, jv = jnp.asarray(k)[table], jnp.asarray(v)[table]
    if quant:
        jk = jpg._dequant_pages(jk, jnp.asarray(ks)[table])
        jv = jpg._dequant_pages(jv, jnp.asarray(vs)[table])
    tk, tv = _t(np.asarray(jk)), _t(np.asarray(jv))
    kw = dict(scale=0.125, sliding_window=7, logit_softcap=30.0)
    q1 = rng.standard_normal((B, HQ, D)).astype(np.float32)
    want1 = np.asarray(jpg.paged_attention(jnp.asarray(q1), jk, jv, jnp.asarray(LENS_INCL), **kw))
    np.testing.assert_allclose(tpg.paged_attention(_t(q1), tk, tv, _t(LENS_INCL), **kw).numpy(),
                               want1, rtol=0, atol=ATOL)
    plain1 = tka.paged_decode_attention_plain(_t(q1), _t(k), _t(v), _t(table), _t(LENS_INCL),
                                              k_scales=_t(ks), v_scales=_t(vs), **kw)
    np.testing.assert_allclose(plain1.numpy(), want1, rtol=0, atol=ATOL)
    qw = rng.standard_normal((B, W, HQ, D)).astype(np.float32)
    pos = LENS_WIN[:, None] + np.arange(W, dtype=np.int32)[None]
    wantw = np.asarray(jpg.paged_window_attention(jnp.asarray(qw), jk, jv, jnp.asarray(pos), **kw))
    np.testing.assert_allclose(
        tpg.paged_window_attention(_t(qw), tk, tv, _t(pos), **kw).numpy(), wantw, rtol=0, atol=ATOL)
    plainw = tka.paged_window_attention_plain(_t(qw), _t(k), _t(v), _t(table), _t(LENS_WIN),
                                              k_scales=_t(ks), v_scales=_t(vs), **kw)
    np.testing.assert_allclose(plainw.numpy(), wantw, rtol=0, atol=ATOL)


def test_paged_decode_plain_empty_slot_is_zero():
    """A slot with seq_lens == 0 (never passed by the engine) gives 0."""
    rng = np.random.default_rng(40)
    table, k, v, _, _ = _pool(rng, False)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    lens = np.array([0, 3, 0, 9], np.int32)
    out = tka.paged_decode_attention(_t(q), _t(k), _t(v), _t(table), _t(lens), scale=0.1)
    assert not out[[0, 2]].any() and out[[1, 3]].abs().sum() > 0


# ---------------------------------------------------------------------------
# K4/K5's split over pages and its merge (the CUDA kernels' decomposition)
# ---------------------------------------------------------------------------

# lengths for the split cases: K4's slot 0 is empty; K5's slot 3 runs its
# window of 4 past maxP * PS = 40; with a window of 6 slot 3's first four
# pages lie wholly before it; slots 0 and 1 have pages past their live ones
LENS_SPLIT_INCL = np.array([0, 9, 23, 40], np.int32)
LENS_SPLIT_WIN = np.array([0, 8, 19, 38], np.int32)


def _split_reference(q, k, v, ks, vs, table, base, pps, *, scale, window, softcap):
    """The kernels' split over pages and merge, written out in f32: q
    [B, W, Hq, D], query w of slot b at position base[b] + w. Each slot's
    keys below min(base + W, maxP * PS) and not wholly before the window
    are cut into paged_split's splits of `pps` pages; a split reads only its
    own live rows and gives (m, l, acc) per query row, l and acc relative to
    m; the splits merge in order 0, 1, ...: m* = max m_s, w_s = e^(m_s - m*)
    (0 for an empty split), o = sum w_s acc_s / max(sum w_s l_s, 1e-30)."""
    f32 = np.float32
    B, W, Hq, D = q.shape
    _, ps, Hkv, _ = k.shape
    maxP, grp = table.shape[1], Hq // Hkv
    splits, pps = tka.paged_split(B, Hkv, 1, maxP, ps, pages_per_split=pps)
    heads = np.arange(Hq) // grp
    out = np.zeros(q.shape, f32)
    for b in range(B):
        n_keys = min(int(base[b]) + W, maxP * ps)
        lo = max(int(base[b]) - window + 1, 0) if window else 0
        qpos = base[b] + np.arange(W)
        parts = []
        for s in range(splits):
            k0, k1 = max(s * pps * ps, lo), min((s + 1) * pps * ps, n_keys)
            if k0 >= k1:
                parts.append((np.full((W, Hq), tka.NEG_INF, f32), np.zeros((W, Hq), f32), None))
                continue
            pos = np.arange(k0, k1)
            pages, rows = table[b, pos // ps], pos % ps
            kh = k[pages, rows][:, heads].astype(f32)  # [n, Hq, D]
            vh = v[pages, rows][:, heads].astype(f32)
            sc = np.einsum("whd,nhd->whn", q[b].astype(f32), kh)
            if ks is not None:
                sc = sc * ks[pages, :, rows][:, heads].T[None]
            sc = sc * f32(scale)
            if softcap:
                sc = np.tanh(sc / f32(softcap)) * f32(softcap)
            valid = pos[None, :] <= qpos[:, None]
            if window:
                valid &= pos[None, :] > qpos[:, None] - window
            valid = valid[:, None, :]
            sc = np.where(valid, sc, f32(tka.NEG_INF))
            m = sc.max(-1)
            pr = np.where(valid, np.exp(sc - m[..., None]), f32(0))
            l = pr.sum(-1)
            if vs is not None:
                pr = pr * vs[pages, :, rows][:, heads].T[None]
            parts.append((m, l, np.einsum("whn,nhd->whd", pr, vh)))
        m_star = np.max([m for m, _, _ in parts], axis=0)
        l_star = np.zeros((W, Hq), f32)
        acc = np.zeros((W, Hq, D), f32)
        for m, l, a in parts:
            w = np.where(l > 0, np.exp(m - m_star), f32(0)).astype(f32)
            l_star += w * l
            if a is not None:
                acc += w[..., None] * a
        out[b] = acc / np.maximum(l_star, f32(1e-30))[..., None]
    return out


SPLIT_PPS = {"pps1": 1, "pps2": 2, "all": MAXP}


@pytest.mark.parametrize("pps", list(SPLIT_PPS))
@pytest.mark.parametrize("window,softcap,quant", KERNEL_CASES)
@pytest.mark.parametrize("kernel", ["decode", "window"])
def test_paged_split_reference_matches_pallas(kernel, window, softcap, quant, pps):
    """The split-and-merge reference at one, two and all pages a split,
    against the Pallas kernel in interpret mode; the trash page (NaN) past
    each slot's live pages is never read, an empty K4 slot gives 0."""
    rng = np.random.default_rng(500 + KERNEL_CASES.index((window, softcap, quant)))
    table, k, v, ks, vs = _pool(rng, quant)
    k[P - 1] = v[P - 1] = 127 if quant else np.nan  # an int8 trash page that would show
    kw = dict(scale=0.125, sliding_window=window, logit_softcap=softcap)
    if kernel == "decode":
        q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
        lens, base = LENS_SPLIT_INCL, LENS_SPLIT_INCL - 1
        want = _pallas(jka.paged_decode_attention, q[:, 0], k, v, table, lens, ks, vs, **kw)[:, None]
        plain = tka.paged_decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(table), _t(lens),
                                           k_scales=_t(ks), v_scales=_t(vs), **kw).numpy()[:, None]
    else:
        q = rng.standard_normal((B, W, HQ, D)).astype(np.float32)
        lens = base = LENS_SPLIT_WIN
        want = _pallas(jka.paged_window_attention_kernel, q, k, v, table, lens, ks, vs, **kw)
        plain = tka.paged_window_attention_kernel(_t(q), _t(k), _t(v), _t(table), _t(lens),
                                                  k_scales=_t(ks), v_scales=_t(vs), **kw).numpy()
    got = _split_reference(q, k, v, ks, vs, table, base, SPLIT_PPS[pps], scale=0.125,
                           window=window, softcap=softcap)
    assert np.isfinite(got).all()
    live = lens + (0 if kernel == "decode" else W) > 0  # Pallas leaves an empty slot unwritten
    assert not got[~live].any()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _pallas_cached(fn, q, k, v, table, lens, ks, vs, scale, sliding_window, logit_softcap):
    a = lambda x: None if x is None else jnp.asarray(np.frombuffer(x[0], x[1]).reshape(x[2]))
    return np.asarray(fn(a(q), a(k), a(v), a(table), a(lens), k_scales=a(ks), v_scales=a(vs),
                         scale=scale, sliding_window=sliding_window, logit_softcap=logit_softcap,
                         interpret=True))


def _pallas(fn, q, k, v, table, lens, ks, vs, **kw):
    """The Pallas kernel in interpret mode, once per distinct input (the
    split cases share theirs across page counts)."""
    key = lambda x: None if x is None else (np.ascontiguousarray(x).tobytes(), x.dtype, x.shape)
    return _pallas_cached(fn, key(q), key(k), key(v), key(table), key(lens), key(ks), key(vs),
                          kw["scale"], kw["sliding_window"], kw["logit_softcap"])


SPLIT_SHAPES = [(8, 8, 1, 16, 128), (8, 2, 1, 16, 128), (8, 8, 2, 16, 128), (64, 8, 1, 16, 128),
                (4, 2, 1, 6, 8), (8, 8, 1, 16, 32), (1, 1, 1, 4096, 8), (1, 8, 1, 1, 128),
                (2, 8, 1, 3, 128), (256, 8, 1, 64, 16)]


@pytest.mark.parametrize("B,Hkv,chunks,maxP,ps", SPLIT_SHAPES)
def test_paged_split_policy(B, Hkv, chunks, maxP, ps):
    """paged_split covers maxP with at least one split of at least one page,
    no split wholly past maxP, at most SPLIT_MAX splits of at least
    SPLIT_MIN_KEYS keys (or the whole table); the grid reaches
    SPLIT_TARGET_BLOCKS blocks unless those limits stop it, with the most
    pages a split that do; a forced page count is kept within [1, maxP]."""
    splits, pps = tka.paged_split(B, Hkv, chunks, maxP, ps)
    assert splits >= 1 and pps >= 1
    assert splits * pps >= maxP and (splits - 1) * pps < maxP
    assert splits <= tka.SPLIT_MAX
    assert pps * ps >= min(tka.SPLIT_MIN_KEYS, maxP * ps)
    least = min(maxP, max(-(-tka.SPLIT_MIN_KEYS // ps), -(-maxP // tka.SPLIT_MAX)))
    blocks = B * Hkv * chunks
    assert blocks * splits >= tka.SPLIT_TARGET_BLOCKS or pps == least
    if least < pps < maxP:  # a page more a split would miss the target
        more = tka.paged_split(B, Hkv, chunks, maxP, ps, pages_per_split=pps + 1)[0]
        assert blocks * more < tka.SPLIT_TARGET_BLOCKS
    for forced in (1, 2, maxP, maxP + 5):
        s, p = tka.paged_split(B, Hkv, chunks, maxP, ps, pages_per_split=forced)
        assert p == min(forced, maxP) and s == -(-maxP // p)


def test_kv_quantize_bit_exact_with_ties():
    rng = np.random.default_rng(41)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    # rows whose amax is 127 have scale 1.0 exactly, so x.5 values are ties
    x[0, 0] = np.concatenate([[127.0, -127.0], np.arange(-30.5, 31.5, 1.0)])
    x[0, 1] = 0.0  # amax floor
    x[1, 2, :4] = [254.0, 1.0, 3.0, -5.0]  # scale 2.0: 0.5, 1.5, -2.5 ties
    jq, js = jpg.kv_quantize(jnp.asarray(x))
    tq, ts = tpg.kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


POOLS = ["float32", "bfloat16", "int8"]


def _jax_pool(kind, n_pages=12, ps=8):
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.float32}[kind]
    return jpg.PagedKVCache.create(JCFG, n_pages, ps, dtype,
                                   kv_quant="int8" if kind == "int8" else None)


@pytest.mark.parametrize("kind", POOLS)
def test_scatter_and_gather_match_jax(kind):
    rng = np.random.default_rng(POOLS.index(kind))
    jc = _jax_pool(kind)
    tc = paged_cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    L, Hkv, Dh = CFG.num_full_attn_layers, CFG.num_key_value_heads, CFG.head_dim
    lk = rng.standard_normal((L, 21, Hkv, Dh)).astype(np.float32)  # 21 rows -> 3 pages of 8
    lv = rng.standard_normal((L, 21, Hkv, Dh)).astype(np.float32)
    if kind == "bfloat16":
        lk, lv = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (lk, lv))
    pages = np.array([7, 2, 11, 4, 4], np.int32)  # the 4 past the rows is never written
    jc = jpg.scatter_prefill_kv(JCFG, jc, jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(pages))
    tpg.scatter_prefill_kv(CFG, tc, to_torch(lk, "cpu"), to_torch(lv, "cpu"), _t(pages))
    for name in ("k", "v", "k_scale", "v_scale"):
        ja, ta = getattr(jc, name), getattr(tc, name)
        if ja is None:
            assert ta is None
            continue
        # jitted XLA may divide by 127 as a product with its reciprocal: 1 ulp
        np.testing.assert_allclose(ta.to(torch.float32).numpy(), np.asarray(ja, np.float32),
                                   rtol=1e-7 if name.endswith("scale") else 0, atol=0, err_msg=name)
    page_vec = np.array([7, 2, 11, 11], np.int32)
    for rows in (24, 40):  # inside the pages and padded past them
        jk, jv = jpg.gather_prefix_rows(jc, jnp.asarray(page_vec), rows, out_dtype=jnp.float32)
        tk, tv = tpg.gather_prefix_rows(tc, _t(page_vec), rows, out_dtype=torch.float32)
        assert len(tk) == len(jk)
        for a, b in zip(tk + tv, jk + jv):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.to(torch.float32).numpy(), np.asarray(b, np.float32),
                                       rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# paged_decode_step / paged_verify_step on the tiny W4 model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models():
    params = jd.init_params(JCFG, jax.random.PRNGKey(11), dtype=jnp.float32)
    qp = jd.merge_projections(j_rtn(params, JCFG, hadamard=True, quantize_lm_head=True), JCFG)
    return qp, params_from_jax(jax.tree.map(np.asarray, qp), CFG, device="cpu")


def _filled_pool(quant, rng, n_pages=16, ps=8):
    """A JAX pool with random rows (int8 with scales) and a trash page."""
    jc = jpg.PagedKVCache.create(JCFG, n_pages + 1, ps, jnp.float32,
                                 kv_quant="int8" if quant else None)
    shape = jc.k.shape
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, jc.k_scale.shape).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, jc.v_scale.shape).astype(np.float32)
        return jc._replace(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=jnp.asarray(ks),
                           v_scale=jnp.asarray(vs))
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    return jc._replace(k=jnp.asarray(k), v=jnp.asarray(v))


def _tables(rng, n_pages, maxP, lens, extra):
    """A shuffled table giving each slot the pages its lens + extra rows
    need; the rest of each row points at the trash page (n_pages)."""
    table = np.full((len(lens), maxP), n_pages, np.int32)
    perm = list(rng.permutation(n_pages))
    for b, n in enumerate(lens):
        need = min(-(-(n + extra) // 8), maxP)
        table[b, :need] = [perm.pop() for _ in range(need)]
    return table


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("attn_mode", [None, "einsum"])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_step_matches_jax(quant, attn_mode):
    jp, tp = _models()
    rng = np.random.default_rng(50 + quant)
    jc = _filled_pool(quant, rng)
    tc = paged_cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    lens = np.array([0, 7, 8, 21], np.int32)  # slot 0 idle (trash page), page edges
    table = _tables(rng, 16, 4, lens, 4)
    table[0] = 16
    for step in range(3):  # teacher-forced: each step's row is attended by the next
        toks = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
        jl, jc = jpg.paged_decode_step(jp, JCFG, jnp.asarray(toks), jnp.asarray(lens),
                                       jnp.asarray(table), jc, quant_mode="xla")
        tl, tc = tpg.paged_decode_step(tp, CFG, _t(toks), _t(lens), _t(table), tc,
                                       quant_mode="xla", attn_mode=attn_mode)
        assert _rel(tl[1:].numpy(), np.asarray(jl)[1:]) < ATOL, step
        lens = lens + np.array([0, 1, 1, 1], np.int32)
    # the written rows agree (int8: the same integers but where a rounding tie moved)
    for name in ("k", "v"):
        got, want = getattr(tc, name).to(torch.float32).numpy(), np.asarray(getattr(jc, name), np.float32)
        live = table[1:][table[1:] < 16]
        diff = np.abs(got[:, live] - want[:, live])
        assert diff.max() <= (1 if quant else 1e-5), name


@pytest.mark.parametrize("quant", [False, True])
def test_paged_verify_step_matches_jax(quant):
    jp, tp = _models()
    rng = np.random.default_rng(60 + quant)
    jc = _filled_pool(quant, rng)
    tc = paged_cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    Wv = 5
    lens = np.array([3, 14, 16, 29], np.int32)  # 29 + 5 rows overrun 4 pages: trash
    table = _tables(rng, 16, 4, lens, Wv)
    windows = rng.integers(0, CFG.vocab_size, (4, Wv)).astype(np.int32)
    jt, jl, j0, jc = jpg.paged_verify_step(jp, JCFG, jnp.asarray(windows), jnp.asarray(lens),
                                           jnp.asarray(table), jc, 16, quant_mode="xla")
    tt, tl, t0, tc = tpg.paged_verify_step(tp, CFG, _t(windows), _t(lens), _t(table), tc, 16,
                                           quant_mode="xla")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # int8: jitted XLA's scale can sit 1 ulp from torch's, which can move a
    # rounding tie of a freshly written row by one step, hence 1e-3 there
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-3 if quant else 1e-4)
    assert _rel(t0.numpy(), j0) < ATOL
    # the pool rows of every real page agree after the writes
    for name in ("k", "v"):
        got, want = getattr(tc, name).to(torch.float32).numpy(), np.asarray(getattr(jc, name), np.float32)
        assert np.abs(got[:, :16] - want[:, :16]).max() <= (1 if quant else 1e-5), name


def test_paged_cache_create_and_unsupported():
    c = tpg.PagedKVCache.create(CFG, 5, 8, torch.float32, kv_quant="int8", device="cpu")
    assert c.k.dtype == torch.int8 and c.k.shape == (2, 5, 8, 2, 64)
    assert c.k_scale.shape == (2, 5, 2, 8) and c.quantized and c.page_size == 8
    with pytest.raises(ValueError):
        tpg.PagedKVCache.create(CFG, 5, 8, kv_quant="fp8", device="cpu")
    jp, tp = _models()
    with pytest.raises(NotImplementedError, match="§A 7"):
        tpg.paged_decode_step(tp, CFG, torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros((1, 1), dtype=torch.int32), c, attn_mesh=object())
