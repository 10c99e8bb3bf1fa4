"""The Gemma3 VLM in the port (models/vision.py and the decoder's image
path) against the JAX package and transformers, on the CPU.

Model: tests/test_vlm.py's tiny HF_CFG (a 2-layer Gemma3 LM of width 64, one
sliding and one full layer; a 2-layer SigLIP tower of width 32 over 28 x 28
images in 7 x 7 patches, pooled to 4 soft tokens), its weights from a seeded
transformers Gemma3ForConditionalGeneration through test_vlm.py's own
mapping to JAX's params, and from those to the port (`params_from_jax`).

Checked: patchify, layer_norm, siglip_encode and gemma3_project within
FN_TOL of max |value| of JAX's; merge_image_embeddings and image_group_ids
exactly, at B 2 with two images in one prompt and with image runs shorter
and longer than mm_tokens_per_image; the bidirectional mask of
attention_kvmajor; vlm_prefill with and without a cache, f32, within FN_TOL
of max |logit| of JAX's and within JAX's 3e-4 of transformers'; bf16
weights with f32 pixels within BF16_TOL of JAX's; an RTN W4 LM under "xla"
within FN_TOL; the flash gate taking the einsum under image groups and a
callable attn_mode raising; gemma3n's input_embeds against JAX's; an
HF-named directory (safetensors.numpy) loaded by both packages to logits
within FN_TOL; and chip_smoke.py's Gemma 3 4B config against the one
transformers completes from it.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from paroquant_tpu.models import PRESETS as J_PRESETS
from paroquant_tpu.models import decoder as jd
from paroquant_tpu.models import gemma3n as jg
from paroquant_tpu.models import vision as jv
from paroquant_tpu_torch.convert.interop import params_from_jax
from paroquant_tpu_torch.models import PRESETS, KVCache, from_hf_dict
from paroquant_tpu_torch.models import decoder as td
from paroquant_tpu_torch.models import gemma3n as tg
from paroquant_tpu_torch.models import vision as tv
from test_vlm import HF_CFG, IMAGE_TOKEN, hf_and_ours  # noqa: F401 (a module fixture)

FN_TOL = 1e-5  # of the reference's max |value|, f32
HF_TOL = 3e-4  # JAX's own bound against transformers (tests/test_vlm.py)
BF16_TOL = 3e-2  # bf16 weights, f32 pixels: XLA keeps f32 inside fused bf16 chains
j_prefill = jax.jit(jv.vlm_prefill, static_argnames=("config", "quant_mode"))
j_forward = jax.jit(jd.model_forward, static_argnames=("config", "quant_mode", "attn_mode"))


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(t.detach().float().numpy() - j).max() / max(np.abs(j).max(), 1e-30))


def perturbed_projector(hf, jparams):
    """transformers initialises the projector's weight and norm to zeros, so
    that every image maps to the same soft tokens: give both random values
    (in place, in the transformers model and in JAX's params)."""
    proj = hf.model.multi_modal_projector
    with torch.no_grad():
        proj.mm_input_projection_weight.normal_(0.0, 0.2)
        proj.mm_soft_emb_norm.weight.normal_(0.0, 0.1)
    jparams["projector"] = {
        "mm_input_projection": jnp.asarray(proj.mm_input_projection_weight.detach().numpy()),
        "mm_soft_emb_norm": jnp.asarray(proj.mm_soft_emb_norm.weight.detach().numpy()),
    }


@pytest.fixture(scope="module")
def model(hf_and_ours):
    hf, jparams, jcfg = hf_and_ours
    torch.manual_seed(1)
    perturbed_projector(hf, jparams)
    cfg = from_hf_dict(HF_CFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return hf, jparams, jcfg, tparams, cfg


def _prompt(seed, T=14, runs=((0, 3, 7),), B=1):
    """Random text tokens [B, T] with image runs (row, start, end)."""
    toks = np.random.default_rng(seed).integers(0, 240, (B, T)).astype(np.int32)
    for b, s, e in runs:
        toks[b, s:e] = IMAGE_TOKEN
    return toks


def _pixels(seed, n=1):
    return np.random.default_rng(seed).standard_normal((n, 3, 28, 28)).astype(np.float32)


def test_patchify_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    got = tv.patchify(torch.from_numpy(px), 7)
    want = np.asarray(jv.patchify(jnp.asarray(px), 7))
    assert got.shape == (2, 16, 147) and np.array_equal(got.numpy(), want)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 32), (32,), (32,)))
    assert _rel(tv.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6),
                jv.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-6)) < FN_TOL
    # bf16 in, bf16 out (f32 inside)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tv.layer_norm(xb, *map(torch.from_numpy, (w, b)), 1e-6).dtype == torch.bfloat16


def test_siglip_encode_and_projector_match_jax(model):
    hf, jp, jcfg, tp, cfg = model
    vcfg = tv.VisionConfig.from_hf_dict(cfg.vision)
    assert vars(vcfg) == vars(jv.VisionConfig.from_hf_dict(jcfg.vision))
    assert vcfg.num_patches == 16
    px = _pixels(0, 2)
    got = tv.siglip_encode(tp["vision"], vcfg, torch.from_numpy(px))
    want = jv.siglip_encode(jp["vision"], vcfg, jnp.asarray(px))
    assert got.shape == (2, 16, 32) and _rel(got, want) < FN_TOL
    with torch.no_grad():
        hf_feats = hf.model.vision_tower(torch.from_numpy(px)).last_hidden_state.numpy()
    assert _rel(got, hf_feats) < HF_TOL
    pg = tv.gemma3_project(tp["projector"], got, vcfg, 4, rms_eps=1e-6)
    pj = jv.gemma3_project(jp["projector"], want, vcfg, 4, rms_eps=1e-6)
    assert pg.shape == (2, 4, 64) and _rel(pg, pj) < FN_TOL


MERGE_CASES = {
    # (B, T, image runs as (row, start, end), images given)
    "two_images_one_prompt": (2, 16, ((0, 2, 6), (0, 9, 13), (1, 4, 8)), 3),
    "run_shorter": (2, 12, ((0, 3, 5), (1, 1, 5)), 2),
    "run_longer": (2, 12, ((0, 2, 8), (1, 0, 4)), 2),
}


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_and_group_ids_match_jax(case):
    B, T, runs, n_img = MERGE_CASES[case]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 240, (B, T)).astype(np.int32)
    for b, s, e in runs:
        toks[b, s:e] = IMAGE_TOKEN
    text = rng.standard_normal((B, T, 8)).astype(np.float32)
    imgs = rng.standard_normal((n_img, 4, 8)).astype(np.float32)
    mask = toks == IMAGE_TOKEN
    got = tv.merge_image_embeddings(torch.from_numpy(text), torch.from_numpy(imgs),
                                    torch.from_numpy(mask))
    want = jv.merge_image_embeddings(jnp.asarray(text), jnp.asarray(imgs), jnp.asarray(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))
    gid = tv.image_group_ids(torch.from_numpy(mask))
    assert gid.dtype == torch.int32
    assert np.array_equal(gid.numpy(), np.asarray(jv.image_group_ids(jnp.asarray(mask))))


def test_bidir_attention_mask_matches_jax():
    """attention_kvmajor with image groups, over a partly filled buffer
    (queries at positions 4-11 of 16 rows, 12 valid) and a sliding window."""
    rng = np.random.default_rng(4)
    B, T, Hq, Hkv, D, S = 2, 8, 4, 2, 16, 16
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(4 + np.arange(T, dtype=np.int32), (B, T)).copy()
    qg = np.full((B, T), -1, np.int32)
    qg[0, 1:5], qg[1, 0:3], qg[1, 5:8] = 0, 0, 1
    kg = np.full((B, S), -1, np.int32)
    kg[:, 4:12] = qg
    valid = np.int32(12)
    for window in (None, 3):
        got = td.attention_kvmajor(
            *map(torch.from_numpy, (q, k, v, pos)), torch.tensor(valid), scale=0.25,
            sliding_window=window, bidir_groups=(torch.from_numpy(qg), torch.from_numpy(kg)))
        want = jd.attention_kvmajor(
            *map(jnp.asarray, (q, k, v, pos)), jnp.asarray(valid), scale=0.25,
            sliding_window=window, bidir_groups=(jnp.asarray(qg), jnp.asarray(kg)))
        assert _rel(got, want) < FN_TOL
        plain = td.attention_kvmajor(*map(torch.from_numpy, (q, k, v, pos)), torch.tensor(valid),
                                     scale=0.25, sliding_window=window)
        assert _rel(plain, want) > 1e-3  # the groups change the result


@pytest.mark.parametrize("cached", (False, True))
def test_vlm_prefill_matches_jax(model, cached):
    """Two prompts (B 2), three images: one row holds two runs."""
    _, jp, jcfg, tp, cfg = model
    toks = _prompt(1, T=18, runs=((0, 2, 6), (0, 9, 13), (1, 5, 9)), B=2)
    px = _pixels(1, 3)
    jc = tc = None
    if cached:
        from paroquant_tpu.models import KVCache as JKVCache

        jc = JKVCache.create(jcfg, 2, 32, jnp.float32)
        tc = KVCache.create(cfg, 2, 32, torch.float32, "cpu")
    want, jc = j_prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(px), jc)
    got, tc = tv.vlm_prefill(tp, cfg, torch.from_numpy(toks), torch.from_numpy(px), tc)
    assert got.shape == (2, 18, 256) and got.dtype == torch.float32
    assert _rel(got, want) < FN_TOL
    if cached:
        assert int(tc.length) == 18 and _rel(tc.k[1], jc.k[1]) < FN_TOL
        # a decode step through the ordinary text path reads the image rows
        nxt = np.array([[7], [9]], np.int32)
        wd, _ = j_forward(jp, jcfg, jnp.asarray(nxt), jc)
        gd, _ = td.model_forward(tp, cfg, torch.from_numpy(nxt), tc)
        assert _rel(gd, wd) < FN_TOL
    step_logits, _ = tv.vlm_prefill_step(tp, cfg, torch.from_numpy(toks), torch.from_numpy(px),
                                         None)
    assert torch.equal(step_logits, got[:, -1])


def test_vlm_prefill_matches_hf(model):
    hf, _, _, tp, cfg = model
    toks = _prompt(2)
    px = _pixels(2)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(toks).long(), pixel_values=torch.from_numpy(px),
                  token_type_ids=torch.from_numpy((toks == IMAGE_TOKEN).astype(np.int64))
                  ).logits.float().numpy()
    got, _ = tv.vlm_prefill(tp, cfg, torch.from_numpy(toks), torch.from_numpy(px))
    assert _rel(got, want) < HF_TOL
    # the image reaches the LM: another image moves the logits after it
    other, _ = tv.vlm_prefill(tp, cfg, torch.from_numpy(toks), torch.from_numpy(_pixels(3)))
    assert _rel(other[:, 3:], want[:, 3:]) > 100 * HF_TOL


def test_vlm_bf16_weights_f32_pixels_match_jax(model):
    """bf16 weights (the tower's biases stay f32, as the loaders keep them)
    with f32 pixels: an f32 tower, a bf16 LM, as in JAX."""
    _, jp, jcfg, _, cfg = model

    def bf16(path, a):
        keep = any(getattr(p, "key", getattr(p, "name", None)) == "b" for p in path) or \
            any(getattr(p, "key", None) == "patch_embed_b" for p in path)
        return a if keep else a.astype(jnp.bfloat16)

    jb = jax.tree_util.tree_map_with_path(bf16, jp)
    tb = params_from_jax(jax.tree.map(np.asarray, jb), cfg, "cpu")
    assert tb["vision"]["layers"][0]["fc1"].w.dtype == torch.bfloat16
    assert tb["vision"]["layers"][0]["fc1"].b.dtype == torch.float32
    toks, px = _prompt(4), _pixels(4)
    want, _ = j_prefill(jb, jcfg, jnp.asarray(toks), jnp.asarray(px))
    got, _ = tv.vlm_prefill(tb, cfg, torch.from_numpy(toks), torch.from_numpy(px))
    assert _rel(got, want) < BF16_TOL
    vcfg = tv.VisionConfig.from_hf_dict(cfg.vision)
    feats = tv.siglip_encode(tb["vision"], vcfg, torch.from_numpy(px))
    assert feats.dtype == torch.float32  # the tower runs in the pixels' dtype
    assert _rel(feats, jv.siglip_encode(jb["vision"], vcfg, jnp.asarray(px))) < FN_TOL


def test_vlm_rtn_w4_lm_matches_jax(model):
    """The LM's linears RTN W4 g32 (JAX's quantize_model_rtn), the tower
    dense; quant_mode "xla" in both packages."""
    from paroquant_tpu.convert.rtn import quantize_model_rtn

    _, jp, jcfg, _, cfg = model
    jq = quantize_model_rtn(jp, jcfg, group_size=32)
    assert type(jq["layers"][0]["q_proj"]).__name__ == "QuantizedLinear"
    assert type(jq["vision"]["layers"][0]["fc1"]).__name__ == "DenseLinear"
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    toks, px = _prompt(5), _pixels(5)
    want, _ = j_prefill(jq, jcfg, jnp.asarray(toks), jnp.asarray(px), quant_mode="xla")
    got, _ = tv.vlm_prefill(tq, cfg, torch.from_numpy(toks), torch.from_numpy(px),
                            quant_mode="xla")
    assert _rel(got, want) < FN_TOL


def test_flash_gate_and_callable_attn_mode_under_groups(model):
    """With image groups, attn_mode "flash" takes the einsum attention (a
    128-token prompt would otherwise meet the flash gate) and a callable
    attn_mode raises JAX's NotImplementedError."""
    _, _, _, tp, cfg = model
    toks = _prompt(6, T=128, runs=((0, 10, 14), (0, 60, 64)))
    px = torch.from_numpy(_pixels(6, 2))
    vcfg = tv.VisionConfig.from_hf_dict(cfg.vision)
    img = tv.gemma3_project(tp["projector"], tv.siglip_encode(tp["vision"], vcfg, px), vcfg, 4,
                            1e-6)
    t = torch.from_numpy(toks)
    mask = t == IMAGE_TOKEN
    x = tv.merge_image_embeddings(td.embed(tp, cfg, torch.where(mask, 0, t)), img, mask)
    groups = tv.image_group_ids(mask)
    ein, _ = td.model_forward(tp, cfg, t, input_embeds=x, bidir_groups=groups)
    flash, _ = td.model_forward(tp, cfg, t, input_embeds=x, bidir_groups=groups,
                                attn_mode="flash")
    assert torch.equal(ein, flash)
    with pytest.raises(NotImplementedError, match="bidir"):
        td.model_forward(tp, cfg, t, input_embeds=x, bidir_groups=groups,
                         attn_mode=lambda *a, **k: None)


def test_gemma3n_input_embeds_matches_jax():
    """gemma3n_forward with input_embeds = the scaled embedding gives the
    token path's logits, in both packages alike (tiny-gemma3n, f32)."""
    jcfg, cfg = J_PRESETS["tiny-gemma3n"], PRESETS["tiny-gemma3n"]
    jp = jax.jit(jd.init_params, static_argnames=("config", "dtype"))(
        jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    t = torch.from_numpy(toks)
    emb = tg.embed_gemma3n(tp, cfg, t)
    want, _ = jax.jit(jg.gemma3n_forward, static_argnames=("config",))(
        jp, jcfg, jnp.asarray(toks), input_embeds=jnp.asarray(emb.numpy()))
    got, _ = tg.gemma3n_forward(tp, cfg, t, input_embeds=emb)
    via, _ = td.model_forward(tp, cfg, t, input_embeds=emb)
    plain, _ = td.model_forward(tp, cfg, t)
    assert _rel(got, want) < FN_TOL
    assert torch.equal(via, got) and torch.equal(plain, got)


def test_vlm_checkpoint_loads_in_both_packages(model, tmp_path):
    """transformers' state dict written with safetensors.numpy beside the
    nested config.json: both loaders give the tower and projector, and
    vlm_prefill's logits agree within FN_TOL (f32)."""
    from safetensors.numpy import save_file

    from paroquant_tpu.convert import load_checkpoint as j_load
    from paroquant_tpu_torch.convert import load_checkpoint

    hf, _, _, _, _ = model
    d = tmp_path / "vlm"
    d.mkdir()
    save_file({k: np.ascontiguousarray(v.float().numpy()) for k, v in hf.state_dict().items()},
              str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(HF_CFG))
    jl, jcfg2 = j_load(d, dtype=jnp.float32)
    tl, cfg2 = load_checkpoint(d, dtype=torch.float32, device="cpu")
    assert cfg2.is_vlm and set(tl) == set(jl) >= {"vision", "projector"}
    assert len(tl["vision"]["layers"]) == 2
    assert tl["vision"]["patch_embed_w"].shape == (147, 32)
    assert tl["vision"]["layers"][0]["q_proj"].b.dtype == torch.float32
    toks, px = _prompt(8, T=12, runs=((0, 2, 6),)), _pixels(8)
    want, _ = j_prefill(jl, jcfg2, jnp.asarray(toks), jnp.asarray(px))
    got, _ = tv.vlm_prefill(tl, cfg2, torch.from_numpy(toks), torch.from_numpy(px))
    assert _rel(got, want) < FN_TOL


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_gemma3_4b_config_matches_transformers():
    """chip_smoke.py's Gemma 3 4B dict writes every width out: the config
    that transformers' Gemma3Config completes from it (its own defaults for
    whatever the dict leaves out) parses to the same LM and tower in both
    packages; the widths are Gemma 3 4B's."""
    from paroquant_tpu.models import from_hf_dict as j_from_hf_dict
    from transformers.models.gemma3 import Gemma3Config

    cs = _chip_smoke()
    ours = cs.vlm_config(34)
    full = Gemma3Config(**cs.GEMMA3_4B).to_dict()
    ref = from_hf_dict(full)
    assert dataclasses.replace(ours, vision_items=None) == dataclasses.replace(ref,
                                                                              vision_items=None)
    vc = tv.VisionConfig.from_hf_dict(ours.vision)
    assert vc == tv.VisionConfig.from_hf_dict(ref.vision)
    assert vars(vc) == vars(jv.VisionConfig.from_hf_dict(j_from_hf_dict(cs.GEMMA3_4B).vision))
    assert (ours.hidden_size, ours.intermediate_size, ours.vocab_size) == (2560, 10240, 262208)
    assert [i for i in range(34) if ours.layer_sliding_window(i) is None] == [5, 11, 17, 23, 29]
    assert ours.layer_sliding_window(0) == 1024 and ours.attn_scale == 256 ** -0.5
    assert (ours.mm_tokens_per_image, ours.image_token_id, vc.num_patches) == (256, 262144, 4096)
    D, F = vc.hidden_size, vc.intermediate_size
    assert round(vc.num_hidden_layers * (4 * D * D + 2 * D * F) / 1e6, 1) == 411.1
