"""SigLIP vision tower and Gemma3 multimodal projector (the VLM path) in torch.

Counterpart of `paroquant_tpu/models/vision.py`, function for function: a
bidirectional pre-LN ViT (SigLIP) whose patch embedding is one
[P, C*p*p] x [C*p*p, D] matmul (a stride-p convolution with a p x p
kernel is a patch flatten and a matmul), then the Gemma3 projector (the
patch grid average-pooled to mm_tokens_per_image soft tokens, a
zero-centred RMSNorm, a linear map into the LM's embedding space), the
merge of those soft tokens into the prompt's embeddings at its image-token
runs, and the decoder with each run's tokens attending to each other both
ways (`bidir_groups`).

The casts are JAX's: the tower runs in the pixels' dtype (`apply_linear`
casts each weight to x's dtype, so f32 pixels run an f32 tower on bf16
weights); the patch embedding, the layer norms, the attention, the GELU and
the projector compute in f32; the projector's output takes the tower's
dtype and the text's only in the merge. No kernel of the port runs here:
the tower's linears are dense matmuls, its attention an f32 einsum, and
the VLM prefill takes the decoder's einsum attention (the flash gate
refuses bidirectional groups, as JAX's does).

Param layout (the JAX package's, after the HF module tree):
  vision: {patch_embed_w [C*p*p, D], patch_embed_b [D], pos_embed [P, D],
           layers: [{ln1_w, ln1_b, q/k/v/out_proj (DenseLinear, bias),
                     ln2_w, ln2_b, fc1, fc2}],
           post_ln_w, post_ln_b}
  projector: {mm_input_projection [Dv, Dt], mm_soft_emb_norm [Dv]}
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @classmethod
    def from_hf_dict(cls, d: dict[str, Any]) -> "VisionConfig":
        return cls(**{
            k: d[k] for k in (
                "hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "image_size", "patch_size",
                "num_channels", "layer_norm_eps",
            ) if k in d
        })


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    return (xn * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, nH*nW, C*p*p], channel-major within a patch, then
    the p x p window: the order of a flattened nn.Conv2d weight [D, C, p, p]."""
    B, C, H, W = pixel_values.shape
    nH, nW = H // patch, W // patch
    x = pixel_values.reshape(B, C, nH, patch, nW, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, nH, nW, C, p, p]
    return x.reshape(B, nH * nW, C * patch * patch)


def _vit_attention(p: dict[str, Any], x: torch.Tensor, n_heads: int) -> torch.Tensor:
    from .decoder import apply_linear

    B, T, D = x.shape
    hd = D // n_heads
    q = apply_linear(p["q_proj"], x).reshape(B, T, n_heads, hd)
    k = apply_linear(p["k_proj"], x).reshape(B, T, n_heads, hd)
    v = apply_linear(p["v_proj"], x).reshape(B, T, n_heads, hd)
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32), k.to(torch.float32)) * (hd ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(torch.float32)).reshape(B, T, D).to(x.dtype)
    return apply_linear(p["out_proj"], out)


def siglip_encode(params: dict[str, Any], cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values [B, C, H, W] -> patch features [B, num_patches, D]."""
    from .decoder import apply_linear

    patches = patchify(pixel_values, cfg.patch_size)
    x = (patches.to(torch.float32) @ params["patch_embed_w"].to(torch.float32)
         + params["patch_embed_b"].to(torch.float32)).to(pixel_values.dtype)
    x = x + params["pos_embed"].to(x.dtype)[None]
    eps = cfg.layer_norm_eps
    for lp in params["layers"]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps)
        x = x + _vit_attention(lp, h, cfg.num_attention_heads)
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], eps)
        h = apply_linear(lp["fc1"], h)
        h = torch.nn.functional.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
        x = x + apply_linear(lp["fc2"], h)
    return layer_norm(x, params["post_ln_w"], params["post_ln_b"], eps)


def gemma3_project(proj: dict[str, Any], vision_out: torch.Tensor, cfg: VisionConfig,
                   mm_tokens_per_image: int, rms_eps: float) -> torch.Tensor:
    """Average-pool the patch grid [B, P, Dv] to mm_tokens_per_image soft
    tokens, then the zero-centred RMSNorm (1 + w) and the projection, in f32
    (HF Gemma3MultiModalProjector); the result in vision_out's dtype."""
    B, P, Dv = vision_out.shape
    pps = cfg.patches_per_side
    tps = int(mm_tokens_per_image ** 0.5)
    kernel = pps // tps
    grid = vision_out.reshape(B, pps, pps, Dv).to(torch.float32)
    pooled = grid.reshape(B, tps, kernel, tps, kernel, Dv).mean(dim=(2, 4))
    pooled = pooled.reshape(B, tps * tps, Dv)
    var = torch.mean(pooled * pooled, dim=-1, keepdim=True)
    normed = pooled * torch.rsqrt(var + rms_eps)
    normed = normed * (1.0 + proj["mm_soft_emb_norm"].to(torch.float32))
    return (normed @ proj["mm_input_projection"].to(torch.float32)).to(vision_out.dtype)


def merge_image_embeddings(text_embeds: torch.Tensor, image_embeds: torch.Tensor,
                           image_token_mask: torch.Tensor) -> torch.Tensor:
    """Put the soft image tokens [N_img, mm_tokens, H] (flattened over the
    batch) at the image-token positions of text_embeds [B, T, H], row-major
    over the batch, as HF's masked_scatter. A cumsum-gather with JAX's clip:
    a run longer than the soft tokens repeats the last row, a shorter one
    takes the first rows."""
    B, T, H = text_embeds.shape
    flat = text_embeds.reshape(B * T, H)
    mask = image_token_mask.reshape(B * T)
    src = image_embeds.reshape(-1, H)
    order = torch.cumsum(mask.to(torch.int64), dim=0) - 1  # row of src per position
    gathered = src[order.clamp(0, src.shape[0] - 1)]
    out = torch.where(mask[:, None], gathered.to(flat.dtype), flat)
    return out.reshape(B, T, H)


def image_group_ids(image_token_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool -> the id of each position's run of image tokens (0, 1, ..
    along each row; -1 for text): HF's token_type_ids grouping for
    bidirectional image attention."""
    m = image_token_mask.to(torch.int32)
    prev = torch.nn.functional.pad(m, (1, 0))[:, :-1]
    starts = (m == 1) & (prev == 0)
    gid = torch.cumsum(starts.to(torch.int32), dim=1, dtype=torch.int32) - 1
    return torch.where(image_token_mask, gid, torch.full_like(gid, -1))


def vlm_prefill(params: dict[str, Any], config, tokens: torch.Tensor, pixel_values: torch.Tensor,
                cache=None, *, quant_mode: str = "xla"):
    """Image-text prefill (HF Gemma3Model.forward): encode the images
    [N_img, C, H, W], project them to soft tokens, put those at the prompt's
    image_token_id runs (tokens [B, T]) and run the decoder with each run
    attending to itself both ways. Returns (logits [B, T, V] f32, cache);
    later decode steps take the cache through the ordinary text path."""
    from .decoder import embed, model_forward

    vcfg = VisionConfig.from_hf_dict(config.vision)
    feats = siglip_encode(params["vision"], vcfg, pixel_values)
    img_embeds = gemma3_project(params["projector"], feats, vcfg, config.mm_tokens_per_image,
                                rms_eps=vcfg.layer_norm_eps)  # [N_img, mm_tokens, H]
    mask = tokens == config.image_token_id
    # the text rows scaled by sqrt(H) in the embedding's dtype; the image rows not
    x = embed(params, config, torch.where(mask, torch.zeros_like(tokens), tokens))
    merged = merge_image_embeddings(x, img_embeds, mask)
    return model_forward(params, config, tokens, cache, quant_mode=quant_mode,
                         input_embeds=merged, bidir_groups=image_group_ids(mask))


@torch.no_grad()
def vlm_prefill_step(params, config, tokens, pixel_values, cache, *, quant_mode: str = "xla"):
    """(last-token logits [B, V], cache): the VLM twin of decoder.prefill for
    the serving paths."""
    logits, cache = vlm_prefill(params, config, tokens, pixel_values, cache, quant_mode=quant_mode)
    return logits[:, -1, :], cache

