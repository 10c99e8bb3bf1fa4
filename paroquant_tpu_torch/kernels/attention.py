"""Flash prefill attention: CUDA kernel (csrc/flash_attention.cu) and its plain version.

Port of `paroquant_tpu/kernels/attention.py::flash_attention` (K3). Layouts
follow the JAX function: q [B, Hq, T, D], head-major k/v [B, Hkv, S, D],
kv_lens [B] int32, q_offset scalar or [B] int32 (absolute position of
q[:, :, 0]). Causal by absolute position, masked to k_pos < kv_lens[b],
optional sliding window and tanh softcap, GQA h -> h // (Hq // Hkv), f32
softmax and f32 PV product, output in q.dtype. A query row with no valid key
gives 0, as the TPU kernel's does.

CUDA tensors launch the kernel; CPU tensors run the plain version. Each
CUDA call adds one to `launch_counts["flash_attention"]`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

NEG_INF = -1e30

launch_counts = {"flash_attention": 0}


def reset_launch_counts() -> None:
    launch_counts["flash_attention"] = 0


def _per_batch(v, B: int, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.tensor(v)
    return t.to(device=device, dtype=torch.int32).reshape(-1).expand(B).contiguous()


def flash_attention_plain(
    q, k, v, kv_lens, *, scale: float, q_offset=0, sliding_window: int | None = None,
    logit_softcap: float | None = None, causal: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: the same masked softmax in f32, all keys at once."""
    B, Hq, T, D = q.shape
    Hkv, S_ = k.shape[1], k.shape[2]
    grp = Hq // Hkv
    lens = _per_batch(kv_lens, B, q.device)
    qoff = _per_batch(q_offset, B, q.device)
    qf = q.to(torch.float32).reshape(B, Hkv, grp, T, D)
    scores = torch.einsum("bhgtd,bhsd->bhgts", qf, k.to(torch.float32)) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    q_pos = (qoff[:, None] + torch.arange(T, device=q.device)[None, :])[:, :, None]  # [B, T, 1]
    k_pos = torch.arange(S_, device=q.device)[None, None, :]
    valid = k_pos < lens[:, None, None]
    if causal:
        valid = valid & (k_pos <= q_pos)
    if sliding_window is not None:
        valid = valid & (k_pos > q_pos - sliding_window)
    valid = valid[:, None, None]  # [B, 1, 1, T, S]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l_sum = probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.to(torch.float32))
    out = out / torch.clamp(l_sum, min=1e-30)
    return out.reshape(B, Hq, T, D).to(q.dtype)


_fn = None


def _lib_fn():
    global _fn
    if _fn is None:
        fn = load("flash_attention").paro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(
    q, k, v, kv_lens, *, scale: float, q_offset=0, sliding_window: int | None = None,
    logit_softcap: float | None = None, causal: bool = True,
) -> torch.Tensor:
    """K3: q [B, Hq, T, D], k/v [B, Hkv, S, D] -> [B, Hq, T, D] in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, kv_lens, scale=scale, q_offset=q_offset,
            sliding_window=sliding_window, logit_softcap=logit_softcap, causal=causal,
        )
    B, Hq, T, D = q.shape
    Hkv, S_ = k.shape[1], k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"CUDA flash_attention supports head_dim 64 or 128, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share dtype float32 or bfloat16: {q.dtype} {k.dtype} {v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on the same device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = _per_batch(kv_lens, B, dev)
    qoff = _per_batch(q_offset, B, dev)
    out = torch.empty_like(q)
    err = _lib_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lens.data_ptr(),
        qoff.data_ptr(), int(q.dtype == torch.bfloat16), B, Hq, Hkv, T, S_, D,
        float(scale), float(logit_softcap or 0.0), int(sliding_window or 0), int(causal),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {err}")
    launch_counts["flash_attention"] += 1
    return out
