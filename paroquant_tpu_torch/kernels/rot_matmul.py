"""Rotated W4 matmul: CUDA kernels (csrc/rot_w4_matmul.cu) and their plain versions.

Port of `paroquant_tpu/kernels/rot_matmul.py::rot_w4_matmul` (K1) and
`::merged_rot_w4_matmul` (K2), each with the int8-activation branch (`a8`):

    xr_g = bf16(x_g @ M_g^T)
    out  = sum_g (xr_g @ q_g - rowsum(xr_g) * z_g) * s_g              (W4A16)
    out  = sum_g (xq_g @ q_g - rowsum(xq_g) * z_g) * s_g * sx_g       (a8)

A wrapper launches the CUDA kernel for tensors on a CUDA device and runs the
plain PyTorch version for tensors on the CPU (the counterpart of the Pallas
interpreter). A failed build or launch raises; nothing falls back. Each
CUDA call adds one to `launch_counts[name]`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

MAX_S = 512  # the CUDA kernel takes group sizes 128, 256, 384 and 512
MAX_PARTS = 4
ROWS_PER_TILE = 8
COLS_PER_TILE = 128

launch_counts = {"rot_w4_matmul": 0, "merged_rot_w4_matmul": 0}
# per-variant split of the counts above (W4A16 vs a8)
variant_counts = {"rot_w4_matmul": [0, 0], "merged_rot_w4_matmul": [0, 0]}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
        variant_counts[name] = [0, 0]


# ---------------------------------------------------------------------------
# Plain versions (same decomposition as the kernel)
# ---------------------------------------------------------------------------


def _unpack_groups(qweight: torch.Tensor, G: int, S: int) -> torch.Tensor:
    """uint8 [I//2, O] -> float32 [G, S, O] nibble values (channel k, then k+S/2)."""
    p = qweight.reshape(G, S // 2, -1).to(torch.int32)
    return torch.cat([p & 0xF, p >> 4], dim=1).to(torch.float32)


def _rot_w4_plain_part(x, rot, q, scales, zeros, a8):
    """One partition: x [M, I]; rot [G, S, S]; q [G, S, O] f32; scales/zeros [G, O]."""
    M = x.shape[0]
    G, S, _ = rot.shape
    xg = x.to(rot.dtype).to(torch.float32).reshape(M, G, S)
    xr = torch.einsum("mgj,gij->mgi", xg, rot.to(torch.float32))  # [M, G, S] f32
    s = scales.to(torch.float32)
    z = zeros.to(torch.float32)
    if a8:
        amax = xr.abs().amax(dim=-1, keepdim=True)
        sx = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        xq = torch.round(xr / sx)
        acc = torch.einsum("mgk,gko->mgo", xq, q)  # integer-valued, exact in f32
        contrib = (acc - xq.sum(-1, keepdim=True) * z) * s * sx
    else:
        xb = xr.to(torch.bfloat16).to(torch.float32)
        acc = torch.einsum("mgk,gko->mgo", xb, q)
        contrib = (acc - xb.sum(-1, keepdim=True) * z) * s
    return contrib.sum(dim=1)


def rot_w4_matmul_plain(x, rot, qweight, scales, zeros, *, a8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1: [M, I] -> [M, O] in x.dtype."""
    G, S, _ = rot.shape
    q = _unpack_groups(qweight, G, S)
    return _rot_w4_plain_part(x, rot, q, scales, zeros, a8).to(x.dtype)


def merged_rot_w4_matmul_plain(
    x, rot, qweight, scales, zeros, *, out_splits: tuple, a8: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of K2: partition p rotates x with rot[p] and
    feeds its out_splits[p] columns."""
    P, G, S, _ = rot.shape
    q = _unpack_groups(qweight, G, S)
    outs, off = [], 0
    for p, n in enumerate(out_splits):
        sl = slice(off, off + n)
        outs.append(_rot_w4_plain_part(x, rot[p], q[:, :, sl], scales[:, sl], zeros[:, sl], a8))
        off += n
    return torch.cat(outs, dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_fn = None


def _lib_fn():
    global _fn
    if _fn is None:
        fn = load("rot_w4_matmul").paro_rot_w4_matmul
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _group_splits(n_col_tiles: int, n_row_tiles: int, G: int, device) -> int:
    """Split the groups across blocks only when the column tiles cannot fill
    the SMs twice over; returns KS with every split non-empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-2 * sms // (n_col_tiles * n_row_tiles)))
    ks = min(G, want)
    gps = -(-G // ks)
    return -(-G // gps)


def _launch(name, x, rot, qweight, scales, zeros, out_splits, a8):
    M, I = x.shape
    P, G, S, _ = rot.shape
    O = qweight.shape[1]
    dev = x.device
    if I != G * S:
        raise ValueError(f"rot {tuple(rot.shape)} does not cover x {tuple(x.shape)}")
    if S % 128 or S > MAX_S:
        # the TPU kernel also takes one group narrower than 128 and groups
        # wider than 512; the CUDA kernel does not yet (ROADMAP, section B 1)
        raise NotImplementedError(
            f"the CUDA kernel takes group sizes 128 to {MAX_S} in steps of 128, not {S}")
    if P > MAX_PARTS or sum(out_splits) != O or any(n % 4 for n in out_splits):
        raise ValueError(f"out_splits {out_splits} must sum to {O}, be multiples of 4, at most {MAX_PARTS}")
    if x.dtype not in (torch.float32, torch.bfloat16) or rot.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x {x.dtype} and rot {rot.dtype} must be float32 or bfloat16")
    if qweight.dtype != torch.uint8 or qweight.shape[0] * 2 != I:
        raise TypeError(f"qweight must be uint8 [I/2, O], got {qweight.dtype} {tuple(qweight.shape)}")
    if scales.dtype != torch.bfloat16 or zeros.dtype != torch.bfloat16:
        raise TypeError("scales and zeros must be bfloat16")
    tensors = (x, rot, qweight, scales, zeros)
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on the same device")
    x, rot, qweight, scales, zeros = (t.contiguous() for t in tensors)
    if qweight.data_ptr() % 4 or rot.data_ptr() % 16:
        raise ValueError("qweight must be 4-byte and rot 16-byte aligned")

    n_tiles = sum(-(-n // COLS_PER_TILE) for n in out_splits)
    KS = _group_splits(n_tiles, -(-M // ROWS_PER_TILE), G, dev)
    out = torch.empty((M, O), dtype=x.dtype, device=dev)
    if a8:
        xr = torch.empty(0, dtype=torch.float32, device=dev)
        xq = torch.empty((P, M, I), dtype=torch.int8, device=dev)
    else:
        xr = torch.empty((P, M, I), dtype=torch.float32, device=dev)
        xq = torch.empty(0, dtype=torch.int8, device=dev)
    xsum = torch.empty((P, M, G), dtype=torch.float32, device=dev)
    sx = torch.empty((P, M, G), dtype=torch.float32, device=dev)
    partial = torch.empty((KS, M, O) if KS > 1 else (0,), dtype=torch.float32, device=dev)
    splits = (ctypes.c_int * P)(*out_splits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib_fn()(
        x.data_ptr(), rot.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), xr.data_ptr(), xq.data_ptr(), xsum.data_ptr(), sx.data_ptr(),
        partial.data_ptr(), M, I, S, P, splits, KS, int(x.dtype == torch.bfloat16),
        int(rot.dtype == torch.bfloat16), int(a8), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launch_counts[name] += 1
    variant_counts[name][int(a8)] += 1
    return out


def rot_w4_matmul(x, rot, qweight, scales, zeros, *, a8: bool = False) -> torch.Tensor:
    """K1: x [M, I]; rot [G, S, S]; qweight uint8 [I//2, O]; scales, zeros
    bf16 [G, O] -> [M, O] in x.dtype."""
    if x.device.type == "cpu":
        return rot_w4_matmul_plain(x, rot, qweight, scales, zeros, a8=a8)
    return _launch("rot_w4_matmul", x, rot[None], qweight, scales, zeros,
                   (qweight.shape[1],), a8)


def merged_rot_w4_matmul(x, rot, qweight, scales, zeros, *, out_splits: tuple,
                         a8: bool = False) -> torch.Tensor:
    """K2: rot [P, G, S, S]; qweight [I//2, sum(out_splits)] -> [M, sum(out_splits)]."""
    out_splits = tuple(int(n) for n in out_splits)
    if x.device.type == "cpu":
        return merged_rot_w4_matmul_plain(x, rot, qweight, scales, zeros,
                                          out_splits=out_splits, a8=a8)
    return _launch("merged_rot_w4_matmul", x, rot, qweight, scales, zeros, out_splits, a8)
