"""Rel-pos flash attention forward: the kernel K1 and its plain version.

Counterpart of nemo_tpu/ops/flash_attention.py:flash_attention (`_fwd_kernel`)
as nemo_tpu/ops/attention.py:_relpos_flash calls it: non-causal attention
with the Transformer-XL rel-pos term and key padding,

    s[i, j] = scale * (qu_i . k_j + qv_i . p_{(T-1)-i+j}),  masked for j >= len_b,

returning o [B, H, T, dh] and lse [B, H, T] (fp32). The CUDA kernel is
`csrc/relpos_flash.cu`; its note gives the design and what bounds it.

`relpos_flash_attention` launches the kernel for CUDA tensors and runs
`relpos_flash_attention_plain` only for CPU tensors. Padded query rows
(i >= len_b) hold values that callers must not read as results.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] raw q·p scores → [B, H, T, T] with
    out[..., i, j] = x[..., i, T-1-i+j] (relative distance i-j)."""
    B, H, T, L = x.shape
    x = torch.nn.functional.pad(x, (1, 0))  # [B, H, T, 2T]
    x = x.reshape(B, H, 2 * T, T)[:, :, 1:, :].reshape(B, H, T, L)
    return x[:, :, :, :T]


def relpos_flash_attention_plain(
    qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, lengths: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: the same function, computed with dense
    [B, H, T, T] scores in fp32. Shapes as `relpos_flash_attention`."""
    f32 = torch.float32
    T = qu.shape[2]
    ac = torch.einsum("bhid,bhjd->bhij", qu.to(f32), k.to(f32))
    bd = rel_shift(torch.einsum("bhid,hrd->bhir", qv.to(f32), p.to(f32)))
    s = (ac + bd) * scale
    keep = torch.arange(T, device=qu.device)[None, :] < lengths.to(qu.device)[:, None]
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.exp(s - lse[..., None])
    o = torch.einsum("bhij,bhjd->bhid", probs, v.to(f32))
    return o.to(qu.dtype), lse


def relpos_flash_attention(
    qu: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_u
    qv: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_v
    k: torch.Tensor,  # [B, H, T, dh]
    v: torch.Tensor,  # [B, H, T, dh]
    p: torch.Tensor,  # [H, 2T-1, dh] projected rel-pos table (positions T-1 .. -(T-1))
    lengths: torch.Tensor,  # [B] int valid keys per row
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (o [B, H, T, dh] in qu's dtype, lse [B, H, T] fp32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32, or bf16 at 16-byte aligned addresses; dh = 64) or raise. The
    kernel reads qu/qv/k/v in the [B, T, H, dh] layout (a view of the Linear
    outputs needs no copy) and writes o in that layout too."""
    if qu.device.type == "cpu":
        return relpos_flash_attention_plain(qu, qv, k, v, p, lengths, scale)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_flash_attention: unsupported device {qu.device}")
    B, H, T, dh = qu.shape
    dtype = qu.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"relpos_flash_attention: dtype {dtype} not supported")
    if dh != 64:
        raise ValueError(f"relpos_flash_attention: head dim {dh} != 64")
    for name, t in (("qv", qv), ("k", k), ("v", v)):
        if t.shape != qu.shape or t.dtype != dtype or t.device != qu.device:
            raise ValueError(f"relpos_flash_attention: {name} does not match qu")
    if p.shape != (H, 2 * T - 1, dh) or p.dtype != dtype or p.device != qu.device:
        raise ValueError(f"relpos_flash_attention: p must be [{H}, {2 * T - 1}, {dh}] {dtype}")
    if lengths.shape != (B,):
        raise ValueError("relpos_flash_attention: lengths must be [B]")
    bthd = [t.transpose(1, 2).contiguous() for t in (qu, qv, k, v)]
    p_rhd = p.transpose(0, 1).contiguous()
    if dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (*bthd, p_rhd)):
        raise ValueError("relpos_flash_attention: bf16 tensors must be 16-byte aligned")
    lens = lengths.to(device=qu.device, dtype=torch.int32).contiguous()
    o = torch.empty((B, T, H, dh), dtype=dtype, device=qu.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qu.device)
    lib = _lib()
    err = lib.relpos_flash_fwd(
        _DTYPES[dtype], *(t.data_ptr() for t in bthd), p_rhd.data_ptr(), lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, H, T, dh, float(scale),
        torch.cuda.current_stream(qu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"relpos_flash_attention: CUDA error {err} at launch")
    relpos_flash_attention.launches += 1
    return o.transpose(1, 2), lse


relpos_flash_attention.launches = 0


def _lib() -> ctypes.CDLL:
    from nemo_tpu_torch.csrc.loader import library

    lib = library("relpos_flash")
    fn = lib.relpos_flash_fwd
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib
