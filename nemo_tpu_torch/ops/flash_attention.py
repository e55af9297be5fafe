"""Rel-pos flash attention: the forward kernel K1, the backward kernels K3
(dq side) and K4 (dk/dv side), and their plain versions.

Counterpart of nemo_tpu/ops/flash_attention.py:flash_attention (`_fwd_kernel`,
and through its custom_vjp `_dq_kernel` and `_dkv_kernel`) as
nemo_tpu/ops/attention.py:_relpos_flash calls it: non-causal attention with
the Transformer-XL rel-pos term and key padding,

    s[i, j] = scale * (qu_i . k_j + qv_i . p_{(T-1)-i+j}),  masked for j >= len_b,

returning o [B, H, T, dh] and lse [B, H, T] (fp32). The CUDA kernels are
`csrc/relpos_flash.cu` (K1) and `csrc/relpos_flash_bwd.cu` (K3, K4); their
notes give the designs and what bounds them.

`relpos_flash_attention` is differentiable (`RelposFlashAttention`): its
backward is `relpos_flash_attention_backward`, which launches K3 and K4 for
CUDA tensors and runs `relpos_flash_attention_backward_plain` for CPU tensors.
Every wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors. Padded query rows (i >= len_b) hold
values that callers must not read as results.
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


def rel_unshift(x: torch.Tensor) -> torch.Tensor:
    """The adjoint of `rel_shift`: [B, H, T, T] → [B, H, T, 2T-1] with
    out[..., i, T-1-i+j] = x[..., i, j] and zeros elsewhere."""
    B, H, T, _ = x.shape
    i = torch.arange(T, device=x.device)
    idx = (T - 1 - i[:, None] + i[None, :]).expand(B, H, T, T)
    return x.new_zeros(B, H, T, 2 * T - 1).scatter_(-1, idx, x)


def _scores(qu, qv, k, p, lengths, scale) -> torch.Tensor:
    """Masked fp32 scores [B, H, T, T]."""
    f32 = torch.float32
    T = qu.shape[2]
    ac = torch.einsum("bhid,bhjd->bhij", qu.to(f32), k.to(f32))
    bd = rel_shift(torch.einsum("bhid,hrd->bhir", qv.to(f32), p.to(f32)))
    s = (ac + bd) * scale
    keep = torch.arange(T, device=qu.device)[None, :] < lengths.to(qu.device)[:, None]
    return torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))


def relpos_flash_attention_plain(
    qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, lengths: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: the same function, computed with dense
    [B, H, T, T] scores in fp32. Shapes as `relpos_flash_attention`."""
    s = _scores(qu, qv, k, p, lengths, scale)
    lse = torch.logsumexp(s, dim=-1)
    probs = torch.exp(s - lse[..., None])
    o = torch.einsum("bhij,bhjd->bhid", probs, v.to(torch.float32))
    return o.to(qu.dtype), lse


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) in fp32 [B, H, T], from the stored output, as
    nemo_tpu/ops/flash_attention.py:_flash_backward computes it outside its
    kernels."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(-1)


def _backward_plain(qu, qv, k, v, p, lengths, scale, lse, delta, do):
    f32 = torch.float32
    probs = torch.exp(_scores(qu, qv, k, p, lengths, scale) - lse[..., None])  # 0 on masked keys
    dprobs = torch.einsum("bhid,bhjd->bhij", do.to(f32), v.to(f32))
    ds = probs * (dprobs - delta[..., None]) * scale
    band = rel_unshift(ds)  # [B, H, T, 2T-1]: dS at each score's rel-pos row
    dqu = torch.einsum("bhij,bhjd->bhid", ds, k.to(f32))
    dqv = torch.einsum("bhir,hrd->bhid", band, p.to(f32))
    dk = torch.einsum("bhij,bhid->bhjd", ds, qu.to(f32))
    dv = torch.einsum("bhij,bhid->bhjd", probs, do.to(f32))
    dp = torch.einsum("bhir,bhid->hrd", band, qv.to(f32))
    return (dqu.to(qu.dtype), dqv.to(qv.dtype), dk.to(k.dtype), dv.to(v.dtype), dp.to(p.dtype))


def relpos_flash_attention_backward_plain(
    qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
    lengths: torch.Tensor, scale: float, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K3 and K4: (dqu, dqv, dk, dv, dp), the dense
    FlashAttention-2 backward in fp32 (shapes of the inputs):

        δ = rowsum(dO∘O);  P = exp(s − lse), 0 on masked keys
        dS = P∘(dO·vᵀ − δ)·scale
        dqu = dS·k;  dk = dSᵀ·qu;  dv = Pᵀ·dO
        dqv_i = Σ_j dS_ij p_{T−1−i+j};  dp_r = Σ_{b,i,j: T−1−i+j=r} dS_ij qv_i

    It differs from the bf16 kernels (and from the JAX kernels,
    flash_attention.py:248,291,299) in one place: those round P and dS to the
    input dtype before each product; here every product is fp32."""
    return _backward_plain(qu, qv, k, v, p, lengths, scale, lse, row_delta(o, do), do)


def _check(what: str, qu, qv, k, v, p, lengths) -> None:
    B, H, T, dh = qu.shape
    dtype = qu.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {dtype} not supported")
    if dh != 64:
        raise ValueError(f"{what}: head dim {dh} != 64")
    for name, t in (("qv", qv), ("k", k), ("v", v)):
        if t.shape != qu.shape or t.dtype != dtype or t.device != qu.device:
            raise ValueError(f"{what}: {name} does not match qu")
    if p.shape != (H, 2 * T - 1, dh) or p.dtype != dtype or p.device != qu.device:
        raise ValueError(f"{what}: p must be [{H}, {2 * T - 1}, {dh}] {dtype}")
    if lengths.shape != (B,):
        raise ValueError(f"{what}: lengths must be [B]")


def _bthd(what: str, tensors):
    """[B, H, T, dh] views → contiguous [B, T, H, dh] (no copy for a view of
    the Linear outputs); bf16 tensors must be 16-byte aligned."""
    out = [t.transpose(1, 2).contiguous() for t in tensors]
    if out[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in out):
        raise ValueError(f"{what}: bf16 tensors must be 16-byte aligned")
    return out


def _p_rhd(what: str, p: torch.Tensor) -> torch.Tensor:
    p_rhd = p.transpose(0, 1).contiguous()
    if p_rhd.dtype == torch.bfloat16 and p_rhd.data_ptr() % 16:
        raise ValueError(f"{what}: bf16 tensors must be 16-byte aligned")
    return p_rhd


def _device(what: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _k1_launch(qu, qv, k, v, p, lengths, scale):
    """K1 → (o [B, T, H, dh], lse [B, H, T] fp32)."""
    what = "relpos_flash_attention"
    _check(what, qu, qv, k, v, p, lengths)
    B, H, T, dh = qu.shape
    dtype = qu.dtype
    bthd = _bthd(what, (qu, qv, k, v))
    p_rhd = _p_rhd(what, p)
    lens = lengths.to(device=qu.device, dtype=torch.int32).contiguous()
    o = torch.empty((B, T, H, dh), dtype=dtype, device=qu.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qu.device)
    err = _lib().relpos_flash_fwd(
        _DTYPES[dtype], *(t.data_ptr() for t in bthd), p_rhd.data_ptr(), lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, H, T, dh, float(scale),
        torch.cuda.current_stream(qu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"relpos_flash_attention: CUDA error {err} at launch")
    relpos_flash_attention.launches += 1
    return o, lse


class RelposFlashAttention(torch.autograd.Function):
    """K1 with its backward. Forward: o and lse (lse is not differentiable);
    backward: `relpos_flash_attention_backward` (K3 + K4 on the card, the
    plain backward on the CPU). Works in [B, T, H, dh] for o."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, p, lengths, scale):
        if _device("relpos_flash_attention", qu) == "cpu":
            o, lse = relpos_flash_attention_plain(qu, qv, k, v, p, lengths, scale)
            o = o.transpose(1, 2).contiguous()
        else:
            o, lse = _k1_launch(qu, qv, k, v, p, lengths, scale)
        ctx.save_for_backward(qu, qv, k, v, p, lengths, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qu, qv, k, v, p, lengths, o, lse = ctx.saved_tensors
        grads = relpos_flash_attention_backward(
            qu, qv, k, v, p, lengths, ctx.scale, o.transpose(1, 2), lse,
            do.to(qu.dtype).transpose(1, 2))
        return (*grads, None, None)


def relpos_flash_attention(
    qu: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_u
    qv: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_v
    k: torch.Tensor,  # [B, H, T, dh]
    v: torch.Tensor,  # [B, H, T, dh]
    p: torch.Tensor,  # [H, 2T-1, dh] projected rel-pos table (positions T-1 .. -(T-1))
    lengths: torch.Tensor,  # [B] int valid keys per row (>= 1)
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (o [B, H, T, dh] in qu's dtype, lse [B, H, T] fp32), differentiable
    in qu, qv, k, v and p.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32, or bf16 at 16-byte aligned addresses; dh = 64) or raise. The
    kernel reads qu/qv/k/v in the [B, T, H, dh] layout (a view of the Linear
    outputs needs no copy) and writes o in that layout too."""
    o, lse = RelposFlashAttention.apply(qu, qv, k, v, p, lengths, scale)
    return o.transpose(1, 2), lse


relpos_flash_attention.launches = 0


def relpos_flash_dq(qu, qv, k, v, p, lengths, scale, lse, delta, do):
    """K3 → (dqu, dqv) [B, H, T, dh]; `delta` is `row_delta(o, do)`. Inputs
    as `relpos_flash_attention`, plus lse and delta [B, H, T] fp32 and do
    [B, H, T, dh] in qu's dtype. CPU tensors take the plain backward."""
    if _device("relpos_flash_dq", qu) == "cpu":
        return _backward_plain(qu, qv, k, v, p, lengths, scale, lse, delta, do)[:2]
    outs = _bwd_launch("relpos_flash_bwd_dq", qu, qv, k, v, p, lengths, scale, lse, delta, do,
                       n_out=2)
    relpos_flash_dq.launches += 1
    return tuple(t.transpose(1, 2) for t in outs)


relpos_flash_dq.launches = 0


def relpos_flash_dkv(qu, qv, k, v, p, lengths, scale, lse, delta, do):
    """K4 → (dk, dv [B, H, T, dh], dp [H, 2T-1, dh]); arguments as
    `relpos_flash_dq`. dp is summed over the batch with fp32 atomics, so its
    last bits change from run to run. CPU tensors take the plain backward."""
    if _device("relpos_flash_dkv", qu) == "cpu":
        return _backward_plain(qu, qv, k, v, p, lengths, scale, lse, delta, do)[2:]
    dk, dv, dp32 = _bwd_launch("relpos_flash_bwd_dkv", qu, qv, k, v, p, lengths, scale, lse,
                               delta, do, n_out=3)
    relpos_flash_dkv.launches += 1
    return dk.transpose(1, 2), dv.transpose(1, 2), dp32.to(p.dtype).transpose(0, 1)


relpos_flash_dkv.launches = 0


def _bwd_launch(fn: str, qu, qv, k, v, p, lengths, scale, lse, delta, do, n_out: int):
    """Launch K3 (n_out 2: dqu, dqv [B, T, H, dh]) or K4 (n_out 3: dk, dv
    [B, T, H, dh] and dp [2T-1, H, dh] fp32)."""
    _check(fn, qu, qv, k, v, p, lengths)
    B, H, T, dh = qu.shape
    dtype = qu.dtype
    if do.shape != qu.shape or do.dtype != dtype:
        raise ValueError(f"{fn}: do must match qu")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be [B, H, T] float32")
    bthd = _bthd(fn, (qu, qv, k, v, do))
    p_rhd = _p_rhd(fn, p)
    lens = lengths.to(device=qu.device, dtype=torch.int32).contiguous()
    outs = [torch.empty((B, T, H, dh), dtype=dtype, device=qu.device) for _ in range(2)]
    if n_out == 3:  # dp, summed by atomics
        outs.append(torch.zeros((2 * T - 1, H, dh), dtype=torch.float32, device=qu.device))
    err = getattr(_lib("relpos_flash_bwd"), fn)(
        _DTYPES[dtype], *(t.data_ptr() for t in bthd[:4]), p_rhd.data_ptr(), bthd[4].data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(), lens.data_ptr(),
        *(t.data_ptr() for t in outs), B, H, T, dh, float(scale),
        torch.cuda.current_stream(qu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    return outs


def relpos_flash_attention_backward(
    qu: torch.Tensor, qv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
    lengths: torch.Tensor, scale: float, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """(dqu, dqv, dk, dv, dp) of `relpos_flash_attention` for the output
    cotangent do: K3 and K4 for CUDA tensors, the plain backward for CPU
    tensors."""
    if _device("relpos_flash_attention_backward", qu) == "cpu":
        return relpos_flash_attention_backward_plain(qu, qv, k, v, p, lengths, scale, o, lse, do)
    delta = row_delta(o, do)
    args = (qu, qv, k, v, p, lengths, scale, lse, delta, do)
    return (*relpos_flash_dq(*args), *relpos_flash_dkv(*args))


def _lib(name: str = "relpos_flash") -> ctypes.CDLL:
    """The forward (K1, `relpos_flash`) or backward (K3 + K4,
    `relpos_flash_bwd`) kernel library, with its C signatures set."""
    from nemo_tpu_torch.csrc.loader import library

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = library(name)
    if name == "relpos_flash":
        sigs = {"relpos_flash_fwd": [ci] + [vp] * 8}
    else:  # dtype, 5 inputs, p, do, lse, delta, lengths, outputs
        sigs = {"relpos_flash_bwd_dq": [ci] + [vp] * 11, "relpos_flash_bwd_dkv": [ci] + [vp] * 12}
    for fn_name, head in sigs.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = head + [ci, ci, ci, ci, ctypes.c_float, vp]
            fn.restype = ci
    return lib
