"""Fused striding subsampling (x4): the kernel K2 and its plain version.

Counterpart of nemo_tpu/ops/subsampling_kernel.py:fused_subsampling_x4: conv
3x3 stride 2 (1→C) + bias + ReLU, then conv 3x3 stride 2 (C→C) + bias + ReLU,
with the first conv's output kept on chip. Same signature and output layout
as the JAX function: weights in HWIO, output [B, T4, F4·C] flattened (f, c).
The CUDA kernel is `csrc/fused_subsampling.cu`; its note gives the design and
what bounds it.

`fused_subsampling_x4` launches the kernel for CUDA tensors and runs
`fused_subsampling_x4_plain` (the F.conv2d pair, in fp32) only for CPU tensors.
The kernel has no backward, as the JAX kernel has none: for CUDA tensors the
wrapper raises where a gradient is required, rather than return an output
cut from the graph. A training forward runs the conv pair instead
(`ConformerEncoder.forward(..., conv_pair_subsampling=True)`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_subsampling_x4_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: two F.conv2d calls in fp32. The first
    conv's output is rounded to x's dtype before the second conv, and the
    result is cast to x's dtype, as in the kernel (and, for bf16 input, in
    the JAX kernel: bf16 operands, fp32 sums)."""
    f32 = torch.float32
    h = F.conv2d(x[:, None].to(f32), w1.permute(3, 2, 0, 1).to(f32), b1.to(f32),
                 stride=2, padding=1).relu()
    h = h.to(x.dtype).to(f32)
    h = F.conv2d(h, w2.permute(3, 2, 0, 1).to(f32), b2.to(f32), stride=2, padding=1).relu()
    B, C, T4, F4 = h.shape
    return h.permute(0, 2, 3, 1).reshape(B, T4, F4 * C).to(x.dtype)


def fused_subsampling_x4(
    x: torch.Tensor,  # [B, T, F]
    w1: torch.Tensor,  # [3, 3, 1, C]
    b1: torch.Tensor,  # [C]
    w2: torch.Tensor,  # [3, 3, C, C]
    b2: torch.Tensor,  # [C]
) -> torch.Tensor:
    """→ [B, T4, F4·C]. CPU tensors take the plain version; CUDA tensors
    launch the kernel (fp32 or bf16, C a multiple of 128, a bf16 w2 16-byte
    aligned) or raise; for CUDA tensors it also raises where grad mode is on
    and an input requires grad (the kernel has no backward)."""
    if x.device.type == "cpu":
        return fused_subsampling_x4_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_subsampling_x4: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("fused_subsampling_x4 has no backward (nor has the JAX kernel): "
                           "run the training forward through the conv pair "
                           "(conv_pair_subsampling=True)")
    B, T, Fi = x.shape
    C = w1.shape[-1]
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"fused_subsampling_x4: dtype {dtype} not supported")
    if C % 128:
        raise ValueError(f"fused_subsampling_x4: channels {C} not a multiple of 128")
    shapes = ((w1, (3, 3, 1, C)), (b1, (C,)), (w2, (3, 3, C, C)), (b2, (C,)))
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"fused_subsampling_x4: expected a {shape} {dtype} weight")
    T4 = ((T - 1) // 2) // 2 + 1
    F4 = ((Fi - 1) // 2) // 2 + 1
    args = [t.contiguous() for t in (x, w1, b1, w2, b2)]
    if dtype == torch.bfloat16 and args[3].data_ptr() % 16:
        raise ValueError("fused_subsampling_x4: the bf16 w2 must be 16-byte aligned")
    out = torch.empty((B, T4, F4 * C), dtype=dtype, device=x.device)
    err = _lib().fused_subsampling_x4(
        _DTYPES[dtype], *(t.data_ptr() for t in args), out.data_ptr(), B, T, Fi, C,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_subsampling_x4: CUDA error {err} at launch")
    fused_subsampling_x4.launches += 1
    return out


fused_subsampling_x4.launches = 0


def _lib() -> ctypes.CDLL:
    from nemo_tpu_torch.csrc.loader import library

    lib = library("fused_subsampling")
    fn = lib.fused_subsampling_x4
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return lib
