"""Conformer encoder, offline path (counterpart of
nemo_tpu/models/asr/modules/conformer.py).

Per layer: x += ½·FF(LN x); x += MHSA(LN x, rel-pos); x += Conv(LN x);
x += ½·FF(LN x); x = LN x. Conv module: pointwise(2d) → GLU → mask →
depthwise(k) → BatchNorm → swish → pointwise(d).

Layout is [B, T, D] inside. Parameter names mirror the JAX tree
(`layer3.attn.linear_q`, `pre_encode.conv0`, ...). Linear and conv weights
are held in the compute dtype; LayerNorm (eps 1e-6, the flax default) and
BatchNorm (eps 1e-5, running stats) hold fp32 and compute in fp32. Training
keeps fp32 master weights in its optimizer (core/optim.py), as the JAX
variables are fp32 and cast to the compute dtype at each use.

The forward is differentiable, BatchNorm's running stats included (they
are read in eval mode, as flax's `use_running_average`, and receive
gradients where they require them). The fused subsampling kernel has no
backward, so a training forward passes `conv_pair_subsampling=True`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nemo_tpu_torch.ops.attention import relpos_attention
from nemo_tpu_torch.ops.subsampling_kernel import fused_subsampling_x4

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LN_EPS = 1e-6


def subsampled_length(length: torch.Tensor, num_layers: int) -> torch.Tensor:
    """Each conv layer: k=3, s=2, p=1 → L = floor((L-1)/2)+1."""
    for _ in range(num_layers):
        length = torch.div(length - 1, 2, rounding_mode="floor") + 1
    return length


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32, cast back to x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class ConvSubsampling(nn.Module):
    """'striding' or 'dw_striding' 2-D conv subsampling: [B, T, F] → [B,
    T/2^n, d_model]. Each of the n layers is a 3×3 stride-2 conv (`conv{i}`)
    and a ReLU; with 'dw_striding' (FastConformer) every layer after the
    first is a depthwise 3×3 stride-2 conv (`dw{i}`) and a 1×1 conv
    (`pw{i}`) before its ReLU. These convolutions are cuDNN's, as they are
    XLA's in JAX.

    With `fused_kernel` ('striding' at factor 4 only, as in JAX) both convs
    run as the fused kernel K2 (ops/subsampling_kernel.py) on the same
    parameters, unless the caller asks for the conv pair (`conv_pair=True`,
    the training forward)."""

    def __init__(self, d_model: int, feat_in: int, subsampling_factor: int = 4,
                 conv_channels: int = -1, fused_kernel: bool = False,
                 dtype: torch.dtype = torch.float32, subsampling: str = "striding"):
        super().__init__()
        if subsampling not in ("striding", "dw_striding"):
            raise ValueError(f"subsampling {subsampling!r} is not ported")
        self.n_layers = int(math.log2(subsampling_factor))
        self.depthwise = subsampling == "dw_striding"
        self.fused_kernel = fused_kernel and self.n_layers == 2 and not self.depthwise
        ch = conv_channels if conv_channels > 0 else d_model
        f = feat_in
        for i in range(self.n_layers):
            if self.depthwise and i > 0:
                self.add_module(f"dw{i}", nn.Conv2d(ch, ch, 3, stride=2, padding=1, groups=ch,
                                                    dtype=dtype))
                self.add_module(f"pw{i}", nn.Conv2d(ch, ch, 1, dtype=dtype))
            else:
                self.add_module(f"conv{i}", nn.Conv2d(1 if i == 0 else ch, ch, 3, stride=2,
                                                      padding=1, dtype=dtype))
            f = (f - 1) // 2 + 1
        self.out = nn.Linear(f * ch, d_model, dtype=dtype)

    def _layer(self, i: int, h: torch.Tensor) -> torch.Tensor:
        if self.depthwise and i > 0:
            return getattr(self, f"pw{i}")(getattr(self, f"dw{i}")(h)).relu()
        return getattr(self, f"conv{i}")(h).relu()

    def forward(self, x: torch.Tensor, length: torch.Tensor,
                conv_pair: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.fused_kernel and not conv_pair:
            hwio = lambda w: w.permute(2, 3, 1, 0)  # OIHW → HWIO, the kernel's layout
            h = fused_subsampling_x4(x, hwio(self.conv0.weight), self.conv0.bias,
                                     hwio(self.conv1.weight), self.conv1.bias)
        else:
            h = x[:, None]  # [B, 1, T, F]
            for i in range(self.n_layers):
                h = self._layer(i, h)
            B, C, T, Fo = h.shape
            # flatten (f, c) as the JAX [B, T, F, C] reshape does
            h = h.permute(0, 2, 3, 1).reshape(B, T, Fo * C)
        return self.out(h), subsampled_length(length, self.n_layers)


class RelPositionalEncoding(nn.Module):
    """Transformer-XL relative positional embeddings: pe[k] for relative
    positions T-1, …, 0, …, -(T-1), and the (optionally xscaled) input."""

    def __init__(self, d_model: int, max_len: int = 5000, xscale: Optional[float] = None):
        super().__init__()
        self.max_len = max_len
        self.xscale = xscale
        pos = np.arange(max_len - 1, -max_len, -1, dtype=np.float32)
        inv = np.exp(np.arange(0, d_model, 2, np.float32) * -(math.log(10000.0) / d_model))
        pe = np.zeros((len(pos), d_model), np.float32)
        pe[:, 0::2] = np.sin(pos[:, None] * inv[None, :])
        pe[:, 1::2] = np.cos(pos[:, None] * inv[None, :])
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (x·xscale, pos_emb [2T-1, d_model] fp32)."""
        T = x.shape[1]
        if self.xscale:
            x = x * self.xscale
        center = self.max_len - 1
        return x, self.pe[center - (T - 1): center + T]


class _PosKernel(nn.Module):
    """Holds the linear_pos kernel [D, D] (in, out), as the JAX tree does."""

    def __init__(self, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_model, d_model, dtype=dtype))


class RelPositionMultiHeadAttention(nn.Module):
    """Rel-pos MHSA with learned global biases pos_bias_u / pos_bias_v.

    impl "decomposed": the trig-decomposed dense score product;
    impl "decomposed_flash": the rel-pos flash kernel K1."""

    def __init__(self, d_model: int, n_heads: int, impl: str = "decomposed",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if impl not in ("decomposed", "decomposed_flash"):
            raise ValueError(f"attention impl {impl!r} is not ported")
        self.d_model, self.n_heads, self.impl = d_model, n_heads, impl
        dh = d_model // n_heads
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            self.add_module(name, nn.Linear(d_model, d_model, dtype=dtype))
        self.linear_pos = _PosKernel(d_model, dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, dh, dtype=dtype))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, dh, dtype=dtype))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.n_heads
        dh = D // H
        q = self.linear_q(x).view(B, T, H, dh)
        k = self.linear_k(x).view(B, T, H, dh).transpose(1, 2)  # [B,H,T,dh] views
        v = self.linear_v(x).view(B, T, H, dh).transpose(1, 2)
        qu = (q + self.pos_bias_u).transpose(1, 2)
        qv = (q + self.pos_bias_v).transpose(1, 2)
        out = relpos_attention(
            qu, qv, k, v, self.linear_pos.kernel.view(D, H, dh), lengths,
            d_model=D, scale=1.0 / math.sqrt(dh), pos_emb=pos_emb,
            use_flash=self.impl == "decomposed_flash")
        return self.linear_out(out.transpose(1, 2).reshape(B, T, D))


class ConformerFeedForward(nn.Module):
    def __init__(self, d_model: int, expansion_factor: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_model * expansion_factor, dtype=dtype)
        self.linear2 = nn.Linear(d_model * expansion_factor, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.silu(self.linear1(x)))


class ConformerConvolution(nn.Module):
    """pointwise(2d) → GLU → mask → depthwise(k) → BatchNorm → swish → pointwise(d)."""

    def __init__(self, d_model: int, kernel_size: int = 31, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pointwise1 = nn.Linear(d_model, 2 * d_model, dtype=dtype)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel_size, groups=d_model,
                                   padding=(kernel_size - 1) // 2, dtype=dtype)
        self.norm = nn.BatchNorm1d(d_model, eps=1e-5)
        self.pointwise2 = nn.Linear(d_model, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        a, b = self.pointwise1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)  # GLU
        h = h.masked_fill(~pad_mask[..., None], 0.0)
        h = self.depthwise(h.transpose(1, 2)).transpose(1, 2)  # [B, T, D]
        n = self.norm  # eval-mode BatchNorm from running stats, in fp32
        h = ((h.float() - n.running_mean) * torch.rsqrt(n.running_var + n.eps) * n.weight
             + n.bias).to(x.dtype)
        return self.pointwise2(F.silu(h))


class ConformerLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, ff_expansion_factor: int = 4,
                 conv_kernel_size: int = 31, att_impl: str = "decomposed",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for name in ("norm_ff1", "norm_attn", "norm_conv", "norm_ff2", "norm_out"):
            self.add_module(name, nn.LayerNorm(d_model, eps=LN_EPS))
        self.ff1 = ConformerFeedForward(d_model, ff_expansion_factor, dtype)
        self.attn = RelPositionMultiHeadAttention(d_model, n_heads, att_impl, dtype)
        self.conv = ConformerConvolution(d_model, conv_kernel_size, dtype)
        self.ff2 = ConformerFeedForward(d_model, ff_expansion_factor, dtype)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, lengths: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ff1(layer_norm(self.norm_ff1, x))
        x = x + self.attn(layer_norm(self.norm_attn, x), pos_emb, lengths)
        x = x + self.conv(layer_norm(self.norm_conv, x), pad_mask)
        x = x + 0.5 * self.ff2(layer_norm(self.norm_ff2, x))
        return layer_norm(self.norm_out, x)


class ConformerEncoder(nn.Module):
    """Offline Conformer encoder: (mel [B, D, T], lens) → (enc [B, d_model, T'], lens').

    Takes the JAX config's keys; dropout is inference-only here, and the
    streaming, adapter and interctc options are not ported."""

    def __init__(self, feat_in: int, n_layers: int, d_model: int, n_heads: int,
                 subsampling: str = "striding", subsampling_factor: int = 4,
                 subsampling_conv_channels: int = -1, ff_expansion_factor: int = 4,
                 conv_kernel_size: int = 31, conv_norm_type: str = "batch_norm",
                 xscaling: bool = True, pos_emb_max_len: int = 5000,
                 att_impl: str = "decomposed", fused_subsampling: bool = False,
                 compute_dtype: str = "float32", **unused):
        super().__init__()
        if conv_norm_type != "batch_norm":
            raise ValueError("only the batch_norm conv module is ported")
        self.n_layers = n_layers
        self.dtype = DTYPES[compute_dtype]
        self.pre_encode = ConvSubsampling(d_model, feat_in, subsampling_factor,
                                          subsampling_conv_channels, fused_subsampling,
                                          self.dtype, subsampling)
        self.pos_enc = RelPositionalEncoding(
            d_model, pos_emb_max_len, math.sqrt(d_model) if xscaling else None)
        for i in range(n_layers):
            self.add_module(f"layer{i}", ConformerLayer(
                d_model, n_heads, ff_expansion_factor, conv_kernel_size, att_impl, self.dtype))

    def forward(self, audio_signal: torch.Tensor, length: torch.Tensor, *,
                conv_pair_subsampling: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """`conv_pair_subsampling` runs the subsampling through the conv pair
        even where `fused_subsampling` is set: the choice of a training
        forward, since the fused kernel has no backward."""
        x = audio_signal.transpose(1, 2).to(self.dtype)  # [B, T, D]
        x, length = self.pre_encode(x, length, conv_pair_subsampling)
        x, pos_emb = self.pos_enc(x)
        T = x.shape[1]
        pad_mask = torch.arange(T, device=x.device)[None, :] < length[:, None]
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, pos_emb, length, pad_mask)
        x = x.masked_fill(~pad_mask[..., None], 0.0)
        return x.transpose(1, 2), length
