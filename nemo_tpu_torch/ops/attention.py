"""Relative-position attention (counterpart of nemo_tpu/ops/attention.py).

Two forms of the same non-causal Transformer-XL attention:

- the trig decomposition (`use_flash=False`): since pe is sinusoidal,
  qv_i . W_pos^T pe(i-j) = a_i . cos(w j) + b_i . sin(w j), so the rel-pos
  term becomes extra contraction features of one dense score product;
- the rel-pos flash kernel K1 (`use_flash=True`, ops/flash_attention.py):
  p = pe @ W_pos is one plain matmul here, and the kernel reads each score's
  band of p itself, at head width 64.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from nemo_tpu_torch.ops.flash_attention import NEG_INF, relpos_flash_attention


def relpos_frequencies(d_model: int) -> np.ndarray:
    """ω_f used by the sinusoidal table (RelPositionalEncoding)."""
    return np.exp(
        np.arange(0, d_model, 2, np.float32) * -(math.log(10000.0) / d_model)
    )


def decompose_relpos_q(
    qv: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_v
    w_pos: torch.Tensor,  # [d_model, H, dh] linear_pos kernel (JAX layout)
    positions: torch.Tensor,  # [T] absolute positions (0..T-1)
    d_model: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (a, b, cosW, sinW): a, b [B, H, T, F]; cosW, sinW [T, F] with
    F = d_model/2, such that bd[b,h,i,j] = a[b,h,i]·cosW[j] + b[b,h,i]·sinW[j]."""
    omega = torch.from_numpy(relpos_frequencies(d_model)).to(qv.device)
    ang = positions.to(torch.float32)[:, None] * omega[None, :]
    sinP, cosP = torch.sin(ang), torch.cos(ang)
    w = w_pos.to(torch.float32)
    g_sin = torch.einsum("bhtd,fhd->bhtf", qv.to(torch.float32), w[0::2])
    g_cos = torch.einsum("bhtd,fhd->bhtf", qv.to(torch.float32), w[1::2])
    a = g_sin * sinP + g_cos * cosP
    b = g_cos * sinP - g_sin * cosP
    return a, b, cosP, sinP


def relpos_attention(
    qu: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_u
    qv: torch.Tensor,  # [B, H, T, dh] = q + pos_bias_v
    k: torch.Tensor,  # [B, H, T, dh]
    v: torch.Tensor,  # [B, H, T, dh]
    w_pos: torch.Tensor,  # [d_model, H, dh]
    lengths: torch.Tensor,  # [B] valid frames
    *,
    d_model: int,
    scale: float,
    pos_emb: Optional[torch.Tensor] = None,  # [2T-1, d_model], needed with use_flash
    use_flash: bool = False,
) -> torch.Tensor:
    """Full (non-causal) rel-pos attention → [B, H, T, dh] in v's dtype.
    Padded query rows hold values that callers must not read as results."""
    B, H, T, dh = qu.shape
    if use_flash:
        dtype = qu.dtype
        p = pos_emb.to(dtype) @ w_pos.reshape(d_model, d_model).to(dtype)  # [2T-1, D]
        p = p.view(2 * T - 1, H, dh).transpose(0, 1)  # [H, 2T-1, dh]
        out, _ = relpos_flash_attention(qu, qv, k, v, p, lengths, scale)
        return out

    positions = torch.arange(T, device=qu.device)
    a, b, cosW, sinW = decompose_relpos_q(qv, w_pos, positions, d_model)
    q_aug = torch.cat([qu.to(torch.float32), a, b], dim=-1)  # [B,H,T,dh+2F]
    k_aug = torch.cat(
        [k.to(torch.float32),
         cosW[None, None].expand(B, H, T, cosW.shape[-1]),
         sinW[None, None].expand(B, H, T, sinW.shape[-1])], dim=-1)
    scores = torch.einsum("bhid,bhjd->bhij", q_aug, k_aug) * scale
    keep = positions[None, :] < lengths.to(qu.device)[:, None]  # [B, T] keys
    scores = torch.where(keep[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", probs.to(v.dtype), v)
