"""LLM losses (counterpart of nemo_tpu/models/llm/loss.py): the masked token
CE and the fused linear + CE of training.

`fused_linear_cross_entropy` never holds [B, S, V] logits: each chunk of the
sequence is one autograd Function (`_ChunkNLL`) that computes its [B·c, V]
logits in fp32, keeps only their logsumexp, and computes them again in its
backward. At Llama-3.2-1B's B=8, S=2048, V=128,256 a chunk of 512 holds
2.1 GB of fp32 logits, where the whole would take 8.4 GB.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                      loss_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, S, V], labels [B, S], loss_mask [B, S] {0, 1} → (mean
    loss over valid tokens, number of valid tokens), as loss.py:18 (no
    z-loss: no caller of the port asks for one)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    mask = torch.ones_like(nll) if loss_mask is None else loss_mask.float()
    n = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / n, n


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result: bf16 or fp16 operands on the card go
    through cuBLAS's product with fp32 output (the counterpart of
    `preferred_element_type=float32`, loss.py:69); on the CPU the operands
    are widened first, which gives the same products."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ChunkNLL(torch.autograd.Function):
    """Σ nll·mask over one chunk of rows. h [N, D] in the compute dtype; w
    [V, D] the head leaf (its gradient is returned in w's dtype); w_c is w in
    h's dtype (computed once for all chunks, not differentiated); labels [N];
    mask [N] fp32. The fp32 logits are computed again in the backward."""

    @staticmethod
    def forward(ctx, h, w, w_c, labels, mask):
        logits = _mm_f32(h, w_c.t())
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - logits.gather(-1, labels[:, None])[:, 0]
        ctx.save_for_backward(h, w_c, labels, mask, lse)
        ctx.w_dtype = w.dtype
        return (nll * mask).sum()

    @staticmethod
    def backward(ctx, g):
        h, w_c, labels, mask, lse = ctx.saved_tensors
        dlogits = _mm_f32(h, w_c.t()).sub_(lse[:, None]).exp_()  # softmax
        dlogits.scatter_add_(1, labels[:, None], -torch.ones_like(lse)[:, None])
        dlogits.mul_((mask * g)[:, None])
        d = dlogits.to(h.dtype)  # bf16 on the card's main path
        del dlogits
        dh = d @ w_c
        dw = _mm_f32(d.t(), h).to(ctx.w_dtype)
        return dh, dw, None, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, head_w_vd: torch.Tensor,
                               labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None,
                               chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [B, S, D] (compute dtype), head_w_vd [V, D] (the tied embedding
    or lm_head's weight, any dtype; cast to hidden's at use), labels [B, S]
    → (mean loss over valid tokens, number of valid tokens), without [B, S,
    V] logits (loss.py:38). Chunks of c = min(chunk, S) positions, lowered
    until c divides S.

    The logits are fp32 products of the compute-dtype operands. In the
    backward the logits' gradient is rounded to the compute dtype before its
    two products (JAX takes them as fp32 mixed products); in fp32 the two
    agree. No z-loss or logit softcapping: no caller of the port asks for
    them."""
    B, S, D = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    mask = (torch.ones((B, S), device=hidden.device) if loss_mask is None
            else loss_mask.to(hidden.device, torch.float32))
    labels = labels.long()
    w_c = head_w_vd.detach().to(hidden.dtype)
    total = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, c):
        total = total + _ChunkNLL.apply(
            hidden[:, s0:s0 + c].reshape(-1, D), head_w_vd, w_c,
            labels[:, s0:s0 + c].reshape(-1), mask[:, s0:s0 + c].reshape(-1))
    n = mask.sum().clamp_min(1.0)
    return total / n, n
