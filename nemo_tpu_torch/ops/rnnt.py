"""RNN-Transducer loss (counterpart of nemo_tpu/ops/rnnt.py).

The forward variables alpha[t, u] = logaddexp(alpha[t-1, u] + lp_blank[t-1, u],
alpha[t, u-1] + lp_label[t, u-1]) fill the same lattice as the JAX package's,
in another order. JAX scans over T and solves each row over U by an
associative scan; here the loop runs over the U + 1 label columns and each
column is solved over T at once: along a column the recurrence is the
log-semiring linear recurrence of `_log_recurrence`, whose closed form is a
cumulative sum and a `logcumsumexp`. That is U + 1 steps of four tensor ops
instead of T steps of ~30, and autograd differentiates it as JAX's autodiff
differentiates the scan. The closed form subtracts cumulative sums of
log-probs, which reach thousands at T' = 751, so the lattice is computed in
float64 and the log-likelihood returned in the planes' dtype.

JAX freezes the rows past f_len and sets the cells past g_len to -1e30;
neither reaches the cell it reads, alpha[f_len-1, g_len-1], so the port
reads that cell of the unmasked lattice (the same value and gradients).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _log_recurrence(A: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Solve x_i = logaddexp(b_i, x_{i-1} + a_i) along `dim` (x_{-1} = -inf)
    given A, the cumulative sum of a with a_0 = 0: x_i = A_i +
    logcumsumexp(b - A)_i."""
    return A + torch.logcumsumexp(b - A, dim)


def rnnt_alpha(lp_blank: torch.Tensor, lp_label: torch.Tensor, f_len: torch.Tensor,
               g_len: torch.Tensor) -> torch.Tensor:
    """Per-sample log-likelihood [B] from lp_blank, lp_label [B, T, U1]
    (log P(blank | t, u) and log P(y_{u+1} | t, u); the last column of
    lp_label is unused), f_len [B] valid frames and g_len [B] valid label
    rows (U + 1 for U targets)."""
    B, T, U1 = lp_blank.shape
    blank = lp_blank.double()
    label = lp_label.double()
    # blank[t-1, u] is the step into (t, u) along column u; row 0 takes none
    step = torch.cat([torch.zeros_like(blank[:, :1]), blank[:, :-1]], 1)
    steps = step.cumsum(1)  # alpha of column 0: the blanks below each row
    cols = [steps[:, :, 0]]
    for u in range(1, U1):
        # x_t = logaddexp(alpha[t, u-1] + label[t, u-1], x_{t-1} + blank[t-1, u])
        cols.append(_log_recurrence(steps[:, :, u], cols[-1] + label[:, :, u - 1], 1))
    alpha = torch.stack(cols, 2)  # [B, T, U1]
    rows = torch.arange(B, device=alpha.device)
    t, u = f_len.long() - 1, g_len.long() - 1
    return (alpha[rows, t, u] + blank[rows, t, u]).to(lp_blank.dtype)


def rnnt_loss_from_log_probs(lp_blank: torch.Tensor, lp_label: torch.Tensor,
                             f_len: torch.Tensor, g_len: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood [B] from pre-gathered blank/label log-probs."""
    return -rnnt_alpha(lp_blank, lp_label, f_len, g_len)


def rnnt_loss(logits: torch.Tensor, targets: torch.Tensor, f_len: torch.Tensor,
              t_len: torch.Tensor) -> torch.Tensor:
    """Full (unchunked) RNNT NLL [B] from joint logits [B, T, U+1, V+1] with
    blank last, targets [B, U], encoder lengths f_len [B] and target
    lengths t_len [B]."""
    B, T, U1, V1 = logits.shape
    lp = F.log_softmax(logits.float(), dim=-1)
    tgt = torch.cat([targets, targets.new_zeros(B, 1)], 1).long()  # [B, U1]
    lp_label = lp.gather(3, tgt[:, None, :, None].expand(B, T, U1, 1))[..., 0]
    return rnnt_loss_from_log_probs(lp[..., V1 - 1], lp_label, f_len, t_len + 1)


def rnnt_loss_mean(logits: torch.Tensor, targets: torch.Tensor, f_len: torch.Tensor,
                   t_len: torch.Tensor) -> torch.Tensor:
    return rnnt_loss(logits, targets, f_len, t_len).mean()
