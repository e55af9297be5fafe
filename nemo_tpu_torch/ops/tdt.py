"""TDT (Token-and-Duration Transducer) loss and frame-skipping greedy decode
(counterpart of nemo_tpu/ops/tdt.py).

TDT extends RNNT with a duration head: every emission, token or blank, also
predicts how many encoder frames to skip (one of `durations`, the first 0),
so the decode visits only a fraction of the frames.

The loss fills the lattice alpha[t, u] as JAX's does, one frame at a time
with a history of the last max(durations) rows: a blank of duration d >= 1
enters (t, u) from (t - d, u), a token of duration d >= 1 from (t - d, u -
1), and a token of duration 0 from (t, u - 1) within the row. That last
recurrence, x_u = logaddexp(b_u, x_{u-1} + a_u), is the log-semiring linear
recurrence whose closed form is A_u + logcumsumexp(b - A)_u with A the
cumulative sum of a (JAX solves it by an associative scan). The lattice is
computed in float64, as the RNNT loss's is (ops/rnnt.py): the closed form
subtracts cumulative sums of log-probs. Autograd gives the gradient.

JAX freezes the rows past f_len and sets the cells past t_len to -1e30;
neither reaches the cells the loss reads, alpha[f_len-1, t_len], so the
port reads them from the unmasked lattice (the same value and gradients).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from nemo_tpu_torch.models.asr.modules import rnnt as _rnnt

NEG_INF = -1e30


def _check_durations(durations: Sequence[int]) -> Tuple[int, ...]:
    durations = tuple(int(d) for d in durations)
    if not durations or durations[0] != 0 or list(durations) != sorted(set(durations)):
        raise ValueError(f"TDT durations must start at 0 and ascend: {durations}")
    return durations


def _shift_u(x: torch.Tensor) -> torch.Tensor:
    """x[..., u - 1] at u along the last axis, -1e30 at u = 0."""
    return F.pad(x[..., :-1], (1, 0), value=NEG_INF)


def tdt_loss(token_logits: torch.Tensor, dur_logits: torch.Tensor, targets: torch.Tensor,
             f_len: torch.Tensor, t_len: torch.Tensor,
             durations: Sequence[int] = (0, 1, 2, 3, 4)) -> torch.Tensor:
    """Negative log-likelihood [B] (fp32) from token logits [B, T, U+1, V+1]
    (blank last), duration logits [B, T, U+1, D], targets [B, U], encoder
    lengths f_len [B] and target lengths t_len [B]."""
    durations = _check_durations(durations)
    B, T, U1, V1 = token_logits.shape
    lp = F.log_softmax(token_logits.float(), dim=-1)
    lp_dur = F.log_softmax(dur_logits.float(), dim=-1).double()
    tgt = torch.cat([targets, targets.new_zeros(B, 1)], 1).long()  # [B, U1]
    label = lp.gather(3, tgt[:, None, :, None].expand(B, T, U1, 1))[..., 0].double()
    blank = lp[..., V1 - 1].double()
    step_blank = blank[..., None] + lp_dur  # [B, T, U1, D]: leave (t, u) by a blank
    step_token = label[..., None] + lp_dur  # ... by the label u + 1
    # the duration-0 tokens of a row: a_u = label[t, u-1] + lp_dur[t, u-1, 0]
    # for u >= 1; A its cumulative sum (A_0 = 0)
    A = F.pad(step_token[..., :-1, 0].cumsum(2), (1, 0))  # [B, T, U1]
    # the steps of each duration d >= 1 that land on frame t: [n, B, T, U1],
    # -1e30 where t - d < 0 (so the loop reads plain slices, and launches no copy)
    moves = [(i, d) for i, d in enumerate(durations) if d >= 1]

    def landing(step: torch.Tensor) -> torch.Tensor:
        return torch.stack([F.pad(step[:, :max(T - d, 0), :, i], (0, 0, min(d, T), 0),
                                  value=NEG_INF) for i, d in moves])

    land_blank, land_token = landing(step_blank), landing(step_token)

    def row(t: int, base: torch.Tensor) -> torch.Tensor:
        return A[:, t] + torch.logcumsumexp(base - A[:, t], -1)

    base0 = torch.full((B, U1), NEG_INF, dtype=torch.float64, device=lp.device)
    base0[:, 0] = 0.0
    alphas = [row(0, base0)]
    none = torch.full_like(base0, NEG_INF)  # alpha before frame 0
    for t in range(1, T):
        hist = torch.stack([alphas[t - d] if d <= t else none for _, d in moves])  # alpha[t - d]
        blanks = hist + land_blank[:, :, t]  # [n, B, U1]
        tokens = _shift_u(hist + land_token[:, :, t])
        alphas.append(row(t, torch.logsumexp(torch.cat([blanks, tokens]), 0)))
    alpha = torch.stack(alphas, 1)  # [B, T, U1]
    rows = torch.arange(B, device=lp.device)
    t, u = f_len.to(lp.device).long() - 1, t_len.to(lp.device).long()
    exit_dur = torch.logsumexp(lp_dur[rows, t, u][:, 1:], -1)  # leave by a blank of d >= 1
    return -(alpha[rows, t, u] + blank[rows, t, u] + exit_dur).float()


def tdt_greedy_decode(joint_fn: Callable, pred_step_fn: Callable, initial_state,
                      enc: torch.Tensor, enc_len: torch.Tensor, blank: int,
                      durations: Sequence[int] = (0, 1, 2, 3, 4), max_steps_factor: int = 2
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Frame-skipping greedy decode, batched: a loop evaluates the joint
    (`joint_fn(enc_t, pred_out)` → (token logits [B, V+1], duration logits
    [B, D])) once for the whole batch at each row's frame; a row that emits
    a token advances its prediction net, and every active row jumps by its
    argmax duration (a blank by at least 1 frame). No max_symbols: a
    duration 0 keeps the row at its frame.

    JAX's loop runs while any row has frames left, at most max_steps_factor
    · T times. Here the host reads that condition every `CHECK_EVERY` loops
    (each read waits for the card): a loop after every row is done writes
    nothing, so the tokens are the same, and the cap is the same (the
    period is modules/rnnt.py's, read at each call). Returns
    (tokens [B, max_steps_factor · T] int32 padded with −1, counts [B]
    int32, the number of loops run)."""
    durations = _check_durations(durations)
    B, T, _ = enc.shape
    dev = enc.device
    durs = torch.tensor(durations, device=dev)
    max_steps = T * max_steps_factor
    frames = enc.reshape(B * T, -1)
    first = torch.arange(B, device=dev) * T  # row b's frame t is frames[first[b] + t]
    enc_len = enc_len.to(dev).long()
    buf = torch.full((B, max_steps + 1), -1, dtype=torch.long, device=dev)
    t = torch.zeros(B, dtype=torch.long, device=dev)
    counts = torch.zeros_like(t)
    pred_out, state = pred_step_fn(torch.full((B,), -1, dtype=torch.long, device=dev),
                                   initial_state)
    it = 0
    while it < max_steps:
        if it % _rnnt.CHECK_EVERY == 0 and not bool((t < enc_len).any()):
            break
        tok_logits, dur_logits = joint_fn(frames.index_select(0, first + t.clamp(max=T - 1)),
                                          pred_out)
        k = tok_logits.argmax(-1)
        d = durs[dur_logits.argmax(-1)]
        active = t < enc_len
        emit = active & (k != blank)
        # a row that does not emit writes the spare last column
        buf.scatter_(1, torch.where(emit, counts, max_steps)[:, None], k[:, None])
        counts += emit
        new_out, new_state = pred_step_fn(torch.where(emit, k, 0), state)
        pred_out = torch.where(emit[:, None], new_out, pred_out)
        state = _rnnt._select(emit, new_state, state)
        d = torch.where(k == blank, d.clamp(min=1), d)  # a blank advances at least 1 frame
        t = torch.where(active, t + d, t)
        it += 1
    return buf[:, :max_steps].int(), counts.int(), it
