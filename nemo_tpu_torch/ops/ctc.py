"""CTC greedy decode pieces (counterpart of nemo_tpu/ops/ctc.py)."""

from __future__ import annotations

import numpy as np
import torch


def ctc_greedy_predictions(log_probs: torch.Tensor) -> torch.Tensor:
    """[B, T, V] → [B, T] int32 argmax token ids, on the tensor's device."""
    return torch.argmax(log_probs, dim=-1).to(torch.int32)


def ctc_collapse(predictions, lengths, blank: int) -> list:
    """Host-side collapse: dedup repeats then drop blanks → list of id lists.

    Takes numpy arrays (or CPU tensors); the collapse is vectorized numpy."""
    predictions = np.asarray(predictions)
    lengths = np.asarray(lengths)
    out = []
    for b in range(predictions.shape[0]):
        seq = predictions[b, : int(lengths[b])]
        keep = np.empty(len(seq), bool)
        if len(seq):
            keep[0] = True
            np.not_equal(seq[1:], seq[:-1], out=keep[1:])
            keep &= seq != blank
        out.append(seq[keep].astype(int).tolist())
    return out
