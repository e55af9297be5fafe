"""Packed sequences: first-fit bin packing into rows of segment ids (a copy
of nemo_tpu/data/packed_sequence.py, numpy only).

Several short samples share one row of `bin_size` tokens; each token carries
the 1-based id of its sample (0 = padding) and its position inside the
sample. The attention mask is then (segment_i == segment_j) & causal, which
the packed flash kernels (K8-K10, `ops/flash_attention.py:
flash_attention_packed`) take without ragged shapes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def first_fit_pack(lengths: Sequence[int], bin_size: int) -> List[List[int]]:
    """Pack sample indices into bins of capacity bin_size, first-fit over
    the samples in decreasing length; samples longer than a bin are
    dropped."""
    order = np.argsort(lengths)[::-1]
    bins: List[List[int]] = []
    space: List[int] = []
    for i in order:
        L = lengths[i]
        if L > bin_size:
            continue
        for b, s in enumerate(space):
            if s >= L:
                bins[b].append(int(i))
                space[b] -= L
                break
        else:
            bins.append([int(i)])
            space.append(bin_size - L)
    return bins


def pack_batch(sequences: List[np.ndarray], labels: List[np.ndarray],
               loss_masks: List[np.ndarray], bin_size: int) -> Dict[str, np.ndarray]:
    """Pack variable-length samples into [n_bins, bin_size] arrays: tokens,
    labels, loss_mask (0 on padding), segment_ids (1-based, 0 = padding) and
    positions (from 0 in each sample)."""
    lengths = [len(s) for s in sequences]
    bins = first_fit_pack(lengths, bin_size)
    n = len(bins)
    tokens = np.zeros((n, bin_size), np.int32)
    labs = np.zeros((n, bin_size), np.int32)
    lmask = np.zeros((n, bin_size), np.float32)
    seg = np.zeros((n, bin_size), np.int32)
    pos = np.zeros((n, bin_size), np.int32)
    for b, idxs in enumerate(bins):
        off = 0
        for s_id, i in enumerate(idxs, start=1):
            L = lengths[i]
            tokens[b, off:off + L] = sequences[i]
            labs[b, off:off + L] = labels[i]
            lmask[b, off:off + L] = loss_masks[i]
            seg[b, off:off + L] = s_id
            pos[b, off:off + L] = np.arange(L)
            off += L
    return {"tokens": tokens, "labels": labs, "loss_mask": lmask, "segment_ids": seg,
            "positions": pos}
