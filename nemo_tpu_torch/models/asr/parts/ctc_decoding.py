"""CTC decoding: token-id sequences → text (counterpart of
nemo_tpu/models/asr/parts/ctc_decoding.py)."""

from __future__ import annotations

from typing import List, Sequence


class CTCDecoding:
    """Greedy CTC decoding for char-vocab models (blank = last index)."""

    def __init__(self, vocabulary: Sequence[str]):
        self.vocabulary = list(vocabulary)
        self.blank_id = len(self.vocabulary)

    def ids_to_text(self, ids: List[int]) -> str:
        return "".join(self.vocabulary[i] for i in ids)
