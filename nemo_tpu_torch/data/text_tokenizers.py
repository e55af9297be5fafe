"""Character tokenizers for TTS (counterpart of the part of
nemo_tpu/data/text_tokenizers.py that FastPitch uses: `CharTokenizer` and
`EnglishCharsTTSTokenizer`)."""

from __future__ import annotations

from typing import List, Optional, Sequence


class CharTokenizer:
    """One id a character of `vocab`. An unknown character maps to `unk`'s
    id, or is dropped where `unk` is None."""

    def __init__(self, vocab: Sequence[str], unk: Optional[str] = None):
        self.vocab = list(vocab)
        self._stoi = {c: i for i, c in enumerate(self.vocab)}
        self.unk = unk

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def text_to_ids(self, text: str) -> List[int]:
        ids = []
        for c in text:
            if c in self._stoi:
                ids.append(self._stoi[c])
            elif self.unk is not None:
                ids.append(self._stoi[self.unk])
        return ids

    def ids_to_text(self, ids: Sequence[int]) -> str:
        return "".join(self.vocab[i] for i in ids)


class EnglishCharsTTSTokenizer(CharTokenizer):
    """40 symbols: `<pad>` (id 0), a-z, the punctuation `!'"(),.:;?- `
    and `<blank>` (id 39). Text is lowercased first; other characters are
    dropped."""

    PUNCT = "!'\"(),.:;?- "

    def __init__(self):
        chars = [chr(ord("a") + i) for i in range(26)]
        vocab = ["<pad>"] + chars + list(self.PUNCT) + ["<blank>"]
        super().__init__(vocab)
        self.pad_id = 0
        self.blank_id = len(vocab) - 1

    def text_to_ids(self, text: str) -> List[int]:
        return super().text_to_ids(text.lower())
