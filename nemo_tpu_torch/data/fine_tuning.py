"""The SFT data module (counterpart of nemo_tpu/data/fine_tuning.py:
FineTuningDataModule): a jsonl of {"input", "output"} examples through a
prompt template and a tokenizer, answer-only loss, optionally packed.

    dm = FineTuningDataModule("sft.jsonl", tokenizer, seq_length=2048,
                              global_batch_size=8, packed=True)
    batch = next(dm.train_batches())  # [8, 2048] each

The tokenizer is duck-typed as in the JAX package: `text_to_ids(str) ->
list[int]` and an optional `eos_id`. Each epoch visits the examples in an
order drawn from `seed`; a packed epoch packs all of them (first-fit,
`data/packed_sequence.py:pack_batch`) and yields its rows GBS at a time,
an unpacked one pads each example to `seq_length`. Batches are torch CPU
tensors (int32 tokens, labels, segment_ids, positions; float32 loss_mask)
with the JAX module's values.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from nemo_tpu_torch.data.packed_sequence import pack_batch

DEFAULT_PROMPT_TEMPLATE = "{input} {output}"


class FineTuningDataModule:
    def __init__(self, path: str, tokenizer, seq_length: int, global_batch_size: int,
                 prompt_template: str = DEFAULT_PROMPT_TEMPLATE, packed: bool = False,
                 answer_only_loss: bool = True, seed: int = 0):
        self.tokenizer = tokenizer
        self.seq_length = seq_length
        self.global_batch_size = global_batch_size
        self.micro_batch_size = None
        self.packed = packed
        self.answer_only_loss = answer_only_loss
        self.seed = seed
        self.prompt_template = prompt_template
        with open(path) as f:
            self.examples = [json.loads(line) for line in f if line.strip()]

    def _encode(self, ex: Dict) -> Optional[Dict[str, np.ndarray]]:
        """One example → tokens, labels (the tokens shifted by one) and the
        loss mask (0 on the prompt when answer_only_loss), at most
        seq_length long; None for an example of fewer than 2 tokens."""
        prompt = self.prompt_template.split("{output}")[0].format(**ex).rstrip()
        full = self.prompt_template.format(**ex)
        p_ids = self.tokenizer.text_to_ids(prompt)
        f_ids = self.tokenizer.text_to_ids(full)
        eos = getattr(self.tokenizer, "eos_id", None)
        if eos is not None and eos >= 0:
            f_ids = f_ids + [eos]
        if len(f_ids) < 2:
            return None
        f_ids = f_ids[: self.seq_length + 1]
        tokens = np.asarray(f_ids[:-1], np.int32)
        labels = np.asarray(f_ids[1:], np.int32)
        mask = np.ones(len(tokens), np.float32)
        if self.answer_only_loss:
            mask[: max(len(p_ids) - 1, 0)] = 0.0  # labels of prompt tokens
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def train_batches(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches from step `start_step` on, without end."""
        rng = np.random.RandomState(self.seed)
        B, S = self.global_batch_size, self.seq_length
        step = 0
        while True:
            order = rng.permutation(len(self.examples))
            encs = [e for e in (self._encode(self.examples[i]) for i in order) if e is not None]
            if self.packed:
                packed = pack_batch([e["tokens"] for e in encs], [e["labels"] for e in encs],
                                    [e["loss_mask"] for e in encs], S)
                groups = [{k: v[i:i + B] for k, v in packed.items()}
                          for i in range(0, packed["tokens"].shape[0] - B + 1, B)]
            else:
                groups = []
                for i in range(0, len(encs) - B + 1, B):
                    g = {"tokens": np.zeros((B, S), np.int32),
                         "labels": np.zeros((B, S), np.int32),
                         "loss_mask": np.zeros((B, S), np.float32)}
                    for b, e in enumerate(encs[i:i + B]):
                        L = min(len(e["tokens"]), S)
                        for key in g:
                            g[key][b, :L] = e[key][:L]
                    groups.append(g)
            for g in groups:
                if step >= start_step:
                    yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in g.items()}
                step += 1
