"""CTC head (counterpart of nemo_tpu/models/asr/modules/conv_asr.py:ConvASRDecoder)."""

from __future__ import annotations

import torch
import torch.nn as nn


class ConvASRDecoder(nn.Module):
    """1×1 projection → per-frame log-probs over vocab + blank, in fp32.
    Blank is the LAST index (num_classes)."""

    def __init__(self, feat_in: int, num_classes: int):
        super().__init__()
        self.proj = nn.Linear(feat_in, num_classes + 1)
        self.proj.jax_conv1x1 = True  # a 1x1 Conv in the JAX tree: kernel [1, in, out]

    def forward(self, encoder_output: torch.Tensor) -> torch.Tensor:
        """[B, C, T] → [B, T, V+1] log-probs."""
        x = encoder_output.transpose(1, 2).float()
        return torch.log_softmax(self.proj(x), dim=-1)
