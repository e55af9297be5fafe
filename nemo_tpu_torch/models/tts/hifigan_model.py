"""HiFi-GAN vocoder, inference (counterpart of
nemo_tpu/models/tts/hifigan_model.py:HifiGanModel; its GAN training waits
for a later slice, ROADMAP A3).

    voc = HifiGanModel()                          # V1, 80 mels, 22,050 Hz
    audio = voc.convert_spectrogram_to_audio(mel)  # [B, frames · 256]
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn

from nemo_tpu_torch.core.config import ConfigDict
from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.models.asr.ctc_models import init_weights
from nemo_tpu_torch.models.tts.modules.hifigan import Generator

_GAN_TRAINING = ("HiFi-GAN's GAN training (discriminators, losses, the two-optimizer step) "
                 "is not ported (ROADMAP A3)")


class HifiGanModel(nn.Module):
    """Config keys as JAX's: sample_rate, n_mels and a `generator` mapping
    (upsample_rates, upsample_kernel_sizes, upsample_initial_channel,
    resblock_kernel_sizes, resblock_dilation_sizes; HiFi-GAN V1 by
    default). `device=None` means CUDA (and raises without it)."""

    def __init__(self, cfg: Optional[dict] = None,
                 device: Union[str, torch.device, None] = None, seed: int = 0):
        super().__init__()
        cfg = ConfigDict(cfg or {})
        device = resolve_device(device)
        self.cfg = cfg
        self.sample_rate = int(cfg.get("sample_rate", 22050))
        self.n_mels = int(cfg.get("n_mels", 80))
        g = cfg.get("generator", ConfigDict())
        self.generator = Generator(
            n_mels=self.n_mels,
            upsample_rates=tuple(g.get("upsample_rates", (8, 8, 2, 2))),
            upsample_kernel_sizes=tuple(g.get("upsample_kernel_sizes", (16, 16, 4, 4))),
            upsample_initial_channel=int(g.get("upsample_initial_channel", 512)),
            resblock_kernel_sizes=tuple(g.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilation_sizes=tuple(tuple(d) for d in g.get(
                "resblock_dilation_sizes", ((1, 3, 5), (1, 3, 5), (1, 3, 5)))),
        )
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    @property
    def hop_length(self) -> int:
        return math.prod(self.generator.upsample_rates)

    @torch.inference_mode()
    def convert_spectrogram_to_audio(self, spec: torch.Tensor) -> torch.Tensor:
        """[B, n_mels, T] → [B, T · hop_length] waveform in [-1, 1]; a mel of
        0 frames raises ValueError."""
        return self.generator(spec.to(self.generator.pre.weight.device, torch.float32))

    def init_train(self, seed: int = 0):
        raise NotImplementedError(_GAN_TRAINING)

    def train_step_fns(self):
        raise NotImplementedError(_GAN_TRAINING)
