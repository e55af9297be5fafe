"""HiFi-GAN generator (counterpart of the Generator of
nemo_tpu/models/tts/modules/hifigan.py; its discriminators and losses wait
for the GAN-training slice, ROADMAP A3).

pre-conv → per upsampling stage: leaky ReLU → transposed conv (×r) → the
mean of the multi-receptive-field ResBlocks → leaky ReLU → post-conv → tanh.
The convolutions are torch ops, as they are XLA ops in JAX.

flax's ConvTranspose (VALID, then cropped by (k - r) // 2 at both ends)
equals `nn.ConvTranspose1d(padding=(k - r) // 2)` with the kernel flipped
along k: `interop/jax_params.py` flips it both ways.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class ResBlock1(nn.Module):
    """Per dilation d: x + c2(lrelu(c1_d(lrelu(x)))), children c1_{i}, c2_{i}."""

    def __init__(self, channels: int, kernel: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"c1_{i}", nn.Conv1d(channels, channels, kernel, dilation=d,
                                                 padding=(kernel - 1) * d // 2))
            self.add_module(f"c2_{i}", nn.Conv1d(channels, channels, kernel,
                                                 padding=(kernel - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = getattr(self, f"c1_{i}")(lrelu(x))
            x = x + getattr(self, f"c2_{i}")(lrelu(h))
        return x


class Generator(nn.Module):
    """Mel [B, n_mels, T] → waveform [B, T · prod(upsample_rates)]. The
    defaults are HiFi-GAN V1."""

    def __init__(self, n_mels: int = 80, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.n_stages, self.n_res = len(upsample_rates), len(resblock_kernel_sizes)
        self.pre = nn.Conv1d(n_mels, upsample_initial_channel, 7, padding=3)
        ch = upsample_initial_channel
        for i, (r, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            self.add_module(f"up{i}", nn.ConvTranspose1d(ch, ch // 2, k, stride=r,
                                                         padding=(k - r) // 2))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
                self.add_module(f"res{i}_{j}", ResBlock1(ch, rk, tuple(rd)))
        self.post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        if mel.shape[-1] == 0:
            # JAX's VALID transposed convolutions make samples of nothing
            # here (ROADMAP C); the port refuses
            raise ValueError("HiFi-GAN: a mel of 0 frames has no audio")
        x = self.pre(mel)
        for i in range(self.n_stages):
            x = getattr(self, f"up{i}")(lrelu(x))
            acc = getattr(self, f"res{i}_0")(x)
            for j in range(1, self.n_res):
                acc = acc + getattr(self, f"res{i}_{j}")(x)
            x = acc / self.n_res
        return torch.tanh(self.post(lrelu(x)))[:, 0]
