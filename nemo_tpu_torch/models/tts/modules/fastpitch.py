"""FastPitch modules (counterpart of nemo_tpu/models/tts/modules/fastpitch.py).

Symbol embedding → FFT encoder → duration and pitch predictors → pitch
embedding → length regulator → FFT decoder → mel projection. Activations
are [B, T, D] as in JAX; the convolutions run over [B, D, T] views. The
attention, the convolutions and the products are torch ops, as they are
XLA ops in JAX (no Pallas kernel lies on this path).

What must match JAX exactly: LayerNorm's eps is flax's 1e-6; masked scores
are -1e30 in fp32, not -inf, so that a query row with no valid key gets a
uniform softmax, as in JAX, and not NaN; the FF intermediate is zeroed at
padded frames; the length regulator gathers by searchsorted (right) over the
cumulative durations, clamped to U-1, so a static `max_mel_len` truncates
as JAX's does; a predicted duration is floor(clip(exp(log_dur) - 1, min,
max) / pace + 0.5) in fp32. Dropout draws from the `gen` it is given
(flax's semantics: keep with probability 1 - rate, scale by 1 / (1 - rate)).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """[max_len, dim] fp32, sin at even and cos at odd columns."""
    pos = np.arange(max_len, dtype=np.float32)
    inv = np.exp(np.arange(0, dim, 2, np.float32) * -(math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(pos[:, None] * inv[None])
    pe[:, 1::2] = np.cos(pos[:, None] * inv[None])
    return pe


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d over the time axis of [B, T, C]."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class FFTBlock(nn.Module):
    """Self-attention + conv feed-forward. norm_style "pre" (the default) or
    "post" (the reference layout: residual then LayerNorm, an o-projection
    without bias, the attention width n_heads · d_head apart from d_model)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, kernel_size: int = 3,
                 dropout: float = 0.1, norm_style: str = "pre", d_head: Optional[int] = None):
        super().__init__()
        self.n_heads, self.dh = n_heads, d_head or d_model // n_heads
        self.rate, self.post = dropout, norm_style == "post"
        width = n_heads * self.dh
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.q, self.k, self.v = (nn.Linear(d_model, width) for _ in range(3))
        self.o = nn.Linear(width, d_model, bias=not self.post)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        pad = (kernel_size - 1) // 2
        self.ff1 = nn.Conv1d(d_model, d_ff, kernel_size, padding=pad)
        self.ff2 = nn.Conv1d(d_ff, d_model, kernel_size, padding=pad)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, _ = x.shape
        H, dh = self.n_heads, self.dh
        valid = pad_mask[..., None]
        h = x if self.post else self.norm1(x)
        q, k, v = (lin(h).view(B, T, H, dh).transpose(1, 2) for lin in (self.q, self.k, self.v))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        scores = scores.masked_fill(~pad_mask[:, None, None, :], -1e30)
        probs = dropout(torch.softmax(scores, dim=-1), self.rate, train, gen)
        att = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * dh)
        att = dropout(self.o(att), self.rate, train, gen)
        if self.post:
            x = torch.where(valid, self.norm1(x + att), 0.0)
        else:
            x = x + att
        h = x if self.post else self.norm2(x)
        h = torch.relu(_conv(self.ff1, h))
        # zeroed at padded frames, so that ff2's boundary taps read zeros
        # whatever the padding (nemo_tpu's fastpitch.py:84-90)
        h = torch.where(valid, h, 0.0)
        if not self.post:  # the reference's CoreNet has no dropout between its convs
            h = dropout(h, self.rate, train, gen)
        h = dropout(_conv(self.ff2, h), self.rate, train, gen)
        x = self.norm2(x + h) if self.post else x + h
        return torch.where(valid, x, 0.0)


class FFTransformer(nn.Module):
    """Positions added, then `n_layers` FFT blocks (children `layer{i}`).
    pos_concat False: interleaved sin/cos; True: the reference's [sin, cos]
    halves, masked at padded frames."""

    def __init__(self, n_layers: int, d_model: int, n_heads: int, d_ff: int,
                 kernel_size: int = 3, dropout: float = 0.1, max_len: int = 4096,
                 norm_style: str = "pre", d_head: Optional[int] = None,
                 pos_concat: bool = False):
        super().__init__()
        self.rate, self.pos_concat = dropout, pos_concat
        if pos_concat:
            inv = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                            * -(math.log(10000.0) / d_model))
            ang = torch.arange(max_len, dtype=torch.float32)[:, None] * inv[None]
            pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
        else:
            pe = torch.from_numpy(sinusoidal_positions(max_len, d_model))
        self.register_buffer("pe", pe, persistent=False)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer{i}", FFTBlock(d_model, n_heads, d_ff, kernel_size, dropout,
                                                  norm_style, d_head))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        pe = self.pe[None, : x.shape[1]]
        if self.pos_concat:
            pe = torch.where(pad_mask[..., None], pe, 0.0)
        x = dropout(x + pe, self.rate, train, gen)
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, pad_mask, train, gen)
        return x


class TemporalPredictor(nn.Module):
    """Duration or pitch predictor: n_layers × [conv → ReLU → LayerNorm →
    dropout], then a linear to one value a symbol (0 at padded symbols)."""

    def __init__(self, d_in: int, filter_size: int = 256, kernel_size: int = 3,
                 dropout: float = 0.1, n_layers: int = 2):
        super().__init__()
        self.rate, self.n_layers = dropout, n_layers
        pad = (kernel_size - 1) // 2
        for i in range(n_layers):
            self.add_module(f"conv{i}", nn.Conv1d(d_in if i == 0 else filter_size, filter_size,
                                                  kernel_size, padding=pad))
            self.add_module(f"norm{i}", nn.LayerNorm(filter_size, eps=LN_EPS))
        self.fc = nn.Linear(filter_size, 1)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            h = torch.where(pad_mask[..., None], h, 0.0)
            h = torch.relu(_conv(getattr(self, f"conv{i}"), h))
            h = dropout(getattr(self, f"norm{i}")(h), self.rate, train, gen)
        return torch.where(pad_mask, self.fc(h)[..., 0], 0.0)


def regulate_length(durations: torch.Tensor, enc: torch.Tensor, max_mel_len: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat enc[:, u] durations[:, u] times along time, at the static
    length `max_mel_len` (frames past a row's total are 0, a total past
    `max_mel_len` is cut): (out [B, max_mel_len, D], mel_len [B]), mel_len
    being each row's total before the cut."""
    csum = torch.cumsum(durations.long(), dim=1)
    mel_len = csum[:, -1]
    t = torch.arange(max_mel_len, device=enc.device)
    # the source of frame t is #{u : csum[u] <= t}
    src = torch.searchsorted(csum, t.expand(csum.shape[0], -1).contiguous(), right=True)
    src = src.clamp_max(enc.shape[1] - 1)
    out = torch.gather(enc, 1, src[..., None].expand(-1, -1, enc.shape[2]))
    mask = t[None, :] < mel_len[:, None]
    return torch.where(mask[..., None], out, 0.0), mel_len


class FastPitchModule(nn.Module):
    """The whole FastPitch net; children and their parameters are named as
    the JAX module's variables (`interop/jax_params.py` carries them)."""

    def __init__(self, n_symbols: int, n_mels: int = 80, d_model: int = 384,
                 n_heads: int = 1, d_ff: int = 1536, enc_layers: int = 6, dec_layers: int = 6,
                 kernel_size: int = 3, dropout: float = 0.1, max_mel_len: int = 2048,
                 pitch_embedding_kernel: int = 3, min_token_duration: int = 0,
                 max_token_duration: int = 75, norm_style: str = "pre",
                 d_head: Optional[int] = None, pos_concat: bool = False,
                 predictor_filter_size: int = 256, predictor_kernel_size: int = 3,
                 predictor_n_layers: int = 2):
        super().__init__()
        self.n_symbols, self.n_mels, self.max_mel_len = n_symbols, n_mels, max_mel_len
        self.min_token_duration, self.max_token_duration = min_token_duration, max_token_duration
        fft = dict(n_heads=n_heads, d_ff=d_ff, kernel_size=kernel_size, dropout=dropout,
                   norm_style=norm_style, d_head=d_head, pos_concat=pos_concat)
        pred = dict(filter_size=predictor_filter_size, kernel_size=predictor_kernel_size,
                    dropout=dropout, n_layers=predictor_n_layers)
        self.symbol_emb = nn.Embedding(n_symbols, d_model)
        self.encoder = FFTransformer(enc_layers, d_model, **fft)
        self.duration_predictor = TemporalPredictor(d_model, **pred)
        self.pitch_predictor = TemporalPredictor(d_model, **pred)
        self.pitch_emb = nn.Conv1d(1, d_model, pitch_embedding_kernel,
                                   padding=(pitch_embedding_kernel - 1) // 2)
        self.decoder = FFTransformer(dec_layers, d_model, **fft)
        self.mel_proj = nn.Linear(d_model, n_mels)

    def _encode(self, tokens, token_len, durations, pitch, pace, train, gen):
        """Everything before the length regulator: (enc, durations,
        log_dur_pred, pitch_pred)."""
        U = tokens.shape[1]
        tok_mask = torch.arange(U, device=tokens.device)[None, :] < token_len[:, None]
        enc = self.encoder(self.symbol_emb(tokens), tok_mask, train, gen)
        log_dur_pred = self.duration_predictor(enc, tok_mask, train, gen)
        pitch_pred = self.pitch_predictor(enc, tok_mask, train, gen)
        use_pitch = pitch if pitch is not None else pitch_pred
        enc = enc + self.pitch_emb(use_pitch[:, None, :]).transpose(1, 2)
        if durations is not None:
            dur = durations
        else:
            dur = torch.clamp(torch.exp(log_dur_pred) - 1.0, float(self.min_token_duration),
                              float(self.max_token_duration))
            dur = torch.floor(dur / pace + 0.5)
            dur = torch.where(tok_mask, dur.clamp_min(0.0), 0.0).long()
        return enc, dur, log_dur_pred, pitch_pred

    def _decode(self, enc, dur, max_mel_len: int, train, gen):
        dec_in, mel_len = regulate_length(dur, enc, max_mel_len)
        mel_mask = torch.arange(max_mel_len, device=enc.device)[None, :] < mel_len[:, None]
        dec = self.decoder(dec_in, mel_mask, train, gen)
        return self.mel_proj(dec).transpose(1, 2), mel_len  # [B, n_mels, T]

    def forward(self, tokens: torch.Tensor, token_len: torch.Tensor, *,
                durations: Optional[torch.Tensor] = None, pitch: Optional[torch.Tensor] = None,
                pace: float = 1.0, train: bool = False, stage: str = "full",
                mel_max_len: Optional[int] = None, enc: Optional[torch.Tensor] = None,
                dur: Optional[torch.Tensor] = None, gen: Optional[torch.Generator] = None):
        """tokens [B, U], token_len [B]; `durations` and `pitch` [B, U] are
        the training targets. stage "full", "encode" (up to the regulator) or
        "decode" (from `enc` [B, U, D] and `dur` [B, U] at `mel_max_len`
        frames). `train` turns dropout on, drawing from `gen`."""
        max_len = mel_max_len or self.max_mel_len
        if stage == "decode":
            mel, mel_len = self._decode(enc, dur, max_len, train, gen)
            return {"mel": mel, "mel_len": mel_len}
        if stage not in ("full", "encode"):
            raise ValueError(f"unknown stage {stage!r}")
        enc, dur, log_dur_pred, pitch_pred = self._encode(tokens, token_len, durations, pitch,
                                                          pace, train, gen)
        if stage == "encode":
            return {"enc": enc, "durations": dur, "mel_len": dur.sum(dim=1),
                    "log_dur_pred": log_dur_pred, "pitch_pred": pitch_pred}
        mel, mel_len = self._decode(enc, dur, max_len, train, gen)
        return {"mel": mel, "mel_len": mel_len, "log_dur_pred": log_dur_pred,
                "pitch_pred": pitch_pred, "durations": dur}
