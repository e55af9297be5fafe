"""Mel frontend on the device (counterpart of nemo_tpu/ops/audio.py).

STFT → power → mel → log → per-feature normalisation, with the STFT computed
as a chunked real-DFT matmul over hop-sized, non-overlapping chunks of the
signal, all in full fp32. The filterbank, window and DFT bases are numpy
constants built once (`build_mel_constants`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CONSTANT = 1e-5  # normalization epsilon, matches reference features.py


def _hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    logs = min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, logs, mels)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] slaney-normalized triangular mel filterbank."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm.reshape(-1, 1)
    return fb.astype(np.float32)


def hann_window(win_length: int, periodic: bool = False) -> np.ndarray:
    """torch.hann_window(win_length, periodic=False) equivalent."""
    if win_length == 1:
        return np.ones(1, np.float32)
    n = win_length if periodic else win_length - 1
    k = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def real_dft_matrices(n_fft: int, window: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases [n_fft, n_freq] for the cos and -sin parts;
    the window is zero-padded to n_fft, centered, and folded in."""
    n_freq = n_fft // 2 + 1
    w = np.zeros(n_fft, np.float64)
    off = (n_fft - len(window)) // 2
    w[off : off + len(window)] = window
    t = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_freq).reshape(1, -1)
    ang = 2.0 * np.pi * t * k / n_fft
    cos = (np.cos(ang) * w.reshape(-1, 1)).astype(np.float32)
    sin = (-np.sin(ang) * w.reshape(-1, 1)).astype(np.float32)
    return cos, sin


@dataclasses.dataclass(frozen=True)
class MelSpectrogramConfig:
    """Mirrors AudioToMelSpectrogramPreprocessor's constructor contract."""

    sample_rate: int = 16000
    window_size: float = 0.02  # seconds
    window_stride: float = 0.01  # seconds
    n_window_size: Optional[int] = None
    n_window_stride: Optional[int] = None
    features: int = 80  # n_mels
    n_fft: Optional[int] = None
    window: str = "hann"
    normalize: str = "per_feature"  # per_feature | all_features | none
    preemph: Optional[float] = 0.97
    dither: float = 1e-5
    lowfreq: float = 0.0
    highfreq: Optional[float] = None
    log: bool = True
    log_zero_guard_type: str = "add"  # add | clamp
    log_zero_guard_value: float = 2.0**-24
    mag_power: float = 2.0
    pad_to: int = 16
    pad_value: float = 0.0
    frame_splicing: int = 1

    @property
    def win_length(self) -> int:
        return self.n_window_size or int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return self.n_window_stride or int(self.window_stride * self.sample_rate)

    @property
    def fft_length(self) -> int:
        return self.n_fft or 2 ** math.ceil(math.log2(self.win_length))


def mel_seq_len(cfg: MelSpectrogramConfig, length: torch.Tensor) -> torch.Tensor:
    """Output frame count for input sample count (center=True):
    floor((len + 2*(n_fft//2) - n_fft) / hop) + 1."""
    pad = 2 * (cfg.fft_length // 2)
    return torch.div(length + pad - cfg.fft_length, cfg.hop_length,
                     rounding_mode="floor") + 1


def build_mel_constants(cfg: MelSpectrogramConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos [n_fft, n_freq], sin [n_fft, n_freq], mel_fb^T [n_freq, n_mels])."""
    win = hann_window(cfg.win_length, periodic=False)
    cos, sin = real_dft_matrices(cfg.fft_length, win)
    fb = mel_filterbank(cfg.sample_rate, cfg.fft_length, cfg.features,
                        cfg.lowfreq, cfg.highfreq).T
    return cos, sin, np.ascontiguousarray(fb)


def pcm_to_float(signal: torch.Tensor) -> torch.Tensor:
    """int16 PCM → float32 in [-1, 1) (exact); float input is cast to fp32."""
    if signal.dtype == torch.int16:
        return signal.to(torch.float32) / 32768.0
    return signal.to(torch.float32)


def mel_spectrogram(
    signal: torch.Tensor,
    length: torch.Tensor,
    cfg: MelSpectrogramConfig = MelSpectrogramConfig(),
    constants: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] float audio, [B] sample lengths → ([B, n_mels, F], [B] frame lens).

    Inference only (no dither). `constants` are `build_mel_constants(cfg)`
    as tensors on the signal's device; the model keeps them as buffers so
    that no host→device copy sits in the pipelined path."""
    if constants is None:
        constants = tuple(torch.from_numpy(c).to(signal.device)
                          for c in build_mel_constants(cfg))
    cos, sin, fbT = constants
    x = signal.to(torch.float32)
    B, T = x.shape
    n_fft, hop = cfg.fft_length, cfg.hop_length

    if cfg.preemph is not None:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)

    # center=True reflect padding (torch.stft's default)
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]

    # Chunked DFT: frame j is rows j..j+n_chunks of the hop-strided signal
    # matrix, so the windowed DFT is a sum of matmuls over non-overlapping data.
    Tp = x.shape[1]
    n_frames = (Tp - n_fft) // hop + 1
    n_chunks = -(-n_fft // hop)
    rows = n_frames + n_chunks - 1
    need = rows * hop
    if need > Tp:
        x = F.pad(x, (0, need - Tp))
    X2d = x[:, :need].reshape(B, rows, hop)
    n_freq = cos.shape[1]
    re = torch.zeros((B, n_frames, n_freq), dtype=torch.float32, device=x.device)
    im = torch.zeros_like(re)
    for j in range(n_chunks):
        w = min(hop, n_fft - j * hop)
        Xj = X2d[:, j : j + n_frames, :w]
        re = re + Xj @ cos[j * hop : j * hop + w]
        im = im + Xj @ sin[j * hop : j * hop + w]
    power = re * re + im * im  # |STFT|^2
    if cfg.mag_power != 2.0:
        power = torch.pow(torch.sqrt(power), cfg.mag_power)

    mel = power @ fbT  # [B, F, n_mels]
    if cfg.log:
        if cfg.log_zero_guard_type == "add":
            mel = torch.log(mel + cfg.log_zero_guard_value)
        else:
            mel = torch.log(torch.clamp(mel, min=cfg.log_zero_guard_value))
    mel = mel.transpose(1, 2)  # [B, n_mels, F]

    if cfg.frame_splicing > 1:
        parts = [mel]
        for n in range(1, cfg.frame_splicing):
            parts.append(torch.cat([mel[:, :, :n], mel[:, :, :-n]], dim=2))
        mel = torch.cat(parts, dim=1)

    out_len = mel_seq_len(cfg, length)
    n_frames = mel.shape[2]
    mask = (torch.arange(n_frames, device=mel.device)[None, :]
            < out_len[:, None]).to(torch.float32)  # [B, F]

    if cfg.normalize in ("per_feature", "all_features"):
        m = mask[:, None, :]
        dims = (2,) if cfg.normalize == "per_feature" else (1, 2)
        count = out_len.to(torch.float32)
        if cfg.normalize == "all_features":
            count = count * mel.shape[1]
        n_valid = torch.clamp(count, min=1.0)[:, None, None]
        mean = torch.sum(mel * m, dim=dims, keepdim=True) / n_valid
        var = torch.sum(torch.square(mel - mean) * m, dim=dims, keepdim=True) / torch.clamp(
            n_valid - 1.0, min=1.0)  # unbiased, matches torch .std()
        mel = (mel - mean) / (torch.sqrt(var) + CONSTANT)

    # zero out the padding region, then pad frames to a multiple of pad_to
    mel = mel * mask[:, None, :]
    if cfg.pad_to > 1:
        rem = (-n_frames) % cfg.pad_to
        if rem:
            mel = F.pad(mel, (0, rem), value=cfg.pad_value)
    return mel, out_len
