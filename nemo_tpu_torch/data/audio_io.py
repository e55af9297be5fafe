"""WAV reading and writing with `wave` and numpy (copies of
nemo_tpu.data.audio_io.read_wav, write_wav and resample_linear)."""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Returns (float32 mono samples [T] in [-1, 1], sample_rate); multichannel
    files are downmixed, and `target_sr` resamples linearly."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32))
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if target_sr is not None and target_sr != sr:
        x = resample_linear(x, sr, target_sr)
        sr = target_sr
    return x, sr


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """samples: [T] mono or [T, C] float32 in [-1, 1] → 16-bit PCM; the
    clipped samples times 32767 are truncated toward zero."""
    x = np.clip(samples, -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if x.ndim == 1 else x.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.linspace(0.0, len(x) - 1.0, n_out)
    return np.interp(t_out, np.arange(len(x)), x).astype(np.float32)
