"""CTC ASR model: Conformer-CTC transcription (counterpart of
nemo_tpu/models/asr/ctc_models.py:EncDecCTCModel).

PCM → mel (ops/audio.py) → ConformerEncoder → ConvASRDecoder log-softmax →
argmax on the device → CTC collapse on the host → text. Transcription is
pipelined: batch i is launched before batch i−1's ids are collapsed on the
host, and only the [B, T'] int32 ids and the lengths leave the device.
`ASRModel` holds what the CTC and RNNT models share.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from nemo_tpu_torch.core.config import ConfigDict
from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.data.audio_io import read_wav
from nemo_tpu_torch.models.asr.modules.conformer import ConformerEncoder, subsampled_length
from nemo_tpu_torch.models.asr.modules.conv_asr import ConvASRDecoder
from nemo_tpu_torch.models.asr.parts.ctc_decoding import CTCDecoding
from nemo_tpu_torch.ops.audio import (MelSpectrogramConfig, build_mel_constants,
                                      mel_seq_len, mel_spectrogram, pcm_to_float)
from nemo_tpu_torch.ops.ctc import ctc_collapse, ctc_greedy_predictions


def _mel_cfg_from(cfg) -> MelSpectrogramConfig:
    names = {f.name for f in dataclasses.fields(MelSpectrogramConfig)}
    return MelSpectrogramConfig(**{k: v for k, v in dict(cfg or {}).items() if k in names})


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: lecun-normal weights, zero biases, unit norms, BatchNorm
    running stats at mean 0 / var 1. Parameters keep their dtype."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
                val = torch.ones if name == "weight" else torch.zeros
                p.data.copy_(val(p.shape))
            elif name == "bias" or name.startswith("pos_bias"):
                p.data.zero_()
            else:
                w = torch.empty(p.shape, dtype=torch.float32)
                if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
                    fan_in = p[0].numel()
                elif isinstance(mod, nn.ConvTranspose1d):  # [in, out, k]
                    fan_in = p.shape[0] * p.shape[2]
                else:
                    fan_in = p.shape[-1] if isinstance(mod, nn.Linear) else p.shape[0]
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                p.data.copy_(w)
        if isinstance(mod, nn.BatchNorm1d):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)


class ASRModel(nn.Module):
    """What the CTC and RNNT models share: the labels, the mel frontend, the
    encoder, host→device uploads and the pipelined transcription. A subclass
    builds its head, then calls `_finish_init`, and defines `_launch(signal,
    length, n)` (enqueue one batch, start copying its result to the host)
    and `_collect(pending)` (wait for that copy, return the batch's texts)."""

    def _init_frontend(self, cfg: ConfigDict) -> dict:
        """Config, sample rate, mel config and labels; returns the encoder's
        keyword arguments."""
        self.cfg = cfg
        self.sample_rate = int(cfg.get("sample_rate", 16000))
        self.mel_cfg = _mel_cfg_from(cfg.get("preprocessor", {}))
        labels = cfg.get("labels") or cfg.get("decoder", {}).get("vocabulary")
        if labels is None:
            raise ValueError("config must provide labels / decoder.vocabulary")
        self.labels = list(labels)
        enc_cfg = dict(cfg.encoder)
        enc_cfg.setdefault("feat_in", self.mel_cfg.features)
        return enc_cfg

    def _finish_init(self, device: torch.device) -> None:
        for i, c in enumerate(build_mel_constants(self.mel_cfg)):
            self.register_buffer(f"mel_const{i}", torch.from_numpy(c), persistent=False)
        self.eval()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.mel_const0.device

    def mel_features(self, signal: torch.Tensor, length: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mel frontend: (feats [B, n_mels, F] fp32, frame lengths [B])."""
        consts = (self.mel_const0, self.mel_const1, self.mel_const2)
        return mel_spectrogram(pcm_to_float(signal), length, self.mel_cfg, consts)

    def encoded_length(self, samples: torch.Tensor) -> torch.Tensor:
        """Encoder frames for `samples` audio samples (mel hop, then the
        subsampling), without running the model."""
        return subsampled_length(mel_seq_len(self.mel_cfg, samples),
                                 self.encoder.pre_encode.n_layers)

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → the model's device; to CUDA through pinned memory, so
        the copy does not wait for the batch in flight."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, *tensors: torch.Tensor):
        """Start copying `tensors` to the host: (host tensors, the event to
        wait for, or None on the CPU)."""
        if tensors[0].device.type != "cuda":
            return tensors, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _pipeline(self, batches: Iterable[Tuple[torch.Tensor, torch.Tensor, int]]) -> List[str]:
        """Batch i is launched before batch i−1's results are turned into
        text on the host."""
        results: List[str] = []
        pending = None
        for sig, lens, n in batches:
            launched = self._launch(sig, lens, n)
            if pending is not None:
                results.extend(self._collect(pending))
            pending = launched
        if pending is not None:
            results.extend(self._collect(pending))
        return results

    def transcribe_staged(self, staged: Iterable[Tuple[torch.Tensor, torch.Tensor, int]]
                          ) -> List[str]:
        """Transcription over device-resident PCM batches.

        staged: (signal [B, T] int16/f32 on the model's device, lengths [B]
        on the device, n_valid) per batch. Runs the pipeline of `transcribe`
        without the host→device upload."""
        return self._pipeline(staged)

    def transcribe(self, audio: Sequence[Union[str, np.ndarray]],
                   batch_size: int = 4) -> List[str]:
        """Wav paths or float arrays → texts. Wav inputs ship as int16 PCM;
        each batch is padded to a power-of-two sample count (`_bucket`)."""
        return self._pipeline(self._padded_batches(audio, batch_size))

    def _padded_batches(self, audio: Sequence[Union[str, np.ndarray]], batch_size: int):
        for start in range(0, len(audio), batch_size):
            batch = audio[start: start + batch_size]
            sigs, all_i16 = [], True
            for a in batch:
                if isinstance(a, str):
                    x, _ = read_wav(a, target_sr=self.sample_rate)
                else:
                    x = np.asarray(a, np.float32)
                    all_i16 = False
                sigs.append(x)
            lens = np.array([len(s) for s in sigs], np.int32)
            pad_len = _bucket(int(lens.max()))
            dtype = np.int16 if all_i16 else np.float32
            padded = np.zeros((batch_size, pad_len), dtype)
            for i, s in enumerate(sigs):
                if dtype == np.int16:
                    s = np.clip(np.rint(s * 32768.0), -32768, 32767).astype(np.int16)
                padded[i, : len(s)] = s
            full_lens = np.ones(batch_size, np.int32)
            full_lens[: len(sigs)] = lens
            yield self.upload(padded), self.upload(full_lens), len(sigs)


class EncDecCTCModel(ASRModel):
    """Conformer-CTC model from a config of `models/asr/configs.py:conformer_ctc`.

    `device=None` means CUDA (and raises without it); `device="cpu"` runs the
    plain versions of the kernels. Weights are initialised from `seed` with a
    `torch.Generator` on the host, so the same seed gives the same weights on
    every device; `interop/jax_params.py:load_jax_variables` replaces them."""

    def __init__(self, cfg: ConfigDict, device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        enc_cfg = self._init_frontend(ConfigDict(cfg))
        d_enc = int(self.cfg.get("decoder", {}).get("feat_in") or enc_cfg["d_model"])
        with torch.random.fork_rng(devices=[]):  # default inits must not move the global RNG
            self.encoder = ConformerEncoder(**enc_cfg)
            self.decoder = ConvASRDecoder(d_enc, len(self.labels))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.decoding = CTCDecoding(self.labels)
        self._finish_init(device)

    @torch.inference_mode()
    def forward(self, signal: torch.Tensor, length: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] int16 PCM or float audio, [B] sample counts →
        (log_probs [B, T', V+1] fp32, frame lengths [B])."""
        return self.log_probs(signal, length, conv_pair_subsampling=False)

    def log_probs(self, signal: torch.Tensor, length: torch.Tensor, *,
                  conv_pair_subsampling: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """`forward` with autograd (the counterpart of JAX's
        `model.net.apply(variables, feats, feat_len)` after the mel frontend
        with `training=False`). `conv_pair_subsampling=True` runs the
        subsampling through the conv pair even with `fused_subsampling` set,
        as a training forward must: the fused kernel has no backward."""
        feats, feat_len = self.mel_features(signal, length)
        enc, enc_len = self.encoder(feats, feat_len, conv_pair_subsampling=conv_pair_subsampling)
        return self.decoder(enc), enc_len

    def _launch(self, signal: torch.Tensor, length: torch.Tensor, n: int):
        """Enqueue forward + argmax; start copying the ids to the host.
        Returns what `_collect` needs to finish the batch."""
        log_probs, enc_len = self.forward(signal, length)
        ids = ctc_greedy_predictions(log_probs)
        (ids, enc_len), done = self._to_host(ids, enc_len)
        return ids, enc_len, done, n

    def _collect(self, pending) -> List[str]:
        """Wait for one launched batch's ids only, then collapse on the host."""
        ids, lens, done, n = pending
        if done is not None:
            done.synchronize()
        id_lists = ctc_collapse(ids[:n].numpy(), lens[:n].numpy(), blank=self.decoding.blank_id)
        return [self.decoding.ids_to_text(x) for x in id_lists]


def _bucket(n: int, minimum: int = 16000) -> int:
    """Pad target: next power of two ≥ n."""
    return max(minimum, 2 ** math.ceil(math.log2(max(n, 1))))
