"""FastPitch spectrogram generator (counterpart of
nemo_tpu/models/tts/fastpitch_model.py:FastPitchModel).

    m = FastPitchModel({"max_mel_len": 1024, "min_token_duration": 1})
    m.fit_synthetic(steps=40, batch=4, seq=48)   # bench.py:bench_tts's calibration
    mel = m.generate_spectrogram(m.parse("hello world"))   # [1, 80, frames]

Synthesis keeps JAX's two phases: the encoder and the duration predictor
run, the host reads the mel length, then the decoder runs at that length
(JAX's 128-frame buckets, which give XLA static shapes, are not ported).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from nemo_tpu_torch.core.config import ConfigDict
from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.core.optim import adam
from nemo_tpu_torch.data.text_tokenizers import EnglishCharsTTSTokenizer
from nemo_tpu_torch.models.asr.ctc_models import init_weights
from nemo_tpu_torch.models.tts.modules.fastpitch import FastPitchModule


class FastPitchModel(FastPitchModule):
    """The config keys and defaults are JAX's (d_model 384, 1 head, d_ff
    1536, 6 + 6 layers, 80 mels, 22,050 Hz, max_mel_len 2048). `device=None`
    means CUDA (and raises without it); weights are drawn from `seed` on the
    host, and `interop/jax_params.py:load_jax_variables` replaces them."""

    def __init__(self, cfg: Optional[dict] = None,
                 device: Union[str, torch.device, None] = None, seed: int = 0):
        cfg = ConfigDict(cfg or {})
        device = resolve_device(device)
        tokenizer = EnglishCharsTTSTokenizer()
        super().__init__(
            n_symbols=int(cfg.get("n_symbols", tokenizer.vocab_size)),
            n_mels=int(cfg.get("n_mels", 80)),
            d_model=int(cfg.get("d_model", 384)),
            n_heads=int(cfg.get("n_heads", 1)),
            d_ff=int(cfg.get("d_ff", 1536)),
            enc_layers=int(cfg.get("enc_layers", 6)),
            dec_layers=int(cfg.get("dec_layers", 6)),
            max_mel_len=int(cfg.get("max_mel_len", 2048)),
            min_token_duration=int(cfg.get("min_token_duration", 0)),
            max_token_duration=int(cfg.get("max_token_duration", 75)),
            norm_style=str(cfg.get("norm_style", "pre")),
            d_head=(int(cfg["d_head"]) if cfg.get("d_head") else None),
            pos_concat=bool(cfg.get("pos_concat", False)),
            predictor_filter_size=int(cfg.get("predictor_filter_size", 256)),
            predictor_kernel_size=int(cfg.get("predictor_kernel_size", 3)),
            predictor_n_layers=int(cfg.get("predictor_n_layers", 2)),
        )
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.sample_rate = int(cfg.get("sample_rate", 22050))
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.mel_proj.weight.device

    def parse(self, text: str) -> torch.Tensor:
        """Text → token ids [1, U] on the model's device."""
        ids = self.tokenizer.text_to_ids(text)
        return torch.tensor([ids], dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def generate_spectrogram(self, tokens: torch.Tensor, pace: float = 1.0) -> torch.Tensor:
        """tokens [B, U] → mel [B, n_mels, frames]: frames is the longest
        row's mel length, cut at max_mel_len (rows past their own length hold
        the projection of zeros, as in JAX)."""
        tokens = tokens.to(self.device, torch.long)
        B, U = tokens.shape
        empty = torch.zeros(B, self.n_mels, 0, device=self.device)
        if U == 0:
            return empty
        token_len = torch.full((B,), U, dtype=torch.long, device=self.device)
        e = self(tokens, token_len, pace=pace, stage="encode")
        mel_len = int(e["mel_len"].max())  # the host's one read between the phases
        if mel_len == 0:
            return empty
        # The last two valid frames see one frame past the end (ff1's tap
        # reads norm2 of it; padding does not zero it). JAX decodes at a
        # 128-frame bucket, which holds such a frame unless the length fills
        # the bucket: one frame of padding there keeps the frames JAX's.
        length = min(mel_len + 1, -(-mel_len // 128) * 128, self.max_mel_len)
        out = self(tokens, token_len, stage="decode", enc=e["enc"], dur=e["durations"],
                   mel_max_len=length)
        return out["mel"][:, :, :min(mel_len, length)]

    def fit_synthetic(self, steps: int = 60, batch: int = 8, seq: int = 64, seed: int = 0,
                      lr: float = 2e-3) -> float:
        """Adam on synthetic batches (tokens in [1, V), durations in [3, 10),
        normal pitch and mel targets at T = max_mel_len), dropout on, so that
        inference emits trained-like positive durations; the batches and the
        dropout draw from one `torch.Generator` of `seed` on the model's
        device. Returns the last step's loss."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = list(self.parameters())
        opt = adam(params, lr)
        token_len = torch.full((batch,), seq, dtype=torch.long, device=dev)
        tok_mask = torch.ones(batch, seq, device=dev)
        loss = None
        for _ in range(steps):
            tokens = torch.randint(1, self.n_symbols, (batch, seq), generator=gen, device=dev)
            dur = torch.randint(3, 10, (batch, seq), generator=gen, device=dev)
            mel = torch.randn(batch, self.n_mels, self.max_mel_len, generator=gen, device=dev)
            pitch = torch.randn(batch, seq, generator=gen, device=dev)
            out = self(tokens, token_len, durations=dur, pitch=pitch, train=True, gen=gen)
            loss = self.loss(out, mel, dur.sum(dim=1), dur, pitch, tok_mask)
            opt.step(torch.autograd.grad(loss, params))
        return float(loss.detach())

    @staticmethod
    def loss(out: dict, mel_target: torch.Tensor, mel_len: torch.Tensor,
             dur_target: torch.Tensor, pitch_target: torch.Tensor,
             token_mask: torch.Tensor) -> torch.Tensor:
        """Mel MSE + 0.1 · log-duration MSE + 0.1 · pitch MSE, each over the
        valid frames or symbols."""
        mel = out["mel"]
        n_mels, T = mel.shape[1], mel.shape[2]
        mel_mask = (torch.arange(T, device=mel.device)[None, :] < mel_len[:, None])[:, None, :]
        mel_loss = (torch.square((mel - mel_target[:, :, :T]) * mel_mask).sum()
                    / torch.clamp_min(mel_mask.sum() * n_mels, 1.0) * n_mels)
        n_tok = torch.clamp_min(token_mask.sum(), 1.0)
        log_dur_t = torch.log(dur_target.float() + 1.0)
        dur_loss = (torch.square(out["log_dur_pred"] - log_dur_t) * token_mask).sum() / n_tok
        pitch_loss = (torch.square(out["pitch_pred"] - pitch_target) * token_mask).sum() / n_tok
        return mel_loss + 0.1 * dur_loss + 0.1 * pitch_loss
