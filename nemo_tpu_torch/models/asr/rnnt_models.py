"""RNNT ASR model: Conformer-Transducer and FastConformer-TDT transcription
and their transducer losses (counterpart of
nemo_tpu/models/asr/rnnt_models.py:EncDecRNNTModel, with its `_RNNTNet`
folded in).

PCM → mel (ops/audio.py) → ConformerEncoder → greedy transducer decode (the
LSTM prediction net and the additive joint, modules/rnnt.py; with
`model_defaults.tdt_durations` the TDT joint and the frame-skipping decode
of ops/tdt.py) → tokens → text on the host. Transcription is pipelined as the CTC model's is
(ctc_models.py:ASRModel): batch i is launched before batch i−1's tokens are
joined into text, and only the tokens and their counts leave the device.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from nemo_tpu_torch.core.config import ConfigDict
from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.models.asr.ctc_models import ASRModel, init_weights
from nemo_tpu_torch.models.asr.modules.conformer import ConformerEncoder
from nemo_tpu_torch.models.asr.modules.rnnt import (PredictionNetwork, RNNTJoint,
                                                    init_flax_defaults, rnnt_greedy_decode,
                                                    rnnt_greedy_decode_label_looping)
from nemo_tpu_torch.ops.rnnt import rnnt_loss_from_log_probs, rnnt_loss_mean
from nemo_tpu_torch.ops.tdt import tdt_greedy_decode, tdt_loss

_NOT_PORTED = "(ROADMAP.md A5, what is left of RNNT and TDT)"


class EncDecRNNTModel(ASRModel):
    """Conformer-Transducer model from a config of
    `models/asr/configs.py:conformer_transducer`: encoder, `prediction`
    (embedding + LSTM) and `joint`, blank last (`blank_id` = V).

    Decoding strategies `greedy_batch` (label looping, the default) and
    `greedy` (the frame loop) are ported; beam, maes, multiblank and n-gram
    fusion raise NotImplementedError. With `model_defaults.tdt_durations`
    (e.g. (0, 1, 2, 3, 4)) it is a TDT model, as JAX's: the joint has a
    duration head, the loss is `ops/tdt.py:tdt_loss` over the full joint
    and the decode is `tdt_greedy_decode`, whichever greedy strategy the
    config names. `device=None` means CUDA (and
    raises without it); `device="cpu"` runs the plain versions of the
    kernels. Weights come from `seed` through a `torch.Generator`: the
    encoder as the CTC model's, the prediction net and the joint with
    flax's initialisers' distributions."""

    def __init__(self, cfg: ConfigDict, device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        enc_cfg = self._init_frontend(ConfigDict(cfg))
        cfg = self.cfg
        self.blank_id = len(self.labels)
        decoding = cfg.get("decoding", {})
        self.max_symbols = int(decoding.get("max_symbols", 10))
        self.decoding_strategy = str(decoding.get("strategy", "greedy_batch"))
        self._check_strategy()
        defaults = cfg.get("model_defaults", {})
        if defaults.get("big_blank_durations"):
            raise NotImplementedError("multiblank RNNT (model_defaults.big_blank_durations) is "
                                      "not ported (ROADMAP.md A5)")
        self.durations = tuple(int(d) for d in defaults.get("tdt_durations", ()))
        dec_cfg, joint_cfg = cfg.get("decoder", {}), cfg.get("joint", {})
        pred_hidden = int(dec_cfg.get("pred_hidden", 640))
        with torch.random.fork_rng(devices=[]):  # default inits must not move the global RNG
            self.encoder = ConformerEncoder(**enc_cfg)
            self.prediction = PredictionNetwork(len(self.labels), pred_hidden,
                                                int(dec_cfg.get("pred_rnn_layers", 1)))
            self.joint = RNNTJoint(len(self.labels), int(enc_cfg["d_model"]), pred_hidden,
                                   int(joint_cfg.get("joint_hidden", 640)),
                                   num_durations=len(self.durations))
        gen = torch.Generator().manual_seed(seed)
        init_weights(self.encoder, gen)
        init_flax_defaults(self.prediction, gen)
        init_flax_defaults(self.joint, gen)
        self.last_loop_iterations = 0  # the decoder loops of the last decoded batch
        self._finish_init(device)

    def _check_strategy(self) -> None:
        if self.decoding_strategy not in ("greedy_batch", "greedy"):
            raise NotImplementedError(f"decoding strategy {self.decoding_strategy!r} is not "
                                      f"ported: greedy_batch and greedy are {_NOT_PORTED}")

    def set_ngram_lm(self, lm, weight: float = 0.3, strategy: str = "beam") -> None:
        raise NotImplementedError(f"n-gram shallow fusion is not ported {_NOT_PORTED}")

    # -- the network (JAX's _RNNTNet) ----------------------------------------
    def encode(self, feats: torch.Tensor, lengths: torch.Tensor, *,
               conv_pair_subsampling: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """mel [B, D, F], [B] → (enc [B, T', H] in the compute dtype, [B])."""
        enc, enc_len = self.encoder(feats, lengths, conv_pair_subsampling=conv_pair_subsampling)
        return enc.transpose(1, 2), enc_len

    def predict(self, targets: torch.Tensor) -> torch.Tensor:
        return self.prediction(targets)  # [B, U+1, H]

    def pred_step(self, token: torch.Tensor, state):
        return self.prediction.step(token, state)

    def joint_logits(self, enc: torch.Tensor, pred: torch.Tensor):
        return self.joint(enc, pred)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor, targets: torch.Tensor):
        """Training path: (full joint logits [B, T', U+1, V+1] (TDT: and the
        duration logits [B, T', U+1, D]), enc lengths). The encoder's
        subsampling runs as the conv pair: the fused kernel has no
        backward."""
        enc, enc_len = self.encode(feats, lengths, conv_pair_subsampling=True)
        pred = self.predict(targets)
        return self.joint(enc[:, :, None], pred[:, None]), enc_len

    def fused_blank_label(self, feats: torch.Tensor, lengths: torch.Tensor,
                          targets: torch.Tensor, chunk: int = 32):
        """Memory-chunked training path: (lp_blank, lp_label [B, T', U+1],
        enc lengths) without the [B, T', U+1, V+1] joint; the subsampling
        as the conv pair, as in `forward`."""
        enc, enc_len = self.encode(feats, lengths, conv_pair_subsampling=True)
        lp_b, lp_l = self.joint.fused_log_probs(enc, self.predict(targets), targets, chunk)
        return lp_b, lp_l, enc_len

    # -- training ------------------------------------------------------------
    def loss_fused(self, signal: torch.Tensor, length: torch.Tensor, targets: torch.Tensor,
                   target_len: torch.Tensor, chunk: int = 32) -> torch.Tensor:
        """The training loss: mel, the memory-chunked joint, the transducer
        NLL, mean over the batch. A TDT model gathers more than the two
        planes, so it takes the full joint and `loss`, as JAX's does."""
        feats, feat_len = self.mel_features(signal, length)
        if self.durations:
            logits, enc_len = self(feats, feat_len, targets)
            return self.loss(logits, targets, enc_len, target_len)
        lp_b, lp_l, enc_len = self.fused_blank_label(feats, feat_len, targets, chunk)
        return rnnt_loss_from_log_probs(lp_b, lp_l, enc_len, target_len + 1).mean()

    def loss(self, logits, targets: torch.Tensor, enc_len: torch.Tensor,
             target_len: torch.Tensor) -> torch.Tensor:
        """Mean NLL of the full joint's logits (TDT: the (token, duration)
        pair)."""
        if self.durations:
            tok, dur = logits
            return tdt_loss(tok, dur, targets, enc_len, target_len, self.durations).mean()
        return rnnt_loss_mean(logits, targets, enc_len, target_len)

    # -- inference -----------------------------------------------------------
    @torch.inference_mode()
    def decode(self, signal: torch.Tensor, length: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] int16 PCM or float audio, [B] sample counts → (tokens [B,
        T'·max_symbols] (TDT: [B, 2 T']) int32 padded with −1, counts [B]
        int32): the JAX model's `_decode_fn`."""
        self._check_strategy()
        feats, feat_len = self.mel_features(signal, length)
        return self.greedy_decode(*self.encode(feats, feat_len))

    @torch.inference_mode()
    def greedy_decode(self, enc: torch.Tensor, enc_len: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The greedy transducer decode of the encoder output enc [B, T', H]
        with enc_len [B] valid frames → (tokens, counts) as `decode`'s. The
        encoder output is projected by the joint's enc_proj once for every
        frame, and the prediction step returns its output through
        pred_proj, so a loop's joint is one add, the activation and
        out_proj (the same function of the same inputs)."""
        self._check_strategy()
        joint, fused = self.joint, self.prediction.fused()

        def pred_step_fn(token, state):
            out, state = self.prediction.step(token, state, fused)
            return joint.project_pred(out), state

        state0 = self.prediction.initial_state(enc.shape[0], enc.device)
        if self.durations:
            tokens, counts, self.last_loop_iterations = tdt_greedy_decode(
                joint.from_projected, pred_step_fn, state0, joint.project_enc(enc), enc_len,
                self.blank_id, self.durations)
            return tokens, counts
        decoder = (rnnt_greedy_decode if self.decoding_strategy == "greedy"
                   else rnnt_greedy_decode_label_looping)
        tokens, counts, self.last_loop_iterations = decoder(
            joint.from_projected, pred_step_fn, state0, joint.project_enc(enc), enc_len,
            self.blank_id, self.max_symbols)
        return tokens, counts

    def _launch(self, signal: torch.Tensor, length: torch.Tensor, n: int):
        """Decode one batch; start copying its tokens and counts to the host."""
        return (*self._to_host(*self.decode(signal, length)), n)

    def _collect(self, pending) -> List[str]:
        (tokens, counts), done, n = pending
        if done is not None:
            done.synchronize()
        tokens, counts = tokens.numpy(), counts.numpy()
        return ["".join(self.labels[i] for i in tokens[b, :counts[b]]) for b in range(n)]
