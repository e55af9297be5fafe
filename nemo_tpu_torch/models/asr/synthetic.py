"""Tone-coded calibration of a CTC or RNNT model, so that a benchmark times a
trained-regime decode (counterpart of nemo_tpu/models/asr/synthetic.py and of
bench.py:_calibrated_tone_batches).

A model at random init decodes almost nothing, so timing its transcription
times an empty host decode. Calibration trains it briefly on tone-coded
utterances (each transcript token is a harmonic burst at a token-specific
pitch, spread over the clip) with framewise cross-entropy on the known
planted alignment, until greedy decoding of held-out tone audio emits a
realistic token stream. A transducer trains its encoder through a throwaway
linear probe, then fits its prediction net and joint with the encoder frozen
(`fit_synthetic_asr`), and a bisection of the joint's blank bias pins the
emission rate (`trim_blank_bias`).

The data functions consume the numpy RNG in the same order as the JAX ones,
so one seed gives bit-identical audio, labels and eval batches. The framewise
step differentiates every variable of the model, BatchNorm's running stats
included (and a transducer's probe), and updates them with clip + AdamW as
optax does (core/optim.py), on fp32 masters.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from nemo_tpu_torch.core.optim import ClippedAdamW, warmup_cosine_decay_schedule
from nemo_tpu_torch.interop.jax_params import model_variables
from nemo_tpu_torch.ops.rnnt import rnnt_loss_from_log_probs


def tone_audio(targets: np.ndarray, secs: float, sr: int = 16000,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """targets [B, U] int → float32 audio [B, sr·secs]: token k renders as a
    short harmonic burst at a k-specific (semitone-spaced) pitch; bursts are
    spaced evenly so that emissions spread over the whole clip."""
    rng = rng or np.random.RandomState(0)
    B, U = targets.shape
    T = int(sr * secs)
    out = 0.01 * rng.randn(B, T).astype(np.float32)
    seg = T // U
    burst = int(min(0.2 * sr, 0.8 * seg))
    t = np.arange(burst) / sr
    env = np.hanning(burst).astype(np.float32)
    for b in range(B):
        for u in range(U):
            k = int(targets[b, u])
            f0 = 180.0 * (2.0 ** (k / 12.0))
            x = sum((0.6 ** h) * np.sin(2 * np.pi * (h + 1) * f0 * t) for h in range(3))
            s = u * seg + (seg - burst) // 2
            out[b, s:s + burst] += (x * env).astype(np.float32)
    peak = np.abs(out).max(axis=1, keepdims=True) + 1e-6
    return (out / peak).astype(np.float32)


def frame_labels(targets: np.ndarray, secs: float, Tprime: int, blank: int,
                 sr: int = 16000) -> np.ndarray:
    """[B, U] targets → [B, T'] per-frame labels of the `tone_audio` layout:
    token u on the encoder frames of its burst's middle 60 %, blank elsewhere
    (the JAX package's `_frame_labels`)."""
    B, U = targets.shape
    T = int(sr * secs)
    seg = T // U
    burst = int(min(0.2 * sr, 0.8 * seg))
    labels = np.full((B, Tprime), blank, np.int32)
    for u in range(U):
        s = u * seg + (seg - burst) // 2
        c0 = (s + 0.2 * burst) / T * Tprime
        c1 = (s + 0.8 * burst) / T * Tprime
        f0, f1 = int(np.ceil(c0)), max(int(c1), int(np.ceil(c0)) + 1)
        labels[:, f0:f1] = targets[:, u][:, None]
    return labels


def make_eval_batch(model, batch: int, secs: float, utt_tokens: int, vocab_cap: int = 12,
                    seed: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """Held-out tone-coded eval audio: (targets, int16 PCM audio)."""
    rng = np.random.RandomState(seed)
    V = min(len(model.labels), vocab_cap)
    targets = rng.randint(1, V, (batch, utt_tokens))
    audio = tone_audio(targets, secs, model.sample_rate, rng)
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    return targets, pcm


def framewise_loss(model, signal: torch.Tensor, length: torch.Tensor,
                   labels: torch.Tensor, probe: Optional[Tuple[torch.Tensor, ...]] = None
                   ) -> torch.Tensor:
    """−mean of the log-prob at the planted label over the first T' frames
    (labels [B, T']), through the mel frontend, the encoder (its subsampling
    through the conv pair: the fused kernel has no backward) and the CTC
    head, or for a transducer the linear probe (w [d_enc, V+1], b [V+1])."""
    if probe is None:
        lp, _ = model.log_probs(signal, length, conv_pair_subsampling=True)
    else:
        enc, _ = model.encode(*model.mel_features(signal, length), conv_pair_subsampling=True)
        lp = torch.log_softmax(torch.addmm(probe[1], enc.float().flatten(0, 1), probe[0]), -1)
        lp = lp.view(*enc.shape[:2], -1)
    lp = lp.float()[:, :labels.shape[1]]
    return -lp.gather(-1, labels.long()[..., None])[..., 0].mean()


def _is_transducer(model) -> bool:
    return hasattr(model, "blank_id") and hasattr(model, "max_symbols")


def fit_synthetic_asr(model, steps: int = 40, batch: int = 8, secs: float = 2.0,
                      utt_tokens: int = 6, vocab_cap: int = 12, lr: float = 3e-4,
                      seed: int = 0, head_only: bool = True) -> float:
    """Brief tone-coded fit of a transducer's prediction net and joint over
    its frozen encoder, in place (the JAX package's `fit_synthetic_asr` with
    `head_only=True`): the RNNT loss of the memory-chunked joint (chunks of
    16 frames), or a TDT model's loss over its full joint, the encoder run
    without autograd (through the fused
    subsampling kernel where the flag is set) and its BatchNorm stats
    untouched; clip 5.0 and AdamW under a warmup-cosine schedule on the
    `prediction` and `joint` variables only. Returns the final loss.

    The full-model fit (`head_only=False`) and CTC models are not ported."""
    if not _is_transducer(model):
        raise NotImplementedError("fit_synthetic_asr of a CTC model is not ported "
                                  "(ROADMAP.md A5, what is left of RNNT and TDT)")
    if not head_only:
        raise NotImplementedError("the full transducer train step (make_train_step) is not "
                                  "ported (ROADMAP.md A5, what is left of RNNT and TDT)")
    rng = np.random.RandomState(seed)
    V = min(len(model.labels), vocab_cap)
    sr = model.sample_rate
    T = int(sr * secs)
    device = model.device
    lens = torch.full((batch,), T, dtype=torch.int32, device=device)
    tlen = torch.full((batch,), utt_tokens, dtype=torch.int32, device=device)
    head = [t for name, t in model_variables(model).items()
            if name.split(".")[0] in ("prediction", "joint")]
    sched = warmup_cosine_decay_schedule(0.0, lr, max(steps // 10, 5), max(steps, 10), lr / 30.0)
    opt = ClippedAdamW(head, sched)
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        targets = rng.randint(1, V, (batch, utt_tokens))
        audio = tone_audio(targets, secs, sr, rng)
        tgt = model.upload(targets.astype(np.int32))
        with torch.no_grad():  # the frozen encoder: through the fused subsampling kernel
            enc, enc_len = model.encode(*model.mel_features(model.upload(audio), lens))
        if model.durations:  # TDT: the full joint and the TDT loss, as JAX's loss_fused
            logits = model.joint(enc[:, :, None], model.predict(tgt)[:, None])
            loss = model.loss(logits, tgt, enc_len, tlen)
        else:
            lp_b, lp_l = model.joint.fused_log_probs(enc, model.predict(tgt), tgt, chunk=16)
            loss = rnnt_loss_from_log_probs(lp_b, lp_l, enc_len, tlen + 1).mean()
        opt.step(torch.autograd.grad(loss, head))
    return float(loss.detach())


def framewise_calibrate(model, steps: int = 150, batch: int = 8, secs: float = 2.0,
                        utt_tokens: int = 4, vocab_cap: int = 12, lr: float = 1e-3,
                        seed: int = 0,
                        on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
                        log: Callable[[str], None] = print, probe: Optional[dict] = None
                        ) -> float:
    """Framewise-CE tone calibration, in place (the JAX package's
    `framewise_calibrate`). Every variable, BatchNorm running stats included,
    is differentiated and updated with clip_by_global_norm(5) and AdamW
    (weight decay 1e-4) under a warmup-cosine schedule. `on_step(i, loss)`
    sees each framewise step's loss tensor. Returns the final framewise loss.

    A CTC model trains its own head. A transducer trains its encoder through
    a throwaway linear probe (`probe`: {"w": [d_enc, V+1], "b": [V+1]}, by
    default w ~ N(0, 0.02²) from a generator seeded with `seed` and b = 0),
    which is then discarded, and fits its prediction net and joint with
    `fit_synthetic_asr(lr=3e-3, seed=seed + 1)`. As in JAX, the prediction
    and joint variables are leaves of the framewise step too: their gradient
    is zero, and AdamW's weight decay still moves them."""
    rng = np.random.RandomState(seed)
    V = min(len(model.labels), vocab_cap)
    sr = model.sample_rate
    T = int(sr * secs)
    device = model.device
    lens = torch.full((batch,), T, dtype=torch.int32, device=device)
    blank = len(model.labels)  # the CTC blank is the last index; the probe's too
    is_rnnt = _is_transducer(model)
    Tprime = int(model.encoded_length(torch.tensor([T]))[0])
    if getattr(model.encoder.pre_encode, "fused_kernel", False):
        log("framewise_calibrate: the training forward runs the subsampling through the "
            "conv pair (the fused kernel has no backward)")

    leaves = list(model_variables(model).values())
    stats = [t for t in leaves if not isinstance(t, nn.Parameter)]
    head = None
    if is_rnnt:
        if probe is None:
            gen = torch.Generator().manual_seed(seed)
            d_enc = model.joint.enc_proj.in_features
            probe = {"w": torch.randn(d_enc, blank + 1, generator=gen) * 0.02,
                     "b": torch.zeros(blank + 1)}
        head = tuple((probe[k] if isinstance(probe[k], torch.Tensor) else torch.from_numpy(
            np.array(probe[k], np.float32))).to(device, torch.float32).requires_grad_(True)
            for k in ("w", "b"))
        leaves += head
    sched = warmup_cosine_decay_schedule(0.0, lr, max(steps // 10, 5), max(steps, 10), lr / 30.0)
    opt = ClippedAdamW(leaves, sched)
    loss = torch.tensor(float("nan"))
    for t in stats:  # the running stats are leaves of the gradient, as in JAX
        t.requires_grad_(True)
    try:
        for i in range(steps):
            targets = rng.randint(1, V, (batch, utt_tokens))
            audio = tone_audio(targets, secs, sr, rng)
            labels = frame_labels(targets, secs, Tprime, blank, sr)
            loss = framewise_loss(model, model.upload(audio), lens, model.upload(labels), head)
            grads = torch.autograd.grad(loss, leaves, allow_unused=is_rnnt)
            # a transducer's prediction and joint leaves take no part: zero gradients
            opt.step([torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)])
            if on_step is not None:
                on_step(i, loss.detach())
    finally:
        for t in stats:
            t.requires_grad_(False)
    if is_rnnt:  # the probe is discarded; the transducer head is fitted on the adapted encoder
        fit_synthetic_asr(model, steps=steps, batch=batch, secs=secs, utt_tokens=utt_tokens,
                          vocab_cap=vocab_cap, lr=3e-3, seed=seed + 1, head_only=True)
    return float(loss.detach())


def trim_blank_bias(model, secs: float, utt_tokens: int,
                    band: Tuple[float, float] = (0.05, 0.15), batch: int = 4, seed: int = 990,
                    iters: int = 9) -> Tuple[float, float]:
    """Bisect an offset on the transducer joint's blank logit bias
    (`joint.out_proj.bias[blank_id]`, the only entry it changes; a TDT
    joint's duration head is left as it is) so that
    greedy decoding of held-out tone audio (`make_eval_batch` seed `seed`,
    B = `batch`) lands in `band` labels per encoder frame. The offset spans
    [-14, 14] (the density falls as it grows), at most `iters` bisection
    steps after the unshifted decode. Returns (offset, tokens/utt)."""
    _, pcm = make_eval_batch(model, batch, secs, utt_tokens, seed=seed)
    T = int(model.sample_rate * secs)
    lens = torch.full((batch,), T, dtype=torch.int32, device=model.device)
    sig = model.upload(pcm)
    Tprime = int(model.encoded_length(torch.tensor([T]))[0])
    lo_tok, hi_tok = band[0] * Tprime, band[1] * Tprime
    bias, blank = model.joint.out_proj.bias, model.blank_id
    bias0 = bias.detach()[blank].clone()

    def density(delta: float) -> float:
        with torch.no_grad():
            bias[blank] = bias0 + delta
        out = model.transcribe_staged([(sig, lens, batch)])
        return sum(len(s) for s in out) / batch

    d0 = density(0.0)
    if lo_tok <= d0 <= hi_tok:
        return 0.0, d0
    lo, hi = -14.0, 14.0
    mid, d = 0.0, d0
    for _ in range(iters):
        mid = (lo + hi) / 2
        d = density(mid)
        if d < lo_tok:
            hi = mid
        elif d > hi_tok:
            lo = mid
        else:
            break
    return mid, d


def calibrated_tone_batches(model, B: int, secs: float, utt_tokens: int, iters: int, *,
                            fit_steps: int, density_floor: float, lr: float = 1e-3,
                            seed: int = 0, fit_batch: int = 4,
                            log: Callable[[str], None] = print
                            ) -> Tuple[List[tuple], float, List[dict]]:
    """Tone-calibrate `model` (up to 3 rounds of `framewise_calibrate`, each
    followed for a transducer by `trim_blank_bias`) until a held-out probe
    decodes ≥ density_floor tokens/utt, then build `iters` + 1 staged
    held-out eval batches (make_eval_batch seeds 100 + i) for
    `transcribe_staged` (bench.py:_calibrated_tone_batches). Returns
    (staged, probe density, one dict per round: loss, seconds, steps,
    density, for a transducer trim_delta and trim_density, and peak_mem_gib
    on CUDA). Raises if the floor is not reached."""
    T = int(model.sample_rate * secs)
    device = model.device
    lens = torch.full((B,), T, dtype=torch.int32, device=device)
    is_rnnt = _is_transducer(model)
    unit = "tokens/utt" if is_rnnt else "chars/utt"
    density, rounds = 0.0, []
    for round_i in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = _clock(device)
        loss = framewise_calibrate(model, steps=fit_steps, batch=fit_batch, secs=secs,
                                   utt_tokens=utt_tokens, lr=lr, seed=seed + round_i, log=log)
        seconds = _clock(device) - t0
        info = dict(loss=loss, seconds=seconds, steps=fit_steps)
        if is_rnnt:
            delta, dtrim = trim_blank_bias(model, secs, utt_tokens)
            info.update(trim_delta=delta, trim_density=dtrim)
            log(f"rnnt blank-bias trim delta={delta:+.2f} -> {dtrim:.1f} tokens/utt on the "
                f"held-out probe")
        _, probe_pcm = make_eval_batch(model, B, secs, utt_tokens, seed=900 + round_i)
        probe = model.transcribe_staged([(model.upload(probe_pcm), lens, B)])
        density = sum(len(s) for s in probe) / max(len(probe), 1)
        info["density"] = density
        if device.type == "cuda":
            info["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rounds.append(info)
        log(f"tone calibration round {round_i}: final loss {loss:.4f}, {fit_steps} steps in "
            f"{seconds:.2f} s, probe density {density:.1f} {unit} (floor {density_floor})")
        if density >= density_floor:
            break
    if density < density_floor:
        raise RuntimeError(f"tone calibration failed: density {density:.1f} < {density_floor}: "
                           "a benchmark would time a degenerate decode")
    staged = [(model.upload(make_eval_batch(model, B, secs, utt_tokens, seed=100 + i)[1]),
               lens, B) for i in range(iters + 1)]
    return staged, density, rounds


def _clock(device: torch.device) -> float:
    """Host seconds, after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()
