#!/usr/bin/env python3
"""On-card check of the PyTorch port (`nemo_tpu_torch`) on one NVIDIA card:
Conformer-Large CTC tone calibration (training) and then transcription,
through the four hand-written kernels K1-K4, as bench.py's primary line runs
them; then Llama-3.2-1B training through the causal GQA flash kernels K5-K7;
then packed full-parameter SFT of Llama-3.2-1B through the segment-masked
flash kernels K8-K10; then context-parallel (ring) training of Llama-3.2-1B
at 16,384 tokens through the position-masked flash kernels K11-K13; then
Conformer-Transducer-Large RNNT tone calibration and label-looping greedy
transcription through K1-K4, as bench.py:bench_rnnt runs them; then LLM
serving: the KV cache, int8 PTQ, the continuous-batching engine at
bench.py:bench_decode's geometry and the OpenAI-compatible server on
Llama-3.2-1B (its scoring forward through K5); then speech synthesis:
FastPitch at bench.py:bench_tts's config and HiFi-GAN V1, served with the
calibrated Conformer-Large CTC (K1, K2) by the OpenAI audio server, and the
voice-agent cascade of that ASR, Llama-3.2-1B and that TTS; then the MFU
bench's training lines (scripts/train_mfu.py): GPT-551M in bf16 and with fp8
training GEMMs (`ops/quant.py:quant_matmul`, `torch._scaled_mm`), and
Llama-3.2-1B under clip + Adafactor, through K5-K7; then FastConformer-XL
TDT (x8 dw_striding subsampling, the TDT joint, loss and frame-skipping
greedy decode) tone calibration and transcription through K1, K3 and K4 at
head dim 128; then Phi-3-mini-4k (32 heads of dh 96) training and packed
full-parameter SFT through K5-K10 at head dim 96.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile  # and torch.profiler breakdowns of one batch,
                                     # of calibration steps, of LLM training steps,
                                     # of SFT steps, of CP training steps, of one
                                     # RNNT batch, of RNNT head-fit steps, of
                                     # decode steps, of a text → waveform call and
                                     # of GPT-551M and Llama-3.2-1B MFU steps
    torchrun --nproc-per-node 2 chip_smoke.py --cp-processes
                                     # only CP training over processes, one a card
                                     # (NCCL), against every rank in one process
    python3 chip_smoke.py --time-forward [--tree DIR]
                                     # only the bf16 forward kernels K1, K2, K5, K8
                                     # and K11 (and K1 at dh 128; K5, K8 at dh 96)
                                     # of this checkout
                                     # (or of DIR) timed, beside SDPA and the cuDNN
                                     # pair, one JSON line: run two checkouts in
                                     # turns to compare
    python3 chip_smoke.py --time-backward [--tree DIR]
                                     # the same for the bf16 backward kernels K3,
                                     # K4, K6, K7, K9, K10, K12 and K13 (and K3, K4
                                     # at dh 128; K6, K7, K9, K10 at dh 96), beside
                                     # SDPA's backward

Phases, each printing a line; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   kernel source (`nemo_tpu_torch/csrc/*.cu`, one nvcc each, in parallel),
   then the unit check of the TMA and wgmma wrappers (`csrc/hopper.cuh`,
   which the bf16 kernels K1-K13 are built from): one warpgroup's m64nNk16
   products of TMA-loaded (or thread-written) tiles against torch.matmul;
2. K1, the rel-pos flash attention, against its plain version at the
   transcription shape (B=32, H=8, T=751, dh=64), in bf16 and fp32, with its
   time, the plain version's and SDPA's (given the precomputed additive
   bias), and the kernel's and SDPA's device times (`device_ms`);
3. K2, the fused subsampling, against its plain version (the cuDNN conv
   pair in fp32) at the transcription shape (x [32, 3001, 80], C=512), with
   its time and device time beside the bf16 cuDNN pair's;
4. K3 and K4, the rel-pos flash backward (dq side; dk/dv and dp side),
   against the plain backward at the calibration shape (B=4, H=8, T=751,
   dh=64), ragged and full lengths, bf16 and fp32, with their times, the
   plain backward's and SDPA's backward (given the bias), and the kernels'
   and SDPA's device times under torch.profiler (`device_ms`);
5. the whole model in fp32: one seeded Conformer-Large CTC model with both
   kernel flags, on the card (kernels) and on the CPU (plain versions), at
   B=2 x 5 s; log-probs on valid frames and greedy ids must agree;
6. gradients in fp32: the calibration loss of a 2-layer model at d_model
   512, on the card (K1, K3, K4) and on the CPU, for every variable;
7. calibration (bench.py:_calibrated_tone_batches): Conformer-Large bf16,
   both flags, the training forward through the conv pair; rounds of 250
   AdamW steps at B=4 x 30 s until a held-out probe decodes >= 50 chars/utt
   (at most 3 rounds); K1, K3 and K4 launch 18 times a step;
8. the main path: `transcribe_staged` of the calibrated model over held-out
   tone batches, B=32 x 30 s int16, one warm batch and 5 timed ones; more
   than 50 chars/utt (bench.py:132), K1 18 and K2 1 launch a batch;
9. K5, K6 and K7, the causal GQA flash forward and backward, against their
   plain versions at B=2, S=2048 (H=32 over G=8 at dh 64, with no window and
   a window of 512; H=G=12 at dh 128, GPT-551M's head), bf16 and fp32, K5
   also at B=1, S=256, H=32 over G=8 at dh 64 (what `LLMServer.score` gives
   it in phase 24); then at the training shape (B=8, S=2048: H=32 over
   G=8 at dh 64 in fp32 and bf16, H=G=12 at dh 128 in bf16) against the
   plain versions again and timed beside them and SDPA (is_causal,
   enable_gqa); o and each gradient are held row by row (one query's o or
   dq, one key's dk or dv) and by their relative norm, since causal rows
   shrink along the sequence;
10. LLM gradients in fp32: a 2-layer model at Llama-3.2-1B's width (the
   vocab cut to 8192), B=1 x S=256, on the card (K5-K7, full remat) and on
   the CPU (plain versions): the loss and every gradient;
11. a measurement: how far the fused CE's bf16 logits gradient moves the
   gradients of a 2-layer bf16 model at Llama-3.2-1B's width and vocab from
   a backward that keeps that gradient in fp32, as JAX's mixed products do;
12. LLM training, this slice's path: `GPTTrainModule.train_step` on
   Llama-3.2-1B (full width and depth, bf16, flash, full remat, AdamW) at
   B=8 x S=2048 from seed 0, 2 warm-up steps and 20 timed ones over distinct
   random batches: tokens/s, ms/step, MFU, peak memory; K5 32, K6 16 and K7
   16 launches a step, none of K1-K4;
13. K8, K9 and K10, the packed (segment-masked) flash forward and backward,
   against their plain versions at B=2, S=2048 (the shapes of phase 9) on
   three segment layouts (two rows of the SFT data; ids 1, 2, 1, 3 with
   padding inside and a row of padding only; one segment a row): padding
   rows and keys exactly 0, and with one segment a row K5-K7's bits; then
   the same checks at B=8, S=2048, 32 over 8, dh 64 on the whole of the SFT
   run's first batch, of a batch from the middle of the epoch and of one
   segment a row, and at each the kernels' times beside K5-K7's (what
   skipping saves, and at one segment a row what the segment policy costs);
   at the first batch also the plain versions' and SDPA's (a dense boolean
   mask);
14. packed SFT, this slice's path: `finetune_recipe("llama32_1b",
   peft_scheme="none", global_batch_size=8).run(params, data)` (the recipe
   says a global batch of 128: the one cut) → `llm.finetune` → `Trainer.fit`
   → `GPTTrainModule.train_step`, on Llama-3.2-1B at full width and depth,
   S=2048, seed-0 weights handed in as a JAX-layout tree of tensors on the
   card, over a jsonl of 2,048 synthetic examples written from seed 0 and a
   byte tokenizer; 2 warm-up and 20 timed steps: ms/step, tokens/s over all
   and over non-padding tokens, MFU, peak memory, the step-0 loss in [ln V,
   ln V + 1]; K8 32, K9 16 and K10 16 launches a step, none of K1-K7; then
   5 more steps timed on batches from the middle of the epoch (packing puts
   the longest examples first, so the run's batches hold fewer segments);
15. K11, K12 and K13, the position-masked flash forward and backward,
   against their plain versions (group by group of heads) at one rank's
   shape of the CP path, B=1, Tl=8,192 (32 heads over 8 at dh 64; 12 over
   12 at dh 128), fp32 and bf16, the backward given a nonzero lse
   cotangent, on five layouts: positions 0 .. Tl-1 (K5-K7's bits), rank 0's
   diagonal and off-diagonal ring steps of the zig-zag cp 2 layout (rows
   that keep no key exactly o = 0, lse = -1e30, dq = 0), the diagonal with
   a window of 512, and flash_attention(q_offset=Tl/2); then the times of
   each ring step beside K5-K7 at S=Tl, the plain versions and SDPA given
   the positions' boolean mask;
16. ring attention (LocalRing, every rank in one process) at cp 2 and cp 4,
   S=16,384, B=1, 32 heads over 8, fp32 and bf16, against causal attention
   over the un-permuted sequence: K5-K7 on every head and the plain version
   on the first kv group; o and the gradients row by row;
17. CP training, this slice's path: the 2-layer fp32 check of phase 10 at
   cp 2 (K11-K13, card against CPU); then `GPTTrainModule.train_step` on
   Llama-3.2-1B (full width and depth, bf16, flash, full remat, AdamW) at
   S=16,384, cp 2, every rank in one process, B=1, seed 0: the first
   batch's loss within 2e-3 relative of cp 1 (K5-K7) on the same weights,
   2 warm-up and 20 timed steps: tokens/s, ms/step, MFU, peak memory; K11
   128, K12 and K13 64 launches a step, none of K1-K10;
18. the RNNT model in fp32: one seeded Conformer-Transducer-Large with both
   kernel flags, on the card (K1 18 and K2 1 launches a forward) and on the
   CPU (plain versions), at B=2 x 5 s (one ragged): the encoder output on
   valid frames and the joint logits along the CPU's greedy path within
   1e-3; the greedy tokens equal up to the first difference, allowed only
   at a near-tie (2e-3) of the CPU's top-2 joint logits;
19. the RNNT loss in fp32 on the planes of `fused_log_probs`, card against
   CPU, at B=4, T'=751, U=40, V+1=29: the value within 1e-5 relative, the
   prediction and joint gradients within 1e-4 of each leaf's max;
20. RNNT calibration (bench.py:bench_rnnt): Conformer-Transducer-Large bf16,
   both flags; rounds of 150 framewise steps (through a linear probe, the
   training forward through the conv pair) and 150 head-only RNNT steps
   (the encoder frozen, through K1 and K2) at B=4 x 30 s, U=40, each round
   ended by the blank-bias trim, until a held-out probe decodes >= 20
   tokens/utt (at most 3 rounds): framewise and head-fit ms/step, the trim,
   peak memory; K1-K4 launches against the steps and decodes;
21. the RNNT main path: `transcribe_staged` of the calibrated model, B=32 x
   30 s int16 held-out tone batches, one warm and 3 timed:
   conformer_transducer_rnnt_transcribe_rtfx, ms/batch, label-looping loops
   per batch, peak memory, more than 20 tokens/utt; K1 18 and K2 1 launches
   a batch;
22. serving in fp32 at the decode bench's width (scripts/decode_throughput.py:
   hidden 2048, 16 heads x dh 128, FFN 8192, vocab 32,000), depth cut to 2
   layers, card against CPU, in two modes (bf16 weights and cache; int8 PTQ
   and the int8 cache): 4 ragged slots, prefill_slot, 16 decode_step calls
   and decode_steps(16), the CPU replaying the card's roundings (greedy
   tokens, cache writes, the bf16 value product), each checked against its
   own; the logits of every forward within 1e-3 of each row's max;
23. the decode bench on the port (bench.py:bench_decode,
   gpt1b_decode_tokens_per_sec_chip): the bench's model at full width and
   depth from seed 0, int8 PTQ + int8 KV and then bf16, 8 slots, 48-token
   prompts, max_len 1024, one KV bucket of 306: tokens/s and ms a step of
   the median of 2 timed decode_steps chunks of 64 after a warm one, ms a
   step of 16 decode_step calls, the weight bytes, the roofline at 3.35
   TB/s and its share, peak memory;
24. `LLMServer` on Llama-3.2-1B (flash backend, int8 PTQ weights, int8 KV)
   on an ephemeral port: 8 concurrent /v1/completions sharing a 32-token
   prefix (the prefix cache must hold it), a streamed /v1/chat/completions,
   the scoring form of /v1/completions on 200 tokens (K5 16 launches, none
   of the other kernels), each answer's shape and token count checked, the
   greedy answers held to the engine's own run of the same prompts (a
   served token that differs must have a logit within 1e-2 of the row's
   max-abs below the engine's max), and the served log-probabilities to the
   same model's score with K5's plain version in K5's place; the wall time
   of each request;
25. speech synthesis in fp32, card against CPU: FastPitch at bench_tts's
   config (d 384, 6 + 6 layers, max_mel_len 1024, min_token_duration 1) and
   HiFi-GAN V1, both from seed 0, on B=2 ragged texts: the encoder stage
   within 1e-3 of each tensor's max; the durations equal but at half-ties
   (the CPU's value before rounding within 1e-4 of k + 0.5); the mel decoded
   from the CPU's durations within 1e-3 of its max; the waveform vocoded from
   the CPU's mel within 1e-3; one loss (train=False) within 1e-5 relative and
   its gradients within 1e-4 of each leaf's max, on a batch the CPU draws;
26. bench.py:bench_tts on the port: fit_synthetic(40 steps, B=4, seq 48),
   B=8 copies of the bench's sentence, the paces 1.0, 1.01 and 1.02 warmed,
   10 timed calls: fastpitch_mel_frames_per_sec, x realtime at 86.13 frames
   a second, ms a call, frames a symbol, the fit's ms a step and final loss,
   peak memory (0 frames fails); then HiFi-GAN V1 on the last call's mels:
   audio seconds per wall second, ms a call, its operations (from the
   convolutions' shapes) and their rate;
27. `AudioServer` on an ephemeral port with phase 7's calibrated CTC model
   and phase 26's FastPitch with HiFi-GAN V1: /v1/audio/speech for the
   bench's sentence (a mono 16-bit 22,050 Hz WAV of 256 x frames samples,
   within 1 LSB of `synthesize`), /v1/audio/transcriptions of a held-out 30
   s tone clip raw at 16 kHz, multipart and at 22,050 Hz (resampled), each
   text `transcribe`'s, K1 18 and K2 1 launches a call, and each of those K1
   and K2 outputs held against its plain version on the inputs the request
   gave it (B=4 rows, one of them 30 s and three one sample long) at phases
   9's and 10's bf16 tolerances; the wall time of each request;
28. `VoiceAgent` over phase 7's model (`ModelASRService`), greedy
   generation of 16 tokens on Llama-3.2-1B with phase 24's seed-0 weights and
   the byte tokenizer, each id spelt as a letter or a space
   (`CallableLLMService`), and FastPitch with HiFi-GAN (`NativeTTSService`):
   one `converse` turn and one `push_audio` turn (the clip, then 0.6 s of
   silence); the user text `transcribe`'s, the history 2 longer a turn, the
   reply audio 256 x the frames of the reply's symbols, each turn's K1 and
   K2 outputs held against their plain versions as in phase 27; the ASR,
   LLM and TTS seconds of each turn; then a reply of no symbol ("€"), whose
   0-frame mel the vocoder refuses;
29. `ops/quant.py`'s products on the card against their plain versions at
   GPT-551M's shapes (M = 8 x 2048; (K, N) of q_proj, o_proj, fc1, fc2) in
   the modes fp8, fp8_e4m3 and int8: the casts of x, w and the gradient
   bitwise the CPU's; `quant_matmul`'s forward (int8 bitwise), dgrad and
   wgrad against the exact sums of the same quantised operands, each row
   within 1e-3 of its max-abs in fp32 (2^-7 + 1e-3 in bf16), the norm
   within 5e-4 (2e-3): Hopper's fp8 sums keep fewer bits than fp32; the
   error with fast accumulation (which the port leaves off) and of the
   fp8 scales in `_scaled_mm`'s epilogue against JAX's multiply after it
   (printed); each product's and quantize's time beside bf16 torch.matmul;
30. fp8 gradients in fp32: a 2-layer model at GPT-551M's width (vocab cut
   to 8192), quantization="fp8", full remat, B=1 x 256, on the card (K5-K7,
   `_scaled_mm`) and the CPU (plain versions); each side's own loss
   printed, then the CPU replaying the card's quantised operands (its own
   scales within 2e-3 relative, its values within 1e-2 of amax plus one
   code step), for 3 seeds of parameters and tokens: the loss within 1e-5
   relative and every gradient's max abs error within 2.5e-3 of its leaf's
   max-abs (`QUANT_GRAD_TOL`, set from 8 seeds; not PERF.md §2's 1e-4: the
   card's fp8 sums carry phase 29's error), each seed's three worst leaves
   printed;
31. bench.py:bench_llm on the port: `nemo_tpu_torch/scripts/train_mfu.py:run`
   on GPT-551M (16 layers, d 1536, 12 heads x dh 128, FFN 6144, vocab
   32,768, bf16, flash, full remat, AdamW) at B=8 x 2048 from seed 0, bf16
   and then fp8, one warm-up and 20 timed steps: tokens/s, ms/step, MFU
   against 989 TFLOP/s (fp8 also against 1,979), peak memory, the
   fp8-vs-bf16 loss at the last common read (within 5 %); K5 32, K6 16 and
   K7 16 launches a step, none of the other kernels, `_scaled_mm` 384 a
   step in fp8 only;
32. clip + Adafactor (`core/optim.py:clip_adafactor`) on the card against
   the CPU: Llama-3.2-1B's widths cut to 2 layers and vocab 8192, the same
   parameters and seeded gradients, 3 steps (the first clipped): the
   global norms, every leaf's change (none unchanged) and the second
   moments; then bench.py:bench_llm_1b on the port: `train_mfu.run` on
   Llama-3.2-1B under clip + Adafactor, the same protocol and prints as
   phase 31, its ms/step beside phase 12's AdamW step; K5 32, K6 16 and K7
   16 launches a step;
33. K1, K3 and K4 at head dim 128 (FastConformer-XL: d 1024 over 8 heads)
   against their plain versions, as phases 2 and 4 at dh 64 but each row
   held to its own max (`compare_rows`): K1 at the transcription shape (B=32,
   H=8, T'=376), K3 and K4 at the calibration shape (B=4), ragged and full
   lengths, fp32 and bf16, with their times, device times, bounds, the plain
   versions' times and SDPA's forward and backward given the bias; K3's
   dqu and dqv bitwise equal over a second launch (bf16, ragged and full);
   and the launch shape K1, K3 and K4 chose at dh 128 (`phase_dh128_shapes`:
   threads, warpgroups, cluster, shared-memory bytes, registers and spill
   bytes a thread);
34. FastConformer-XL TDT in fp32 at full width, 2 layers, card against CPU,
   B=2 x 5 s (one ragged), the blank bias shifted so that the random decode
   emits and skips: the encoder output, the token and duration logits along
   the CPU's greedy path (within 1e-3), the tokens (equal up to a near-tie),
   the TDT loss (1e-5 relative) and every parameter's gradient (1e-4 of its
   max), the CPU taking the card's ReLU pre-activations straight through;
35. TDT calibration (bench.py:bench_rnnt on FastConformer-XL TDT, bf16, 24
   layers): rounds of 150 framewise and 150 head-only TDT steps at B=4 x 30
   s, U=40, each round ended by the blank-bias trim, until a held-out probe
   decodes >= 20 tokens/utt (at most 3 rounds); K1 24 launches a framewise
   step, a head-fit step and a decode, K3 and K4 24 a framewise step;
36. the TDT main path: `transcribe_staged` of the calibrated model, B=32 x
   30 s int16 held-out tone batches, one warm and 3 timed:
   fastconformer_tdt_transcribe_rtfx, ms/batch, decoder loops per batch and
   us a loop (encoder against the whole decode by the host's clock), peak
   memory, more than 20 tokens/utt; K1 24 launches a batch;
37. K5-K13 at head dim 96 (Phi-3-mini: 32 heads of dh 96, no query groups;
   the kernels take dh 128's tiles with a zero tail) against their plain
   versions, fp32 and bf16, row by row at phase 9's tolerances: K5-K7 at
   Phi-3's training shape (B=2, 32 over 32, S=4096) and at 32 over 8, S=2048
   with a window of 512; K8-K10 at B=2, S=2048 on three segment layouts (one
   segment a row giving K5-K7's bits); K11-K13 at one CP rank's diagonal
   ring step (Tl=2048); every dq, dk and dv launched twice, bit for bit
   equal; a head dim of 80 refused (ValueError); then the bf16 times (CUDA
   events and device time) of K5-K7 at Phi-3's training shape and of K8-K10
   on the SFT batch (B=8 x 2048), beside their bounds, their plain versions
   and SDPA (causal; given the dense mask);
38. Phi-3-mini in fp32 at full width cut to 2 layers, B=1 x S=256, card
   (K5-K7 at dh 96 under full remat) against CPU: the logits within 1e-3 of
   their max, the loss within 1e-5 relative, every gradient within 1e-4 of
   its leaf's max;
39. Phi-3-mini training, `GPTTrainModule.train_step`: full width, 16 of 32
   layers (2.01 B parameters), B=2 x 4096, bf16, flash, full remat, clip +
   AdamW, one warm-up and 10 timed steps from seed 0: tokens/s, ms/step,
   MFU, peak memory; K5 32, K6 and K7 16 launches a step, none of the other
   kernels;
40. packed SFT of Phi-3-mini: `finetune_recipe("phi3_mini_4k",
   peft_scheme="none", global_batch_size=8)` with its model cut to 16
   layers, `.run` over the synthetic jsonl of phases 13-14 (S=2048), one
   warm-up and 5 timed steps: ms/step, tokens/s, MFU, peak memory; K8 32,
   K9 and K10 16 launches a step, none of the other kernels.

With --profile, one more batch of the transcription path, 6 more calibration
steps, 2 more LLM training steps, 2 more SFT steps, 2 more CP training steps,
one more RNNT batch (and its encoder and whole decode by the host's clock),
6 more RNNT head-fit steps, one more decode bench chunk of each mode and one
more B=8 text → waveform call, one more GPT-551M step in bf16 and in fp8,
one more Llama-3.2-1B Adafactor step, one more TDT batch and 6 TDT head-fit
steps, 2 more Phi-3-mini training steps and 2 more Phi-3-mini SFT steps run
under torch.profiler, and their
device time by kernel and the card's busy share of the wall time are
printed, with the 1B's optimizer steps alone (Adafactor, AdamW). It
ends with a line of the serving paths' launches (phases 24, 27 and 28, each
read just after its run), a JSON line of the kernels (each one's launches on
its main path) and then
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
TF32 is off for the comparisons. Nothing of JAX or `nemo_tpu` is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# peak dense rates and memory rate of one H100 SXM at its 700 W limit
# (NVIDIA's data sheet): the bound of each kernel is reckoned from these
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
CARD = "cuda"  # the device of the card side of every check
# K1 and K2 against their plain versions (atol, rtol): fp32, bf16, and K1's lse
KERNEL_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
LSE_TOL = (1e-3, 1e-4)

B, SECS, SR = 32, 30.0, 16000
TIMED_BATCHES = 5
# calibration at bench.py's values: fit batch, steps per round, tokens per utterance
FIT_BATCH, FIT_STEPS, UTT_TOKENS, DENSITY_FLOOR = 4, 250, 60, 50.0
# LLM training at bench.py:325's shape (bench_llm_1b): batch, sequence, steps
LLM_B, LLM_S, LLM_WARMUP, LLM_STEPS = 8, 2048, 2, 20
# Phi-3-mini-4k (phases 37-40): training batch and sequence (its 4k context),
# the depth of phases 39-40 (16 of 32 layers: 2.01 B parameters, whose fp32
# weights, gradients and AdamW moments take 32 GB where all 32 layers' take
# 61 GB before activations), timed steps after one warm-up (training, SFT)
PHI3_B, PHI3_S, PHI3_LAYERS, PHI3_STEPS, PHI3_SFT_STEPS = 2, 4096, 16, 10, 5
# packed SFT: synthetic examples in the jsonl (the batch and steps are the LLM's)
SFT_EXAMPLES = 2048
SFT_MID = 6  # SFT steps timed again at the middle of the epoch, the first a warm-up
# the step-0 loss of random weights: ln V plus half the logits' variance
# (std 0.02 * sqrt(2048) = 0.9 → +0.41); the band allows [ln V, ln V + 1]
LLM_LOSS_BAND = (0.0, 1.0)
# kinds of device kernels in an LLM training step, by a piece of their names
LLM_KERNEL_KINDS = (
    ("K8 packed flash forward", ("fwd_kernel<64, 1>", "fwd_kernel<96, 1>")),
    ("K9 packed flash dq", ("dq_kernel<64, 1>", "dq_kernel<96, 1>")),
    ("K10 packed flash dk/dv", ("dkv_kernel<64, 1>", "dkv_kernel<96, 1>")),
    ("K11 positions flash forward", ("fwd_kernel<64, 2>",)),
    ("K12 positions flash dq", ("dq_kernel<64, 2>",)),
    ("K13 positions flash dk/dv", ("dkv_kernel<64, 2>",)),
    ("K5 flash forward", ("fwd_kernel<",)), ("K6 flash dq", ("dq_kernel<",)),
    ("K7 flash dk/dv", ("dkv_kernel<",)), ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass", "sm90_")),
    ("optimizer (foreach)", ("multi_tensor",)), ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset", "fill")))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean time of fn() on the card in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean host time of a call of fn() in ms: the wall clock over `iters`
    calls issued back to back, read before the sync that waits for their
    kernels. Where it exceeds `device_ms`, `cuda_ms` reads about this: the
    host's pace, not the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / iters


def device_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms: the summed durations of the device
    operations of `iters` calls under torch.profiler (device activity only),
    over `iters`. Unlike `cuda_ms` it leaves out the gaps between launches,
    so a call whose host work (a wrapper's Python and launch) outlasts its
    kernels is not timed at the host's pace."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # late in a long run a trace sometimes holds no device event: again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            break
    return total / 1e3 / iters


def compare(what: str, out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    """Max abs error; raises where |out - ref| > atol + rtol |ref| anywhere."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (out - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    max_err = float(err.max())
    log(f"{what}: max_abs_err={max_err:.3e} (tolerance atol {atol:g} + rtol {rtol:g}), "
        f"{bad} elements outside")
    if bad:
        raise AssertionError(f"{what}: {bad} elements outside the tolerance")
    return max_err


def compare_rows(what: str, out: torch.Tensor, ref: torch.Tensor, tol: float,
                 norm_tol: float) -> float:
    """Max abs error of an attention output or gradient, each row (the last
    axis: one query's o or dq, one key's dk or dv) held at its own scale,
    since causal rows and keys shrink along the sequence. Raises where |out -
    ref| > tol * max|ref| over the row + tol / 100 * max|ref| anywhere, or
    where ||out - ref|| > norm_tol * ||ref||."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (out - ref).abs()
    limit = tol * ref.abs().amax(-1, keepdim=True) + tol / 100 * float(ref.abs().max())
    worst = float((err / limit).max())
    rel = float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref))
    max_err = float(err.max())
    log(f"{what}: max_abs_err={max_err:.3e}, worst row at {worst:.3f} of its tolerance ({tol:g} "
        f"of the row's max-abs + {tol / 100:g} of the max), rel_norm_err={rel:.3e} "
        f"(tolerance {norm_tol:g})")
    if worst > 1 or rel > norm_tol:
        raise AssertionError(f"{what}: outside the tolerance")
    return max_err


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def flash_bounds(B_: int, H: int, G: int, T: int, dh: int, pairs: float, dtype: torch.dtype,
                 extra_bytes: float = 0.0) -> list:
    """The bounds of K5 (K8, K11), K6 (K9, K12) and K7 (K10, K13) at B_ rows
    of T tokens, H heads over G: each input read and each output written
    once (q, k, v, o and lse; q, k, v, dO, lse, delta and dq; q, k, v, dO,
    lse, delta, dk and dv; plus `extra_bytes`: segment ids or positions), and
    4, 6 and 8 dh operations a kept (query, key) pair."""
    elt = torch.empty(0, dtype=dtype).element_size()
    bq, bk = B_ * T * H * dh, B_ * T * G * dh  # elements of q (or o) and of k
    rows_bytes = 4 * B_ * H * T  # one fp32 value a query row
    return [bound(elt * (2 * bq + 2 * bk) + rows_bytes + extra_bytes, 4 * dh * pairs, dtype),
            bound(elt * (3 * bq + 2 * bk) + 2 * rows_bytes + extra_bytes, 6 * dh * pairs, dtype),
            bound(elt * (2 * bq + 4 * bk) + 2 * rows_bytes + extra_bytes, 8 * dh * pairs, dtype)]


def relpos_bias(qv: torch.Tensor, p: torch.Tensor, lens: torch.Tensor, scale: float,
                dtype) -> torch.Tensor:
    """The rel-pos term and the key mask of K1 as one precomputed additive
    bias [B, H, T, T] in `dtype`: what SDPA is given where it stands in for
    K1 (forward) or K3 + K4 (backward) as the library yardstick."""
    Bn, H, T, _ = qv.shape
    bd = torch.einsum("bhid,hrd->bhir", qv.float(), p.float())
    bd = F.pad(bd, (1, 0)).reshape(Bn, H, 2 * T, T)[:, :, 1:].reshape(
        Bn, H, T, 2 * T - 1)[..., :T] * scale
    keys = torch.arange(T, device=qv.device)[None, :] < lens[:, None]
    return bd.masked_fill_(~keys[:, None, None, :], float("-inf")).to(dtype)


def relpos_backward_inputs(gen: torch.Generator, Bc: int, H: int = 8, T: int = 751,
                           dh: int = 64):
    """fp32 inputs of K3 and K4 at the calibration shape, on the CPU: the
    projected rel-pos table p [2T-1, H, dh] (as the Conformer builds it from
    RelPositionalEncoding) and qu, qv, k, v, dO [Bc, T, H, dh]"""
    from nemo_tpu_torch.models.asr.modules.conformer import RelPositionalEncoding

    D = H * dh
    _, pos_emb = RelPositionalEncoding(D)(torch.zeros(1, T, D))
    p32 = (pos_emb @ (torch.randn(D, D, generator=gen) / math.sqrt(D))).view(2 * T - 1, H, dh)
    return p32, [torch.randn(Bc, T, H, dh, generator=gen) for _ in range(5)]


def subsampling_inputs(gen: torch.Generator, T: int = 3001, Fi: int = 80, C: int = 512):
    """fp32 inputs of K2 at the transcription shape, on the CPU: x [B, T, Fi],
    w1 [3, 3, 1, C], b1, w2 [3, 3, C, C], b2"""
    return (torch.randn(B, T, Fi, generator=gen), torch.randn(3, 3, 1, C, generator=gen) / 3.0,
            0.1 * torch.randn(C, generator=gen),
            torch.randn(3, 3, C, C, generator=gen) / math.sqrt(9 * C),
            0.1 * torch.randn(C, generator=gen))


def speechlike(batch: int, n: int, rng: np.random.RandomState) -> np.ndarray:
    """Pitch-modulated harmonics, an AM envelope and pauses, peak-normalised
    (a copy of bench.py's `_speechlike`), as int16 PCM."""
    t = np.arange(n) / SR
    out = np.zeros((batch, n), np.float32)
    for b in range(batch):
        f0 = 90 + 60 * rng.rand() + 25 * np.sin(2 * np.pi * (2 + rng.rand()) * t)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        x = sum((0.55 ** k) * np.sin((k + 1) * phase) for k in range(5))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (2.5 + rng.rand()) * t + rng.rand() * 6)
        gate = (np.sin(2 * np.pi * 0.7 * t + rng.rand() * 6) > -0.6).astype(np.float32)
        out[b] = (x * env * gate + 0.01 * rng.randn(n)).astype(np.float32)
    out /= np.abs(out).max(axis=1, keepdims=True) + 1e-6
    return np.clip(np.rint(out * 32767.0), -32768, 32767).astype(np.int16)


def phase_build():
    from nemo_tpu_torch.csrc import loader

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    t0 = time.perf_counter()
    libs = loader.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(sorted(libs))} (sm_90a)")
    for name in sorted(libs):
        for line in (loader.BUILD / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_hopper_check(gen: torch.Generator) -> None:
    """The TMA and wgmma wrappers of csrc/hopper.cuh alone, before any
    attention kernel: one warpgroup's four m64nNk16 steps over TMA-loaded
    bf16 tiles against torch.matmul, N = 64 and 128, b K-major (as k) and
    MN-major (as v), a from shared memory (as q), from registers (as P) and
    from shared memory the threads wrote in the swizzle (as K3's and K4's dS
    band); K2's forms, N = 256 and 128 with a written by the threads with
    no swizzle (its h1 patch) and N = 32 with both so (conv1); and N = 96
    with b MN-major over two boxes, the second zero past column 96, and a
    from registers (the dh-96 flash kernels' P v, dS k, P^T dO, dS^T q).
    The products of bf16 values are exact in fp32; only the order and
    rounding of the fp32 sums differ: atol 1e-3 + rtol 1e-4 (a wrong
    descriptor or swizzle moves entries by O(1))."""
    from nemo_tpu_torch.csrc.loader import PLAIN_FORMS, wgmma_tile_product

    for n in (64, 128):
        for mn in (False, True):
            for source in ("tma", "registers", "threads"):
                a = torch.randn(64, 64, generator=gen).to("cuda", torch.bfloat16)
                b = torch.randn(*((64, n) if mn else (n, 64)), generator=gen).to(
                    "cuda", torch.bfloat16)
                c = wgmma_tile_product(a, b, mn, source)
                torch.cuda.synchronize()
                ref = a.float() @ (b.float() if mn else b.float().T)
                compare(f"wgmma m64n{n}k16, b {'MN' if mn else 'K'}-major, a from {source}", c,
                        ref, 1e-3, 1e-4)
    for n, layout, source in PLAIN_FORMS:  # K2's (no swizzle, n 32 and 256) and n 96
        a = torch.randn(64, 64, generator=gen).to("cuda", torch.bfloat16)
        mn = layout == "mn"
        b = torch.randn(*((64, n) if mn else (n, 64)), generator=gen).to("cuda", torch.bfloat16)
        c = wgmma_tile_product(a, b, mn, source, b_plain=layout == "k_plain")
        torch.cuda.synchronize()
        ref = a.float() @ (b.float() if mn else b.float().T)
        compare(f"wgmma m64n{n}k16, b {layout}, a from {source}", c, ref, 1e-3, 1e-4)


def _hold(what: str, out: torch.Tensor, ref: torch.Tensor, dh: int, tol: float,
          atol: Optional[float] = None, rtol: float = 0.0) -> float:
    """The check of a rel-pos kernel's output against its plain version: at
    dh 64 as phases 2 and 4 hold it (`compare`: atol, rtol; atol defaults to
    tol of the max-abs value), at dh 128 row by row (`compare_rows`: tol of
    each row's max-abs value, the relative norm within tol as well, 1e-2 in
    bf16)."""
    if dh == 64:
        return compare(what, out, ref, tol * float(ref.float().abs().max()) if atol is None
                       else atol, rtol)
    return compare_rows(what, out, ref, tol, min(tol, 1e-2))


def phase_k1(gen: torch.Generator, T: int = 751, dh: int = 64) -> dict:
    """2. (dh 64, T' = 751) and 33. (dh 128, T' = 376): K1 against its plain
    version at the transcription shape, timed beside it and SDPA."""
    from nemo_tpu_torch.models.asr.modules.conformer import RelPositionalEncoding
    from nemo_tpu_torch.ops.flash_attention import (relpos_flash_attention,
                                                    relpos_flash_attention_plain)

    H = 8
    D, scale = H * dh, 1.0 / math.sqrt(dh)
    tag = "K1" if dh == 64 else "K1 dh128"
    _, pos_emb = RelPositionalEncoding(D)(torch.zeros(1, T, D))
    w_pos = torch.randn(D, D, generator=gen) / math.sqrt(D)
    p32 = (pos_emb @ w_pos).view(2 * T - 1, H, dh)  # [2T-1, H, dh], as the module builds it
    # the Linear outputs are [B, T, H, dh]; the kernel reads them as such
    base = [torch.randn(B, T, H, dh, generator=gen) for _ in range(4)]
    ragged = torch.tensor([T - 37 * (i % 9) for i in range(B)], dtype=torch.int32)
    full = torch.full((B,), T, dtype=torch.int32)
    row = {"name": "relpos_flash_attention" + ("" if dh == 64 else "_dh128"), "route": "cuda",
           "source": "nemo_tpu_torch/csrc/relpos_flash.cu",
           "replaces": "nemo_tpu/ops/flash_attention.py:77"}
    for dtype, (atol, rtol) in KERNEL_TOL.items():
        qu, qv, k, v = (t.to("cuda", dtype).transpose(1, 2) for t in base)
        p = p32.to("cuda", dtype).transpose(0, 1)
        for lengths in (ragged, full):
            lens = lengths.cuda()
            o, lse = relpos_flash_attention(qu, qv, k, v, p, lens, scale)
            o_ref, lse_ref = relpos_flash_attention_plain(qu, qv, k, v, p, lens, scale)
            torch.cuda.synchronize()
            valid = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, :].expand(
                B, H, T)  # padded query rows are garbage by design
            what = f"{tag} {str(dtype)[6:]} lengths={'ragged' if lengths is ragged else 'full'}"
            err = _hold(what, o[valid], o_ref[valid], dh, rtol, atol, rtol)
            compare(what + " lse", lse[valid], lse_ref[valid], *LSE_TOL)
        del o_ref, lse_ref
        args = (qu, qv, k, v, p, lens, scale)  # the main path's lengths: full 30 s clips
        ms = cuda_ms(lambda: relpos_flash_attention(*args), iters=10)
        dev_ms = device_ms(lambda: relpos_flash_attention(*args), iters=10)
        plain_ms = cuda_ms(lambda: relpos_flash_attention_plain(*args), iters=3)
        # SDPA as a yardstick, given the rel-pos term and the key mask as one
        # precomputed additive bias [B, H, T, T]
        bias = relpos_bias(qv, p, lens, scale, dtype)
        def sdpa():
            return F.scaled_dot_product_attention(qu, k, v, attn_mask=bias, scale=scale)

        library_ms, library_dev_ms = cuda_ms(sdpa, iters=5), device_ms(sdpa, iters=5)
        del bias
        elt = qu.element_size()
        n_bytes = elt * (5 * B * T * H * dh + (2 * T - 1) * H * dh) + 4 * B + 4 * B * H * T
        n_ops = 6 * H * dh * T * float(lens.sum())
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
        log(f"{tag} {str(dtype)[6:]}: kernel_ms={ms:.4f} (device {dev_ms:.4f}) "
            f"plain_ms={plain_ms:.4f} library_ms(SDPA+bias)={library_ms:.4f} (device "
            f"{library_dev_ms:.4f}) bound_ms={bound_ms:.4f} ({bound_by})")
        row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)  # bf16, the main path's type, last
    return row


def phase_dh128_shapes() -> None:
    """33. The launch shape of K1, K3 and K4 at dh 128 (the redesigned
    blocks), from `cudaFuncGetAttributes` of the built kernels: a spill shows
    as local bytes on the card's own line, and fails the phase."""
    from nemo_tpu_torch.ops.flash_attention import relpos_kernel_shape

    for kernel, tag in (("fwd", "K1"), ("dq", "K3"), ("dkv", "K4")):
        shape = relpos_kernel_shape(kernel, 128)
        log(f"{tag} dh128 launch shape: {shape['threads']} threads, {shape['warpgroups']} consumer "
            f"warpgroups, cluster {shape['cluster']}, {shape['shared_bytes']} bytes of shared "
            f"memory, {shape['registers']} registers a thread at launch, "
            f"{shape['local_bytes']} local (spill) bytes a thread")
        if shape["local_bytes"]:
            raise AssertionError(f"{tag} dh128: {shape['local_bytes']} bytes of local memory")


def phase_k2(gen: torch.Generator) -> dict:
    from nemo_tpu_torch.ops.subsampling_kernel import (fused_subsampling_x4,
                                                       fused_subsampling_x4_plain)

    T, Fi, C = 3001, 80, 512
    x32, w1_32, b1_32, w2_32, b2_32 = subsampling_inputs(gen, T, Fi, C)
    row = {"name": "fused_subsampling_x4", "route": "cuda",
           "source": "nemo_tpu_torch/csrc/fused_subsampling.cu",
           "replaces": "nemo_tpu/ops/subsampling_kernel.py:34"}
    for dtype, (atol, rtol) in KERNEL_TOL.items():
        args = [t.to("cuda", dtype) for t in (x32, w1_32, b1_32, w2_32, b2_32)]
        out = fused_subsampling_x4(*args)
        ref = fused_subsampling_x4_plain(*args)
        torch.cuda.synchronize()
        if out.shape != (B, 751, 20 * C):
            raise AssertionError(f"K2: output shape {tuple(out.shape)}")
        err = compare(f"K2 {str(dtype)[6:]}", out, ref, atol, rtol)
        del out, ref
        ms = cuda_ms(lambda: fused_subsampling_x4(*args), iters=3)
        dev_ms = device_ms(lambda: fused_subsampling_x4(*args), iters=3)
        plain_ms = cuda_ms(lambda: fused_subsampling_x4_plain(*args), iters=5)
        # the library yardstick: the cuDNN conv pair alone in the kernel's
        # dtype, NCHW, without the plain version's casts and layout copies
        x4, w1, b1, w2, b2 = args[0][:, None], args[1].permute(3, 2, 0, 1).contiguous(), \
            args[2], args[3].permute(3, 2, 0, 1).contiguous(), args[4]
        def pair():
            return F.conv2d(F.conv2d(x4, w1, b1, 2, 1).relu_(), w2, b2, 2, 1).relu_()

        library_ms, library_dev_ms = cuda_ms(pair, iters=5), device_ms(pair, iters=5)
        elt = args[0].element_size()
        T2, F2, T4, F4 = 1501, 40, 751, 20
        n_bytes = elt * (B * T * Fi + 9 * C + C + 9 * C * C + C + B * T4 * F4 * C)
        n_ops = 2 * B * T4 * F4 * C * 9 * C + 2 * B * T2 * F2 * C * 9
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
        log(f"K2 {str(dtype)[6:]}: kernel_ms={ms:.4f} (device {dev_ms:.4f}) "
            f"plain_ms(fp32 cuDNN pair + layout)={plain_ms:.4f} "
            f"library_ms(cuDNN pair in {str(dtype)[6:]})={library_ms:.4f} (device "
            f"{library_dev_ms:.4f}) bound_ms={bound_ms:.4f} ({bound_by})")
        row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
    return row


def phase_k3_k4(gen: torch.Generator, T: int = 751, dh: int = 64):
    """4. (dh 64, T' = 751) and 33. (dh 128, T' = 376): K3 and K4 against the
    plain backward at the calibration shape, timed beside it and SDPA's
    backward."""
    from nemo_tpu_torch.ops.flash_attention import (relpos_flash_attention,
                                                    relpos_flash_attention_backward_plain,
                                                    relpos_flash_dkv, relpos_flash_dq, row_delta)

    Bc, H = FIT_BATCH, 8
    scale = 1.0 / math.sqrt(dh)
    p32, base = relpos_backward_inputs(gen, Bc, H, T, dh)  # p; qu, qv, k, v, dO
    ragged = torch.tensor([T, T - 51, T - 138, T - 251], dtype=torch.int32)
    full = torch.full((Bc,), T, dtype=torch.int32)
    sfx, tag = ("", "") if dh == 64 else ("_dh128", " dh128")
    rows = [{"name": "relpos_flash_dq" + sfx, "route": "cuda",
             "source": "nemo_tpu_torch/csrc/relpos_flash_bwd.cu",
             "replaces": "nemo_tpu/ops/flash_attention.py:213"},
            {"name": "relpos_flash_dkv" + sfx, "route": "cuda",
             "source": "nemo_tpu_torch/csrc/relpos_flash_bwd.cu",
             "replaces": "nemo_tpu/ops/flash_attention.py:257"}]
    names = ("dqu", "dqv", "dk", "dv", "dp")
    # tolerance relative to each gradient's max-abs value: fp32 differs by the
    # order of sums (dp's reductions change it from run to run), bf16 also by the
    # kernels' rounding of P and dS to bf16 before each product
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        qu, qv, k, v, do = (t.to("cuda", dtype).transpose(1, 2) for t in base)
        p = p32.to("cuda", dtype).transpose(0, 1)
        for lengths in (ragged, full):
            lens = lengths.cuda()
            args = (qu, qv, k, v, p, lens, scale)
            o, lse = relpos_flash_attention(*args)
            delta = row_delta(o, do)
            out = (*relpos_flash_dq(*args, lse, delta, do), *relpos_flash_dkv(*args, lse, delta, do))
            ref = relpos_flash_attention_backward_plain(*args, o, lse, do)
            torch.cuda.synchronize()
            errs = []
            for name, x, r in zip(names, out, ref):
                what = (f"K{3 if name.startswith('dq') else 4}{tag} {str(dtype)[6:]} "
                        f"lengths={'ragged' if lengths is ragged else 'full'} {name}")
                errs.append(_hold(what, x, r, dh, tol))
            del ref
            if dh == 128 and dtype == torch.bfloat16:  # one block sums each row, in one order
                again = relpos_flash_dq(*args, lse, delta, do)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(out[:2], again))
                log(f"K3{tag} bf16 lengths={'ragged' if lengths is ragged else 'full'}: a second "
                    f"launch gives {'bitwise-equal' if same else 'DIFFERENT'} dqu and dqv")
                if not same:
                    raise AssertionError(f"K3{tag}: dqu, dqv differ between two launches")
        args = (qu, qv, k, v, p, lens, scale)  # the calibration's lengths: full 30 s clips
        k3 = lambda: relpos_flash_dq(*args, lse, delta, do)  # noqa: E731
        k4 = lambda: relpos_flash_dkv(*args, lse, delta, do)  # noqa: E731
        ms3, ms4 = cuda_ms(k3, iters=10), cuda_ms(k4, iters=10)
        # and the kernels' own device time, without the gaps between launches
        dev3, dev4 = device_ms(k3, iters=10), device_ms(k4, iters=10)
        plain_ms = cuda_ms(lambda: relpos_flash_attention_backward_plain(*args, o, lse, do),
                           iters=3)
        # SDPA's backward (dq, dk, dv) as a yardstick, given the rel-pos term
        # and the key mask as one precomputed additive bias [B, H, T, T]
        bias = relpos_bias(qv, p, lens, scale, dtype)
        ql, kl, vl = (t.detach().requires_grad_() for t in (qu, k, v))
        o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, scale=scale)
        sdpa_bwd = lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,  # noqa: E731
                                               retain_graph=True)
        library_ms = cuda_ms(sdpa_bwd, iters=5)
        library_device_ms = device_ms(sdpa_bwd, iters=5)
        del o_lib, bias, sdpa_bwd
        elt = qu.element_size()
        btd = Bc * T * H * dh
        pairs = T * float(lens.sum())  # (query row, valid key) pairs
        common = elt * (5 * btd + (2 * T - 1) * H * dh) + 4 * Bc + 2 * 4 * Bc * H * T
        b3 = bound(common + elt * 2 * btd, 10 * H * dh * pairs, dtype)  # 5 products
        b4 = bound(common + elt * 2 * btd + 4 * (2 * T - 1) * H * dh, 12 * H * dh * pairs,
                   dtype)  # 6 products
        for row, ms, dev, (bound_ms, bound_by), err in (
                (rows[0], ms3, dev3, b3, max(errs[:2])), (rows[1], ms4, dev4, b4, max(errs[2:]))):
            log(f"{'K3' if row is rows[0] else 'K4'}{tag} {str(dtype)[6:]} B={Bc}: "
                f"kernel_ms={ms:.4f} "
                f"(device {dev:.4f}) plain_ms(whole backward)={plain_ms:.4f} "
                f"library_ms(SDPA backward+bias)={library_ms:.4f} (device "
                f"{library_device_ms:.4f}) bound_ms={bound_ms:.4f} ({bound_by})")
            row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms, device_ms=dev,
                       library_device_ms=library_device_ms)  # bf16 last
    return rows


def phase_grad_exactness() -> None:
    """The calibration loss of a 2-layer model at d_model 512 (8 heads of
    64, both flags, fp32): every variable's gradient on the card (K1, K3, K4,
    the conv pair) against the CPU's (plain versions), within 1e-4 of the
    leaf's max-abs value plus 1e-6 (for leaves whose exact gradient is 0,
    such as linear_k's bias). Both encoders take the CPU's mel features:
    the frontends differ by ~4e-6, which flips ReLU gates of the first conv
    and moves its weight gradient by ~2e-3 of its max (measured on one H100)."""
    from nemo_tpu_torch.models.asr.configs import conformer_ctc
    from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel
    from nemo_tpu_torch.interop.jax_params import model_variables

    cfg = conformer_ctc("large", att_impl="decomposed_flash", fused_subsampling=True)
    cfg.encoder.n_layers = 2
    rng = np.random.RandomState(2)
    pcm = torch.from_numpy(speechlike(2, int(5 * SR), rng))
    lens = torch.tensor([5 * SR, 61000], dtype=torch.int32)
    labels = torch.from_numpy(rng.randint(0, 29, (2, 100)))
    grads, feats = {}, None
    for device in ("cpu", "cuda"):
        model = EncDecCTCModel(cfg, device=device, seed=1)
        if feats is None:
            with torch.no_grad():
                feats = model.mel_features(pcm, lens)
        leaves = model_variables(model)
        for t in leaves.values():
            t.requires_grad_(True)
        enc, _ = model.encoder(*(x.to(device) for x in feats), conv_pair_subsampling=True)
        lp = model.decoder(enc)[:, :labels.shape[1]]
        loss = -lp.gather(-1, labels.to(device)[..., None])[..., 0].mean()
        grads[device] = [g.cpu() for g in torch.autograd.grad(loss, list(leaves.values()))]
        del model
    worst, bad = 0.0, []
    for name, g, ref in zip(leaves, grads["cuda"], grads["cpu"]):
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        err = float((g - ref).abs().max())
        worst = max(worst, err / tol)
        if not torch.isfinite(g).all() or err > tol:
            bad.append(name)
    log(f"gradients fp32, 2 layers d_model 512, B=2 x 5 s, cuda (K1, K3, K4) vs cpu (plain): "
        f"{len(leaves)} variables, worst max_abs_err = {worst:.3f} of its tolerance "
        f"(1e-4 of the leaf's max-abs + 1e-6)")
    if bad:
        raise AssertionError(f"gradients disagree on {bad}")


def phase_calibration(counters: dict):
    """bench.py's calibration on the port; returns (model, staged eval
    batches, launch counts of the calibration run)."""
    from nemo_tpu_torch.models.asr.synthetic import calibrated_tone_batches

    model = _model("bfloat16", None)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    staged, density, rounds = calibrated_tone_batches(
        model, B, SECS, UTT_TOKENS, TIMED_BATCHES, fit_steps=FIT_STEPS,
        density_floor=DENSITY_FLOOR, fit_batch=FIT_BATCH, log=log)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for i, r in enumerate(rounds):
        log(f"calibration round {i}: final loss {r['loss']:.4f}, "
            f"{1e3 * r['seconds'] / r['steps']:.2f} ms/step (B={FIT_BATCH} x {SECS:g} s), "
            f"peak_mem={r['peak_mem_gib']:.2f} GiB, probe density {r['density']:.1f} chars/utt")
    steps = FIT_STEPS * len(rounds)
    want = {"k1": 18 * (steps + len(rounds)), "k2": len(rounds), "k3": 18 * steps,
            "k4": 18 * steps}  # each round's probe is one transcription batch
    log(f"calibration: {len(rounds)} round(s), {steps} steps, {wall:.1f} s in all "
        f"(with the probes and the eval batches' build), probe density {density:.1f} "
        f"chars/utt, launches {launches}")
    if launches != want:
        raise AssertionError(f"calibration launch counts {launches}, expected {want}")
    return model, staged, launches


def _model(dtype: str, device: str):
    from nemo_tpu_torch.models.asr.configs import conformer_ctc
    from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel

    cfg = conformer_ctc("large", compute_dtype=dtype, att_impl="decomposed_flash",
                        fused_subsampling=True)
    return EncDecCTCModel(cfg, device=device, seed=0)


def phase_exactness(k1, k2) -> None:
    tol = 1e-3
    pcm = speechlike(2, int(5 * SR), np.random.RandomState(1))
    lens = torch.tensor([5 * SR, 61000], dtype=torch.int32)
    out, launches = {}, {}
    for device in ("cuda", "cpu"):
        model = _model("float32", device)
        k1.launches = k2.launches = 0
        lp, n = model(torch.from_numpy(pcm).to(device), lens.to(device))
        out[device] = (lp.float().cpu(), n.cpu())
        launches[device] = (k1.launches, k2.launches)
        del model
    if launches != {"cuda": (18, 1), "cpu": (0, 0)}:  # the CPU run takes the plain versions
        raise AssertionError(f"launches per forward: {launches}")
    (lp, n), (ref, ref_n) = out["cuda"], out["cpu"]
    if not torch.equal(n, ref_n):
        raise AssertionError(f"frame lengths differ: {n} vs {ref_n}")
    err, frames, agree = 0.0, 0, 0
    for b, t in enumerate(n.tolist()):
        a, r = lp[b, :t], ref[b, :t]
        err = max(err, float((a - r).abs().max()))
        same = a.argmax(-1) == r.argmax(-1)
        top2 = r.topk(2, dim=-1).values
        if not bool(((top2[:, 0] - top2[:, 1]) < 2 * tol)[~same].all()):
            raise AssertionError("greedy ids differ on a frame that is not a near-tie")
        frames, agree = frames + t, agree + int(same.sum())
    log(f"slice fp32, cuda (kernels) vs cpu (plain), B=2 x 5 s: max_abs_logprob_diff={err:.3e} "
        f"(tolerance {tol:g}), greedy ids agree on {agree}/{frames} frames")
    if err > tol or not torch.isfinite(lp).all():
        raise AssertionError("whole-slice log-probs disagree")


def profile_batch(model, staged) -> None:
    """One batch of the main path under torch.profiler: device time by kernel,
    and the card's busy share (kernel time over the host's wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.transcribe_staged(staged)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    log(events.table(sort_by="self_device_time_total", row_limit=30))
    busy_us = sum(e.self_device_time_total for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)  # kernels only
    log(f"profile, one batch: wall {wall_us / 1e3:.2f} ms, kernels {busy_us / 1e3:.2f} ms, "
        f"card idle {100 - 100 * busy_us / wall_us:.1f} % of the wall time")


def profile_training(model) -> None:
    """Where a calibration step's time goes (after the main path, since the
    steps move the weights): the host's time to make one tone batch, then 6
    steps under torch.profiler (device activity only, to keep its host
    overhead low): the step's wall time, its kernel time, and the card's idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    from nemo_tpu_torch.models.asr.synthetic import (frame_labels, framewise_calibrate,
                                                     tone_audio)

    rng = np.random.RandomState(7)
    t0 = time.perf_counter()
    for _ in range(5):
        targets = rng.randint(1, 12, (FIT_BATCH, UTT_TOKENS))
        tone_audio(targets, SECS, SR, rng)
        frame_labels(targets, SECS, 751, 28, SR)
    data_ms = 1e3 * (time.perf_counter() - t0) / 5
    steps = 6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        framewise_calibrate(model, steps=steps, batch=FIT_BATCH, secs=SECS,
                            utt_tokens=UTT_TOKENS, seed=7, log=lambda msg: None)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"profile, calibration step (B={FIT_BATCH} x {SECS:g} s): wall {wall_ms:.2f} ms, "
        f"kernels {busy_ms:.2f} ms in {len(kernels) / steps:.0f} device operations, card idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f} % of the wall time; the host makes one tone "
        f"batch in {data_ms:.2f} ms")


def phase_main_path(model, staged, k1, k2, profile: bool) -> dict:
    lens = staged[0][1]
    n = int(SECS * SR)
    lp, enc_len = model(staged[0][0], lens)
    frames = (n // 160) // 4 + 1  # hop 10 ms, then subsampling x4
    if lp.shape != (B, frames, 29) or not torch.isfinite(lp).all() or int(enc_len.min()) != frames:
        raise AssertionError(f"bf16 forward: shape {tuple(lp.shape)} or non-finite values")
    del lp
    model.transcribe_staged(staged[:1])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    texts = model.transcribe_staged(staged[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": k1.launches, "k2": k2.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rtfx = B * SECS * TIMED_BATCHES / wall
    density = sum(map(len, texts)) / len(texts)
    log(f"main path, transcribe_staged bf16 B={B} x {SECS:g} s, calibrated weights, held-out "
        f"tone audio, {TIMED_BATCHES} timed batches: RTFx={rtfx:.1f}, "
        f"{1e3 * wall / TIMED_BATCHES:.1f} ms/batch, peak_mem={peak:.2f} GiB, "
        f"{density:.1f} chars/utt, launches K1={launches['k1']} K2={launches['k2']}")
    if len(texts) != B * TIMED_BATCHES or not all(isinstance(s, str) for s in texts):
        raise AssertionError("transcribe_staged returned the wrong number of texts")
    if density <= DENSITY_FLOOR:
        raise AssertionError(f"decode density {density:.1f} <= {DENSITY_FLOOR} chars/utt")
    want = {"k1": 18 * TIMED_BATCHES, "k2": TIMED_BATCHES}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if profile:
        profile_batch(model, staged[1:2])
        profile_training(model)
    return launches


def _gqa_inputs(gen: torch.Generator, B_: int, H: int, G: int, T: int, dh: int, dtype):
    """q, dO [B, H, T, dh] and k, v [B, G, T, dh] on the card, as views of
    the [B, T, heads, dh] Linear-output layout the kernels read."""
    q, do = (torch.randn(B_, T, H, dh, generator=gen).to("cuda", dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B_, T, G, dh, generator=gen).to("cuda", dtype).transpose(1, 2)
            for _ in range(2))
    return q, k, v, do


def check_k5_k7(what: str, q, k, v, do, scale: float, window):
    """K5 (through the model's wrapper, its lse from a launch of its own), K6
    and K7 on one input against their plain versions at phase 9's
    tolerances: o within (atol, rtol) and row by row, lse within 1e-3 + 1e-4
    relative, each gradient row by row (one query's o or dq, one key's dk or
    dv) and by its relative norm. Returns o [B, H, T, dh], lse, (dq, dk, dv)
    and the max abs errors of K5, K6, K7."""
    from nemo_tpu_torch.ops.flash_attention import (_k5_launch, flash_attention,
                                                    flash_attention_backward_plain,
                                                    flash_attention_plain, flash_dkv, flash_dq,
                                                    row_delta)

    # (K5 atol, rtol), gradients' tolerance of each row's max, relative norm
    tol, gtol, ntol = (((1e-4, 1e-4), 1e-4, 1e-5) if q.dtype == torch.float32
                       else ((1e-2, 2e-2), 3e-2, 1e-2))
    o = flash_attention(q, k, v, scale, True, window)  # the wrapper the model calls
    _, lse = _k5_launch(q, k, v, scale, True, window)
    o_ref, lse_ref = flash_attention_plain(q, k, v, scale, True, window)
    err5 = compare(f"K5 {what}", o, o_ref, *tol)
    compare_rows(f"K5 {what} by row", o, o_ref, tol[1], ntol)
    compare(f"K5 {what} lse", lse, lse_ref, 1e-3, 1e-4)
    del o_ref, lse_ref
    args = (q, k, v, scale, True, window, lse, row_delta(o, do), do)
    out = (flash_dq(*args), *flash_dkv(*args))
    ref = flash_attention_backward_plain(q, k, v, scale, True, window, o, lse, do)
    torch.cuda.synchronize()
    grad_errs = [compare_rows(f"K{6 if name == 'dq' else 7} {what} {name}", x, r, gtol, ntol)
                 for name, x, r in zip(("dq", "dk", "dv"), out, ref)]
    return o, lse, out, [err5, grad_errs[0], max(grad_errs[1:])]


def phase_k5_k7(gen: torch.Generator):
    """K5, K6 and K7 against their plain versions at B=2, S=2048 (Llama's
    32 heads over 8 kv heads at dh 64, with no window and a window of 512;
    GPT-551M's 12 heads at dh 128); K5 also at the shape `LLMServer.score`
    gives it (B=1, S=256, Llama's heads); then, at the training shape
    (B=8, S=2048), Llama's heads in fp32 and bf16 and, in bf16, GPT-551M's
    (12 heads over 12 at dh 128), each checked again and timed
    (`_time_k5_k7`). Returns the rows of both shapes."""
    from nemo_tpu_torch.ops.flash_attention import (_k5_launch, flash_attention,
                                                    flash_attention_plain)

    rows = [{"name": name, "route": "cuda", "source": f"nemo_tpu_torch/csrc/{src}.cu",
             "replaces": f"nemo_tpu/ops/flash_attention.py:{line} (causal GQA)"}
            for name, src, line in (("flash_attention", "flash_fwd", 77),
                                    ("flash_dq", "flash_bwd", 213),
                                    ("flash_dkv", "flash_bwd", 257))]
    errs, errs128 = {}, {}  # kernel → worst bf16 max abs error (over all; at GPT-551M's heads)
    for (H, G, dh, window), dtype in ((c, d) for c in ((32, 8, 64, None), (32, 8, 64, 512),
                                                       (12, 12, 128, None))
                                      for d in (torch.float32, torch.bfloat16)):
        q, k, v, do = _gqa_inputs(gen, 2, H, G, LLM_S, dh, dtype)
        what = f"{str(dtype)[6:]} B=2 H={H} G={G} dh={dh} window={window}"
        *_, err = check_k5_k7(what, q, k, v, do, 1.0 / math.sqrt(dh), window)
        if dtype == torch.bfloat16:
            for key, e in zip(("k5", "k6", "k7"), err):
                errs[key] = max(errs.get(key, 0.0), e)
                if dh == 128:
                    errs128[key] = e
    for dtype in (torch.float32, torch.bfloat16):  # the serving path's score (phase 24)
        tol, ntol = ((1e-4, 1e-4), 1e-5) if dtype == torch.float32 else ((1e-2, 2e-2), 1e-2)
        q, k, v, _ = _gqa_inputs(gen, 1, 32, 8, SCORE_S, 64, dtype)
        what = f"{str(dtype)[6:]} B=1 S={SCORE_S} H=32 G=8 dh=64 (score)"
        o, (o_ref, lse_ref) = flash_attention(q, k, v, 0.125), flash_attention_plain(q, k, v, 0.125)
        err5 = compare(f"K5 {what}", o, o_ref, *tol)
        compare_rows(f"K5 {what} by row", o, o_ref, tol[1], ntol)
        compare(f"K5 {what} lse", _k5_launch(q, k, v, 0.125, True, None)[1], lse_ref, 1e-3, 1e-4)
        if dtype == torch.bfloat16:
            errs["k5"] = max(errs["k5"], err5)

    # the checks and times at Llama's training shape, then (bf16) at GPT-551M's (phase 31's rows)
    rows551 = [dict(row, name=f"{row['name']} (GPT-551M, dh 128)") for row in rows]
    for H, G, dh, dtypes, out, err in ((32, 8, 64, (torch.float32, torch.bfloat16), rows, errs),
                                       (12, 12, 128, (torch.bfloat16,), rows551, errs128)):
        _time_k5_k7(gen, H, G, dh, dtypes, out, err)
    torch.cuda.empty_cache()
    return rows, rows551


def _time_k5_k7(gen: torch.Generator, H: int, G: int, dh: int, dtypes, rows: list,
                errs: dict) -> None:
    """K5, K6 and K7 at the training paths' shape, B=8, S=2048, with H heads
    over G at dh: held against their plain versions on the same inputs at
    phase 9's tolerances (the persistent grids walk 4x the tiles of phase
    9's B=2), then timed beside the plain versions and SDPA; fills `rows`
    (the last dtype's numbers; max_abs_err the worse of `errs`, phase 9's
    B=2 error, and this one)."""
    from nemo_tpu_torch.ops.flash_attention import (_k5_launch, flash_attention,
                                                    flash_attention_backward_plain,
                                                    flash_attention_plain, flash_dkv, flash_dq,
                                                    row_delta)

    scale, pairs = 1.0 / math.sqrt(dh), LLM_B * H * LLM_S * (LLM_S + 1) / 2
    for dtype in dtypes:
        # phase 9's (K5 atol, rtol), gradients' tolerance of each row's max, relative norm
        tol, gtol, ntol = (((1e-4, 1e-4), 1e-4, 1e-5) if dtype == torch.float32
                           else ((1e-2, 2e-2), 3e-2, 1e-2))
        q, k, v, do = _gqa_inputs(gen, LLM_B, H, G, LLM_S, dh, dtype)
        o, lse = _k5_launch(q, k, v, scale, True, None)
        o = o.transpose(1, 2)
        args = (q, k, v, scale, True, None, lse, row_delta(o, do), do)
        what = f"{str(dtype)[6:]} B={LLM_B} H={H} G={G} dh={dh} window=None"
        o_fa = flash_attention(q, k, v, scale)  # the wrapper the model calls
        o_ref, lse_ref = flash_attention_plain(q, k, v, scale, True, None)
        err = [compare(f"K5 {what}", o_fa, o_ref, *tol)]
        compare_rows(f"K5 {what} by row", o_fa, o_ref, tol[1], ntol)
        compare(f"K5 {what} lse", lse, lse_ref, 1e-3, 1e-4)
        del o_fa, o_ref, lse_ref
        out = (flash_dq(*args), *flash_dkv(*args))
        ref = flash_attention_backward_plain(q, k, v, scale, True, None, o, lse, do)
        torch.cuda.synchronize()
        grad_errs = [compare_rows(f"K{6 if name == 'dq' else 7} {what} {name}", x, r, gtol, ntol)
                     for name, x, r in zip(("dq", "dk", "dv"), out, ref)]
        err += [grad_errs[0], max(grad_errs[1:])]
        del out, ref
        fast = dtype == torch.bfloat16
        ms = [cuda_ms(lambda: flash_attention(q, k, v, scale), iters=20 if fast else 3),
              cuda_ms(lambda: flash_dq(*args), iters=20 if fast else 3),
              cuda_ms(lambda: flash_dkv(*args), iters=20 if fast else 3)]
        plain_fwd = cuda_ms(lambda: flash_attention_plain(q, k, v, scale, True, None), iters=3)
        plain_bwd = cuda_ms(lambda: flash_attention_backward_plain(
            q, k, v, scale, True, None, o, lse, do), iters=3)
        # SDPA, causal with GQA, as the library yardstick: forward, backward
        # alone (dq, dk, dv), and forward + backward
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            ql, kl, vl, is_causal=True, scale=scale, enable_gqa=True)
        lib_fwd = cuda_ms(sdpa, iters=20 if fast else 3)
        o_lib = sdpa()
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,
                                                      retain_graph=True), iters=10 if fast else 3)
        lib_both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (ql, kl, vl), do),
                           iters=10 if fast else 3)
        del o_lib
        bounds = flash_bounds(LLM_B, H, G, LLM_S, dh, pairs, dtype)
        name = str(dtype)[6:]
        log(f"SDPA {name} B={LLM_B} H={H} G={G} dh={dh} causal GQA: forward {lib_fwd:.4f} ms, "
            f"backward {lib_bwd:.4f} ms, forward+backward {lib_both:.4f} ms")
        for i, (row, plain_ms, lib_ms) in enumerate(zip(rows, (plain_fwd, plain_bwd, plain_bwd),
                                                         (lib_fwd, lib_bwd, lib_bwd))):
            bound_ms, bound_by = bounds[i]
            log(f"K{5 + i} {name} B={LLM_B} H={H} G={G} S={LLM_S} dh={dh}: kernel_ms={ms[i]:.4f} "
                f"plain_ms({'forward' if i == 0 else 'whole backward'})={plain_ms:.4f} "
                f"library_ms(SDPA {'forward' if i == 0 else 'backward'})={lib_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by})")
            row.update(max_abs_err=max(errs[f"k{5 + i}"], err[i]), ms=ms[i], plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)  # bf16 last
        del q, k, v, do, o, lse, args, ql, kl, vl


def _llm_cfg(**kw):
    from nemo_tpu_torch.models.llm.config import llama32_1b

    return llama32_1b(**{"seq_length": LLM_S, "compute_dtype": "bfloat16",
                         "attention_backend": "flash", "remat": "full", **kw})


def _card_vs_cpu(cfg, what: str, logits: bool = False) -> None:
    """fp32 loss and gradients of `cfg`'s model from seed 0 on one seeded
    batch of B=1 x S=cfg.seq_length, on the card (the flash kernels under
    full remat) against the CPU (plain versions): the loss within 1e-5
    relative, every gradient within 1e-4 of its leaf's max-abs plus 1e-6 and,
    with `logits`, the logits within 1e-3 of their max-abs."""
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    S = cfg.seq_length
    rng = np.random.RandomState(3)
    tokens, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, S))) for _ in range(2))
    cpu = GPTTrainModule(cfg, device="cpu", seed=0)
    card = GPTTrainModule(cfg, device="cuda", seed=0)
    card.model.load_state_dict(cpu.model.state_dict())
    out = {}
    for name, mod in (("cpu", cpu), ("cuda", card)):
        loss = mod.loss(tokens.to(mod.device), labels.to(mod.device))
        grads = torch.autograd.grad(loss, mod.params)
        out[name] = (float(loss.detach()), [g.cpu() for g in grads])
        if logits:
            with torch.no_grad():
                out[name] += (mod.model(tokens.to(mod.device)).cpu(),)
    (loss, grads, *z), (ref_loss, ref_grads, *z_ref) = out["cuda"], out["cpu"]
    worst, bad = 0.0, []
    for (pname, _), g, ref in zip(cpu.model.named_parameters(), grads, ref_grads):
        tol = 1e-4 * float(ref.abs().max()) + 1e-6
        err = float((g - ref).abs().max())
        worst = max(worst, err / tol)
        if not torch.isfinite(g).all() or err > tol:
            bad.append(pname)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    z_err = 0.0
    if logits:
        z_err = float((z[0] - z_ref[0]).abs().max() / z_ref[0].abs().max())
        if not torch.isfinite(z[0]).all() or z_err > 1e-3:
            bad.append("logits")
    log(f"{what}: loss {loss:.6f} vs {ref_loss:.6f} (rel {rel:.2e}, tolerance 1e-5); "
        + (f"logits max_abs_err {z_err:.3e} of their max-abs (tolerance 1e-3); " if logits
           else "") + f"{len(ref_grads)} gradients, worst max_abs_err = {worst:.3f} of its "
        f"tolerance (1e-4 of the leaf's max-abs + 1e-6)")
    if rel > 1e-5 or bad:
        raise AssertionError(f"{what}: loss, logits or gradients disagree: rel {rel:.2e}, "
                             f"failing {bad}")


def phase_llm_grad_exactness(cp_size: int = 1) -> None:
    """fp32 loss and gradients of a 2-layer model at Llama-3.2-1B's width
    (hidden 2048, 32 heads over 8, FFN 8192, llama3 RoPE; the vocab cut to
    8192 to keep the CPU side cheap), B=1 x S=256, on the card (K5-K7 under
    full remat; with cp_size 2 the ring over K11-K13, every rank in one
    process) against the CPU (plain versions): the loss within 1e-5
    relative, every gradient within 1e-4 of its leaf's max-abs plus 1e-6."""
    cfg = _llm_cfg(num_layers=2, vocab_size=8192, seq_length=256, compute_dtype="float32",
                   cp_size=cp_size)
    kernels = "K5-K7" if cp_size == 1 else f"cp {cp_size}, K11-K13"
    _card_vs_cpu(cfg, f"LLM fp32, 2 layers at Llama-3.2-1B width, vocab cut to "
                      f"{cfg.vocab_size}, B=1 x S=256, cuda ({kernels}, remat full) vs cpu "
                      f"(plain)")


def phase_ce_grad_rounding() -> None:
    """The fused CE's backward (models/llm/loss.py) rounds the logits'
    gradient to bf16 before its two products; JAX takes them as fp32 mixed
    products. A 2-layer model at Llama-3.2-1B's width and vocab (bf16, no
    remat), B=1 x S=2048: one forward, then the gradients of d(hidden) and of
    every leaf with the port's loss against a backward written out here that
    keeps the logits' gradient in fp32. Prints the gaps; no limit."""
    from nemo_tpu_torch.models.llm.loss import fused_linear_cross_entropy
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    cfg = _llm_cfg(num_layers=2, remat="none")
    model = GPTTrainModule(cfg, device="cuda", seed=0).model
    params = list(model.parameters())
    rng = np.random.RandomState(4)
    tokens, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, LLM_S))).cuda()
                      for _ in range(2))
    hidden = model(tokens, output_hidden=True)
    h = hidden.detach().requires_grad_()
    w = model.head_weight().detach().requires_grad_()
    loss, _ = fused_linear_cross_entropy(h, w, labels, chunk=cfg.fused_ce_chunk)
    dh, dw = torch.autograd.grad(loss, (h, w))
    # the same loss's backward, the logits' gradient kept in fp32
    n, c = LLM_S, min(cfg.fused_ce_chunk, LLM_S)
    hs, ls, w_c = h.detach()[0], labels[0], w.detach().to(h.dtype)
    dh32, dw32 = torch.empty_like(hs), torch.zeros_like(dw)
    for s0 in range(0, n, c):
        dlogits = torch.softmax(torch.mm(hs[s0:s0 + c], w_c.t(), out_dtype=torch.float32), -1)
        dlogits[torch.arange(c, device="cuda"), ls[s0:s0 + c]] -= 1.0
        dlogits /= n
        dh32[s0:s0 + c] = (dlogits @ w_c.float()).to(hs.dtype)
        dw32 += dlogits.t() @ hs[s0:s0 + c].float()
    grads, [emb] = {}, [i for i, p in enumerate(params) if p is model.embedding]
    for name, (d_h, d_w) in (("bf16", (dh, dw)), ("fp32", (dh32[None], dw32))):
        g = list(torch.autograd.grad(hidden, params, d_h, retain_graph=True))
        g[emb] = g[emb] + d_w  # the tied embedding: the lookup's gradient and the head's
        grads[name] = [d_h.float()] + [x.float() for x in g]

    def gap(x, ref):
        rel = float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))
        return rel, float((x - ref).abs().max() / ref.abs().max())

    names = ["d(hidden)"] + [name for name, _ in model.named_parameters()]
    gaps = {name: gap(x, r) for name, x, r in zip(names, grads["bf16"], grads["fp32"])}
    if not all(torch.isfinite(x).all() for x in grads["bf16"]):
        raise AssertionError("CE rounding: non-finite gradients")
    worst = max((k for k in names[1:] if k != names[1 + emb]), key=lambda k: gaps[k][0])
    log(f"CE logits gradient bf16 vs fp32, 2 layers at Llama-3.2-1B width and vocab, bf16, "
        f"B=1 x S={LLM_S}: " + ", ".join(
            f"{k} rel_norm_gap={gaps[k][0]:.3e} max_abs_gap={gaps[k][1]:.3e} of its max"
            for k in ("d(hidden)", names[1 + emb], worst)) + f" (the worst other leaf); "
        f"{len(names) - 1} leaves, loss {float(loss.detach()):.4f}")


def phase_llm_training(counters: dict, profile: bool, cfg=None, B_: int = LLM_B,
                       S: int = LLM_S, warmup: int = LLM_WARMUP, steps: int = LLM_STEPS,
                       label: str = "Llama-3.2-1B") -> tuple:
    """This slice's path: Llama-3.2-1B (or `cfg`'s model, named `label`)
    train steps at B=8 x S=2048 (B_ x S) from seed 0, `warmup` steps then
    `steps` timed ones over distinct random batches; K5 twice a layer a step,
    K6 and K7 once, none of the other kernels. Returns the launch counts of
    the timed steps and the ms a step."""
    from nemo_tpu_torch.llm.auto_configurator import model_flops_per_token
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    cfg = cfg or _llm_cfg()
    t0 = time.perf_counter()
    mod = GPTTrainModule(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in mod.params)
    # distinct random batches, made from the seed and staged on the card (scripts/train_mfu.py:76-85)
    rng = np.random.RandomState(0)
    batches = [{key: torch.from_numpy(rng.randint(0, cfg.vocab_size, (B_, S))).cuda()
                for key in ("tokens", "labels")} for _ in range(warmup + steps)]
    torch.cuda.synchronize()
    log(f"LLM: {label} ({cfg.num_layers} layers) built on the card from seed 0 ({n_params:,} "
        f"parameters, fp32) with {len(batches)} batches in {time.perf_counter() - t0:.1f} s")
    metrics = [mod.train_step(b) for b in batches[:warmup]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics += [mod.train_step(b) for b in batches[warmup:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    tok_s = steps * B_ * S / wall
    mfu = model_flops_per_token(cfg) * tok_s / PEAK_FLOPS[torch.bfloat16]
    log(f"main path, LLM training: {label} ({cfg.num_layers} layers) bf16, flash, remat full, "
        f"AdamW, B={B_} x S={S}, {steps} timed steps after {warmup}: {tok_s:.1f} tokens/s, "
        f"{1e3 * wall / steps:.2f} ms/step, MFU {100 * mfu:.2f} % of 989 TFLOP/s "
        f"({model_flops_per_token(cfg):.4e} FLOPs/token), peak_mem={peak:.2f} GiB, loss "
        f"{losses[0]:.4f} (step 0) → {losses[-1]:.4f} (step {len(losses) - 1}), grad_norm "
        f"{norms[0]:.4f} → {norms[-1]:.4f}, launches {launches}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
    lo, hi = (math.log(cfg.vocab_size) + d for d in LLM_LOSS_BAND)
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"step-0 loss {losses[0]:.4f} outside [{lo:.3f}, {hi:.3f}]")
    want = {key: 0 for key in counters}
    want.update(k5=2 * cfg.num_layers * steps, k6=cfg.num_layers * steps,
                k7=cfg.num_layers * steps)
    if launches != want:
        raise AssertionError(f"LLM launch counts {launches}, expected {want}")
    if profile:
        profile_llm(mod, batches[:2], shape=f"B={B_} x S={S}", model=label)
    return launches, 1e3 * wall / steps


def profile_by_kind(fn, kinds, label: str, n_steps: int = 1) -> None:
    """`fn` (`n_steps` steps of work) under torch.profiler, device activity
    only: the kernel table, device ms a step by kind (`kinds`: (kind, pieces
    of kernel names), the first match wins), the kernels of the fp8 kinds
    (`QUANT_KERNEL_KINDS`) by name, the wall and kernel ms a step, the
    device operations a step and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    groups, names = {}, {}
    for e in kernels:
        kind = next((k for k, keys in kinds if any(x in e.name for x in keys)), "other")
        groups[kind] = groups.get(kind, 0.0) + e.self_device_time_total / 1e3 / n_steps
        if kind in (k for k, _ in QUANT_KERNEL_KINDS):
            n, ms = names.get((kind, e.name), (0, 0.0))
            names[(kind, e.name)] = (n + 1, ms + e.self_device_time_total / 1e3 / n_steps)
    for (kind, name), (n, ms) in sorted(names.items(), key=lambda kv: -kv[1][1]):
        log(f"profile, {label}, {kind}: {ms:.3f} ms in {n / n_steps:.0f} launches of {name[:160]}")
    log(f"profile, {label} by kind: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    log(f"profile, {label}: wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms in "
        f"{len(kernels) / n_steps:.0f} device operations, card idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f} % of the wall time")


def profile_llm(mod, batches, what: str = "LLM training",
                shape: str = f"B={LLM_B} x S={LLM_S}", model: str = "Llama-3.2-1B") -> None:
    """Two more training steps under torch.profiler: device time a step by
    kind, the step's wall and kernel time, and the card's idle share."""
    def steps():
        for b in batches:
            mod.train_step(b)

    profile_by_kind(steps, LLM_KERNEL_KINDS, f"{what} step ({model}, {shape})",
                    n_steps=len(batches))


class ByteTokenizer:
    """One token per byte of UTF-8 text, and an eos id past the bytes (the
    data module's duck-typed tokenizer: `text_to_ids`, `eos_id`)."""
    eos_id = 256

    def text_to_ids(self, text: str):
        return list(text.encode())


def write_sft_jsonl(path: str, n: int = SFT_EXAMPLES, seed: int = 0) -> None:
    """n {"input", "output"} examples of random lowercase words from the
    seed: inputs of 64-1024 bytes, outputs of 8-128 (uniform)."""
    rng = np.random.RandomState(seed)

    def words(length: int) -> str:
        text = (97 + rng.randint(0, 26, length)).astype(np.uint8)
        text[rng.rand(length) < 1 / 6] = 32  # spaces between words
        text[0] = text[-1] = 97
        return text.tobytes().decode()

    with open(path, "w") as f:
        for _ in range(n):
            f.write(json.dumps({"input": words(rng.randint(64, 1025)),
                                "output": words(rng.randint(8, 129))}) + "\n")


def segment_pairs(seg: torch.Tensor) -> float:
    """The causal (query, key) pairs of equal nonzero segment ids in [B, S]
    rows: sum over segments of L (L + 1) / 2."""
    lengths = torch.stack([torch.bincount(row.long(), minlength=int(seg.max()) + 1)[1:]
                           for row in seg.cpu()]).double()
    return float((lengths * (lengths + 1) / 2).sum())


def packed_layout(layout: str, T: int, sft_seg: torch.Tensor) -> torch.Tensor:
    """[2, T] segment ids: "sft", two rows of the SFT batch (pack_batch over
    the synthetic lengths); "mixed", ids 1, 2, 1, 3 with a run of padding in
    the middle and a padding tail, then a row of padding only; "one", one
    segment over each row."""
    seg = torch.zeros(2, T, dtype=torch.int32)
    if layout == "sft":
        seg = sft_seg[:2].clone()
    elif layout == "mixed":
        cuts = [0, 3 * T // 20, 7 * T // 20, 9 * T // 20, 13 * T // 20, 19 * T // 20 - 5]
        for sid, (lo, hi) in zip((1, 2, 0, 1, 3), zip(cuts, cuts[1:])):
            seg[0, lo:hi] = sid
    else:
        seg[:] = 1
    return seg


def check_k8_k10(what: str, q, k, v, do, seg, scale: float, window):
    """K8 (through the model's wrapper, its lse from a launch of its own), K9
    and K10 on one input against their plain versions, held row by row as
    K5-K7 are; a padding row must give o = 0, lse = -1e30, and padding rows
    and keys exactly 0 in dq, dk and dv. Returns o [B, H, T, dh], lse, (dq,
    dk, dv) and the max abs errors of K8, K9, K10."""
    from nemo_tpu_torch.ops.flash_attention import (
        _k8_launch, flash_attention_packed, flash_attention_packed_backward_plain,
        flash_attention_packed_plain, flash_seg_dkv, flash_seg_dq, row_delta, seg_tile_ranges)

    tol, gtol, ntol = ((1e-4, 1e-4, 1e-5) if q.dtype == torch.float32 else (2e-2, 3e-2, 1e-2))
    o = flash_attention_packed(q, k, v, seg, scale, True, window)
    _, lse = _k8_launch(q, k, v, seg, seg_tile_ranges(seg), scale, True, window)
    o_ref, lse_ref = flash_attention_packed_plain(q, k, v, seg, scale, True, window)
    err8 = compare_rows(f"K8 {what}", o, o_ref, tol, ntol)
    pad = seg == 0
    live = ~pad[:, None, :].expand_as(lse)
    compare(f"K8 {what} lse", lse[live], lse_ref[live], 1e-3, 1e-4)
    if not (bool((lse[~live] == -1e30).all()) and bool((o.transpose(1, 2)[pad] == 0).all())):
        raise AssertionError(f"K8 {what}: a padding row is not o = 0, lse = -1e30")
    del o_ref, lse_ref
    args = (q, k, v, seg, scale, True, window, lse, row_delta(o, do), do)
    out = (flash_seg_dq(*args), *flash_seg_dkv(*args))
    ref = flash_attention_packed_backward_plain(q, k, v, seg, scale, True, window, o, lse, do)
    torch.cuda.synchronize()
    grad_errs = []
    for name, x, r in zip(("dq", "dk", "dv"), out, ref):
        grad_errs.append(compare_rows(f"K{9 if name == 'dq' else 10} {what} {name}", x, r,
                                      gtol, ntol))
        if not bool((x.transpose(1, 2)[pad] == 0).all()):
            raise AssertionError(f"{what} {name}: padding is not exactly 0")
    return o, lse, out, [err8, grad_errs[0], max(grad_errs[1:])]


def _repeatable(what: str, fn, first) -> None:
    """fn() launched again gives `first` bit for bit (the backward kernels
    sum in a fixed order and take no atomics)."""
    again = fn()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, again)]
    log(f"{what}: a second launch gives the same bits: {same}")
    if not all(same):
        raise AssertionError(f"{what}: a second launch differs ({same})")


def check_k8_k10_layouts(gen: torch.Generator, H: int, G: int, dh: int, window,
                         sft_seg: torch.Tensor, repeat: bool = False) -> list:
    """K8, K9 and K10 at B=2, S=2048, H heads over G at dh, fp32 then bf16,
    on each of `packed_layout`'s three segment layouts ("sft": two rows of
    `sft_seg`), held against their plain versions (`check_k8_k10`); with one
    segment a row they must give K5-K7's bits and, with `repeat`, a second
    launch of dq, dk and dv the first's. Returns the worst bf16 max abs
    errors of K8, K9, K10."""
    from nemo_tpu_torch.ops.flash_attention import (_k5_launch, flash_dkv, flash_dq, flash_seg_dkv,
                                                    flash_seg_dq, row_delta)

    errs, scale = [0.0, 0.0, 0.0], 1.0 / math.sqrt(dh)
    for dtype, layout in ((d, lay) for d in (torch.float32, torch.bfloat16)
                          for lay in ("sft", "mixed", "one")):
        q, k, v, do = _gqa_inputs(gen, 2, H, G, LLM_S, dh, dtype)
        seg = packed_layout(layout, LLM_S, sft_seg).cuda()
        what = f"{str(dtype)[6:]} B=2 H={H} G={G} dh={dh} window={window} segments={layout}"
        o, lse, out, err = check_k8_k10(what, q, k, v, do, seg, scale, window)
        if repeat:
            args = (q, k, v, seg, scale, True, window, lse, row_delta(o, do), do)
            _repeatable(f"K9, K10 {what}", lambda: (flash_seg_dq(*args), *flash_seg_dkv(*args)),
                        out)
        if layout == "one":  # one segment a row: K5-K7's kernels step for step
            o5, lse5 = _k5_launch(q, k, v, scale, True, window)
            args5 = (q, k, v, scale, True, window, lse5, row_delta(o, do), do)
            same = [torch.equal(o.transpose(1, 2), o5), torch.equal(lse, lse5)] + [
                torch.equal(x, y) for x, y in zip(out, (flash_dq(*args5), *flash_dkv(*args5)))]
            log(f"K8-K10 {what}: equal to K5-K7 bit for bit: {all(same)}")
            if not all(same):
                raise AssertionError(f"K8-K10 {what}: not K5-K7's bits ({same})")
        if dtype == torch.bfloat16:
            errs = [max(a, b) for a, b in zip(errs, err)]
        del q, k, v, do, o, lse, out
    return errs


def dense_segment_mask(seg: torch.Tensor) -> torch.Tensor:
    """SDPA's dense boolean mask [B, 1, S, S] for segment ids [B, S]: the
    causal pairs of one segment; a padding row sees its own key only, since
    SDPA gives NaN on a row that sees none."""
    S = seg.shape[1]
    pos = torch.arange(S, device=seg.device)
    dense = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0) & (
        pos[None, None, :] <= pos[None, :, None])
    dense |= torch.eye(S, dtype=torch.bool, device=seg.device)[None] & (seg == 0)[:, :, None]
    return dense[:, None]


def phase_k8_k10(gen: torch.Generator, layouts: dict):
    """K8, K9 and K10 against their plain versions at B=2, S=2048 (32 heads
    over 8 at dh 64, no window and a window of 512; 12 over 12 at dh 128) on
    three segment layouts; with one segment per row K8-K10 must give K5-K7's
    bits. Then, at B=8 (32 over 8, dh 64) on `layouts` (the [B, S] segment
    ids of the SFT run's first batch, "sft", and of a batch from the middle
    of the epoch, "mid") and on one segment a row ("one": nothing to skip,
    so the segment policy's own cost), the same checks, and their times
    beside K5-K7's at the same shape; at "sft" also the plain versions' and
    SDPA's given a dense boolean mask."""
    from nemo_tpu_torch.ops.flash_attention import (
        _k5_launch, _k8_launch, flash_attention_packed, flash_attention_packed_backward_plain,
        flash_attention_packed_plain, flash_dkv, flash_dq, flash_seg_dkv, flash_seg_dq,
        row_delta, seg_tile_ranges)

    rows = [{"name": name, "route": "cuda", "source": f"nemo_tpu_torch/csrc/{src}.cu",
             "replaces": f"nemo_tpu/ops/flash_attention.py:{line}"}
            for name, src, line in (("flash_attention_packed", "flash_fwd", 817),
                                    ("flash_seg_dq", "flash_bwd", 871),
                                    ("flash_seg_dkv", "flash_bwd", 914))]
    errs = [0.0, 0.0, 0.0]  # K8, K9, K10: worst bf16 max abs error
    for H, G, dh, window in ((32, 8, 64, None), (32, 8, 64, 512), (12, 12, 128, None)):
        err = check_k8_k10_layouts(gen, H, G, dh, window, layouts["sft"])
        errs = [max(a, b) for a, b in zip(errs, err)]

    H, G, dh, scale = 32, 8, 64, 0.125
    layouts = {name: seg.cuda() for name, seg in layouts.items()}
    layouts["one"] = torch.ones_like(layouts["sft"])
    causal = H * LLM_B * LLM_S * (LLM_S + 1) / 2
    pairs = {}  # layout → this batch's valid (query, key) pairs, every head
    for lay_name, seg in layouts.items():
        pairs[lay_name] = H * segment_pairs(seg)
        log(f"K8-K10 batch {lay_name}: B={LLM_B} x S={LLM_S}, H={H} over G={G}, dh={dh}: "
            f"{pairs[lay_name] / causal:.4f} of the causal pairs are of one segment")
    dense = dense_segment_mask(layouts["sft"])
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _gqa_inputs(gen, LLM_B, H, G, LLM_S, dh, dtype)
        fast = dtype == torch.bfloat16
        n = 20 if fast else 3
        name = str(dtype)[6:]
        o5, lse5 = _k5_launch(q, k, v, scale, True, None)
        args5 = (q, k, v, scale, True, None, lse5, row_delta(o5.transpose(1, 2), do), do)
        ms5 = [cuda_ms(lambda: _k5_launch(q, k, v, scale, True, None), iters=n),
               cuda_ms(lambda: flash_dq(*args5), iters=n),
               cuda_ms(lambda: flash_dkv(*args5), iters=n)]
        del o5, lse5, args5
        for lay_name, seg in layouts.items():
            what = f"{name} B={LLM_B} H={H} G={G} dh={dh} segments={lay_name}"
            o, lse, _, err = check_k8_k10(what, q, k, v, do, seg, scale, None)
            if fast:
                errs = [max(a, b) for a, b in zip(errs, err)]
            ranges = seg_tile_ranges(seg)  # the kernels alone are timed: the ranges given
            args = (q, k, v, seg, scale, True, None, lse, row_delta(o, do), do)
            ms = [cuda_ms(lambda: _k8_launch(q, k, v, seg, ranges, scale, True, None), iters=n),
                  cuda_ms(lambda: flash_seg_dq(*args, ranges=ranges), iters=n),
                  cuda_ms(lambda: flash_seg_dkv(*args, ranges=ranges), iters=n)]
            bounds = flash_bounds(LLM_B, H, G, LLM_S, dh, pairs[lay_name], dtype,
                                  4 * LLM_B * LLM_S)  # the segment ids
            for i in range(3):
                log(f"K{8 + i} {what}: kernel_ms={ms[i]:.4f} (K{5 + i} at the same shape "
                    f"{ms5[i]:.4f}, {ms[i] / ms5[i]:.3f} of it) bound_ms={bounds[i][0]:.4f} "
                    f"({bounds[i][1]})")
            if lay_name != "sft":
                continue
            wrapper_ms = cuda_ms(lambda: flash_attention_packed(q, k, v, seg, scale), iters=n)
            prepass_ms = cuda_ms(lambda: seg_tile_ranges(seg), iters=n)
            plain_fwd = cuda_ms(lambda: flash_attention_packed_plain(q, k, v, seg, scale), iters=3)
            plain_bwd = cuda_ms(lambda: flash_attention_packed_backward_plain(
                q, k, v, seg, scale, True, None, o, lse, do), iters=3)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                ql, kl, vl, attn_mask=dense, scale=scale, enable_gqa=True)
            lib_fwd = cuda_ms(sdpa, iters=n)
            o_lib = sdpa()
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,
                                                          retain_graph=True),
                              iters=10 if fast else 3)
            del o_lib, ql, kl, vl
            log(f"SDPA {name} B={LLM_B} GQA with a dense [B, 1, S, S] boolean mask: forward "
                f"{lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; the tile-range pre-pass "
                f"{prepass_ms:.4f} ms, K8 through its autograd wrapper (pre-pass included) "
                f"{wrapper_ms:.4f} ms; plain forward {plain_fwd:.4f} ms, plain backward (dq, dk "
                f"and dv) {plain_bwd:.4f} ms")
            for i, (row, plain_ms, lib_ms) in enumerate(zip(
                    rows, (plain_fwd, plain_bwd, plain_bwd), (lib_fwd, lib_bwd, lib_bwd))):
                row.update(ms=ms[i], plain_ms=plain_ms, bound_ms=bounds[i][0],
                           bound_by=bounds[i][1], library_ms=lib_ms)  # bf16 last
        del q, k, v, do, o, lse, args
    del dense
    for row, err in zip(rows, errs):
        row["max_abs_err"] = err
    torch.cuda.empty_cache()
    return rows


def sft_data(path: str):
    """The SFT data module over the synthetic jsonl, the batches of a run
    (each run of the module yields the same) and SFT_MID batches from the
    middle of the epoch, and the shape of each: segments per row, shares of
    padding, of tokens that bear loss, and of causal pairs within one
    segment."""
    from nemo_tpu_torch.data.fine_tuning import FineTuningDataModule
    from nemo_tpu_torch.data.packed_sequence import pack_batch

    def describe(seg, loss_mask):
        return {"segments_per_row": float(seg.amax(-1).double().mean()),
                "pad_share": float((seg == 0).double().mean()),
                "loss_share": float(loss_mask.double().mean()),
                "pair_share": segment_pairs(seg) / (seg.shape[0] * LLM_S * (LLM_S + 1) / 2)}

    dm = FineTuningDataModule(path, ByteTokenizer(), seq_length=LLM_S, global_batch_size=LLM_B,
                              packed=True)
    batches = [b for _, b in zip(range(LLM_WARMUP + LLM_STEPS), dm.train_batches())]
    shape = describe(torch.cat([b["segment_ids"] for b in batches]),
                     torch.cat([b["loss_mask"] for b in batches]))
    encs = [e for e in map(dm._encode, dm.examples) if e is not None]
    epoch = pack_batch([e["tokens"] for e in encs], [e["labels"] for e in encs],
                       [e["loss_mask"] for e in encs], LLM_S)
    whole = describe(torch.from_numpy(epoch["segment_ids"]), torch.from_numpy(epoch["loss_mask"]))
    mid_step = epoch["tokens"].shape[0] // LLM_B // 2
    mid = [b for _, b in zip(range(SFT_MID), dm.train_batches(mid_step))]
    mid_shape = describe(torch.cat([b["segment_ids"] for b in mid]),
                         torch.cat([b["loss_mask"] for b in mid]))
    for what, d in ((f"the {len(batches)} batches of the run", shape),
                    (f"a whole epoch ({epoch['tokens'].shape[0]} rows; first-fit puts the "
                     f"longest examples in the first rows)", whole),
                    (f"the {SFT_MID} batches from step {mid_step} on, the middle of the epoch",
                     mid_shape)):
        log(f"SFT data: {SFT_EXAMPLES} synthetic examples (inputs of 64-1024 bytes, outputs of "
            f"8-128, one token a byte) packed into rows of {LLM_S}; over {what}: "
            f"{d['segments_per_row']:.2f} segments a row, {100 * d['pad_share']:.2f} % padding, "
            f"{100 * d['loss_share']:.2f} % of the tokens bear loss, "
            f"{100 * d['pair_share']:.2f} % of the causal pairs are of one segment")
    return dm, batches, shape, mid, mid_shape


def phase_sft(counters: dict, dm, batches, shape: dict, mid, mid_shape: dict,
              profile: bool, recipe: str = "llama32_1b", layers: Optional[int] = None,
              warmup: int = LLM_WARMUP, timed: int = LLM_STEPS,
              label: str = "Llama-3.2-1B") -> dict:
    """This slice's path: packed full-parameter SFT of Llama-3.2-1B (or of
    `recipe`'s model, named `label`, cut to `layers` layers where given) through
    finetune_recipe(...).run → llm.finetune → Trainer.fit →
    GPTTrainModule.train_step on the data module `dm`, `warmup` steps then
    `timed` timed ones, from seed-0 weights handed in as a JAX-layout tree of
    tensors on the card; returns the launch counts of the whole run. Then,
    where `mid` is given, the trained module's steps on `mid`, batches from
    the middle of the epoch, are timed too."""
    from nemo_tpu_torch.core.callbacks import Callback, ProgressPrinter, TimingCallback
    from nemo_tpu_torch.core.trainer import Trainer
    from nemo_tpu_torch.interop.jax_params import export_jax_variables
    from nemo_tpu_torch.llm.auto_configurator import model_flops_per_token
    from nemo_tpu_torch.llm.recipes import finetune_recipe
    from nemo_tpu_torch.models.llm.gpt import build_model

    fr = finetune_recipe(recipe, peft_scheme="none", global_batch_size=LLM_B)
    full = fr.model.num_layers
    if layers is not None:
        fr = dataclasses.replace(fr, model=dataclasses.replace(fr.model, num_layers=layers))
    cfg = fr.model
    log(f"SFT recipe {fr.name}: seq_length {cfg.seq_length}, lr {fr.lr:g} "
        f"CosineAnnealing (warmup {fr.warmup_steps}, max_steps {fr.max_steps}), packed "
        f"{fr.packed}; the cuts: global batch {LLM_B} where the recipe says "
        f"{finetune_recipe(recipe, peft_scheme='none').global_batch_size}, {cfg.num_layers} "
        f"of {full} layers")
    t0 = time.perf_counter()
    params = export_jax_variables(build_model(cfg, torch.device("cuda"), seed=0),
                                  as_tensors=True)["params"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    leaves = lambda tree: [x for v in tree.values() for x in (  # noqa: E731
        leaves(v) if isinstance(v, dict) else [v])]
    tree_gib = sum(x.numel() * x.element_size() for x in leaves(params)) / 2**30
    log(f"SFT: seed-0 weights as the JAX parameter tree of fp32 tensors on the card "
        f"({tree_gib:.2f} GiB, held by the caller through the run) in "
        f"{time.perf_counter() - t0:.1f} s")

    class Window(Callback):
        """CUDA-synchronised wall time of the steps after warm-up, their
        losses, and the peak memory from the first timed step."""

        def __init__(self):
            self.losses, self.norms, self.t0, self.wall = [], [], None, None

        def on_step_start(self, trainer, step):
            if step == warmup:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                self.t0 = time.perf_counter()

        def on_step_end(self, trainer, step, metrics):
            self.losses.append(metrics["loss"])
            self.norms.append(metrics["grad_norm"])
            if step == trainer.max_steps - 1:
                torch.cuda.synchronize()
                self.wall = time.perf_counter() - self.t0

    window = Window()
    trainer = Trainer(max_steps=warmup + timed,
                      callbacks=[TimingCallback(), ProgressPrinter(), window])
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    module, _ = fr.run(params, dm, trainer=trainer)
    run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    del params
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in window.losses]
    norms = [float(x) for x in window.norms]
    wall = window.wall
    tok_s = timed * LLM_B * LLM_S / wall
    real_tok_s = tok_s * (1 - shape["pad_share"])
    mfu = model_flops_per_token(cfg) * tok_s / PEAK_FLOPS[torch.bfloat16]
    steps = warmup + timed
    log(f"main path, packed SFT: finetune_recipe('{recipe}', peft_scheme='none', "
        f"global_batch_size={LLM_B}).run: {label} ({cfg.num_layers} layers) bf16, flash, remat "
        f"full, AdamW, B={LLM_B} x S={LLM_S}, {timed} timed steps after {warmup} "
        f"({run_s:.1f} s for the whole run, the weights' load included): "
        f"{1e3 * wall / timed:.2f} ms/step, {tok_s:.1f} tokens/s over all B*S tokens, "
        f"{real_tok_s:.1f} over non-padding tokens, MFU {100 * mfu:.2f} % of 989 TFLOP/s "
        f"(over B*S tokens), peak_mem={peak:.2f} GiB ({peak - tree_gib:.2f} without the "
        f"caller's parameter tree), loss {losses[0]:.4f} (step 0) → "
        f"{losses[-1]:.4f} (step {steps - 1}), grad_norm {norms[0]:.4f} → {norms[-1]:.4f}, "
        f"lr {fr.lr_schedule()(0):.4g} → {fr.lr_schedule()(steps - 1):.4g}, launches {launches}")
    if module.step != steps or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"SFT: {module.step} steps, losses {losses}, norms {norms}")
    lo, hi = (math.log(cfg.vocab_size) + d for d in LLM_LOSS_BAND)
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"SFT step-0 loss {losses[0]:.4f} outside [{lo:.3f}, {hi:.3f}]")
    L = cfg.num_layers
    want = {key: 0 for key in counters}
    want.update(k8=2 * L * steps, k9=L * steps, k10=L * steps)
    if launches != want:
        raise AssertionError(f"SFT launch counts {launches}, expected {want}")
    if mid is not None:
        module.train_step(mid[0])  # warm-up at the new layout
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mid_losses = [module.train_step(b)["loss"] for b in mid[1:]]
        torch.cuda.synchronize()
        mid_ms = 1e3 * (time.perf_counter() - t0) / len(mid_losses)
        mid_tok_s = LLM_B * LLM_S / mid_ms * 1e3
        log(f"packed SFT at the middle of the epoch ({mid_shape['segments_per_row']:.2f} "
            f"segments a row, {100 * mid_shape['pad_share']:.2f} % padding, "
            f"{100 * mid_shape['pair_share']:.2f} % of the causal pairs of one segment): "
            f"{mid_ms:.2f} ms/step over {len(mid_losses)} steps after 1, {mid_tok_s:.1f} "
            f"tokens/s over all B*S tokens, {mid_tok_s * (1 - mid_shape['pad_share']):.1f} over "
            f"non-padding tokens, losses {[round(float(x), 4) for x in mid_losses]}")
        if not all(math.isfinite(float(x)) for x in mid_losses):
            raise AssertionError(f"SFT at the middle of the epoch: losses {mid_losses}")
    if profile:
        profile_llm(module, batches[:2], "packed SFT", model=label)
    return launches


# ------------------------------------------------------------ context parallelism
CP_S, CP_B = 16384, 1  # the long-context recipes' 16k with cp 2 (recipes.py:334,345,470)


def position_layouts(Tl: int) -> dict:
    """One ring step's (qpos, kpos, window, q_offset) at Tl rows a rank, on
    the card: "arange" (0 .. Tl-1 both sides: K5-K7's function), "diagonal"
    (rank 0 of the zig-zag cp 2 layout of 2 Tl tokens against its own keys),
    "off_diagonal" (rank 0's rows against rank 1's keys: the rows of chunk 0
    keep no key, those of chunk 3 every key), "window" (the diagonal with a
    window of 512), "offset" (flash_attention(q_offset=Tl/2): Tl/2 rows
    after Tl/2 keys, the same Tl keys)."""
    from nemo_tpu_torch.ops.ring_attention import zigzag_order

    z = torch.from_numpy(zigzag_order(2 * Tl, 2).astype(np.int32)).cuda()
    pos = torch.arange(Tl, dtype=torch.int32, device="cuda")
    return {"arange": (pos, pos, None, 0), "diagonal": (z[:Tl], z[:Tl], None, 0),
            "off_diagonal": (z[:Tl], z[Tl:], None, 0), "window": (z[:Tl], z[:Tl], 512, 0),
            "offset": (pos[Tl // 2:], pos, None, Tl // 2)}


def kept_pairs(qpos: torch.Tensor, kpos: torch.Tensor, window) -> float:
    """The (query, key) pairs the position mask keeps: this input's work."""
    keep = kpos[None, :] <= qpos[:, None]
    if window is not None:
        keep &= kpos[None, :] > qpos[:, None] - window
    return float(keep.sum())


def plain_positions_by_group(q, k, v, qpos, kpos, scale, window, o, lse, do, dlse):
    """The plain forward (o, lse) and backward (dq, dk, dv) of the positions
    kernels, one kv group of heads at a time (the fp32 scores of every head
    at Tl = 8,192 would take 8.6 GB), joined over the groups."""
    from nemo_tpu_torch.ops.flash_attention import (flash_attention_positions_backward_plain,
                                                    flash_attention_positions_plain)

    G = k.shape[1]
    rep = q.shape[1] // G
    outs = []
    for g in range(G):
        hq, hk = slice(g * rep, (g + 1) * rep), slice(g, g + 1)
        fwd = flash_attention_positions_plain(q[:, hq], k[:, hk], v[:, hk], qpos, kpos, scale,
                                              True, window)
        bwd = flash_attention_positions_backward_plain(
            q[:, hq], k[:, hk], v[:, hk], qpos, kpos, scale, True, window, o[:, hq], lse[:, hq],
            do[:, hq], dlse[:, hq])
        outs.append((*fwd, *bwd))
    return [torch.cat(parts, 1) for parts in zip(*outs)]


def check_k11_k13(what: str, q, k, v, do, dlse, qpos, kpos, window, q_offset: int):
    """K11 (through flash_attention_positions, or flash_attention with
    q_offset where it is given), K12 and K13 given the lse cotangent `dlse`
    on one input against the plain versions, held row by row as K5-K7 are;
    rows that keep no key must give o = 0, lse = -1e30 and dq = 0 exactly.
    Returns o, lse, (dq, dk, dv) and the max abs errors of K11, K12, K13."""
    from nemo_tpu_torch.ops.flash_attention import (_k11_launch, flash_attention,
                                                    flash_attention_positions, flash_pos_dkv,
                                                    flash_pos_dq, pos_delta)

    scale = 1.0 / math.sqrt(q.shape[-1])
    tol, gtol, ntol = ((1e-4, 1e-4, 1e-5) if q.dtype == torch.float32 else (2e-2, 3e-2, 1e-2))
    if q_offset:
        o = flash_attention(q, k, v, scale, True, window, q_offset=q_offset)
    else:
        o, _ = flash_attention_positions(q, k, v, qpos, kpos, scale, True, window)
    _, lse = _k11_launch(q, k, v, qpos, kpos, scale, True, window)
    args = (q, k, v, qpos, kpos, scale, True, window, lse, pos_delta(o, do, dlse), do)
    out = (flash_pos_dq(*args), *flash_pos_dkv(*args))
    o_ref, lse_ref, *ref = plain_positions_by_group(q, k, v, qpos, kpos, scale, window, o, lse,
                                                    do, dlse)
    torch.cuda.synchronize()
    err11 = compare_rows(f"K11 {what}", o, o_ref, tol, ntol)
    dead = (kpos[None, :] > qpos[:, None]).all(-1)  # rows that keep no key
    compare(f"K11 {what} lse", lse[:, :, ~dead], lse_ref[:, :, ~dead], 1e-3, 1e-4)
    if not (bool((o[:, :, dead] == 0).all()) and bool((lse[:, :, dead] == -1e30).all())
            and bool((out[0][:, :, dead] == 0).all())):
        raise AssertionError(f"K11-K13 {what}: a row with no key is not o = 0, lse = -1e30, "
                             f"dq = 0")
    errs = [compare_rows(f"K{12 if name == 'dq' else 13} {what} {name}", x, r, gtol, ntol)
            for name, x, r in zip(("dq", "dk", "dv"), out, ref)]
    return o, lse, out, [err11, errs[0], max(errs[1:])], int(dead.sum())


def phase_k11_k13(gen: torch.Generator):
    """K11, K12 and K13 against their plain versions at one rank's shape of
    the CP path, B=1 and Tl=8,192 rows (32 heads over 8 at dh 64; 12 over 12
    at dh 128, GPT-551M's head), fp32 and bf16, on the layouts of
    `position_layouts`, the backward given a nonzero lse cotangent; at
    "arange" K5-K7's bits. Then the times at 32 over 8, dh 64 of each ring
    step of rank 0 (diagonal, off-diagonal) beside K5-K7 at S = Tl, the plain
    versions (group by group) and SDPA given the boolean mask the positions
    make."""
    from nemo_tpu_torch.ops.flash_attention import (
        _k11_launch, _k5_launch, flash_attention_positions_backward_plain,
        flash_attention_positions_plain, flash_dkv, flash_dq, flash_pos_dkv, flash_pos_dq,
        pos_delta, pos_tile_ranges)

    Tl = CP_S // 2
    layouts = position_layouts(Tl)
    rows = [{"name": name, "route": "cuda", "source": f"nemo_tpu_torch/csrc/{src}.cu",
             "replaces": f"nemo_tpu/ops/flash_attention.py:{line}"}
            for name, src, line in (("flash_attention_positions", "flash_fwd", 489),
                                    ("flash_pos_dq", "flash_bwd", 532),
                                    ("flash_pos_dkv", "flash_bwd", 569))]
    errs = [0.0, 0.0, 0.0]  # K11, K12, K13: worst bf16 max abs error
    for (H, G, dh), dtype, name in ((c, d, n) for c in ((32, 8, 64), (12, 12, 128))
                                    for d in (torch.float32, torch.bfloat16) for n in layouts):
        qpos, kpos, window, q_offset = layouts[name]
        q, k, v, do = _gqa_inputs(gen, CP_B, H, G, Tl, dh, dtype)
        if q_offset:
            q, do = q[:, :, q_offset:], do[:, :, q_offset:]
        dlse = torch.randn(CP_B, H, len(qpos), generator=gen).cuda()
        what = f"{str(dtype)[6:]} B={CP_B} H={H} G={G} dh={dh} Tl={Tl} {name}"
        o, lse, out, err, n_dead = check_k11_k13(what, q, k, v, do, dlse, qpos, kpos, window,
                                                 q_offset)
        if name == "arange":  # K5-K7 step for step
            o5, lse5 = _k5_launch(q, k, v, 1.0 / math.sqrt(dh), True, window)
            args5 = (q, k, v, 1.0 / math.sqrt(dh), True, window, lse5, pos_delta(o, do, dlse), do)
            same = [torch.equal(o.transpose(1, 2), o5), torch.equal(lse, lse5)] + [
                torch.equal(x, y) for x, y in zip(out, (flash_dq(*args5), *flash_dkv(*args5)))]
            log(f"K11-K13 {what}: equal to K5-K7 bit for bit: {all(same)}")
            if not all(same):
                raise AssertionError(f"K11-K13 {what}: not K5-K7's bits ({same})")
        if name == "off_diagonal":
            log(f"K11-K13 {what}: {n_dead} of {len(qpos)} rows keep no key: o, lse, dq exact")
        if dtype == torch.bfloat16:
            errs = [max(a, b) for a, b in zip(errs, err)]
        del q, k, v, do, o, lse, out

    H, G, dh = 32, 8, 64
    scale = 1.0 / math.sqrt(dh)
    steps = {name: layouts[name][:2] for name in ("diagonal", "off_diagonal")}
    for name, (qpos, kpos) in steps.items():
        qr, kr = pos_tile_ranges(qpos).cpu(), pos_tile_ranges(kpos).cpu()
        n = Tl // 64
        active = ((kr[None, :, 0] <= qr[:, None, 1])).sum()
        whole = ((kr[None, :, 1] <= qr[:, None, 0])).sum()
        log(f"K11-K13 ring step {name} (rank 0 of cp 2, Tl={Tl}): the pre-pass leaves "
            f"{int(active)} of {n * n} tile pairs to visit, {int(whole)} of them without an "
            f"element mask; {kept_pairs(qpos, kpos, None) / Tl ** 2:.4f} of the pairs kept")
    results = {}  # (dtype, step) → [ms K11, K12, K13], [plain fwd, bwd], [lib fwd, bwd], bounds
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _gqa_inputs(gen, CP_B, H, G, Tl, dh, dtype)
        dlse = torch.randn(CP_B, H, Tl, generator=gen).cuda()
        fast = dtype == torch.bfloat16
        n_it = 20 if fast else 3
        dname = str(dtype)[6:]
        o5, lse5 = _k5_launch(q, k, v, scale, True, None)
        args5 = (q, k, v, scale, True, None, lse5, pos_delta(o5.transpose(1, 2), do), do)
        ms5 = [cuda_ms(lambda: _k5_launch(q, k, v, scale, True, None), iters=n_it),
               cuda_ms(lambda: flash_dq(*args5), iters=n_it),
               cuda_ms(lambda: flash_dkv(*args5), iters=n_it)]
        del o5, lse5, args5
        for step, (qpos, kpos) in steps.items():
            ranges = (pos_tile_ranges(qpos), pos_tile_ranges(kpos))
            o, lse = _k11_launch(q, k, v, qpos, kpos, scale, True, None, ranges)
            o = o.transpose(1, 2)
            args = (q, k, v, qpos, kpos, scale, True, None, lse, pos_delta(o, do, dlse), do)
            ms = [cuda_ms(lambda: _k11_launch(q, k, v, qpos, kpos, scale, True, None, ranges),
                          iters=n_it),
                  cuda_ms(lambda: flash_pos_dq(*args, ranges=ranges), iters=n_it),
                  cuda_ms(lambda: flash_pos_dkv(*args, ranges=ranges), iters=n_it)]
            hs = [slice(g * H // G, (g + 1) * H // G) for g in range(G)]
            plain_fwd = cuda_ms(lambda: [flash_attention_positions_plain(
                q[:, h], k[:, g:g + 1], v[:, g:g + 1], qpos, kpos, scale)
                for g, h in enumerate(hs)], iters=2)
            plain_bwd = cuda_ms(lambda: [flash_attention_positions_backward_plain(
                q[:, h], k[:, g:g + 1], v[:, g:g + 1], qpos, kpos, scale, True, None, o[:, h],
                lse[:, h], do[:, h], dlse[:, h]) for g, h in enumerate(hs)], iters=2)
            # SDPA given the boolean mask of the positions; a row that keeps no key
            # sees its own position's key index instead, since SDPA gives NaN there
            mask = kpos[None, :] <= qpos[:, None]
            mask |= torch.eye(Tl, dtype=torch.bool, device="cuda") & ~mask.any(-1, keepdim=True)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                ql, kl, vl, attn_mask=mask, scale=scale, enable_gqa=True)
            lib_fwd = cuda_ms(sdpa, iters=n_it)
            o_lib = sdpa()
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,
                                                          retain_graph=True),
                              iters=10 if fast else 3)
            del o_lib, ql, kl, vl, mask
            bounds = flash_bounds(CP_B, H, G, Tl, dh, H * CP_B * kept_pairs(qpos, kpos, None),
                                  dtype, 8 * Tl)  # the positions
            what = f"{dname} B={CP_B} H={H} G={G} dh={dh} Tl={Tl} ring step {step}"
            log(f"SDPA {what}, [Tl, Tl] boolean mask: forward {lib_fwd:.4f} ms, backward "
                f"{lib_bwd:.4f} ms; plain (group by group) forward {plain_fwd:.4f} ms, "
                f"backward (dq, dk and dv) {plain_bwd:.4f} ms")
            for i in range(3):
                log(f"K{11 + i} {what}: kernel_ms={ms[i]:.4f} (K{5 + i} causal at S={Tl} "
                    f"{ms5[i]:.4f}, {ms[i] / ms5[i]:.3f} of it) bound_ms={bounds[i][0]:.4f} "
                    f"({bounds[i][1]})")
            results[(dname, step)] = (ms, (plain_fwd, plain_bwd, plain_bwd),
                                      (lib_fwd, lib_bwd, lib_bwd), bounds)
            del o, lse, args
        del q, k, v, do, dlse
    # the kernels' line: bf16, the mean of the two steps, one launch of each a step a rank
    for i, row in enumerate(rows):
        pair = [results[("bfloat16", step)] for step in steps]
        b = [r[3][i] for r in pair]
        row.update(max_abs_err=errs[i], ms=sum(r[0][i] for r in pair) / 2,
                   plain_ms=sum(r[1][i] for r in pair) / 2,
                   library_ms=sum(r[2][i] for r in pair) / 2,
                   bound_ms=sum(x[0] for x in b) / 2, bound_by=b[0][1])
    torch.cuda.empty_cache()
    return rows


def phase_ring(gen: torch.Generator) -> None:
    """ring_flash_attention with every rank in one process (LocalRing) at cp
    2 and cp 4 on the card, S = 16,384, B=1, 32 heads over 8, dh 64, fp32 and
    bf16, against causal attention over the un-permuted sequence: K5-K7 (held
    against their plain versions in phase 9) over every head, and the plain
    version over the first kv group of heads; o and the gradients row by
    row."""
    from nemo_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_backward_plain,
                                                    flash_attention_plain)
    from nemo_tpu_torch.ops.ring_attention import (LocalRing, ring_flash_attention,
                                                   zigzag_order, zigzag_shard, zigzag_unshard)

    H, G, dh = 32, 8, 64
    scale = 1.0 / math.sqrt(dh)
    for dtype in (torch.float32, torch.bfloat16):
        tol, gtol, ntol = ((1e-4, 1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 3e-2, 1e-2))
        q, k, v, do = _gqa_inputs(gen, CP_B, H, G, CP_S, dh, dtype)
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        o5 = flash_attention(*xs, scale)
        ref5 = [o5.detach(), *torch.autograd.grad(o5, xs, do)]
        del o5, xs
        o_p, lse_p = flash_attention_plain(q[:, :4], k[:, :1], v[:, :1], scale)
        ref_p = [o_p, *flash_attention_backward_plain(q[:, :4], k[:, :1], v[:, :1], scale, True,
                                                      None, o_p, lse_p, do[:, :4])]
        del lse_p
        for cp in (2, 4):
            Tl = CP_S // cp
            zs = [zigzag_shard(x, cp, 2).view(CP_B, x.shape[1], cp, Tl, dh)
                  .permute(2, 0, 1, 3, 4).contiguous().requires_grad_() for x in (q, k, v)]
            qpos = torch.from_numpy(zigzag_order(CP_S, cp).astype(np.int32)).cuda().view(cp, Tl)
            t0 = time.perf_counter()
            o = ring_flash_attention(*zs, qpos, LocalRing(cp), scale=scale)
            dz = zigzag_shard(do, cp, 2).view(CP_B, H, cp, Tl, dh).permute(2, 0, 1, 3, 4)
            got = [o.detach(), *torch.autograd.grad(o, zs, dz)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = [zigzag_unshard(t.permute(1, 2, 0, 3, 4).reshape(CP_B, t.shape[2], CP_S, dh),
                                  cp, 2) for t in got]
            what = f"ring cp={cp} (LocalRing) {str(dtype)[6:]} B={CP_B} H={H} G={G} S={CP_S}"
            log(f"{what}: forward and backward in {1e3 * wall:.1f} ms (first call)")
            for name, x, r5, rp in zip(("o", "dq", "dk", "dv"), got, ref5, ref_p):
                t = tol if name == "o" else gtol
                compare_rows(f"{what} {name} vs K5-K7", x, r5, t, ntol)
                compare_rows(f"{what} {name} vs plain (kv group 0)",
                             x[:, :4] if name in ("o", "dq") else x[:, :1], rp, t, ntol)
            del zs, o, got, dz
        del q, k, v, do, ref5, ref_p
    torch.cuda.empty_cache()


def phase_cp_training(counters: dict, profile: bool) -> dict:
    """This slice's path: context-parallel training of Llama-3.2-1B at S =
    16,384, cp 2, every rank in one process (LocalRing), B=1: the loss of
    the first batch against the same step without cp (K5-K7) on the same
    weights, then 2 warm-up and 20 timed train steps; returns the launch
    counts of the timed steps."""
    from nemo_tpu_torch.llm.auto_configurator import model_flops_per_token
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    cfg = _llm_cfg(seq_length=CP_S, cp_size=2)
    rng = np.random.RandomState(0)
    batches = [{key: torch.from_numpy(rng.randint(0, cfg.vocab_size, (CP_B, CP_S))).cuda()
                for key in ("tokens", "labels")} for _ in range(LLM_WARMUP + LLM_STEPS)]
    first = (batches[0]["tokens"], batches[0]["labels"])
    with torch.no_grad():
        ref = float(GPTTrainModule(dataclasses.replace(cfg, cp_size=1), device="cuda",
                                   seed=0).loss(*first))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mod = GPTTrainModule(cfg, device="cuda", seed=0)
        loss0 = float(mod.loss(*first))
    rel = abs(loss0 - ref) / abs(ref)
    log(f"CP: Llama-3.2-1B built on the card from seed 0 at cp 2 (LocalRing) in "
        f"{time.perf_counter() - t0:.1f} s; first batch's loss {loss0:.6f} at cp 2, {ref:.6f} at "
        f"cp 1 (K5-K7) on the same weights: rel {rel:.2e} (tolerance 2e-3)")
    if rel > 2e-3:
        raise AssertionError(f"CP loss {loss0} against {ref} without cp")
    metrics = [mod.train_step(b) for b in batches[:LLM_WARMUP]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics += [mod.train_step(b) for b in batches[LLM_WARMUP:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    tok_s = LLM_STEPS * CP_B * CP_S / wall
    mfu = model_flops_per_token(cfg) * tok_s / PEAK_FLOPS[torch.bfloat16]
    log(f"main path, CP training: Llama-3.2-1B bf16, flash, remat full, AdamW, cp 2 (LocalRing, "
        f"one card), B={CP_B} x S={CP_S}, {LLM_STEPS} timed steps after {LLM_WARMUP}: "
        f"{tok_s:.1f} tokens/s, {1e3 * wall / LLM_STEPS:.2f} ms/step, MFU {100 * mfu:.2f} % of "
        f"989 TFLOP/s ({model_flops_per_token(cfg):.4e} FLOPs/token), peak_mem={peak:.2f} GiB, "
        f"loss {losses[0]:.4f} (step 0) → {losses[-1]:.4f} (step {len(losses) - 1}), grad_norm "
        f"{norms[0]:.4f} → {norms[-1]:.4f}, launches {launches}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
    lo, hi = (math.log(cfg.vocab_size) + d for d in LLM_LOSS_BAND)
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"step-0 loss {losses[0]:.4f} outside [{lo:.3f}, {hi:.3f}]")
    L, cp = cfg.num_layers, cfg.cp_size
    want = {key: 0 for key in counters}  # a launch a held rank a ring step; remat runs it twice
    want.update(k11=2 * L * cp * cp * LLM_STEPS, k12=L * cp * cp * LLM_STEPS,
                k13=L * cp * cp * LLM_STEPS)
    if launches != want:
        raise AssertionError(f"CP launch counts {launches}, expected {want}")
    if profile:
        profile_llm(mod, batches[:2], "CP training", f"cp 2, B={CP_B} x S={CP_S}")
    return launches


def _rnnt_model(dtype: str, device):
    from nemo_tpu_torch.models.asr.configs import conformer_transducer
    from nemo_tpu_torch.models.asr.rnnt_models import EncDecRNNTModel

    cfg = conformer_transducer("large", compute_dtype=dtype)
    cfg.encoder.update(att_impl="decomposed_flash", fused_subsampling=True)
    return EncDecRNNTModel(cfg, device=device, seed=0)


def greedy_path(model, e: torch.Tensor, n: int, tokens: torch.Tensor, count: int):
    """Replay one row's label-looping decode from its tokens: the (frame,
    label) points where the decoder evaluated the joint, in order, and the
    joint logits there (`model`'s prediction net over the tokens and its
    joint on `e`, the row's projected encoder output [T', J]). Raises if the replay's
    argmax decisions do not give back `tokens`."""
    joint, blank = model.joint, model.blank_id
    pp = joint.project_pred(model.prediction(tokens[None, :count].long())[0])  # [U+1, J]
    t = u = sym = 0
    points, rows = [], []
    while t < n:
        logits = joint.from_projected(e[t], pp[u])
        points.append((t, u))
        rows.append(logits)
        k = int(logits.argmax())
        if k != blank and sym < model.max_symbols:
            if u >= count or k != int(tokens[u]):
                raise AssertionError(f"the replay emits {k} at frame {t}, label {u}, where the "
                                     "decode did not")
            u, sym = u + 1, sym + 1
        else:
            t, sym = t + 1, 0
    if u != count:
        raise AssertionError(f"the replay emits {u} labels, the decode {count}")
    return points, torch.stack(rows)


def blank_shift(model, enc: torch.Tensor, n: torch.Tensor, candidates: int = 16) -> float:
    """An offset for the blank logit's bias that makes a random-init
    transducer emit blanks as well as labels (unshifted it floods,
    max_symbols labels every frame). The margins of the best label over
    blank where the unshifted greedy decode of `enc` [B, T', H] (`n` valid
    frames a row) evaluated the joint (replayed by `greedy_path`) are
    sorted; of the offsets at the midpoints of `candidates` evenly spaced
    pairs of consecutive margins (so that none of those points becomes a
    tie), the one whose decode is furthest from both ends in its least
    balanced row: the largest min over rows of min(tokens, T' x max_symbols
    - tokens). The model's bias is left as it was."""
    tokens, counts = model.greedy_decode(enc, n)
    e = model.joint.project_enc(enc)
    logits = torch.cat([greedy_path(model, e[b], t, tokens[b], int(counts[b]))[1]
                        for b, t in enumerate(n.tolist())])
    bias, blank = model.joint.out_proj.bias, model.blank_id
    margin = (logits[:, :blank].max(-1).values - logits[:, blank]).sort().values.double()
    cap, base = n.long() * model.max_symbols, float(bias[blank])
    best = (-1, 0.0)
    for i in np.linspace(0, len(margin) - 2, candidates).round().astype(int).tolist():
        shift = float(margin[i] + margin[i + 1]) / 2
        bias[blank] = base + shift
        _, c = model.greedy_decode(enc, n)
        best = max(best, (int(torch.minimum(c.long(), cap - c.long()).min()), shift))
    bias[blank] = base
    return best[1]


def phase_rnnt_exactness(k1, k2, tol: float = 1e-3) -> dict:
    """18. One seeded Conformer-Transducer-Large with both flags, fp32, on
    the card and on the CPU, at B=2 x 5 s (one ragged), the blank bias of
    both shifted by the CPU's `blank_shift` so that the decode both emits
    and advances (each row of the CPU's decode holds more than 0 and fewer
    than T' x max_symbols tokens): the encoder output on valid frames
    within `tol`; the joint logits along the CPU's greedy path within `tol`
    (the card's joint at the CPU's (frame, label) points); the card's tokens
    equal to the CPU's up to the first difference, and that only at a point
    of the CPU's path where its top-2 logits are within 2 tol of each other
    (phase 5's near-tie rule). Returns both models, by device."""
    pcm = torch.from_numpy(speechlike(2, int(5 * SR), np.random.RandomState(3)))
    lens = torch.tensor([5 * SR, 61000], dtype=torch.int32)
    out, launches, models, projected = {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        model = _rnnt_model("float32", device)
        with torch.no_grad():
            k1.launches = k2.launches = 0
            enc, n = model.encode(*model.mel_features(pcm.to(device), lens.to(device)))
            launches[device] = (k1.launches, k2.launches)
            projected[device] = (enc, n, model.joint.project_enc(enc))
        models[device] = model
    with torch.no_grad():
        shift = blank_shift(models["cpu"], *projected["cpu"][:2])
    for device, model in models.items():
        with torch.no_grad():
            model.joint.out_proj.bias[model.blank_id] += shift
        tokens, counts = model.decode(pcm.to(device), lens.to(device))
        enc, n, e = projected[device]
        out[device] = [x.cpu() for x in (enc.float(), n, tokens, counts)] + [e]
    if launches != {"cuda": (18, 1), "cpu": (0, 0)}:
        raise AssertionError(f"launches per encoder forward: {launches}")
    (enc, n, tokens, counts, e), (ref, ref_n, ref_tokens, ref_counts, ref_e) = (out["cuda"],
                                                                             out["cpu"])
    if not torch.equal(n, ref_n):
        raise AssertionError(f"frame lengths differ: {n} vs {ref_n}")
    cap = ref_n * models["cpu"].max_symbols
    if not bool(((ref_counts > 0) & (ref_counts < cap)).all()):
        raise AssertionError(f"the CPU's decode is degenerate after the blank shift {shift:+.4f}: "
                             f"tokens {ref_counts.tolist()} of at most {cap.tolist()}")
    enc_err = max(float((enc[b, :t] - ref[b, :t]).abs().max()) for b, t in enumerate(n.tolist()))
    logit_err, points, same = 0.0, 0, []
    for b, t in enumerate(n.tolist()):
        with torch.no_grad():
            path, ref_logits = greedy_path(models["cpu"], ref_e[b], t, ref_tokens[b],
                                           int(ref_counts[b]))
            ts, us = (torch.tensor(x) for x in zip(*path))
            m = models["cuda"]
            pp = m.joint.project_pred(m.prediction(ref_tokens[b:b + 1, :int(ref_counts[b])]
                                                .long().cuda())[0])
            logits = m.joint.from_projected(e[b, ts.cuda()], pp[us.cuda()]).cpu()
        logit_err = max(logit_err, float((logits - ref_logits).abs().max()))
        points += len(path)
        got, want = tokens[b, :int(counts[b])], ref_tokens[b, :int(ref_counts[b])]
        k = min(len(got), len(want))
        diff = (got[:k] != want[:k]).nonzero()
        first = int(diff[0]) if len(diff) else (k if len(got) != len(want) else None)
        same.append(first is None)
        if first is not None:  # allowed only at a near-tie of the CPU's joint at label `first`
            top2 = ref_logits[us == first].topk(2, dim=-1).values
            if not bool(((top2[:, 0] - top2[:, 1]) < 2 * tol).any()):
                raise AssertionError(f"row {b}: tokens differ at label {first}, not at a "
                                     "near-tie of the CPU's joint")
    log(f"rnnt fp32, cuda (kernels) vs cpu (plain), B=2 x 5 s, blank bias shifted by "
        f"{shift:+.4f}: max_abs_enc_diff={enc_err:.3e}, max_abs_joint_logit_diff="
        f"{logit_err:.3e} at the CPU's {points} path points (tolerance {tol:g}), tokens "
        f"{ref_counts.tolist()} (cpu) and {counts.tolist()} (cuda) of at most {cap.tolist()}, "
        f"identical rows {sum(same)}/2")
    if enc_err > tol or logit_err > tol or not torch.isfinite(enc).all():
        raise AssertionError("whole-model RNNT outputs disagree")
    return models


def phase_rnnt_loss(models, tol: float = 1e-4) -> None:
    """19. The RNNT loss on the planes of `fused_log_probs`, fp32, on the
    card and on the CPU, at B=4, T'=751, U=40, V+1=29 (ragged frames and
    targets), with phase 18's prediction nets and joints: the value within
    1e-5 relative; the gradients of every prediction and joint leaf within
    `tol` of the leaf's max-abs value. The value is each device's own pass.
    In the pass whose gradients are compared, the CPU takes the card's
    enc_proj and pred_proj outputs as its values (its gradients still flow
    through its own layers), as phase 6 gives both encoders the CPU's mel
    features: a joint ReLU whose pre-activation lies within the two devices'
    GEMM rounding (~1e-6) of 0 opens on one device only, and among this
    size's 79 M pre-activations such gates moved enc_proj's weight gradient by
    3.4e-4 to 1.9e-3 of its max (measured on one H100). Also the card's
    time of one loss forward and backward (the head fit's loss)."""
    from nemo_tpu_torch.ops.rnnt import rnnt_loss_from_log_probs

    gen = torch.Generator().manual_seed(4)
    Bl, T, U = 4, 751, 40
    enc = torch.randn(Bl, T, 512, generator=gen)
    targets = torch.randint(0, 28, (Bl, U), generator=gen)
    f_len = torch.tensor([751, 751, 600, 413])
    t_len = torch.tensor([40, 40, 31, 17])
    value, grads, card = {}, {}, {}
    for device in ("cuda", "cpu"):
        model = models[device]
        leaves = [p for name, p in model.named_parameters()
                  if name.split(".")[0] in ("prediction", "joint")]

        def loss_fn():
            lp_b, lp_l = model.joint.fused_log_probs(
                enc.to(device), model.prediction(targets.to(device)), targets.to(device), 16)
            return rnnt_loss_from_log_probs(lp_b, lp_l, f_len.to(device),
                                            t_len.to(device) + 1).mean()

        with torch.no_grad():
            value[device] = float(loss_fn())
        hooks = []
        for name in ("enc_proj", "pred_proj"):
            if device == "cuda":
                def hook(mod, args, out, name=name):
                    card[name] = out.detach().cpu()
            else:
                def hook(mod, args, out, name=name):
                    return out + (card[name] - out).detach()
            hooks.append(getattr(model.joint, name).register_forward_hook(hook))
        grads[device] = [g.cpu() for g in torch.autograd.grad(loss_fn(), leaves)]
        for h in hooks:
            h.remove()
        if device == "cuda":
            ms = cuda_ms(lambda: torch.autograd.grad(loss_fn(), leaves), iters=5)
    worst = max(float((g - r).abs().max()) / (float(r.abs().max()) + 1e-30)
                for g, r in zip(grads["cuda"], grads["cpu"]))
    rel = abs(value["cuda"] - value["cpu"]) / abs(value["cpu"])
    log(f"rnnt loss fp32 B={Bl}, T'={T}, U={U}: {value['cuda']:.6f} (cuda) vs {value['cpu']:.6f} "
        f"(cpu), rel diff {rel:.2e} (tolerance 1e-5); {len(leaves)} prediction and joint "
        f"gradients, worst max_abs_err {worst:.2e} of the leaf's max (tolerance {tol:g}); "
        f"{ms:.2f} ms a loss forward + backward on the card (chunks of 16 frames)")
    if rel > 1e-5 or worst > tol:
        raise AssertionError("the RNNT loss or its gradients disagree")


RNNT_UTT_TOKENS, RNNT_FIT_STEPS, RNNT_DENSITY_FLOOR, RNNT_TIMED = 40, 150, 20.0, 3


@contextlib.contextmanager
def rnnt_calls(model):
    """Record, in order, `model.decode`'s calls as ("decode", the decoder's
    loop count) and `fit_synthetic_asr`'s (the head fit that ends each
    `framewise_calibrate` of a transducer) as ("fit", seconds on the card's
    clock) while the block runs."""
    from nemo_tpu_torch.models.asr import synthetic

    calls, decode, fit = [], model.decode, synthetic.fit_synthetic_asr

    def counted_decode(*args, **kw):
        out = decode(*args, **kw)
        calls.append(("decode", model.last_loop_iterations))
        return out

    def timed_fit(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(*args, **kw)
        torch.cuda.synchronize()
        calls.append(("fit", time.perf_counter() - t0))
        return out

    model.decode, synthetic.fit_synthetic_asr = counted_decode, timed_fit
    try:
        yield calls
    finally:
        del model.decode
        synthetic.fit_synthetic_asr = fit


def phase_rnnt_calibration(counters: dict):
    """20. bench.py:bench_rnnt's calibration on the port: Conformer-Transducer-
    Large bf16, both flags, rounds of 150 framewise steps and 150 head-fit
    steps at B=4 x 30 s, U=40, each followed by the blank-bias trim, until a
    held-out probe decodes >= 20 tokens/utt (at most 3 rounds). Launches:
    K1 18 a framewise step, a head-fit step and a decode (the trim's and the
    probe's); K2 1 a head-fit step and a decode (the framewise forward takes
    the conv pair); K3 and K4 18 a framewise step."""
    from nemo_tpu_torch.models.asr.synthetic import calibrated_tone_batches

    model = _rnnt_model("bfloat16", None)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with rnnt_calls(model) as calls:
        staged, density, rounds = calibrated_tone_batches(
            model, B, SECS, RNNT_UTT_TOKENS, RNNT_TIMED, fit_steps=RNNT_FIT_STEPS,
            density_floor=RNNT_DENSITY_FLOOR, fit_batch=FIT_BATCH, log=log)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    fits = [i for i, (kind, _) in enumerate(calls) if kind == "fit"]
    if len(fits) != len(rounds):
        raise AssertionError(f"{len(fits)} head fits in {len(rounds)} calibration rounds")
    ends = fits[1:] + [len(calls)]
    for i, r in enumerate(rounds):  # a round: its framewise steps, its head fit, its decodes
        r["head_fit_s"] = calls[fits[i]][1]
        r["framewise_s"] = r["seconds"] - r["head_fit_s"]
        r["decodes"] = sum(kind == "decode" for kind, _ in calls[fits[i]:ends[i]])
        log(f"rnnt calibration round {i}: framewise {1e3 * r['framewise_s'] / r['steps']:.2f} "
            f"ms/step, head fit {1e3 * r['head_fit_s'] / r['steps']:.2f} ms/step (B={FIT_BATCH} "
            f"x {SECS:g} s, U={RNNT_UTT_TOKENS}), final framewise loss {r['loss']:.4f}, trim "
            f"delta {r['trim_delta']:+.4f} -> {r['trim_density']:.1f} tokens/utt, probe density "
            f"{r['density']:.1f} tokens/utt, {r['decodes']} decodes, "
            f"peak_mem={r['peak_mem_gib']:.2f} GiB")
    steps = RNNT_FIT_STEPS * len(rounds)
    decodes = sum(r["decodes"] for r in rounds)
    want = {"k1": 18 * (2 * steps + decodes), "k2": steps + decodes, "k3": 18 * steps,
            "k4": 18 * steps}
    log(f"rnnt calibration: {len(rounds)} round(s), {steps} framewise and {steps} head-fit "
        f"steps, {decodes} decodes, {wall:.1f} s in all, probe density {density:.1f} "
        f"tokens/utt, launches {launches}")
    if launches != want:
        raise AssertionError(f"rnnt calibration launch counts {launches}, expected {want}")
    return model, staged


def phase_rnnt_main_path(model, staged, k1, k2, profile: bool) -> None:
    """21. `transcribe_staged` of the calibrated transducer over held-out tone
    batches (B=32 x 30 s int16, make_eval_batch seeds 100 + i): one warm
    batch and 3 timed ones; more than 20 tokens/utt (bench.py:214), K1 18
    and K2 1 launches a batch."""
    model.transcribe_staged(staged[:1])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    with rnnt_calls(model) as calls:
        t0 = time.perf_counter()
        texts = model.transcribe_staged(staged[1:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"k1": k1.launches, "k2": k2.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rtfx = B * SECS * RNNT_TIMED / wall
    density = sum(map(len, texts)) / len(texts)
    iters = [loops for _, loops in calls]
    log(f"rnnt main path, transcribe_staged bf16 B={B} x {SECS:g} s, calibrated weights, "
        f"held-out tone audio, {RNNT_TIMED} timed batches: "
        f"conformer_transducer_rnnt_transcribe_rtfx={rtfx:.1f}, "
        f"{1e3 * wall / RNNT_TIMED:.1f} ms/batch, {density:.1f} tokens/utt, label-looping "
        f"loops per batch {iters}, peak_mem={peak:.2f} GiB, launches K1={launches['k1']} "
        f"K2={launches['k2']}")
    if len(texts) != B * RNNT_TIMED or len(iters) != RNNT_TIMED or not all(
            isinstance(s, str) for s in texts):
        raise AssertionError("transcribe_staged returned the wrong number of texts")
    if density <= RNNT_DENSITY_FLOOR:
        raise AssertionError(f"rnnt decode density {density:.1f} <= {RNNT_DENSITY_FLOOR}")
    want = {"k1": 18 * RNNT_TIMED, "k2": RNNT_TIMED}
    if launches != want:
        raise AssertionError(f"rnnt launch counts {launches}, expected {want}")
    if profile:
        profile_rnnt(model, staged[1:2])


def profile_rnnt(model, staged) -> None:
    """Where an RNNT batch's time goes: the encoder alone (mel, encoder,
    enc_proj) against the whole decode, by the host's clock after a sync;
    then one batch under torch.profiler (device time by kernel, the card's
    idle share) and 6 head-fit steps (after the main path: they move the
    weights)."""
    from torch.profiler import ProfilerActivity, profile

    from nemo_tpu_torch.models.asr.synthetic import fit_synthetic_asr

    sig, lens, _ = staged[0]

    def encoder_only():
        with torch.inference_mode():
            enc, _ = model.encode(*model.mel_features(sig, lens))
            model.joint.project_enc(enc)

    walls = {}
    for name, fn in (("encoder", encoder_only), ("decode", lambda: model.decode(sig, lens))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls[name] = 1e3 * (time.perf_counter() - t0) / 3
    log(f"profile, one RNNT batch by the host's clock: encoder {walls['encoder']:.2f} ms, whole "
        f"decode {walls['decode']:.2f} ms, so the label-looping loop "
        f"{walls['decode'] - walls['encoder']:.2f} ms ({model.last_loop_iterations} loops, "
        f"{1e3 * (walls['decode'] - walls['encoder']) / model.last_loop_iterations:.1f} us each)")
    profile_batch(model, staged)
    steps = 6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_synthetic_asr(model, steps=steps, batch=FIT_BATCH, secs=SECS,
                          utt_tokens=RNNT_UTT_TOKENS, lr=3e-3, seed=7)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"profile, RNNT head-fit step (B={FIT_BATCH} x {SECS:g} s, U={RNNT_UTT_TOKENS}): wall "
        f"{wall_ms:.2f} ms, kernels {busy_ms:.2f} ms in {len(kernels) / steps:.0f} device "
        f"operations, card idle {100 - 100 * busy_ms / wall_ms:.1f} % of the wall time")


TDT_DURATIONS = (0, 1, 2, 3, 4)
TDT_LAYERS = 24  # FastConformer-XL's depth: phases 35-36 run it whole
TDT_EXACT_LAYERS = 2  # phase 34's depth, at full width
# kinds of device kernels in a TDT batch or head-fit step, by a piece of their names
TDT_KERNEL_KINDS = (
    ("K1 rel-pos flash forward dh128", ("fwd128_kernel",)),
    ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass", "sm90_")),
    ("cuDNN convolutions", ("conv", "cudnn", "xmma", "implicit")),
    ("logcumsumexp / scans", ("scan", "cumsum", "logcumsumexp")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset", "fill", "index",
                                "gather", "scatter", "cat")))


def _tdt_model(dtype: str, device, n_layers: int = TDT_LAYERS):
    """FastConformer-XL with a TDT head, composed as bench.py:184-187 composes
    Conformer-Transducer-Large: `fastconformer_ctc("xlarge")`'s encoder (x8
    dw_striding through 256 channels, d 1024, 8 heads of 128, the conv
    kernel of 31 it inherits) in `dtype` with the rel-pos flash kernels,
    `conformer_transducer`'s decoder and joint (pred_hidden 640, 1 LSTM
    layer, joint_hidden 640, greedy_batch) and durations (0, 1, 2, 3, 4);
    seed 0; `n_layers` of the encoder's 24."""
    from nemo_tpu_torch.core.config import ConfigDict
    from nemo_tpu_torch.models.asr.configs import conformer_transducer, fastconformer_ctc
    from nemo_tpu_torch.models.asr.rnnt_models import EncDecRNNTModel

    cfg = fastconformer_ctc("xlarge")
    cfg.encoder.update(compute_dtype=dtype, att_impl="decomposed_flash", n_layers=n_layers)
    head = conformer_transducer("xlarge")
    cfg.decoder, cfg.joint, cfg.decoding = head.decoder, head.joint, head.decoding
    cfg.model_defaults = ConfigDict(tdt_durations=TDT_DURATIONS)
    return EncDecRNNTModel(cfg, device=device, seed=0)


def tdt_path(model, e: torch.Tensor, n: int, tokens: torch.Tensor, count: int):
    """Replay one row's TDT greedy decode from its tokens: the (frame, label)
    points where the decoder evaluated the joint, in order, and the token and
    duration logits there (`model`'s prediction net over the tokens and its
    joint on `e`, the row's projected encoder output [T', J]). Raises if the
    replay's argmax decisions do not give back `tokens`."""
    joint, blank, durs = model.joint, model.blank_id, model.durations
    pp = joint.project_pred(model.prediction(tokens[None, :count].long())[0])  # [U+1, J]
    t = u = 0
    points, tok_rows, dur_rows = [], [], []
    while t < n and len(points) < 2 * e.shape[0]:
        tok, dur = joint.from_projected(e[t], pp[u])
        points.append((t, u))
        tok_rows.append(tok)
        dur_rows.append(dur)
        k, d = int(tok.argmax()), durs[int(dur.argmax())]
        if k != blank:
            if u >= count or k != int(tokens[u]):
                raise AssertionError(f"the replay emits {k} at frame {t}, label {u}, where the "
                                     "decode did not")
            u += 1
        else:
            d = max(d, 1)
        t += d
    if u != count:
        raise AssertionError(f"the replay emits {u} labels, the decode {count}")
    return points, torch.stack(tok_rows), torch.stack(dur_rows)


def tdt_blank_shift(model, enc: torch.Tensor, n: torch.Tensor) -> float:
    """An offset for the blank logit's bias under which a random-init TDT
    model's greedy decode of `enc` [B, T', H] (`n` valid frames a row) both
    emits and skips: of the offsets -8, -7.5, .., 8, the one whose least
    balanced row is furthest from both ends (the largest min over rows of
    min(tokens, frames - tokens)), the nearest to 0 among equals. The
    model's bias is left as it was."""
    bias, blank = model.joint.out_proj.bias, model.blank_id
    base, best = float(bias[blank]), (-1, 0.0, 0.0)
    for shift in np.arange(-8.0, 8.25, 0.5).tolist():
        bias[blank] = base + shift
        _, c = model.greedy_decode(enc, n)
        best = max(best, (int(torch.minimum(c.long(), n.long() - c.long()).min()), -abs(shift),
                          shift))
    bias[blank] = base
    return best[2]


def phase_tdt_exactness(k1, k3, k4, tol: float = 1e-3, grad_tol: float = 1e-4) -> None:
    """34. One seeded FastConformer-XL TDT model at full width and 2 layers,
    fp32, on the card (K1, K3, K4 at dh 128) and on the CPU (plain
    versions), at B=2 x 5 s (one ragged), the blank bias of both shifted by
    the CPU's `tdt_blank_shift`: the encoder output on valid frames within
    `tol`; the token and duration logits along the CPU's greedy path
    (`tdt_path`) within `tol`; the card's tokens equal to the CPU's up to the
    first difference, and that only after a point of the CPU's path where
    its top-2 token or duration logits are within 2 tol (phase 18's
    near-tie rule). Then the TDT loss of the full joint on both devices'
    passes from the CPU's mel features (U = 8 and 5 random labels): the
    value within 1e-5 relative, and every parameter's gradient (encoder,
    prediction net, joint) within `grad_tol` of its max-abs value plus 1e-6
    of the largest (leaves whose exact gradient is 0, as linear_k's bias).
    In the pass whose gradients are compared the CPU takes the card's
    pre-activations of every ReLU (the subsampling's conv0, pw1, pw2 and the
    joint's sum of enc_proj and pred_proj) straight through, as phases 19
    and 25 do: a gate at a near-tie of the two devices' sums opens on one
    device only."""
    pcm = torch.from_numpy(speechlike(2, int(5 * SR), np.random.RandomState(5)))
    lens = torch.tensor([5 * SR, 61000], dtype=torch.int32)
    models, projected, launches = {}, {}, {}
    for device in (CARD, "cpu"):
        model = _tdt_model("float32", device, TDT_EXACT_LAYERS)
        with torch.no_grad():
            k1.launches = 0
            enc, n = model.encode(*model.mel_features(pcm.to(device), lens.to(device)))
            launches[device] = k1.launches
            projected[device] = (enc, n, model.joint.project_enc(enc))
        models[device] = model
    if launches != {CARD: TDT_EXACT_LAYERS, "cpu": 0}:
        raise AssertionError(f"K1 launches per encoder forward: {launches}")
    with torch.no_grad():
        shift = tdt_blank_shift(models["cpu"], *projected["cpu"][:2])
    out = {}
    for device, model in models.items():
        with torch.no_grad():
            model.joint.out_proj.bias[model.blank_id] += shift
        tokens, counts = model.decode(pcm.to(device), lens.to(device))
        enc, n, e = projected[device]
        out[device] = [x.cpu() for x in (enc.float(), n, tokens, counts)] + [e]
    (enc, n, tokens, counts, e), (ref, ref_n, ref_tokens, ref_counts, ref_e) = (out[CARD],
                                                                             out["cpu"])
    if not torch.equal(n, ref_n):
        raise AssertionError(f"frame lengths differ: {n} vs {ref_n}")
    if not bool(((ref_counts > 0) & (ref_counts < ref_n)).all()):
        raise AssertionError(f"the CPU's decode is degenerate after the blank shift {shift:+.2f}: "
                             f"tokens {ref_counts.tolist()} for frames {ref_n.tolist()}")
    enc_err = max(float((enc[b, :t] - ref[b, :t]).abs().max()) for b, t in enumerate(n.tolist()))
    logit_err, points, same = 0.0, 0, []
    for b, t in enumerate(n.tolist()):
        with torch.no_grad():
            path, ref_tok, ref_dur = tdt_path(models["cpu"], ref_e[b], t, ref_tokens[b],
                                              int(ref_counts[b]))
            ts, us = (torch.tensor(x) for x in zip(*path))
            m = models[CARD]
            pp = m.joint.project_pred(m.prediction(ref_tokens[b:b + 1, :int(ref_counts[b])]
                                                .long().to(CARD))[0])
            tok, dur = (x.cpu() for x in m.joint.from_projected(e[b, ts.to(CARD)],
                                                                pp[us.to(CARD)]))
        logit_err = max(logit_err, float((tok - ref_tok).abs().max()),
                        float((dur - ref_dur).abs().max()))
        points += len(path)
        got, want = tokens[b, :int(counts[b])], ref_tokens[b, :int(ref_counts[b])]
        k = min(len(got), len(want))
        diff = (got[:k] != want[:k]).nonzero()
        first = int(diff[0]) if len(diff) else (k if len(got) != len(want) else None)
        same.append(first is None)
        if first is not None:  # allowed only after a near-tie of the CPU's joint
            upto = us <= first
            gaps = [x[upto].topk(2, dim=-1).values for x in (ref_tok, ref_dur)]
            if not any(bool(((g[:, 0] - g[:, 1]) < 2 * tol).any()) for g in gaps):
                raise AssertionError(f"row {b}: tokens differ at label {first}, not after a "
                                     "near-tie of the CPU's joint")
    log(f"tdt fp32, FastConformer-XL width x {TDT_EXACT_LAYERS} layers, cuda (K1 dh128) vs cpu "
        f"(plain), B=2 x 5 s, blank bias shifted by {shift:+.2f}: max_abs_enc_diff="
        f"{enc_err:.3e}, max_abs_joint_logit_diff={logit_err:.3e} (token and duration) at the "
        f"CPU's {points} path points (tolerance {tol:g}), tokens {ref_counts.tolist()} (cpu) "
        f"and {counts.tolist()} (cuda) for frames {ref_n.tolist()}, identical rows {sum(same)}/2")
    if enc_err > tol or logit_err > tol or not torch.isfinite(enc).all():
        raise AssertionError("whole-model TDT outputs disagree")

    gen = torch.Generator().manual_seed(6)
    targets = torch.randint(1, 28, (2, 8), generator=gen)
    t_len = torch.tensor([8, 5])
    with torch.no_grad():
        feats = models["cpu"].mel_features(pcm, lens)
    relus = ("encoder.pre_encode.conv0", "encoder.pre_encode.pw1", "encoder.pre_encode.pw2",
             "joint.enc_proj", "joint.pred_proj")
    value, grads, card = {}, {}, {}
    for device in (CARD, "cpu"):
        model = models[device]
        args = [x.to(device) for x in (*feats, targets, t_len)]

        def loss_fn():
            logits, enc_len = model(*args[:3])
            return model.loss(logits, args[2], enc_len, args[3])

        with torch.no_grad():
            value[device] = float(loss_fn())
        hooks = []
        for name in relus:
            if device == CARD:
                def hook(mod, inputs, output, name=name):
                    card[name] = output.detach().cpu()
            else:
                def hook(mod, inputs, output, name=name):
                    return output + (card[name] - output).detach()
            hooks.append(model.get_submodule(name).register_forward_hook(hook))
        names, leaves = zip(*model.named_parameters())
        k3.launches = k4.launches = 0
        grads[device] = [g.cpu() for g in torch.autograd.grad(loss_fn(), leaves)]
        launches[device] = (k3.launches, k4.launches)
        for h in hooks:
            h.remove()
    if launches[CARD] != (TDT_EXACT_LAYERS, TDT_EXACT_LAYERS):
        raise AssertionError(f"K3, K4 launches of the backward: {launches[CARD]}")
    floor = 1e-6 * max(float(r.abs().max()) for r in grads["cpu"])
    worst, bad = 0.0, []
    for name, g, r in zip(names, grads[CARD], grads["cpu"]):
        limit = grad_tol * float(r.abs().max()) + floor
        err = float((g - r).abs().max())
        worst = max(worst, err / limit)
        if not torch.isfinite(g).all() or err > limit:
            bad.append(name)
    rel = abs(value[CARD] - value["cpu"]) / abs(value["cpu"])
    log(f"tdt loss fp32 (full joint, U=8): {value[CARD]:.6f} (cuda) vs {value['cpu']:.6f} "
        f"(cpu), rel diff {rel:.2e} (tolerance 1e-5); {len(names)} parameters' gradients "
        f"(K3, K4 dh128 on the card), worst at {worst:.3f} of its tolerance ({grad_tol:g} of "
        f"the leaf's max-abs + {floor:.1e})")
    if rel > 1e-5 or bad:
        raise AssertionError(f"the TDT loss or its gradients disagree: {bad}")


def phase_tdt_calibration(counters: dict):
    """35. bench.py:bench_rnnt's calibration on FastConformer-XL TDT (bf16,
    24 layers): rounds of 150 framewise steps (through a linear probe) and
    150 head-only TDT steps (the encoder frozen) at B=4 x 30 s, U=40, each
    round ended by the blank-bias trim, until a held-out probe decodes >= 20
    tokens/utt (at most 3 rounds). Launches: K1 24 a framewise step, a
    head-fit step and a decode (the trim's and the probe's); K3 and K4 24 a
    framewise step; K2 none (dw_striding is cuDNN's)."""
    from nemo_tpu_torch.models.asr.synthetic import calibrated_tone_batches

    model = _tdt_model("bfloat16", None)
    n_params = sum(p.numel() for p in model.parameters())
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with rnnt_calls(model) as calls:
        staged, density, rounds = calibrated_tone_batches(
            model, B, SECS, RNNT_UTT_TOKENS, RNNT_TIMED, fit_steps=RNNT_FIT_STEPS,
            density_floor=RNNT_DENSITY_FLOOR, fit_batch=FIT_BATCH, log=log)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    fits = [i for i, (kind, _) in enumerate(calls) if kind == "fit"]
    if len(fits) != len(rounds):
        raise AssertionError(f"{len(fits)} head fits in {len(rounds)} calibration rounds")
    ends = fits[1:] + [len(calls)]
    for i, r in enumerate(rounds):  # a round: its framewise steps, its head fit, its decodes
        r["head_fit_s"] = calls[fits[i]][1]
        r["framewise_s"] = r["seconds"] - r["head_fit_s"]
        r["decodes"] = sum(kind == "decode" for kind, _ in calls[fits[i]:ends[i]])
        log(f"tdt calibration round {i}: framewise {1e3 * r['framewise_s'] / r['steps']:.2f} "
            f"ms/step, head fit {1e3 * r['head_fit_s'] / r['steps']:.2f} ms/step (B={FIT_BATCH} "
            f"x {SECS:g} s, U={RNNT_UTT_TOKENS}), final framewise loss {r['loss']:.4f}, trim "
            f"delta {r['trim_delta']:+.4f} -> {r['trim_density']:.1f} tokens/utt, probe density "
            f"{r['density']:.1f} tokens/utt, {r['decodes']} decodes, "
            f"peak_mem={r['peak_mem_gib']:.2f} GiB")
    steps = RNNT_FIT_STEPS * len(rounds)
    decodes = sum(r["decodes"] for r in rounds)
    want = {"k1": TDT_LAYERS * (2 * steps + decodes), "k2": 0, "k3": TDT_LAYERS * steps,
            "k4": TDT_LAYERS * steps}
    log(f"tdt calibration, FastConformer-XL TDT ({n_params / 1e6:.1f} M parameters): "
        f"{len(rounds)} round(s), {steps} framewise and {steps} head-fit steps, {decodes} "
        f"decodes, {wall:.1f} s in all, probe density {density:.1f} tokens/utt, launches "
        f"{launches}")
    if launches != want:
        raise AssertionError(f"tdt calibration launch counts {launches}, expected {want}")
    return model, staged, launches


def phase_tdt_main_path(model, staged, k1, k2, profile: bool) -> dict:
    """36. `transcribe_staged` of the calibrated FastConformer-XL TDT over
    held-out tone batches (B=32 x 30 s int16, make_eval_batch seeds 100 + i):
    one warm batch and 3 timed ones; more than 20 tokens/utt (bench.py:214),
    K1 24 launches a batch, K2 none."""
    model.transcribe_staged(staged[:1])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    with rnnt_calls(model) as calls:
        t0 = time.perf_counter()
        texts = model.transcribe_staged(staged[1:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"k1": k1.launches, "k2": k2.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rtfx = B * SECS * RNNT_TIMED / wall
    density = sum(map(len, texts)) / len(texts)
    loops = [n for _, n in calls]
    log(f"tdt main path, transcribe_staged bf16 B={B} x {SECS:g} s, FastConformer-XL TDT, "
        f"calibrated weights, held-out tone audio, {RNNT_TIMED} timed batches: "
        f"fastconformer_tdt_transcribe_rtfx={rtfx:.1f}, {1e3 * wall / RNNT_TIMED:.1f} ms/batch, "
        f"{density:.1f} tokens/utt, TDT decoder loops per batch {loops}, "
        f"peak_mem={peak:.2f} GiB, launches K1={launches['k1']} K2={launches['k2']}")
    if len(texts) != B * RNNT_TIMED or len(loops) != RNNT_TIMED or not all(
            isinstance(s, str) for s in texts):
        raise AssertionError("transcribe_staged returned the wrong number of texts")
    if density <= RNNT_DENSITY_FLOOR:
        raise AssertionError(f"tdt decode density {density:.1f} <= {RNNT_DENSITY_FLOOR}")
    want = {"k1": TDT_LAYERS * RNNT_TIMED, "k2": 0}
    if launches != want:
        raise AssertionError(f"tdt launch counts {launches}, expected {want}")
    profile_tdt(model, staged[1:2], profile)
    return launches


def profile_tdt(model, staged, profile: bool) -> None:
    """Where a TDT batch's time goes, by the host's clock after a sync: the
    encoder alone (mel, encoder, enc_proj) against the whole decode, so the
    decoder loop's ms and µs a loop. With `profile`, one batch and then 6
    head-fit steps (after the main path: they move the weights) under
    torch.profiler: device time by kind, the card's idle share."""
    from nemo_tpu_torch.models.asr.synthetic import fit_synthetic_asr

    sig, lens, _ = staged[0]

    def encoder_only():
        with torch.inference_mode():
            enc, _ = model.encode(*model.mel_features(sig, lens))
            model.joint.project_enc(enc)

    walls = {}
    for name, fn in (("encoder", encoder_only), ("decode", lambda: model.decode(sig, lens))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls[name] = 1e3 * (time.perf_counter() - t0) / 3
    loop_ms = walls["decode"] - walls["encoder"]
    log(f"tdt batch by the host's clock: encoder {walls['encoder']:.2f} ms, whole decode "
        f"{walls['decode']:.2f} ms, so the TDT decoder loop {loop_ms:.2f} ms "
        f"({model.last_loop_iterations} loops, {1e3 * loop_ms / model.last_loop_iterations:.1f} "
        f"us each)")
    if not profile:
        return
    profile_by_kind(lambda: model.transcribe_staged(staged), TDT_KERNEL_KINDS,
                    f"one TDT batch (FastConformer-XL, B={B} x {SECS:g} s)")
    steps = 6
    profile_by_kind(lambda: fit_synthetic_asr(model, steps=steps, batch=FIT_BATCH, secs=SECS,
                                              utt_tokens=RNNT_UTT_TOKENS, lr=3e-3, seed=7),
                    TDT_KERNEL_KINDS, f"TDT head-fit step (B={FIT_BATCH} x {SECS:g} s, "
                    f"U={RNNT_UTT_TOKENS})", n_steps=steps)


# LLM serving at bench.py:bench_decode's geometry (scripts/decode_throughput.py:23-110): slots,
# max_len, prompt tokens, the one prefill bucket, tokens a decode_steps call, timed calls, and
# the one KV bucket that covers the run (decode_throughput.py:58)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PROMPT, SERVE_BUCKET, SERVE_CHUNK, SERVE_TIMED = (
    8, 1024, 48, 64, 64, 2)
SERVE_KV_BUCKET = SERVE_PROMPT + SERVE_CHUNK * (2 + SERVE_TIMED) + 2
SERVE_STEPS = 16  # decode_step calls (phases 22, 23) and decode_steps tokens (phase 22)
# the LLMServer cell: slots, max_len, the shared prefix, tokens an answer, the scored prompt
SERVER_SLOTS, SERVER_MAX_LEN, SERVER_PREFIX, SERVER_TOKENS, SCORE_TOKENS = 8, 512, 32, 16, 200
SCORE_S = 256  # the scored prompt padded to a power of two: K5's shape in LLMServer.score
# nats, the served log-probabilities against the plain attention's (read 6.258e-2 on an H100
# 80GB HBM3 at 700 W: bf16 attention outputs rounded otherwise, carried through 16 layers)
SCORE_TOL = 0.1
SERVE_KERNEL_KINDS = (
    ("GEMM", ("nvjet", "gemm", "cutlass", "sm90_", "gemv")), ("softmax", ("softmax",)),
    ("index and scatter", ("index", "scatter", "gather")), ("reductions", ("reduce_kernel",)),
    ("casts and copies", ("copy", "Memcpy", "Memset", "fill")), ("cat", ("CatArray",)),
    ("elementwise", ("elementwise",)))


def _decode_cfg(**kw):
    """The bench's model (scripts/decode_throughput.py:35-40): 16 layers,
    hidden 2048, FFN 8192, 16 heads x dh 128 (MHA), vocab 32,000, an untied
    head, the einsum attention; bf16 compute on fp32 parameters."""
    from nemo_tpu_torch.models.llm.config import GPTConfig

    return GPTConfig(**{"num_layers": 16, "hidden_size": 2048, "ffn_hidden_size": 8192,
                        "num_attention_heads": 16, "kv_channels": 128, "vocab_size": 32000,
                        "seq_length": SERVE_MAX_LEN, "scan_layers": False,
                        "attention_backend": "xla", **kw})


def _seed_params(cfg, device: str):
    """The JAX-layout parameter tree of a port model built on `device` from
    seed 0, as tensors there (the bench seeds its weights too)."""
    from nemo_tpu_torch.interop.jax_params import export_jax_variables
    from nemo_tpu_torch.models.llm.gpt import build_model

    model = build_model(cfg, torch.device(device), seed=0)
    return export_jax_variables(model, as_tensors=True)["params"]


def _gap(row: torch.Tensor, token: int) -> float:
    """How far the logit of `token` lies below the max of `row`, as a share
    of the row's max-abs: 0 for the greedy token, under a tolerance for a
    token that another rounding of the same row could have picked."""
    row = row.float()
    return float((row.max() - row[int(token)]) / row.abs().max())


def _record_logits(model) -> list:
    """Every forward's logits of `model`, on the host, in order."""
    out = []
    model.register_forward_hook(lambda m, args, res: out.append(res[0].float().cpu()))
    return out


@contextlib.contextmanager
def _replay(run: dict, card: Optional[dict], model, bf16_products: bool, tol: float):
    """While the block runs, record (card is None) or replay (the CPU, given
    the card's record) every rounding of the serving path that sees its
    input's last bits: the greedy tokens (`generate._temp_sample`; the
    CPU's own may differ only where the card's token has a CPU logit within
    `tol` of the row's max-abs below the row's max), what each forward writes into the cache
    (`gpt._to_cache`; int8 entries by at most 1, scales within 1e-5
    relative, bf16 values by one step of their row's max-abs) and, with `bf16_products`, the
    attention's bf16 value product (o_proj's input, within one bf16 step of
    its row's max-abs: its bf16 probabilities round at ties too, and a
    sum that cancels moves by more than one step of its own). The CPU checks its own value, counts the
    differences and goes on with the card's, so that the logits compare
    the arithmetic alone."""
    from nemo_tpu_torch.models.llm import generate, gpt

    to_cache, temp_sample = gpt._to_cache, generate._temp_sample
    for key in ("tokens", "stored", "attn"):
        run[key] = []
    run.update(ties=0, flips=0, entries=0, attn_flips=0, attn_entries=0, attn_rel=0.0,
               store_rel=0.0)

    def take(key, ours):
        """ours, recorded on the card; the card's matching value on the CPU"""
        if card is None:
            run[key].append(ours)
            return None
        run[key].append(None)
        return card[key][len(run[key]) - 1]

    def sample(logits, *args, **kw):
        ours = temp_sample(logits, *args, **kw)
        theirs = take("tokens", ours.cpu())
        if theirs is None:
            return ours
        for r in np.flatnonzero((ours.cpu() != theirs).numpy()):
            if _gap(logits[r], theirs[r]) > tol:
                raise AssertionError(f"serving exactness: the card's greedy token lies "
                                     f"{_gap(logits[r], theirs[r]):.3e} of the row's max-abs "
                                     f"below the CPU's max")
            run["ties"] += 1
        return theirs.to(ours.device)

    def stored(x, c):
        ours = to_cache(x, c)
        host = ({k: t.cpu() for k, t in ours.items()} if isinstance(ours, dict) else ours.cpu())
        theirs = take("stored", host)
        if theirs is None:
            return ours
        if isinstance(ours, dict):
            d = (host["q"].int() - theirs["q"].int()).abs()
            if int(d.max()) > 1:
                raise AssertionError("serving exactness: int8 cache entries differ by more than 1")
            run["flips"] += int((d > 0).sum())
            run["entries"] += d.numel()
            pairs = [(host["s"], theirs["s"])]
        else:  # bf16 values near 0 move by more than their own step: hold them to the row's
            pairs = [(host.float(), theirs.float())]
            run["flips"] += int((host != theirs).sum())
            run["entries"] += host.numel()
        for x_, y_ in pairs:
            scale = y_.abs().amax(-1, keepdim=True).clamp_min(1e-30)
            run["store_rel"] = max(run["store_rel"], float(((x_ - y_).abs() / scale).max()))
        return ({k: t.to(x.device) for k, t in theirs.items()} if isinstance(theirs, dict)
                else theirs.to(x.device))

    def product(m, args):
        x = args[0]
        theirs = take("attn", x.detach().cpu().clone())
        if theirs is None:
            return None
        d = (x - theirs).abs()
        scale = theirs.abs().amax(-1, keepdim=True)
        run["attn_rel"] = max(run["attn_rel"], float((d / scale.clamp_min(1e-30)).max()))
        if (d > 2 ** -7 * scale).any():
            raise AssertionError("serving exactness: the attention outputs differ by more than "
                                 "one bf16 step of their row's max")
        run["attn_flips"] += int((d > 0).sum())
        run["attn_entries"] += d.numel()
        return (theirs,) + tuple(args[1:])

    hooks = ([layer.attention.o_proj.register_forward_pre_hook(product)
              for layer in model.layers] if bf16_products else [])
    gpt._to_cache, generate._temp_sample = stored, sample
    try:
        yield
    finally:
        gpt._to_cache, generate._temp_sample = to_cache, temp_sample
        for h in hooks:
            h.remove()


def phase_serving_exactness(tol: float = 1e-3) -> None:
    """22. The serving path in fp32 at the bench's width, depth cut to 2
    layers, on the card and on the CPU, in two modes: bf16 weights with a
    bf16 cache, and int8 PTQ (`ptq(algorithm="int8_serve")`) with the int8
    cache. Four slots, ragged prompts; prefill_slot, 16 decode_step calls
    (the write-then-attend route), then decode_steps(16) (the
    attend-then-write route). The CPU replays the card's roundings
    (`_replay`): its greedy tokens equal the card's but at near-ties (the
    card's token within `tol` of the row's max-abs below the CPU's max), what it writes into the cache
    equals the card's but at rounding ties (int8 entries by 1, at most 1e-3
    of them; bf16 values by one step of their row's max-abs), and so does
    the bf16 cache's bf16 value product (within one step of its row's
    max-abs); then the logits of every forward within `tol` of each row's
    max."""
    from nemo_tpu_torch.llm.api import ptq
    from nemo_tpu_torch.models.llm.generate import ContinuousBatchingEngine

    cfg = _decode_cfg(num_layers=2, compute_dtype="float32")
    params = _seed_params(cfg, "cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, cfg.vocab_size, n).tolist() for n in (48, 37, 64, 21)]
    active = np.ones(len(prompts), bool)
    for mode in ("bf16 weights, bf16 cache", "int8 PTQ, int8 cache"):
        if mode.startswith("bf16"):
            mcfg, mparams, cache = (dataclasses.replace(cfg, params_dtype="bfloat16"), params,
                                    torch.bfloat16)
        else:
            (mcfg, mparams), cache = ptq(cfg, params, algorithm="int8_serve"), torch.int8
        runs = []  # the card's run, then the CPU's
        for dev in (CARD, "cpu"):
            t0 = time.perf_counter()
            eng = ContinuousBatchingEngine(mcfg, mparams, max_slots=len(prompts),
                                           max_len=SERVE_MAX_LEN, prefill_buckets=(SERVE_BUCKET,),
                                           kv_len_buckets=(128,), cache_dtype=cache, device=dev)
            run = {"logits": _record_logits(eng.model)}
            with _replay(run, runs[0] if runs else None, eng.model, cache == torch.bfloat16, tol):
                feed = np.array([eng.prefill_slot(s, p) for s, p in enumerate(prompts)])
                for i in range(SERVE_STEPS):
                    feed = eng.decode_step(feed, active, seed=i)
                toks, emitted, _ = eng.decode_steps(feed, active, n_steps=SERVE_STEPS)
            if not emitted.all():
                raise AssertionError(f"{mode}, {dev}: a slot stopped in decode_steps")
            run["toks"], run["s"] = toks, time.perf_counter() - t0
            runs.append(run)
            del eng
        card, cpu = runs
        worst = max(float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())
                    for a, b in zip(card["logits"], cpu["logits"]))
        if len(cpu["logits"]) != len(prompts) + 2 * SERVE_STEPS or worst > tol:
            raise AssertionError(f"{mode}: {len(cpu['logits'])} forwards, logits within "
                                 f"{worst:.3e} of the row's max")
        if not np.array_equal(card["toks"], cpu["toks"]):
            raise AssertionError(f"{mode}: the replayed decode_steps tokens differ")
        if cache == torch.int8 and cpu["flips"] > 1e-3 * cpu["entries"]:
            raise AssertionError(f"{mode}: {cpu['flips']} of {cpu['entries']} int8 cache entries "
                                 f"differ")
        if cpu["store_rel"] > (1e-5 if cache == torch.int8 else 2 ** -7):
            raise AssertionError(f"{mode}: stored values differ by {cpu['store_rel']:.3e}")
        products = (f"; {cpu['attn_flips']} of {cpu['attn_entries']} bf16 attention outputs "
                    f"differ, by at most {cpu['attn_rel']:.3e} of their row's max-abs"
                    if cache == torch.bfloat16 else "")
        log(f"serving exactness, {mode}: 2 layers at the decode bench's width (hidden 2048, 16 "
            f"heads x dh 128, FFN 8192, vocab 32000), fp32, {len(prompts)} slots, prompts "
            f"{[len(p) for p in prompts]}, {SERVE_STEPS} decode_step + decode_steps"
            f"({SERVE_STEPS}), card vs cpu (the CPU replaying the card's roundings): logits of "
            f"{len(cpu['logits'])} forwards within {worst:.3e} of each row's max (tolerance "
            f"{tol:g}); {cpu['ties']} near-tie greedy tokens; cache writes equal but "
            f"{cpu['flips']} of {cpu['entries']} "
            + ("int8 entries (by 1)" if cache == torch.int8 else "bf16 values")
            + f", {'scales' if cache == torch.int8 else 'values'} within "
            f"{cpu['store_rel']:.3e} of their row's max-abs{products}; card {card['s']:.1f} s, "
            f"CPU {cpu['s']:.1f} s")


def phase_decode_bench(profile: bool) -> None:
    """23. bench.py:bench_decode on the port (scripts/decode_throughput.py:run
    at its geometry): the bench's model at full width and depth from seed 0,
    int8 PTQ + int8 KV and then bf16 weights + bf16 KV; 8 slots prefilled with
    48-token prompts, max_len 1024, one prefill bucket (64) and one KV bucket
    (306); a warm decode_steps chunk of 64 tokens, then 2 timed: tokens/s
    over the slots and ms a step of the median chunk; 16 decode_step calls;
    the weight bytes and the roofline at 3.35 TB/s; peak memory."""
    from nemo_tpu_torch.llm.api import ptq
    from nemo_tpu_torch.models.llm.generate import ContinuousBatchingEngine

    cfg = _decode_cfg()
    for mode in ("int8_ptq+kv8", "bf16"):
        t0 = time.perf_counter()
        params = _seed_params(cfg, CARD)
        if mode == "bf16":
            mcfg, cache = dataclasses.replace(cfg, params_dtype="bfloat16"), torch.bfloat16
        else:
            (mcfg, params), cache = ptq(cfg, params, algorithm="int8_serve"), torch.int8
        eng = ContinuousBatchingEngine(mcfg, params, max_slots=SERVE_SLOTS,
                                       max_len=SERVE_MAX_LEN, prefill_buckets=(SERVE_BUCKET,),
                                       kv_len_buckets=(SERVE_KV_BUCKET,), cache_dtype=cache,
                                       device=CARD)
        del params
        torch.cuda.empty_cache()
        build_s = time.perf_counter() - t0
        rng = np.random.RandomState(0)
        for s in range(SERVE_SLOTS):
            eng.prefill_slot(s, rng.randint(1, 30000, SERVE_PROMPT).tolist())
        active = np.ones(SERVE_SLOTS, bool)
        toks, emitted, _ = eng.decode_steps(rng.randint(1, 30000, SERVE_SLOTS), active,
                                            n_steps=SERVE_CHUNK)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunk_s = []
        for i in range(SERVE_TIMED):
            t0 = time.perf_counter()
            toks, emitted, act = eng.decode_steps(toks[-1], active, n_steps=SERVE_CHUNK, seed=i)
            chunk_s.append(time.perf_counter() - t0)  # decode_steps ends in its read-back
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not (emitted.all() and act.all() and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"{mode}: decode_steps gave {toks} {emitted}")
        nxt = eng.decode_step(toks[-1], active)
        t0 = time.perf_counter()
        for i in range(SERVE_STEPS):
            nxt = eng.decode_step(nxt, active, seed=i)
        ms_single = 1e3 * (time.perf_counter() - t0) / SERVE_STEPS
        want_len = SERVE_PROMPT + SERVE_CHUNK * (1 + SERVE_TIMED) + 1 + SERVE_STEPS
        if eng.cur_len.tolist() != [want_len] * SERVE_SLOTS:
            raise AssertionError(f"{mode}: write rows {eng.cur_len} for {want_len}")
        med = float(np.median(chunk_s))
        tps = SERVE_SLOTS * SERVE_CHUNK / med
        wbytes = sum(p.numel() * p.element_size() for p in eng.model.parameters())
        emb = eng.model.embedding
        step_bytes = wbytes - emb.numel() * emb.element_size()  # the table is read 8 rows a step
        roof = SERVE_SLOTS / (wbytes / PEAK_BYTES)
        log(f"decode bench ({mode}, gpt1b_decode_tokens_per_sec_chip): the decode bench's model "
            f"({sum(p.numel() for p in eng.model.parameters()) / 1e6:.1f} M parameters, built "
            f"and converted in {build_s:.1f} s), {SERVE_SLOTS} slots, {SERVE_PROMPT}-token "
            f"prompts, KV bucket {SERVE_KV_BUCKET}: {tps:.1f} tokens/s, {1e3 * med / SERVE_CHUNK:.3f}"
            f" ms/step (median of {SERVE_TIMED} chunks of {SERVE_CHUNK}: "
            + ", ".join(f"{1e3 * c:.1f}" for c in chunk_s) + f" ms), {ms_single:.3f} ms/step "
            f"unchunked ({SERVE_STEPS} decode_step calls); weights {wbytes / 1e9:.3f} GB "
            f"({step_bytes / 1e9:.3f} GB without the embedding table), roofline "
            f"{roof:.1f} tokens/s at {PEAK_BYTES / 1e12:.2f} TB/s (bench's formula, every "
            f"parameter byte a step), {100 * tps / roof:.2f} % of it; "
            f"{SERVE_SLOTS / (step_bytes / PEAK_BYTES):.1f} tokens/s without the table's bytes; "
            f"peak_mem={peak:.2f} GiB")
        if profile:  # one more chunk: device time a step by kind, the card's idle share
            profile_by_kind(lambda: eng.decode_steps(toks[-1], active, n_steps=SERVE_CHUNK,
                                                     seed=99),
                            SERVE_KERNEL_KINDS, "decode step", n_steps=SERVE_CHUNK)
        del eng
        torch.cuda.empty_cache()


class ServeTokenizer(ByteTokenizer):
    """The byte tokenizer with a reversible `ids_to_text` for any id
    ("<id>" a token), so that answers can be compared token by token."""

    def ids_to_text(self, ids) -> str:
        return "".join(f"<{int(i)}>" for i in ids)

    @staticmethod
    def ids_of(text: str):
        import re

        return [int(i) for i in re.findall(r"<(\d+)>", text)]


def _post(port: int, path: str, body: bytes, ctype: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", path, body, {"Content-Type": ctype})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data, time.perf_counter() - t0


def _http(port: int, path: str, payload: dict):
    status, body, wall = _post(port, path, json.dumps(payload).encode(), "application/json")
    return status, body.decode(), wall


def phase_llm_server(counters: dict, tol: float = 1e-2, score_tol: float = SCORE_TOL) -> dict:
    """24. `LLMServer` on Llama-3.2-1B (full width and depth, seed-0 weights,
    bf16, flash backend) with quantize_weights and quantize_kv_cache, on an
    ephemeral port: 8 concurrent /v1/completions sharing a 32-token prefix
    (the automatic prefix cache must hold it), one streamed
    /v1/chat/completions, and the scoring form of /v1/completions on a
    200-token prompt (padded to 256: K5 launches 16 times, once a layer, and
    nothing else of K1-K13 launches in the phase). Each answer's shape and
    token count are checked; the greedy answers equal the engine's own run
    of the same prompts (one slot, decode_steps of one step fed the
    server's tokens), but at near-ties: the served token's logit in the
    engine's row lies within `tol` of the row's max-abs below its max (the
    first request admitted was prefilled before its prefix was stored, the
    engine's run takes the stored prefix). The served log-probabilities of
    the scored prompt equal, within `score_tol` nats, those of the same
    model scoring it with K5's plain version in K5's place.
    Returns the phase's launch counts."""
    import threading

    from nemo_tpu_torch.models.llm.config import llama32_1b
    from nemo_tpu_torch.serve.openai_server import LLMServer

    tok = ServeTokenizer()
    cfg = llama32_1b(seq_length=SERVER_MAX_LEN, attention_backend="flash")
    t0 = time.perf_counter()
    srv = LLMServer(cfg, _seed_params(cfg, CARD), tok, max_slots=SERVER_SLOTS,
                    max_len=SERVER_MAX_LEN, quantize_weights=True, quantize_kv_cache=True,
                    device=CARD)
    torch.cuda.empty_cache()
    srv.serve(port=0, blocking=False)
    log(f"server: Llama-3.2-1B int8 PTQ + int8 KV up on port {srv.port} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(7)
    prefix = "".join(chr(97 + c) for c in rng.randint(0, 26, SERVER_PREFIX))
    prompts = [prefix + chr(65 + i) + "".join(chr(97 + c) for c in rng.randint(0, 26, 8 + 2 * i))
               for i in range(SERVER_SLOTS)]
    for fn in counters.values():
        fn.launches = 0
    results = [None] * len(prompts)

    def call(i):
        results[i] = _http(srv.port, "/v1/completions",
                           {"prompt": prompts[i], "max_tokens": SERVER_TOKENS})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    answers = []
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            raise AssertionError(f"request {i}: {res}")
        out = json.loads(res[1])
        answers.append(tok.ids_of(out["choices"][0]["text"]))
        if out["object"] != "text_completion" or len(answers[-1]) != SERVER_TOKENS:
            raise AssertionError(f"request {i}: {out}")
    key = tuple(tok.text_to_ids(prefix))
    if key not in srv.engine._prefix_store:
        raise AssertionError(f"the shared {SERVER_PREFIX}-token prefix was not registered: "
                             f"{[len(k) for k in srv.engine._prefix_store]}")
    status, body, chat_s = _http(srv.port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": prompts[0]}], "max_tokens": SERVER_TOKENS,
        "stream": True})
    events = [e for e in body.split("\n\n") if e.startswith("data: ")]
    pieces = [json.loads(e[6:])["choices"][0]["delta"]["content"] for e in events[:-1]]
    if status != 200 or events[-1] != "data: [DONE]" or len(pieces) != SERVER_TOKENS:
        raise AssertionError(f"streamed chat: {status} {body[:400]}")
    score_text = "".join(chr(97 + c) for c in rng.randint(0, 26, SCORE_TOKENS))
    status, body, score_s = _http(srv.port, "/v1/completions", {
        "prompt": score_text, "max_tokens": 0, "logprobs": 1})
    lp = json.loads(body)["choices"][0]["logprobs"]
    token_lp = np.array(lp["token_logprobs"][1:], np.float64)
    if (status != 200 or len(lp["tokens"]) != SCORE_TOKENS or lp["token_logprobs"][0] is not None
            or len(token_lp) != SCORE_TOKENS - 1 or not np.isfinite(token_lp).all()
            or (token_lp > 0).any()):
        raise AssertionError(f"score: {status} {body[:400]}")
    launches = {name: fn.launches for name, fn in counters.items()}
    srv.shutdown()
    import nemo_tpu_torch.models.llm.gpt as gpt
    from nemo_tpu_torch.ops.flash_attention import flash_attention_plain

    kernel = gpt.flash_attention
    gpt.flash_attention = lambda q, k, v, scale, causal, window: flash_attention_plain(
        q, k, v, scale, causal, window)[0]
    try:
        _, plain_lp = srv.score(score_text)
    finally:
        gpt.flash_attention = kernel
    score_err = float(np.abs(token_lp - np.array(plain_lp[1:], np.float64)).max())
    log(f"server score: the served log-probabilities of {SCORE_TOKENS} tokens within "
        f"{score_err:.3e} nats of K5's plain version's (tolerance {score_tol:g}), mean "
        f"{token_lp.mean():.4f}")
    if score_err > score_tol:
        raise AssertionError(f"score: {score_err:.3e} nats from the plain attention's")
    if srv._worker.is_alive():
        raise AssertionError("the server's worker did not stop")
    want = {name: 0 for name in counters}
    want["k5"] = cfg.num_layers
    if launches != want:
        raise AssertionError(f"server launch counts {launches}, expected {want}")
    # the engine's own run of each prompt, fed the server's tokens
    eng = srv.engine
    logits = _record_logits(eng.model)
    active = np.zeros(SERVER_SLOTS, bool)
    active[0] = True
    ties, gaps = 0, []
    for prompt, answer in zip(prompts, answers):
        ids = tok.text_to_ids(prompt)
        skip = eng._match_prefix(ids)  # the stored prefix's tokens are not prefilled
        logits.clear()
        got = [eng.prefill_slot(0, ids)]
        feed = np.zeros(SERVER_SLOTS, np.int64)
        for t in answer[:-1]:  # one step a call: the server's route, fed its tokens
            feed[0] = t
            got.append(int(eng.decode_steps(feed, active, n_steps=1)[0][0, 0]))
        eng.free_slot(0)
        rows = [logits[0][0, len(ids) - skip - 1]] + [lg[0, -1] for lg in logits[1:]]
        for i in np.flatnonzero(np.array(got) != np.array(answer)):
            gaps.append(_gap(rows[i], answer[i]))
            if gaps[-1] > tol:
                raise AssertionError(f"a served greedy token lies {gaps[-1]:.3e} of the row's "
                                     f"max-abs below the max of the engine's row")
            ties += 1
    log(f"server (Llama-3.2-1B, flash, int8 PTQ + int8 KV, {SERVER_SLOTS} slots): "
        f"{len(prompts)} concurrent /v1/completions of {SERVER_TOKENS} tokens sharing a "
        f"{SERVER_PREFIX}-token prefix in {wall:.3f} s (requests "
        + ", ".join(f"{r[2]:.3f}" for r in results) + f" s; {wall / len(prompts):.3f} s a "
        f"request), prefix registered; streamed chat {chat_s:.3f} s ({len(pieces)} events); "
        f"score of {SCORE_TOKENS} tokens (S=256) {score_s:.3f} s; launches {launches}; answers "
        f"equal the engine's own run but {ties} near-tie tokens (the served token "
        + ", ".join(f"{g:.2e}" for g in gaps) + f" of the row's max-abs below the engine's max, "
        f"tolerance {tol:g})")
    del srv, eng
    torch.cuda.empty_cache()
    return launches


# speech synthesis at bench.py:bench_tts's values (bench.py:247-296): the config over JAX's
# defaults, the fit, the sentence, batch, timed calls, and mel frames an audio second
# (22,050 Hz over a hop of 256)
TTS_CFG = {"max_mel_len": 1024, "min_token_duration": 1}
TTS_FIT = {"steps": 40, "batch": 4, "seq": 48}
TTS_TEXT = ("the quick brown fox jumps over the lazy dog and keeps on running through the quiet "
            "green fields toward the river")
TTS_SHORT = "Hello there!"
TTS_B, TTS_ITERS, TTS_VOC_ITERS, FRAMES_PER_SEC = 8, 10, 3, 86.13
# fp32 tolerances, card against CPU: of each tensor's max (FastPitch), absolute (the waveform),
# how near k + 0.5 a duration before rounding may lie where the two differ, the loss relative,
# each gradient of its leaf's max
TTS_TOL, WAVE_TOL, HALF_TIE, TTS_LOSS_TOL, TTS_GRAD_TOL = 1e-3, 1e-3, 1e-4, 1e-5, 1e-4
AGENT_TOKENS = 16  # the voice agent's LLM reply, greedy
AGENT_SYMBOLS = "abcdefghijklmnopqrstuvwxyz "
TTS_KERNEL_KINDS = (  # cuDNN's convolutions first: their names hold "gemm" too
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "gemv")), ("softmax", ("softmax",)),
    ("normalisation", ("layer_norm", "LayerNorm")), ("reductions", ("reduce_kernel",)),
    ("index, gather, scan", ("index", "gather", "scatter", "searchsorted", "scan")),
    ("casts and copies", ("copy", "Memcpy", "Memset", "fill")),
    ("elementwise", ("elementwise",)))


class AgentTokenizer(ByteTokenizer):
    """The byte tokenizer with an `ids_to_text` that spells any id as a
    letter or a space (`AGENT_SYMBOLS[id % 27]`): a random model's ids lie
    mostly past the bytes, and the reply must still carry symbols to speak."""

    def ids_to_text(self, ids) -> str:
        return "".join(AGENT_SYMBOLS[int(i) % len(AGENT_SYMBOLS)] for i in ids)


def _tts_tokens(model, texts, device):
    """[B, U] ids right-padded with 0, and the lengths, on `device`."""
    ids = [model.tokenizer.text_to_ids(t) for t in texts]
    tokens = torch.zeros(len(ids), max(map(len, ids)), dtype=torch.long)
    for i, x in enumerate(ids):
        tokens[i, : len(x)] = torch.tensor(x)
    return tokens.to(device), torch.tensor([len(x) for x in ids], device=device)


def phase_tts_exactness() -> None:
    """25. FastPitch (bench_tts's config) and HiFi-GAN V1 from seed 0 in fp32,
    card against CPU, on B=2 ragged texts: the encoder stage; the durations
    (equal, but where the CPU's value before rounding lies within HALF_TIE of
    k + 0.5); the mel decoded from the CPU's durations; the waveform vocoded
    from the CPU's mel; one loss (train=False) and its gradients on a batch
    the CPU draws."""
    from nemo_tpu_torch.interop.jax_params import model_variables
    from nemo_tpu_torch.models.tts import FastPitchModel, HifiGanModel

    fp = {d: FastPitchModel(TTS_CFG, device=d, seed=0) for d in (CARD, "cpu")}
    voc = {d: HifiGanModel(device=d, seed=0) for d in (CARD, "cpu")}
    tokens, lens = _tts_tokens(fp["cpu"], [TTS_TEXT, TTS_SHORT], "cpu")
    with torch.inference_mode():
        enc = {d: m(tokens.to(d), lens.to(d), stage="encode") for d, m in fp.items()}
    errs = []
    for key in ("enc", "log_dur_pred", "pitch_pred"):
        ref = enc["cpu"][key]
        errs.append(compare(f"fastpitch encode {key}", enc[CARD][key].cpu(), ref,
                            TTS_TOL * float(ref.abs().max()), 0.0))
    dur, ref_dur = enc[CARD]["durations"].cpu(), enc["cpu"]["durations"]
    # the CPU's durations before rounding (pace 1): a half-tie rounds either way
    v = torch.clamp(torch.exp(enc["cpu"]["log_dur_pred"]) - 1.0, float(TTS_CFG[
        "min_token_duration"]), float(fp["cpu"].max_token_duration))
    tie = (v - torch.floor(v) - 0.5).abs() < HALF_TIE
    off = dur != ref_dur
    if bool((off & ~tie).any()):
        raise AssertionError(f"durations differ away from a half-tie at {off.nonzero().tolist()}")
    n = int(ref_dur.sum(1).max())
    length = min(n + 1, fp["cpu"].max_mel_len)
    with torch.inference_mode():
        mel = {d: m(tokens.to(d), lens.to(d), stage="decode", enc=enc[d]["enc"],
                    dur=ref_dur.to(d), mel_max_len=length)["mel"][:, :, :n]
               for d, m in fp.items()}
    errs.append(compare("fastpitch decode (the CPU's durations)", mel[CARD].cpu(), mel["cpu"],
                        TTS_TOL * float(mel["cpu"].abs().max()), 0.0))
    wave = {d: m.convert_spectrogram_to_audio(mel["cpu"].to(d)) for d, m in voc.items()}
    werr = compare("hifigan V1 (the CPU's mel)", wave[CARD].cpu(), wave["cpu"], WAVE_TOL, 0.0)
    # the loss and every gradient, train=False, on a batch the CPU draws
    g = torch.Generator().manual_seed(5)
    Bl, U, T = 2, TTS_FIT["seq"], fp["cpu"].max_mel_len
    batch = (torch.randint(1, fp["cpu"].n_symbols, (Bl, U), generator=g),
             torch.randint(3, 10, (Bl, U), generator=g), torch.randn(Bl, 80, T, generator=g),
             torch.randn(Bl, U, generator=g))
    # A ReLU gate flips where a pre-activation lies within rounding of 0 (the
    # card's cuDNN and the CPU sum a conv in other orders): one flip moves
    # ff1's weight gradient by ~1e-3 of its max. So the loss is compared
    # from each device's own pass, the gradients from a CPU pass that takes
    # the card's pre-activations (straight through) into every ReLU.
    gated = [name for name, _ in fp["cpu"].named_modules()
             if name.endswith(".ff1") or ".conv" in name and "predictor" in name]
    card_pre, losses, grads = {}, {}, {}

    def record(name):
        return lambda mod, inputs, out: card_pre.__setitem__(name, out.detach().cpu())

    def take(name):
        return lambda mod, inputs, out: out + (card_pre[name] - out).detach()

    for d, m, hook in ((CARD, fp[CARD], record), ("cpu", fp["cpu"], None),
                       ("cpu gated", fp["cpu"], take)):
        dev = CARD if d == CARD else "cpu"
        mods = dict(m.named_modules())
        handles = [mods[n].register_forward_hook(hook(n)) for n in gated] if hook else []
        tok, du, target, pitch = (x.to(dev) for x in batch)
        leaves = model_variables(m)
        out = m(tok, torch.full((Bl,), U, device=dev), durations=du, pitch=pitch)
        loss = m.loss(out, target, du.sum(1), du, pitch, torch.ones(Bl, U, device=dev))
        losses[d] = loss.detach().cpu()
        if d != "cpu":
            grads[d] = dict(zip(leaves, (x.cpu() for x in torch.autograd.grad(
                loss, list(leaves.values())))))
        for h in handles:
            h.remove()
    grads["cpu"] = grads.pop("cpu gated")
    rel = float((losses[CARD] - losses["cpu"]).abs() / losses["cpu"].abs())
    if rel > TTS_LOSS_TOL:
        raise AssertionError(f"fastpitch loss {float(losses[CARD])} vs {float(losses['cpu'])}")
    top = max(float(x.abs().max()) for x in grads["cpu"].values())
    worst, worst_key = 0.0, ""
    for key, ref in grads["cpu"].items():
        got = grads[CARD][key]
        if key.endswith(".k.bias"):
            # 0 in exact arithmetic (a row's softmax ignores the shift q · b_k): both hold
            # rounding noise only
            if max(float(got.abs().max()), float(ref.abs().max())) > 1e-5 * top:
                raise AssertionError(f"{key}: gradient {float(got.abs().max()):.3e} is not noise")
            continue
        share = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        if share > worst:
            worst, worst_key = share, key
    if worst > TTS_GRAD_TOL:
        raise AssertionError(f"gradient of {worst_key}: {worst:.3e} of its max")
    log(f"TTS fp32, cuda vs cpu, B=2 ({int(lens[0])} and {int(lens[1])} symbols; FastPitch "
        f"d 384, 6 + 6 layers, max_mel_len {T}, seed 0): encode max_abs_err "
        + ", ".join(f"{e:.3e}" for e in errs[:3]) + f" (tolerance {TTS_TOL:g} of each max); "
        f"durations equal on {int((~off).sum())}/{off.numel()} symbols "
        f"({int(off.sum())} half-ties); {n} frames, decode max_abs_err {errs[3]:.3e}; HiFi-GAN "
        f"V1 waveform [{', '.join(map(str, wave['cpu'].shape))}] max_abs_err {werr:.3e} "
        f"(tolerance {WAVE_TOL:g}); loss {float(losses['cpu']):.6f} within {rel:.2e} relative "
        f"(tolerance {TTS_LOSS_TOL:g}), worst gradient {worst_key} at {worst:.3e} of its max "
        f"(tolerance {TTS_GRAD_TOL:g}) over {len(grads['cpu'])} leaves, the CPU taking the "
        f"card's {len(gated)} ReLU inputs")


def _conv_flops(voc, mel: torch.Tensor) -> float:
    """Operations of one vocoder call on `mel`, from its convolutions' shapes
    (forward hooks): 2 · B · output length · weight size a Conv1d, 2 · B ·
    input length · weight size a ConvTranspose1d."""
    total = [0.0]

    def hook(mod, inputs, out):
        frames = inputs[0].shape[-1] if isinstance(mod, torch.nn.ConvTranspose1d) else out.shape[-1]
        total[0] += 2.0 * out.shape[0] * frames * mod.weight.numel()

    handles = [m.register_forward_hook(hook) for m in voc.modules()
               if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))]
    try:
        voc.convert_spectrogram_to_audio(mel)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def phase_tts_bench(profile: bool):
    """26. bench.py:bench_tts on the port: FastPitch at bench_tts's config from
    seed 0, fit_synthetic(40 steps, B=4, seq 48), B=8 copies of the bench's
    sentence, the paces 1.0, 1.01 and 1.02 warmed, 10 timed calls at the
    paces in turn: fastpitch_mel_frames_per_sec; then HiFi-GAN V1 (seed 0)
    on the last call's mels. Returns (FastPitch, HiFi-GAN)."""
    from nemo_tpu_torch.models.tts import FastPitchModel, HifiGanModel

    m = FastPitchModel(TTS_CFG, device=CARD, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = m.fit_synthetic(**TTS_FIT)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0) / TTS_FIT["steps"]
    tokens = m.parse(TTS_TEXT).repeat(TTS_B, 1)
    for pace in (1.0, 1.01, 1.02):
        if m.generate_spectrogram(tokens, pace=pace).shape[2] == 0:
            raise AssertionError("FastPitch synthesis produced 0 mel frames")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = 0
    for i in range(TTS_ITERS):
        mel = m.generate_spectrogram(tokens, pace=1.0 + 0.01 * (i % 3))
        frames += mel.shape[0] * mel.shape[2]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if frames == 0:
        raise AssertionError("FastPitch synthesis produced 0 mel frames")
    fps = frames / wall
    log(f"bench_tts on the port (FastPitch d 384, 6 + 6 layers, fp32, B={TTS_B} x "
        f"{tokens.shape[1]} symbols): fastpitch_mel_frames_per_sec={fps:.1f} "
        f"({fps / FRAMES_PER_SEC:.1f}x realtime at {FRAMES_PER_SEC} frames/s), "
        f"{1e3 * wall / TTS_ITERS:.2f} ms a call, {mel.shape[2]} frames "
        f"({mel.shape[2] / tokens.shape[1]:.2f} a symbol) at pace "
        f"{1.0 + 0.01 * ((TTS_ITERS - 1) % 3):g}, peak_mem={peak:.2f} GiB; "
        f"fit_synthetic {fit_ms:.2f} ms/step, final loss {loss:.4f}")
    voc = HifiGanModel(device=CARD, seed=0)
    flops = _conv_flops(voc, mel)  # also the warm call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TTS_VOC_ITERS):
        audio = voc.convert_spectrogram_to_audio(mel)
    torch.cuda.synchronize()
    call = (time.perf_counter() - t0) / TTS_VOC_ITERS
    if audio.shape != (TTS_B, mel.shape[2] * voc.hop_length) or not torch.isfinite(audio).all():
        raise AssertionError(f"vocoder output {tuple(audio.shape)} or non-finite values")
    secs = audio.numel() / voc.sample_rate
    rate = flops / call
    log(f"HiFi-GAN V1 (fp32, TF32 off) on those mels [{TTS_B}, 80, {mel.shape[2]}]: "
        f"{secs / call:.1f} audio s per wall s, {1e3 * call:.2f} ms a call, "
        f"{flops / 1e12:.3f} TFLOP a call ({flops / mel.shape[0] / mel.shape[2] / 1e9:.3f} GFLOP "
        f"a frame) at {rate / 1e12:.1f} TFLOP/s ({100 * rate / PEAK_FLOPS[torch.float32]:.1f} % "
        f"of the fp32 peak), peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:  # one more text → waveform call: device time by kind, the card's idle share
        profile_by_kind(lambda: voc.convert_spectrogram_to_audio(m.generate_spectrogram(tokens)),
                        TTS_KERNEL_KINDS, f"text → waveform call (B={TTS_B})")
    return m, voc


def _wav_fields(data: bytes):
    import io
    import wave

    with wave.open(io.BytesIO(data)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)
        return (w.getnchannels(), w.getsampwidth(), w.getframerate()), pcm


def held_out_clip(asr) -> np.ndarray:
    """A held-out 30 s tone clip at 16 kHz (float32, int16 steps)."""
    from nemo_tpu_torch.models.asr.synthetic import make_eval_batch

    _, pcm = make_eval_batch(asr, 1, SECS, UTT_TOKENS, seed=2024)
    return pcm[0].astype(np.float32) / 32768.0


@contextlib.contextmanager
def recording_k1_k2(calls: list):
    """While open, the CTC model's K1 and K2 call sites append (name, inputs,
    output) of each call to `calls`: the tensors themselves, which nothing
    writes after the call. The kernels launch and count as before."""
    import nemo_tpu_torch.models.asr.modules.conformer as conformer
    import nemo_tpu_torch.ops.attention as attention

    sites = ((attention, "relpos_flash_attention", "K1"),
             (conformer, "fused_subsampling_x4", "K2"))
    kept = [getattr(mod, attr) for mod, attr, _ in sites]

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            calls.append((name, args, out))
            return out
        return call

    for (mod, attr, name), fn in zip(sites, kept):
        setattr(mod, attr, recording(name, fn))
    try:
        yield calls
    finally:
        for (mod, attr, _), fn in zip(sites, kept):
            setattr(mod, attr, fn)


@torch.inference_mode()  # the recorded tensors are the model's inference tensors
def hold_recorded(what: str, calls: list) -> str:
    """Each recorded K1 and K2 output held against the plain version on the
    same inputs, at phases 9's and 10's tolerances for the inputs' type (K1
    on the valid query rows, its lse too). Raises outside them; returns a
    summary for the phase's log line."""
    from nemo_tpu_torch.ops.flash_attention import relpos_flash_attention_plain
    from nemo_tpu_torch.ops.subsampling_kernel import fused_subsampling_x4_plain

    def err(name, out, ref, atol, rtol):
        out, ref = out.float(), ref.float()
        e = (out - ref).abs()
        bad = int((e > atol + rtol * ref.abs()).sum())
        if bad or not torch.isfinite(out).all():
            raise AssertionError(f"{what}: {name} against its plain version: {bad} elements "
                                 f"outside atol {atol:g} + rtol {rtol:g}, or non-finite")
        return float(e.max())

    worst, shapes = {}, {}
    for name, args, out in calls:
        tol = KERNEL_TOL[args[0].dtype]
        if name == "K1":
            (o, lse), (o_ref, lse_ref) = out, relpos_flash_attention_plain(*args)
            Bn, H, T, _ = o.shape
            lens = args[5]
            valid = (torch.arange(T, device=lens.device)[None, :] < lens[:, None])[:, None, :]
            valid = valid.expand(Bn, H, T)
            errs = (err(name, o[valid], o_ref[valid], *tol),
                    err(name + " lse", lse[valid], lse_ref[valid], *LSE_TOL))
            shape = f"B={Bn}, T={T}, lengths {lens.tolist()}"
        else:
            errs = (err(name, out, fused_subsampling_x4_plain(*args), *tol),)
            shape = f"x {list(args[0].shape)}"
        worst[name] = tuple(max(a, b) for a, b in zip(worst.get(name, errs), errs))
        shapes.setdefault(name, set()).add(f"{shape}, {str(args[0].dtype)[6:]}")
    count = {name: sum(c[0] == name for c in calls) for name in worst}
    if set(count) != {"K1", "K2"}:
        raise AssertionError(f"{what}: recorded calls {count}")
    torch.cuda.synchronize()
    return (f"its {count['K1']} K1 and {count['K2']} K2 outputs against their plain versions "
            f"on the same inputs (K1 at {'; '.join(sorted(shapes['K1']))}: max_abs_err "
            f"{worst['K1'][0]:.3e}, lse {worst['K1'][1]:.3e}; K2 at "
            f"{'; '.join(sorted(shapes['K2']))}: {worst['K2'][0]:.3e}), within phases 9's and "
            f"10's tolerances")


def phase_audio_server(asr, fp, voc, k1, k2) -> dict:
    """27. `AudioServer(asr, tts=(FastPitch, HiFi-GAN))` on an ephemeral port:
    /v1/audio/speech for the bench's sentence (a mono 16-bit 22,050 Hz WAV of
    256 x frames samples, equal within 1 LSB to `synthesize` called
    directly); /v1/audio/transcriptions of a held-out 30 s tone clip raw at
    16 kHz, multipart at 16 kHz and at 22,050 Hz (the resample path), each
    text `transcribe`'s of the same samples, K1 18 and K2 1 launches a call;
    after the server stops, each of those K1 and K2 outputs held against its
    plain version on the inputs the request gave it. Returns the phase's K1,
    K2 launches."""
    from nemo_tpu_torch.data.audio_io import resample_linear
    from nemo_tpu_torch.serve.audio_server import AudioServer, _parse_wav, _wav_bytes

    srv = AudioServer(asr=asr, tts=(fp, voc))
    srv.serve(port=0, blocking=False)
    try:
        status, data, speech_s = _post(srv.port, "/v1/audio/speech",
                                       json.dumps({"input": TTS_TEXT}).encode(), "application/json")
        frames = fp.generate_spectrogram(fp.parse(TTS_TEXT)).shape[2]
        fields, pcm = _wav_fields(data)
        _, direct = _wav_fields(srv.synthesize(TTS_TEXT))
        lsb = int(np.abs(pcm - direct).max()) if len(pcm) == len(direct) else -1
        if (status != 200 or fields != (1, 2, 22050) or len(pcm) != voc.hop_length * frames
                or not 0 <= lsb <= 1):
            raise AssertionError(f"/v1/audio/speech: {status}, {fields}, {len(pcm)} samples for "
                                 f"{frames} frames, {lsb} LSB from synthesize")
        clip = held_out_clip(asr)
        wav16 = _wav_bytes(clip, SR)
        wav22 = _wav_bytes(resample_linear(clip, SR, 22050), 22050)
        boundary = "nemoTPUboundary"
        multipart = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                     f"filename=\"clip.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() + \
            wav16 + f"\r\n--{boundary}--\r\n".encode()
        bodies = {"raw 16 kHz": (wav16, "audio/wav"),
                  "multipart 16 kHz": (multipart, f"multipart/form-data; boundary={boundary}"),
                  "raw 22,050 Hz": (wav22, "audio/wav")}
        launches, walls, texts, calls = {"k1": 0, "k2": 0}, [], [], []
        for what, (body, ctype) in bodies.items():
            k1.launches = k2.launches = 0
            with recording_k1_k2(calls):
                status, data, wall = _post(srv.port, "/v1/audio/transcriptions", body, ctype)
            got = (k1.launches, k2.launches)
            launches["k1"] += got[0]
            launches["k2"] += got[1]
            x, sr = _parse_wav(wav16 if what != "raw 22,050 Hz" else wav22)
            if sr != SR:
                x = resample_linear(x, sr, SR)
            want = asr.transcribe([x])[0]
            text = json.loads(data)["text"] if status == 200 else None
            if text != want or got != (18, 1):
                raise AssertionError(f"/v1/audio/transcriptions ({what}): {status}, launches "
                                     f"{got}, text {text!r} vs transcribe's {want!r}")
            walls.append(f"{what} {wall:.3f} s")
            texts.append(len(text))
    finally:
        srv.shutdown()
    held = hold_recorded("AudioServer", calls)
    log(f"AudioServer (Conformer-Large CTC bf16 from phase 7, FastPitch from phase 26 + "
        f"HiFi-GAN V1): /v1/audio/speech {speech_s:.3f} s, a 22,050 Hz mono 16-bit WAV of "
        f"{len(pcm)} samples = {voc.hop_length} x {frames} frames, within {lsb} LSB of "
        f"synthesize; /v1/audio/transcriptions of a held-out {SECS:g} s tone clip: "
        + ", ".join(walls) + f", each text ({texts[0]} chars) equal to transcribe's, K1 18 and "
        f"K2 1 launches a call; {held}")
    return launches


def phase_voice_agent(asr, fp, voc, k1, k2) -> dict:
    """28. `VoiceAgent(ModelASRService(phase 7's model), CallableLLMService(greedy
    generation of 16 tokens on Llama-3.2-1B, phase 24's seed-0 weights, the
    byte tokenizer, each id spelt as a letter or a space),
    NativeTTSService(FastPitch, HiFi-GAN))`: one `converse` turn on the
    held-out clip, then one `push_audio` turn (the clip, then 0.6 s of
    silence). The user text equals `transcribe`'s of the same audio through
    a WAV file, the history grows by 2 a turn, the reply has letters and its
    audio is 256 x the mel frames of its symbols; each turn's K1 and K2
    outputs are held against their plain versions on the turn's inputs. Then
    a reply with no symbol of the TTS tokenizer ("€"): the vocoder refuses
    the 0-frame mel (ValueError). Returns the phase's K1, K2 launches."""
    from nemo_tpu_torch.agents import (CallableLLMService, ModelASRService, NativeTTSService,
                                       VoiceAgent)
    from nemo_tpu_torch.data.audio_io import write_wav
    from nemo_tpu_torch.models.llm.config import llama32_1b
    from nemo_tpu_torch.models.llm.generate import GenerationEngine, SamplingParams

    cfg = llama32_1b(seq_length=SERVER_MAX_LEN, attention_backend="flash")
    t0 = time.perf_counter()
    engine = GenerationEngine(cfg, _seed_params(cfg, CARD), device=CARD)
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    tok = AgentTokenizer()
    sampling = SamplingParams(max_new_tokens=AGENT_TOKENS)
    seconds = {"asr": 0.0, "llm": 0.0, "tts": 0.0}

    def timed(what, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds[what] += time.perf_counter() - t
            return out
        return call

    asr_service, tts_service = ModelASRService(asr), NativeTTSService(fp, voc)
    asr_service.transcribe = timed("asr", asr_service.transcribe)
    tts_service.synthesize = timed("tts", tts_service.synthesize)
    llm = CallableLLMService(timed("llm", lambda prompt: tok.ids_to_text(
        engine.generate_tokens([tok.text_to_ids(prompt)], sampling)[0])))
    agent = VoiceAgent(asr_service, llm, tts_service)
    clip = held_out_clip(asr)
    silence = np.zeros(int(0.6 * SR), np.float32)
    launches, lines, calls = {"k1": 0, "k2": 0}, [], []
    for turn, audio in enumerate((clip, np.concatenate([clip, silence]))):
        for key in seconds:
            seconds[key] = 0.0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "turn.wav")
            write_wav(path, audio, SR)
            want = asr.transcribe([path])[0]
        k1.launches = k2.launches = 0
        history = len(agent.history)
        with recording_k1_k2(calls):
            if turn == 0:
                out = agent.converse(clip)
            else:
                if agent.push_audio(clip) is not None:
                    raise AssertionError("push_audio ended a turn before any silence")
                out = agent.push_audio(silence)
                if out is None:
                    raise AssertionError("push_audio did not end the turn after 0.6 s of silence")
        user, reply, reply_audio = out
        if user != want or len(agent.history) != history + 2:
            raise AssertionError(f"turn {turn}: user text {user!r} vs transcribe's {want!r}, "
                                 f"history {history} -> {len(agent.history)}")
        if (k1.launches, k2.launches) != (18, 1):
            raise AssertionError(f"turn {turn}: launches K1 {k1.launches}, K2 {k2.launches}")
        launches["k1"] += k1.launches
        launches["k2"] += k2.launches
        symbols = fp.parse(reply).shape[1]
        frames = fp.generate_spectrogram(fp.parse(reply)).shape[2] if symbols else 0
        if (not any(c.isalpha() for c in reply) or len(reply_audio) != voc.hop_length * frames
                or not np.isfinite(reply_audio).all()):
            raise AssertionError(f"turn {turn}: reply {reply!r} ({symbols} symbols), "
                                 f"{len(reply_audio)} samples for {frames} frames")
        torch.cuda.synchronize()
        t = time.perf_counter()
        NativeTTSService(fp, voc).synthesize(reply)  # again, at shapes already seen
        warm_s = time.perf_counter() - t
        lines.append(f"turn {turn} ({'converse' if turn == 0 else 'push_audio'}): user text "
                     f"({len(user)} chars) equal to transcribe's, reply {reply!r} ({symbols} "
                     f"symbols) spoken as {len(reply_audio)} samples = {voc.hop_length} x "
                     f"{frames} frames; ASR {seconds['asr']:.3f} s, LLM {seconds['llm']:.3f} s, "
                     f"TTS {seconds['tts']:.3f} s ({warm_s:.3f} s again on the same reply)")
    held = hold_recorded("VoiceAgent", calls)
    try:
        NativeTTSService(fp, voc).synthesize("€")
        raise AssertionError("a reply with no symbol was spoken: the 0-frame mel was not refused")
    except ValueError as e:
        refused = str(e)
    log(f"VoiceAgent (Conformer-Large CTC bf16 → Llama-3.2-1B greedy, {AGENT_TOKENS} tokens, "
        f"built in {build_s:.1f} s → FastPitch + HiFi-GAN V1): " + "; ".join(lines)
        + f"; history {len(agent.history)} entries; {held}; a reply of no symbol (\"€\"): the "
        f"vocoder refused the 0-frame mel ({refused})")
    del engine
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# The MFU bench's training lines: GPT-551M in bf16 and fp8, Llama-3.2-1B
# under clip + Adafactor (scripts/train_mfu.py; bench.py:bench_llm, bench_llm_1b)
# --------------------------------------------------------------------------

QUANT_MODES = ("fp8", "fp8_e4m3", "int8")
QUANT_SHAPES = (("q_proj", 1536, 1536), ("o_proj", 1536, 1536), ("fc1", 1536, 12288),
                ("fc2", 6144, 1536))  # GPT-551M's products (name, K, N) at M = B x S
# a card product against its plain version (the exact fp32 sum of the same fp8 or int8
# operands): each row within QUANT_ROW_TOL of its max-abs, the whole within QUANT_NORM_TOL
# of its norm. Hopper's fp8 tensor cores keep fewer bits than fp32 between promotions to
# fp32 (fast accumulation off): 1.28e-4 of the norm, 3.5e-4 of a row's max (a first run
# on an H100 80GB HBM3 at 700 W); a bf16 output is also one step (up to 2^-7 of a value)
# off wherever that error crosses a rounding boundary.
QUANT_ROW_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -7 + 1e-3}
QUANT_NORM_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-3}
# phase 30: a gradient's max abs error, card against CPU with the card's quantised operands
# replayed, over its leaf's max-abs. Over 8 seeds on an H100 80GB HBM3 at 700 W the worst
# leaf (always the last layer's v_proj: its gradient passes o_proj's fp8 dgrad, attention
# and its own fp8 wgrad, each ~3e-4 of a row's max off, phase 29) was 6.6e-4 to 1.15e-3 of
# its max; a wrong scale, operand or tile moves a gradient by a large share of its max.
QUANT_GRAD_TOL = 2.5e-3
MFU_CHUNK = 10  # phases 31-32 read the loss every 10 steps and at the last
MFU_STEPS = LLM_STEPS + 1  # train_mfu.run's steps: its one warm-up, then 20 timed
# `_scaled_mm`'s cuBLAS kernels (nvjet_<a type><b type>..., q: e4m3, r: e5m2), then the
# kernels typed fp8: the casts into fp8 and the copies (transposes) of fp8 tensors
QUANT_KERNEL_KINDS = (("fp8 GEMMs (_scaled_mm)", ("nvjet_qq", "nvjet_qr", "nvjet_rq", "f8f8")),
                      ("fp8 casts and transposes", ("Float8", "float8", "e4m3", "e5m2")))


def _cast_equal(x: torch.Tensor, dtype: torch.dtype) -> int:
    """`quantize` of x on the card against the CPU's on the same values:
    codes and scale bitwise equal; returns the element count."""
    from nemo_tpu_torch.ops.quant import quantize

    q, s = quantize(x, dtype)
    q_ref, s_ref = quantize(x.cpu(), dtype)
    bits = (lambda t: t.view(torch.uint8)) if dtype != torch.int8 else (lambda t: t)
    if float(s) != float(s_ref) or not torch.equal(bits(q.cpu()), bits(q_ref)):
        raise AssertionError(f"quantize to {dtype}: the card's codes or scale differ from the "
                             f"CPU's ({int((bits(q.cpu()) != bits(q_ref)).sum())} codes)")
    return x.numel()


def phase_quant_products(gen: torch.Generator) -> dict:
    """29. `ops/quant.py`'s products on the card against their plain versions
    at GPT-551M's shapes (M = 8 x 2048; q_proj, o_proj, fc1, fc2), in the
    three training modes: the casts of x (bf16), w (the fp32 weight, as a
    Linear's transposed view) and the gradient g (bf16) bitwise the CPU's;
    `quant_matmul`'s forward, dgrad and wgrad against the plain products
    of the same quantised operands (int8's forward bitwise, the rest each
    row within `QUANT_ROW_TOL` of its max-abs and within `QUANT_NORM_TOL`
    of the norm); printed with no limit, `_scaled_mm`'s error with fast
    accumulation off and on, and with its scales in the epilogue against
    the scales multiplied after it; each product's time (wgrad's and int8's
    also of the bare GEMM) beside bf16 torch.matmul on the same shape.
    Returns {shape: {key: ms}}."""
    from nemo_tpu_torch.ops import quant

    M, bad, times, cast_elems = LLM_B * LLM_S, [], {}, 0
    one = torch.ones((), device="cuda")

    def hold(what, out, ref, dtype):
        try:
            compare_rows(what, out, ref, QUANT_ROW_TOL[dtype], QUANT_NORM_TOL[dtype])
        except AssertionError as e:
            bad.append(str(e))

    def tflops(K, N, ms):
        return 2 * M * K * N / ms / 1e9

    for name, K, N in QUANT_SHAPES:
        x = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
        weight = (0.02 * torch.randn(N, K, generator=gen)).cuda()  # a Linear's [out, in], fp32
        g = torch.randn(M, N, generator=gen).to("cuda", torch.bfloat16)
        xb, wb = x, weight.t().to(torch.bfloat16)
        t = times.setdefault(name, {})
        t["bf16_fwd"] = cuda_ms(lambda: xb @ wb, iters=10)
        t["bf16_dgrad"] = cuda_ms(lambda: g @ wb.t(), iters=10)
        t["bf16_wgrad"] = cuda_ms(lambda: g.t() @ xb, iters=10)
        for mode in QUANT_MODES:
            fwd_q = torch.int8 if mode == "int8" else quant.E4M3
            bwd_q = quant.E4M3 if mode == "fp8_e4m3" else quant.E5M2
            if mode != "fp8_e4m3":  # x and w take the same casts in both fp8 modes
                cast_elems += _cast_equal(x, fwd_q) + _cast_equal(weight.t(), fwd_q)
            if mode != "int8":
                cast_elems += _cast_equal(g, bwd_q)
            xr, wr = x.detach().requires_grad_(), weight.detach().requires_grad_()
            y = quant.quant_matmul(xr, wr.t(), mode, torch.bfloat16)
            dx, dw = torch.autograd.grad(y, (xr, wr), g)
            qx, sx = quant.quantize(x, fwd_q)
            qw, sw = quant.quantize(weight.t(), fwd_q)
            what = f"{mode} {name} M={M} K={K} N={N}"
            if mode == "int8":
                acc = quant.int8_mm(qx, qw)
                if not torch.equal(acc, quant.int8_mm_plain(qx, qw)):
                    bad.append(f"{what}: _int_mm differs from the exact int8 product")
                y_ref = (quant.int8_mm_plain(qx, qw).float() * (sx * sw)).to(torch.bfloat16)
                if not torch.equal(y, y_ref):
                    bad.append(f"{what}: the int8 forward differs from its plain version")
                gb = g.to(torch.bfloat16)
                wdq = (qw.float() * sw).to(torch.bfloat16)
                xdq = (qx.float() * sx).to(torch.bfloat16)
                hold(f"{what} dgrad", dx, (gb.float() @ wdq.float().t()).to(torch.bfloat16),
                     torch.bfloat16)
                hold(f"{what} wgrad", dw, gb.float().t() @ xdq.float(), torch.float32)
                t["int8_fwd"] = cuda_ms(lambda: (quant.int8_mm(qx, qw).float() * (sx * sw)).to(
                    torch.bfloat16), iters=10)
                t["int8_gemm"] = cuda_ms(lambda: quant.int8_mm(qx, qw), iters=10)
                t["int8_dgrad"] = cuda_ms(lambda: quant.f32_mm(gb, wdq.t()), iters=10)
                t["int8_wgrad"] = cuda_ms(lambda: quant.f32_mm(gb.t(), xdq), iters=10)
                t["int8_quantize_x"] = cuda_ms(lambda: quant.quantize(x, torch.int8), iters=10)
            else:
                qg, sg = quant.quantize(g, bwd_q)
                hold(f"{what} forward", y, quant.fp8_mm_plain(qx, qw, sx, sw, torch.bfloat16),
                     torch.bfloat16)
                hold(f"{what} forward fp32", quant.fp8_mm(qx, qw, sx, sw, torch.float32),
                     quant.fp8_mm_plain(qx, qw, sx, sw, torch.float32), torch.float32)
                hold(f"{what} dgrad", dx,
                     quant.fp8_mm_plain(qg, qw.t(), sg, sw, torch.bfloat16), torch.bfloat16)
                hold(f"{what} wgrad", dw, quant.fp8_mm_plain(qg.t(), qx, sg, sx, torch.float32),
                     torch.float32)
                t[f"{mode}_fwd"] = cuda_ms(lambda: quant.fp8_mm(qx, qw, sx, sw, torch.bfloat16),
                                           iters=10)
                t[f"{mode}_dgrad"] = cuda_ms(lambda: quant.fp8_mm(qg, qw.t(), sg, sw,
                                                                  torch.bfloat16), iters=10)
                t[f"{mode}_wgrad"] = cuda_ms(lambda: quant.fp8_mm(qg.t(), qx, sg, sx,
                                                                  torch.float32), iters=10)
                t[f"{mode}_quantize_x"] = cuda_ms(lambda: quant.quantize(x, fwd_q), iters=10)
                if mode == "fp8":
                    # wgrad's product alone, its operands laid out beforehand
                    qgt, qxc = qg.t().contiguous(), qx.t().contiguous().t()
                    t["fp8_wgrad_gemm"] = cuda_ms(lambda: quant.fp8_mm(qgt, qxc, sg, sx,
                                                                       torch.float32), iters=10)
                    # fast accumulation, which the port leaves off, against the exact sum
                    exact = quant.fp8_mm_plain(qx, qw, sx, sw, torch.float32)
                    for fast in (False, True):
                        y32 = torch._scaled_mm(qx, qw, sx, sw, out_dtype=torch.float32,
                                               use_fast_accum=fast)
                        rel = float(torch.linalg.vector_norm(y32 - exact)
                                    / torch.linalg.vector_norm(exact))
                        worst = float(((y32 - exact).abs()
                                       / exact.abs().amax(-1, keepdim=True)).max())
                        log(f"{what}: _scaled_mm use_fast_accum={fast} against the exact fp32 "
                            f"sum: rel_norm_err={rel:.3e}, max {worst:.3e} of the row's max-abs")
                    del qgt, qxc, exact, y32
                    # the scales in the epilogue against JAX's multiply after
                    folded = quant.fp8_mm(qx, qw, sx, sw, torch.float32)
                    after = quant.fp8_mm(qx, qw, one, one, torch.float32) * (sx * sw)
                    rel = float(((folded - after).abs()
                                 / after.abs().amax(-1, keepdim=True)).max())
                    flips = int((folded.to(torch.bfloat16) != after.to(torch.bfloat16)).sum())
                    log(f"{what}: scales in _scaled_mm's epilogue vs multiplied after: "
                        f"max {rel:.3e} of the row's max-abs, {flips} of {folded.numel()} bf16 "
                        f"outputs differ")
                    del folded, after
                del qg
            del xr, wr, y, dx, dw, qx, qw
        log(f"products {name} (M={M}, K={K}, N={N}) ms (TFLOP/s): " + ", ".join(
            f"{k} {v:.4f}" + ("" if "quantize" in k else
                               f" ({tflops(K, N, v):.1f})") for k, v in t.items()))
        del x, weight, g, xb, wb
        torch.cuda.empty_cache()
    log(f"quantize: {cast_elems:,} elements cast on the card bitwise as on the CPU")
    if bad:
        raise AssertionError("quantised products: " + "; ".join(bad))
    return times


@contextlib.contextmanager
def _fp8_replay(record: list, counts: dict, scale_tol: float = 2e-3, tol: float = 1e-2):
    """While the block runs, record every `ops/quant.py:quantize` of the path
    (the card: `record` is filled with (q, scale) on the host), or replay
    them (the CPU: each call takes the recorded pair of the same dtype and
    size nearest its input). The CPU's own quantisation is checked first:
    its scale within `scale_tol` relative of the card's, and each value it
    stands for within `tol` of the tensor's amax plus a quarter of the
    card's value (one code step at most) of the card's. The two devices'
    inputs differ by the card's fp8 sums (phase 29: ~3e-4 of a row's max a
    product), so codes move: one step where that crosses a rounding
    boundary, several near zero, where the steps are small. `counts` gets
    the codes that differ, all codes, the largest difference (of amax) and
    the largest scale difference."""
    from nemo_tpu_torch.ops import quant

    own = quant.quantize
    replay = len(record) > 0
    unused = list(range(len(record))) if replay else []
    counts.update(flips=0, codes=0, worst=0.0, scale_rel=0.0)

    def recording(x, dtype):
        q, scale = own(x, dtype)
        record.append((q.cpu(), scale.cpu()))
        return q, scale

    def replaying(x, dtype):
        q, scale = own(x, dtype)
        cands = [i for i in unused if record[i][0].dtype == dtype
                 and record[i][0].numel() == x.numel()]
        i = min(cands, key=lambda j: float((record[j][0].float().reshape(x.shape) * record[j][1]
                                            - x.float()).norm()))
        unused.remove(i)
        theirs, their_scale = record[i][0].reshape(x.shape), record[i][1]
        rel = abs(float(scale) - float(their_scale)) / float(their_scale)
        counts["scale_rel"] = max(counts["scale_rel"], rel)
        if rel > scale_tol:
            raise AssertionError(f"fp8 replay: a scale differs by {rel:.2e} relative "
                                 f"(tolerance {scale_tol:g})")
        ours_v, theirs_v = q.float() * scale, theirs.float() * their_scale
        amax = float(theirs_v.abs().max())
        diff = (ours_v - theirs_v).abs()
        bad = int((diff > tol * amax + 0.25 * theirs_v.abs()).sum())
        if bad:
            raise AssertionError(f"fp8 replay: {bad} of {diff.numel()} values further from the "
                                 f"card's than {tol:g} of amax and one code step")
        counts["flips"] += int((q.view(torch.uint8) != theirs.view(torch.uint8)).sum())
        counts["codes"] += diff.numel()
        counts["worst"] = max(counts["worst"], float(diff.max()) / max(amax, 1e-30))
        return theirs, their_scale

    quant.quantize = replaying if replay else recording
    try:
        yield
    finally:
        quant.quantize = own
    if replay and unused:
        raise AssertionError(f"fp8 replay: {len(unused)} recorded quantisations left unused")



def phase_quant_grad_exactness(tol: float = QUANT_GRAD_TOL, loss_tol: float = 1e-5) -> None:
    """30. A 2-layer model at GPT-551M's width (hidden 1536, 12 heads x dh
    128, FFN 6144; the vocab cut to 8192 as in phase 10), fp32,
    quantization="fp8", flash, full remat, B=1 x S=256: the card (K5-K7,
    `_scaled_mm`) against the CPU (plain versions), for seeds 0, 1 and 2
    (parameters from the seed, tokens from RandomState(3 + seed)). Each
    side's own loss (no limit: fp8 tie flips); then the card's pass records
    every quantisation and the CPU's replays it (`_fp8_replay`): the loss
    within `loss_tol` relative (PERF.md §2's) and every gradient's max abs
    error within `tol` of its leaf's max-abs (`QUANT_GRAD_TOL`, not §2's
    1e-4: the card's fp8 products carry Hopper's accumulation error).
    Prints each seed's three worst leaves (error over max-abs)."""
    from nemo_tpu_torch.models.llm.train import GPTTrainModule
    from nemo_tpu_torch.scripts.train_mfu import make_cfg

    cfg = dataclasses.replace(make_cfg("fp8", seq_length=256), num_layers=2, vocab_size=8192,
                              compute_dtype="float32")
    worst_all, bad = 0.0, []
    for seed in range(3):
        rng = np.random.RandomState(3 + seed)
        tokens, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 256)))
                          for _ in range(2))
        cpu = GPTTrainModule(cfg, device="cpu", seed=seed)
        card = GPTTrainModule(cfg, device="cuda", seed=seed)
        card.model.load_state_dict(cpu.model.state_dict())
        with torch.no_grad():
            own = [float(m.loss(tokens.to(m.device), labels.to(m.device))) for m in (card, cpu)]
        record, counts, out = [], {}, {}
        for name, mod in (("cuda", card), ("cpu", cpu)):
            with _fp8_replay(record, counts):
                loss = mod.loss(tokens.to(mod.device), labels.to(mod.device))
                grads = torch.autograd.grad(loss, mod.params)
            out[name] = (float(loss.detach()), [g.cpu() for g in grads])
        (loss, grads), (ref_loss, ref_grads) = out["cuda"], out["cpu"]
        ratios = []  # (max abs error / the leaf's max-abs, leaf)
        for (pname, _), g, ref in zip(cpu.model.named_parameters(), grads, ref_grads):
            scale, err = float(ref.abs().max()), float((g - ref).abs().max())
            ratio = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
            ratios.append((ratio, pname))
            if not torch.isfinite(g).all() or ratio > tol:
                bad.append(f"seed {seed} {pname}")
        ratios.sort(reverse=True)
        worst_all = max(worst_all, ratios[0][0])
        rel = abs(loss - ref_loss) / abs(ref_loss)
        if rel > loss_tol:
            bad.append(f"seed {seed} loss rel {rel:.2e}")
        log(f"GPT fp8, 2 layers at GPT-551M width, vocab cut to {cfg.vocab_size}, fp32, "
            f"B=1 x S=256, seed {seed}, cuda (K5-K7, _scaled_mm, remat full) vs cpu (plain): "
            f"own losses {own[0]:.6f} vs {own[1]:.6f} (rel "
            f"{abs(own[0] - own[1]) / abs(own[1]):.2e}, no limit); the CPU replaying the card's "
            f"{len(record)} quantisations ({counts['flips']} of its {counts['codes']:,} own codes "
            f"differ, by at most {counts['worst']:.2e} of amax, its scales within "
            f"{counts['scale_rel']:.2e} relative): loss {loss:.6f} vs {ref_loss:.6f} (rel "
            f"{rel:.2e}, tolerance {loss_tol:g}); {len(ref_grads)} gradients, max_abs_err over "
            f"the leaf's max-abs at worst " + ", ".join(f"{n} {r:.3e}" for r, n in ratios[:3])
            + f" (tolerance {tol:g}; PERF.md §2's 1e-4)")
        del cpu, card, record, out, grads, ref_grads
        torch.cuda.empty_cache()
    log(f"fp8 gradients over 3 seeds: worst {worst_all:.3e} of the leaf's max-abs, "
        f"{worst_all / tol:.3f} of the tolerance {tol:g}")
    if bad:
        raise AssertionError(f"fp8 loss or gradients disagree: {bad}")


def _mfu_runs(counters: dict, model: str, quants) -> tuple:
    """`train_mfu.run` of `model` for each of `quants` at B=8 x 2048, its one
    warm-up and 20 timed steps, every count set to 0 before each run and read
    after: (results, launches, peak GiB) by quant."""
    from nemo_tpu_torch.ops import quant
    from nemo_tpu_torch.scripts import train_mfu

    results, launches, peaks = {}, {}, {}
    for q in quants:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts = dict(counters, fp8_mm=quant.fp8_mm)
        for fn in counts.values():
            fn.launches = 0
        results[q] = train_mfu.run(None if q == "bf16" else q, MFU_STEPS, LLM_B, LLM_S,
                                   chunk=MFU_CHUNK, model=model)
        launches[q] = {name: fn.launches for name, fn in counts.items()}
        peaks[q] = torch.cuda.max_memory_allocated() / 2**30
    return results, launches, peaks


def _mfu_line(what: str, r: dict, launches: dict, peak: float) -> float:
    """Logs one run of `train_mfu.run`; returns its ms a step."""
    ms = 1e3 * LLM_B * LLM_S / r["tokens_per_sec"]
    fp8 = (f", MFU {100 * r['mfu_vs_fp8_peak']:.2f} % of the fp8 peak (1,979 TFLOP/s)"
           if "mfu_vs_fp8_peak" in r else "")
    log(f"main path, {what} ({r['quant']}): {r['tokens_per_sec']} tokens/s, {ms:.2f} ms/step, "
        f"{r['tflops_per_sec']} TFLOP/s, MFU {100 * r['mfu_vs_bf16_peak']:.2f} % of 989 TFLOP/s"
        f"{fp8}, peak_mem={peak:.2f} GiB, losses {r['losses']}, device {r['device']}, "
        f"launches {launches}")
    losses = [v for _, v in r["losses"]]
    if not losses or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: non-finite or missing losses {r['losses']}")
    return ms


def _want_launches(cfg, steps: int, fp8: bool) -> dict:
    """K5 twice a layer a step (remat), K6 and K7 once, none of K1-K4 or
    K8-K13; with fp8, `_scaled_mm` 24 times a layer a step (6 products:
    2 forwards with remat, dgrad and wgrad)."""
    L = cfg.num_layers
    want = {f"k{i}": 0 for i in (1, 2, 3, 4, 8, 9, 10, 11, 12, 13)}
    want.update(k5=2 * L * steps, k6=L * steps, k7=L * steps,
                fp8_mm=24 * L * steps if fp8 else 0)
    return want


def phase_bench_llm(counters: dict, profile: bool) -> dict:
    """31. bench.py:bench_llm on the port: `train_mfu.run` on GPT-551M at full
    width and depth, B=8 x S=2048, bf16 then fp8, one warm-up and 20 timed
    steps from seed 0: tokens/s, ms/step, MFU (fp8 also against the fp8
    peak), peak memory, the fp8-vs-bf16 loss at their last common read
    (within 5 % relative); K5 32, K6 16 and K7 16 launches a step, none of
    K1-K4 or K8-K13, `_scaled_mm` 384 a step in fp8 and none in bf16.
    Returns the launches of both runs, summed."""
    from nemo_tpu_torch.llm.auto_configurator import _param_count
    from nemo_tpu_torch.scripts import train_mfu

    cfg = train_mfu.make_cfg()
    results, launches, peaks = _mfu_runs(counters, "551m", ("bf16", "fp8"))
    for q in ("bf16", "fp8"):
        _mfu_line(f"bench_llm, GPT-551M ({_param_count(cfg):,.0f} parameters), B={LLM_B} x "
                  f"S={LLM_S}, {LLM_STEPS} timed steps after 1", results[q],
                  launches[q], peaks[q])
        want = _want_launches(cfg, MFU_STEPS, q == "fp8")
        if launches[q] != want:
            raise AssertionError(f"GPT-551M {q} launch counts {launches[q]}, expected {want}")
    line = train_mfu.overlay(results)
    log("fp8 vs bf16: " + json.dumps(line))
    if line is None or not line["rel_diff"] < 0.05:
        raise AssertionError(f"fp8 vs bf16 loss overlay {line}")
    if profile:
        for q in ("bf16", "fp8"):
            mod = train_mfu.build(None if q == "bf16" else q, "551m", LLM_S, 0)
            batches = train_mfu.make_batches(mod.cfg, LLM_B, LLM_S, 0, mod.device)[:3]
            mod.train_step(batches[0])
            profile_by_kind(lambda: mod.train_step(batches[1]),
                            QUANT_KERNEL_KINDS + LLM_KERNEL_KINDS,
                            f"GPT-551M {q} step (B={LLM_B} x S={LLM_S})")
            del mod, batches
            torch.cuda.empty_cache()
    return {k: launches["bf16"][k] + launches["fp8"][k] for k in launches["bf16"]}


def phase_adafactor_exactness(tol: float = 1e-2, v_tol: float = 1e-5,
                              norm_tol: float = 1e-6) -> None:
    """32, first: clip + Adafactor (`core/optim.py:ClippedAdafactor`) on the
    card against the CPU, on Llama-3.2-1B's widths cut to 2 layers and a
    vocab of 8192 (stacked leaves: q/k/v/o [2, 2048, heads, 64] keep a full
    second moment, the MLP's and the embedding are factored), the same
    parameters and seeded gradients on both sides, 3 steps (global norm 5,
    then 0.5 twice: the first clipped). After each step: the global norms
    within `norm_tol` relative; every leaf changed on the card, its change
    within `tol` of the CPU's largest change of the leaf (the parameter's
    fp32 rounding alone moves a change by up to ~1e-3 of it). After the
    last: every v_row, v_col and v within `v_tol` relative of the CPU's
    (the same sums in other orders)."""
    from nemo_tpu_torch.core.optim import clip_adafactor
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    cfg = _llm_cfg(num_layers=2, vocab_size=8192, seq_length=256)
    mods = {dev: GPTTrainModule(cfg, device=dev, seed=0) for dev in ("cpu", "cuda")}
    mods["cuda"].model.load_state_dict(mods["cpu"].model.state_dict())
    opts = {dev: clip_adafactor(3e-4)(m.model) for dev, m in mods.items()}
    names = [n for n, _ in mods["cpu"].model.named_parameters()]
    gen = torch.Generator().manual_seed(5)
    worst, norms, bad = 0.0, [], []
    for norm_to in (5.0, 0.5, 0.5):
        grads = [torch.randn(p.shape, generator=gen)
                 * torch.exp(torch.randn(p.shape[-1], generator=gen)) for p in opts["cpu"].masters]
        total = math.sqrt(sum(float(torch.linalg.vector_norm(g, dtype=torch.float64)) ** 2
                              for g in grads))
        grads = [g * (norm_to / total) for g in grads]
        before = {dev: [m.double() for m in o.masters] for dev, o in
                  (("cpu", opts["cpu"]), ("cuda", opts["cuda"]))}
        norm = {"cuda": float(opts["cuda"].step([g.cuda() for g in grads])),
                "cpu": float(opts["cpu"].step(grads))}
        norms.append(norm["cuda"])
        if abs(norm["cuda"] - norm["cpu"]) > norm_tol * norm["cpu"]:
            bad.append(f"global norm {norm['cuda']} vs {norm['cpu']}")
        for name, b_cpu, b_card, a_cpu, a_card in zip(
                names, before["cpu"], before["cuda"], opts["cpu"].masters, opts["cuda"].masters):
            d_cpu, d_card = a_cpu.double() - b_cpu, (a_card.double() - b_card).cpu()
            scale = float(d_cpu.abs().max())
            if scale == 0 or float(d_card.abs().max()) == 0:
                bad.append(f"{name} unchanged")
                continue
            err = float((d_card - d_cpu).abs().max()) / scale
            worst = max(worst, err)
            if err > tol:
                bad.append(f"{name} change off by {err:.2e} of its max")
        del before, grads
    worst_v = 0.0
    for k in range(len(opts["cpu"].groups)):
        for attr in ("v_row", "v_col", "v"):
            ref, got = getattr(opts["cpu"], attr)[k], getattr(opts["cuda"], attr)[k]
            if ref is not None:
                worst_v = max(worst_v, float(((got.cpu() - ref).abs() / ref.abs()).max()))
    if worst_v > v_tol:
        bad.append(f"second moments off by {worst_v:.2e} relative")
    n_fact = sum(d is not None for d in opts["cpu"].factored)
    log(f"clip + Adafactor, Llama-3.2-1B widths, 2 layers, vocab {cfg.vocab_size} "
        f"({len(names)} tensors, {len(opts['cpu'].groups)} JAX leaves, {n_fact} factored), 3 "
        f"steps, cuda vs cpu: global norms {', '.join(f'{x:.4f}' for x in norms)}; every leaf "
        f"changed; parameter changes within {worst:.3e} of each leaf's largest (tolerance "
        f"{tol:g}); v_row, v_col, v within {worst_v:.3e} relative (tolerance {v_tol:g})")
    if bad:
        raise AssertionError("Adafactor on the card disagrees with the CPU: " + "; ".join(bad))
    del mods, opts
    torch.cuda.empty_cache()


def phase_bench_llm_1b(counters: dict, adamw_ms: float, profile: bool) -> dict:
    """32. bench.py:bench_llm_1b on the port: `train_mfu.run` on Llama-3.2-1B
    (full width and depth, bf16, flash, full remat) under clip + Adafactor,
    B=8 x S=2048, one warm-up and 20 timed steps from seed 0: tokens/s,
    ms/step beside phase 12's AdamW step, MFU, peak memory; K5 32, K6 16
    and K7 16 launches a step, none of the others. With `profile`, one more
    step by kind, and the optimizer steps alone (Adafactor, then AdamW on
    the same parameters) by CUDA events."""
    from nemo_tpu_torch.core.optim import gpt_optimizer
    from nemo_tpu_torch.scripts import train_mfu

    cfg = train_mfu.make_cfg_1b()
    results, launches, peaks = _mfu_runs(counters, "llama32_1b", ("bf16",))
    ms = _mfu_line(f"bench_llm_1b, Llama-3.2-1B, clip + Adafactor, B={LLM_B} x S={LLM_S}, "
                   f"{LLM_STEPS} timed steps after 1", results["bf16"],
                   launches["bf16"], peaks["bf16"])
    log(f"Llama-3.2-1B a step: Adafactor {ms:.2f} ms, AdamW (phase 12) {adamw_ms:.2f} ms")
    want = _want_launches(cfg, MFU_STEPS, False)
    if launches["bf16"] != want:
        raise AssertionError(f"Llama-3.2-1B launch counts {launches['bf16']}, expected {want}")
    if profile:
        mod = train_mfu.build(None, "llama32_1b", LLM_S, 0)
        batches = train_mfu.make_batches(mod.cfg, LLM_B, LLM_S, 0, mod.device)[:3]
        mod.train_step(batches[0])
        profile_by_kind(lambda: mod.train_step(batches[1]), LLM_KERNEL_KINDS,
                        f"Llama-3.2-1B Adafactor step (B={LLM_B} x S={LLM_S})")
        grads = [torch.full_like(p, 1e-4) for p in mod.params]
        ada = cuda_ms(lambda: mod.optimizer.step(grads), iters=3)
        adamw = gpt_optimizer(mod.params)
        adam_ms = cuda_ms(lambda: adamw.step(grads), iters=3)
        log(f"optimizer step alone, Llama-3.2-1B ({len(mod.params)} tensors, "
            f"{len(mod.optimizer.groups)} JAX leaves): clip + Adafactor {ada:.2f} ms, clip + "
            f"AdamW {adam_ms:.2f} ms")
        del mod, batches, grads, adamw
        torch.cuda.empty_cache()
    return launches["bf16"]


# ------------------------------------------------------------ Phi-3-mini-4k (dh 96)
def _phi3_cfg(**kw):
    from nemo_tpu_torch.models.llm.config import phi3_mini_4k

    return phi3_mini_4k(**{"num_layers": PHI3_LAYERS, "compute_dtype": "bfloat16",
                           "attention_backend": "flash", "remat": "full", **kw})


def _time_dh96(what: str, fns: dict, plain: dict, library: dict) -> dict:
    """Each of `fns` (kernel → its launch) and `library` (name → one PyTorch
    call) by CUDA events and by torch.profiler (`<name>_device`), `plain`
    (name → call) by CUDA events; printed, and returned by name."""
    out = {}
    for name, fn in fns.items():
        out[name], out[f"{name}_device"] = cuda_ms(fn, iters=20), device_ms(fn, iters=20)
    for name, fn in plain.items():
        out[name] = cuda_ms(fn, iters=2)
    for name, fn in library.items():
        out[name], out[f"{name}_device"] = cuda_ms(fn, iters=10), device_ms(fn, iters=10)
    log(f"times dh 96, {what}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def phase_dh96(gen: torch.Generator, sft_seg: torch.Tensor) -> list:
    """K5-K13 at head dim 96 (Phi-3-mini: dh 128's tiles with a zero tail)
    against their plain versions, fp32 and bf16, each held row by row:
    K5-K7 at Phi-3's training shape (B=2, 32 heads over 32, S=4096) and at
    B=2, 32 heads over 8, S=2048 with a window of 512; K8-K10 at B=2, S=2048,
    32 over 32 on three segment layouts (`check_k8_k10_layouts`, "sft" from
    the SFT batch `sft_seg`); K11-K13 at one CP rank's diagonal ring step
    (Tl=2048, 32 over 8). Every dq, dk and dv is launched twice and must
    repeat bit for bit, and a head dim of 80 must raise ValueError. Then the
    bf16 times of K5-K7 at Phi-3's training shape and of K8-K10 on the whole
    SFT batch (B=8 x 2048, 32 over 32, phase 40's shape; held against their
    plain versions there first), each beside its bound, its plain version
    and SDPA. Returns the six kernel rows (launches filled by phases 39 and
    40)."""
    from nemo_tpu_torch.ops.flash_attention import (
        _k5_launch, _k8_launch, flash_attention, flash_attention_backward_plain,
        flash_attention_packed, flash_attention_packed_backward_plain,
        flash_attention_packed_plain, flash_attention_plain, flash_dkv, flash_dq, flash_pos_dkv,
        flash_pos_dq, flash_seg_dkv, flash_seg_dq, pos_delta, row_delta, seg_tile_ranges)

    rows = [{"name": f"{name} (Phi-3-mini, dh 96)", "route": "cuda",
             "source": f"nemo_tpu_torch/csrc/{src}.cu",
             "replaces": f"nemo_tpu/ops/flash_attention.py:{line}"}
            for name, src, line in (("flash_attention", "flash_fwd", "77 (causal GQA)"),
                                    ("flash_dq", "flash_bwd", "213 (causal GQA)"),
                                    ("flash_dkv", "flash_bwd", "257 (causal GQA)"),
                                    ("flash_attention_packed", "flash_fwd", 817),
                                    ("flash_seg_dq", "flash_bwd", 871),
                                    ("flash_seg_dkv", "flash_bwd", 914))]
    H, dh, bf16 = 32, 96, torch.bfloat16
    scale = 1.0 / math.sqrt(dh)
    errs = [0.0] * 6  # K5-K10: worst bf16 max abs error
    for (B_, G, T, window), dtype in ((c, d) for c in ((PHI3_B, H, PHI3_S, None),
                                                       (2, 8, LLM_S, 512))
                                      for d in (torch.float32, bf16)):
        q, k, v, do = _gqa_inputs(gen, B_, H, G, T, dh, dtype)
        what = f"dh 96 {str(dtype)[6:]} B={B_} H={H} G={G} S={T} window={window}"
        o, lse, out, err = check_k5_k7(what, q, k, v, do, scale, window)
        args = (q, k, v, scale, True, window, lse, row_delta(o, do), do)
        _repeatable(f"K6, K7 {what}", lambda: (flash_dq(*args), *flash_dkv(*args)), out)
        if dtype == bf16:
            errs[:3] = [max(a, b) for a, b in zip(errs[:3], err)]
        del q, k, v, do, o, lse, out, args
    errs[3:] = check_k8_k10_layouts(gen, H, H, dh, None, sft_seg, repeat=True)
    Tl = LLM_S
    qpos, kpos, window, _ = position_layouts(Tl)["diagonal"]
    for dtype in (torch.float32, bf16):
        q, k, v, do = _gqa_inputs(gen, 1, H, 8, Tl, dh, dtype)
        dlse = torch.randn(1, H, Tl, generator=gen).cuda()
        what = f"dh 96 {str(dtype)[6:]} B=1 H={H} G=8 Tl={Tl} positions=diagonal"
        o, lse, out, _, _ = check_k11_k13(what, q, k, v, do, dlse, qpos, kpos, window, 0)
        args = (q, k, v, qpos, kpos, scale, True, window, lse, pos_delta(o, do, dlse), do)
        _repeatable(f"K12, K13 {what}", lambda: (flash_pos_dq(*args), *flash_pos_dkv(*args)),
                    out)
        del q, k, v, do, o, lse, out, args
    q, k, v = (torch.zeros(1, 4, 128, 80, device="cuda", dtype=bf16) for _ in range(3))
    seg = torch.ones(1, 128, dtype=torch.int32, device="cuda")
    for name, call in (("flash_attention", lambda: flash_attention(q, k, v, 0.1)),
                       ("flash_attention_packed",
                        lambda: flash_attention_packed(q, k, v, seg, 0.1))):
        try:
            call()
        except ValueError as e:
            log(f"{name} at head dim 80 raises ValueError: {e}")
        else:
            raise AssertionError(f"{name} launched at head dim 80")

    # the bf16 times: K5-K7 at phase 39's shape, beside SDPA (causal)
    B_, S = PHI3_B, PHI3_S
    q, k, v, do = _gqa_inputs(gen, B_, H, H, S, dh, bf16)
    o, lse = _k5_launch(q, k, v, scale, True, None)
    o = o.transpose(1, 2)
    args = (q, k, v, scale, True, None, lse, row_delta(o, do), do)
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        ql, kl, vl, is_causal=True, scale=scale)
    o_lib = sdpa()
    t = _time_dh96(
        f"B={B_} H={H} G={H} S={S} causal",
        {"k5": lambda: flash_attention(q, k, v, scale), "k6": lambda: flash_dq(*args),
         "k7": lambda: flash_dkv(*args)},
        {"plain_forward": lambda: flash_attention_plain(q, k, v, scale, True, None),
         "plain_backward": lambda: flash_attention_backward_plain(q, k, v, scale, True, None, o,
                                                                  lse, do)},
        {"sdpa": sdpa, "sdpa_backward": lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do,
                                                                    retain_graph=True)})
    del o_lib, ql, kl, vl
    bounds = flash_bounds(B_, H, H, S, dh, B_ * H * S * (S + 1) / 2, bf16)
    for i, key in enumerate(("k5", "k6", "k7")):
        plain_ms, lib_ms = ((t["plain_forward"], t["sdpa"]) if i == 0
                            else (t["plain_backward"], t["sdpa_backward"]))
        rows[i].update(max_abs_err=errs[i], ms=t[key], plain_ms=plain_ms, bound_ms=bounds[i][0],
                       bound_by=bounds[i][1], library_ms=lib_ms)
    del q, k, v, do, o, lse, args
    # K8-K10 on the SFT run's first batch (B=8 x 2048), phase 40's shape: held
    # against their plain versions, then timed beside SDPA given the dense mask
    B_, S = LLM_B, LLM_S
    q, k, v, do = _gqa_inputs(gen, B_, H, H, S, dh, bf16)
    seg, ranges = sft_seg, seg_tile_ranges(sft_seg)
    o, lse, _, err = check_k8_k10(f"dh 96 bf16 B={B_} H={H} G={H} S={S} segments=sft (the whole "
                                  f"batch)", q, k, v, do, seg, scale, None)
    errs[3:] = [max(a, b) for a, b in zip(errs[3:], err)]
    args = (q, k, v, seg, scale, True, None, lse, row_delta(o, do), do)
    dense = dense_segment_mask(seg)
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        ql, kl, vl, attn_mask=dense, scale=scale)
    o_lib = sdpa()
    t = _time_dh96(
        f"B={B_} H={H} G={H} S={S} on the SFT batch",
        {"k8": lambda: _k8_launch(q, k, v, seg, ranges, scale, True, None),
         "k9": lambda: flash_seg_dq(*args, ranges=ranges),
         "k10": lambda: flash_seg_dkv(*args, ranges=ranges)},
        {"plain_forward": lambda: flash_attention_packed_plain(q, k, v, seg, scale),
         "plain_backward": lambda: flash_attention_packed_backward_plain(
             q, k, v, seg, scale, True, None, o, lse, do)},
        {"sdpa_mask": sdpa, "sdpa_mask_backward": lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), do, retain_graph=True)})
    del o_lib, ql, kl, vl, dense
    bounds = flash_bounds(B_, H, H, S, dh, H * segment_pairs(seg), bf16, 4 * B_ * S)
    for i, key in enumerate(("k8", "k9", "k10")):
        plain_ms, lib_ms = ((t["plain_forward"], t["sdpa_mask"]) if i == 0
                            else (t["plain_backward"], t["sdpa_mask_backward"]))
        rows[3 + i].update(max_abs_err=errs[3 + i], ms=t[key], plain_ms=plain_ms,
                           bound_ms=bounds[i][0], bound_by=bounds[i][1], library_ms=lib_ms)
    for row in rows:
        log(f"{row['name']}: kernel_ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}) plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} max_abs_err={row['max_abs_err']:.3e}")
    del q, k, v, do, o, lse, args
    torch.cuda.empty_cache()
    return rows


def phase_phi3_exactness() -> None:
    """Phi-3-mini in fp32 at full width (hidden 3072, 32 heads of dh 96, FFN
    8192, vocab 32,064, untied head) cut to 2 layers, B=1 x S=256: the card
    (K5-K7 at dh 96, fp32 kernels, under full remat) against the CPU (plain
    versions) from the same seed-0 weights."""
    cfg = _phi3_cfg(num_layers=2, seq_length=256, compute_dtype="float32")
    _card_vs_cpu(cfg, "Phi-3-mini fp32, 2 layers at full width, B=1 x S=256, cuda (K5-K7 at "
                      "dh 96, remat full) vs cpu (plain)", logits=True)


def cp_processes() -> int:
    """The process-group form under torchrun (one process a card, NCCL):
    Llama-3.2-1B at S = 16,384, cp = the number of processes, B=1, every rank
    given the whole batch; 2 warm-up and 20 timed steps. Rank 0 first takes
    the loss of the first batch with every rank in its own process
    (LocalRing) on the same weights, and prints both."""
    import torch.distributed as dist

    from nemo_tpu_torch.llm.auto_configurator import model_flops_per_token
    from nemo_tpu_torch.models.llm.train import GPTTrainModule
    from nemo_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl", init_method="env://", world_size=world, rank=rank)
    cfg = _llm_cfg(seq_length=CP_S, cp_size=world)
    rng = np.random.RandomState(0)
    batches = [{key: torch.from_numpy(rng.randint(0, cfg.vocab_size, (CP_B, CP_S))).cuda()
                for key in ("tokens", "labels")} for _ in range(LLM_WARMUP + LLM_STEPS)]
    local = None
    if rank == 0:
        with torch.no_grad():
            local = float(GPTTrainModule(cfg, device="cuda", seed=0).loss(
                batches[0]["tokens"], batches[0]["labels"]))
        torch.cuda.empty_cache()
    mod = GPTTrainModule(cfg, device="cuda", seed=0, mesh=make_mesh(MeshConfig(cp=world)))
    metrics = [mod.train_step(b) for b in batches[:LLM_WARMUP]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    metrics += [mod.train_step(b) for b in batches[LLM_WARMUP:]]
    torch.cuda.synchronize()
    dist.barrier()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    tok_s = LLM_STEPS * CP_B * CP_S / wall
    mfu = model_flops_per_token(cfg) * tok_s / (world * PEAK_FLOPS[torch.bfloat16])
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        log(smi)
        log(f"CP over processes: Llama-3.2-1B bf16, flash, remat full, AdamW, cp {world} "
            f"(ProcessGroupRing, NCCL, {world} cards), B={CP_B} x S={CP_S}, {LLM_STEPS} timed "
            f"steps after {LLM_WARMUP}: {1e3 * wall / LLM_STEPS:.2f} ms/step, {tok_s:.1f} "
            f"tokens/s, MFU {100 * mfu:.2f} % of {world} x 989 TFLOP/s, peak_mem={peak:.2f} GiB "
            f"on rank 0, loss {losses[0]:.6f} (step 0; {local:.6f} with every rank in one "
            f"process, rel {abs(losses[0] - local) / abs(local):.2e}) → {losses[-1]:.4f}")
        if abs(losses[0] - local) > 1e-4 * abs(local) or not all(map(math.isfinite, losses)):
            raise AssertionError(f"CP over processes: losses {losses}, one process {local}")
    dist.destroy_process_group()
    return 0


def _timing_start():
    """(the JSON line's head: tree and card, the timer) of --time-forward and
    --time-backward: timed(key, fn) puts fn's mean time over 50 launches
    after 3 warm-up ones under `key`_ms (CUDA events, `cuda_ms`), its
    device time under `key`_device_ms (torch.profiler, `device_ms`) and its
    host time a call under `key`_host_ms (`host_ms`)"""
    import nemo_tpu_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"tree": os.path.dirname(os.path.dirname(nemo_tpu_torch.__file__)), "card": smi}

    def timed(key: str, fn) -> None:
        out[f"{key}_ms"] = cuda_ms(fn, iters=50, warmup=3)
        out[f"{key}_device_ms"] = device_ms(fn, iters=50, warmup=3)
        out[f"{key}_host_ms"] = host_ms(fn, iters=50, warmup=3)

    return out, timed


def _sft_first_segments() -> torch.Tensor:
    """the segment ids [8, 2048] of the SFT run's first batch, on the card"""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sft.jsonl")
        write_sft_jsonl(path)
        return sft_data(path)[1][0]["segment_ids"].to("cuda", torch.int32)


def time_forward() -> int:
    """--time-forward: only the bf16 forward kernels K1, K2, K5, K8 and K11
    of the `nemo_tpu_torch` on sys.path (another checkout with --tree), each
    timed by CUDA events and by torch.profiler over 50 launches after 3
    warm-up ones (`_timing_start`: keys `<kernel>_ms`, `<kernel>_device_ms`
    and the host's time a call, `<kernel>_host_ms`) at the shape of its path: K1 and K2 at the
    transcription shape (B=32 x 30 s, full lengths), beside SDPA given the
    rel-pos bias (`sdpa_relpos`) and the bf16 cuDNN conv pair
    (`cudnn_pair_bf16`); K5 at B=8, H=32 over G=8, S=2048, dh 64, causal
    (and at dh 128, 12 heads over 12, GPT-551M's head), beside SDPA's
    forward; K8 on the SFT run's first batch; K11 at one rank's CP shape
    (B=1, Tl=8,192), rank 0's diagonal and off-diagonal ring steps. Prints
    one JSON line. K5 and K8 at dh 96 come last (`k5_dh96` at Phi-3-mini's
    B=2, 32 heads over 32, S=4096, beside `sdpa_dh96`; `k8_dh96` on the SFT
    batch), so that the earlier keys' inputs are drawn as before. Run it for
    two trees in turns (parent, change, change, parent) to compare them on
    one card."""
    from nemo_tpu_torch.ops.flash_attention import (_k5_launch, _k8_launch, _k11_launch,
                                                    pos_tile_ranges, relpos_flash_attention,
                                                    seg_tile_ranges)
    from nemo_tpu_torch.ops.subsampling_kernel import fused_subsampling_x4

    out, timed = _timing_start()
    gen = torch.Generator().manual_seed(0)
    p32, base = relpos_backward_inputs(gen, B)
    qu, qv, k, v = (t.to("cuda", torch.bfloat16).transpose(1, 2) for t in base[:4])
    p = p32.to("cuda", torch.bfloat16).transpose(0, 1)
    lens = torch.full((B,), qu.shape[2], dtype=torch.int32, device="cuda")
    timed("k1", lambda: relpos_flash_attention(qu, qv, k, v, p, lens, 0.125))
    bias = relpos_bias(qv, p, lens, 0.125, torch.bfloat16)
    timed("sdpa_relpos", lambda: F.scaled_dot_product_attention(qu, k, v, attn_mask=bias,
                                                                scale=0.125))
    del bias, qu, qv, k, v, p, base
    x, w1, b1, w2, b2 = (t.to("cuda", torch.bfloat16) for t in subsampling_inputs(gen))
    timed("k2", lambda: fused_subsampling_x4(x, w1, b1, w2, b2))
    x4 = x[:, None]
    w1c, w2c = (w.permute(3, 2, 0, 1).contiguous() for w in (w1, w2))
    timed("cudnn_pair_bf16", lambda: F.conv2d(F.conv2d(x4, w1c, b1, 2, 1).relu_(), w2c, b2, 2, 1)
          .relu_())
    del x, x4, w1, w2, w1c, w2c
    for name, (H, G, dh) in (("k5", (32, 8, 64)), ("k5_dh128", (12, 12, 128))):
        q, k, v, _ = _gqa_inputs(gen, LLM_B, H, G, LLM_S, dh, torch.bfloat16)
        scale = 1.0 / math.sqrt(dh)
        timed(name, lambda: _k5_launch(q, k, v, scale, True, None))
        timed(f"sdpa{name[2:]}", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    q, k, v, _ = _gqa_inputs(gen, LLM_B, 32, 8, LLM_S, 64, torch.bfloat16)
    seg = _sft_first_segments()
    ranges = seg_tile_ranges(seg)
    timed("k8", lambda: _k8_launch(q, k, v, seg, ranges, 0.125, True, None))
    Tl = CP_S // 2
    q, k, v, _ = _gqa_inputs(gen, CP_B, 32, 8, Tl, 64, torch.bfloat16)
    for step, (qpos, kpos, _, _) in ((s, position_layouts(Tl)[s])
                                     for s in ("diagonal", "off_diagonal")):
        r = (pos_tile_ranges(qpos), pos_tile_ranges(kpos))
        timed(f"k11_{step}", lambda: _k11_launch(q, k, v, qpos, kpos, 0.125, True, None, r))
    del q, k, v
    # K1 at dh 128: FastConformer-XL's transcription shape (B=32, H=8, T'=376)
    p32, base = relpos_backward_inputs(gen, B, 8, 376, 128)
    qu, qv, k, v = (t.to("cuda", torch.bfloat16).transpose(1, 2) for t in base[:4])
    p = p32.to("cuda", torch.bfloat16).transpose(0, 1)
    lens = torch.full((B,), 376, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(128)
    timed("k1_dh128", lambda: relpos_flash_attention(qu, qv, k, v, p, lens, scale))
    bias = relpos_bias(qv, p, lens, scale, torch.bfloat16)
    timed("sdpa_relpos_dh128", lambda: F.scaled_dot_product_attention(qu, k, v, attn_mask=bias,
                                                                      scale=scale))
    del qu, qv, k, v, p, base, bias
    # K5 and K8 at dh 96: Phi-3-mini's training shape (B=2, 32 heads over 32, S=4096) and
    # the SFT batch (B=8 x 2048)
    scale = 1.0 / math.sqrt(96)
    q, k, v, _ = _gqa_inputs(gen, PHI3_B, 32, 32, PHI3_S, 96, torch.bfloat16)
    timed("k5_dh96", lambda: _k5_launch(q, k, v, scale, True, None))
    timed("sdpa_dh96", lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              scale=scale))
    q, k, v, _ = _gqa_inputs(gen, LLM_B, 32, 32, LLM_S, 96, torch.bfloat16)
    timed("k8_dh96", lambda: _k8_launch(q, k, v, seg, ranges, scale, True, None))
    print(json.dumps(out), flush=True)
    return 0


def time_backward() -> int:
    """--time-backward: only the bf16 backward kernels of the `nemo_tpu_torch`
    on sys.path (another checkout with --tree), as --time-forward times the
    forward: K6, K7 and row_delta (the delta pass before them) at B=8, H=32
    over G=8, S=2048, dh 64, causal (and at dh 128, 12 heads over 12),
    beside SDPA's backward (dq, dk, dv of a causal GQA forward, its own delta
    pass included); K9 and K10 on the SFT run's first batch; K12 and K13 at
    one rank's CP shape (B=1, Tl=8,192), rank 0's diagonal and off-diagonal
    ring steps; K3, K4 and row_delta at the calibration shape (B=4, H=8,
    T=751, dh 64, full lengths), beside SDPA's backward given the rel-pos
    bias; and the same at dh 128 (T'=376), with K4 also on 2 rows
    (`k4_dh128_b2`, one round of the persistent grid); last, K6, K7 and
    row_delta at dh 96 at Phi-3-mini's B=2, 32 heads over 32, S=4096, beside
    SDPA's backward, and K9, K10 at dh 96 on the SFT batch. Each given the
    lse of its forward. Prints one JSON line."""
    from nemo_tpu_torch.ops.flash_attention import (
        _k5_launch, _k8_launch, _k11_launch, flash_dkv, flash_dq, flash_pos_dkv, flash_pos_dq,
        flash_seg_dkv, flash_seg_dq, pos_delta, pos_tile_ranges, relpos_flash_attention,
        relpos_flash_dkv, relpos_flash_dq, row_delta, seg_tile_ranges)

    out, timed = _timing_start()
    gen = torch.Generator().manual_seed(0)
    p32, base = relpos_backward_inputs(gen, FIT_BATCH)
    qu, qv, k, v, do = (t.to("cuda", torch.bfloat16).transpose(1, 2) for t in base)
    p = p32.to("cuda", torch.bfloat16).transpose(0, 1)
    lens = torch.full((FIT_BATCH,), qu.shape[2], dtype=torch.int32, device="cuda")
    args = (qu, qv, k, v, p, lens, 0.125)
    o, lse = relpos_flash_attention(*args)
    delta = row_delta(o, do)
    timed("k3", lambda: relpos_flash_dq(*args, lse, delta, do))
    timed("k4", lambda: relpos_flash_dkv(*args, lse, delta, do))
    timed("row_delta_relpos", lambda: row_delta(o, do))
    bias = relpos_bias(qv, p, lens, 0.125, torch.bfloat16)
    ql, kl, vl = (t.detach().requires_grad_() for t in (qu, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, scale=0.125)
    timed("sdpa_backward_relpos",
          lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True))
    del o_lib, bias, ql, kl, vl
    for name, (H, G, dh) in (("", (32, 8, 64)), ("_dh128", (12, 12, 128))):
        q, k, v, do = _gqa_inputs(gen, LLM_B, H, G, LLM_S, dh, torch.bfloat16)
        scale = 1.0 / math.sqrt(dh)
        o, lse = _k5_launch(q, k, v, scale, True, None)
        o = o.transpose(1, 2)
        args = (q, k, v, scale, True, None, lse, row_delta(o, do), do)
        timed(f"k6{name}", lambda: flash_dq(*args))
        timed(f"k7{name}", lambda: flash_dkv(*args))
        timed(f"row_delta{name}", lambda: row_delta(o, do))
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale,
                                               enable_gqa=True)
        timed(f"sdpa_backward{name}",
              lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True))
        del o_lib, ql, kl, vl
    q, k, v, do = _gqa_inputs(gen, LLM_B, 32, 8, LLM_S, 64, torch.bfloat16)
    seg = _sft_first_segments()
    ranges = seg_tile_ranges(seg)
    o, lse = _k8_launch(q, k, v, seg, ranges, 0.125, True, None)
    o = o.transpose(1, 2)
    args = (q, k, v, seg, 0.125, True, None, lse, row_delta(o, do), do, ranges)
    timed("k9", lambda: flash_seg_dq(*args))
    timed("k10", lambda: flash_seg_dkv(*args))
    Tl = CP_S // 2
    q, k, v, do = _gqa_inputs(gen, CP_B, 32, 8, Tl, 64, torch.bfloat16)
    for step, (qpos, kpos, _, _) in ((s, position_layouts(Tl)[s])
                                     for s in ("diagonal", "off_diagonal")):
        r = (pos_tile_ranges(qpos), pos_tile_ranges(kpos))
        o, lse = _k11_launch(q, k, v, qpos, kpos, 0.125, True, None, r)
        o = o.transpose(1, 2)
        args = (q, k, v, qpos, kpos, 0.125, True, None, lse, pos_delta(o, do), do, r)
        timed(f"k12_{step}", lambda: flash_pos_dq(*args))
        timed(f"k13_{step}", lambda: flash_pos_dkv(*args))
    # K3, K4 at dh 128: FastConformer-XL's calibration shape (B=4, H=8, T'=376)
    p32, base = relpos_backward_inputs(gen, FIT_BATCH, 8, 376, 128)
    qu, qv, k, v, do = (t.to("cuda", torch.bfloat16).transpose(1, 2) for t in base)
    p = p32.to("cuda", torch.bfloat16).transpose(0, 1)
    lens = torch.full((FIT_BATCH,), 376, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(128)
    args = (qu, qv, k, v, p, lens, scale)
    o, lse = relpos_flash_attention(*args)
    delta = row_delta(o, do)
    timed("k3_dh128", lambda: relpos_flash_dq(*args, lse, delta, do))
    timed("k4_dh128", lambda: relpos_flash_dkv(*args, lse, delta, do))
    timed("row_delta_relpos_dh128", lambda: row_delta(o, do))
    # K4 on the first 2 rows: 96 items of 64 keys, one round on 132 SMs, where
    # B=4's 192 take two on 60 of them (the tail of a persistent grid)
    half = [t[:2] for t in (qu, qv, k, v)] + [p, lens[:2], scale]
    timed("k4_dh128_b2", lambda: relpos_flash_dkv(*half, lse[:2], delta[:2], do[:2]))
    bias = relpos_bias(qv, p, lens, scale, torch.bfloat16)
    ql, kl, vl = (t.detach().requires_grad_() for t in (qu, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias, scale=scale)
    timed("sdpa_backward_relpos_dh128",
          lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True))
    del o_lib, ql, kl, vl, bias, qu, qv, k, v, do, p, base, half, args
    # K6, K7, K9 and K10 at dh 96: Phi-3-mini's training shape and the SFT batch
    scale = 1.0 / math.sqrt(96)
    q, k, v, do = _gqa_inputs(gen, PHI3_B, 32, 32, PHI3_S, 96, torch.bfloat16)
    o, lse = _k5_launch(q, k, v, scale, True, None)
    o = o.transpose(1, 2)
    args = (q, k, v, scale, True, None, lse, row_delta(o, do), do)
    timed("k6_dh96", lambda: flash_dq(*args))
    timed("k7_dh96", lambda: flash_dkv(*args))
    timed("row_delta_dh96", lambda: row_delta(o, do))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)
    timed("sdpa_backward_dh96",
          lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True))
    del o_lib, ql, kl, vl, args
    q, k, v, do = _gqa_inputs(gen, LLM_B, 32, 32, LLM_S, 96, torch.bfloat16)
    o, lse = _k8_launch(q, k, v, seg, ranges, scale, True, None)
    o = o.transpose(1, 2)
    args = (q, k, v, seg, scale, True, None, lse, row_delta(o, do), do, ranges)
    timed("k9_dh96", lambda: flash_seg_dq(*args))
    timed("k10_dh96", lambda: flash_seg_dkv(*args))
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one transcription batch, calibration steps, "
                             "LLM, SFT and CP training steps, one RNNT batch, RNNT head-fit "
                             "steps, a decode bench chunk and a text-to-waveform call")
    parser.add_argument("--cp-processes", action="store_true",
                        help="only the process-group form of CP training, one process a card: "
                             "torchrun --nproc-per-node N chip_smoke.py --cp-processes")
    parser.add_argument("--time-forward", action="store_true",
                        help="only time the bf16 forward kernels K1, K2, K5, K8 and K11")
    parser.add_argument("--time-backward", action="store_true",
                        help="only time the bf16 backward kernels K3, K4, K6, K7, K9, K10, "
                             "K12 and K13")
    parser.add_argument("--tree", default=None,
                        help="with --time-forward or --time-backward: the checkout whose "
                             "nemo_tpu_torch to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this check runs on the GPU only", file=sys.stderr)
        return 1
    if args.cp_processes:
        return cp_processes()
    if args.time_forward or args.time_backward:
        if args.tree:
            sys.path.insert(0, os.path.abspath(args.tree))
        return time_forward() if args.time_forward else time_backward()
    from nemo_tpu_torch.ops.flash_attention import flash_attention as k5
    from nemo_tpu_torch.ops.flash_attention import flash_attention_positions as k11
    from nemo_tpu_torch.ops.flash_attention import flash_pos_dkv as k13
    from nemo_tpu_torch.ops.flash_attention import flash_pos_dq as k12
    from nemo_tpu_torch.ops.flash_attention import flash_attention_packed as k8
    from nemo_tpu_torch.ops.flash_attention import flash_seg_dkv as k10
    from nemo_tpu_torch.ops.flash_attention import flash_seg_dq as k9
    from nemo_tpu_torch.ops.flash_attention import flash_dkv as k7
    from nemo_tpu_torch.ops.flash_attention import flash_dq as k6
    from nemo_tpu_torch.ops.flash_attention import relpos_flash_attention as k1
    from nemo_tpu_torch.ops.flash_attention import relpos_flash_dkv as k4
    from nemo_tpu_torch.ops.flash_attention import relpos_flash_dq as k3
    from nemo_tpu_torch.ops.subsampling_kernel import fused_subsampling_x4 as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    t0 = time.perf_counter()
    laps = [t0]

    def lap(what: str) -> None:
        laps.append(time.perf_counter())
        log(f"time: {what} {laps[-1] - laps[-2]:.1f} s")

    phase_build()
    gen = torch.Generator().manual_seed(0)
    phase_hopper_check(torch.Generator().manual_seed(1))
    rows = [phase_k1(gen), phase_k2(gen), *phase_k3_k4(gen)]
    lap("phases 1-4 (build, K1-K4)")
    phase_exactness(k1, k2)
    phase_grad_exactness()
    model, staged, fit_launches = phase_calibration({"k1": k1, "k2": k2, "k3": k3, "k4": k4})
    launches = phase_main_path(model, staged, k1, k2, args.profile)
    rows[0]["launches"], rows[1]["launches"] = launches["k1"], launches["k2"]
    rows[2]["launches"], rows[3]["launches"] = fit_launches["k3"], fit_launches["k4"]
    ctc_model = model  # calibrated: it serves phases 27-28
    del model, staged
    torch.cuda.empty_cache()
    lap("phases 5-8 (CTC exactness, calibration, main path)")
    llm_rows, llm551_rows = phase_k5_k7(gen)
    phase_llm_grad_exactness()
    phase_ce_grad_rounding()
    counters = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k5": k5, "k6": k6, "k7": k7}
    llm_launches, adamw_ms = phase_llm_training(counters, args.profile)
    for row, key in zip(llm_rows, ("k5", "k6", "k7")):
        row["launches"] = llm_launches[key]
    rows += llm_rows
    torch.cuda.empty_cache()
    lap("phases 9-12 (K5-K7, LLM exactness, LLM training)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sft.jsonl")
        write_sft_jsonl(path)
        dm, batches, shape, mid, mid_shape = sft_data(path)
        sft_rows = phase_k8_k10(gen, {"sft": batches[0]["segment_ids"],
                                      "mid": mid[0]["segment_ids"]})
        counters.update(k8=k8, k9=k9, k10=k10)
        sft_launches = phase_sft(counters, dm, batches, shape, mid, mid_shape, args.profile)
    for row, key in zip(sft_rows, ("k8", "k9", "k10")):
        row["launches"] = sft_launches[key]
    rows += sft_rows
    torch.cuda.empty_cache()
    lap("phases 13-14 (K8-K10, SFT)")
    cp_rows = phase_k11_k13(gen)
    phase_ring(gen)
    phase_llm_grad_exactness(cp_size=2)
    counters.update(k11=k11, k12=k12, k13=k13)
    cp_launches = phase_cp_training(counters, args.profile)
    for row, key in zip(cp_rows, ("k11", "k12", "k13")):
        row["launches"] = cp_launches[key]
    rows += cp_rows
    torch.cuda.empty_cache()
    lap("phases 15-17 (K11-K13, ring, CP training)")
    rnnt_models = phase_rnnt_exactness(k1, k2)
    phase_rnnt_loss(rnnt_models)
    del rnnt_models
    model, staged = phase_rnnt_calibration({"k1": k1, "k2": k2, "k3": k3, "k4": k4})
    phase_rnnt_main_path(model, staged, k1, k2, args.profile)
    del model, staged
    torch.cuda.empty_cache()
    lap("phases 18-21 (RNNT)")
    phase_serving_exactness()
    lap("phase 22 (serving exactness)")
    phase_decode_bench(args.profile)
    lap("phase 23 (decode bench)")
    server_launches = phase_llm_server(counters)
    lap("phase 24 (LLMServer)")
    t25 = time.perf_counter()
    phase_tts_exactness()
    lap("phase 25 (TTS exactness)")
    fp, voc = phase_tts_bench(args.profile)
    lap("phase 26 (bench_tts, HiFi-GAN V1)")
    audio_launches = phase_audio_server(ctc_model, fp, voc, k1, k2)
    lap("phase 27 (AudioServer)")
    agent_launches = phase_voice_agent(ctc_model, fp, voc, k1, k2)
    lap("phase 28 (VoiceAgent)")
    log(f"time: phases 25-28 {time.perf_counter() - t25:.1f} s")
    del ctc_model, fp, voc
    torch.cuda.empty_cache()
    t29 = time.perf_counter()
    phase_quant_products(gen)
    lap("phase 29 (quantised products)")
    phase_quant_grad_exactness()
    lap("phase 30 (fp8 exactness)")
    mfu_launches = phase_bench_llm(counters, args.profile)
    for row, key in zip(llm551_rows, ("k5", "k6", "k7")):
        row["launches"] = mfu_launches[key]
    rows += llm551_rows
    lap("phase 31 (bench_llm: GPT-551M bf16, fp8)")
    phase_adafactor_exactness()
    phase_bench_llm_1b(counters, adamw_ms, args.profile)
    lap("phase 32 (bench_llm_1b: Llama-3.2-1B, Adafactor)")
    log(f"time: phases 29-32 {time.perf_counter() - t29:.1f} s")
    t33 = time.perf_counter()
    gen128 = torch.Generator().manual_seed(14)  # the earlier phases' inputs stay as they were
    dh128_rows = [phase_k1(gen128, T=376, dh=128), *phase_k3_k4(gen128, T=376, dh=128)]
    phase_dh128_shapes()
    lap("phase 33 (K1, K3, K4 at dh 128)")
    phase_tdt_exactness(k1, k3, k4)
    lap("phase 34 (FastConformer-XL TDT exactness)")
    model, staged, tdt_fit = phase_tdt_calibration({"k1": k1, "k2": k2, "k3": k3, "k4": k4})
    lap("phase 35 (FastConformer-XL TDT calibration)")
    tdt_launches = phase_tdt_main_path(model, staged, k1, k2, args.profile)
    del model, staged
    torch.cuda.empty_cache()
    lap("phase 36 (FastConformer-XL TDT main path)")
    dh128_rows[0]["launches"] = tdt_launches["k1"]
    dh128_rows[1]["launches"], dh128_rows[2]["launches"] = tdt_fit["k3"], tdt_fit["k4"]
    rows += dh128_rows
    log(f"time: phases 33-36 {time.perf_counter() - t33:.1f} s")
    t37 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sft.jsonl")
        write_sft_jsonl(path)
        dm, batches, shape, _, _ = sft_data(path)
        gen96 = torch.Generator().manual_seed(17)  # the earlier phases' inputs stay as they were
        dh96_rows = phase_dh96(gen96, batches[0]["segment_ids"].to("cuda", torch.int32))
        lap("phase 37 (K5-K13 at dh 96)")
        phase_phi3_exactness()
        lap("phase 38 (Phi-3-mini exactness)")
        # Phi-3-mini pretraining's model, cut to PHI3_LAYERS layers
        phi3_launches, _ = phase_llm_training(counters, args.profile,
                                              _phi3_cfg(seq_length=PHI3_S), PHI3_B, PHI3_S, 1,
                                              PHI3_STEPS, "Phi-3-mini-4k")
        lap("phase 39 (Phi-3-mini training)")
        # packed SFT of Phi-3-mini: its recipe, the model cut to PHI3_LAYERS layers
        phi3_launches.update((key, n) for key, n in phase_sft(
            counters, dm, batches, shape, None, None, args.profile, "phi3_mini_4k", PHI3_LAYERS,
            1, PHI3_SFT_STEPS, "Phi-3-mini-4k").items() if key in ("k8", "k9", "k10"))
        lap("phase 40 (Phi-3-mini packed SFT)")
    for row, key in zip(dh96_rows, ("k5", "k6", "k7", "k8", "k9", "k10")):
        row["launches"] = phi3_launches[key]
    rows += dh96_rows
    torch.cuda.empty_cache()
    log(f"time: phases 37-40 {time.perf_counter() - t37:.1f} s")
    # `launches` in the kernels line is each kernel's main path's; the serving paths'
    # own counts, each read just after its run, go on a line of their own
    log("launches on the serving paths: " + "; ".join(
        f"{path} " + ", ".join(f"{k.upper()} {n}" for k, n in counts.items() if n)
        for path, counts in (("LLMServer", server_launches), ("AudioServer", audio_launches),
                             ("VoiceAgent", agent_launches))))
    log(f"total: {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
