#!/usr/bin/env python3
"""On-card check of the PyTorch port (`nemo_tpu_torch`): Conformer-Large CTC
transcription on one NVIDIA card, through the two hand-written kernels.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile  # and a torch.profiler breakdown of one batch

Phases, each printing a line; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   kernel source (`nemo_tpu_torch/csrc/*.cu`, one nvcc each, in parallel);
2. K1, the rel-pos flash attention, against its plain version at the main
   path's shape (B=32, H=8, T=751, dh=64), in bf16 and fp32, with its time,
   the plain version's and SDPA's (given the precomputed additive bias);
3. K2, the fused subsampling, against its plain version (the cuDNN conv
   pair in fp32) at the main path's shape (x [32, 3001, 80], C=512), bf16 and fp32;
4. the whole slice in fp32: one seeded Conformer-Large CTC model with both
   kernel flags, on the card (kernels) and on the CPU (plain versions), at
   B=2 x 5 s; log-probs on valid frames and greedy ids must agree;
5. the main path: `transcribe_staged` in bf16 at B=32 x 30 s of speech-like
   int16 audio, one warm batch and then timed ones; the kernels' launch
   counts must be 18 and 1 per batch. The weights are random (calibration is
   not ported), so the RTFx is not comparable to bench.py's.

With --profile, one more batch of the main path runs under torch.profiler
and its device time by kernel and the card's busy share of the wall time are
printed. It ends with a JSON line of the kernels and then
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
TF32 is off for the comparisons. Nothing of JAX or `nemo_tpu` is imported.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# peak dense rates and memory rate of one H100 SXM at its 700 W limit
# (NVIDIA's data sheet): the bound of each kernel is reckoned from these
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

B, SECS, SR = 32, 30.0, 16000
TIMED_BATCHES = 3


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


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


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


def phase_k1(gen: torch.Generator) -> dict:
    from nemo_tpu_torch.models.asr.modules.conformer import RelPositionalEncoding
    from nemo_tpu_torch.ops.flash_attention import (relpos_flash_attention,
                                                    relpos_flash_attention_plain)

    H, T, dh = 8, 751, 64
    D, scale = H * dh, 1.0 / math.sqrt(dh)
    _, pos_emb = RelPositionalEncoding(D)(torch.zeros(1, T, D))
    w_pos = torch.randn(D, D, generator=gen) / math.sqrt(D)
    p32 = (pos_emb @ w_pos).view(2 * T - 1, H, dh)  # [2T-1, H, dh], as the module builds it
    # the Linear outputs are [B, T, H, dh]; the kernel reads them as such
    base = [torch.randn(B, T, H, dh, generator=gen) for _ in range(4)]
    ragged = torch.tensor([T - 37 * (i % 9) for i in range(B)], dtype=torch.int32)
    full = torch.full((B,), T, dtype=torch.int32)
    row = {"name": "relpos_flash_attention", "route": "cuda",
           "source": "nemo_tpu_torch/csrc/relpos_flash.cu",
           "replaces": "nemo_tpu/ops/flash_attention.py:77"}
    for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-2, 2e-2)):
        qu, qv, k, v = (t.to("cuda", dtype).transpose(1, 2) for t in base)
        p = p32.to("cuda", dtype).transpose(0, 1)
        for lengths in (ragged, full):
            lens = lengths.cuda()
            o, lse = relpos_flash_attention(qu, qv, k, v, p, lens, scale)
            o_ref, lse_ref = relpos_flash_attention_plain(qu, qv, k, v, p, lens, scale)
            torch.cuda.synchronize()
            valid = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, :].expand(
                B, H, T)  # padded query rows are garbage by design
            what = f"K1 {str(dtype)[6:]} lengths={'ragged' if lengths is ragged else 'full'}"
            err = compare(what, o[valid], o_ref[valid], atol, rtol)
            compare(what + " lse", lse[valid], lse_ref[valid], 1e-3, 1e-4)
        del o_ref, lse_ref
        args = (qu, qv, k, v, p, lens, scale)  # the main path's lengths: full 30 s clips
        ms = cuda_ms(lambda: relpos_flash_attention(*args), iters=10)
        plain_ms = cuda_ms(lambda: relpos_flash_attention_plain(*args), iters=3)
        # SDPA as a yardstick, given the rel-pos term and the key mask as one
        # precomputed additive bias [B, H, T, T]
        bd = torch.einsum("bhid,hrd->bhir", qv.float(), p.float())
        bd = torch.nn.functional.pad(bd, (1, 0)).reshape(B, H, 2 * T, T)[:, :, 1:].reshape(
            B, H, T, 2 * T - 1)[..., :T] * scale
        keys = torch.arange(T, device="cuda")[None, :] < lens[:, None]
        bias = bd.masked_fill(~keys[:, None, None, :], float("-inf")).to(dtype)
        del bd
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qu, k, v, attn_mask=bias, scale=scale), iters=5)
        del bias
        elt = qu.element_size()
        n_bytes = elt * (5 * B * T * H * dh + (2 * T - 1) * H * dh) + 4 * B + 4 * B * H * T
        n_ops = 6 * H * dh * T * float(lens.sum())
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
        log(f"K1 {str(dtype)[6:]}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(SDPA+bias)={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)  # bf16, the main path's type, last
    return row


def phase_k2(gen: torch.Generator) -> dict:
    from nemo_tpu_torch.ops.subsampling_kernel import (fused_subsampling_x4,
                                                       fused_subsampling_x4_plain)

    T, Fi, C = 3001, 80, 512
    x32 = torch.randn(B, T, Fi, generator=gen)
    w1_32 = torch.randn(3, 3, 1, C, generator=gen) / 3.0
    b1_32 = 0.1 * torch.randn(C, generator=gen)
    w2_32 = torch.randn(3, 3, C, C, generator=gen) / math.sqrt(9 * C)
    b2_32 = 0.1 * torch.randn(C, generator=gen)
    row = {"name": "fused_subsampling_x4", "route": "cuda",
           "source": "nemo_tpu_torch/csrc/fused_subsampling.cu",
           "replaces": "nemo_tpu/ops/subsampling_kernel.py:34"}
    for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-2, 2e-2)):
        args = [t.to("cuda", dtype) for t in (x32, w1_32, b1_32, w2_32, b2_32)]
        out = fused_subsampling_x4(*args)
        ref = fused_subsampling_x4_plain(*args)
        torch.cuda.synchronize()
        if out.shape != (B, 751, 20 * C):
            raise AssertionError(f"K2: output shape {tuple(out.shape)}")
        err = compare(f"K2 {str(dtype)[6:]}", out, ref, atol, rtol)
        del out, ref
        ms = cuda_ms(lambda: fused_subsampling_x4(*args), iters=3)
        plain_ms = cuda_ms(lambda: fused_subsampling_x4_plain(*args), iters=5)
        # the library yardstick: the cuDNN conv pair alone in the kernel's
        # dtype, NCHW, without the plain version's casts and layout copies
        x4, w1, b1, w2, b2 = args[0][:, None], args[1].permute(3, 2, 0, 1).contiguous(), \
            args[2], args[3].permute(3, 2, 0, 1).contiguous(), args[4]
        library_ms = cuda_ms(lambda: F.conv2d(F.conv2d(x4, w1, b1, 2, 1).relu_(), w2, b2, 2, 1)
                             .relu_(), iters=5)
        elt = args[0].element_size()
        T2, F2, T4, F4 = 1501, 40, 751, 20
        n_bytes = elt * (B * T * Fi + 9 * C + C + 9 * C * C + C + B * T4 * F4 * C)
        n_ops = 2 * B * T4 * F4 * C * 9 * C + 2 * B * T2 * F2 * C * 9
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
        log(f"K2 {str(dtype)[6:]}: kernel_ms={ms:.4f} "
            f"plain_ms(fp32 cuDNN pair + layout)={plain_ms:.4f} "
            f"library_ms(cuDNN pair in {str(dtype)[6:]})={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
        row.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
    return row


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


def phase_main_path(k1, k2, profile: bool) -> dict:
    model = _model("bfloat16", None)
    n = int(SECS * SR)
    rng = np.random.RandomState(0)
    lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
    staged = [(torch.from_numpy(speechlike(B, n, rng)).cuda(), lens, B)
              for _ in range(1 + TIMED_BATCHES)]
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
    log(f"main path, transcribe_staged bf16 B={B} x {SECS:g} s, {TIMED_BATCHES} timed batches: "
        f"RTFx={rtfx:.1f} (uncalibrated weights, not comparable to bench.py), "
        f"{1e3 * wall / TIMED_BATCHES:.1f} ms/batch, peak_mem={peak:.2f} GiB, "
        f"{density:.1f} chars/utt, launches K1={launches['k1']} K2={launches['k2']}")
    if len(texts) != B * TIMED_BATCHES or not all(isinstance(s, str) for s in texts):
        raise AssertionError("transcribe_staged returned the wrong number of texts")
    want = {"k1": 18 * TIMED_BATCHES, "k2": TIMED_BATCHES}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if profile:
        profile_batch(model, staged[1:2])
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one batch of the main path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this check runs on the GPU only", file=sys.stderr)
        return 1
    from nemo_tpu_torch.ops.flash_attention import relpos_flash_attention as k1
    from nemo_tpu_torch.ops.subsampling_kernel import fused_subsampling_x4 as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    rows = [phase_k1(gen), phase_k2(gen)]
    phase_exactness(k1, k2)
    launches = phase_main_path(k1, k2, args.profile)
    rows[0]["launches"], rows[1]["launches"] = launches["k1"], launches["k2"]
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
