"""GPT training throughput and MFU on the card, bf16 against fp8
(counterpart of scripts/train_mfu.py, the path of bench.py:bench_llm and
bench_llm_1b).

    python -m nemo_tpu_torch.scripts.train_mfu [--steps 200] [--quant bf16 fp8]
    python -m nemo_tpu_torch.scripts.train_mfu --model llama32_1b --quant bf16
    python -m nemo_tpu_torch.scripts.train_mfu --model tiny --device cpu \\
        --steps 3 --batch 2 --seq 128          # the path at a tiny size on the CPU

`run` trains GPT-551M (`make_cfg`: 16 layers, d 1536, FFN 6144, 12 heads
x dh 128, MHA, vocab 32,768, untied, bf16, flash, full remat) with
`GPTTrainModule`'s AdamW chain, in bf16 or with `quantization` "fp8",
"fp8_e4m3" or "int8" (`ops/quant.py:quant_matmul` in every projection), or
Llama-3.2-1B (`make_cfg_1b`) under `core/optim.py:clip_adafactor(3e-4)`,
the script's `optax.chain(clip_by_global_norm(1.0), adafactor(3e-4))`, on
128 batches drawn from `np.random.RandomState(seed)`. The first step, as
in JAX, is not timed; the loss is read every `chunk` steps
and at the last. The result has the JAX script's keys, MFU against the
card's dense bf16 peak (989 TFLOP/s, one H100 SXM) and, for the fp8 modes,
also against its fp8 peak (1,979 TFLOP/s), and the device it ran on (a
CPU run's rates are no card's). The 1B line trains in bf16 only: its
config takes no quantization. FLOPs a token are
`llm/auto_configurator.py:model_flops_per_token`. `model="tiny"` runs the
551M's recipe on `tiny_test`'s model, for a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# dense peak rates of one H100 SXM (NVIDIA's data sheet), TFLOP/s
PEAK_BF16_TFLOPS = 989.0
PEAK_FP8_TFLOPS = 1979.0
N_BATCHES = 128  # a long cycle of distinct batches, as in the JAX script
MODELS = ("551m", "llama32_1b", "tiny")


def make_cfg(quantization=None, seq_length=2048, heads=12):
    """GPT-551M (scripts/train_mfu.py:26-41), field for field."""
    from nemo_tpu_torch.models.llm.config import _cfg

    return _cfg(
        num_layers=16, hidden_size=1536, ffn_hidden_size=6144,
        num_attention_heads=heads, num_query_groups=heads, vocab_size=32768,
        seq_length=seq_length, compute_dtype="bfloat16",
        attention_backend="flash", remat="full",
        quantization=quantization,
    )


def make_cfg_1b(seq_length=2048):
    """Llama-3.2-1B as the MFU bench trains it (scripts/train_mfu.py:44-53)."""
    from nemo_tpu_torch.models.llm.config import llama32_1b

    return llama32_1b(
        seq_length=seq_length, compute_dtype="bfloat16",
        attention_backend="flash", remat="full", scan_layers=True)


def build(quantization: Optional[str], model: str, S: int, seed: int = 0, device=None):
    """The GPTTrainModule of `model` ("551m", "llama32_1b" or "tiny") on
    `device` (the card by default), parameters drawn from `seed`."""
    from nemo_tpu_torch.core.optim import clip_adafactor
    from nemo_tpu_torch.models.llm.config import tiny_test
    from nemo_tpu_torch.models.llm.train import GPTTrainModule

    if model not in MODELS:
        raise ValueError(f"model {model!r} is not one of {MODELS}")
    optimizer = None
    if model == "llama32_1b":
        if quantization:  # make_cfg_1b takes none (scripts/train_mfu.py:44)
            raise ValueError("the 1B line trains in bf16: pass quantization=None")
        cfg = make_cfg_1b(seq_length=S)
        optimizer = clip_adafactor(3e-4)
    elif model == "tiny":
        cfg = tiny_test(seq_length=S, attention_backend="flash", remat="full",
                        quantization=quantization)
    else:
        cfg = make_cfg(quantization, seq_length=S)
    return GPTTrainModule(cfg, device=device, seed=seed, optimizer=optimizer)


def make_batches(cfg, B: int, S: int, seed: int, device) -> list:
    """The JAX script's 128 batches of tokens and labels from RandomState(seed),
    on `device`."""
    rng = np.random.RandomState(seed)
    return [{key: torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).to(device)
             for key in ("tokens", "labels")} for _ in range(N_BATCHES)]


def run(quantization, steps, B, S, seed=0, chunk=100, model="551m", device=None) -> Dict:
    """`steps` training steps of `model` at B x S, the first of them untimed
    (scripts/train_mfu.py:56-114)."""
    from nemo_tpu_torch.llm.auto_configurator import model_flops_per_token

    if steps < 2:
        raise ValueError(f"{steps} steps: one warm-up step and at least one timed")
    mod = build(quantization, model, S, seed, device)
    batches = make_batches(mod.cfg, B, S, seed, mod.device)

    losses = []
    m = mod.train_step(batches[0])  # warm-up
    float(m["loss"])  # waits for the card

    t0 = time.perf_counter()
    done = 1
    while done < steps:
        m = mod.train_step(batches[done % N_BATCHES])
        if done % chunk == 0 or done == steps - 1:
            losses.append((done, float(m["loss"])))  # also waits for the card
        done += 1
    float(m["loss"])
    t1 = time.perf_counter()

    tok_s = B * S * (steps - 1) / (t1 - t0)
    tflops = tok_s * model_flops_per_token(mod.cfg) / 1e12
    out = dict(quant=quantization or "bf16", tokens_per_sec=round(tok_s, 1),
               tflops_per_sec=round(tflops, 1),
               mfu_vs_bf16_peak=round(tflops / PEAK_BF16_TFLOPS, 4))
    if quantization in ("fp8", "fp8_e4m3"):
        out["mfu_vs_fp8_peak"] = round(tflops / PEAK_FP8_TFLOPS, 4)
    dev = mod.device
    out.update(steps=steps, batch=B, seq=S, losses=losses,
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type)
    return out


def overlay(results: Dict[str, Dict]) -> Optional[Dict]:
    """The fp8-vs-bf16 loss at their last common read and the fp8 speed-up
    (scripts/train_mfu.py:132-145); None without both runs or a common read."""
    if "bf16" not in results or "fp8" not in results:
        return None
    lb, lf = dict(results["bf16"]["losses"]), dict(results["fp8"]["losses"])
    common = sorted(set(lb) & set(lf))
    if not common:
        return None
    last = common[-1]
    rel = abs(lf[last] - lb[last]) / max(abs(lb[last]), 1e-9)
    return {"fp8_vs_bf16_loss_at_step": last, "bf16_loss": round(lb[last], 4),
            "fp8_loss": round(lf[last], 4), "rel_diff": round(rel, 4),
            "speedup": round(results["fp8"]["tokens_per_sec"]
                             / results["bf16"]["tokens_per_sec"], 3)}


def main(argv=None) -> Tuple[Dict, Optional[Dict]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--quant", nargs="+", default=["bf16", "fp8"])
    ap.add_argument("--model", default="551m", choices=MODELS)
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    results = {}
    for q in args.quant:
        r = run(None if q == "bf16" else q, args.steps, args.batch, args.seq,
                model=args.model, device=args.device)
        results[q] = r
        print(json.dumps({k: v for k, v in r.items() if k != "losses"}), flush=True)
    line = overlay(results)
    if line is not None:
        print(json.dumps(line), flush=True)
    return results, line


if __name__ == "__main__":
    main()
