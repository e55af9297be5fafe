"""clip_by_global_norm + AdamW with optax's semantics, on fp32 masters.

Three chains of the JAX package run through `ClippedAdamW`:

- calibration (nemo_tpu/models/asr/synthetic.py:231-233):
  `optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(schedule))` with
  optax's `warmup_cosine_decay_schedule` (the class defaults);
- GPT training (nemo_tpu/models/llm/train.py:105-110):
  `optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule,
  b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1))`, weight decay on every leaf,
  a constant 3e-4 unless the module is given a schedule (SFT recipes pass
  `core/lr_schedulers.py`'s CosineAnnealing) (`gpt_optimizer`);
- FastPitch's synthetic fit (nemo_tpu/models/tts/fastpitch_model.py:112):
  `optax.adam(lr)`, no clipping and no decay (`adam`).

Where torch's own differ: torch's `clip_grad_norm_` adds 1e-6 to the norm
and `torch.optim.AdamW` decays by lr·wd·p before the Adam step with a
default wd of 0.01; optax adds wd·p to the Adam direction and scales the sum
by the schedule, whose first value (count 0) is used by the first update.

The optimizer owns fp32 master copies of its leaves. Leaves held in a
narrower dtype (the bf16 weights of a bf16 model) receive the rounded master
after each step, so an update smaller than a bf16 ulp is kept in the master,
as in the JAX package, whose variables are fp32 and cast at each use. An
fp32 leaf is its own master.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    `init_value` to `peak_value` over `warmup_steps`, then a cosine to
    `end_value` at `decay_steps` (which counts the warmup), flat after."""
    alpha = end_value / peak_value if peak_value else 0.0
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span)) + alpha)

    return schedule


def constant_schedule(value: float) -> Callable[[int], float]:
    """optax.constant_schedule: `value` at every count."""
    return lambda count: value


class ClippedAdamW:
    """clip_by_global_norm(max_norm) then AdamW (b1, b2, eps outside the
    square root, weight decay on every leaf; by default calibration's 5.0,
    0.9, 0.999, 1e-8 and 1e-4) over `leaves` (any tensors: parameters and
    BatchNorm running stats alike), on fp32 masters.

    `step(grads)` takes one gradient per leaf (any float dtype), updates the
    masters and writes them into the leaves. It runs on the leaves' device
    and does not synchronise with the host."""

    def __init__(self, leaves: Sequence[torch.Tensor], schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_norm: float = 5.0):
        self.B1, self.B2, self.EPS = b1, b2, eps
        self.WEIGHT_DECAY, self.MAX_NORM = weight_decay, max_norm
        self.leaves = list(leaves)
        # an fp32 leaf is its own master; a narrower one gets an fp32 copy
        self.masters = [t.detach() if t.dtype == torch.float32 else t.detach().float()
                        for t in self.leaves]
        self.mu = [torch.zeros_like(m) for m in self.masters]
        self.nu = [torch.zeros_like(m) for m in self.masters]
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update; returns the global norm of `grads` (before clipping)."""
        if len(grads) != len(self.leaves):
            raise ValueError(f"{len(grads)} gradients for {len(self.leaves)} leaves")
        g: List[torch.Tensor] = [x.float() for x in grads]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        # optax: where(norm < max_norm, g, g / norm * max_norm)
        factor = torch.where(norm < self.MAX_NORM, torch.ones_like(norm), self.MAX_NORM / norm)
        g = torch._foreach_mul(g, factor)
        self.count += 1
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        den = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        del g
        update = mu_hat  # the Adam direction, in place of mu_hat's buffers
        torch._foreach_div_(update, den)
        del den
        torch._foreach_add_(update, self.masters, alpha=self.WEIGHT_DECAY)
        lr = self.schedule(self.count - 1)  # optax's schedule count starts at 0
        torch._foreach_add_(self.masters, update, alpha=-lr)
        for leaf, master in zip(self.leaves, self.masters):
            if leaf.dtype != torch.float32:
                leaf.copy_(master)
        return norm


def gpt_optimizer(leaves: Sequence[torch.Tensor],
                  schedule: Optional[Callable[[int], float]] = None) -> ClippedAdamW:
    """GPTTrainModule's chain (nemo_tpu/models/llm/train.py:105-110): clip
    1.0, then AdamW(b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1 on every
    leaf) at the learning rate `schedule(step)`, by default a constant 3e-4."""
    return ClippedAdamW(leaves, schedule or constant_schedule(3e-4), b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.1, max_norm=1.0)


def adam(leaves: Sequence[torch.Tensor], lr: float) -> ClippedAdamW:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, no weight decay and no
    clipping (an infinite norm bound scales every gradient by 1)."""
    return ClippedAdamW(leaves, constant_schedule(lr), b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=0.0, max_norm=math.inf)
