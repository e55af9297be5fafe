"""clip_by_global_norm + AdamW, and clip_by_global_norm + Adafactor, with
optax's semantics, on fp32 masters.

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

One runs through `ClippedAdafactor`: the 1B line of the MFU bench
(scripts/train_mfu.py:66-69), `optax.chain(optax.clip_by_global_norm(1.0),
optax.adafactor(3e-4))` with optax 0.2.6's defaults (`clip_adafactor`, the
factory `GPTTrainModule(optimizer=...)` takes).

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
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
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


def _norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of each of `tensors` (fp32, on one device), stacked, fp32.
    On the card one `_foreach_norm`; on the CPU each norm is summed in fp64,
    since torch's CPU kernel sums an fp32 norm in fp32 (5e-3 relative off
    for 67 M normal values, where clip_by_global_norm and Adafactor's
    parameter RMS want fp32's precision)."""
    if tensors[0].device.type == "cpu":
        return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64)
                            for t in tensors]).float()
    return torch.stack(torch._foreach_norm(tensors))


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
        norm = torch.linalg.vector_norm(_norms(g))
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


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int
                   ) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: (d1, d0), the second largest and the largest
    axis in np.argsort's order, where the second largest has at least
    `min_dim_size_to_factor` entries; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _drop(shape: Sequence[int], axis: int) -> Tuple[int, ...]:
    return tuple(d for i, d in enumerate(shape) if i != axis)


class ClippedAdafactor:
    """clip_by_global_norm(1.0), then optax.adafactor(schedule) with
    optax 0.2.6's defaults (factored second moments over the two largest
    axes where the second largest has at least 128 entries, decay 1 -
    (count + 1)^-0.8, eps 1e-30, the update clipped to a block RMS of 1,
    times the learning rate, times max(rms(p), 1e-3), no momentum and no
    weight decay), on fp32 masters as `ClippedAdamW` keeps them, with its
    interface: `step(grads)` takes one gradient per leaf and returns the
    global norm; `schedule` and `count`.

    Adafactor's statistics, its block RMS and its parameter scale are taken
    over the leaves of the JAX tree, not over the port's tensors: `groups`
    (`interop/jax_params.py:jax_leaf_groups`) says which of `leaves` make
    up each JAX leaf and in which layout. The update runs on the stacked
    leaf: each step gathers a leaf's gradients into the JAX layout (one copy,
    layer by layer, of the leaf's size), computes the update there and
    subtracts each layer's slice from its master through a view. So the 1B
    model's q_proj [16, 2048, 32, 64] keeps a full second moment (its second
    largest axis is 64) where a per-layer [2048, 2048] weight would be
    factored, and GPT-551M's q_proj [16, 1536, 12, 128] is factored over
    1536 and 128. The global norm and the parameter RMS are sums over the
    parts, equal to the stacked leaf's up to the order of the sum."""

    MAX_NORM = 1.0  # clip_by_global_norm
    DECAY_RATE, EPS, MIN_DIM_SIZE_TO_FACTOR = 0.8, 1e-30, 128  # scale_by_factored_rms
    CLIP = 1.0  # clip_by_block_rms
    MIN_SCALE = 1e-3  # scale_by_param_block_rms

    def __init__(self, leaves: Sequence[torch.Tensor], groups: Sequence,
                 schedule: Callable[[int], float]):
        self.leaves = list(leaves)
        self.masters = [t.detach() if t.dtype == torch.float32 else t.detach().float()
                        for t in self.leaves]
        covered = sorted(i for g in groups for i in g.index)
        if covered != list(range(len(self.leaves))):
            raise ValueError("ClippedAdafactor: the groups must cover every leaf once")
        self.groups = list(groups)
        self.factored: List[Optional[Tuple[int, int]]] = []
        self.v_row, self.v_col, self.v = [], [], []
        device = self.masters[0].device
        for g in self.groups:
            dims = _factored_dims(g.shape, self.MIN_DIM_SIZE_TO_FACTOR)
            self.factored.append(dims)
            if dims is None:
                self.v_row.append(None)
                self.v_col.append(None)
                self.v.append(torch.zeros(g.shape, device=device))
            else:
                d1, d0 = dims
                self.v_row.append(torch.zeros(_drop(g.shape, d0), device=device))
                self.v_col.append(torch.zeros(_drop(g.shape, d1), device=device))
                self.v.append(None)
        self.schedule = schedule
        self.count = 0

    @staticmethod
    def _stacked(group, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The group's parts of `tensors` as the JAX leaf (a new fp32 tensor)."""
        parts = [(tensors[i].t() if group.transposed else tensors[i]).reshape(group.part_shape)
                 for i in group.index]
        return torch.stack(parts) if group.stacked else parts[0].clone()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update; returns the global norm of `grads` (before clipping)."""
        if len(grads) != len(self.leaves):
            raise ValueError(f"{len(grads)} gradients for {len(self.leaves)} leaves")
        g = [x.float() for x in grads]
        norm = torch.linalg.vector_norm(_norms(g))
        # optax: select(norm < max_norm, t, t / norm * max_norm), as t / div * mul
        clipped = norm >= self.MAX_NORM
        div = torch.where(clipped, norm, torch.ones_like(norm))
        mul = torch.where(clipped, torch.full_like(norm, self.MAX_NORM), torch.ones_like(norm))
        # scale_by_factored_rms's decay in fp32, from the count before this step
        decay = np.float32(1.0) - np.float32(self.count + 1) ** np.float32(-self.DECAY_RATE)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        lr = self.schedule(self.count)  # scale_by_learning_rate's count, also from 0
        for k, group in enumerate(self.groups):
            u = self._stacked(group, g).div_(div).mul_(mul)
            sq = (u * u).add_(self.EPS)
            dims = self.factored[k]
            if dims is None:
                v = self.v[k].mul_(keep).add_(sq, alpha=take)
                del sq
                u.mul_(v.pow(-0.5))
            else:
                d1, d0 = dims
                v_row = self.v_row[k].mul_(keep).add_(sq.mean(d0), alpha=take)
                v_col = self.v_col[k].mul_(keep).add_(sq.mean(d1), alpha=take)
                del sq
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).pow_(-0.5)
                u.mul_(row_factor.unsqueeze(d0)).mul_(v_col.pow(-0.5).unsqueeze(d1))
            # clip_by_block_rms, the learning rate, scale_by_param_block_rms
            rms_u = torch.sqrt((u * u).mean())
            u.div_(torch.clamp_min(rms_u / self.CLIP, 1.0)).mul_(lr)
            masters = [self.masters[i] for i in group.index]
            sq_sum = _norms(masters).square().sum()
            rms_p = torch.sqrt(sq_sum / math.prod(group.shape))
            u.mul_(torch.where(rms_p <= self.MIN_SCALE, torch.full_like(rms_p, self.MIN_SCALE),
                               rms_p))
            parts = u.unbind(0) if group.stacked else (u,)
            for master, part in zip(masters, parts):  # p + (-u), through a view
                master.sub_(part.reshape(master.shape[::-1]).t() if group.transposed
                            else part.reshape(master.shape))
        self.count += 1
        for leaf, master in zip(self.leaves, self.masters):
            if leaf.dtype != torch.float32:
                leaf.copy_(master)
        return norm


def clip_adafactor(learning_rate: float = 3e-4) -> Callable:
    """The factory `GPTTrainModule(optimizer=...)` takes for the MFU bench's
    1B chain, optax.chain(optax.clip_by_global_norm(1.0),
    optax.adafactor(learning_rate)) (scripts/train_mfu.py:66-69): model →
    `ClippedAdafactor` over `list(model.parameters())`, grouped by the
    model's JAX leaves."""
    def make(model) -> ClippedAdafactor:
        from nemo_tpu_torch.interop.jax_params import jax_leaf_groups

        return ClippedAdafactor(list(model.parameters()), jax_leaf_groups(model),
                                constant_schedule(learning_rate))
    return make
