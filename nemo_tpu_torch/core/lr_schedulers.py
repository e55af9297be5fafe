"""Learning-rate schedules (counterpart of nemo_tpu/core/lr_schedulers.py:
`get_scheduler`, `_warmup_steps`, `_warmup_policy` and CosineAnnealing) as
plain functions of the step, which `core/optim.py:ClippedAdamW` calls on the
host before each update.

The JAX schedules are jnp programs in float32; these compute the same
formulas in numpy float32, operation for operation, so that the two agree
to float32's rounding. Only CosineAnnealing, the SFT recipes' schedule
(`llm/recipes.py`), is ported; the other policies of the JAX registry are
not.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

Schedule = Callable[[int], float]

AVAILABLE_SCHEDULERS: Dict[str, Callable[..., Schedule]] = {}


def register_scheduler(name: str):
    def deco(fn):
        AVAILABLE_SCHEDULERS[name] = fn
        return fn

    return deco


def get_scheduler(name: str, **kwargs) -> Schedule:
    if name not in AVAILABLE_SCHEDULERS:
        raise ValueError(
            f"Unknown scheduler {name!r}; available: {sorted(AVAILABLE_SCHEDULERS)}")
    return AVAILABLE_SCHEDULERS[name](**kwargs)


def _warmup_steps(max_steps: Optional[int], warmup_steps, warmup_ratio) -> float:
    if warmup_steps is not None:
        return float(warmup_steps)
    if warmup_ratio is not None:
        if max_steps is None:
            raise ValueError("warmup_ratio requires max_steps")
        return float(warmup_ratio * max_steps)
    return 0.0


def _warmup_policy(lr, warmup, max_steps, min_lr, anneal) -> Schedule:
    """Linear warmup from lr / (warmup + 1) to lr over `warmup` steps, then
    max(anneal(progress), min_lr), and min_lr from `max_steps` on."""
    f32 = np.float32
    warmup = max(float(warmup), 0.0)
    max_steps = float(max_steps)

    def schedule(step) -> float:
        step = f32(step)
        warm_lr = f32(lr) * (step + f32(1.0)) / f32(warmup + 1.0)
        decay_total = max(f32(max_steps - warmup), f32(1.0))
        progress = np.clip((step - f32(warmup)) / decay_total, f32(0.0), f32(1.0))
        out = warm_lr if step < warmup else max(f32(anneal(progress)), f32(min_lr))
        return float(f32(min_lr) if step >= max_steps else f32(out))

    return schedule


def _cos(x: np.float32) -> np.float32:
    """cos of a float32, rounded from float64 (numpy's float32 cos is off by
    up to 2 ulps; XLA's by under 1)."""
    return np.float32(np.cos(np.float64(x)))


@register_scheduler("CosineAnnealing")
def cosine_annealing(max_steps: int, lr: float = 1e-3, warmup_steps=None, warmup_ratio=None,
                     min_lr: float = 0.0, **_) -> Schedule:
    """Warmup, then min_lr + (lr - min_lr) (1 + cos(pi progress)) / 2."""
    f32 = np.float32
    warmup = _warmup_steps(max_steps, warmup_steps, warmup_ratio)
    return _warmup_policy(
        lr, warmup, max_steps, min_lr,
        lambda p: f32(min_lr) + f32(0.5 * (lr - min_lr)) * (f32(1.0) + _cos(f32(np.pi) * p)))
