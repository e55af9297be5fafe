"""Trainer callbacks (counterpart of nemo_tpu/core/callbacks.py: the event
bus `Callback`, `TimingCallback` and `ProgressPrinter`).

`TimingCallback` reads the host's clock around `train_step`, which on the
card returns once the step's kernels are queued: its step_time is the
host's dispatch time, not the device's. Time a device step with a
`torch.cuda.synchronize()` around a window of steps instead.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

logger = logging.getLogger("nemo_tpu_torch")


class Callback:
    def on_train_start(self, trainer):
        pass

    def on_step_start(self, trainer, step: int):
        pass

    def on_step_end(self, trainer, step: int, metrics: Dict[str, Any]):
        pass

    def on_train_end(self, trainer):
        pass


class TimingCallback(Callback):
    """The host's wall time of each step and its mean over the last `window`
    steps → metrics["step_time"], metrics["step_time_avg"] (seconds)."""

    def __init__(self, window: int = 20):
        self._t0 = None
        self._times: List[float] = []
        self.window = window

    def on_step_start(self, trainer, step):
        self._t0 = time.perf_counter()

    def on_step_end(self, trainer, step, metrics):
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self._times = (self._times + [dt])[-self.window:]
            metrics["step_time"] = dt
            metrics["step_time_avg"] = sum(self._times) / len(self._times)


class ProgressPrinter(Callback):
    """Logs the step, loss, grad norm, mean step time and lr every
    `log_every` steps (reading a metric on the card waits for its step)."""

    def __init__(self, log_every: int = 10):
        self.log_every = log_every

    def on_step_end(self, trainer, step, metrics):
        if step % self.log_every == 0:
            parts = [f"step {step}/{trainer.max_steps}"]
            for k in ("loss", "grad_norm", "step_time_avg", "tflops_per_chip", "lr"):
                if k in metrics:
                    parts.append(f"{k}: {float(metrics[k]):.4g}")
            logger.info(" | ".join(parts))
