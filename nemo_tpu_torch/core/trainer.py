"""The training loop (counterpart of nemo_tpu/core/trainer.py:Trainer.fit):
a host loop that takes batches from the data module, calls the module's
`train_step` and drives the callbacks and `should_stop`.

In PyTorch's idiom the module owns its state (parameters, optimizer, step),
so `fit(module, datamodule)` calls `module.train_step(batch)`; where the JAX
loop starts from `initial_state`, the port's caller passes a module whose
parameters are already loaded (`llm/api.py:finetune`).

Module protocol: `train_step(batch) -> metrics`. DataModule protocol:
`train_batches(start_step) -> iterator of batches`.

Checkpointing and resume (`ckpt_io`, `resume`) and validation (`val_every >
0`) are not ported and raise NotImplementedError; nor is the metrics logger,
which goes with them.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from nemo_tpu_torch.core.callbacks import Callback, ProgressPrinter, TimingCallback

logger = logging.getLogger("nemo_tpu_torch")


class Trainer:
    def __init__(self, max_steps: int, callbacks: Optional[List[Callback]] = None,
                 ckpt_io=None, val_every: int = 0, resume=None):
        if ckpt_io is not None or resume is not None:
            raise NotImplementedError("Trainer: checkpointing and resume are not ported")
        if val_every:
            raise NotImplementedError("Trainer: validation (val_every > 0) is not ported")
        self.max_steps = max_steps
        self.callbacks = (callbacks if callbacks is not None
                          else [TimingCallback(), ProgressPrinter()])
        self.should_stop = False
        self.module = None
        self.global_step = 0

    def _emit(self, event: str, *args):
        for cb in self.callbacks:
            getattr(cb, event)(self, *args)

    def fit(self, module, datamodule) -> Dict[str, Any]:
        """Steps 0 .. max_steps - 1 (fewer if the data ends or a callback
        sets `should_stop`); returns the last step's metrics."""
        self.module = module
        self._emit("on_train_start")
        metrics: Dict[str, Any] = {}
        batches = datamodule.train_batches(0)
        for step in range(self.max_steps):
            self.global_step = step
            try:
                batch = next(batches)
            except StopIteration:
                logger.info("datamodule exhausted — stopping")
                break
            self._emit("on_step_start", step)
            metrics = dict(module.train_step(batch))
            self._emit("on_step_end", step, metrics)
            if self.should_stop:
                break
        self._emit("on_train_end")
        return metrics
