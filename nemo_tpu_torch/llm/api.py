"""LLM task API (counterpart of nemo_tpu/llm/api.py): `finetune` and
`validate_config` in their one-card form.

    module, metrics = finetune(cfg, params, data, max_steps=100,
                               lr_schedule=recipe.lr_schedule())

`params` is the JAX package's parameter tree (nested dicts of numpy arrays
or tensors, as `GPTTrainModule.init_state().params` or an imported
checkpoint gives it); `interop/jax_params.py:load_jax_variables` carries it
into the module's fp32 parameters, as `_cast_like` casts it in JAX. The run
goes through `core/trainer.py:Trainer` and `GPTTrainModule.train_step` on
the card unless `device="cpu"` is given. LoRA/DoRA (`peft`), a mesh, a
caller's optimizer and `log_dir` (checkpointing) are not ported and raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from nemo_tpu_torch.core.trainer import Trainer
from nemo_tpu_torch.interop.jax_params import load_jax_variables
from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.models.llm.train import GPTTrainModule


def validate_config(cfg: GPTConfig, global_batch_size: int,
                    micro_batch_size: Optional[int]) -> None:
    """The divisibility checks of api.py:validate_config on one card (data,
    tensor and context parallel sizes of 1): the global batch must be a
    multiple of the micro batch."""
    if micro_batch_size and global_batch_size % micro_batch_size:
        raise ValueError(
            f"GBS {global_batch_size} must be divisible by MBS {micro_batch_size} × DP 1")


def finetune(model: GPTConfig, params, data, *, max_steps: int = 100, peft=None,
             trainer: Optional[Trainer] = None, log_dir: Optional[str] = None,
             lr_schedule: Optional[Callable[[int], float]] = None, mesh=None, optimizer=None,
             device: Union[str, torch.device, None] = None
             ) -> Tuple[GPTTrainModule, Dict[str, Any]]:
    """Finetune from existing parameters (api.py:85). Returns (module,
    metrics of the last step): the module holds what the JAX function
    returns as its state (parameters, optimizer state, step). Without a
    `lr_schedule` the module trains at its pretraining default of 3e-4, as
    in JAX."""
    for name, value in (("peft", peft), ("mesh", mesh), ("optimizer", optimizer),
                        ("log_dir", log_dir)):
        if value is not None:
            raise NotImplementedError(f"finetune: {name} is not ported (one card, full-parameter "
                                      f"SFT, no checkpointing)")
    validate_config(model, data.global_batch_size, data.micro_batch_size)
    module = GPTTrainModule(model, device=device, lr_schedule=lr_schedule)
    load_jax_variables(module.model, {"params": params})
    trainer = trainer or Trainer(max_steps=max_steps)
    metrics = trainer.fit(module, data)
    return module, metrics
