"""LLM task API (counterpart of nemo_tpu/llm/api.py): `finetune` and
`validate_config` in their one-card form, `generate` and `ptq`.

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

    cfg_q, qparams = ptq(cfg, params, algorithm="int8_serve")   # int8-resident
    texts = generate(cfg_q, qparams, prompts, tokenizer)

`ptq` quantises a JAX-layout tree with the port's own arithmetic
(`ops/quant.py`), so a model the port trained is served without JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from nemo_tpu_torch.core.trainer import Trainer
from nemo_tpu_torch.interop.jax_params import load_jax_variables
from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.models.llm.generate import SamplingParams
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


def generate(model: GPTConfig, params, prompts: Sequence[str], tokenizer, *,
             sampling: SamplingParams = SamplingParams(), seed: int = 0,
             device: Union[str, torch.device, None] = None) -> List[str]:
    """Batch text generation (api.py:166), on the card unless `device="cpu"`."""
    from nemo_tpu_torch.models.llm.generate import generate as _gen

    return _gen(model, params, tokenizer, prompts, sampling, seed, device=device)


def ptq(cfg: GPTConfig, params, *, algorithm: str = "int8_weight_only",
        min_size: int = 1 << 16):
    """Post-training quantization of a JAX-layout tree (api.py:195).
    "int8_weight_only": every large kernel → {"q": int8, "scale"} (pass
    through `ops/quant.py:dequantize_params` before serving); "int8_serve":
    (cfg with quantization="int8_ptq", its int8-resident tree), which the
    engines and `LLMServer` run directly."""
    from nemo_tpu_torch.ops.quant import ptq_params_for_serving, quantize_params_int8

    if algorithm == "int8_serve":
        return ptq_params_for_serving(cfg, params)
    if algorithm != "int8_weight_only":
        raise ValueError(f"unknown ptq algorithm: {algorithm}")
    return cfg, quantize_params_int8(params, min_size=min_size)
