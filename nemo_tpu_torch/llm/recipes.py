"""Recipes: per-model defaults as factory functions (counterpart of
nemo_tpu/llm/recipes.py), for one card.

    fr = finetune_recipe("llama32_1b", peft_scheme="none", global_batch_size=8)
    module, metrics = fr.run(params, data, max_steps=20)

`Recipe` holds a pretraining recipe's fields without the JAX one's mesh;
only `tiny_test`, `llama32_1b`, `phi3_mini_4k` and `phi3_mini_4k_instruct`
are registered, with the JAX package's values (recipes.py:269-272, 311-312,
283-285 and 438-439, 685-687). `finetune_recipe` derives the SFT
recipe from one: sequence length at most 2048, a global batch of at most
128, lr 5e-6 (full-parameter SFT) on CosineAnnealing with 50 warmup steps,
packed data. Its LoRA, DoRA and canonical-LoRA schemes (the JAX default is
"lora") are not ported and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from nemo_tpu_torch.core.lr_schedulers import get_scheduler
from nemo_tpu_torch.models.llm import config as C


@dataclasses.dataclass
class Recipe:
    name: str
    model: C.GPTConfig
    global_batch_size: int
    micro_batch_size: Optional[int]
    lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 2000
    max_steps: int = 300000
    seq_length: Optional[int] = None
    family: str = "gpt"

    def lr_schedule(self):
        return get_scheduler("CosineAnnealing", max_steps=self.max_steps, lr=self.lr,
                             warmup_steps=self.warmup_steps, min_lr=self.min_lr)


RECIPES: Dict[str, Callable[..., Recipe]] = {}


def register(fn):
    RECIPES[fn.__name__] = fn
    return fn


@register
def tiny_test(**kw) -> Recipe:
    return Recipe("tiny_test", C.tiny_test(seq_length=32), 8, None, warmup_steps=2, max_steps=10,
                  **kw)


@register
def llama32_1b(**kw) -> Recipe:
    return Recipe("llama32_1b", C.llama32_1b(seq_length=8192, attention_backend="flash"), 512, 1,
                  lr=4e-4, **kw)


@register
def phi3_mini_4k(**kw) -> Recipe:
    """JAX's `_small` recipe: micro batch 1, the default lr and schedule."""
    return Recipe("phi3_mini_4k", C.phi3_mini_4k(attention_backend="flash"), 256, 1, **kw)


@register
def phi3_mini_4k_instruct(**kw) -> Recipe:
    return dataclasses.replace(RECIPES["phi3_mini_4k"](**kw), name="phi3_mini_4k_instruct")


@dataclasses.dataclass
class FinetuneRecipe:
    """A finetuning config derived from a pretraining recipe; `.run(params,
    data)` runs `llm/api.py:finetune` with its schedule."""

    name: str
    model: C.GPTConfig
    global_batch_size: int
    micro_batch_size: Optional[int]
    peft: Optional[Any] = None
    lr: float = 1e-4
    min_lr: float = 0.0
    warmup_steps: int = 50
    max_steps: int = 1000
    packed: bool = True

    def lr_schedule(self):
        return get_scheduler("CosineAnnealing", max_steps=self.max_steps, lr=self.lr,
                             warmup_steps=self.warmup_steps, min_lr=self.min_lr)

    def run(self, params, data, *, max_steps: Optional[int] = None, log_dir=None, trainer=None,
            device=None):
        from nemo_tpu_torch.llm.api import finetune

        if data.global_batch_size != self.global_batch_size:
            raise ValueError(
                f"data module global_batch_size {data.global_batch_size} != recipe's "
                f"{self.global_batch_size}: pass a matching data module or override the recipe "
                f"field")
        return finetune(self.model, params, data, peft=self.peft,
                        max_steps=max_steps or self.max_steps, trainer=trainer, log_dir=log_dir,
                        lr_schedule=self.lr_schedule(), device=device)


def finetune_recipe(name: str, peft_scheme: Optional[str] = "lora", seq_length: int = 2048,
                    **kw) -> FinetuneRecipe:
    """The SFT recipe of the registered pretraining recipe `name`
    (recipes.py:1107): its model at min(seq_length, its own) tokens, its
    micro batch, a global batch of min(128, its own), lr 5e-6; `kw`
    overrides any field. Only full-parameter SFT (`peft_scheme` "none" or
    None) is ported."""
    if peft_scheme in ("lora", "dora", "canonical_lora"):
        raise NotImplementedError(f"finetune_recipe: peft_scheme {peft_scheme!r} (nemo_tpu/llm/"
                                  f"peft.py) is not ported; pass peft_scheme='none'")
    if peft_scheme not in (None, "none"):
        raise ValueError(f"unknown peft_scheme {peft_scheme!r} (lora|dora|canonical_lora|none)")
    base = RECIPES[name]()
    defaults = dict(
        name=f"{name}_finetune",
        model=dataclasses.replace(base.model, seq_length=min(seq_length, base.model.seq_length)),
        global_batch_size=min(128, base.global_batch_size),
        micro_batch_size=base.micro_batch_size,
        lr=5e-6,  # full SFT (finetune_default.py); LoRA would take 1e-4
    )
    defaults.update(kw)
    return FinetuneRecipe(**defaults)
