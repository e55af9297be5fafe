"""GPT training step (counterpart of nemo_tpu/models/llm/train.py:
GPTTrainModule in its fused-CE, dense, single-batch branch, train.py:184-314).

    mod = GPTTrainModule(llama32_1b(seq_length=2048, attention_backend="flash"))
    metrics = mod.train_step({"tokens": tokens, "labels": labels})  # [B, S] each

One step is the model's hidden states (`output_hidden=True`), the fused
linear + CE loss over the tied or untied head, `torch.autograd.grad` of
every parameter, and `core/optim.py:gpt_optimizer` (clip 1.0, AdamW with
weight decay 0.1 on every leaf; the parameters are fp32 and are their own
masters). It returns {"loss", "grad_norm", "step"} as tensors on the
device, without waiting for it. The module runs on the card unless
`device="cpu"` is passed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch

from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.core.optim import gpt_optimizer
from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.models.llm.gpt import build_model, check_supported, init_parameters
from nemo_tpu_torch.models.llm.loss import fused_linear_cross_entropy, masked_token_loss


class GPTTrainModule:
    """Owns the model and its optimizer. `train_step(batch)` takes
    {"tokens": [B, S], "labels": [B, S], "loss_mask": [B, S] (optional)} as
    numpy arrays or tensors."""

    def __init__(self, cfg: GPTConfig, device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device, seed)
        self._start()

    def init_state(self, seed: int = 0) -> None:
        """Parameters drawn again from `seed` (on the module's device), a
        fresh optimizer state and step 0."""
        init_parameters(self.model, torch.Generator(device=self.device).manual_seed(seed),
                        self.cfg.init_method_std)
        self._start()

    def _start(self) -> None:
        self.params = list(self.model.parameters())
        self.optimizer = gpt_optimizer(self.params)
        self.step = 0

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             loss_mask: Union[torch.Tensor, None] = None) -> torch.Tensor:
        """The training loss of one [B, S] batch (train.py:loss_fn)."""
        if self.cfg.fused_ce:
            hidden = self.model(tokens, output_hidden=True)
            loss, _ = fused_linear_cross_entropy(hidden, self.model.head_weight(), labels,
                                                 loss_mask, chunk=self.cfg.fused_ce_chunk)
        else:
            loss, _ = masked_token_loss(self.model(tokens), labels, loss_mask)
        return loss

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def train_step(self, batch: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        tokens = self._tensor(batch["tokens"])
        if tokens.dim() != 2:
            raise NotImplementedError(
                "GPTTrainModule.train_step: only [B, S] batches are ported; in-step "
                "microbatching over [A, B, S] is not")
        labels = self._tensor(batch["labels"])
        mask = batch.get("loss_mask")
        mask = None if mask is None else self._tensor(mask)
        loss = self.loss(tokens, labels, mask)
        grads = torch.autograd.grad(loss, self.params)
        norm = self.optimizer.step(grads)
        metrics = {"loss": loss.detach(), "grad_norm": norm,
                   "step": torch.tensor(self.step, device=self.device)}
        self.step += 1
        return metrics
