"""GPT training step (counterpart of nemo_tpu/models/llm/train.py:
GPTTrainModule in its fused-CE, dense, single-batch branch, train.py:184-314).

    mod = GPTTrainModule(llama32_1b(seq_length=2048, attention_backend="flash"))
    metrics = mod.train_step({"tokens": tokens, "labels": labels})  # [B, S] each

One step is the model's hidden states (`output_hidden=True`), the fused
linear + CE loss over the tied or untied head, `torch.autograd.grad` of
every parameter, and `core/optim.py:gpt_optimizer` (clip 1.0, AdamW with
weight decay 0.1 on every leaf; the parameters are fp32 and are their own
masters) at the learning rate of `lr_schedule(step)`, 3e-4 by default
(train.py:105-110). A packed batch (SFT, `data/fine_tuning.py`) also
carries "loss_mask", "positions" and "segment_ids", which reach the model
as train.py:loss_fn passes them. It returns {"loss", "grad_norm", "step"}
as tensors on the device, without waiting for it, and the step's "lr" as a
float. The module runs on the card unless `device="cpu"` is passed.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch

from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.core.optim import gpt_optimizer
from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.models.llm.gpt import build_model, check_supported, init_parameters
from nemo_tpu_torch.models.llm.loss import fused_linear_cross_entropy, masked_token_loss


class GPTTrainModule:
    """Owns the model and its optimizer. `train_step(batch)` takes
    {"tokens": [B, S], "labels": [B, S]} and optionally "loss_mask",
    "positions" and "segment_ids" [B, S], as numpy arrays or tensors.
    `lr_schedule` maps the step (from 0) to the learning rate."""

    def __init__(self, cfg: GPTConfig, device: Union[str, torch.device, None] = None,
                 seed: int = 0, lr_schedule: Optional[Callable[[int], float]] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr_schedule = lr_schedule
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
        self.optimizer = gpt_optimizer(self.params, self.lr_schedule)
        self.step = 0

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None, positions: Optional[torch.Tensor] = None,
             segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training loss of one [B, S] batch (train.py:loss_fn)."""
        if self.cfg.fused_ce:
            hidden = self.model(tokens, positions, segment_ids, output_hidden=True)
            loss, _ = fused_linear_cross_entropy(hidden, self.model.head_weight(), labels,
                                                 loss_mask, chunk=self.cfg.fused_ce_chunk)
        else:
            loss, _ = masked_token_loss(self.model(tokens, positions, segment_ids), labels,
                                        loss_mask)
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
        mask, positions, segment_ids = (
            None if batch.get(key) is None else self._tensor(batch[key])
            for key in ("loss_mask", "positions", "segment_ids"))
        loss = self.loss(tokens, labels, mask, positions, segment_ids)
        grads = torch.autograd.grad(loss, self.params)
        lr = float(self.optimizer.schedule(self.optimizer.count))
        norm = self.optimizer.step(grads)
        metrics = {"loss": loss.detach(), "grad_norm": norm,
                   "step": torch.tensor(self.step, device=self.device), "lr": lr}
        self.step += 1
        return metrics
