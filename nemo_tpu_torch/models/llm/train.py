"""GPT training step (counterpart of nemo_tpu/models/llm/train.py:
GPTTrainModule in its fused-CE, dense, single-batch branch, train.py:184-314).

    mod = GPTTrainModule(llama32_1b(seq_length=2048, attention_backend="flash"))
    metrics = mod.train_step({"tokens": tokens, "labels": labels})  # [B, S] each

One step is the model's hidden states (`output_hidden=True`), the fused
linear + CE loss over the tied or untied head, `torch.autograd.grad` of
every parameter, and `core/optim.py:gpt_optimizer` (clip 1.0, AdamW with
weight decay 0.1 on every leaf; the parameters are fp32 and are their own
masters) at the learning rate of `lr_schedule(step)`, 3e-4 by default
(train.py:105-110), or the optimizer that the `optimizer` factory makes
from the model, as JAX's `optimizer` field replaces that chain (train.py:81,
105-110): `core/optim.py:clip_adafactor(3e-4)` is the MFU bench's 1B
chain. A packed batch (SFT, `data/fine_tuning.py`) also
carries "loss_mask", "positions" and "segment_ids", which reach the model
as train.py:loss_fn passes them. It returns {"loss", "grad_norm", "step"}
as tensors on the device, without waiting for it, and the step's "lr" as a
float. The module runs on the card unless `device="cpu"` is passed.

Context parallelism (`cp_size > 1`, train.py:98-102 and 188-205): a batch
without positions is reordered zig-zag (rank r of cp gets chunks r and
2cp-1-r of 2cp) and its positions become that order; attention then takes
ring attention (`ops/ring_attention.py`); a batch that cannot take it
(segment ids, or shards not a multiple of 128 tokens) raises
NotImplementedError. Without a mesh, every rank is held in this process
(`LocalRing`, GPTModel's default). With a `parallel/mesh.py:make_mesh` mesh
(one process a rank, e.g. under `torchrun`), cp_size comes from its "cp"
axis; every rank is given the whole global batch and takes its own zig-zag
shard, the loss is the global masked mean (its sum and count all-reduced
over cp) and the gradients are summed over cp before clipping, so that
every rank takes the same AdamW step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist

from nemo_tpu_torch.core.device import resolve_device
from nemo_tpu_torch.core.optim import gpt_optimizer
from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.models.llm.gpt import build_model, check_supported, init_parameters
from nemo_tpu_torch.models.llm.loss import fused_linear_cross_entropy, masked_token_loss
from nemo_tpu_torch.ops.ring_attention import ProcessGroupRing, zigzag_order

# the keys of a batch that train_step takes; any other (with a value) raises
BATCH_KEYS = ("tokens", "labels", "loss_mask", "positions", "segment_ids")


class GPTTrainModule:
    """Owns the model and its optimizer. `train_step(batch)` takes
    {"tokens": [B, S], "labels": [B, S]} and optionally "loss_mask",
    "positions" and "segment_ids" [B, S], as numpy arrays or tensors.
    `lr_schedule` maps the step (from 0) to the learning rate. `mesh` is a
    ("dp", "cp") DeviceMesh (`parallel/mesh.py:make_mesh`) for context
    parallelism over processes; dp must be 1. `optimizer`, a factory: the
    model → an optimizer over `list(model.parameters())` with `step(grads)`,
    `schedule` and `count` (`core/optim.py:clip_adafactor`); given one,
    `lr_schedule` is not read, as in JAX. `init_state` makes a fresh one."""

    def __init__(self, cfg: GPTConfig, device: Union[str, torch.device, None] = None,
                 seed: int = 0, lr_schedule: Optional[Callable[[int], float]] = None,
                 mesh=None, optimizer: Optional[Callable[[torch.nn.Module], object]] = None):
        ring = None  # without a mesh, GPTModel's default: LocalRing(cfg.cp_size) where cp > 1
        if mesh is not None:
            if mesh["dp"].size() > 1:
                raise NotImplementedError("GPTTrainModule: a mesh with dp > 1 is not ported")
            cp = mesh["cp"].size()
            if cp > 1 and cfg.cp_size != cp:  # the ring wired to the mesh (train.py:98-102)
                cfg = dataclasses.replace(cfg, cp_size=cp)
            if cfg.cp_size != cp:
                raise ValueError(f"cp_size {cfg.cp_size} on a mesh whose cp axis is {cp}")
            if cp > 1:
                ring = ProcessGroupRing(mesh["cp"].get_group())
        check_supported(cfg)
        if cfg.quantization == "int8_ptq":  # train.py:91-94
            raise ValueError("quantization='int8_ptq' is the weight-resident serving path "
                             "(ptq(algorithm='int8_serve')); its int8 params have no useful "
                             "gradients")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr_schedule = lr_schedule
        self.make_optimizer = optimizer
        self.model = build_model(cfg, self.device, seed, ring)
        self._start()

    def init_state(self, seed: int = 0) -> None:
        """Parameters drawn again from `seed` (on the module's device), a
        fresh optimizer state and step 0."""
        init_parameters(self.model, torch.Generator(device=self.device).manual_seed(seed),
                        self.cfg.init_method_std)
        self._start()

    def _start(self) -> None:
        self.params = list(self.model.parameters())
        self.optimizer = (self.make_optimizer(self.model) if self.make_optimizer
                          else gpt_optimizer(self.params, self.lr_schedule))
        self.step = 0

    def _over_processes(self) -> bool:
        ring = self.model.ring
        return ring is not None and ring.held < ring.size

    def _cp_batch(self, tokens, labels, loss_mask, positions, segment_ids):
        """The zig-zag reorder of train.py:188-205, then, over processes, this
        rank's contiguous shard of the sequence (shard_map's split)."""
        cp = self.cfg.cp_size
        S = tokens.shape[-1]
        if cp > 1 and positions is None and S % (2 * cp) == 0:
            order = torch.from_numpy(zigzag_order(S, cp)).to(tokens.device)
            tokens, labels = tokens[..., order], labels[..., order]
            loss_mask = None if loss_mask is None else loss_mask[..., order]
            positions = order.to(torch.int32)[None, :].expand(tokens.shape[0], S)
        if self._over_processes():
            if S % cp:
                raise ValueError(f"sequence of {S} tokens over {cp} context-parallel ranks")
            rank = self.model.ring.rank
            part = slice(rank * (S // cp), (rank + 1) * (S // cp))
            tokens, labels = tokens[..., part], labels[..., part]
            loss_mask, positions, segment_ids = (None if x is None else x[..., part]
                                                 for x in (loss_mask, positions, segment_ids))
        return tokens, labels, loss_mask, positions, segment_ids

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None, positions: Optional[torch.Tensor] = None,
             segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training loss of one [B, S] batch (train.py:loss_fn). Over
        processes, this rank's share of the global masked mean: its masked
        sum over the all-reduced count, so that the shares sum to the loss."""
        tokens, labels, loss_mask, positions, segment_ids = self._cp_batch(
            tokens, labels, loss_mask, positions, segment_ids)
        if self.cfg.fused_ce:
            hidden = self.model(tokens, positions, segment_ids, output_hidden=True)
            loss, n = fused_linear_cross_entropy(hidden, self.model.head_weight(), labels,
                                                 loss_mask, chunk=self.cfg.fused_ce_chunk)
        else:
            loss, n = masked_token_loss(self.model(tokens, positions, segment_ids), labels,
                                        loss_mask)
        if self._over_processes():
            count = (torch.tensor(float(labels.numel()), device=loss.device) if loss_mask is None
                     else loss_mask.to(loss.device, torch.float32).sum())
            dist.all_reduce(count, group=self.model.ring.group)
            loss = loss * n.detach() / count.clamp_min(1.0)
        return loss

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def train_step(self, batch: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        unported = sorted(k for k, v in batch.items() if k not in BATCH_KEYS and v is not None)
        if unported:  # teacher_logits: distillation (JAX train.py:208-225) is not ported
            raise NotImplementedError(
                f"GPTTrainModule.train_step: batch keys {unported} are not ported; a batch "
                f"takes {', '.join(BATCH_KEYS)}")
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
        if self._over_processes():  # the global loss and gradient: sums over cp
            loss = loss.detach().clone()
            for t in (loss, *grads):
                dist.all_reduce(t, group=self.model.ring.group)
        lr = float(self.optimizer.schedule(self.optimizer.count))
        norm = self.optimizer.step(grads)
        metrics = {"loss": loss.detach(), "grad_norm": norm,
                   "step": torch.tensor(self.step, device=self.device), "lr": lr}
        self.step += 1
        return metrics
