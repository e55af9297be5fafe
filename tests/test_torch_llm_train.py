"""The port's GPT training step (nemo_tpu_torch/models/llm/train.py,
loss.py, core/optim.py) against the JAX package.

- On a tiny Llama-style model (tied embeddings, llama3 RoPE), fp32, B=2,
  S=128, weights carried from JAX: the first step's loss within 1e-5
  relative and every leaf's gradient within 1e-4 of the leaf's max-abs plus
  1e-6 of `jax.value_and_grad` of the JAX fused-CE loss; the losses and
  grad norms of two steps match `GPTTrainModule.train_step`'s. The port runs
  the flash backend with full remat (K5's Function, recomputed, with the
  plain backward on the CPU); JAX the einsum backend, since interpret-mode
  Pallas does not run under remat and scan (tests/test_flash_attention.py:75).
- The GPT optimizer chain matches optax's over 8 steps, one above the clip.
- Guards: no device means CUDA; a [A, B, S] batch and an unsupported config
  raise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm.gpt import GPTModel as JaxGPTModel  # noqa: E402
from nemo_tpu.models.llm.loss import fused_linear_cross_entropy as jax_fused_ce  # noqa: E402
from nemo_tpu.models.llm.train import GPTTrainModule as JaxGPTTrainModule  # noqa: E402
from nemo_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from nemo_tpu_torch.core.optim import gpt_optimizer  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables)
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402

B, S = 2, 128


def _cfg(module, **kw):
    return module.tiny_test(share_embeddings_and_output_weights=True, rope_scaling="llama3",
                            rotary_base=5e5, seq_length=S, fused_ce_chunk=48, **kw)


def _batches(n):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        mask = np.ones((B, S), np.float32)
        mask[1, 100:] = 0.0
        out.append({"tokens": rng.randint(0, 128, (B, S)).astype(np.int32),
                    "labels": rng.randint(0, 128, (B, S)).astype(np.int32), "loss_mask": mask})
    return out


def test_train_steps_match_jax():
    jax_cfg = _cfg(jax_config)
    jax_mod = JaxGPTTrainModule(jax_cfg, mesh=make_mesh(MeshConfig(), jax.devices()[:1]))
    state = jax_mod.init_state(seed=0)
    params = jax.device_get(nn.meta.unbox(state.params))
    batches = _batches(2)

    def loss_fn(p, batch):
        hidden = JaxGPTModel(jax_cfg).apply({"params": p}, jnp.asarray(batch["tokens"]),
                                            output_hidden=True)
        return jax_fused_ce(hidden, p["embedding"], jnp.asarray(batch["labels"]),
                            jnp.asarray(batch["loss_mask"]), chunk=jax_cfg.fused_ce_chunk)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params, batches[0])

    mod = GPTTrainModule(_cfg(port_config, attention_backend="flash"), device="cpu")
    load_jax_variables(mod.model, {"params": params})
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    loss = mod.loss(batch["tokens"], batch["labels"], batch["loss_mask"])
    grads = torch.autograd.grad(loss, mod.params)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = export_jax_variables(mod.model, dict(zip(
        (name for name, _ in mod.model.named_parameters()), grads)))["params"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, ref in jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(flat_got[path], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6,
                                   err_msg=jax.tree_util.keystr(path))

    # two optimizer steps: the same losses and grad norms as the JAX module's
    for i, batch in enumerate(batches):
        state, want = jax_mod.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(i))
        got = mod.train_step(batch)
        assert int(got["step"]) == int(want["step"]) == i
        for key in ("loss", "grad_norm"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-5 * abs(float(want[key])), key


def test_gpt_optimizer_matches_optax():
    """clip 1.0 + AdamW(3e-4, b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1)
    on fixed gradients over 8 steps, one of them above the clip norm;
    within 1e-6."""
    rng = np.random.RandomState(1)
    shapes = [(6, 4), (5,), (3, 2, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * (0.5 if i != 3 else 3.0) / 4).astype(np.float32)
              for s in shapes] for i in range(8)]
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1))
    params = [jnp.asarray(x) for x in init]
    state = tx.init(params)
    leaves = [torch.from_numpy(x.copy()) for x in init]
    opt = gpt_optimizer(leaves)
    norms = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        norms.append(float(opt.step([torch.from_numpy(x) for x in g])))
        for leaf, want in zip(leaves, params):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        assert norms[-1] == pytest.approx(float(optax.global_norm(
            [jnp.asarray(x) for x in g])), rel=1e-6)
    assert min(norms) < 1.0 < max(norms)  # clipped on one step only


def test_train_module_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTTrainModule(_cfg(port_config))


def test_train_module_refuses_what_is_not_ported():
    mod = GPTTrainModule(_cfg(port_config, num_layers=1), device="cpu")
    tokens = np.zeros((2, 2, S), np.int32)
    with pytest.raises(NotImplementedError, match=r"\[A, B, S\]"):
        mod.train_step({"tokens": tokens, "labels": tokens})
    for field, value in (("attn_logit_softcapping", 50.0), ("qk_layernorm", True)):
        with pytest.raises(NotImplementedError, match=f"GPTConfig.{field}="):
            GPTTrainModule(dataclasses.replace(_cfg(port_config), **{field: value}),
                           device="cpu")


def test_train_step_refuses_batch_keys_it_does_not_take():
    """A batch with teacher_logits (a distillation batch, which the JAX step
    trains as (1-a) CE + a T^2 KL) raises until distillation is ported, where
    it trained plain CE; the usual keys still train, and a key set to None
    is no key (as the JAX step reads it)."""
    mod = GPTTrainModule(_cfg(port_config, num_layers=1), device="cpu")
    batch = _batches(1)[0]
    teacher = np.zeros(batch["tokens"].shape + (mod.cfg.vocab_size,), np.float32)
    with pytest.raises(NotImplementedError, match="teacher_logits"):
        mod.train_step({**batch, "teacher_logits": teacher})
    assert mod.step == 0
    metrics = mod.train_step({**batch, "loss_mask": np.ones(batch["tokens"].shape, np.float32),
                              "teacher_logits": None})
    assert mod.step == 1 and np.isfinite(float(metrics["loss"]))


def test_init_state_draws_the_seeds_parameters_again():
    cfg = _cfg(port_config, num_layers=1)
    mod = GPTTrainModule(cfg, device="cpu", seed=3)
    fresh = {k: v.clone() for k, v in mod.model.state_dict().items()}
    rng = np.random.RandomState(0)
    mod.train_step({k: rng.randint(0, 128, (2, S)) for k in ("tokens", "labels")})
    assert mod.step == 1 and not torch.equal(mod.model.embedding, fresh["embedding"])
    mod.init_state(seed=3)
    assert mod.step == 0 and mod.optimizer.count == 0
    for name, value in mod.model.state_dict().items():
        assert torch.equal(value, fresh[name]), name
