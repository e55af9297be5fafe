"""The port's GPT with quantization="fp8" (nemo_tpu_torch/ops/quant.py:
TrainingQuantDense in every projection) against the JAX package, on the CPU.

A small model with dims >= 128 (hidden 256, 2 heads x dh 128, FFN 512,
vocab 512, S=128, fp32 compute, AdamW). Both sides take the einsum
attention: the port's flash path (plain on the CPU) sums in another order,
~1e-7 apart, and an activation that lands that close to an e4m3 rounding
midpoint then rounds to the neighbouring code (a tie flip), which moved
the loss by 1.8e-5 relative (2.3e-7 with the einsum path).
- With JAX's quantised operands replayed: the loss within 1e-6 relative
  and every gradient within 1e-4 of its leaf's max-abs plus 1e-6.
- Two `GPTTrainModule.train_step`s, each side with its own quantisations:
  the losses within 1e-4 and the grad norms within 1e-2 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm.gpt import GPTModel as JaxGPTModel  # noqa: E402
from nemo_tpu.models.llm.loss import fused_linear_cross_entropy as jax_fused_ce  # noqa: E402
from nemo_tpu.models.llm.train import GPTTrainModule as JaxGPTTrainModule  # noqa: E402
from nemo_tpu.ops import quant as jax_quant  # noqa: E402
from nemo_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables)
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402
from nemo_tpu_torch.ops import quant  # noqa: E402

SMALL = dict(hidden_size=256, num_attention_heads=2, num_query_groups=2, ffn_hidden_size=512,
             vocab_size=512, num_layers=2, seq_length=128, quantization="fp8")


def _codes(q: torch.Tensor) -> torch.Tensor:
    """fp8 or int8 codes as ints: sign-magnitude for fp8, so that adjacent
    values of one sign differ by 1."""
    if q.dtype == torch.int8:
        return q.int()
    c = q.view(torch.uint8).int()
    return torch.where(c >= 128, -(c - 128), c)


def test_fp8_gradients_match_jax_replaying_its_quantised_operands():
    """fp8 loss and gradients of the small model cut to one layer and B=1
    (fp32, unrolled, no remat, einsum attention on both sides) against `jax.value_and_grad` of
    JAX's fused-CE loss, run eagerly so that every quantisation JAX makes
    (forward e4m3, backward e5m2) is recorded. The port replays them: each
    of its quantize calls takes the recorded (q, scale) of the same dtype
    and size nearest its input, after checking that its own codes differ
    from JAX's by at most one step (a rounding tie flipped by ~1e-7 of
    summation order) and its scale by at most 1e-6 relative. With JAX's
    operands, the loss within 1e-6 relative and every gradient within 1e-4
    of its leaf's max-abs plus 1e-6. Unreplayed, a flipped e5m2 code (25 %
    of its value) avalanches: a 1e-7 relative change of the embedding moves
    the port's own fp8 gradients by ~10 %."""
    cfg_kw = dict(SMALL, scan_layers=False, num_layers=1)  # JAX runs op by op here
    jax_cfg = jax_config.tiny_test(**cfg_kw)
    abstract = jax.eval_shape(lambda r: nn.meta.unbox(JaxGPTModel(jax_cfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"]), jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(  # normal(0.02), the norm scales 1
        lambda path, spec: (np.ones(spec.shape) if path[-1].key == "scale" else
                            rng.normal(0.0, 0.02, spec.shape)).astype(np.float32), abstract)
    tokens, labels = (rng.randint(0, 512, (1, 128)).astype(np.int32) for _ in range(2))
    record, quantize = [], jax_quant.quantize

    def recording(x, dtype):
        q, scale = quantize(x, dtype)
        q_np = np.array(q)  # codes as uint8 (torch reads no ml_dtypes array), values as fp32
        record.append((q_np.view(np.uint8), q_np.astype(np.float32), float(scale),
                       str(q_np.dtype)))
        return q, scale

    def loss_fn(p):
        hidden = JaxGPTModel(jax_cfg).apply({"params": p}, jnp.asarray(tokens), output_hidden=True)
        return jax_fused_ce(hidden, p["lm_head"]["kernel"].T, jnp.asarray(labels), None,
                            chunk=jax_cfg.fused_ce_chunk)[0]

    jax_quant.quantize = recording
    try:
        want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    finally:
        jax_quant.quantize = quantize
    assert len(record) == 2 * 6 + 6  # x and w of 6 forward products, g of their backwards

    mod = GPTTrainModule(port_config.tiny_test(attention_backend="xla", remat="none", **cfg_kw),
                         device="cpu")
    load_jax_variables(mod.model, {"params": params})
    unused, flips = list(range(len(record))), [0, 0]

    def replaying(x, dtype):
        ours, scale = own_quantize(x, dtype)
        cands = [i for i in unused if record[i][0].size == x.numel()
                 and str(dtype) == f"torch.{record[i][3]}"]
        deq = [torch.from_numpy(record[i][1]).reshape(x.shape) * record[i][2] for i in cands]
        best = min(range(len(cands)), key=lambda j: float((deq[j] - x.float()).norm()))
        i = cands[best]
        unused.remove(i)
        theirs = torch.from_numpy(record[i][0]).reshape(x.shape).view(dtype)
        assert abs(float(scale) - record[i][2]) <= 1e-6 * record[i][2]
        step = (_codes(ours) - _codes(theirs)).abs()
        assert int(step.max()) <= 1, "a code moved by more than one step"
        flips[0] += int((step > 0).sum())
        flips[1] += step.numel()
        return theirs, torch.tensor(record[i][2], dtype=torch.float32)

    own_quantize = quant.quantize
    quant.quantize = replaying
    try:
        loss = mod.loss(torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
        grads = torch.autograd.grad(loss, mod.params)
    finally:
        quant.quantize = own_quantize
    assert not unused
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    got = export_jax_variables(mod.model, dict(zip(
        (name for name, _ in mod.model.named_parameters()), grads)))["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, ref in jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(flat[path], ref, rtol=0, atol=1e-4 * np.abs(ref).max() + 1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert flips[0] < 1e-3 * flips[1]


def test_fp8_train_steps_match_jax():
    """Two steps, each side with its own quantisations: the losses within
    1e-4 relative and the grad norms within 1e-2 relative. Tie flips
    (see the replay test) avalanche through the fp8 backward: a 1e-7
    relative change of the embedding moved the port's own fp8 grad norm by
    1.4e-5 to 5.5e-3 over three draws; JAX and the port read 2.3e-7 and
    4.9e-4 apart at step 0, 2.0e-5 and 9.8e-5 at step 1."""
    kw = SMALL
    jax_mod = JaxGPTTrainModule(jax_config.tiny_test(**kw),
                                mesh=make_mesh(MeshConfig(), jax.devices()[:1]))
    state = jax_mod.init_state(seed=0)
    mod = GPTTrainModule(port_config.tiny_test(attention_backend="xla", remat="full", **kw),
                         device="cpu")
    load_jax_variables(mod.model, {"params": jax.device_get(nn.meta.unbox(state.params))})
    rng = np.random.RandomState(0)
    for i in range(2):
        batch = {k: rng.randint(0, 512, (2, 128)).astype(np.int32) for k in ("tokens", "labels")}
        state, want = jax_mod.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(i))
        got = mod.train_step(batch)
        for key, tol in (("loss", 1e-4), ("grad_norm", 1e-2)):
            assert abs(float(got[key]) - float(want[key])) <= tol * abs(float(want[key])), key
