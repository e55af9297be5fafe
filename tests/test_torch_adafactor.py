"""The port's Adafactor chain (nemo_tpu_torch/core/optim.py:ClippedAdafactor,
`clip_adafactor`) and the JAX leaf layout it runs on
(interop/jax_params.py:jax_leaf_groups) against optax and the JAX package,
on the CPU.

- `optax.chain(clip_by_global_norm(1.0), adafactor(3e-4))` over 8 steps on
  fixed gradients, one step above the clip: every parameter within 1e-6
  (absolute, parameters of rms ~0.05), the norms within 1e-6 relative.
  The leaves are stacked [L, ...] JAX leaves made of per-layer tensors in
  the port's layout: one unfactored in JAX whose per-layer [out, in] view
  would be factored, factored ones with d1 > d0 and with d1 < d0, an
  unstacked one and a 1-d stack.
- The global norm of one large gradient (16.8 M values) within 1e-6
  relative of its fp64 norm, under both chains.
- The leaf groups carry the paths and shapes of the JAX model's tree, in
  the stacked (scan_layers) and the unrolled layout.
- Two `GPTTrainModule.train_step`s of a GPT with dims >= 128 (hidden 256,
  2 heads x dh 128, FFN 512, vocab 512, 2 layers, S=128, fp32) under the
  chain, from JAX's weights: the losses and grad norms within 1e-5
  relative of JAX's `GPTTrainModule(optimizer=...)`, and the optimizer
  state after them (v_row, v_col on the factored leaves, v on the others)
  within 1e-5 of its leaf's max, leaf by leaf.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from optax._src.factorized import FactoredState  # noqa: E402

from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm.gpt import GPTModel as JaxGPTModel  # noqa: E402
from nemo_tpu.models.llm.train import GPTTrainModule as JaxGPTTrainModule  # noqa: E402
from nemo_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from nemo_tpu_torch.core.optim import (  # noqa: E402
    ClippedAdafactor, clip_adafactor, constant_schedule)
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    LeafGroup, jax_leaf_groups, load_jax_variables)
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm.gpt import GPTModel  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402

B, S = 2, 128


def _cfg(module, **kw):
    return module.tiny_test(hidden_size=256, num_attention_heads=2, num_query_groups=2,
                            ffn_hidden_size=512, vocab_size=512, num_layers=2, seq_length=S,
                            **kw)


# (name, layers stacked (0: one unstacked leaf), the port's part shape, the
# JAX part shape, the part is a Linear weight [out, in])
LEAVES = [("qkv_split", 2, (128, 256), (256, 4, 32), True),  # [2, 256, 4, 32]: not factored
          ("q_proj", 2, (256, 256), (256, 2, 128), True),    # [2, 256, 2, 128]: d1 3 > d0 1
          ("fc1", 2, (512, 128), (128, 512), True),          # [2, 128, 512]: d1 1 < d0 2
          ("embedding", 0, (512, 256), (512, 256), False),   # [512, 256]: d1 1 > d0 0
          ("norm", 2, (256,), (256,), False)]                # [2, 256]: not factored


def _to_jax(x, transposed, part_shape):
    return (x.T if transposed else x).reshape(part_shape)


def test_adafactor_matches_optax_on_stacked_leaves():
    rng = np.random.RandomState(0)
    leaves, groups, jax_params = [], [], {}
    for name, L, shape, part, transposed in LEAVES:
        parts, index = [], []
        for _ in range(max(L, 1)):
            x = (rng.randn(*shape) * 0.05).astype(np.float32)
            index.append(len(leaves))
            leaves.append(torch.from_numpy(x.copy()))
            parts.append(_to_jax(x, transposed, part))
        jax_params[name] = np.stack(parts) if L else parts[0]
        groups.append(LeafGroup((name,), jax_params[name].shape, part, tuple(index), transposed,
                                bool(L)))
    opt = ClippedAdafactor(leaves, groups, constant_schedule(3e-4))
    assert opt.factored == [None, (3, 1), (1, 2), (1, 0), None]

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(3e-4))
    params = {k: jnp.asarray(v) for k, v in jax_params.items()}
    state = tx.init(params)
    update = jax.jit(tx.update)
    norms = []
    for step in range(8):
        grads = {k: (rng.randn(*v.shape) * (0.05 if step == 3 else 0.001)).astype(np.float32)
                 for k, v in jax_params.items()}
        port_grads = []
        for name, L, shape, part, transposed in LEAVES:
            for layer in range(max(L, 1)):
                g = grads[name][layer] if L else grads[name]
                g = g.reshape(shape[::-1]).T if transposed else g.reshape(shape)
                port_grads.append(torch.from_numpy(np.ascontiguousarray(g)))
        updates, state = update({k: jnp.asarray(v) for k, v in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        norms.append(float(opt.step(port_grads)))
        assert norms[-1] == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for (name, L, shape, part, transposed), group in zip(LEAVES, groups):
            got = [_to_jax(leaves[i].numpy(), transposed, part) for i in group.index]
            got = np.stack(got) if L else got[0]
            np.testing.assert_allclose(got, np.asarray(params[name]), rtol=0, atol=1e-6,
                                       err_msg=f"{name}, step {step}")
    assert sum(n > 1.0 for n in norms) == 1  # clipped on one step only


@pytest.mark.parametrize("chain", ["adafactor", "adamw"])
def test_global_norm_of_a_large_leaf(chain):
    """The clip's global norm of one [4096, 4096] gradient (16.8 M values,
    as large as the 1B model's MLP leaves) within 1e-6 relative of its fp64
    norm, for both chains on the CPU (torch's own fp32 norm there is ~1e-3
    off at this size)."""
    from nemo_tpu_torch.core.optim import ClippedAdamW

    gen = torch.Generator().manual_seed(0)
    leaf = torch.randn(4096, 4096, generator=gen) * 0.02
    grad = torch.randn(4096, 4096, generator=gen) * torch.exp(torch.randn(4096, generator=gen))
    if chain == "adafactor":
        group = LeafGroup(("w",), (4096, 4096), (4096, 4096), (0,), False, False)
        opt = ClippedAdafactor([leaf], [group], constant_schedule(3e-4))
    else:
        opt = ClippedAdamW([leaf], constant_schedule(3e-4), max_norm=1.0)
    want = float(torch.linalg.vector_norm(grad.double()))
    assert float(opt.step([grad])) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_leaf_groups_follow_the_jax_tree(scan_layers):
    """Paths and shapes of the leaf groups equal the JAX model's parameter
    tree; the parts are every parameter of the port's model once."""
    jax_cfg = _cfg(jax_config, scan_layers=scan_layers, share_embeddings_and_output_weights=False)
    abstract = jax.eval_shape(lambda r: nn.meta.unbox(JaxGPTModel(jax_cfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"]), jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    with torch.device("meta"):
        model = GPTModel(_cfg(port_config, scan_layers=scan_layers,
                              share_embeddings_and_output_weights=False))
    groups = jax_leaf_groups(model)
    assert {g.path: g.shape for g in groups} == want
    assert sorted(i for g in groups for i in g.index) == list(range(len(list(model.parameters()))))
    assert all(g.stacked == (scan_layers and g.path[0] == "layers") for g in groups)


def _factored_state(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, FactoredState)) if isinstance(s, FactoredState)]
    assert len(found) == 1
    return found[0]


def test_train_steps_with_adafactor_match_jax():
    jax_cfg = _cfg(jax_config)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(3e-4))
    jax_mod = JaxGPTTrainModule(jax_cfg, mesh=make_mesh(MeshConfig(), jax.devices()[:1]),
                                optimizer=tx)
    state = jax_mod.init_state(seed=0)
    params = jax.device_get(nn.meta.unbox(state.params))

    mod = GPTTrainModule(_cfg(port_config, attention_backend="flash", remat="full"),
                         device="cpu", optimizer=clip_adafactor(3e-4))
    load_jax_variables(mod.model, {"params": params})
    rng = np.random.RandomState(0)
    for i in range(2):
        batch = {k: rng.randint(0, 512, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
        state, want = jax_mod.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(i))
        got = mod.train_step(batch)
        for key in ("loss", "grad_norm"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-5 * abs(float(want[key])), key
    assert mod.optimizer.count == 2 and got["lr"] == pytest.approx(3e-4)

    ref = _factored_state(state.opt_state)
    flat = {name: {tuple(k.key for k in path): np.asarray(x)
                   for path, x in jax.tree_util.tree_leaves_with_path(getattr(ref, name))}
            for name in ("v_row", "v_col", "v")}
    opt = mod.optimizer
    for k, group in enumerate(opt.groups):
        factored = opt.factored[k] is not None
        for name, ours in (("v_row", opt.v_row[k]), ("v_col", opt.v_col[k]), ("v", opt.v[k])):
            theirs = flat[name][group.path]
            if ours is None:  # optax keeps a zeros((1,)) placeholder there
                assert theirs.shape == (1,) and factored == (name == "v")
                continue
            assert ours.shape == theirs.shape, (group.path, name)
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                       atol=1e-5 * np.abs(theirs).max(),
                                       err_msg=f"{group.path} {name}")
    # the split: every stacked projection and the embedding factored, the norms not
    split = {g.path[-2] if g.path[-1] in ("kernel", "scale") else g.path[-1]:
             opt.factored[k] is not None for k, g in enumerate(opt.groups)}
    assert split == {"embedding": True, "q_proj": True, "k_proj": True, "v_proj": True,
                     "o_proj": True, "fc1": True, "fc2": True, "lm_head": True, "input_norm": False,
                     "post_attn_norm": False, "final_norm": False}


def test_train_module_optimizer_factory_is_rebuilt_by_init_state():
    cfg = dataclasses.replace(_cfg(port_config), num_layers=1, hidden_size=128, vocab_size=128)
    mod = GPTTrainModule(cfg, device="cpu", optimizer=clip_adafactor(1e-3))
    first = mod.optimizer
    tokens = np.zeros((1, S), np.int32)
    mod.train_step({"tokens": tokens, "labels": tokens})
    mod.init_state(seed=1)
    assert mod.optimizer is not first and mod.optimizer.count == 0
    assert mod.optimizer.schedule(0) == pytest.approx(1e-3)
