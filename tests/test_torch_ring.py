"""The port's context parallelism (nemo_tpu_torch/ops/ring_attention.py,
models/llm/gpt.py's ring branch, train.py's zig-zag reorder,
parallel/mesh.py) against the JAX package, all ranks in one process
(`LocalRing`).

- The zig-zag helpers give JAX's orders (`zigzag_chunk_ids`,
  `zigzag_shard`, `zigzag_unshard`, and train.py:196-199's positions).
- `ring_flash_attention` at cp 2 and cp 4 against JAX's
  `ring_flash_attention` inside `jax.shard_map` over
  `make_mesh(MeshConfig(dp=1, cp=cp), devices=jax.devices()[:cp])`, where
  JAX takes `xla_attention_positions` as its own CPU tests do: B=1, H=4
  over G=2, S=512, dh 64, fp32, zig-zag shards; the outputs and the
  gradients of q, k and v within 1e-5.
- A tiny Llama-style model (tiny_test at S=512, 2 layers, hidden 64, 4
  heads over 2, flash backend), fp32, B=2, weights carried from JAX: the
  port's cp 2 loss within 1e-5 relative and every leaf's gradient within
  1e-4 of its max-abs + 1e-6 of JAX's train.py:loss_fn at cp 2 (the
  zig-zag reorder, then the model with the fused CE) under the 2-device cp
  mesh, jitted; JAX's step compiles in a few seconds here.
- `check_supported` admits cp_size > 1; the ring is taken exactly where
  JAX's conditions (gpt.py:591-599) hold; MeshConfig resolves as JAX's.

The process-group ring (gloo processes) is tested in
tests/test_torch_ring_gloo.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm.gpt import GPTModel as JaxGPTModel  # noqa: E402
from nemo_tpu.models.llm.loss import fused_linear_cross_entropy as jax_fused_ce  # noqa: E402
from nemo_tpu.ops import ring_attention as jax_ring  # noqa: E402
from nemo_tpu.parallel import mesh as jax_mesh  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables)
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm import gpt as port_gpt  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402
from nemo_tpu_torch.ops import ring_attention as port_ring  # noqa: E402
from nemo_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

TOL = 1e-5
S = 512


def test_zigzag_helpers_match_jax():
    for cp in (1, 2, 4):
        np.testing.assert_array_equal(port_ring.zigzag_chunk_ids(cp),
                                      jax_ring.zigzag_chunk_ids(cp))
        x = np.arange(2 * 3 * 16 * cp, dtype=np.float32).reshape(2, 16 * cp, 3)
        for port_fn, jax_fn in ((port_ring.zigzag_shard, jax_ring.zigzag_shard),
                                (port_ring.zigzag_unshard, jax_ring.zigzag_unshard)):
            np.testing.assert_array_equal(port_fn(torch.from_numpy(x), cp).numpy(),
                                          np.asarray(jax_fn(jnp.asarray(x), cp)))
        clen = 32 * cp // (2 * cp)  # train.py:196-199
        want = np.concatenate([np.arange(i * clen, (i + 1) * clen)
                               for i in jax_ring.zigzag_chunk_ids(cp).reshape(-1)])
        np.testing.assert_array_equal(port_ring.zigzag_order(32 * cp, cp), want)


def _ring_inputs(seed, B=1, H=4, G=2, dh=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, h, S, dh).astype(np.float32) for h in (H, G, G, H)]  # q, k, v, do


@pytest.mark.parametrize("cp", [2, 4])
def test_ring_flash_attention_matches_jax_shard_map(cp):
    q, k, v, do = (port_ring.zigzag_shard(torch.from_numpy(x), cp, 2).numpy()
                   for x in _ring_inputs(seed=cp))
    pos = port_ring.zigzag_order(S, cp).astype(np.int32)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(dp=1, cp=cp), devices=jax.devices()[:cp])
    spec = P(None, None, "cp", None)

    def body(q, k, v, pos):
        return jax_ring.ring_flash_attention(q, k, v, pos, axis_name="cp", scale=0.125,
                                             causal=True, block_q=64, block_kv=64)

    ring = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, P("cp")), out_specs=spec,
                         check_vma=False)

    def f(q, k, v):
        o = ring(q, k, v, jnp.asarray(pos))
        return jnp.sum(o * jnp.asarray(do)), o

    (_, o_ref), want = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))

    Tl = S // cp
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    shards = [t.view(1, t.shape[1], cp, Tl, 64).permute(2, 0, 1, 3, 4) for t in (tq, tk, tv)]
    o = port_ring.ring_flash_attention(*shards, torch.from_numpy(pos).view(cp, Tl),
                                       port_ring.LocalRing(cp), scale=0.125)
    o = o.permute(1, 2, 0, 3, 4).reshape(q.shape)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=TOL, rtol=TOL)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


def _cfg(module, **kw):
    return module.tiny_test(seq_length=S, num_layers=2, hidden_size=64, num_attention_heads=4,
                            num_query_groups=2, attention_backend="flash", **kw)


def test_cp2_train_loss_and_gradients_match_jax():
    B = 2
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 128, (B, S)).astype(np.int32),
             "labels": rng.randint(0, 128, (B, S)).astype(np.int32),
             "loss_mask": (rng.rand(B, S) > 0.2).astype(np.float32)}
    jax_cfg = _cfg(jax_config, cp_size=2)
    variables = nn.meta.unbox(JaxGPTModel(dataclasses.replace(  # cp adds no parameter
        jax_cfg, cp_size=1, attention_backend="xla")).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["tokens"])))
    params = jax.device_get(variables["params"])
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(dp=1, cp=2), devices=jax.devices()[:2])

    def loss_fn(p, batch):  # train.py:loss_fn at cp 2: the zig-zag reorder, the fused-CE branch
        ids = jax_ring.zigzag_chunk_ids(2).reshape(-1)
        clen = S // 4
        order = np.concatenate([np.arange(i * clen, (i + 1) * clen) for i in ids])
        tokens, labels, mask = (batch[key][..., order] for key in ("tokens", "labels",
                                                                    "loss_mask"))
        positions = jnp.asarray(order, jnp.int32)[None, :].repeat(B, 0)
        hidden = JaxGPTModel(jax_cfg).apply({"params": p}, tokens, positions, train=True,
                                            output_hidden=True)
        w_vd = (p["embedding"] if jax_cfg.share_embeddings_and_output_weights
                else p["lm_head"]["kernel"].T)
        return jax_fused_ce(hidden, w_vd, labels, mask, chunk=jax_cfg.fused_ce_chunk)[0]

    with jax.set_mesh(mesh):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
            params, {key: jnp.asarray(val) for key, val in batch.items()})

    mod = GPTTrainModule(_cfg(port_config, cp_size=2), device="cpu")
    assert isinstance(mod.model.ring, port_ring.LocalRing) and mod.model.ring.size == 2
    load_jax_variables(mod.model, {"params": params})
    calls = []
    ring_fn = port_gpt.ring_flash_attention
    port_gpt.ring_flash_attention = lambda *a, **k: calls.append(1) or ring_fn(*a, **k)
    try:
        tb = {key: torch.from_numpy(val) for key, val in batch.items()}
        loss = mod.loss(tb["tokens"], tb["labels"], tb["loss_mask"])
        grads = torch.autograd.grad(loss, mod.params)
    finally:
        port_gpt.ring_flash_attention = ring_fn
    assert len(calls) == 2 * mod.cfg.num_layers  # the ring, forward and recompute
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = export_jax_variables(mod.model, dict(zip(
        (name for name, _ in mod.model.named_parameters()), grads)))["params"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, ref in jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(flat_got[path], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6,
                                   err_msg=jax.tree_util.keystr(path))


class _OneRankOfTwo:
    """A ring of 2 ranks of which this process holds one, as a
    ProcessGroupRing is, without a process group (never shifted here)."""
    size, rank, held = 2, 0, 1


def test_ring_is_taken_where_jax_takes_it():
    """JAX takes the ring (gpt.py:591-599) where cp_size > 1, no segment ids
    and (S // cp) % 128 == 0; otherwise it takes the flash or einsum path
    over the whole sequence, which masks a zig-zag-reordered batch wrongly.
    The port takes the ring under the same conditions and refuses every
    other cp > 1 batch, all ranks in one process or one a process, so that
    a train step at S = 384 (shards of 192) raises instead of training on
    the wrong prefix."""
    port_gpt.check_supported(_cfg(port_config, cp_size=2))
    with torch.device("meta"):
        model = port_gpt.GPTModel(_cfg(port_config, cp_size=2))  # LocalRing(2), the default
        shard = port_gpt.GPTModel(_cfg(port_config, cp_size=2), _OneRankOfTwo())
        plain = port_gpt.GPTModel(_cfg(port_config))
    assert isinstance(model.ring, port_ring.LocalRing) and model.ring.size == 2
    seg = torch.ones(1, S, dtype=torch.int32)
    assert model.uses_ring(512, None) and model.uses_ring(256, None)
    assert shard.uses_ring(256, None)
    assert not plain.uses_ring(512, None)  # cp 1: no ring
    for m, length, ids in ((model, 512, seg), (model, 384, None),  # packed; Tl 192
                           (shard, 256, seg[:, :256]), (shard, 192, None)):
        with pytest.raises(NotImplementedError, match="needs the ring"):
            m.uses_ring(length, ids)
    mod = GPTTrainModule(dataclasses.replace(_cfg(port_config, cp_size=2), seq_length=384),
                         device="cpu")
    tokens = np.zeros((1, 384), np.int32)
    with pytest.raises(NotImplementedError, match="needs the ring"):
        mod.train_step({"tokens": tokens, "labels": tokens})
    with pytest.raises(ValueError, match="a ring of 2 ranks for cp_size 4"):
        port_gpt.GPTModel(_cfg(port_config, cp_size=4), port_ring.LocalRing(2))


def test_mesh_config_resolves_as_jax():
    for kw, n in (({}, 4), ({"cp": 2}, 4), ({"cp": 2, "dp": 2}, 4), ({"tp": 2, "cp": 2}, 8)):
        assert dataclasses.asdict(port_mesh.MeshConfig(**kw).resolved(n)) == dataclasses.asdict(
            jax_mesh.MeshConfig(**kw).resolved(n))
    for kw, n in (({"cp": 3}, 4), ({"dp": 3, "cp": 2}, 4)):
        with pytest.raises(ValueError):
            port_mesh.MeshConfig(**kw).resolved(n)
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_mesh(port_mesh.MeshConfig(cp=2))
