"""Phi-3-mini-4k in the port (nemo_tpu_torch/models/llm/config.py:
phi3_mini_4k, llm/recipes.py, interop/hf_llama.py, interop/hf_models.py)
against the JAX package.

- The preset and the recipes (`phi3_mini_4k`, `phi3_mini_4k_instruct`, and
  `finetune_recipe("phi3_mini_4k", peft_scheme="none")`) field by field.
- A Phi-3-shaped tiny model (2 layers, hidden 192 over 2 heads of dh 96, no
  query groups, FFN 512, vocab 256, untied head, S=256, the flash backend),
  fp32, weights carried from JAX through `interop/jax_params.py`: the
  logits within 1e-4, the fused-CE loss within 1e-5 relative and every
  leaf's gradient within 1e-4 of its max-abs plus 1e-6, once on a plain
  batch and once on a packed one (segment ids, per-segment positions). JAX
  takes its Pallas kernels (`flash_attention`, `flash_attention_packed`) in
  interpret mode, unrolled and without remat (interpret-mode Pallas does not
  run under remat and scan, tests/test_flash_attention.py:75); the port
  takes K5-K10's plain versions on the CPU.
- The HF importer on a synthesized phi3 state dict (fused `qkv_proj` and
  `gate_up_proj`): the port's `import_hf_model` gives JAX's config and, as
  the JAX tree, JAX's parameters; `export_hf_llama_state` gives JAX's export
  and converts back to the same state.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.interop import hf_llama as jax_hf_llama  # noqa: E402
from nemo_tpu.interop.hf_models import import_hf_model as jax_import_hf_model  # noqa: E402
from nemo_tpu.llm.recipes import RECIPES as JAX_RECIPES  # noqa: E402
from nemo_tpu.llm.recipes import finetune_recipe as jax_finetune_recipe  # noqa: E402
from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm.gpt import GPTModel as JaxGPTModel  # noqa: E402
from nemo_tpu.models.llm.loss import fused_linear_cross_entropy as jax_fused_ce  # noqa: E402
from nemo_tpu_torch.data.packed_sequence import pack_batch  # noqa: E402
from nemo_tpu_torch.interop import hf_llama  # noqa: E402
from nemo_tpu_torch.interop.hf_models import import_hf_model  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables)
from nemo_tpu_torch.llm import recipes as port_recipes  # noqa: E402
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm import gpt as port_gpt  # noqa: E402
from nemo_tpu_torch.models.llm.gpt import GPTModel  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402

B, S = 2, 256
TINY = dict(num_layers=2, hidden_size=192, ffn_hidden_size=512, num_attention_heads=2,
            vocab_size=256, seq_length=S, compute_dtype="float32", fused_ce_chunk=96)


def test_preset_matches_jax():
    for kw in ({}, TINY):
        port, ref = port_config.phi3_mini_4k(**kw), jax_config.phi3_mini_4k(**kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = port_config.phi3_mini_4k()
    assert (cfg.head_dim, cfg.n_kv_heads, cfg.share_embeddings_and_output_weights) == (96, 32,
                                                                                       False)
    port_gpt.check_supported(cfg)


def _recipe_fields(r):
    return {f: getattr(r, f) for f in ("name", "global_batch_size", "micro_batch_size", "lr",
                                       "min_lr", "warmup_steps", "max_steps")}


def test_recipes_match_jax():
    for name in ("phi3_mini_4k", "phi3_mini_4k_instruct"):
        port, ref = port_recipes.RECIPES[name](), JAX_RECIPES[name]()
        assert _recipe_fields(port) == _recipe_fields(ref)
        assert (port.seq_length, port.family) == (ref.seq_length, ref.family)
        assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    port = port_recipes.finetune_recipe("phi3_mini_4k", peft_scheme="none")
    ref = jax_finetune_recipe("phi3_mini_4k", peft_scheme="none")
    assert _recipe_fields(port) == _recipe_fields(ref)
    assert (port.peft, port.packed) == (ref.peft, ref.packed) == (None, True)
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert (port.model.seq_length, port.global_batch_size, port.lr) == (2048, 128, 5e-6)


def _batch(packed: bool):
    """Two rows of S tokens: random ones, or samples of 20-120 tokens packed
    (answer-only loss on each sample's last third) with a padding tail."""
    rng = np.random.RandomState(5 if packed else 4)
    if not packed:
        mask = np.ones((B, S), np.float32)
        mask[1, 200:] = 0.0
        return {"tokens": rng.randint(0, 256, (B, S)).astype(np.int32),
                "labels": rng.randint(0, 256, (B, S)).astype(np.int32), "loss_mask": mask}
    lengths = rng.randint(20, 121, 7)
    seqs = [rng.randint(1, 256, n).astype(np.int32) for n in lengths]
    labels = [rng.randint(1, 256, n).astype(np.int32) for n in lengths]
    masks = [(np.arange(n) >= 2 * n // 3).astype(np.float32) for n in lengths]
    out = {key: val[:B] for key, val in pack_batch(seqs, labels, masks, S).items()}
    assert (out["segment_ids"] == 0).any() and out["segment_ids"].max() >= 3
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_tiny_phi3_matches_jax_flash_interpret(packed):
    batch = _batch(packed)
    kw = dict(TINY, attention_backend="flash", remat="none", scan_layers=False)
    jax_cfg = jax_config.phi3_mini_4k(**kw)
    jb = {key: jnp.asarray(val) for key, val in batch.items()}
    extra = ({"positions": jb["positions"], "segment_ids": jb["segment_ids"]} if packed else {})
    model = JaxGPTModel(jax_cfg)
    with pltpu.force_tpu_interpret_mode():
        params = jax.device_get(nn.meta.unbox(model.init(jax.random.PRNGKey(0), jb["tokens"])))
        params = params["params"]
        want_logits = np.asarray(model.apply({"params": params}, jb["tokens"], **extra))

        def loss_fn(p):  # train.py:loss_fn, the fused-CE branch with an untied head
            hidden = model.apply({"params": p}, jb["tokens"], output_hidden=True, **extra)
            return jax_fused_ce(hidden, p["lm_head"]["kernel"].T, jb["labels"], jb["loss_mask"],
                                chunk=jax_cfg.fused_ce_chunk)[0]

        want_loss, want_grads = jax.value_and_grad(loss_fn)(params)

    mod = GPTTrainModule(port_config.phi3_mini_4k(**kw), device="cpu")
    load_jax_variables(mod.model, {"params": params})
    tb = {key: torch.from_numpy(val) for key, val in batch.items()}
    args = (tb["positions"], tb["segment_ids"]) if packed else ()
    calls = []
    name = "flash_attention_packed" if packed else "flash_attention"
    fn = getattr(port_gpt, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_gpt, name, lambda *a, **k: calls.append(a[0].shape[-1]) or fn(*a, **k))
        with torch.no_grad():
            logits = mod.model(tb["tokens"], *args)
        loss = mod.loss(tb["tokens"], tb["labels"], tb["loss_mask"], *args)
        grads = torch.autograd.grad(loss, mod.params)
    assert calls == [96] * (2 * jax_cfg.num_layers)  # the flash branch at dh 96
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-4, rtol=0)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = export_jax_variables(mod.model, dict(zip(
        (n for n, _ in mod.model.named_parameters()), grads)))["params"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads))
    assert len(flat_got) == len(want)
    for path, ref in want:
        ref = np.asarray(ref)
        np.testing.assert_allclose(flat_got[path], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6,
                                   err_msg=jax.tree_util.keystr(path))


HF_CFG = types.SimpleNamespace(
    model_type="phi3", hidden_size=192, intermediate_size=512, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=2, vocab_size=256, max_position_embeddings=4096,
    rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False)


def _phi3_state(seed: int = 0):
    """A phi3 HF state dict of numpy arrays, q, k, v and gate, up fused."""
    c, rng = HF_CFG, np.random.RandomState(seed)
    D, F, V = c.hidden_size, c.intermediate_size, c.vocab_size
    dh = D // c.num_attention_heads
    qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * dh

    def w(*shape):
        return rng.randn(*shape).astype(np.float32) * 0.02

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
          "lm_head.weight": w(V, D)}
    for i in range(c.num_hidden_layers):
        pre = f"model.layers.{i}"
        sd.update({f"{pre}.input_layernorm.weight": 1 + w(D),
                   f"{pre}.post_attention_layernorm.weight": 1 + w(D),
                   f"{pre}.self_attn.qkv_proj.weight": w(qkv, D),
                   f"{pre}.self_attn.o_proj.weight": w(D, D),
                   f"{pre}.mlp.gate_up_proj.weight": w(2 * F, D),
                   f"{pre}.mlp.down_proj.weight": w(D, F)})
    return sd


class _HFModel:
    """What JAX's import_hf_model reads of a loaded HF model."""

    def __init__(self, config, sd):
        self.config, self._sd = config, sd

    def state_dict(self):
        return {k: torch.from_numpy(v) for k, v in self._sd.items()}


def test_hf_phi3_import_and_export_match_jax():
    sd = _phi3_state()
    want_cfg, want_params = jax_import_hf_model(_HFModel(HF_CFG, sd))
    cfg, state = import_hf_model(HF_CFG, sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert cfg.head_dim == 96 and not cfg.share_embeddings_and_output_weights
    model = GPTModel(cfg)
    model.load_state_dict(state)
    got = dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model)["params"]))
    want = jax.tree_util.tree_leaves_with_path(want_params)
    assert len(got) == len(want)
    for path, ref in want:
        np.testing.assert_array_equal(got[path], np.asarray(ref),
                                      err_msg=jax.tree_util.keystr(path))
    exported = hf_llama.export_hf_llama_state(model.state_dict(), cfg)
    want_export = jax_hf_llama.export_hf_llama_state(want_params, want_cfg)
    assert sorted(exported) == sorted(want_export)
    for key, ref in want_export.items():
        np.testing.assert_array_equal(exported[key], ref, err_msg=key)
    back = hf_llama.params_from_hf_state(exported, cfg)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key


def test_hf_import_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="transformers"):
        import_hf_model("microsoft/Phi-3-mini-4k-instruct")
    for model_type in ("starcoder2", "deepseek_v3"):
        with pytest.raises(NotImplementedError, match=model_type):
            import_hf_model(types.SimpleNamespace(model_type=model_type), {})
    sd = _phi3_state()
    sd["model.layers.0.self_attn.o_proj.bias"] = np.zeros(192, np.float32)
    with pytest.raises(NotImplementedError, match="biases"):
        import_hf_model(HF_CFG, sd)
