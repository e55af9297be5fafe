"""The port's GPT model (nemo_tpu_torch/models/llm/) against the JAX package.

- The config copy has the JAX fields and defaults; `rope_frequencies`,
  `_param_count` and `model_flops_per_token` equal JAX's exactly.
- A tiny Llama-style model (`tiny_test` with tied embeddings, llama3 RoPE at
  base 5e5), fp32, S = 128, weights carried from JAX by `load_jax_variables`
  from a scan-stacked and from an unrolled tree: the logits match JAX
  `GPTModel` (attention_backend "xla") within 1e-4, through the port's flash
  branch (the plain K5 on the CPU) and its einsum branch, and
  `export_jax_variables` gives the JAX tree back.
- Config values the port does not implement raise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nemo_tpu.llm import auto_configurator as jax_ac  # noqa: E402
from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm import gpt as jax_gpt  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables)
from nemo_tpu_torch.llm import auto_configurator as port_ac  # noqa: E402
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm import gpt as port_gpt  # noqa: E402

S = 128


def llama_tiny(module, **kw):
    return module.tiny_test(share_embeddings_and_output_weights=True, rope_scaling="llama3",
                            rotary_base=5e5, seq_length=S, remat="none", **kw)


def test_config_matches_jax():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(port_config.GPTConfig) == fields(jax_config.GPTConfig)
    for preset in ("tiny_test", "llama32_1b"):
        got = getattr(port_config, preset)(seq_length=2048)
        want = getattr(jax_config, preset)(seq_length=2048)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), preset


@pytest.mark.parametrize("scaling", ["llama3", None])
def test_rope_frequencies_equal_jax(scaling):
    kw = {} if scaling is None else {"rope_scaling": scaling}
    for port_cfg, jax_cfg in ((port_config.llama32_1b(seq_length=2048, **kw),
                               jax_config.llama32_1b(seq_length=2048, **kw)),
                              (port_config.tiny_test(**kw), jax_config.tiny_test(**kw))):
        got, want = port_gpt.rope_frequencies(port_cfg), jax_gpt.rope_frequencies(jax_cfg)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_flops_per_token_equal_jax():
    for preset in ("llama32_1b", "tiny_test"):
        got = getattr(port_config, preset)(seq_length=2048)
        want = getattr(jax_config, preset)(seq_length=2048)
        assert port_ac._param_count(got) == jax_ac._param_count(want)
        assert port_ac.model_flops_per_token(got) == jax_ac.model_flops_per_token(want)
    cfg = port_config.llama32_1b(seq_length=2048)
    assert port_ac._param_count(cfg) == 1_235_814_400
    assert abs(port_ac.model_flops_per_token(cfg) - 7.8175e9) < 1e5


def _jax_variables(cfg, tokens):
    variables = nn.meta.unbox(jax_gpt.GPTModel(cfg).init(jax.random.PRNGKey(0),
                                                         jnp.asarray(tokens)))
    # perturb the RMSNorm scales off 1 so that a misplaced scale shows
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * (1 + 0.1 * np.cos(np.arange(x.size).reshape(x.shape)))
        if getattr(p[-1], "key", None) == "scale" else x, variables["params"])
    return jax.device_get({"params": params})


@pytest.mark.parametrize("scan_layers,backend", [(True, "flash"), (False, "xla")])
def test_logits_match_jax(monkeypatch, scan_layers, backend):
    tokens = np.random.RandomState(0).randint(0, 128, (2, S)).astype(np.int32)
    jax_cfg = llama_tiny(jax_config, scan_layers=scan_layers)
    variables = _jax_variables(jax_cfg, tokens)
    want = np.asarray(jax_gpt.GPTModel(jax_cfg).apply(variables, jnp.asarray(tokens)))

    cfg = llama_tiny(port_config, scan_layers=scan_layers, attention_backend=backend)
    model = load_jax_variables(port_gpt.build_model(cfg, torch.device("cpu"), seed=1), variables)
    calls = []
    flash = port_gpt.flash_attention
    monkeypatch.setattr(port_gpt, "flash_attention",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert len(calls) == (cfg.num_layers if backend == "flash" else 0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    exported = export_jax_variables(model)
    assert jax.tree.structure(exported) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(exported), jax.tree.leaves(variables)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_flash_branch_needs_s_multiple_of_128(monkeypatch):
    """As gpt.py:632: at S = 96 the flash backend takes the einsum path."""
    cfg = llama_tiny(port_config, attention_backend="flash")
    model = port_gpt.build_model(cfg, torch.device("cpu"), seed=0)
    monkeypatch.setattr(port_gpt, "flash_attention", None)  # would raise if called
    with torch.no_grad():
        out = model(torch.zeros(1, 96, dtype=torch.long))
    assert out.shape == (1, 96, cfg.vocab_size)


@pytest.mark.parametrize("field,value", [("num_moe_experts", 4), ("qk_layernorm", True),
                                         ("remat", "dots"), ("normalization", "LayerNorm"),
                                         ("rope_scaling", "yarn"), ("activation", "gelu")])
def test_unsupported_config_raises(field, value):
    cfg = port_config.tiny_test(**{field: value})
    with pytest.raises(NotImplementedError, match=f"GPTConfig.{field}="):
        port_gpt.GPTModel(cfg)
