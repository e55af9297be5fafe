"""Conformer modules of the PyTorch port against the JAX package, on weights
carried across with `load_jax_variables`: one ConformerLayer with
non-trivial BatchNorm running stats and non-zero biases, in fp32 (1e-4), for
both attention forms, and the LayerNorm epsilon the port must copy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nemo_tpu.models.asr.modules.conformer import ConformerLayer as JaxConformerLayer  # noqa: E402
from nemo_tpu_torch.interop.jax_params import load_jax_variables  # noqa: E402
from nemo_tpu_torch.models.asr.modules.conformer import (  # noqa: E402
    ConformerLayer, RelPositionalEncoding)


def perturb(tree, rng):
    """Seeded, non-trivial values for the leaves a fresh init leaves flat:
    biases, pos_bias_u/v, norm scales and BatchNorm running stats."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
            continue
        v = np.asarray(v)
        if k == "var":
            v = 0.5 + rng.rand(*v.shape)
        elif k in ("mean", "bias", "pos_bias_u", "pos_bias_v"):
            v = v + 0.2 * rng.randn(*v.shape)
        elif k == "scale":
            v = 1.0 + 0.2 * rng.randn(*v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("att_impl", ["decomposed", "decomposed_flash"])
def test_conformer_layer_matches_jax(att_impl):
    B, T, D, H = 2, 23, 32, 4
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.array([23, 14], np.int32)
    pad_mask = np.arange(T)[None, :] < lens[:, None]
    _, pos_emb = RelPositionalEncoding(D)(torch.zeros(1, T, D))

    jl = JaxConformerLayer(d_model=D, n_heads=H, conv_kernel_size=7, att_impl=att_impl)
    args = (jnp.asarray(x), jnp.asarray(pos_emb.numpy())[None], jnp.asarray(pad_mask))
    variables = perturb(jax.device_get(jl.init(jax.random.PRNGKey(0), *args)), rng)
    assert set(variables) == {"params", "batch_stats"}
    ref = np.asarray(jl.apply(variables, *args))

    layer = ConformerLayer(D, H, conv_kernel_size=7, att_impl=att_impl)
    load_jax_variables(layer, variables)
    with torch.no_grad():
        out = layer(torch.from_numpy(x), pos_emb, torch.from_numpy(lens),
                    torch.from_numpy(pad_mask)).numpy()
    for b, n in enumerate(lens):  # padded query rows are garbage on both sides
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=1e-4, rtol=1e-4)


def test_layer_norms_use_the_flax_epsilon():
    layer = ConformerLayer(16, 2, conv_kernel_size=3)
    assert {m.eps for m in layer.modules() if isinstance(m, torch.nn.LayerNorm)} == {1e-6}
    assert layer.conv.norm.eps == 1e-5
