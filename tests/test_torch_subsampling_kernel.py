"""Fused striding subsampling of the PyTorch port (K2, nemo_tpu_torch/ops/
subsampling_kernel.py) against the JAX package.

On the CPU the wrapper runs its plain version (the F.conv2d pair). It is held
against the Pallas kernel in interpret mode, which rounds conv2's operands to
bf16 (hence atol 5e-3 / rtol 1e-2, as the JAX package's own test), and
against the XLA conv pair in fp32 (1e-5); in bf16 both round conv1's output
to bf16 and sum in fp32 (1e-2). The CUDA kernel is checked against
the plain version on the card by tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.models.asr.modules.conformer import ConvSubsampling as JaxConvSubsampling  # noqa: E402
from nemo_tpu.ops.subsampling_kernel import fused_subsampling_x4 as jax_fused  # noqa: E402
from nemo_tpu_torch.interop.jax_params import load_jax_variables  # noqa: E402
from nemo_tpu_torch.models.asr.modules.conformer import ConvSubsampling  # noqa: E402
from nemo_tpu_torch.ops.subsampling_kernel import (  # noqa: E402
    fused_subsampling_x4, fused_subsampling_x4_plain)


def _inputs(B, T, F, C, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, F).astype(np.float32),
            (rng.randn(3, 3, 1, C) * 0.1).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32),
            (rng.randn(3, 3, C, C) * 0.05).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32)]


def _xla_pair(x, w1, b1, w2, b2):
    dn = ("NHWC", "HWIO", "NHWC")
    h = jax.lax.conv_general_dilated(x[..., None], w1, (2, 2), [(1, 1), (1, 1)],
                                     dimension_numbers=dn, precision="highest")
    h = jnp.maximum(h + b1, 0)
    h = jax.lax.conv_general_dilated(h, w2, (2, 2), [(1, 1), (1, 1)],
                                     dimension_numbers=dn, precision="highest")
    h = jnp.maximum(h + b2, 0)
    B, T, F, C = h.shape
    return h.reshape(B, T, F * C)


@pytest.mark.parametrize("T,F", [(99, 80), (64, 40), (30, 81)])
def test_plain_matches_jax(T, F):
    args = _inputs(2, T, F, 32)
    out = fused_subsampling_x4_plain(*map(torch.from_numpy, args)).numpy()
    ref = np.asarray(_xla_pair(*map(jnp.asarray, args)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_fused(*map(jnp.asarray, args), block_t=8))
    np.testing.assert_allclose(out, pallas, atol=5e-3, rtol=1e-2)


def test_plain_in_bf16_matches_jax_pallas():
    """For bf16 input the plain version rounds conv1's output to bf16 and sums
    in fp32, as the Pallas kernel does: the two agree to bf16 rounding."""
    bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(2, 64, 40, 32, seed=1)]
    out = fused_subsampling_x4_plain(*bf16)
    assert out.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf16),
                        block_t=8)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(1, 17, 12, 8)]
    launches = fused_subsampling_x4.launches
    assert torch.equal(fused_subsampling_x4(*args), fused_subsampling_x4_plain(*args))
    assert fused_subsampling_x4.launches == launches


def test_conv_subsampling_module_matches_jax():
    """ConvSubsampling (both routes) against the JAX module with the XLA conv
    pair, on carried weights: the (f, c) flatten before `out` must match."""
    B, T, F, D = 2, 45, 40, 32
    x = np.random.RandomState(3).randn(B, T, F).astype(np.float32)
    lens = np.array([45, 30], np.int32)
    jm = JaxConvSubsampling(d_model=D, feat_in=F)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens))
    ref, ref_len = jm.apply(variables, jnp.asarray(x), jnp.asarray(lens))
    for fused in (False, True):
        m = load_jax_variables(ConvSubsampling(D, F, fused_kernel=fused),
                               jax.device_get(variables))
        out, out_len = m(torch.from_numpy(x), torch.from_numpy(lens))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
