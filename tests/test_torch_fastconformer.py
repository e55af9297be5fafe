"""The FastConformer pieces of the PyTorch port against the JAX package, on
the CPU: the rel-pos flash attention at head dim 128 (the plain versions of
K1, K3 and K4, which the CUDA kernels are held to on the card by
tests/test_torch_cuda_kernels.py) and the ×8 depthwise-striding
subsampling (`dw_striding`).

The attention is held against the einsum branch of
`nemo_tpu.ops.attention.relpos_attention` and its `jax.grad` (on the CPU
JAX takes that branch whatever the attention impl). Tolerances are fp32's:
outputs within 1e-4 of each row's max-abs value, gradients within 1e-4 of
each leaf's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nemo_tpu.models.asr.modules.conformer import ConvSubsampling as JaxConvSubsampling  # noqa: E402,E501
from nemo_tpu.ops import attention as jax_attention  # noqa: E402
from nemo_tpu_torch.interop.jax_params import export_jax_variables, load_jax_variables  # noqa: E402,E501
from nemo_tpu_torch.models.asr.modules.conformer import ConvSubsampling  # noqa: E402
from nemo_tpu_torch.ops.attention import relpos_attention  # noqa: E402
from test_torch_flash_attention import _inputs  # noqa: E402

NAMES = ("qu", "qv", "k", "v", "w_pos")


def _rows_close(out, ref, tol, what):
    """Each row (the last axis) within tol of its own max-abs value."""
    out, ref = np.asarray(out), np.asarray(ref)
    limit = tol * np.abs(ref).max(-1, keepdims=True) + 1e-7
    worst = float((np.abs(out - ref) / limit).max())
    assert worst <= 1.0, f"{what}: worst row at {worst:.3f} of its tolerance"


@pytest.mark.parametrize("T,lengths", [(37, [37, 20]), (70, [70, 1])])
def test_plain_relpos_flash_dh128_matches_jax_einsum(T, lengths):
    """K1's plain version (through the wrapper, as the Conformer calls it)
    and its backward, the plain K3 and K4, at head dim 128 against the JAX
    einsum branch and its jax.grad: fp32, padded keys, a row of length 1,
    the loss weighting valid query rows only (padded rows are garbage on the
    JAX side by design)."""
    B, H, dh = len(lengths), 2, 128
    a = _inputs(B=B, H=H, T=T, dh=dh, lengths=lengths, seed=T)
    valid = np.arange(T)[None, :] < a["lengths"][:, None]  # [B, T]
    w = np.random.RandomState(T + 1).randn(B, H, T, dh).astype(np.float32)
    w *= valid[:, None, :, None]
    pad_mask = jnp.asarray(valid)

    def jax_out(qu, qv, k, v, w_pos):
        return jax_attention.relpos_attention(qu, qv, k, v, w_pos, pad_mask, d_model=a["D"],
                                              scale=a["scale"])

    jargs = [jnp.asarray(a[k]) for k in ("qu", "qv", "k", "v")]
    jargs.append(jnp.asarray(a["w_pos"]).reshape(a["D"], H, dh))
    ref = np.asarray(jax_out(*jargs))
    ref_grads = jax.grad(lambda *x: jnp.sum(jax_out(*x) * w), argnums=tuple(range(5)))(*jargs)

    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in ("qu", "qv", "k", "v")}
    t["w_pos"] = torch.from_numpy(a["w_pos"]).view(a["D"], H, dh).requires_grad_()
    out = relpos_attention(t["qu"], t["qv"], t["k"], t["v"], t["w_pos"],
                           torch.from_numpy(a["lengths"]), d_model=a["D"], scale=a["scale"],
                           pos_emb=torch.from_numpy(a["pos_emb"]), use_flash=True)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [t[n] for n in NAMES])
    assert out.shape == (B, H, T, dh)
    for b, n in enumerate(lengths):
        _rows_close(out[b, :, :n].detach().numpy(), ref[b, :, :n], 1e-4, f"o row {b}")
    for name, g, r in zip(NAMES, grads, ref_grads):
        r = np.asarray(r).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * np.abs(r).max(), rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def subsampling():
    """The JAX dw_striding module (×8, 16 channels, 40 mels into d 32) and
    seeded variables for it, drawn with numpy on flax's tree (traced, not
    compiled)."""
    jmod = JaxConvSubsampling(d_model=32, feat_in=40, subsampling="dw_striding",
                              subsampling_factor=8, conv_channels=16)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 40)),
                                              jnp.array([16])))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)
    return jmod, variables


def test_dw_striding_subsampling_matches_jax(subsampling):
    """conv0, then depthwise dw{i} and pointwise pw{i} convs with a ReLU
    each, then `out`: the port's module on the JAX variables against JAX's,
    at ragged lengths, every output row within 1e-4 of its max; the lengths
    equal."""
    jmod, variables = subsampling
    x = np.random.RandomState(1).randn(2, 53, 40).astype(np.float32)
    lens = np.array([53, 30], np.int32)
    ref, ref_len = jax.device_get(jmod.apply(variables, jnp.asarray(x), jnp.asarray(lens)))
    port = ConvSubsampling(32, 40, 8, 16, subsampling="dw_striding")
    assert [n for n, _ in port.named_children()] == ["conv0", "dw1", "pw1", "dw2", "pw2", "out"]
    load_jax_variables(port, variables)
    with torch.no_grad():
        out, out_len = port(torch.from_numpy(x), torch.from_numpy(lens))
    assert out.shape == ref.shape == (2, 7, 32)
    np.testing.assert_array_equal(out_len.numpy(), ref_len)
    _rows_close(out.numpy(), ref, 1e-4, "dw_striding")


def test_dw_striding_variables_round_trip(subsampling):
    """The port exports the JAX tree it loaded, leaf for leaf (depthwise
    kernels [3, 3, 1, C], pointwise [1, 1, C, C]), and a depthwise kernel of
    the wrong shape raises."""
    _, variables = subsampling
    port = load_jax_variables(ConvSubsampling(32, 40, 8, 16, subsampling="dw_striding"),
                              variables)
    assert tuple(port.dw1.weight.shape) == (16, 1, 3, 3)
    tree = export_jax_variables(port)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len(jax.tree_util.tree_leaves(tree)) == len(flat)
    for path, want in flat:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["dw2"]["kernel"] = np.zeros((3, 3, 16, 16), np.float32)
    with pytest.raises(ValueError, match="dw2/kernel"):
        load_jax_variables(ConvSubsampling(32, 40, 8, 16, subsampling="dw_striding"), bad)
    with pytest.raises(ValueError, match="not ported"):
        ConvSubsampling(32, 40, 8, 16, subsampling="vggnet")
