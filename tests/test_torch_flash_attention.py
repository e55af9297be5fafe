"""Rel-pos flash attention of the PyTorch port (K1, nemo_tpu_torch/ops/
flash_attention.py) against the JAX package.

On the CPU the wrapper runs its plain version; it is held against the einsum
branch of `nemo_tpu.ops.attention.relpos_attention` at a ragged T with key
padding, and against the Pallas flash kernel as `_relpos_flash` calls it
(interpret mode, T = 128). Padded query rows are garbage on the JAX side by
design, so only valid rows are compared. The CUDA kernel is checked against
the plain version on the card by tests/test_torch_cuda_kernels.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.models.asr.modules.conformer import RelPositionalEncoding as JaxRelPos  # noqa: E402
from nemo_tpu.ops import attention as jax_attention  # noqa: E402
from nemo_tpu_torch.models.asr.modules.conformer import RelPositionalEncoding  # noqa: E402
from nemo_tpu_torch.ops.attention import relpos_attention  # noqa: E402
from nemo_tpu_torch.ops.flash_attention import (  # noqa: E402
    relpos_flash_attention, relpos_flash_attention_plain)


def _inputs(B, H, T, dh, lengths, seed=0):
    rng = np.random.RandomState(seed)
    D = H * dh
    qu, qv, k, v = (rng.randn(B, H, T, dh).astype(np.float32) for _ in range(4))
    w_pos = (rng.randn(D, D) / math.sqrt(D)).astype(np.float32)
    pos_emb = RelPositionalEncoding(D)(torch.zeros(1, T, D))[1].numpy()  # [2T-1, D]
    return dict(qu=qu, qv=qv, k=k, v=v, w_pos=w_pos, pos_emb=pos_emb,
                lengths=np.asarray(lengths, np.int32), D=D, scale=1.0 / math.sqrt(dh))


def _p_table(a):
    """p = pe @ W_pos as the wrapper's caller builds it: [H, 2T-1, dh]."""
    H, dh = a["qu"].shape[1], a["qu"].shape[3]
    p = torch.from_numpy(a["pos_emb"]) @ torch.from_numpy(a["w_pos"])
    return p.view(-1, H, dh).transpose(0, 1)


def _assert_valid_rows_close(out, ref, lengths, tol):
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(out[b, :, :n], ref[b, :, :n], atol=tol, rtol=tol)


def test_positional_table_matches_jax():
    T, D = 19, 32
    _, pe = RelPositionalEncoding(D, xscale=None)(torch.zeros(1, T, D))
    _, jpe = JaxRelPos(D).apply({}, jnp.zeros((1, T, D)))
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe)[0], atol=1e-6)


@pytest.mark.parametrize("use_flash", [False, True])
def test_relpos_attention_matches_jax_einsum(use_flash):
    """Both port forms (trig decomposition; K1's plain version through the
    wrapper) against the JAX einsum branch: fp32, ragged T, padded keys."""
    a = _inputs(B=2, H=2, T=37, dh=16, lengths=[37, 20])
    t = {k: torch.from_numpy(a[k]) for k in ("qu", "qv", "k", "v")}
    out = relpos_attention(
        t["qu"], t["qv"], t["k"], t["v"], torch.from_numpy(a["w_pos"]).view(a["D"], 2, 16),
        torch.from_numpy(a["lengths"]), d_model=a["D"], scale=a["scale"],
        pos_emb=torch.from_numpy(a["pos_emb"]), use_flash=use_flash).numpy()
    pad_mask = np.arange(37)[None, :] < a["lengths"][:, None]
    ref = jax_attention.relpos_attention(
        *(jnp.asarray(a[k]) for k in ("qu", "qv", "k", "v")),
        jnp.asarray(a["w_pos"]).reshape(a["D"], 2, 16), jnp.asarray(pad_mask),
        d_model=a["D"], scale=a["scale"])
    _assert_valid_rows_close(out, np.asarray(ref), a["lengths"], 1e-5)


def test_plain_matches_jax_pallas_flash_interpret():
    """K1's plain version against the Pallas flash kernel on the augmented
    features that `_relpos_flash` builds, at T = 128 (a tile multiple)."""
    B, H, T, dh = 2, 2, 128, 16
    a = _inputs(B, H, T, dh, lengths=[128, 90], seed=1)
    D = a["D"]
    pad_mask = jnp.asarray(np.arange(T)[None, :] < a["lengths"][:, None])
    qv = jnp.asarray(a["qv"])
    aa, bb, cosW, sinW = jax_attention.decompose_relpos_q(
        qv, jnp.asarray(a["w_pos"]).reshape(D, H, dh), jnp.arange(T), D)
    q_aug = jnp.concatenate([jnp.asarray(a["qu"]), aa, bb], -1)
    F = cosW.shape[-1]
    k_aug = jnp.concatenate([jnp.asarray(a["k"]), jnp.broadcast_to(cosW, (B, H, T, F)),
                             jnp.broadcast_to(sinW, (B, H, T, F))], -1)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_attention._relpos_flash(q_aug, k_aug, jnp.asarray(a["v"]), pad_mask,
                                          a["scale"], jnp.float32)
    t = {k: torch.from_numpy(a[k]) for k in ("qu", "qv", "k", "v")}
    out, lse = relpos_flash_attention_plain(t["qu"], t["qv"], t["k"], t["v"], _p_table(a),
                                            torch.from_numpy(a["lengths"]), a["scale"])
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    _assert_valid_rows_close(out.numpy(), np.asarray(ref), a["lengths"], 2e-5)


def test_wrapper_takes_plain_version_on_cpu():
    a = _inputs(B=1, H=2, T=9, dh=8, lengths=[7])
    args = [torch.from_numpy(a[k]) for k in ("qu", "qv", "k", "v")]
    args += [_p_table(a), torch.from_numpy(a["lengths"]), a["scale"]]
    launches = relpos_flash_attention.launches
    o, lse = relpos_flash_attention(*args)
    o_ref, lse_ref = relpos_flash_attention_plain(*args)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert relpos_flash_attention.launches == launches  # the plain version counts nothing


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        relpos_flash_attention(x, x, x, x, torch.zeros(1, 7, 64, device="meta"),
                               torch.ones(1, dtype=torch.int32), 0.125)
