"""Backward of the port's rel-pos flash attention (the plain version of K3
and K4, nemo_tpu_torch/ops/flash_attention.py) against the JAX package.

On the CPU, `relpos_flash_attention` is a `torch.autograd.Function` whose
backward is `relpos_flash_attention_backward_plain`. Its gradients in qu, qv,
k, v and w_pos (through p = pe @ W_pos) are held against `jax.grad` of the
einsum branch of `nemo_tpu.ops.attention.relpos_attention` at a ragged T with
key padding, and against the Pallas backward kernels (`_dq_kernel`,
`_dkv_kernel`) as `_relpos_flash` differentiates them, in interpret mode at
T = 128. The loss weights valid query rows only: padded rows are garbage on
the JAX side by design. The CUDA kernels are checked against the plain
backward on the card by tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.ops import attention as jax_attention  # noqa: E402
from nemo_tpu_torch.ops.attention import relpos_attention  # noqa: E402
from nemo_tpu_torch.ops.flash_attention import (  # noqa: E402
    relpos_flash_attention, relpos_flash_attention_backward_plain, relpos_flash_dkv,
    relpos_flash_dq, row_delta)
from nemo_tpu_torch.ops.subsampling_kernel import fused_subsampling_x4  # noqa: E402
from test_torch_flash_attention import _inputs, _p_table  # noqa: E402

NAMES = ("qu", "qv", "k", "v", "w_pos")


def _row_weights(a, seed):
    """Loss weights [B, H, T, dh], zero on padded query rows."""
    w = np.random.RandomState(seed).randn(*a["qu"].shape).astype(np.float32)
    valid = np.arange(w.shape[2])[None, :] < a["lengths"][:, None]  # [B, T]
    return w * valid[:, None, :, None]


def _port_grads(a, w, use_flash):
    B, H, T, dh = a["qu"].shape
    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in ("qu", "qv", "k", "v")}
    t["w_pos"] = torch.from_numpy(a["w_pos"]).view(a["D"], H, dh).requires_grad_()
    out = relpos_attention(t["qu"], t["qv"], t["k"], t["v"], t["w_pos"],
                           torch.from_numpy(a["lengths"]), d_model=a["D"], scale=a["scale"],
                           pos_emb=torch.from_numpy(a["pos_emb"]), use_flash=use_flash)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [t[n] for n in NAMES])
    return [g.numpy() for g in grads]


def _assert_grads_close(grads, ref, tol):
    """Each gradient within tol of its leaf's max-abs value."""
    for name, g, r in zip(NAMES, grads, ref):
        r = np.asarray(r).reshape(g.shape)
        np.testing.assert_allclose(g, r, atol=tol * np.abs(r).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("use_flash", [False, True])
def test_grads_match_jax_einsum(use_flash):
    """The trig-decomposed form (autograd) and the flash form (K1's Function,
    plain backward) against jax.grad of the JAX einsum branch: fp32, T = 37,
    padded keys; within 1e-5 of each leaf's max."""
    a = _inputs(B=2, H=2, T=37, dh=16, lengths=[37, 20], seed=3)
    w = _row_weights(a, seed=4)
    pad_mask = jnp.asarray(np.arange(37)[None, :] < a["lengths"][:, None])

    def loss(qu, qv, k, v, w_pos):
        out = jax_attention.relpos_attention(qu, qv, k, v, w_pos, pad_mask,
                                             d_model=a["D"], scale=a["scale"])
        return jnp.sum(out * w)

    ref = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(a[k]) for k in ("qu", "qv", "k", "v")),
        jnp.asarray(a["w_pos"]).reshape(a["D"], 2, 16))
    _assert_grads_close(_port_grads(a, w, use_flash), ref, 1e-5)


@pytest.mark.parametrize("T, lengths", [(65, [65, 3]), (130, [130, 3]), (150, [150, 90])])
def test_flash_grads_match_jax_einsum_at_tile_edges(T, lengths):
    """The flash form's gradients against jax.grad of the JAX einsum branch
    at the lengths where the card tests hold K1, K3 and K4 at dh 128 to this
    plain backward: one row past a 64-row tile, two past, an odd number of
    tiles, and keys past a length of 3 inside a key tile; fp32, within 1e-5
    of each leaf's max."""
    a = _inputs(B=2, H=2, T=T, dh=8, lengths=lengths, seed=8)
    w = _row_weights(a, seed=9)
    pad_mask = jnp.asarray(np.arange(T)[None, :] < a["lengths"][:, None])

    def loss(qu, qv, k, v, w_pos):
        out = jax_attention.relpos_attention(qu, qv, k, v, w_pos, pad_mask,
                                             d_model=a["D"], scale=a["scale"])
        return jnp.sum(out * w)

    ref = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(a[k]) for k in ("qu", "qv", "k", "v")),
        jnp.asarray(a["w_pos"]).reshape(a["D"], 2, 8))
    _assert_grads_close(_port_grads(a, w, use_flash=True), ref, 1e-5)


def test_plain_backward_matches_jax_pallas_backward_interpret():
    """The plain backward against the Pallas `_dq_kernel` / `_dkv_kernel` (the
    custom_vjp of `flash_attention`) on the augmented features that
    `_relpos_flash` builds, in interpret mode at T = 128 (a tile multiple),
    B = 1, H = 2; within 1e-5 of each leaf's max."""
    B, H, T, dh = 1, 2, 128, 16
    a = _inputs(B, H, T, dh, lengths=[100], seed=5)
    w = _row_weights(a, seed=6)
    D = a["D"]
    pad_mask = jnp.asarray(np.arange(T)[None, :] < a["lengths"][:, None])

    def loss(qu, qv, k, v, w_pos):
        aa, bb, cosW, sinW = jax_attention.decompose_relpos_q(qv, w_pos, jnp.arange(T), D)
        F = cosW.shape[-1]
        q_aug = jnp.concatenate([qu, aa, bb], -1)
        k_aug = jnp.concatenate([k, jnp.broadcast_to(cosW, (B, H, T, F)),
                                 jnp.broadcast_to(sinW, (B, H, T, F))], -1)
        out = jax_attention._relpos_flash(q_aug, k_aug, v, pad_mask, a["scale"], jnp.float32)
        return jnp.sum(out * w)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=tuple(range(5)))(
            *(jnp.asarray(a[k]) for k in ("qu", "qv", "k", "v")),
            jnp.asarray(a["w_pos"]).reshape(D, H, dh))
    _assert_grads_close(_port_grads(a, w, use_flash=True), ref, 1e-5)


def test_backward_wrappers_take_plain_version_on_cpu():
    """K3's and K4's wrappers on CPU tensors return the plain backward's
    outputs and launch nothing; K1's output carries the Function's grad_fn."""
    a = _inputs(B=2, H=2, T=11, dh=8, lengths=[11, 6], seed=7)
    args = [torch.from_numpy(a[k]) for k in ("qu", "qv", "k", "v")]
    args += [_p_table(a), torch.from_numpy(a["lengths"]), a["scale"]]
    o, lse = relpos_flash_attention(*[x.requires_grad_() if torch.is_tensor(x) and
                                      x.is_floating_point() else x for x in args])
    fn = o.grad_fn.next_functions[0][0]  # o is the transposed view of the Function's output
    assert type(fn).__name__ == "RelposFlashAttentionBackward" and not lse.requires_grad
    o, do = o.detach(), torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    args = [x.detach() if torch.is_tensor(x) else x for x in args]
    ref = relpos_flash_attention_backward_plain(*args, o, lse, do)
    launches = relpos_flash_dq.launches, relpos_flash_dkv.launches
    delta = row_delta(o, do)
    out = (*relpos_flash_dq(*args, lse, delta, do), *relpos_flash_dkv(*args, lse, delta, do))
    assert (relpos_flash_dq.launches, relpos_flash_dkv.launches) == launches
    assert [x.shape for x in out] == [x.shape for x in ref]
    for x, r in zip(out, ref):
        assert torch.equal(x, r)


def test_training_forward_reaches_the_conv_pair_only_when_asked(monkeypatch):
    """With `fused_subsampling` set, the encoder calls the fused kernel's
    wrapper unless the caller passes conv_pair_subsampling=True (the
    training forward, since the kernel has no backward); both give the same
    values within 1e-4 (the two routes run fp32 convolutions on weights in
    other layouts, so their sums differ in order)."""
    from nemo_tpu_torch.models.asr.ctc_models import init_weights
    from nemo_tpu_torch.models.asr.modules import conformer

    enc = conformer.ConformerEncoder(feat_in=16, n_layers=1, d_model=128, n_heads=2,
                                     fused_subsampling=True)
    init_weights(enc, torch.Generator().manual_seed(0))
    feats = torch.randn(2, 16, 40, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([40, 31])
    with torch.no_grad():
        fused, _ = enc(feats, lens)
    calls = []
    monkeypatch.setattr(conformer, "fused_subsampling_x4",
                        lambda *a: calls.append(1) or fused_subsampling_x4(*a))
    with torch.no_grad():
        enc(feats, lens)
    out, _ = enc(feats, lens, conv_pair_subsampling=True)
    assert len(calls) == 1 and out.requires_grad and torch.isfinite(fused).all()
    torch.testing.assert_close(out.detach(), fused, atol=1e-4, rtol=1e-4)


def test_plain_backward_sums_dp_over_the_batch():
    """dp of the plain backward sums over the batch: twice the batch of the
    same rows gives twice dp and the same per-row gradients."""
    a = _inputs(B=1, H=2, T=9, dh=8, lengths=[7], seed=8)
    one = [torch.from_numpy(a[k]) for k in ("qu", "qv", "k", "v")]
    p, lens = _p_table(a), torch.from_numpy(a["lengths"])
    o, lse = relpos_flash_attention(*one, p, lens, a["scale"])
    do = torch.from_numpy(_row_weights(a, seed=9))
    g1 = relpos_flash_attention_backward_plain(*one, p, lens, a["scale"], o, lse, do)
    two = [torch.cat([x, x]) for x in one]
    g2 = relpos_flash_attention_backward_plain(
        *two, p, torch.cat([lens, lens]), a["scale"], torch.cat([o, o]), torch.cat([lse, lse]),
        torch.cat([do, do]))
    for x1, x2 in zip(g1[:4], g2[:4]):
        torch.testing.assert_close(x2, torch.cat([x1, x1]), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(g2[4], 2 * g1[4], atol=1e-6, rtol=1e-6)
