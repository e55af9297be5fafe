"""The port's positions attention (nemo_tpu_torch/ops/flash_attention.py:
flash_attention_positions, the plain versions of K11, K12 and K13) and
`flash_attention(q_offset != 0)` against the JAX package.

- The plain version against JAX's Pallas kernels (`flash_attention_positions`
  and its custom_vjp) in interpret mode, as tests/test_ring_gpt.py:27-83 runs
  them: B=1, H=4 over G=2, T=256, dh 64, blocks of 64 or 128, fp32, on four
  layouts (contiguous positions; a zig-zag permutation for cp 2; one
  off-diagonal ring step, the queries of rank 0 against the keys of rank 1,
  where the rows of chunk 0 see no key and must give o = 0, lse = -1e30 and
  dq = 0; a window of 64). o, lse, dq, dk and dv within 1e-5; the gradients
  are of sum(o²) + sum(tanh(lse)), so the lse cotangent is used.
- `flash_attention(q_offset=128)` at Tq 128, Tkv 256 against JAX's
  `flash_attention(..., q_offset)` in interpret mode: o and the gradients
  within 1e-5.
- The wrappers take the plain version on CPU tensors without a launch, and
  refuse on CUDA tensors what the kernels do not take.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.ops import flash_attention as jax_flash  # noqa: E402
from nemo_tpu.ops.ring_attention import zigzag_chunk_ids as jax_zigzag_chunk_ids  # noqa: E402
from nemo_tpu_torch.ops import flash_attention as port  # noqa: E402

TOL = 1e-5
T, SCALE = 256, 0.125


def _inputs(seed, B=1, H=4, G=2, Tq=T, Tkv=T, dh=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Tq, dh).astype(np.float32), rng.randn(B, G, Tkv, dh).astype(np.float32),
            rng.randn(B, G, Tkv, dh).astype(np.float32))


def _zigzag(S, cp):
    """The positions of S tokens in zig-zag order for cp ranks (train.py:196-199)."""
    clen = S // (2 * cp)
    return np.concatenate([np.arange(i * clen, (i + 1) * clen)
                           for i in jax_zigzag_chunk_ids(cp).reshape(-1)]).astype(np.int32)


LAYOUTS = {  # name → (qpos, kpos, window, block)
    "contiguous": (np.arange(T, dtype=np.int32), np.arange(T, dtype=np.int32), None, 128),
    "zigzag": (_zigzag(T, 2), _zigzag(T, 2), None, 128),
    # a sequence of 2T at cp 2: rank 0 holds chunks 0 and 3 of 4, rank 1
    # chunks 1 and 2, so rank 0's rows of chunk 0 see none of rank 1's keys
    "off_diagonal": (_zigzag(2 * T, 2)[:T], _zigzag(2 * T, 2)[T:], None, 128),
    "window": (np.arange(T, dtype=np.int32), np.arange(T, dtype=np.int32), 64, 128),
}


@functools.partial(jax.jit, static_argnames=("window", "block"))
def _pallas_value_and_grad(q, k, v, qpos, kpos, *, window, block):
    """sum(o²) + sum(tanh(lse)) of JAX's flash_attention_positions, its
    (o, lse) and its gradients in q, k and v (one compile for the layouts
    that share a window; call it in interpret mode)."""

    def f(q, k, v):
        o, lse = jax_flash.flash_attention_positions(q, k, v, qpos, kpos, SCALE, True, window,
                                                     block, block)
        return jnp.sum(o ** 2) + jnp.sum(jnp.tanh(lse)), (o, lse)

    return jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_positions_attention_matches_pallas_interpret(layout):
    qpos, kpos, window, block = LAYOUTS[layout]
    q, k, v = _inputs(seed=list(LAYOUTS).index(layout))

    with pltpu.force_tpu_interpret_mode():
        (_, (o_ref, lse_ref)), want = _pallas_value_and_grad(
            *(jnp.asarray(x) for x in (q, k, v, qpos, kpos)), window=window, block=block)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tqp, tkp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    o, lse = port.flash_attention_positions(tq, tk, tv, tqp, tkp, SCALE, True, window)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_ref)[..., 0], atol=TOL,
                               rtol=TOL)
    got = torch.autograd.grad((o ** 2).sum() + torch.tanh(lse).sum(), (tq, tk, tv))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)
    dead = (kpos[None, :] > qpos[:, None]).all(-1)  # rows that see no key
    assert dead.any() == (layout == "off_diagonal")
    if dead.any():
        assert not o.detach().numpy()[:, :, dead].any()
        assert (lse.detach().numpy()[:, :, dead] == -1e30).all()
        assert not got[0].numpy()[:, :, dead].any()


def test_q_offset_matches_pallas_interpret():
    q, k, v = _inputs(seed=9, Tq=128, Tkv=256)
    rng = np.random.RandomState(10)
    do = rng.randn(*q.shape).astype(np.float32)

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, SCALE, True, None, 128, 128, 128)

    def fwd_bwd(q, k, v):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(jnp.asarray(do))

    with pltpu.force_tpu_interpret_mode():
        o_ref, want = jax.jit(fwd_bwd)(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = port.flash_attention(tq, tk, tv, SCALE, q_offset=128)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=TOL, rtol=TOL)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


def test_positions_wrappers_take_plain_version_on_cpu():
    """K11's, K12's and K13's wrappers on CPU tensors run the plain versions
    and count no launch; the backward folds the lse cotangent into delta'."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(seed=7, Tq=128, Tkv=192))
    qpos = torch.arange(64, 192, dtype=torch.int32)
    kpos = torch.arange(192, dtype=torch.int32)
    counters = (port.flash_attention_positions, port.flash_pos_dq, port.flash_pos_dkv)
    launches = [fn.launches for fn in counters]
    o, lse = port.flash_attention_positions_plain(q, k, v, qpos, kpos, SCALE)
    do, dlse = torch.randn_like(o), torch.randn_like(lse)
    args = (q, k, v, qpos, kpos, SCALE, True, None, lse, port.pos_delta(o, do, dlse), do)
    ref = port.flash_attention_positions_backward_plain(q, k, v, qpos, kpos, SCALE, True, None,
                                                        o, lse, do, dlse)
    for g, r in zip((port.flash_pos_dq(*args), *port.flash_pos_dkv(*args)), ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    o2, lse2 = port.flash_attention_positions(q, k, v, qpos, kpos, SCALE)
    torch.testing.assert_close(o2, o, atol=0, rtol=0)
    torch.testing.assert_close(lse2, lse, atol=0, rtol=0)
    assert [fn.launches for fn in counters] == launches


def test_positions_cuda_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch):
    """On CUDA tensors the positions wrappers (and flash_attention with
    q_offset) raise on lengths that are not multiples of 64, positions of
    the wrong shape or type, a head dim of 16 and, where the ring hands
    them to K12, bad tile ranges. Simulated on CPU tensors by taking the
    launch branch: the checks run before anything touches a card."""
    monkeypatch.setattr(port, "_device", lambda what, t: "cuda")
    q, k, v = (torch.zeros(1, h, 128, 64) for h in (4, 2, 2))
    pos = torch.arange(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 64"):
        port.flash_attention(q[:, :, :100], k, v, 0.125, q_offset=28)
    with pytest.raises(ValueError, match="qpos must be"):
        port.flash_attention_positions(q, k, v, pos[:64], pos, 0.125)
    with pytest.raises(ValueError, match="kpos must be"):
        port.flash_attention_positions(q, k, v, pos, pos.float(), 0.125)
    q16, k16, v16 = (torch.zeros(1, h, 128, 16) for h in (4, 2, 2))
    with pytest.raises(ValueError, match="head dim 16"):
        port.flash_attention_positions(q16, k16, v16, pos, pos, 0.25)
    bad = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="ranges must be"):
        port.flash_pos_dq(q, k, v, pos, pos, 0.125, True, None, torch.zeros(1, 4, 128),
                          torch.zeros(1, 4, 128), torch.zeros_like(q), ranges=(bad, bad))
