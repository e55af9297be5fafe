"""The port's causal GQA flash attention (the plain versions of K5, K6 and K7,
nemo_tpu_torch/ops/flash_attention.py) against the JAX package's Pallas
kernels, run in interpret mode as tests/test_flash_attention.py runs them.

B=1, H=4, T=256, dh 64 and 96 (Phi-3-mini's), blocks of 128, fp32: the
forward (o and lse) within 2e-5 and the backward (dq, dk, dv by `jax.vjp`)
within 2e-4, for a causal GQA case, a windowed one and a non-causal one. The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.ops import flash_attention as jax_flash  # noqa: E402
from nemo_tpu_torch.ops import flash_attention as port  # noqa: E402

# causal, window, G (H = 4), head dim; the dh-64 cases keep their ids
CASES = [pytest.param(causal, window, G, dh, id=f"{causal}-{window}-{G}" + ("-dh96" if dh == 96
                                                                          else ""))
         for dh in (64, 96) for causal, window, G in ((True, None, 1), (True, 64, 2),
                                                      (False, None, 2))]


def _inputs(G, seed, B=1, H=4, T=256, dh=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, dh).astype(np.float32)
    k = rng.randn(B, G, T, dh).astype(np.float32)
    v = rng.randn(B, G, T, dh).astype(np.float32)
    do = rng.randn(B, H, T, dh).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal,window,G,dh", CASES)
def test_plain_forward_matches_pallas_interpret(causal, window, G, dh):
    q, k, v, _ = _inputs(G, seed=G, dh=dh)
    scale = 1.0 / np.sqrt(dh)
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = jax_flash._flash_forward(*(jnp.asarray(x) for x in (q, k, v)), scale,
                                                  causal, window, 128, 128, 0)
    o, lse = port.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), scale,
                                        causal, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=2e-5, rtol=2e-5)
    # the public function (K5's Function on the CPU) gives the same o
    o_fn = port.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), scale, causal, window)
    torch.testing.assert_close(o_fn, o, atol=0, rtol=0)


@pytest.mark.parametrize("causal,window,G,dh", CASES)
def test_plain_backward_matches_pallas_interpret(causal, window, G, dh):
    q, k, v, do = _inputs(G, seed=10 + G, dh=dh)
    scale = 1.0 / np.sqrt(dh)

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, scale, causal, window, 128, 128, 0)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = port.flash_attention(tq, tk, tv, scale, causal, window)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    o_plain, lse = port.flash_attention_plain(tq, tk, tv, scale, causal, window)
    plain = port.flash_attention_backward_plain(tq, tk, tv, scale, causal, window, o_plain, lse,
                                                torch.from_numpy(do))
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4, err_msg=name)
        torch.testing.assert_close(g, p, atol=0, rtol=0, msg=name)


def test_backward_wrappers_take_plain_version_on_cpu():
    """K6's and K7's wrappers on CPU tensors run the plain backward and count
    no launch."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, seed=5, T=128))
    scale = 0.125
    o, lse = port.flash_attention_plain(q, k, v, scale, True, 64)
    delta = port.row_delta(o, do)
    launches = port.flash_dq.launches, port.flash_dkv.launches, port.flash_attention.launches
    dq = port.flash_dq(q, k, v, scale, True, 64, lse, delta, do)
    dk, dv = port.flash_dkv(q, k, v, scale, True, 64, lse, delta, do)
    ref = port.flash_attention_backward_plain(q, k, v, scale, True, 64, o, lse, do)
    for g, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    port.flash_attention(q, k, v, scale)
    assert (port.flash_dq.launches, port.flash_dkv.launches,
            port.flash_attention.launches) == launches


def test_cuda_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch):
    """On CUDA tensors the wrapper raises where the kernels do not go (a head
    dim of 16 or 80, a kv head count that does not divide H; with
    `q_offset`, a query length that is not a multiple of 64), and the checks
    pass the head dims the kernels take (64, 96, 128). Simulated on CPU
    tensors by taking the launch branch: the checks run before anything
    touches a card."""
    monkeypatch.setattr(port, "_device", lambda what, t: "cuda")
    for dh in (16, 80):
        q, k, v = (torch.zeros(1, h, 128, dh) for h in (4, 2, 2))
        with pytest.raises(ValueError, match=f"head dim {dh}"):
            port.flash_attention(q, k, v, 0.25)
    for dh in (64, 96, 128):
        q, k, v = (torch.zeros(1, h, 128, dh) for h in (4, 2, 2))
        port._flash_check("flash_attention", q, k, v, None)
    q, k, v = (torch.zeros(1, h, 128, 64) for h in (4, 3, 3))
    with pytest.raises(ValueError, match="G dividing"):
        port.flash_attention(q, k, v, 0.125)
    with pytest.raises(ValueError, match="dtype"):
        port.flash_attention(q.half(), k.half(), v.half(), 0.125)
    q, k, v = (torch.zeros(1, h, 128, 64) for h in (4, 2, 2))
    with pytest.raises(ValueError, match="multiples of 64"):
        port.flash_attention(q[:, :, :96], k, v, 0.125, q_offset=32)
