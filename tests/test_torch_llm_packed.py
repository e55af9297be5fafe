"""The port's packed attention and packed model (nemo_tpu_torch/ops/
flash_attention.py:flash_attention_packed, models/llm/gpt.py, train.py)
against the JAX package.

- The plain versions of K8 (forward) and K9/K10 (backward) against the JAX
  package's Pallas kernels (`flash_attention_packed`, its `jax.vjp`) in
  interpret mode, as tests/test_flash_packed.py runs them: B=2, H=4 over
  G=2, T=256, dh 64 and 96 (Phi-3-mini's), blocks 128, segment layouts made
  as that file's `_segments` makes them (2-4 documents, then a padding
  tail), causal with
  and without a window, fp32. o (padding rows included, which must be 0),
  lse, dq, dk and dv within 1e-5.
- A tiny Llama-style model (tied embeddings, llama3 RoPE), fp32, B=2,
  S=128, a packed batch (segments, per-segment positions, answer-only
  loss), weights carried from JAX: the logits on valid rows within 1e-4 of
  JAX `GPTModel.apply(tokens, positions, segment_ids=...)` (the port's flash
  branch, JAX's einsum branch: the two differ only on padding rows, where
  JAX's einsum gives the mean of v and the flash kernels 0; no valid row and
  no loss sees them), and the fused-CE loss within 1e-5 relative and every
  leaf's gradient within 1e-4 of its max-abs + 1e-6 of JAX's
  `train.py:loss_fn` with `segment_ids` and `positions`. JAX runs the einsum
  backend because interpret-mode Pallas does not run under remat and scan
  (tests/test_torch_llm_train.py).
- The packed wrapper refuses on CUDA what the kernels do not take.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm.gpt import GPTModel as JaxGPTModel  # noqa: E402
from nemo_tpu.models.llm.loss import fused_linear_cross_entropy as jax_fused_ce  # noqa: E402
from nemo_tpu.ops import flash_attention as jax_flash  # noqa: E402
from nemo_tpu_torch.data.packed_sequence import pack_batch  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables)
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm import gpt as port_gpt  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402
from nemo_tpu_torch.ops import flash_attention as port  # noqa: E402

TOL = 1e-5


def _segments(B, T, seed):
    """Per-row packing as tests/test_flash_packed.py:_segments makes it: 2-4
    documents at random cuts, then a padding tail (id 0)."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(8, T - 8), rng.randint(2, 5), replace=False))
        start = 0
        for sid, c in enumerate(cuts, start=1):
            seg[b, start:c] = sid
            start = c
    return seg


def _inputs(seed, B=2, H=4, G=2, T=256, dh=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, dh).astype(np.float32)
    k = rng.randn(B, G, T, dh).astype(np.float32)
    v = rng.randn(B, G, T, dh).astype(np.float32)
    do = rng.randn(B, H, T, dh).astype(np.float32)
    return q, k, v, do, _segments(B, T, seed + 1)


@pytest.mark.parametrize("window,dh", [
    pytest.param(window, dh, id=f"{window}" + ("-dh96" if dh == 96 else ""))
    for dh in (64, 96) for window in (None, 64)])  # the dh-64 cases keep their ids
def test_plain_packed_attention_matches_pallas_interpret(window, dh):
    q, k, v, do, seg = _inputs(seed=3 if window else 1, dh=dh)
    scale = 1.0 / np.sqrt(dh)

    def f(q, k, v):
        return jax_flash.flash_attention_packed(q, k, v, jnp.asarray(seg), scale, True, window,
                                                128, 128)

    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = jax_flash._flash_forward_seg(
            *(jnp.asarray(x) for x in (q, k, v, seg)), scale, True, window, 128, 128)
        _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        o_plain, lse = port.flash_attention_packed_plain(tq, tk, tv, torch.from_numpy(seg), scale,
                                                         True, window)
    pad = seg == 0
    assert pad.any() and (~pad).any()
    np.testing.assert_allclose(o_plain.numpy(), np.asarray(o_ref), atol=TOL, rtol=TOL)
    assert not o_plain.numpy().transpose(0, 2, 1, 3)[pad].any()  # padding rows: 0
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=TOL, rtol=TOL)
    o = port.flash_attention_packed(tq, tk, tv, torch.from_numpy(seg), scale, True, window)
    torch.testing.assert_close(o, o_plain, atol=0, rtol=0)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)
        assert not g.numpy().transpose(0, 2, 1, 3)[pad].any(), name  # padding rows and keys


def test_packed_backward_wrappers_take_plain_version_on_cpu():
    """K9's and K10's wrappers on CPU tensors run the plain backward and
    count no launch."""
    q, k, v, do, seg = (torch.from_numpy(x) for x in _inputs(seed=7, T=128))
    scale = 0.125
    o, lse = port.flash_attention_packed_plain(q, k, v, seg, scale, True, None)
    args = (q, k, v, seg, scale, True, None, lse, port.row_delta(o, do), do)
    counters = (port.flash_attention_packed, port.flash_seg_dq, port.flash_seg_dkv)
    launches = [fn.launches for fn in counters]
    ref = port.flash_attention_packed_backward_plain(q, k, v, seg, scale, True, None, o, lse, do)
    for g, r in zip((port.flash_seg_dq(*args), *port.flash_seg_dkv(*args)), ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    port.flash_attention_packed(q, k, v, seg, scale)
    assert [fn.launches for fn in counters] == launches


def test_packed_cuda_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch):
    """On CUDA tensors the packed wrapper raises on segments of the wrong
    shape or type, a head dim of 16 and a kv head count that does not
    divide H. Simulated on CPU tensors by taking the launch branch: the
    checks run before anything touches a card."""
    monkeypatch.setattr(port, "_device", lambda what, t: "cuda")
    q, k, v = (torch.zeros(1, h, 128, 64) for h in (4, 2, 2))
    seg = torch.ones(1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="segments must be"):
        port.flash_attention_packed(q, k, v, seg[:, :64], 0.125)
    with pytest.raises(ValueError, match="segments must be"):
        port.flash_attention_packed(q, k, v, seg.float(), 0.125)
    q16, k16, v16 = (torch.zeros(1, h, 128, 16) for h in (4, 2, 2))
    with pytest.raises(ValueError, match="head dim 16"):
        port.flash_attention_packed(q16, k16, v16, seg, 0.25)
    k3, v3 = (torch.zeros(1, 3, 128, 64) for _ in range(2))
    with pytest.raises(ValueError, match="G dividing"):
        port.flash_attention_packed(q, k3, v3, seg, 0.125)


# ------------------------------------------------------------- packed model
B, S = 2, 128


def _cfg(module, **kw):
    return module.tiny_test(share_embeddings_and_output_weights=True, rope_scaling="llama3",
                            rotary_base=5e5, seq_length=S, fused_ce_chunk=48, **kw)


def _packed_batch(seed):
    """Two packed rows of S tokens from samples of 10-60 tokens (answer-only
    loss on each sample's last third), with a padding tail."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(10, 61, 9)
    seqs = [rng.randint(1, 128, n).astype(np.int32) for n in lengths]
    labels = [rng.randint(1, 128, n).astype(np.int32) for n in lengths]
    masks = [(np.arange(n) >= 2 * n // 3).astype(np.float32) for n in lengths]
    rows = pack_batch(seqs, labels, masks, S)
    out = {key: val[:B] for key, val in rows.items()}
    assert (out["segment_ids"] == 0).any() and out["segment_ids"].max() >= 3
    return out


def test_packed_model_logits_loss_and_gradients_match_jax():
    batch = _packed_batch(seed=4)
    jax_cfg = _cfg(jax_config)
    tokens = jnp.asarray(batch["tokens"])
    variables = nn.meta.unbox(JaxGPTModel(jax_cfg).init(jax.random.PRNGKey(0), tokens))
    params = jax.device_get(variables["params"])
    jb = {key: jnp.asarray(val) for key, val in batch.items()}
    want_logits = np.asarray(JaxGPTModel(jax_cfg).apply(
        {"params": params}, tokens, jb["positions"], segment_ids=jb["segment_ids"]))

    def loss_fn(p):  # train.py:loss_fn, the fused-CE branch
        hidden = JaxGPTModel(jax_cfg).apply({"params": p}, tokens, jb["positions"],
                                            segment_ids=jb["segment_ids"], output_hidden=True)
        return jax_fused_ce(hidden, p["embedding"], jb["labels"], jb["loss_mask"],
                            chunk=jax_cfg.fused_ce_chunk)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)

    mod = GPTTrainModule(_cfg(port_config, attention_backend="flash"), device="cpu")
    load_jax_variables(mod.model, {"params": params})
    tb = {key: torch.from_numpy(val) for key, val in batch.items()}
    with torch.no_grad():
        logits = mod.model(tb["tokens"], tb["positions"], tb["segment_ids"])
    valid = batch["segment_ids"] > 0
    np.testing.assert_allclose(logits.numpy()[valid], want_logits[valid], atol=1e-4, rtol=0)

    calls = []
    packed = port_gpt.flash_attention_packed
    port_gpt.flash_attention_packed = lambda *a, **k: calls.append(1) or packed(*a, **k)
    try:
        loss = mod.loss(tb["tokens"], tb["labels"], tb["loss_mask"], tb["positions"],
                        tb["segment_ids"])
        grads = torch.autograd.grad(loss, mod.params)
    finally:
        port_gpt.flash_attention_packed = packed
    assert len(calls) == 2 * mod.cfg.num_layers  # the packed branch, forward and recompute
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    got = export_jax_variables(mod.model, dict(zip(
        (name for name, _ in mod.model.named_parameters()), grads)))["params"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, ref in jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(flat_got[path], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_einsum_path_masks_segments_as_jax():
    """The port's einsum branch (attention_backend "xla") with segment ids
    gives JAX's logits on every row, padding rows included (both take the
    mean of v there)."""
    batch = _packed_batch(seed=6)
    jax_cfg = _cfg(jax_config, remat="none")
    tokens = jnp.asarray(batch["tokens"])
    variables = jax.device_get(nn.meta.unbox(JaxGPTModel(jax_cfg).init(jax.random.PRNGKey(1),
                                                                       tokens)))
    want = np.asarray(JaxGPTModel(jax_cfg).apply(
        variables, tokens, jnp.asarray(batch["positions"]),
        segment_ids=jnp.asarray(batch["segment_ids"])))
    model = load_jax_variables(port_gpt.build_model(_cfg(port_config, remat="none"),
                                                    torch.device("cpu"), seed=0), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["positions"]),
                    torch.from_numpy(batch["segment_ids"]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
