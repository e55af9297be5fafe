"""Tone calibration of the PyTorch port (nemo_tpu_torch/models/asr/
synthetic.py, core/optim.py) against the JAX package.

- The tone data (`tone_audio`, the frame labels, `make_eval_batch`) is
  bit-identical to the JAX package's for the same seed.
- The port's clip + AdamW + warmup-cosine schedule matches optax's chain on
  a fixed sequence of gradients, across warmup and decay, within 1e-6.
- A tiny Conformer-CTC (2 layers, d_model 64, 1 s clips, batch 2; the port
  with `att_impl="decomposed_flash"` and `fused_subsampling=True`, its
  training forward through the conv pair) on weights carried from JAX: the
  first step's gradients of every variable, BatchNorm stats included, match
  `jax.value_and_grad` of the JAX calibration loss, and the losses of three
  calibration steps match those of the JAX step (synthetic.py:245-268).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nemo_tpu.models.asr import synthetic as jax_synthetic  # noqa: E402
from nemo_tpu.models.asr.configs import conformer_ctc as jax_conformer_ctc  # noqa: E402
from nemo_tpu.models.asr.ctc_models import EncDecCTCModel as JaxEncDecCTCModel  # noqa: E402
from nemo_tpu.ops.audio import mel_spectrogram as jax_mel_spectrogram  # noqa: E402
from nemo_tpu_torch.core.optim import ClippedAdamW, warmup_cosine_decay_schedule  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables, model_variables)
from nemo_tpu_torch.models.asr import synthetic  # noqa: E402
from nemo_tpu_torch.models.asr.configs import conformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel  # noqa: E402
from test_torch_conformer import perturb  # noqa: E402

SECS, BATCH, TOKENS, SR = 1.0, 2, 4, 16000


def test_tone_data_is_bit_identical_to_jax():
    targets = np.random.RandomState(0).randint(1, 12, (3, 7))
    audio = synthetic.tone_audio(targets, 1.5, SR, np.random.RandomState(4))
    ref = jax_synthetic.tone_audio(targets, 1.5, SR, np.random.RandomState(4))
    assert audio.dtype == ref.dtype and np.array_equal(audio, ref)
    for Tprime in (38, 751):
        np.testing.assert_array_equal(synthetic.frame_labels(targets, 1.5, Tprime, 28, SR),
                                      jax_synthetic._frame_labels(targets, 1.5, Tprime, 28, SR))
    model = SimpleNamespace(labels=list("abcdefghijklmnopqrstuvwxyz '"), sample_rate=SR)
    for got, want in zip(synthetic.make_eval_batch(model, 2, 2.0, 9, seed=101),
                         jax_synthetic.make_eval_batch(model, 2, 2.0, 9, seed=101)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_optimizer_matches_optax():
    """14 steps of the schedule of a 12-step calibration (5 warmup steps,
    decay to step 12, then flat), gradients that are clipped on some steps
    and not on others, over fp32 leaves and one bf16 leaf (fp32 master);
    within 1e-6."""
    lr, steps = 1e-3, 12
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 2, 2), (4,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * (0.3 if i % 3 else 4.0)).astype(np.float32) for s in shapes]
             for i in range(14)]

    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(steps // 10, 5), max(steps, 10),
                                               lr / 30.0)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(sched))
    leaves = [torch.from_numpy(x.copy()) for x in init[:-1]]
    leaves.append(torch.from_numpy(init[-1]).to(torch.bfloat16))
    # the bf16 leaf's master starts at its bf16 value, so optax starts there too
    ref_init = init[:-1] + [leaves[-1].float().numpy()]
    params = [jnp.asarray(x) for x in ref_init]
    state = tx.init(params)
    ref = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        ref.append([np.asarray(x) for x in params])

    schedule = warmup_cosine_decay_schedule(0.0, lr, max(steps // 10, 5), max(steps, 10),
                                            lr / 30.0)
    for i in range(16):
        assert abs(schedule(i) - float(sched(i))) < 1e-9, i
    opt = ClippedAdamW(leaves, schedule)
    norms = []
    for g, want in zip(grads, ref):
        norms.append(float(opt.step([torch.from_numpy(x) for x in g])))
        for master, w in zip(opt.masters, want):
            np.testing.assert_allclose(master.numpy(), w, atol=1e-6, rtol=0)
        assert torch.equal(leaves[-1], opt.masters[-1].to(torch.bfloat16))
        assert leaves[0] is not opt.masters[0] and torch.equal(leaves[0], opt.masters[0])
    assert min(norms) < 5.0 < max(norms)  # clipped on some steps only


def _tiny(cfg, fused):
    cfg.encoder.update(n_layers=2, d_model=64, n_heads=4, feat_in=40,
                       att_impl="decomposed_flash", fused_subsampling=fused)
    cfg.preprocessor.features = 40
    cfg.decoder.feat_in = 64
    return cfg


def _jax_calibration_run(jax_model, variables, steps, Tprime, seed=0, lr=1e-3):
    """The JAX package's calibration step (synthetic.py:231-277, CTC branch)
    over `steps` steps: (loss per step, the first step's gradients)."""
    rng = np.random.RandomState(seed)
    V, blank = min(len(jax_model.labels), 12), len(jax_model.labels)
    T = int(SR * SECS)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(steps // 10, 5), max(steps, 10),
                                               lr / 30.0)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(sched))

    @jax.jit
    def step(state, opt_state, signal, length, labels):
        def f(st):
            feats, feat_len = jax_mel_spectrogram(signal, length, jax_model.mel_cfg,
                                                  training=False)
            lp, _ = jax_model.net.apply(st, feats, feat_len)
            lp = lp.astype(jnp.float32)[:, :labels.shape[1]]
            return -jnp.mean(jnp.take_along_axis(lp, labels[..., None], -1)[..., 0])

        loss, grads = jax.value_and_grad(f)(state)
        updates, opt_state = tx.update(grads, opt_state, state)
        return optax.apply_updates(state, updates), opt_state, loss, grads

    state = jax.tree_util.tree_map(jnp.asarray, variables)
    opt_state = tx.init(state)
    lens = jnp.full((BATCH,), T, jnp.int32)
    losses, first = [], None
    for _ in range(steps):
        targets = rng.randint(1, V, (BATCH, TOKENS))
        audio = jax_synthetic.tone_audio(targets, SECS, SR, rng)
        labels = jax_synthetic._frame_labels(targets, SECS, Tprime, blank, SR)
        state, opt_state, loss, grads = step(state, opt_state, jnp.asarray(audio), lens,
                                             jnp.asarray(labels))
        losses.append(float(loss))
        first = jax.device_get(grads) if first is None else first
    return losses, first


def test_calibration_matches_jax():
    """First-step gradients of every variable within 1e-4 of the leaf's
    max-abs plus 1e-7 (an absolute floor for leaves whose gradient is zero
    in exact arithmetic, e.g. linear_k's bias, which cancels in the softmax),
    and the losses of 3 steps within 1e-4 (fp32 throughout)."""
    jax_model = JaxEncDecCTCModel(_tiny(jax_conformer_ctc("large"), fused=False))
    variables = perturb(jax.device_get(jax_model.variables), np.random.RandomState(1))
    port = EncDecCTCModel(_tiny(conformer_ctc("large"), fused=True), device="cpu")
    load_jax_variables(port, variables)
    T = int(SR * SECS)
    Tprime = int(port.encoded_length(torch.tensor([T]))[0])
    jax_losses, jax_grads = _jax_calibration_run(jax_model, variables, 3, Tprime)

    # the port's first step on the same batch
    rng = np.random.RandomState(0)
    targets = rng.randint(1, 12, (BATCH, TOKENS))
    audio = synthetic.tone_audio(targets, SECS, SR, rng)
    labels = synthetic.frame_labels(targets, SECS, Tprime, len(port.labels), SR)
    leaves = model_variables(port)
    stats = [t for t in leaves.values() if not isinstance(t, torch.nn.Parameter)]
    for t in stats:
        t.requires_grad_(True)
    loss = synthetic.framewise_loss(port, torch.from_numpy(audio),
                                    torch.full((BATCH,), T, dtype=torch.int32),
                                    torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for t in stats:
        t.requires_grad_(False)
    tree = export_jax_variables(port, dict(zip(leaves, grads)))
    assert set(tree) == {"params", "batch_stats"}
    flat = jax.tree_util.tree_flatten_with_path(jax_grads)[0]
    assert len(flat) == len(leaves)
    for path, want in flat:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))

    losses = []
    synthetic.framewise_calibrate(port, steps=3, batch=BATCH, secs=SECS, utt_tokens=TOKENS,
                                  seed=0, on_step=lambda i, x: losses.append(float(x)),
                                  log=lambda msg: None)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert losses[0] == pytest.approx(float(loss), rel=1e-6)
    assert not any(t.requires_grad for t in stats)  # restored after calibration
