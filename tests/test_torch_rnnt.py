"""The RNNT slice of the PyTorch port (nemo_tpu_torch/ops/rnnt.py,
models/asr/modules/rnnt.py, models/asr/rnnt_models.py and the transducer
half of models/asr/synthetic.py) against the JAX package, on the CPU.

The model is a tiny Conformer-Transducer (2 layers, d_model 64, 4 heads, 40
mels, pred_hidden and joint_hidden 32) with both kernel flags set in the
port, so that it takes the kernels' plain versions; the JAX model runs the
XLA conv pair (the Pallas subsampling kernel rounds to bf16 in interpret
mode). Weights are the JAX model's, perturbed and carried by
`load_jax_variables`. Tolerances are fp32's: 1e-5 for the prediction net,
the joint and the loss's value (relative), 1e-4 of each leaf's max for
gradients and trained variables, 1e-4 for the encoder output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nemo_tpu.models.asr import synthetic as jax_synthetic  # noqa: E402
from nemo_tpu.models.asr.configs import conformer_transducer as jax_conformer_transducer  # noqa: E402,E501
from nemo_tpu.models.asr.modules.rnnt import (  # noqa: E402
    rnnt_greedy_decode_label_looping as jax_label_looping)
from nemo_tpu.models.asr.rnnt_models import EncDecRNNTModel as JaxEncDecRNNTModel  # noqa: E402
from nemo_tpu.models.asr.rnnt_models import _RNNTNet  # noqa: E402
from nemo_tpu.ops.audio import mel_spectrogram as jax_mel_spectrogram  # noqa: E402
from nemo_tpu.ops.rnnt import rnnt_loss as jax_rnnt_loss  # noqa: E402
from nemo_tpu_torch.core.optim import warmup_cosine_decay_schedule  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables, model_variables)
from nemo_tpu_torch.models.asr import synthetic  # noqa: E402
from nemo_tpu_torch.models.asr.configs import conformer_transducer  # noqa: E402
from nemo_tpu_torch.models.asr.modules import rnnt as rnnt_module  # noqa: E402
from nemo_tpu_torch.models.asr.modules.rnnt import (  # noqa: E402
    rnnt_greedy_decode, rnnt_greedy_decode_label_looping)
from nemo_tpu_torch.models.asr.rnnt_models import EncDecRNNTModel  # noqa: E402
from nemo_tpu_torch.ops.rnnt import rnnt_loss, rnnt_loss_from_log_probs  # noqa: E402
from test_rnnt_loss import numpy_rnnt_nll  # noqa: E402
from test_torch_conformer import perturb  # noqa: E402

LENGTHS = np.array([16000, 11000], np.int32)
BLANK_SHIFT = 2.0  # on the blank logit's bias, so that the random joint emits some blanks


def _tiny(cfg, fused=True, **decoding):
    cfg.encoder.update(n_layers=2, d_model=64, n_heads=4, feat_in=40,
                       att_impl="decomposed_flash", fused_subsampling=fused)
    cfg.preprocessor.features = 40
    cfg.decoder.pred_hidden = 32
    cfg.joint.joint_hidden = 32
    cfg.decoding.update(decoding)
    return cfg


def _port(variables=None, **decoding):
    port = EncDecRNNTModel(_tiny(conformer_transducer("large"), **decoding), device="cpu")
    return port if variables is None else load_jax_variables(port, variables)


@pytest.fixture(scope="module")
def models():
    """(JAX model with the XLA conv pair, port model, the variables). The
    variables are the port's seed-0 weights, exported and perturbed (a flax
    init would compile the whole model); the JAX tree's structure is held
    to flax's own in `test_jax_variables_round_trip_and_are_strict`."""
    variables = perturb(export_jax_variables(_port()), np.random.RandomState(1))
    variables["params"]["joint"]["out_proj"]["bias"][-1] += BLANK_SHIFT
    jax_model = JaxEncDecRNNTModel(_tiny(jax_conformer_transducer("large"), fused=False),
                                   init_params=False)
    jax_model.variables = variables
    return jax_model, _port(variables), variables


def _apply(jax_model, method, *args):
    return jax.device_get(jax_model.net.apply(jax_model.variables, *args, method=method))


def _audio():
    x = 0.1 * np.random.RandomState(0).randn(2, 16000).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0
    return x


def test_prediction_network_matches_jax(models):
    """The U+1-step training pass and the decode step (from SOS, then from
    tokens) against JAX's, fp32, within 1e-5."""
    jax_model, port, _ = models
    rng = np.random.RandomState(2)
    targets = rng.randint(0, 28, (3, 6)).astype(np.int32)
    ref = _apply(jax_model, _RNNTNet.predict, jnp.asarray(targets))
    with torch.no_grad():
        out = port.predict(torch.from_numpy(targets))
    assert out.shape == (3, 7, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    state = tuple((jnp.zeros((3, 32)), jnp.zeros((3, 32))) for _ in range(1))
    tstate = port.prediction.initial_state(3)
    for token in (np.full(3, -1, np.int32), targets[:, 0], targets[:, 1]):
        ref_out, state = _apply(jax_model, _RNNTNet.pred_step, jnp.asarray(token), state)
        with torch.no_grad():
            out, tstate = port.pred_step(torch.from_numpy(token), tstate)
        np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=1e-5)
        for (c, h), (rc, rh) in zip(tstate, state):
            np.testing.assert_allclose(c.numpy(), rc, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(h.numpy(), rh, atol=1e-5, rtol=1e-5)


def test_joint_and_fused_log_probs_match_jax(models):
    """The broadcast joint [B,T,1,H] x [B,1,U+1,H] and the decode joint [B,H]
    x [B,H] against JAX's; the chunked planes against JAX's and against the
    log-softmax of the full joint (a bf16 encoder output is promoted to
    fp32, as flax does)."""
    jax_model, port, _ = models
    rng = np.random.RandomState(3)
    B, T, U = 2, 37, 5
    enc = rng.randn(B, T, 64).astype(np.float32)
    pred = rng.randn(B, U + 1, 32).astype(np.float32)
    targets = rng.randint(0, 28, (B, U)).astype(np.int32)
    ref = _apply(jax_model, _RNNTNet.joint_logits, jnp.asarray(enc)[:, :, None],
                 jnp.asarray(pred)[:, None])
    with torch.no_grad():
        full = port.joint_logits(torch.from_numpy(enc)[:, :, None], torch.from_numpy(pred)[:, None])
        step = port.joint_logits(torch.from_numpy(enc[:, 4]), torch.from_numpy(pred[:, 2]))
    assert full.shape == (B, T, U + 1, 29) and full.dtype == torch.float32
    np.testing.assert_allclose(full.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(step.numpy(), ref[:, 4, 2], atol=1e-5, rtol=1e-5)

    fused = jax_model.net.apply(
        jax_model.variables, jnp.asarray(enc), jnp.asarray(pred), jnp.asarray(targets),
        method=lambda net, e, p, t: net.joint.fused_log_probs(e, p, t, 16))
    lp = torch.log_softmax(full, -1)
    tgt = torch.from_numpy(np.concatenate([targets, np.zeros((B, 1), np.int32)], 1)).long()
    from_full = (lp[..., 28], lp.gather(3, tgt[:, None, :, None].expand(B, T, U + 1, 1))[..., 0])
    for dtype in (torch.float32, torch.bfloat16):
        e = torch.from_numpy(enc).to(dtype)
        with torch.no_grad():
            planes = port.joint.fused_log_probs(e, torch.from_numpy(pred),
                                                torch.from_numpy(targets), chunk=16)
        want = fused if dtype == torch.float32 else jax.device_get(
            jax_model.net.apply(jax_model.variables, jnp.asarray(e.float().numpy()),
                                jnp.asarray(pred), jnp.asarray(targets),
                                method=lambda net, e, p, t: net.joint.fused_log_probs(e, p, t)))
        for got, ref_plane, full_plane in zip(planes, want, from_full):
            assert got.shape == (B, T, U + 1) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_plane), atol=1e-5, rtol=1e-5)
            if dtype == torch.float32:
                np.testing.assert_allclose(got.numpy(), full_plane.numpy(), atol=1e-5)


def test_model_losses_match_jax(models):
    """`loss_fused` (the memory-chunked training loss) against JAX's on the
    same batch: the value within 1e-5 relative, and the gradient of every
    prediction and joint leaf against JAX's autodiff within 1e-4 of the
    leaf's max. The full joint's `loss` on `forward`'s logits against it in
    value (1e-5) and in every gradient (1e-4 of each leaf's max, plus 1e-6
    of the largest gradient for the leaves whose exact gradient is 0, such
    as linear_k's bias, which hold only the rounding of sums of such
    gradients)."""
    jax_model, port, variables = models
    x = _audio()
    targets = np.random.RandomState(5).randint(1, 12, (2, 4)).astype(np.int32)
    t_len = np.array([4, 3], np.int32)
    heads = ("prediction", "joint")

    def jax_loss(head):
        return jax_model.loss_fused(
            {**variables, "params": {**variables["params"], **head}}, jnp.asarray(x),
            jnp.asarray(LENGTHS), jnp.asarray(targets), jnp.asarray(t_len), chunk=16)

    ref, ref_grads = jax.value_and_grad(jax_loss)({k: variables["params"][k] for k in heads})
    ref, ref_grads = float(ref), jax.device_get(ref_grads)
    args = [torch.from_numpy(a) for a in (x, LENGTHS, targets, t_len)]
    names, leaves = zip(*port.named_parameters())
    fused = port.loss_fused(*args, chunk=16)
    logits, enc_len = port(*port.mel_features(*args[:2]), args[2])
    full = port.loss(logits, args[2], enc_len, args[3])
    assert float(fused.detach()) == pytest.approx(ref, rel=1e-5)
    assert float(full.detach()) == pytest.approx(ref, rel=1e-5)
    grads = torch.autograd.grad(full, leaves)
    fused_grads = torch.autograd.grad(fused, leaves)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads)
    for g, want in zip(fused_grads, grads):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()) + floor)

    values = {k: torch.zeros_like(v) for k, v in model_variables(port).items()}
    values.update(zip(names, fused_grads))
    tree = export_jax_variables(port, values)["params"]
    flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(flat) == sum(name.split(".")[0] in heads for name in names)
    for path, want in flat:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


def _numpy_rnnt_grad(lp_blank, lp_label, T, U):
    """d(-log p)/d lp of the RNNT lattice by the forward-backward recursion:
    the occupation of each blank and label transition (one sample)."""
    alpha = np.full((T, U + 1), -np.inf)
    beta = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U + 1):
            c = [alpha[t, u]] if t == u == 0 else []
            if t > 0:
                c.append(alpha[t - 1, u] + lp_blank[t - 1, u])
            if u > 0:
                c.append(alpha[t, u - 1] + lp_label[t, u - 1])
            alpha[t, u] = np.logaddexp.reduce(c)
    beta[T - 1, U] = lp_blank[T - 1, U]
    for t in range(T - 1, -1, -1):
        for u in range(U, -1, -1):
            if t == T - 1 and u == U:
                continue
            c = []
            if t < T - 1:
                c.append(beta[t + 1, u] + lp_blank[t, u])
            if u < U:
                c.append(beta[t, u + 1] + lp_label[t, u])
            beta[t, u] = np.logaddexp.reduce(c)
    ll = beta[0, 0]
    g_blank = np.zeros_like(lp_blank)
    g_label = np.zeros_like(lp_label)
    g_blank[:T - 1, :U + 1] = -np.exp(alpha[:-1] + lp_blank[:T - 1, :U + 1] + beta[1:] - ll)
    g_blank[T - 1, U] = -np.exp(alpha[T - 1, U] + lp_blank[T - 1, U] - ll)
    g_label[:T, :U] = -np.exp(alpha[:, :-1] + lp_label[:T, :U] + beta[:, 1:] - ll)
    return -ll, g_blank, g_label


@pytest.mark.parametrize("seed", [0, 1])
def test_rnnt_loss_matches_jax_and_numpy(seed):
    """The NLL of ragged frames and targets against JAX's and a numpy DP
    (value within 1e-5 relative), and its gradient with respect to the
    logits against JAX's autodiff and with respect to the two planes against
    a numpy forward-backward (within 1e-4 of the gradient's max)."""
    rng = np.random.RandomState(seed)
    B, T, U, V = 3, 23, 6, 8  # V counts the blank, last
    logits = (2 * rng.randn(B, T, U + 1, V)).astype(np.float32)
    targets = rng.randint(0, V - 1, (B, U)).astype(np.int32)
    f_len = np.array([T, T - 4, T - 11], np.int32)
    t_len = np.array([U, U - 2, U - 5], np.int32)
    args = [jnp.asarray(a) for a in (targets, f_len, t_len)]
    ref = np.asarray(jax_rnnt_loss(jnp.asarray(logits), *args))
    ref_grad = np.asarray(jax.grad(lambda x: jnp.sum(jax_rnnt_loss(x, *args)))(jnp.asarray(logits)))

    x = torch.from_numpy(logits).requires_grad_(True)
    nll = rnnt_loss(x, *(torch.from_numpy(a) for a in (targets, f_len, t_len)))
    (grad,) = torch.autograd.grad(nll.sum(), x)
    assert nll.dtype == torch.float32 and nll.shape == (B,)
    np.testing.assert_allclose(nll.detach().numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0,
                               atol=1e-4 * np.abs(ref_grad).max())

    lp = torch.log_softmax(torch.from_numpy(logits).double(), -1).numpy()
    for b in range(B):
        Tb, Ub = int(f_len[b]), int(t_len[b])
        lp_blank = lp[b, ..., V - 1]
        lp_label = np.take_along_axis(
            lp[b], np.concatenate([targets[b], [0]])[None, :, None].repeat(T, 0), 2)[..., 0]
        want = numpy_rnnt_nll(lp[b], targets[b], Tb, Ub, V - 1)
        value, g_blank, g_label = _numpy_rnnt_grad(lp_blank, lp_label, Tb, Ub)
        assert value == pytest.approx(want, rel=1e-12)
        np.testing.assert_allclose(nll[b].item(), want, rtol=1e-5)
        planes = [torch.from_numpy(p[None].astype(np.float32)).requires_grad_(True)
                  for p in (lp_blank, lp_label)]
        out = rnnt_loss_from_log_probs(*planes, torch.tensor([Tb]), torch.tensor([Ub + 1]))
        got = torch.autograd.grad(out.sum(), planes)
        for g, want_g in zip(got, (g_blank, g_label)):
            np.testing.assert_allclose(g[0].numpy(), want_g, rtol=0,
                                       atol=1e-4 * np.abs(want_g).max())


def _numpy_transducer(V=5, H=8, seed=0):
    """A tiny transducer defined by numpy weights, as jnp and torch
    functions: joint = enc Wj_e + pred Wj_p, prediction = an embedding
    recurrence (tests/test_rnnt_decoding.py's)."""
    rng = np.random.RandomState(seed)
    Wj_e, Wj_p = (rng.randn(H, V + 1).astype(np.float32) * 0.7 for _ in range(2))
    emb = rng.randn(V + 1, H).astype(np.float32)

    def fns(xp, asarray, where, maximum):
        we, wp, em = asarray(Wj_e), asarray(Wj_p), asarray(emb)

        def joint_fn(enc_t, pred_out):
            return enc_t @ we + pred_out @ wp

        def pred_step_fn(token, state):
            (h,) = state
            e = where((token >= 0)[:, None], em[maximum(token, 0)], 0.0)
            h = 0.6 * h + 0.4 * e
            return h, (h,)
        return joint_fn, pred_step_fn

    jax_fns = fns(jnp, jnp.asarray, jnp.where, lambda t, m: jnp.maximum(t, m))
    torch_fns = fns(torch, torch.from_numpy, torch.where, lambda t, m: t.clamp(min=m).long())
    return jax_fns, torch_fns, V, H


@pytest.mark.parametrize("seed,max_symbols,bias", [(0, 4, 0.0), (2, 3, 0.0), (1, 2, -6.0)])
def test_decoders_match_jax(seed, max_symbols, bias, monkeypatch):
    """Label looping and the frame loop, driven by the same numpy-defined
    joint and prediction functions, against JAX's label looping: tokens and
    counts exactly equal. bias -6 on the blank logit makes every row emit
    max_symbols at every frame: the buffer fills to T·max_symbols and the
    loop runs to its cap. Reading the loop's condition every loop, every
    CHECK_EVERY loops or only at the start (the loop then runs to iters_cap,
    the cap exactly) gives the same tokens."""
    (jax_joint, jax_pred), (joint, pred), V, H = _numpy_transducer(seed=seed)
    rng = np.random.RandomState(seed + 10)
    B, T = 3, 12
    enc = rng.randn(B, T, H).astype(np.float32)
    enc_len = np.array([12, 7, 10], np.int32)

    def jax_joint_b(e, p):
        return jax_joint(e, p).at[:, V].add(bias)

    def joint_b(e, p):
        out = joint(e, p)
        out[:, V] += bias
        return out

    ref_tok, ref_n = jax.device_get(jax_label_looping(
        jax_joint_b, jax_pred, (jnp.zeros((B, H)),), jnp.asarray(enc), jnp.asarray(enc_len),
        blank=V, max_symbols=max_symbols))
    if bias < 0:
        np.testing.assert_array_equal(ref_n, enc_len * max_symbols)
    cap = T * (max_symbols + 1) + 1
    runs = [(rnnt_greedy_decode, None), (rnnt_greedy_decode_label_looping, 1),
            (rnnt_greedy_decode_label_looping, rnnt_module.CHECK_EVERY),
            (rnnt_greedy_decode_label_looping, 10 ** 6)]
    for decode, check_every in runs:
        if check_every:
            monkeypatch.setattr(rnnt_module, "CHECK_EVERY", check_every)
        tok, n, loops = decode(joint_b, pred, (torch.zeros(B, H),), torch.from_numpy(enc),
                               torch.from_numpy(enc_len), blank=V, max_symbols=max_symbols)
        assert tok.dtype == torch.int32 and tok.shape == (B, T * max_symbols)
        np.testing.assert_array_equal(n.numpy(), ref_n)
        np.testing.assert_array_equal(tok.numpy(), ref_tok)  # the -1 padding too
        if check_every == 1:  # JAX's count: every row's frames + emissions
            assert loops == int((enc_len + ref_n).max())
        elif check_every == 10 ** 6:
            assert loops == cap


def _encode_jax(jax_model, x):
    feats, feat_len = jax_mel_spectrogram(jnp.asarray(x), jnp.asarray(LENGTHS), jax_model.mel_cfg,
                                          training=False)
    return _apply(jax_model, _RNNTNet.encode, feats, feat_len)


def test_model_matches_jax(models):
    """The encoder output on valid frames within 1e-4; the decode tokens of
    int16 PCM (and of its float value) and the texts equal, with label
    looping and with the frame loop. The tokens may differ only after a near-tie of the
    JAX joint's top two logits (2e-3, the rule of chip_smoke.py's phase 18);
    on this model they do not differ at all."""
    jax_model, port, variables = models
    x = _audio()
    enc, enc_len = _encode_jax(jax_model, x)
    with torch.no_grad():
        out, out_len = port.encode(*port.mel_features(torch.from_numpy(x),
                                                      torch.from_numpy(LENGTHS)))
    np.testing.assert_array_equal(out_len.numpy(), enc_len)
    for b, t in enumerate(enc_len):
        np.testing.assert_allclose(out[b, :t].numpy(), enc[b, :t], atol=1e-4, rtol=1e-4)

    pcm = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
    ref_tok, ref_n = jax.device_get(jax_model._jit_decode(
        jax_model.variables, jnp.asarray(pcm), jnp.asarray(LENGTHS)))
    assert 0 < ref_n.min() and ref_n.max() < enc_len.max() * port.max_symbols
    for model in (port, _port(variables, strategy="greedy")):
        tok, n = model.decode(torch.from_numpy(pcm), torch.from_numpy(LENGTHS))
        np.testing.assert_array_equal(n.numpy(), ref_n)
        np.testing.assert_array_equal(tok.numpy(), ref_tok)
    # int16 PCM decodes as its float value
    tok, n = port.decode(torch.from_numpy(pcm.astype(np.float32) / 32768),
                         torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    texts = ["".join(port.labels[i] for i in ref_tok[b, :ref_n[b]]) for b in range(2)]
    assert port.transcribe_staged([(torch.from_numpy(pcm), torch.from_numpy(LENGTHS), 2)]) == texts


def test_transcribe_staged_matches_transcribe(models, monkeypatch):
    _, port, _ = models
    x = _audio()
    padded = np.pad(x, ((0, 0), (0, 16384 - 16000)))  # transcribe's power-of-two bucket
    staged = [(torch.from_numpy(padded), torch.from_numpy(LENGTHS), 2)] * 2
    loops, decode = [], port.decode

    def counted(*args):
        out = decode(*args)
        loops.append(port.last_loop_iterations)
        return out
    monkeypatch.setattr(port, "decode", counted)
    out = port.transcribe_staged(staged)
    assert len(loops) == 2 and min(loops) > 0  # one decode a batch
    assert out == port.transcribe([x[0], x[1, :LENGTHS[1]]] * 2, batch_size=2)
    assert all(out)


def test_jax_variables_round_trip_and_are_strict(models):
    """The exported tree has flax's structure and shapes (of the JAX model's
    init, traced without compiling); export(load(tree)) is the tree, leaf
    for leaf; a missing LSTM kernel, an extra LSTM key or a wrong shape
    raises."""
    jax_model, _, variables = models
    flax_tree = jax.eval_shape(lambda: jax_model.net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 40, 128)), jnp.array([128]),
        jnp.zeros((1, 4), jnp.int32), train=False))
    assert jax.tree_util.tree_structure(flax_tree) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(flax_tree), jax.tree_util.tree_leaves(variables)):
        assert a.shape == b.shape and a.dtype == b.dtype
    port = _port(variables)
    tree = export_jax_variables(port)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len(jax.tree_util.tree_leaves(tree)) == len(flat)
    for path, want in flat:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    lstm = ("params", "prediction", "rnn", "lstm0")

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, variables)
        node = tree
        for key in lstm:
            node = node[key]
        fn(node)
        return tree

    with pytest.raises(KeyError, match="lstm0/if/kernel"):
        load_jax_variables(_port(), edited(lambda n: n.pop("if")))
    with pytest.raises(ValueError, match="lstm0/ii/bias"):
        load_jax_variables(_port(), edited(lambda n: n["ii"].update(bias=np.zeros(32, np.float32))))
    with pytest.raises(ValueError, match="lstm0/hg/kernel"):
        load_jax_variables(_port(), edited(lambda n: n["hg"].update(
            kernel=np.zeros((32, 31), np.float32))))
    grads = {k: torch.zeros_like(v) for k, v in port.named_parameters()}
    del grads["prediction.rnn.lstm0.ho.bias"]
    with pytest.raises(KeyError, match="lstm0.ho.bias"):
        export_jax_variables(port, grads)


SECS, BATCH, TOKENS = 1.0, 2, 4


def _jax_probe(d_enc, blank, seed):
    """JAX's framewise_calibrate probe (synthetic.py:230-234): w from
    jax.random, whose bits the port does not draw, so it is handed over."""
    w = jax.random.normal(jax.random.PRNGKey(seed), (d_enc, blank + 1), jnp.float32) * 0.02
    return {"w": np.asarray(w), "b": np.zeros(blank + 1, np.float32)}


def test_calibration_steps_match_jax(models, monkeypatch):
    """Two framewise steps of the transducer branch of `framewise_calibrate`
    (the probe is JAX's) and the two head-only `fit_synthetic_asr` steps it
    runs after them, against JAX: every loss within 1e-4 relative, and every
    variable after the steps within 1e-4 of its leaf's max (BatchNorm stats
    included). linear_k's bias has an exact gradient of 0; Adam normalises
    its rounding noise (~1e-9) to steps of up to the learning rate in both,
    so it is held to the rate of the one step that moves it (2e-4)."""
    jax_model, _, variables = models
    port = _port(variables)
    d_enc, blank = 64, 28
    losses = {"jax": {}, "port": {}}

    def recording(module, key):
        fit = module.fit_synthetic_asr

        def wrapper(*args, **kw):
            losses[key]["fit"] = fit(*args, **kw)
            return losses[key]["fit"]
        monkeypatch.setattr(module, "fit_synthetic_asr", wrapper)

    recording(jax_synthetic, "jax")
    recording(synthetic, "port")
    jax_model = JaxEncDecRNNTModel(_tiny(jax_conformer_transducer("large"), fused=False),
                                   init_params=False)
    jax_model.variables = variables
    losses["jax"]["framewise"] = jax_synthetic.framewise_calibrate(
        jax_model, steps=2, batch=BATCH, secs=SECS, utt_tokens=TOKENS, seed=0)
    steps = []
    losses["port"]["framewise"] = synthetic.framewise_calibrate(
        port, steps=2, batch=BATCH, secs=SECS, utt_tokens=TOKENS, seed=0,
        probe=_jax_probe(d_enc, blank, 0), on_step=lambda i, x: steps.append(float(x)),
        log=lambda msg: None)
    assert steps[-1] == losses["port"]["framewise"]
    for key in ("framewise", "fit"):
        assert losses["port"][key] == pytest.approx(losses["jax"][key], rel=1e-4), key

    tree = export_jax_variables(port)
    for path, want in jax.tree_util.tree_flatten_with_path(jax.device_get(jax_model.variables))[0]:
        got = tree
        for key in path:
            got = got[key.key]
        name = jax.tree_util.keystr(path)
        tol = 1e-4 * np.abs(want).max() + (2e-4 if "linear_k" in name and "bias" in name else 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def test_probe_step_decays_the_head_as_optax(models):
    """In the framewise steps a transducer's prediction and joint leaves get a
    zero gradient, and AdamW's weight decay still moves them, as optax
    moves a leaf of the (variables, probe) tuple that has no gradient. At
    lr 0.5 (0.1 on the second step) the decay is ~1e-5 of each value,
    visible in fp32; the head fit is left out by stopping after the
    framewise steps."""
    *_, variables = models
    port = _port(variables)
    head0 = {k: v.detach().clone() for k, v in port.named_parameters()
             if k.split(".")[0] in ("prediction", "joint")}
    sched = warmup_cosine_decay_schedule(0.0, 0.5, 5, 10, 0.5 / 30)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 0.5, 5, 10, 0.5 / 30)))

    @jax.jit
    def two_steps(params):
        state = tx.init(params)
        for _ in range(2):
            zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
            updates, state = tx.update(zeros, state, params)
            params = optax.apply_updates(params, updates)
        return params

    params = jax.device_get(two_steps({k: jnp.asarray(v.numpy()) for k, v in head0.items()}))
    assert sched(1) == pytest.approx(0.1)

    class Stop(Exception):
        pass

    def stop(i, loss):
        if i == 1:
            raise Stop

    with pytest.raises(Stop):
        synthetic.framewise_calibrate(port, steps=2, batch=BATCH, secs=SECS, utt_tokens=TOKENS,
                                      lr=0.5, on_step=stop, log=lambda msg: None)
    for k, v in port.named_parameters():
        if k in head0:
            want = np.asarray(params[k])
            np.testing.assert_allclose(v.detach().numpy(), want, rtol=2e-7, atol=0, err_msg=k)
            moved = v.detach() != head0[k]
            assert moved.float().mean() > 0.9, k  # the decay shows in fp32


def test_trim_blank_bias_moves_only_the_blank_bias(models):
    *_, variables = models
    port = _port(variables)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    delta, density = synthetic.trim_blank_bias(port, SECS, TOKENS, batch=2)
    bias = port.joint.out_proj.bias.detach()
    for k, v in port.named_parameters():
        if k != "joint.out_proj.bias":
            assert torch.equal(v, before[k]), k
    assert torch.equal(bias[:-1], before["joint.out_proj.bias"][:-1])
    assert bias[-1].item() == pytest.approx(before["joint.out_proj.bias"][-1].item() + delta)
    assert delta != 0.0 and density >= 0.0


def test_unported_options_raise(models):
    *_, variables = models
    for strategy in ("beam", "maes"):
        with pytest.raises(NotImplementedError, match="not ported"):
            _port(strategy=strategy)
    port = _port(variables)
    port.decoding_strategy = "beam"
    with pytest.raises(NotImplementedError, match="not ported"):
        port.decode(torch.zeros(1, 16000), torch.tensor([16000]))
    cfg = _tiny(conformer_transducer("large"))  # TDT is ported: tests/test_torch_tdt.py
    cfg.model_defaults = {"big_blank_durations": [0, 1, 2]}
    with pytest.raises(NotImplementedError, match="multiblank .* not ported"):
        EncDecRNNTModel(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        port.set_ngram_lm(object())
    with pytest.raises(NotImplementedError, match="make_train_step"):
        synthetic.fit_synthetic_asr(port, steps=1, head_only=False)


def test_model_runs_on_cuda_unless_asked():
    """No device means CUDA: without a card the model raises rather than
    running quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncDecRNNTModel(_tiny(conformer_transducer("large")))
