"""The TDT slice of the PyTorch port (nemo_tpu_torch/ops/tdt.py, the TDT
joint of models/asr/modules/rnnt.py, the TDT branches of
models/asr/rnnt_models.py and of models/asr/synthetic.py) against the JAX
package, on the CPU.

The model is a tiny FastConformer-TDT: `fastconformer_ctc("xlarge")`'s
encoder (×8 dw_striding subsampling) cut to 2 layers of d_model 256 over 2
heads (head dim 128, so that the port takes the dh-128 plain versions of
K1, K3 and K4) on 40 mels, conformer_transducer's decoder and joint cut to
32 wide, durations (0, 1, 2, 3, 4). Weights are the port's seed-0 weights,
exported, perturbed and carried into both. Tolerances are fp32's: outputs
within 1e-4 of each row's max-abs value (1e-5 for the joint), the loss
within 1e-5 relative, gradients within 1e-4 of each leaf's max, tokens
equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nemo_tpu.core.config import ConfigDict as JaxConfigDict  # noqa: E402
from nemo_tpu.models.asr import synthetic as jax_synthetic  # noqa: E402
from nemo_tpu.models.asr.configs import fastconformer_ctc as jax_fastconformer_ctc  # noqa: E402
from nemo_tpu.models.asr.rnnt_models import EncDecRNNTModel as JaxEncDecRNNTModel  # noqa: E402
from nemo_tpu.models.asr.rnnt_models import _RNNTNet  # noqa: E402
from nemo_tpu.ops.audio import mel_spectrogram as jax_mel_spectrogram  # noqa: E402
from nemo_tpu.ops.tdt import tdt_greedy_decode as jax_tdt_greedy_decode  # noqa: E402
from nemo_tpu.ops.tdt import tdt_loss as jax_tdt_loss  # noqa: E402
from nemo_tpu_torch.core.config import ConfigDict  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables, model_variables)
from nemo_tpu_torch.models.asr import synthetic  # noqa: E402
from nemo_tpu_torch.models.asr.configs import fastconformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.modules import rnnt as rnnt_module  # noqa: E402
from nemo_tpu_torch.models.asr.rnnt_models import EncDecRNNTModel  # noqa: E402
from nemo_tpu_torch.ops.tdt import tdt_greedy_decode, tdt_loss  # noqa: E402
from test_torch_conformer import perturb  # noqa: E402
from test_torch_fastconformer import _rows_close  # noqa: E402

DURATIONS = (0, 1, 2, 3, 4)
LENGTHS = np.array([16000, 11000], np.int32)
BLANK_SHIFT = -1.0  # on the blank logit's bias, so that the random joint emits some tokens
HEADS = ("prediction", "joint")


def _tiny(cfg, config_dict):
    """The FastConformer-TDT config, cut to test size (either package's
    ConfigDict for the decoder, joint, decoding and model defaults)."""
    cfg.encoder.update(n_layers=2, d_model=256, n_heads=2, feat_in=40,
                       att_impl="decomposed_flash")
    cfg.preprocessor.features = 40
    cfg.decoder = config_dict(pred_hidden=32, pred_rnn_layers=1, vocabulary=cfg.labels)
    cfg.joint = config_dict(joint_hidden=32)
    cfg.decoding = config_dict(strategy="greedy_batch", max_symbols=10)
    cfg.model_defaults = config_dict(tdt_durations=DURATIONS)
    return cfg


def _port(variables=None):
    port = EncDecRNNTModel(_tiny(fastconformer_ctc("xlarge"), ConfigDict), device="cpu")
    return port if variables is None else load_jax_variables(port, variables)


def _jax_model(variables):
    model = JaxEncDecRNNTModel(_tiny(jax_fastconformer_ctc("xlarge"), JaxConfigDict),
                               init_params=False)
    model.variables = variables
    return model


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, the variables): the port's seed-0 weights,
    exported and perturbed (a flax init would compile the whole model); the
    JAX tree's structure is held to flax's own in
    `test_tdt_variables_round_trip_and_are_strict`."""
    variables = perturb(export_jax_variables(_port()), np.random.RandomState(1))
    variables["params"]["joint"]["out_proj"]["bias"][-1] += BLANK_SHIFT
    return _jax_model(variables), _port(variables), variables


def _apply(jax_model, method, *args):
    return jax.device_get(jax_model.net.apply(jax_model.variables, *args, method=method))


def _audio():
    x = 0.1 * np.random.RandomState(0).randn(2, 16000).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0
    return x


def test_tdt_joint_matches_jax(models):
    """The TDT joint, broadcast [B,T,1,H] x [B,1,U+1,H] and per decode step
    [B,H] x [B,H]: token logits [.., V+1] and duration logits [.., 5]
    against JAX's, within 1e-5."""
    jax_model, port, _ = models
    rng = np.random.RandomState(3)
    enc = rng.randn(2, 9, 256).astype(np.float32)
    pred = rng.randn(2, 4, 32).astype(np.float32)
    ref_tok, ref_dur = _apply(jax_model, _RNNTNet.joint_logits, jnp.asarray(enc)[:, :, None],
                              jnp.asarray(pred)[:, None])
    with torch.no_grad():
        tok, dur = port.joint_logits(torch.from_numpy(enc)[:, :, None],
                                     torch.from_numpy(pred)[:, None])
        step_tok, step_dur = port.joint_logits(torch.from_numpy(enc[:, 4]),
                                               torch.from_numpy(pred[:, 2]))
    assert tok.shape == (2, 9, 4, 29) and dur.shape == (2, 9, 4, 5)
    for got, want in ((tok, ref_tok), (dur, ref_dur), (step_tok, ref_tok[:, 4, 2]),
                      (step_dur, ref_dur[:, 4, 2])):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_tdt_loss_matches_jax(seed):
    """`tdt_loss` against JAX's on random logits at ragged frame and target
    lengths (a row of one frame, a row of no targets): every value within
    1e-5 relative, the gradients in both logit tensors within 1e-4 of their
    max."""
    rng = np.random.RandomState(seed)
    B, T, U, V1 = 4, 9, 4, 6
    tok = rng.randn(B, T, U + 1, V1).astype(np.float32) * 2
    dur = rng.randn(B, T, U + 1, len(DURATIONS)).astype(np.float32)
    targets = rng.randint(0, V1 - 1, (B, U)).astype(np.int32)
    f_len = np.array([9, 7, 1, 5], np.int32)
    t_len = np.array([4, 2, 1, 0], np.int32)

    def jax_sum(a, b):
        return jnp.sum(jax_tdt_loss(a, b, jnp.asarray(targets), jnp.asarray(f_len),
                                    jnp.asarray(t_len), DURATIONS))

    ref = np.asarray(jax_tdt_loss(jnp.asarray(tok), jnp.asarray(dur), jnp.asarray(targets),
                                  jnp.asarray(f_len), jnp.asarray(t_len), DURATIONS))
    ref_grads = jax.grad(jax_sum, argnums=(0, 1))(jnp.asarray(tok), jnp.asarray(dur))
    a, b = (torch.from_numpy(x).requires_grad_() for x in (tok, dur))
    nll = tdt_loss(a, b, torch.from_numpy(targets), torch.from_numpy(f_len),
                   torch.from_numpy(t_len), DURATIONS)
    assert nll.dtype == torch.float32 and nll.shape == (B,)
    np.testing.assert_allclose(nll.detach().numpy(), ref, rtol=1e-5, atol=0)
    for g, r in zip(torch.autograd.grad(nll.sum(), (a, b)), ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * np.abs(r).max(), rtol=0)


def _numpy_tdt(V=5, H=8, seed=0):
    """A tiny TDT transducer defined by numpy weights, as jnp and torch
    functions: token and duration logits linear in the frame and the
    prediction output, the prediction an embedding recurrence."""
    rng = np.random.RandomState(seed)
    We, Wp = (rng.randn(H, V + 1).astype(np.float32) * 0.7 for _ in range(2))
    De, Dp = (rng.randn(H, len(DURATIONS)).astype(np.float32) * 0.7 for _ in range(2))
    emb = rng.randn(V + 1, H).astype(np.float32)

    def fns(asarray, where, maximum):
        we, wp, de, dp, em = (asarray(a) for a in (We, Wp, De, Dp, emb))

        def joint_fn(enc_t, pred_out):
            return enc_t @ we + pred_out @ wp, enc_t @ de + pred_out @ dp

        def pred_step_fn(token, state):
            (h,) = state
            e = where((token >= 0)[:, None], em[maximum(token, 0)], 0.0)
            h = 0.6 * h + 0.4 * e
            return h, (h,)
        return joint_fn, pred_step_fn

    jax_fns = fns(jnp.asarray, jnp.where, lambda t, m: jnp.maximum(t, m))
    torch_fns = fns(torch.from_numpy, torch.where, lambda t, m: t.clamp(min=m).long())
    return jax_fns, torch_fns, V, H


@pytest.mark.parametrize("seed,blank_bias,zero_bias", [(0, 0.0, 0.0), (1, -6.0, 0.0),
                                                       (2, 0.0, 4.0)])
def test_tdt_greedy_decode_matches_jax(seed, blank_bias, zero_bias, monkeypatch):
    """`tdt_greedy_decode` driven by the same numpy-defined joint and
    prediction functions as JAX's: tokens (the -1 padding too) and counts
    equal, reading the loop's condition every loop or every CHECK_EVERY
    loops. A blank bias of -6 makes every row emit at every loop; a bias of
    4 on duration 0 keeps rows on their frames, so the loop runs to its cap
    of 2 T."""
    (jax_joint, jax_pred), (joint, pred), V, H = _numpy_tdt(seed=seed)
    rng = np.random.RandomState(seed + 10)
    B, T = 3, 12
    enc = rng.randn(B, T, H).astype(np.float32)
    enc_len = np.array([12, 7, 10], np.int32)
    bias = np.zeros(V + 1, np.float32)
    bias[V] = blank_bias
    dbias = np.zeros(len(DURATIONS), np.float32)
    dbias[0] = zero_bias

    def jax_joint_b(e, p):
        a, b = jax_joint(e, p)
        return a + bias, b + dbias

    def joint_b(e, p):
        a, b = joint(e, p)
        return a + torch.from_numpy(bias), b + torch.from_numpy(dbias)

    ref_tok, ref_n = jax.device_get(jax_tdt_greedy_decode(
        jax_joint_b, jax_pred, (jnp.zeros((B, H)),), jnp.asarray(enc), jnp.asarray(enc_len),
        blank=V, durations=DURATIONS))
    assert ref_n.max() > 0
    for check_every in (1, rnnt_module.CHECK_EVERY):
        monkeypatch.setattr(rnnt_module, "CHECK_EVERY", check_every)
        tok, n, loops = tdt_greedy_decode(joint_b, pred, (torch.zeros(B, H),),
                                          torch.from_numpy(enc), torch.from_numpy(enc_len),
                                          blank=V, durations=DURATIONS)
        assert tok.dtype == torch.int32 and tok.shape == (B, 2 * T)
        np.testing.assert_array_equal(n.numpy(), ref_n)
        np.testing.assert_array_equal(tok.numpy(), ref_tok)
        assert 0 < loops <= 2 * T
        if zero_bias > 0:
            assert loops == 2 * T


def _encode_jax(jax_model, x):
    feats, feat_len = jax_mel_spectrogram(jnp.asarray(x), jnp.asarray(LENGTHS), jax_model.mel_cfg,
                                          training=False)
    return _apply(jax_model, _RNNTNet.encode, feats, feat_len)


def test_model_matches_jax(models):
    """The whole model: the encoder output (dw_striding, the dh-128
    attention) on valid frames within 1e-4 of each frame's max; the decode
    tokens and counts of int16 PCM equal to JAX's, and the texts of
    `transcribe_staged`."""
    jax_model, port, _ = models
    x = _audio()
    enc, enc_len = _encode_jax(jax_model, x)
    with torch.no_grad():
        out, out_len = port.encode(*port.mel_features(torch.from_numpy(x),
                                                      torch.from_numpy(LENGTHS)))
    np.testing.assert_array_equal(out_len.numpy(), enc_len)
    assert out.shape[1] == 13  # 1 s of audio at x8
    for b, t in enumerate(enc_len):
        _rows_close(out[b, :t].numpy(), enc[b, :t], 1e-4, f"encoder row {b}")

    pcm = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
    ref_tok, ref_n = jax.device_get(jax_model._jit_decode(
        jax_model.variables, jnp.asarray(pcm), jnp.asarray(LENGTHS)))
    assert 0 < ref_n.min() and ref_n.max() < 2 * enc_len.max()
    tok, n = port.decode(torch.from_numpy(pcm), torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(n.numpy(), ref_n)
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    assert 0 < port.last_loop_iterations <= 2 * enc_len.max()
    texts = ["".join(port.labels[i] for i in ref_tok[b, :ref_n[b]]) for b in range(2)]
    assert port.transcribe_staged([(torch.from_numpy(pcm), torch.from_numpy(LENGTHS), 2)]) == texts


def test_model_loss_matches_jax(models):
    """`loss_fused` of the TDT model (the full joint and the TDT loss)
    against JAX's on the same batch: the value within 1e-5 relative, the
    gradient of every prediction and joint leaf (dur_proj's too) within
    1e-4 of the leaf's max."""
    jax_model, port, variables = models
    x = _audio()
    targets = np.random.RandomState(5).randint(1, 12, (2, 4)).astype(np.int32)
    t_len = np.array([4, 3], np.int32)

    def jax_loss(head):
        return jax_model.loss_fused(
            {**variables, "params": {**variables["params"], **head}}, jnp.asarray(x),
            jnp.asarray(LENGTHS), jnp.asarray(targets), jnp.asarray(t_len))

    ref, ref_grads = jax.value_and_grad(jax_loss)({k: variables["params"][k] for k in HEADS})
    ref, ref_grads = float(ref), jax.device_get(ref_grads)
    names, leaves = zip(*[(k, v) for k, v in port.named_parameters()
                          if k.split(".")[0] in HEADS])
    loss = port.loss_fused(*[torch.from_numpy(a) for a in (x, LENGTHS, targets, t_len)])
    assert float(loss.detach()) == pytest.approx(ref, rel=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    values = {k: torch.zeros_like(v) for k, v in model_variables(port).items()}
    values.update(zip(names, grads))
    tree = export_jax_variables(port, values)["params"]
    flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(flat) == len(names) and "joint.dur_proj.weight" in names
    for path, want in flat:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_tdt_variables_round_trip_and_are_strict(models):
    """The exported tree has flax's structure and shapes (of the JAX model's
    init, traced without compiling): the dw_striding subsampling's conv0,
    dw{i}, pw{i} and out, the joint's dur_proj; export(load(tree)) is the
    tree, leaf for leaf; a missing dur_proj raises."""
    jax_model, _, variables = models
    flax_tree = jax.eval_shape(lambda: jax_model.net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 40, 128)), jnp.array([128]),
        jnp.zeros((1, 4), jnp.int32), train=False))
    assert jax.tree_util.tree_structure(flax_tree) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(flax_tree), jax.tree_util.tree_leaves(variables)):
        assert a.shape == b.shape and a.dtype == b.dtype
    pre = variables["params"]["encoder"]["pre_encode"]
    assert sorted(pre) == ["conv0", "dw1", "dw2", "out", "pw1", "pw2"]
    assert pre["dw1"]["kernel"].shape == (3, 3, 1, 256)
    assert variables["params"]["joint"]["dur_proj"]["kernel"].shape == (32, 5)
    tree = export_jax_variables(_port(variables))
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len(jax.tree_util.tree_leaves(tree)) == len(flat)
    for path, want in flat:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    del bad["params"]["joint"]["dur_proj"]
    with pytest.raises(KeyError, match="dur_proj/kernel"):
        load_jax_variables(_port(), bad)


SECS, BATCH, TOKENS = 1.0, 2, 4


def test_calibration_steps_match_jax(models, monkeypatch):
    """Two framewise steps of `framewise_calibrate`'s transducer branch (the
    probe is JAX's, handed over) and the two head-only TDT steps of
    `fit_synthetic_asr` it runs after them, against JAX: every loss within
    1e-4 relative, every variable after the steps within 1e-4 of its leaf's
    max, BatchNorm stats included. linear_k's bias has an exact gradient of
    0; Adam normalises its rounding noise to steps of up to the learning
    rate in both, so it is held to the rate of the step that moves it
    (2e-4), as tests/test_torch_rnnt.py holds it."""
    jax_model, _, variables = models
    port = _port(variables)
    losses = {"jax": {}, "port": {}}

    def recording(module, key):
        fit = module.fit_synthetic_asr

        def wrapper(*args, **kw):
            losses[key]["fit"] = fit(*args, **kw)
            return losses[key]["fit"]
        monkeypatch.setattr(module, "fit_synthetic_asr", wrapper)

    recording(jax_synthetic, "jax")
    recording(synthetic, "port")
    jax_model = _jax_model(variables)
    losses["jax"]["framewise"] = jax_synthetic.framewise_calibrate(
        jax_model, steps=2, batch=BATCH, secs=SECS, utt_tokens=TOKENS, seed=0)
    w = jax.random.normal(jax.random.PRNGKey(0), (256, 29), jnp.float32) * 0.02
    losses["port"]["framewise"] = synthetic.framewise_calibrate(
        port, steps=2, batch=BATCH, secs=SECS, utt_tokens=TOKENS, seed=0,
        probe={"w": np.asarray(w), "b": np.zeros(29, np.float32)}, log=lambda msg: None)
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


def test_trim_blank_bias_leaves_the_duration_head(models):
    """The blank-bias trim on a TDT joint changes out_proj's blank bias and
    nothing else: dur_proj and every other leaf keep their values."""
    *_, variables = models
    port = _port(variables)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    delta, density = synthetic.trim_blank_bias(port, SECS, TOKENS, batch=2)
    for k, v in port.named_parameters():
        if k != "joint.out_proj.bias":
            assert torch.equal(v, before[k]), k
    bias = port.joint.out_proj.bias.detach()
    assert torch.equal(bias[:-1], before["joint.out_proj.bias"][:-1])
    assert bias[-1].item() == pytest.approx(before["joint.out_proj.bias"][-1].item() + delta)
    assert density >= 0.0
