"""The port's TTS slice (nemo_tpu_torch/models/tts, data/text_tokenizers.py,
core/optim.py:adam, the TTS layouts of interop/jax_params.py) against the
JAX package, on the CPU.

One tiny JAX FastPitch per norm style (d_model 64, 2 heads, 1 + 1 layers,
max_mel_len 256, 16 mels; "post" also with the reference's concatenated
positions and a d_head of its own) and one tiny HiFi-GAN generator (rates
(4, 4), kernels (8, 8), 32 channels), their weights perturbed from a numpy
seed and carried into the port. Outputs agree within 1e-5 of each tensor's
max, durations and mel lengths exactly; the loss within 1e-5 relative and
every gradient within 1e-4 of its leaf's max.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nemo_tpu.data.text_tokenizers import CharTokenizer as JaxCharTokenizer  # noqa: E402
from nemo_tpu.data.text_tokenizers import EnglishCharsTTSTokenizer as JaxTTSTokenizer  # noqa: E402
from nemo_tpu.models.tts.fastpitch_model import FastPitchModel as JaxFastPitch  # noqa: E402
from nemo_tpu.models.tts.hifigan_model import HifiGanModel as JaxHifiGan  # noqa: E402
from nemo_tpu.models.tts.modules.fastpitch import regulate_length as jax_regulate  # noqa: E402
from nemo_tpu_torch.core.optim import adam  # noqa: E402
from nemo_tpu_torch.data.text_tokenizers import (CharTokenizer,  # noqa: E402
                                                 EnglishCharsTTSTokenizer)
from nemo_tpu_torch.interop.jax_params import (export_jax_variables,  # noqa: E402
                                               load_jax_variables, model_variables)
from nemo_tpu_torch.models.tts import FastPitchModel, HifiGanModel  # noqa: E402
from nemo_tpu_torch.models.tts.modules.fastpitch import regulate_length  # noqa: E402

TINY = {"d_model": 64, "n_heads": 2, "d_ff": 128, "enc_layers": 1, "dec_layers": 1,
        "max_mel_len": 256, "n_mels": 16}
STYLES = {"pre": {}, "post": {"norm_style": "post", "pos_concat": True, "d_head": 24}}
VOCODER = {"n_mels": 16, "generator": {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
                                       "upsample_initial_channel": 32}}
TEXTS = ["Hello, world! (A test.)", "ok"]


def _tokens(texts):
    """[B, U] int32 ids of `texts`, right-padded with 0, and their lengths."""
    ids = [EnglishCharsTTSTokenizer().text_to_ids(t) for t in texts]
    out = np.zeros((len(ids), max(map(len, ids))), np.int32)
    for i, x in enumerate(ids):
        out[i, : len(x)] = x
    return out, np.array([len(x) for x in ids], np.int32)


def _close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


def random_tree(abstract, rng):
    """Values from numpy for a JAX variable tree's shapes (no JAX init,
    which compiles): kernels normal over sqrt(fan-in), embeddings normal,
    norm scales 1 + 0.2 · normal, running variances in [0.5, 1.5), any
    other leaf (biases, running means) 0.2 · normal."""
    def leaf(path, spec):
        name, shape = path[-1].key, spec.shape
        if name == "kernel":
            return rng.randn(*shape) / math.sqrt(math.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.2 * rng.randn(*shape)
        if name == "var":  # BatchNorm's running variance
            return 0.5 + rng.rand(*shape)
        return (1.0 if name == "embedding" else 0.2) * rng.randn(*shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), abstract)


def _jax_apply(jm, tokens, lens, static=(), **arrays):
    """jm.net.apply under jit (static: the stage and mel_max_len)."""
    fn = jax.jit(lambda v, t, n, a: jm.net.apply(v, t, n, **a, **dict(static)))
    return fn(jm.variables, jnp.asarray(tokens), jnp.asarray(lens),
              {k: jnp.asarray(a) for k, a in arrays.items()})


def carried_fastpitch(style="pre"):
    """(JAX model, port model) of one norm style, with carried weights. The
    duration predictor's output sits near log(4), so a symbol lasts ~3 frames."""
    cfg = dict(TINY, **STYLES[style])
    jm = JaxFastPitch(cfg, init_params=False)
    abstract = jax.eval_shape(jm.net.init, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32),
                              jnp.array([16], jnp.int32))
    variables = random_tree(abstract, np.random.RandomState(1))
    fc = variables["params"]["duration_predictor"]["fc"]
    fc["kernel"] *= 0.1
    fc["bias"] = np.array([math.log(4.0)], np.float32)
    jm.variables = variables
    return jm, load_jax_variables(FastPitchModel(cfg, device="cpu"), variables)


def carried_vocoder():
    """(JAX model, port model) of the tiny generator, with carried weights."""
    jm = JaxHifiGan(VOCODER, init_params=False)
    abstract = jax.eval_shape(jm.generator.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16)))
    variables = {"params": {"generator": random_tree(abstract["params"],
                                                     np.random.RandomState(2))}}
    jm.variables = variables
    return jm, load_jax_variables(HifiGanModel(VOCODER, device="cpu"), variables)


@pytest.fixture(scope="module", params=list(STYLES))
def fastpitch(request):
    return carried_fastpitch(request.param)


@pytest.fixture(scope="module")
def vocoder():
    return carried_vocoder()


@pytest.mark.parametrize("text", ["Hello, World!", "MiXeD cAsE: 'quotes' \"too\"; ok?",
                                  "naïve café — 42 ünïcode", ""])
def test_tokenizers_match_jax(text):
    port, ref = EnglishCharsTTSTokenizer(), JaxTTSTokenizer()
    assert port.vocab == ref.vocab and port.vocab_size == 40
    assert (port.pad_id, port.blank_id) == (ref.pad_id, ref.blank_id) == (0, 39)
    ids = port.text_to_ids(text)
    assert ids == ref.text_to_ids(text)
    assert port.ids_to_text(ids) == ref.ids_to_text(ids)
    for unk in (None, "?"):
        vocab = list("abc?")
        assert CharTokenizer(vocab, unk).text_to_ids(text) == \
            JaxCharTokenizer(vocab, unk).text_to_ids(text)


@pytest.mark.parametrize("case", range(4))
def test_regulate_length_matches_jax(case):
    if case == 0:  # tests/test_tts.py:15's case
        dur = np.array([[2, 1, 3], [1, 0, 1]], np.int32)
        enc = np.arange(6, dtype=np.float32).reshape(2, 3, 1) + 1
        T = 8
    else:  # ragged random ones, the last cut by a small max_mel_len
        rng = np.random.RandomState(case)
        dur = rng.randint(0, 6, (3, 7)).astype(np.int32)
        dur[1, 4:] = 0
        enc = rng.randn(3, 7, 5).astype(np.float32)
        T = 40 if case < 3 else 9
    out, n = regulate_length(torch.from_numpy(dur), torch.from_numpy(enc), T)
    ref, ref_n = jax_regulate(jnp.asarray(dur), jnp.asarray(enc), T)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if case == 0:
        np.testing.assert_array_equal(out.numpy()[0, :, 0], [1, 1, 2, 3, 3, 3, 0, 0])


def test_fastpitch_stages_match_jax(fastpitch):
    """The three stages on ragged token lengths at pace 1.2: encoder
    output, predictions and durations, then the decoder from JAX's
    durations at a static length that cuts the longer row."""
    jm, pm = fastpitch
    tokens, lens = _tokens(TEXTS)
    t, n = torch.from_numpy(tokens).long(), torch.from_numpy(lens).long()
    with torch.no_grad():
        enc = pm(t, n, pace=1.2, stage="encode")
        full = pm(t, n, pace=1.2)
    pace = np.float32(1.2)
    ref_enc = _jax_apply(jm, tokens, lens, {"stage": "encode"}.items(), pace=pace)
    ref_full = _jax_apply(jm, tokens, lens, pace=pace)
    for key in ("enc", "log_dur_pred", "pitch_pred"):
        _close(enc[key].numpy(), ref_enc[key])
    np.testing.assert_array_equal(enc["durations"].numpy(), np.asarray(ref_enc["durations"]))
    np.testing.assert_array_equal(enc["mel_len"].numpy(), np.asarray(ref_enc["mel_len"]))
    assert enc["mel_len"].min() > 0
    for key in ("mel", "log_dur_pred", "pitch_pred"):
        _close(full[key].numpy(), ref_full[key])
    np.testing.assert_array_equal(full["mel_len"].numpy(), np.asarray(ref_full["mel_len"]))
    cut = int(np.asarray(ref_enc["mel_len"]).max()) - 5
    ref_dec = _jax_apply(jm, tokens, lens, {"stage": "decode", "mel_max_len": cut}.items(),
                         enc=ref_enc["enc"], dur=ref_enc["durations"])
    with torch.no_grad():
        dec = pm(t, n, stage="decode", enc=torch.tensor(np.asarray(ref_enc["enc"])),
                 dur=torch.tensor(np.asarray(ref_enc["durations"])), mel_max_len=cut)
    assert dec["mel"].shape[2] == cut
    _close(dec["mel"].numpy(), ref_dec["mel"])


@pytest.mark.parametrize("pace", [1.0, 1.3])
def test_generate_spectrogram_matches_jax(fastpitch, pace):
    """Two rows, the long one past max_mel_len at pace 1.0 (cut there),
    and one row alone (the frames after JAX's 128-frame bucket)."""
    jm, pm = fastpitch
    long = "the quick brown fox jumps over the lazy dog " * 3
    for text in ([long, "hi there"], ["hello world"]):
        tokens, _ = _tokens(text)
        ref = np.asarray(jm.generate_spectrogram(jnp.asarray(tokens), pace=pace))
        mel = pm.generate_spectrogram(torch.from_numpy(tokens), pace=pace).numpy()
        _close(mel, ref)
        if len(text) == 2 and pace == 1.0:  # the long row was cut
            assert mel.shape[2] == ref.shape[2] == pm.max_mel_len
    assert 0 < ref.shape[2] < pm.max_mel_len


def _batch(rng, B=2, U=12, T=256, n_mels=16, V=40):
    tokens = rng.randint(1, V, (B, U)).astype(np.int32)
    dur = rng.randint(3, 10, (B, U)).astype(np.int32)
    return (tokens, dur, rng.randn(B, n_mels, T).astype(np.float32),
            rng.randn(B, U).astype(np.float32))


def test_loss_and_gradients_match_jax(fastpitch):
    """The training loss (train=False, ground-truth durations and pitch)
    and the gradient of every parameter."""
    jm, pm = fastpitch
    tokens, dur, mel, pitch = _batch(np.random.RandomState(3))
    B, U = tokens.shape
    mask = np.ones((B, U), np.float32)

    def jax_loss(v):
        out = jm.net.apply(v, jnp.asarray(tokens), jnp.full((B,), U, jnp.int32),
                           durations=jnp.asarray(dur), pitch=jnp.asarray(pitch))
        return jm.loss(out, jnp.asarray(mel), jnp.asarray(dur.sum(1)), jnp.asarray(dur),
                       jnp.asarray(pitch), jnp.asarray(mask))

    ref, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(jm.variables)
    leaves = model_variables(pm)
    out = pm(torch.from_numpy(tokens).long(), torch.full((B,), U), pitch=torch.from_numpy(pitch),
             durations=torch.from_numpy(dur).long())
    loss = pm.loss(out, torch.from_numpy(mel), torch.from_numpy(dur.sum(1)),
                   torch.from_numpy(dur), torch.from_numpy(pitch), torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    got = export_jax_variables(pm, dict(zip(leaves, grads)))
    flat_ref = jax.tree_util.tree_flatten_with_path(jax.device_get(ref_grads))[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_ref)
    top = max(np.abs(g).max() for _, g in flat_ref)
    for path, g in flat_ref:
        if path[-2].key == "k" and path[-1].key == "bias":
            # 0 in exact arithmetic (a row's softmax ignores the common
            # shift q · b_k): both sides hold rounding noise only
            assert max(np.abs(g).max(), np.abs(flat_got[path]).max()) < 1e-6 * top
        else:
            _close(flat_got[path], g, tol=1e-4)


def test_adam_step_matches_optax():
    rng = np.random.RandomState(4)
    params = [rng.randn(3, 5).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params] for _ in range(3)]
    opt = optax.adam(2e-3)
    ref, state = [jnp.asarray(p) for p in params], None
    state = opt.init(ref)
    leaves = [torch.from_numpy(p.copy()) for p in params]
    port = adam(leaves, 2e-3)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, ref)
        ref = optax.apply_updates(ref, updates)
        port.step([torch.from_numpy(x) for x in g])
        for a, b in zip(leaves, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_fit_synthetic_gives_positive_durations():
    """A short fit moves the duration predictor to positive durations;
    with min_token_duration=1 no text gives a 0-frame mel."""
    pm = FastPitchModel(dict(TINY, min_token_duration=1, max_mel_len=128), device="cpu")
    before = {k: v.clone() for k, v in model_variables(pm).items()}
    loss = pm.fit_synthetic(steps=6, batch=2, seq=12, seed=0, lr=2e-2)
    assert math.isfinite(loss)
    assert all(not torch.equal(before[k], v) for k, v in model_variables(pm).items())
    with torch.no_grad():
        tokens = pm.parse("hello world")
        e = pm(tokens, torch.tensor([tokens.shape[1]]), stage="encode")
    assert int(e["durations"].min()) >= 1
    for text in ("a", "hi", "hello world, again"):
        assert pm.generate_spectrogram(pm.parse(text)).shape[2] > 0


def test_generator_matches_jax(vocoder):
    jm, pm = vocoder
    assert pm.hop_length == jm.hop_length == 16
    mel = np.random.RandomState(5).randn(2, 16, 21).astype(np.float32)
    audio = pm.convert_spectrogram_to_audio(torch.from_numpy(mel)).numpy()
    ref = np.asarray(jm.convert_spectrogram_to_audio(jnp.asarray(mel)))
    assert audio.shape == (2, 21 * 16)
    _close(audio, ref)


def test_generator_refuses_a_0_frame_mel(vocoder):
    """JAX makes samples of nothing here (its VALID transposed convolutions,
    ROADMAP C); the port raises."""
    jm, pm = vocoder
    assert np.asarray(jm.convert_spectrogram_to_audio(jnp.zeros((1, 16, 0)))).shape[1] > 0
    with pytest.raises(ValueError, match="0 frames"):
        pm.convert_spectrogram_to_audio(torch.zeros(1, 16, 0))
    with pytest.raises(NotImplementedError, match="A3"):
        pm.init_train()


def test_weights_round_trip_and_strictness(fastpitch, vocoder):
    for jm, pm in (fastpitch, vocoder):
        tree = jax.device_get(jm.variables)
        back = export_jax_variables(pm)
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert len(jax.tree_util.tree_leaves(back)) == len(flat)
        got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        for path, leaf in flat:
            np.testing.assert_array_equal(got[path], leaf)
        params = tree["params"]
        key = "symbol_emb" if "symbol_emb" in params else "generator"
        extra = {"params": dict(params, extra={"kernel": np.zeros(1, np.float32)})}
        with pytest.raises(ValueError, match="does not take"):
            load_jax_variables(type(pm)(pm.cfg, device="cpu"), extra)
        missing = {"params": {k: v for k, v in params.items() if k != key}}
        with pytest.raises(KeyError, match="missing"):
            load_jax_variables(type(pm)(pm.cfg, device="cpu"), missing)
