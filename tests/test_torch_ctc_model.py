"""The whole slice: a tiny Conformer-CTC model with both kernel flags on
(`att_impl="decomposed_flash"`, `fused_subsampling=True`; 2 layers, d_model
64, 4 heads, 40 mels), built in JAX and in the PyTorch port from one set of
carried weights.

JAX runs its Pallas subsampling kernel in interpret mode. That kernel rounds
conv2's operands to bf16, so against it the log-probs agree to 1e-2 while
greedy ids and text must be identical; against the same JAX model with the
XLA conv pair (same parameters) the fp32 log-probs agree to 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from nemo_tpu.data.audio_io import write_wav  # noqa: E402
from nemo_tpu.models.asr.configs import conformer_ctc as jax_conformer_ctc  # noqa: E402
from nemo_tpu.models.asr.ctc_models import EncDecCTCModel as JaxEncDecCTCModel  # noqa: E402
from nemo_tpu_torch.interop.jax_params import load_jax_variables  # noqa: E402
from nemo_tpu_torch.models.asr.configs import conformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel  # noqa: E402
from test_torch_conformer import perturb  # noqa: E402

LENGTHS = np.array([16000, 11000], np.int32)


def _tiny(cfg, fused=True):
    cfg.encoder.update(n_layers=2, d_model=64, n_heads=4, feat_in=40,
                       att_impl="decomposed_flash", fused_subsampling=fused)
    cfg.preprocessor.features = 40
    cfg.decoder.feat_in = 64
    return cfg


def _audio():
    x = 0.1 * np.random.RandomState(0).randn(2, 16000).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0
    return x


@pytest.fixture(scope="module")
def models():
    """(JAX model with both flags, JAX model with the XLA conv pair, port model)."""
    # both JAX models hold the same parameter tree; initialising the one
    # with the XLA conv pair keeps the Pallas kernel out of `init`
    jax_pair = JaxEncDecCTCModel(_tiny(jax_conformer_ctc("large"), fused=False))
    variables = perturb(jax.device_get(jax_pair.variables), np.random.RandomState(1))
    jax_pair.variables = variables
    jax_fused = JaxEncDecCTCModel(_tiny(jax_conformer_ctc("large")), init_params=False)
    jax_fused.variables = variables
    port = EncDecCTCModel(_tiny(conformer_ctc("large", att_impl="decomposed_flash",
                                              fused_subsampling=True)), device="cpu")
    load_jax_variables(port, variables)
    return jax_fused, jax_pair, port, variables


def _jax_forward(model, x):
    with pltpu.force_tpu_interpret_mode():
        lp, n = model.forward(jnp.asarray(x), jnp.asarray(LENGTHS))
    return np.asarray(lp), np.asarray(n)


def test_log_probs_and_ids_match_jax(models):
    jax_fused, jax_pair, port, _ = models
    x = _audio()
    lp, n = port(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    lp, n = lp.numpy(), n.numpy()
    assert lp.dtype == np.float32 and lp.shape[-1] == 29
    for ref_model, tol in ((jax_pair, 1e-4), (jax_fused, 1e-2)):
        ref, ref_n = _jax_forward(ref_model, x)
        np.testing.assert_array_equal(n, ref_n)
        assert lp.shape == ref.shape
        for b, t in enumerate(n):
            np.testing.assert_allclose(lp[b, :t], ref[b, :t], atol=tol, rtol=tol)
            np.testing.assert_array_equal(lp[b, :t].argmax(-1), ref[b, :t].argmax(-1))


def test_transcribe_text_matches_jax(models, tmp_path):
    jax_fused, _, port, _ = models
    x = _audio()
    paths = []
    for i, n in enumerate(LENGTHS):
        paths.append(str(tmp_path / f"a{i}.wav"))
        write_wav(paths[-1], x[i, :n], 16000)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused.transcribe(paths, batch_size=2)
    assert port.transcribe(paths, batch_size=2) == ref
    assert any(ref)  # the comparison is not between empty strings
    # float input and a partial last batch take the same path
    floats = [x[0], x[1, :LENGTHS[1]], x[0, :9000]]
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused.transcribe(floats, batch_size=2)
    assert port.transcribe(floats, batch_size=2) == ref


def test_transcribe_staged_matches_transcribe(models):
    _, _, port, _ = models
    x = _audio()
    padded = np.pad(x, ((0, 0), (0, 16384 - 16000)))  # transcribe's power-of-two bucket
    staged = [(torch.from_numpy(padded), torch.from_numpy(LENGTHS), 2)] * 2
    out = port.transcribe_staged(staged)
    assert out == port.transcribe([x[0], x[1, :LENGTHS[1]]] * 2, batch_size=2)


def test_load_jax_variables_is_strict(models):
    *_, variables = models
    port = EncDecCTCModel(_tiny(conformer_ctc("large")), device="cpu")
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["params"]["encoder"]["layer1"]["attn"]["pos_bias_u"]
    with pytest.raises(KeyError, match="layer1/attn/pos_bias_u"):
        load_jax_variables(port, missing)
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["batch_stats"]["encoder"]["layer0"]["conv"]["norm"]["extra"] = np.zeros(3)
    with pytest.raises(ValueError, match="norm/extra"):
        load_jax_variables(port, extra)
    wrong = jax.tree_util.tree_map(lambda a: a, variables)
    wrong["params"]["decoder"]["proj"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="decoder/proj/bias"):
        load_jax_variables(port, wrong)
