"""Host and frontend pieces of the PyTorch port against the JAX package: the
mel frontend (fp32, 1e-4 relative), its constants, the int16 scaling,
`read_wav`, the CTC collapse and the char decoding."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nemo_tpu.data.audio_io import read_wav as jax_read_wav, write_wav  # noqa: E402
from nemo_tpu.models.asr.configs import EN_CHAR_LABELS as JAX_LABELS  # noqa: E402
from nemo_tpu.models.asr.parts.ctc_decoding import CTCDecoding as JaxCTCDecoding  # noqa: E402
from nemo_tpu.ops import audio as jax_audio  # noqa: E402
from nemo_tpu.ops.ctc import ctc_collapse as jax_ctc_collapse  # noqa: E402
from nemo_tpu_torch.data.audio_io import read_wav  # noqa: E402
from nemo_tpu_torch.models.asr.configs import EN_CHAR_LABELS, conformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.ctc_models import _mel_cfg_from  # noqa: E402
from nemo_tpu_torch.models.asr.parts.ctc_decoding import CTCDecoding  # noqa: E402
from nemo_tpu_torch.ops import audio  # noqa: E402
from nemo_tpu_torch.ops.ctc import ctc_collapse  # noqa: E402


def _jax_cfg(cfg):
    return jax_audio.MelSpectrogramConfig(**{
        f: getattr(cfg, f) for f in jax_audio.MelSpectrogramConfig.__dataclass_fields__})


@pytest.mark.parametrize("pre", [
    dict(conformer_ctc("large").preprocessor),  # the slice's own frontend
    dict(features=64, window_size=0.02, normalize="all_features", pad_to=16),
])
def test_mel_spectrogram_matches_jax(pre):
    cfg = _mel_cfg_from(pre)
    rng = np.random.RandomState(0)
    x = (0.3 * rng.randn(2, 8000)).astype(np.float32)
    lens = np.array([8000, 5123], np.int32)
    mel, n = audio.mel_spectrogram(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    ref, ref_n = jax_audio.mel_spectrogram(jnp.asarray(x), jnp.asarray(lens), _jax_cfg(cfg))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert mel.shape == ref.shape and mel.dtype == torch.float32
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_mel_constants_and_seq_len_match_jax():
    cfg = _mel_cfg_from(conformer_ctc("large").preprocessor)
    for ours, ref in zip(audio.build_mel_constants(cfg), jax_audio.build_mel_constants(_jax_cfg(cfg))):
        np.testing.assert_array_equal(ours, np.asarray(ref))
    lens = np.array([1, 159, 160, 480000], np.int32)
    np.testing.assert_array_equal(audio.mel_seq_len(cfg, torch.from_numpy(lens)).numpy(),
                                  np.asarray(jax_audio.mel_seq_len(_jax_cfg(cfg), jnp.asarray(lens))))


def test_int16_scaling_is_exact():
    pcm = np.array([-32768, -1, 0, 1, 32767], np.int16)
    out = audio.pcm_to_float(torch.from_numpy(pcm))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), pcm.astype(np.float32) / 32768.0)


def test_read_wav_matches_jax(tmp_path):
    x = np.sin(np.arange(4000) / 7.0).astype(np.float32) * 0.5
    path = str(tmp_path / "a.wav")
    write_wav(path, x, 8000)
    for target in (None, 16000):
        ours, sr = read_wav(path, target_sr=target)
        ref, ref_sr = jax_read_wav(path, target_sr=target)
        assert sr == ref_sr
        np.testing.assert_array_equal(ours, ref)


def test_ctc_collapse_and_decoding_match_jax():
    assert EN_CHAR_LABELS == JAX_LABELS
    rng = np.random.RandomState(0)
    preds = rng.randint(0, 29, size=(3, 40)).astype(np.int32)
    preds[0, :10] = 28  # a run of blanks
    lens = np.array([40, 17, 0], np.int32)
    ours = ctc_collapse(preds, lens, blank=28)
    assert ours == jax_ctc_collapse(preds, lens, blank=28)
    dec, ref_dec = CTCDecoding(EN_CHAR_LABELS), JaxCTCDecoding(JAX_LABELS)
    assert dec.blank_id == ref_dec.blank_id == 28
    assert [dec.ids_to_text(i) for i in ours] == [ref_dec.ids_to_text(i) for i in ours]
