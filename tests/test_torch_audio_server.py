"""The port's audio serving and voice agent (nemo_tpu_torch/serve/audio_server.py,
agents/voice_agent.py, data/audio_io.py:write_wav) against the JAX
package's, on the CPU.

The WAV helpers must give JAX's bytes. Over HTTP on an ephemeral port the
port's AudioServer runs a tiny Conformer-CTC (both kernel flags, so the
plain versions of K1 and K2) and the tiny FastPitch + HiFi-GAN pair of
test_torch_tts.py, with weights carried from the JAX models: its text must
equal JAX's `AudioServer.transcribe_bytes` (raw, multipart and resampled
bodies) and its speech JAX's `synthesize` within one 16-bit step. The
voice agent's turn detection is held against JAX's with stub services, and
one `converse` with the tiny models.
"""

import http.client
import io
import json
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nemo_tpu.agents as jax_agents  # noqa: E402
import nemo_tpu.serve.audio_server as jax_audio  # noqa: E402
from nemo_tpu.data.audio_io import write_wav as jax_write_wav  # noqa: E402
from nemo_tpu.models.asr.configs import conformer_ctc as jax_conformer_ctc  # noqa: E402
from nemo_tpu.models.asr.ctc_models import EncDecCTCModel as JaxEncDecCTCModel  # noqa: E402
import nemo_tpu_torch.agents as agents  # noqa: E402
import nemo_tpu_torch.serve.audio_server as audio  # noqa: E402
from nemo_tpu_torch.data.audio_io import resample_linear, write_wav  # noqa: E402
from nemo_tpu_torch.interop.jax_params import load_jax_variables  # noqa: E402
from nemo_tpu_torch.models.asr.configs import conformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel  # noqa: E402
from test_torch_ctc_model import _tiny  # noqa: E402
from test_torch_tts import carried_fastpitch, carried_vocoder, random_tree  # noqa: E402

TEXT = "Hello world, this is speech."


def _noise(n, seed, scale=0.1):
    return (scale * np.random.RandomState(seed).randn(n)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """JAX and port models with one set of weights: ((asr, fastpitch, hifigan)
    of JAX, the same of the port). The JAX Conformer takes the XLA attention
    and conv pair, the port's both kernel flags (their plain versions here)."""
    cfg = _tiny(jax_conformer_ctc("large"), fused=False)
    cfg.encoder.att_impl = "decomposed"
    jax_asr = JaxEncDecCTCModel(cfg, init_params=False)
    abstract = jax.eval_shape(lambda r, f, n: jax_asr.net.init(r, f, n, train=False),
                              jax.random.PRNGKey(0), jnp.zeros((1, 40, 128)),
                              jnp.array([128], jnp.int32))
    jax_asr.variables = random_tree(abstract, np.random.RandomState(3))
    asr = EncDecCTCModel(_tiny(conformer_ctc("large", att_impl="decomposed_flash",
                                             fused_subsampling=True)), device="cpu")
    load_jax_variables(asr, jax_asr.variables)
    (jax_fp, fp), (jax_voc, voc) = carried_fastpitch(), carried_vocoder()
    return (jax_asr, jax_fp, jax_voc), (asr, fp, voc)


@pytest.fixture(scope="module")
def server(models):
    _, (asr, fp, voc) = models
    srv = audio.AudioServer(asr=asr, tts=(fp, voc))
    srv.serve(port=0, blocking=False)
    yield srv
    srv.shutdown()
    assert not srv._thread.is_alive()


def _request(srv, method, path, body=None, ctype="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    conn.request(method, path, body=body, headers={"Content-Type": ctype} if body else {})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _multipart(wav, boundary="XBOUNDARYX"):
    return (f"--{boundary}\r\nContent-Disposition: form-data; name=\"model\"\r\n\r\nwhisper-1"
            f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() + wav + \
        f"\r\n--{boundary}--\r\n".encode()


@pytest.mark.parametrize("channels,width", [(1, 2), (2, 2), (1, 4), (1, 1)])
def test_wav_helpers_match_jax(tmp_path, channels, width):
    x = np.concatenate([_noise(1000, 0, 0.5), [1.5, -1.5, 0.99999, -0.99999, 0.5]]).astype(
        np.float32)
    assert audio._wav_bytes(x, 22050) == jax_audio._wav_bytes(x, 22050)
    write_wav(str(tmp_path / "a.wav"), x, 16000)
    jax_write_wav(str(tmp_path / "b.wav"), x, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    stereo = np.stack([x, -x], 1)
    write_wav(str(tmp_path / "s.wav"), stereo, 8000)
    jax_write_wav(str(tmp_path / "t.wav"), stereo, 8000)
    assert (tmp_path / "s.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(11025)
        w.writeframes(np.random.RandomState(1).bytes(400 * channels * width))
    for data in (buf.getvalue(), audio._wav_bytes(x, 16000)):
        (got, sr), (ref, ref_sr) = audio._parse_wav(data), jax_audio._parse_wav(data)
        assert sr == ref_sr and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("body,ctype", [
    (_multipart(b"RIFFdata"), "multipart/form-data; boundary=XBOUNDARYX"),
    (_multipart(b"RIFF\r\n\r\ndata", "q9"), 'multipart/form-data; boundary="q9"'),
    (b"--XB\r\nContent-Disposition: form-data; name=\"model\"\r\n\r\nx\r\n--XB--",
     "multipart/form-data; boundary=XB"),
    (_multipart(b"RIFF"), "multipart/form-data")])
def test_multipart_file_matches_jax(body, ctype):
    assert audio._multipart_file(body, ctype) == jax_audio._multipart_file(body, ctype)


def test_transcriptions_equal_jax(models, server):
    """Raw, multipart and 22,050 Hz (resampled) bodies, and /v1/models."""
    (jax_asr, _, _), _ = models
    ref_srv = jax_audio.AudioServer(asr=jax_asr)
    x = _noise(16000, 0)
    wavs = {"raw": audio._wav_bytes(x, 16000),
            "resampled": audio._wav_bytes(resample_linear(x, 16000, 22050), 22050)}
    texts = {}
    for name, wav in wavs.items():
        status, body = _request(server, "POST", "/v1/audio/transcriptions", wav, "audio/wav")
        assert status == 200
        texts[name] = json.loads(body)["text"]
        assert texts[name] == ref_srv.transcribe_bytes(wav)
    status, body = _request(server, "POST", "/v1/audio/transcriptions", _multipart(wavs["raw"]),
                            "multipart/form-data; boundary=XBOUNDARYX")
    assert status == 200 and json.loads(body)["text"] == texts["raw"]
    assert texts["raw"]  # the comparison is not between empty strings
    status, body = _request(server, "GET", "/v1/models")
    assert status == 200 and json.loads(body)["data"][0]["id"] == "nemo-tpu-audio"


def test_speech_equals_jax(models, server):
    (_, jax_fp, jax_voc), (_, fp, _) = models
    status, data = _request(server, "POST", "/v1/audio/speech", json.dumps({"input": TEXT}))
    assert status == 200
    ref = jax_audio.AudioServer(tts=(jax_fp, jax_voc)).synthesize(TEXT)
    with wave.open(io.BytesIO(data)) as w, wave.open(io.BytesIO(ref)) as r:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        assert w.getparams() == r.getparams()
        got = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)
        want = np.frombuffer(r.readframes(r.getnframes()), "<i2").astype(np.int32)
    frames = fp.generate_spectrogram(fp.parse(TEXT)).shape[2]
    assert len(got) == 16 * frames > 0
    assert np.abs(got - want).max() <= 1


def test_errors(server):
    """404 for unknown routes, 400 for a multipart body without a file part,
    500 (and the server keeps serving) for a body that is not a WAV."""
    assert _request(server, "GET", "/v1/nothing")[0] == 404
    assert _request(server, "POST", "/v1/nothing", b"{}")[0] == 404
    body = b"--XB\r\nContent-Disposition: form-data; name=\"model\"\r\n\r\nx\r\n--XB--"
    status, data = _request(server, "POST", "/v1/audio/transcriptions", body,
                            "multipart/form-data; boundary=XB")
    assert status == 400 and json.loads(data)["error"] == "no file part"
    assert _request(server, "POST", "/v1/audio/transcriptions", b"not a wav", "audio/wav")[0] == 500
    assert _request(server, "GET", "/v1/models")[0] == 200
    with pytest.raises(NotImplementedError, match="VITS"):
        audio.AudioServer(tts=object()).synthesize("hi")


class _StubASR:
    def transcribe(self, a, sr):
        return f"heard {len(a)} at {sr} ({float(np.abs(a).max()):.3f})"


def _stub_agent(mod):
    llm = mod.CallableLLMService(lambda prompt: f"{len(prompt)}: " + prompt.splitlines()[-2])

    class TTS:
        def synthesize(self, text):
            return np.full(len(text), 0.5, np.float32), 22050

    return mod.VoiceAgent(_StubASR(), llm, TTS(), mod.TurnConfig(end_silence_secs=0.3))


def test_turn_detection_equals_jax():
    """The same chunks give the same turns, replies and history."""
    sr = 16000
    rng = np.random.RandomState(1)
    loud, quiet = (0.3 * rng.randn(sr // 2)).astype(np.float32), np.zeros(sr // 4, np.float32)
    chunks = [quiet, loud, quiet, quiet, quiet, loud[:700], quiet, 1e-3 * loud, loud, quiet,
              quiet, np.zeros(0, np.float32), loud[:4000], quiet, quiet]
    port, ref = _stub_agent(agents), _stub_agent(jax_agents)
    turns = 0
    for chunk in chunks:
        got, want = port.push_audio(chunk), ref.push_audio(chunk)
        assert (got is None) == (want is None)
        if got is not None:
            turns += 1
            assert got[:2] == want[:2]
            np.testing.assert_array_equal(got[2], want[2])
    assert turns >= 2 and port.history == ref.history
    assert port.converse(loud)[:2] == ref.converse(loud)[:2]
    assert port.history == ref.history and len(port.history) == 2 * turns + 2


def test_converse_equals_jax(models):
    """One whole turn with the tiny models: the ASR through a WAV file, a
    stub LLM, FastPitch and HiFi-GAN."""
    jax_models, port_models = models

    def agent(mod, asr, fp, voc):
        return mod.VoiceAgent(mod.ModelASRService(asr),
                              mod.CallableLLMService(lambda p: "ok, " + p.splitlines()[-2][:20]),
                              mod.NativeTTSService(fp, voc))

    x = _noise(16000, 2)
    user, reply, wav = agent(agents, *port_models).converse(x)
    ref_user, ref_reply, ref_wav = agent(jax_agents, *jax_models).converse(x)
    assert (user, reply) == (ref_user, ref_reply) and user
    assert wav.shape == np.asarray(ref_wav).shape
    np.testing.assert_allclose(wav, np.asarray(ref_wav), rtol=0, atol=1e-5)
