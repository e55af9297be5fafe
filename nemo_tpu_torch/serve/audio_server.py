"""OpenAI-compatible audio serving (counterpart of
nemo_tpu/serve/audio_server.py): transcription (ASR) and speech (TTS).

    srv = AudioServer(asr=EncDecCTCModel(cfg), tts=(FastPitchModel(), HifiGanModel()))
    srv.serve(port=0, blocking=False)      # srv.port is the bound port
    ...
    srv.shutdown()

- POST /v1/audio/transcriptions: a multipart `file=` WAV or a raw WAV body
  → {"text": ...}; the audio is resampled (linearly) to the ASR model's rate.
- POST /v1/audio/speech: JSON {"input": text} → a mono 16-bit WAV at the
  spectrogram model's rate.
- GET /v1/models.

A stdlib ThreadingHTTPServer; one model call runs at a time, under a lock.
The models run where they were built (the card, or the CPU with
`device="cpu"`). `tts` is a (spectrogram model, vocoder) pair; a
single-model TTS (VITS) raises NotImplementedError until VITS is ported.
"""

from __future__ import annotations

import io
import json
import logging
import re
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from nemo_tpu_torch.data.audio_io import resample_linear

log = logging.getLogger(__name__)


def _wav_bytes(samples: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        pcm = np.clip(samples, -1.0, 1.0)
        w.writeframes((pcm * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _parse_wav(data: bytes) -> Tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def _multipart_file(body: bytes, content_type: str) -> Optional[bytes]:
    """The payload of the first file part of a multipart/form-data body."""
    m = re.search(r'boundary="?([^";,]+)"?', content_type)
    if not m:
        return None
    boundary = ("--" + m.group(1)).encode()
    for part in body.split(boundary):
        if b"filename=" not in part:
            continue
        idx = part.find(b"\r\n\r\n")
        if idx < 0:
            continue
        payload = part[idx + 4:]
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        return payload
    return None


class AudioServer:
    """ASR and TTS behind the OpenAI audio API. asr: a model with
    `transcribe([np.ndarray]) -> [str]` and `sample_rate`; tts: a
    (spectrogram model, vocoder) pair (FastPitch, HiFi-GAN)."""

    def __init__(self, asr=None, tts=None, *, model_name: str = "nemo-tpu-audio"):
        self.asr = asr
        self.tts = tts
        self.model_name = model_name
        self._lock = threading.Lock()  # one model call at a time
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # -- model calls ---------------------------------------------------------
    def transcribe_bytes(self, wav_data: bytes) -> str:
        if self.asr is None:
            raise ValueError("no ASR model loaded")
        x, sr = _parse_wav(wav_data)
        target = getattr(self.asr, "sample_rate", 16000)
        if sr != target:
            x = resample_linear(x, sr, target)
        with self._lock:
            return self.asr.transcribe([x.astype(np.float32)])[0]

    def synthesize(self, text: str) -> bytes:
        if self.tts is None:
            raise ValueError("no TTS model loaded")
        if not isinstance(self.tts, tuple):
            raise NotImplementedError("single-model TTS (VITS) is not ported; pass a "
                                      "(spectrogram model, vocoder) pair")
        spec, voc = self.tts
        with self._lock:
            mel = spec.generate_spectrogram(spec.parse(text))
            wav = voc.convert_spectrogram_to_audio(mel)[0].float().cpu().numpy()
        return _wav_bytes(wav, getattr(spec, "sample_rate", 22050))

    # -- HTTP ---------------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": server.model_name, "object": "model"}]})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                ctype = self.headers.get("Content-Type", "")
                try:
                    if self.path == "/v1/audio/transcriptions":
                        if ctype.startswith("multipart/form-data"):
                            data = _multipart_file(body, ctype)
                            if data is None:
                                return self._json(400, {"error": "no file part"})
                        else:
                            data = body  # a raw audio/wav body
                        return self._json(200, {"text": server.transcribe_bytes(data)})
                    if self.path == "/v1/audio/speech":
                        req = json.loads(body or b"{}")
                        wav = server.synthesize(str(req.get("input", "")))
                        self.send_response(200)
                        self.send_header("Content-Type", "audio/wav")
                        self.send_header("Content-Length", str(len(wav)))
                        self.end_headers()
                        self.wfile.write(wav)
                        return
                    self._json(404, {"error": "not found"})
                except Exception as e:  # the server keeps running; the client gets the error
                    log.exception("audio endpoint error")
                    self._json(500, {"error": str(e)})

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8001,
              blocking: bool = True) -> ThreadingHTTPServer:
        """Listen on (host, port); port 0 takes a free one, which `self.port`
        then holds."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.port = self._httpd.server_address[1]
        log.info("AudioServer listening on %s:%d", host, self.port)
        if blocking:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        return self._httpd

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop the HTTP server and wait for its thread."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
