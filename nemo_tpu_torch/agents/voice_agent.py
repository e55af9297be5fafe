"""Voice agent: the cascaded ASR → LLM → TTS conversation (counterpart of
nemo_tpu/agents/voice_agent.py).

Pluggable services around the port's models, with an energy VAD that ends
a turn after a run of silence:

    agent = VoiceAgent(ModelASRService(ctc_model),
                       CallableLLMService(lambda prompt: reply_text),
                       NativeTTSService(FastPitchModel(), HifiGanModel()))
    user_text, reply, reply_audio = agent.converse(audio)   # one whole utterance
    turn = agent.push_audio(chunk)                            # None while listening

Services are duck-typed:
  ASRService.transcribe(audio [T] f32, sr) -> str
  LLMService.respond(history: list[dict(role, content)]) -> str
  TTSService.synthesize(text) -> (audio [T'] f32, sr)
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from nemo_tpu_torch.data.audio_io import write_wav


@dataclasses.dataclass
class TurnConfig:
    """Energy-VAD end-of-turn detection: frames of `frame_secs` above
    `threshold_db` are speech; a turn ends after `end_silence_secs` of
    silence that follows speech, once `min_speech_secs` are buffered."""

    sample_rate: int = 16000
    frame_secs: float = 0.05
    threshold_db: float = -40.0
    end_silence_secs: float = 0.6
    min_speech_secs: float = 0.2


class ModelASRService:
    """Wraps a model with `.transcribe([wav path]) -> [str]`: the audio goes
    through a 16-bit WAV file, as in JAX."""

    def __init__(self, model):
        self.model = model

    def transcribe(self, audio: np.ndarray, sr: int) -> str:
        fd, path = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
        try:
            write_wav(path, audio.astype(np.float32), sr)
            return self.model.transcribe([path])[0]
        finally:
            os.remove(path)


class CallableLLMService:
    """Wraps a text → text callable, over a chatml-like prompt of the history."""

    def __init__(self, fn: Callable[[str], str],
                 system_prompt: str = "You are a helpful voice assistant."):
        self.fn = fn
        self.system_prompt = system_prompt

    def respond(self, history: List[Dict[str, str]]) -> str:
        parts = [f"system: {self.system_prompt}"]
        for m in history:
            parts.append(f"{m['role']}: {m['content']}")
        parts.append("assistant:")
        return self.fn("\n".join(parts)).strip()


class NativeTTSService:
    """A spectrogram model (FastPitch) and a vocoder (HiFi-GAN)."""

    def __init__(self, spec_model, vocoder, sample_rate: int = 22050):
        self.spec_model = spec_model
        self.vocoder = vocoder
        self.sample_rate = sample_rate

    def synthesize(self, text: str) -> Tuple[np.ndarray, int]:
        mel = self.spec_model.generate_spectrogram(self.spec_model.parse(text))
        audio = self.vocoder.convert_spectrogram_to_audio(mel)
        return audio[0].float().cpu().numpy(), self.sample_rate


class VoiceAgent:
    """Push audio chunks; a finished turn comes back as (user_text,
    reply_text, reply_audio). `converse(audio)` takes one whole utterance."""

    def __init__(self, asr, llm, tts, turn: Optional[TurnConfig] = None):
        self.asr = asr
        self.llm = llm
        self.tts = tts
        self.turn = turn or TurnConfig()
        self.history: List[Dict[str, str]] = []
        self.reset_audio()

    def reset_audio(self) -> None:
        self._buf = np.zeros(0, np.float32)
        self._speech_started = False
        self._silence = 0.0

    def _frame_active(self, frame: np.ndarray) -> bool:
        if len(frame) == 0:
            return False
        db = 10.0 * np.log10(float(np.mean(frame ** 2)) + 1e-10)
        return db > self.turn.threshold_db

    def push_audio(self, chunk: np.ndarray) -> Optional[Tuple[str, str, np.ndarray]]:
        """A finished turn, or None while listening."""
        t = self.turn
        self._buf = np.concatenate([self._buf, np.asarray(chunk, np.float32)])
        n = int(t.frame_secs * t.sample_rate)
        active_any = False
        for s in range(0, max(len(chunk) - n + 1, 1), n):
            if self._frame_active(np.asarray(chunk[s:s + n], np.float32)):
                active_any = True
        if active_any:
            self._speech_started = True
            self._silence = 0.0
        else:
            self._silence += len(chunk) / t.sample_rate
        if (self._speech_started and self._silence >= t.end_silence_secs
                and len(self._buf) / t.sample_rate >= t.min_speech_secs):
            audio = self._buf
            self.reset_audio()
            return self._complete_turn(audio)
        return None

    def _complete_turn(self, audio: np.ndarray) -> Tuple[str, str, np.ndarray]:
        user_text = self.asr.transcribe(audio, self.turn.sample_rate)
        self.history.append({"role": "user", "content": user_text})
        reply = self.llm.respond(self.history)
        self.history.append({"role": "assistant", "content": reply})
        reply_audio, _ = self.tts.synthesize(reply or " ")
        return user_text, reply, reply_audio

    def converse(self, audio: np.ndarray) -> Tuple[str, str, np.ndarray]:
        """One whole turn on a complete utterance."""
        return self._complete_turn(np.asarray(audio, np.float32))
