from nemo_tpu_torch.models.tts.fastpitch_model import FastPitchModel  # noqa: F401
from nemo_tpu_torch.models.tts.hifigan_model import HifiGanModel  # noqa: F401
