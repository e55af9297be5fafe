from nemo_tpu_torch.agents.voice_agent import (  # noqa: F401
    CallableLLMService,
    ModelASRService,
    NativeTTSService,
    TurnConfig,
    VoiceAgent,
)
