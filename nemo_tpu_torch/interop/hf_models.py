"""HF importers beyond the llama family: the counterpart of the phi3 branch
of nemo_tpu/interop/hf_models.py (`_split_phi3_fused` 25, `import_hf_model`
406-460).

Phi-3 fuses q, k and v into `qkv_proj` ([H dh + 2 G dh, D]) and the gate and
up projections into `gate_up_proj` ([2F, D]); they are split to llama-style
names so that `hf_llama.py`'s converter applies. Any other model type whose
JAX branch converts it its own way (MLA, MoE, Mamba-2, Gemma, StarCoder2,
Nemotron) is not ported and raises NotImplementedError; llama-style types
take `hf_llama.py` as they do in JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from nemo_tpu_torch.interop.hf_llama import config_from_hf, params_from_hf_state
from nemo_tpu_torch.models.llm.config import GPTConfig

# model types whose JAX branch (hf_models.py:418-470) the port does not have
_NOT_PORTED = ("mamba2", "gemma3_text", "gemma3", "gpt_oss", "deepseek_v3", "mixtral",
               "qwen3_moe", "gemma2", "starcoder2", "nemotron")


def _split_phi3_fused(sd: Mapping[str, np.ndarray], hf_cfg) -> Dict[str, np.ndarray]:
    """phi3's fused qkv_proj and gate_up_proj split to llama-style names."""
    out = dict(sd)
    H = hf_cfg.num_attention_heads
    G = hf_cfg.num_key_value_heads
    dh = hf_cfg.hidden_size // H
    F = hf_cfg.intermediate_size
    i = 0
    while f"model.layers.{i}.self_attn.qkv_proj.weight" in out:
        w = out.pop(f"model.layers.{i}.self_attn.qkv_proj.weight")
        out[f"model.layers.{i}.self_attn.q_proj.weight"] = w[: H * dh]
        out[f"model.layers.{i}.self_attn.k_proj.weight"] = w[H * dh: (H + G) * dh]
        out[f"model.layers.{i}.self_attn.v_proj.weight"] = w[(H + G) * dh:]
        gu = out.pop(f"model.layers.{i}.mlp.gate_up_proj.weight")
        out[f"model.layers.{i}.mlp.gate_proj.weight"] = gu[:F]
        out[f"model.layers.{i}.mlp.up_proj.weight"] = gu[F:]
        i += 1
    return out


def import_hf_model(path_or_config, state: Optional[Mapping[str, np.ndarray]] = None
                    ) -> Tuple[GPTConfig, Dict[str, torch.Tensor]]:
    """(an HF config object, its state dict as numpy arrays) → (GPTConfig,
    the state of `GPTModel(cfg)`), dispatching on `config.model_type` as the
    JAX package does: phi3 split and converted, llama-style types converted
    by `hf_llama.py`. A path would load the checkpoint through
    `transformers`, which the port does not depend on: it raises."""
    if isinstance(path_or_config, str):
        raise NotImplementedError(
            f"import_hf_model({path_or_config!r}): loading a checkpoint path needs the "
            f"`transformers` package, which the port does not use; pass the HF config and its "
            f"state dict as numpy arrays")
    c = path_or_config
    mt = getattr(c, "model_type", "")
    if mt in _NOT_PORTED:
        raise NotImplementedError(f"import_hf_model: model_type {mt!r} is not ported")
    if state is None:
        raise ValueError("import_hf_model: the state dict is missing")
    cfg = config_from_hf(c)
    sd = _split_phi3_fused(state, c) if mt == "phi3" else dict(state)
    return cfg, params_from_hf_state(sd, cfg)
