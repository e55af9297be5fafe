"""HuggingFace ↔ port weight conversion for llama-family causal LMs: the
counterpart of nemo_tpu/interop/hf_llama.py (`config_from_hf` 21,
`params_from_hf_state` 52, `export_hf_llama_state` 207).

The port's `GPTModel` keeps each projection as a Linear weight [out, in],
HF's own layout, so a converted state is HF's tensors under the port's
names (`layers.{i}.attention.q_proj.weight`, `final_norm.scale`,
`embedding`, `lm_head.weight`); only SwiGLU's gate and up projections are
joined into `fc1` [2F, D] (gate rows first, as the JAX package's fc1 kernel
[D, 2F] holds gate columns first). The architectures covered are those
`models/llm/gpt.py:check_supported` takes: RMSNorm, SwiGLU, GQA and
rotate-half RoPE without biases or qk norms, tied or untied heads.

Nothing here loads a checkpoint: the caller hands in the HF config object
and the state as numpy arrays (`hf_models.py:import_hf_model`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from nemo_tpu_torch.models.llm.config import GPTConfig


def config_from_hf(hf_cfg) -> GPTConfig:
    """A transformers LlamaConfig-like object → GPTConfig, field for field as
    the JAX package maps it (its compute dtype fp32)."""
    rope_scaling = None
    factor = 8.0
    old_ctx = 8192
    rs = getattr(hf_cfg, "rope_scaling", None)
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        rope_scaling = "llama3"
        factor = float(rs.get("factor", 8.0))
        old_ctx = int(rs.get("original_max_position_embeddings", 8192))
    return GPTConfig(
        num_layers=hf_cfg.num_hidden_layers,
        hidden_size=hf_cfg.hidden_size,
        ffn_hidden_size=hf_cfg.intermediate_size,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_query_groups=getattr(hf_cfg, "num_key_value_heads", None),
        kv_channels=getattr(hf_cfg, "head_dim", None),
        vocab_size=hf_cfg.vocab_size,
        seq_length=hf_cfg.max_position_embeddings,
        layernorm_epsilon=getattr(hf_cfg, "rms_norm_eps", 1e-5),
        rotary_base=getattr(hf_cfg, "rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        rope_scaling_factor=factor,
        old_context_len=old_ctx,
        add_qkv_bias=bool(getattr(hf_cfg, "attention_bias", False)),
        qk_layernorm=getattr(hf_cfg, "model_type", "") in ("qwen3", "qwen3_moe"),
        share_embeddings_and_output_weights=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        compute_dtype="float32",
    )


# port name (layer i) → HF name, for every tensor carried as it is
_LAYER = {
    "input_norm.scale": "input_layernorm.weight",
    "post_attn_norm.scale": "post_attention_layernorm.weight",
    "attention.q_proj.weight": "self_attn.q_proj.weight",
    "attention.k_proj.weight": "self_attn.k_proj.weight",
    "attention.v_proj.weight": "self_attn.v_proj.weight",
    "attention.o_proj.weight": "self_attn.o_proj.weight",
    "mlp.fc2.weight": "mlp.down_proj.weight",
}


def params_from_hf_state(sd: Mapping[str, np.ndarray], cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """An HF llama state dict (numpy) → the state of `GPTModel(cfg)` (fp32
    tensors by the port's names). An untied head takes `lm_head.weight`, or
    the embedding where the state has none (as the JAX package does). Raises
    where the state carries what the port does not take (biases, qk norms,
    sandwich norms) or lacks a tensor."""
    extra = [k for k in sd if k.endswith(".bias") or "q_norm" in k
             or "pre_feedforward_layernorm" in k]
    if extra or cfg.add_qkv_bias or cfg.add_bias_linear or not cfg.gated_linear_unit:
        raise NotImplementedError(
            f"params_from_hf_state: biases, qk norms, sandwich norms and MLPs other than "
            f"SwiGLU are not ported ({extra[:3]})")

    def t(key):
        return torch.from_numpy(np.ascontiguousarray(sd[key], dtype=np.float32))

    state = {"embedding": t("model.embed_tokens.weight"),
             "final_norm.scale": t("model.norm.weight")}
    for i in range(cfg.num_layers):
        hf = f"model.layers.{i}"
        for name, key in _LAYER.items():
            state[f"layers.{i}.{name}"] = t(f"{hf}.{key}")
        state[f"layers.{i}.mlp.fc1.weight"] = torch.cat(
            [t(f"{hf}.mlp.gate_proj.weight"), t(f"{hf}.mlp.up_proj.weight")])
    if not cfg.share_embeddings_and_output_weights:
        state["lm_head.weight"] = t("lm_head.weight" if "lm_head.weight" in sd
                                    else "model.embed_tokens.weight")
    return state


def export_hf_llama_state(state: Mapping[str, torch.Tensor],
                          cfg: GPTConfig) -> Dict[str, np.ndarray]:
    """The state of a `GPTModel(cfg)` (its `state_dict()`, or
    `params_from_hf_state`'s) → an HF llama state dict of fp32 numpy arrays,
    under the names the JAX package's export writes (split gate and up
    projections; `lm_head.weight` only for an untied head)."""
    def a(key):
        return state[key].detach().to("cpu", torch.float32).numpy().copy()

    F = cfg.ffn_hidden_size
    sd = {"model.embed_tokens.weight": a("embedding"), "model.norm.weight": a("final_norm.scale")}
    if "lm_head.weight" in state:
        sd["lm_head.weight"] = a("lm_head.weight")
    for i in range(cfg.num_layers):
        hf = f"model.layers.{i}"
        for name, key in _LAYER.items():
            sd[f"{hf}.{key}"] = a(f"layers.{i}.{name}")
        fc1 = a(f"layers.{i}.mlp.fc1.weight")
        sd[f"{hf}.mlp.gate_proj.weight"] = fc1[:F]
        sd[f"{hf}.mlp.up_proj.weight"] = fc1[F:]
    return sd
