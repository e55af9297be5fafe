"""Model size and FLOPs per token, for MFU: the dense branches of
nemo_tpu/llm/auto_configurator.py:_param_count and model_flops_per_token
(57-83). For llama32_1b at S=2048: 1,235,814,400 parameters and
7.8175e9 training FLOPs per token. The MoE terms wait for the slice that
ports MoE (the port's GPTModel raises on `num_moe_experts`)."""

from __future__ import annotations

from nemo_tpu_torch.models.llm.config import GPTConfig


def _param_count(cfg: GPTConfig) -> float:
    """Transformer parameter count of a dense model."""
    D, F, L, V = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_layers, cfg.vocab_size
    H, G, dh = cfg.num_attention_heads, cfg.n_kv_heads, cfg.head_dim
    attn = D * H * dh + 2 * D * G * dh + H * dh * D
    mlp = (2 if cfg.gated_linear_unit else 1) * D * F + F * D
    emb = V * D * (1 if cfg.share_embeddings_and_output_weights else 2)
    return float(L * (attn + mlp + 2 * D) + emb + D)


def model_flops_per_token(cfg: GPTConfig) -> float:
    """Fwd+bwd useful FLOPs per token (6·N + the causal attention term)."""
    attn = 12 * cfg.num_layers * cfg.hidden_size * cfg.seq_length / 2  # causal
    return 6.0 * _param_count(cfg) + attn
