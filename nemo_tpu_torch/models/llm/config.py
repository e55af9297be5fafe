"""GPT model config and the presets the port runs (a copy of
nemo_tpu/models/llm/config.py:16-190 with `tiny_test`, `llama32_1b` and
`phi3_mini_4k` (config.py:227), without JAX).

The fields and their defaults are the JAX package's, so that a config means
the same model in both packages (tests/test_torch_gpt.py holds them equal).
The port implements a subset of the fields: `models/llm/gpt.py:check_supported`
raises on every value it does not implement.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    num_layers: int = 12
    hidden_size: int = 768
    ffn_hidden_size: int = 3072
    num_attention_heads: int = 12
    num_query_groups: Optional[int] = None  # None → MHA; <heads → GQA
    kv_channels: Optional[int] = None  # None → hidden/heads
    vocab_size: int = 32000
    seq_length: int = 2048
    max_position_embeddings: Optional[int] = None

    # structure
    normalization: str = "RMSNorm"  # RMSNorm | LayerNorm
    layernorm_epsilon: float = 1e-5
    gated_linear_unit: bool = True  # SwiGLU
    activation: str = "silu"  # silu | gelu | squared_relu
    add_bias_linear: bool = False
    add_qkv_bias: bool = False
    position_embedding_type: str = "rope"  # rope | learned_absolute | none
    rotary_base: float = 10000.0
    rotary_percent: float = 1.0
    # None | "llama3" (wavelength-banded) | "linear" (gemma3 global) |
    # "yarn" (gpt-oss: NTK-by-parts interpolation + concentration mscale)
    rope_scaling: Optional[str] = None
    rope_scaling_factor: float = 8.0
    old_context_len: int = 8192  # llama3/yarn scaling original context
    # qwen2-VL multimodal RoPE: per-frequency-section position axes
    # (temporal, height, width); sum must be head_dim//2. Positions become
    # [B, S, 3] (reference vlm/qwen2vl multimodal rotary embedding).
    mrope_sections: Optional[Tuple[int, ...]] = None
    share_embeddings_and_output_weights: bool = False
    attention_softmax_in_fp32: bool = True
    qk_layernorm: bool = False  # qwen3-style per-head q/k norm
    # gemma2/3: extra norms on the attention and MLP OUTPUTS before the
    # residual adds (HF post_attention_layernorm applied to attn output +
    # pre/post_feedforward_layernorm sandwich)
    sandwich_norms: bool = False
    layernorm_zero_centered_gamma: bool = False  # gemma-style (1+g) scale
    attention_multiplier: Optional[float] = None  # custom softmax scale
    embedding_multiplier: Optional[float] = None  # gemma: sqrt(hidden)
    logit_softcapping: Optional[float] = None  # gemma2
    attn_logit_softcapping: Optional[float] = None  # gemma2 attn scores
    window_size: Optional[int] = None  # sliding-window attention (mistral)
    # False → bidirectional attention (NV-Embed-style encoders built on a
    # decoder stack; reference llama_embedding.py get_nv_embedding_layer_spec)
    causal: bool = True
    # per-layer heterogeneity (cyclic patterns over layer index; reference
    # gemma3 interleaved_attn_pattern, gpt_oss window_attn_skip_freq,
    # llama4 moe_layer_freq/nope_layer_interval). When the cycle period
    # divides num_layers, layers are scanned in pattern-period groups;
    # otherwise the stack unrolls.
    # window per layer i = window_pattern[i % len]; None entry = global.
    # gemma3: (512,)*5 + (None,); gemma2/gpt_oss: (4096|128, None).
    window_pattern: Optional[Tuple[Optional[int], ...]] = None
    # rotary base used by windowed (local) layers when set (gemma3:
    # 10k local / 1M global; rope scaling applies to global layers only)
    rope_local_base: Optional[float] = None
    # llama4: every k-th layer (i+1 % k == 0) skips rope entirely (NoPE)
    nope_layer_interval: Optional[int] = None
    # llama4: local (rope) layers attend only within chunks of this size
    attention_chunk_size: Optional[int] = None
    # llama4: L2-normalize q/k after rope on rope layers (no learnable scale)
    qk_l2_norm: bool = False
    # gpt-oss: learnable per-head sink logit added to the softmax
    # denominator (HF `sinks` / MCore softmax_offset)
    attention_sinks: bool = False
    # chatglm/llama4: rotate (x0,x1),(x2,x3) pairs instead of halves
    rotary_interleaved: bool = False
    # gpt-oss: clamp GLU gate to (-inf, c] and up-projection to [-c, c]
    activation_clamp: Optional[float] = None
    # gpt-oss: GLU linear term is (up + offset) — HF GptOssExperts (up+1)*glu
    glu_linear_offset: float = 0.0

    # multi-token prediction (deepseek-V3 MTP, reference gpt/model/base.py
    # mtp_block_spec): an extra transformer block predicts token t+2 from
    # [norm(h_t); norm(emb(x_{t+1}))]; trained with coeff-weighted CE
    mtp_num_layers: int = 0
    mtp_loss_coeff: float = 0.1

    # MoE (0 experts = dense)
    num_moe_experts: int = 0
    moe_router_topk: int = 2
    moe_ffn_hidden_size: Optional[int] = None
    moe_shared_expert_intermediate_size: Optional[int] = None
    moe_router_pre_softmax: bool = False
    moe_aux_loss_coeff: float = 0.0
    # deepseek-v3 routing (reference: gpt/model/deepseek.py): sigmoid scores,
    # aux-loss-free e-score correction bias, node/group-limited topk,
    # normalized weights × scaling factor
    moe_router_score_function: str = "softmax"  # softmax | sigmoid
    moe_router_enable_expert_bias: bool = False
    # aux-loss-free balancing (deepseek-v3): after each optimizer step the
    # e-score correction bias moves by ±rate against the per-step expert
    # load sign (underloaded experts gain bias). Applied by GPTTrainModule,
    # not by the gradient path (the bias is behind stop_gradient).
    moe_router_bias_update_rate: float = 1e-3
    moe_router_num_groups: Optional[int] = None
    moe_router_group_topk: Optional[int] = None
    moe_router_topk_scaling_factor: Optional[float] = None
    moe_router_norm_topk_prob: bool = False
    # layers [0, moe_first_k_dense) use a dense MLP instead of MoE
    # (deepseek first_k_dense_replace). Requires scan_layers=False.
    moe_first_k_dense: int = 0
    # cyclic 0/1 pattern: layer i is MoE iff moe_layer_freq[i % len]
    # (llama4 maverick (0, 1): MoE every other layer)
    moe_layer_freq: Optional[Tuple[int, ...]] = None

    # Multi-head Latent Attention (deepseek v2/v3; reference
    # gpt/model/deepseek.py MLATransformerConfig). kv_lora_rank != None
    # switches Attention → MLAAttention.
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_head_dim: int = 128  # nope (non-rotary) part per head
    qk_pos_emb_head_dim: int = 64  # rotary part per head
    v_head_dim: int = 128
    # dispatch: "topk" = sort-based capacity dispatch (per-token FLOPs ∝ topk,
    # expert-sharded over the ep mesh axis — MCore a2a token-dispatcher
    # equivalent); "dense" = all-experts einsum (exact, no drops; debug/parity)
    moe_dispatch: str = "topk"
    # capacity per expert = ceil(tokens·topk/E · capacity_factor); overflow
    # tokens are dropped (reference: MCore capacity_factor + token drop)
    moe_capacity_factor: float = 1.25

    # attention backend: "xla" (einsum) | "flash" (Pallas kernel)
    attention_backend: str = "xla"
    # context parallelism (ring attention over the 'cp' mesh axis).
    # >1 → Attention runs shard_map'd Pallas ring-flash with zig-zag
    # causal load balancing (reference: TE CP p2p ring, parallelisms.rst:365).
    cp_size: int = 1

    # quantized GEMMs: None (bf16) | "fp8" (e4m3 fwd / e5m2 bwd grads,
    # current scaling — TE Float8CurrentScaling 'hybrid' recipe equivalent,
    # mixed_precision.py:55) | "fp8_e4m3" | "int8" (v5e MXU int8 fwd,
    # bf16 bwd). Applies to the attention q/k/v/o and MLP fc1/fc2 GEMMs.
    quantization: Optional[str] = None

    # fused linear+CE training loss: never materializes [B,S,V] logits
    # (chunked remat scan over the sequence; Megatron vocab-parallel-CE
    # equivalent). Identical math to the plain path.
    fused_ce: bool = True
    fused_ce_chunk: int = 512

    # numerics / training
    init_method_std: float = 0.02
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    params_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat: "none" | "full" | "dots" (checkpoint matmul outputs only)
    remat: str = "full"
    scan_layers: bool = True  # stack layers with nn.scan (fast compiles)

    @property
    def head_dim(self) -> int:
        return self.kv_channels or self.hidden_size // self.num_attention_heads

    @property
    def n_kv_heads(self) -> int:
        return self.num_query_groups or self.num_attention_heads


def _cfg(**kw) -> GPTConfig:
    return GPTConfig(**kw)


def _preset(defaults: dict, kw: dict) -> GPTConfig:
    merged = dict(defaults)
    merged.update(kw)  # user overrides win
    return GPTConfig(**merged)


def tiny_test(**kw) -> GPTConfig:
    kw.setdefault("num_layers", 2)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("ffn_hidden_size", 128)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("num_query_groups", 2)
    kw.setdefault("vocab_size", 128)
    kw.setdefault("seq_length", 64)
    kw.setdefault("compute_dtype", "float32")
    return _cfg(**kw)


def llama32_1b(**kw) -> GPTConfig:
    return _preset(dict(num_layers=16, hidden_size=2048, ffn_hidden_size=8192, num_attention_heads=32, num_query_groups=8, vocab_size=128256, seq_length=131072, rotary_base=500000.0, rope_scaling='llama3', rope_scaling_factor=32.0, share_embeddings_and_output_weights=True), kw)


def phi3_mini_4k(**kw) -> GPTConfig:
    """reference: gpt/model/phi3.py Phi3ConfigMini (microsoft/Phi-3-mini-4k):
    32 heads of dh 96, no query groups, an untied head."""
    return _preset(dict(num_layers=32, hidden_size=3072, ffn_hidden_size=8192, num_attention_heads=32, vocab_size=32064, seq_length=4096, rotary_base=10000.0), kw)
