"""GPT transformer stack (counterpart of nemo_tpu/models/llm/gpt.py) in the
dense, causal, RoPE form that Llama-3.2-1B and GPT-551M train in:

    embedding → L × [RMSNorm → GQA attention with RoPE → residual,
                     RMSNorm → SwiGLU MLP → residual] → RMSNorm → (tied) head

Parameters are held in `params_dtype` (fp32 by default) and cast to the
compute dtype at each use, as flax's DenseGeneral does; the norms and the
RoPE rotation are fp32 islands. The layers are a ModuleList (no scan
stacking); `remat="full"` wraps each layer in `torch.utils.checkpoint`, the
counterpart of `nn.remat` at gpt.py:1195. Attention takes the hand-written
flash kernels (K5 forward, K6/K7 backward, `ops/flash_attention.py`) where
the JAX model takes its Pallas kernel (gpt.py:627-652: backend "flash", no
KV cache, S a multiple of 128), and the einsum path otherwise. Packed batches
(SFT) carry per-token `positions` for RoPE and `segment_ids` (0 = padding):
the flash branch then takes the packed kernels (K8 forward, K9/K10
backward), the einsum path masks to pairs of one segment (gpt.py:408-410).
With `cp_size > 1` attention takes ring attention over the context-parallel
ranks (`ops/ring_attention.py`, the positions kernels K11-K13) under JAX's
conditions (gpt.py:591-619) and refuses a batch that does not meet them
(`GPTModel.uses_ring`); the ring holds every rank in this process
(`LocalRing`, the default: the model sees the whole zig-zag-ordered
sequence and cuts it into cp shards, as shard_map does) or one rank a
process (`ProcessGroupRing`: the model sees its own shard).

Serving (gpt.py:285-577, 1347): the model takes a KV cache (`init_kv_caches`,
bf16/fp32 or int8 with per-token scales), written in place, and decodes
by JAX's two routes (`Attention`); `quantization="int8_ptq"` makes every
projection and an untied head int8-resident (`ops/quant.py:QuantDense`).
The training modes `quantization` "fp8", "fp8_e4m3" and "int8" make every
projection (q, k, v, o, fc1, fc2; not the head, as in JAX) a
`ops/quant.py:TrainingQuantDense`, whose GEMM is `quant_matmul`.

Parameter names mirror the JAX tree (`layers.3.attention.q_proj`,
`final_norm.scale`, `embedding`), so `interop/jax_params.py` carries JAX
variables across. `check_supported` raises on every config value the port
does not implement.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_packed, pos_tile_ranges, seg_tile_ranges)
from nemo_tpu_torch.ops.quant import TRAINING_MODES, dense_layer
from nemo_tpu_torch.ops.ring_attention import LocalRing, ring_flash_attention

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def check_supported(cfg: GPTConfig) -> None:
    """Raise NotImplementedError naming the first field of `cfg` whose value
    selects a part of the JAX model that the port does not implement (MoE,
    MLA, MTP, softcapping, sinks, chunked or per-layer attention patterns,
    qk norms, sandwich norms, other position embeddings, dropout, other
    remat policies, LayerNorm,
    biases, bidirectional attention, RoPE scalings other than llama3, MLPs
    other than SwiGLU)."""
    ok = {
        "num_moe_experts": cfg.num_moe_experts == 0,
        "kv_lora_rank": cfg.kv_lora_rank is None,
        "mtp_num_layers": cfg.mtp_num_layers == 0,
        "logit_softcapping": not cfg.logit_softcapping,
        "attn_logit_softcapping": not cfg.attn_logit_softcapping,
        "attention_sinks": not cfg.attention_sinks,
        "attention_chunk_size": cfg.attention_chunk_size is None,
        "window_pattern": cfg.window_pattern is None,
        "nope_layer_interval": not cfg.nope_layer_interval,
        "qk_layernorm": not cfg.qk_layernorm,
        "qk_l2_norm": not cfg.qk_l2_norm,
        "sandwich_norms": not cfg.sandwich_norms,
        "position_embedding_type": cfg.position_embedding_type == "rope",
        "mrope_sections": cfg.mrope_sections is None,
        "rotary_interleaved": not cfg.rotary_interleaved,
        "rope_scaling": cfg.rope_scaling in (None, "llama3"),
        "rope_local_base": cfg.rope_local_base is None,
        "hidden_dropout": not cfg.hidden_dropout,
        "attention_dropout": not cfg.attention_dropout,
        "quantization": cfg.quantization in (None, "int8_ptq", *TRAINING_MODES),
        "cp_size": cfg.cp_size >= 1,
        "remat": cfg.remat in ("full", "none"),
        "normalization": cfg.normalization == "RMSNorm",
        "layernorm_zero_centered_gamma": not cfg.layernorm_zero_centered_gamma,
        "add_bias_linear": not cfg.add_bias_linear,
        "add_qkv_bias": not cfg.add_qkv_bias,
        "causal": cfg.causal,
        "embedding_multiplier": cfg.embedding_multiplier is None,
        "activation_clamp": cfg.activation_clamp is None,
        "glu_linear_offset": not cfg.glu_linear_offset,
        "gated_linear_unit": cfg.gated_linear_unit,
        "activation": cfg.activation == "silu",
        "attention_backend": cfg.attention_backend in ("xla", "flash"),
        "params_dtype": cfg.params_dtype in DTYPES,
        "compute_dtype": cfg.compute_dtype in DTYPES,
    }
    for name, good in ok.items():
        if not good:
            raise NotImplementedError(
                f"GPTConfig.{name}={getattr(cfg, name)!r} is not implemented by the PyTorch port")


# --------------------------------------------------------------------------
# RMSNorm, RoPE
# --------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · scale in fp32, cast back to x's dtype
    (gpt.py:47)."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.scale.float()).to(x.dtype)


def rope_frequencies(cfg: GPTConfig) -> np.ndarray:
    """Inverse frequencies [head_dim/2] in float64 numpy, cast to fp32, with
    llama3's wavelength-dependent scaling where the config asks for it: the
    branches of gpt.py:183 that `check_supported` lets through."""
    dim = int(cfg.head_dim * cfg.rotary_percent)
    inv = 1.0 / (cfg.rotary_base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    if cfg.rope_scaling == "llama3":
        factor = cfg.rope_scaling_factor
        low_freq_factor, high_freq_factor = 1.0, 4.0
        old_len = cfg.old_context_len
        wavelen = 2 * np.pi / inv
        low_wl = old_len / low_freq_factor
        high_wl = old_len / high_freq_factor
        scaled = inv / factor
        smooth = (old_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
        mid = (1 - smooth) * scaled + smooth * inv
        inv = np.where(wavelen > low_wl, scaled, np.where(wavelen < high_wl, inv, mid))
    return inv.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, heads, D], positions [B, S] or [S]: rotates the first
    2·len(inv_freq) channels in the half-split convention, angles and
    rotation in fp32 (gpt.py:260)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv_freq  # [B, S, D/2]
    sin, cos = ang.sin()[:, :, None, :], ang.cos()[:, :, None, :]
    rot = 2 * inv_freq.shape[-1]
    x1, x2 = x[..., :rot].float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return out if rot == x.shape[-1] else torch.cat([out, x[..., rot:]], dim=-1)


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------


def _quantize_kv(x: torch.Tensor):
    """[B, S, G, D] → (int8 q, fp32 per-(token, head) scale [B, S, G, 1]),
    clipped then rounded half to even, as gpt.py:291."""
    x32 = x.float()
    s = torch.clamp_min(x32.abs().amax(-1, keepdim=True), 1e-12) / 127.0
    return torch.round(torch.clamp(x32 / s, -127, 127)).to(torch.int8), s


def _dequantize_kv(c, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(c, dict):
        return (c["q"].float() * c["s"]).to(dtype)
    return c


def _cache_write(c: torch.Tensor, val: torch.Tensor, decode_index) -> None:
    """Write `val` into the cache view `c` in place along the time axis at
    `decode_index` (gpt.py:305): an int writes rows [i, i + S) of every slot
    (batch generate, chunked prefill) and raises where they overrun the
    cache, which JAX's dynamic_update_slice would clamp silently; a [B]
    tensor writes one row a slot (continuous batching, S = 1)."""
    if isinstance(decode_index, torch.Tensor) and decode_index.dim() == 1:
        c[torch.arange(val.shape[0], device=c.device), decode_index] = val[:, 0].to(c.dtype)
        return
    start, end = int(decode_index), int(decode_index) + val.shape[1]
    if start < 0 or end > c.shape[1]:
        raise ValueError(f"a cache write of rows [{start}, {end}) overruns the cache's "
                         f"{c.shape[1]} rows")
    c[:, start:end] = val.to(c.dtype)


def _to_cache(x: torch.Tensor, c):
    """`x` [B, S, G, D] as the cache side `c` stores it: {"q", "s"} for an
    int8 side (`_quantize_kv`), else x in the side's dtype."""
    if isinstance(c, dict):
        return dict(zip("qs", _quantize_kv(x)))
    return x.to(c.dtype)


def _store(c, stored, decode_index) -> None:
    """Write a `_to_cache` result into the cache side `c` at `decode_index`."""
    if isinstance(c, dict):
        for key in ("q", "s"):
            _cache_write(c[key], stored[key], decode_index)
    else:
        _cache_write(c, stored, decode_index)


def _update_kv_cache(ck, cv, k: torch.Tensor, v: torch.Tensor, decode_index):
    """Write new k and v at `decode_index`, then return the whole cache
    (dequantised) to attend over (gpt.py:317)."""
    _store(ck, _to_cache(k, ck), decode_index)
    _store(cv, _to_cache(v, cv), decode_index)
    return _dequantize_kv(ck, k.dtype), _dequantize_kv(cv, v.dtype)


def init_kv_caches(cfg: GPTConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                   device: Union[str, torch.device, None] = None):
    """The stacked cache (gpt.py:1347): ([L, B, T, G, D], [L, B, T, G, D]) in
    `dtype`, or with dtype=torch.int8 each side {"q": int8 [L, B, T, G, D],
    "s": fp32 [L, B, T, G, 1]} (quantised per token and head on write). The
    model writes into it in place."""
    shape = (cfg.num_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if dtype == torch.int8:
        def side():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)}
        return side(), side()
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def cache_map(fn, caches):
    """`fn` applied to every tensor of a cache pair (either dtype's form)."""
    return tuple({k: fn(t) for k, t in side.items()} if isinstance(side, dict) else fn(side)
                 for side in caches)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                     window: Optional[int] = None, softmax_fp32: bool = True,
                     kv_offset: Union[int, torch.Tensor] = 0,
                     kv_valid: Optional[torch.Tensor] = None,
                     segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query causal attention as einsums (gpt.py:341, the
    `attention_backend="xla"` path without sinks): q [B, Sq, H, D], k and v
    [B, Skv, G, D] → [B, Sq, H, D]; fp32 scores, the causal and window mask
    at -1e30, softmax, then the value product in v's dtype. Query i sits at
    `kv_offset` + i (an int, or a [B] tensor of per-slot offsets);
    `kv_valid` [B, Skv] masks out keys (left padding); with `segment_ids`
    [B, S] only pairs of one nonzero id are kept (gpt.py:408-410). A row
    that keeps no key (padding, id 0) gets, as in JAX, the mean of v, which
    reaches no other row and no loss."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    qg = q.reshape(B, Sq, G, H // G, D)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float()) * scale
    if isinstance(kv_offset, torch.Tensor):
        kv_offset = kv_offset[:, None]
    qpos = (torch.arange(Sq, device=q.device)[None, :] + kv_offset)[:, :, None]  # [1|B, Sq, 1]
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    if segment_ids is not None:
        qs = segment_ids[:, :, None]
        mask = mask & (qs == segment_ids[:, None, :]) & (qs > 0)
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    if not softmax_fp32:
        scores = scores.to(q.dtype)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def _decode_attention(q: torch.Tensor, ck, cv, k_new: torch.Tensor, v_new: torch.Tensor, *,
                      cl: torch.Tensor, scale: float, window: Optional[int],
                      softmax_fp32: bool) -> torch.Tensor:
    """One-token decode attention over the cache as it was before this
    step's write, plus an explicit column for the current token
    (gpt.py:429): q [B, 1, H, D]; ck, cv the cache sides [B, T, G, D]; k_new,
    v_new [B, 1, G, D] already round-tripped through the cache dtype; cl [B]
    the per-slot write rows (the history is rows < cl)."""
    B, _, H, D = q.shape
    k_hist, v_hist = _dequantize_kv(ck, q.dtype), _dequantize_kv(cv, q.dtype)
    G, T = k_hist.shape[2], k_hist.shape[1]
    qg = q.reshape(B, 1, G, H // G, D).float()
    s_hist = torch.einsum("bsgrd,btgd->bgrst", qg, k_hist.float()) * scale
    s_new = torch.einsum("bsgrd,bsgd->bgrs", qg, k_new.float())[..., None] * scale
    kpos = torch.arange(T, device=q.device)
    mask = kpos < cl[:, None]
    if window is not None:
        mask = mask & (kpos > cl[:, None] - window)
    s_hist = s_hist.masked_fill(~mask[:, None, None, None, :], -1e30)
    s_all = torch.cat([s_hist, s_new], dim=-1)
    if not softmax_fp32:
        s_all = s_all.to(q.dtype)
    probs = torch.softmax(s_all, dim=-1)
    p_hist, p_new = probs[..., :T].to(v_hist.dtype), probs[..., T:].to(v_new.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", p_hist, v_hist)
    out = out + p_new[..., 0].permute(0, 3, 1, 2)[..., None] * v_new[:, :, :, None, :]
    return out.reshape(B, 1, H, v_hist.shape[-1])


class Attention(nn.Module):
    """q/k/v projections, RoPE, causal GQA attention, output projection
    (gpt.py:473). Without a cache it takes the flash kernels or the einsum
    path, and ring attention over `ring` where the model hands in
    `pos_ranges`, the held ranks' tile ranges of the positions, as it does
    exactly where it takes the ring (`GPTModel.uses_ring`). With a cache
    (`kv_cache`, this layer's pair of cache views, written in place) it
    takes one of two routes, as JAX does (gpt.py:527-577): one token a slot
    at a [B] `decode_index` with no `kv_valid` attends over the cache before
    the write (`_decode_attention`), then writes; anything else writes
    first (`_update_kv_cache`) and attends over the whole cache by the
    einsum path, queries offset by `decode_index`."""

    def __init__(self, cfg: GPTConfig, ring=None):
        super().__init__()
        self.cfg = cfg
        self.ring = ring  # the context-parallel ring (cp_size > 1), else None
        H, G, D, hidden = cfg.num_attention_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_size
        pdt = DTYPES[cfg.params_dtype]
        self.q_proj = dense_layer(cfg.quantization, (hidden,), (H, D), pdt)
        self.k_proj = dense_layer(cfg.quantization, (hidden,), (G, D), pdt)
        self.v_proj = dense_layer(cfg.quantization, (hidden,), (G, D), pdt)
        self.o_proj = dense_layer(cfg.quantization, (H, D), (hidden,), pdt)
        self.window = cfg.window_size
        self.scale = float(cfg.attention_multiplier or 1.0 / np.sqrt(D))
        self.inv_freq_np = rope_frequencies(cfg)
        self._inv_freq: Optional[torch.Tensor] = None

    def inv_freq(self, device: torch.device) -> torch.Tensor:
        if self._inv_freq is None or self._inv_freq.device != device:
            self._inv_freq = torch.from_numpy(self.inv_freq_np).to(device)
        return self._inv_freq

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                seg_ranges: Optional[torch.Tensor] = None,
                pos_ranges: Optional[torch.Tensor] = None, kv_cache=None,
                decode_index=None, kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, G, D = cfg.num_attention_heads, cfg.n_kv_heads, cfg.head_dim
        inv = self.inv_freq(x.device)
        q = apply_rope(self.q_proj(x).view(B, S, H, D), positions, inv)
        k = apply_rope(self.k_proj(x).view(B, S, G, D), positions, inv)
        v = self.v_proj(x).view(B, S, G, D)
        if kv_cache is not None:
            ck, cv = kv_cache
            if (S == 1 and isinstance(decode_index, torch.Tensor) and decode_index.dim() == 1
                    and kv_valid is None):
                # the decode gate: the current token round-trips through the cache dtype
                sk, sv = _to_cache(k, ck), _to_cache(v, cv)
                k_cur, v_cur = (_dequantize_kv(st, t.dtype) if isinstance(st, dict)
                                else st.to(t.dtype) for st, t in ((sk, k), (sv, v)))
                out = _decode_attention(q, ck, cv, k_cur, v_cur, cl=decode_index,
                                        scale=self.scale, window=self.window,
                                        softmax_fp32=cfg.attention_softmax_in_fp32)
                _store(ck, sk, decode_index)
                _store(cv, sv, decode_index)
            else:
                kc, vc = _update_kv_cache(ck, cv, k, v, decode_index)
                out = causal_attention(q, kc, vc, scale=self.scale, window=self.window,
                                       softmax_fp32=cfg.attention_softmax_in_fp32,
                                       kv_offset=decode_index, kv_valid=kv_valid)
        elif pos_ranges is not None:  # the ring (GPTModel.uses_ring)
            # the held ranks' shards [R, B, heads, Tl, D], as shard_map's split over "cp"
            R = self.ring.held
            Tl = S // R
            qr, kr, vr = (t.view(B, R, Tl, t.shape[2], D).permute(1, 0, 3, 2, 4)
                          for t in (q, k, v))
            pos = positions[0] if positions.dim() == 2 else positions  # gpt.py:607
            out = ring_flash_attention(qr, kr, vr, pos.view(R, Tl), self.ring, scale=self.scale,
                                       causal=True, window=self.window, qranges=pos_ranges)
            out = out.permute(1, 0, 3, 2, 4).reshape(B, S, H, D)
        elif cfg.attention_backend == "flash" and S % 128 == 0:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            if segment_ids is None:
                out = flash_attention(qt, kt, vt, self.scale, True, self.window)
            else:
                out = flash_attention_packed(qt, kt, vt, segment_ids, self.scale, True,
                                             self.window, seg_ranges)
            out = out.transpose(1, 2)
        else:
            out = causal_attention(q, k, v, scale=self.scale, window=self.window,
                                   softmax_fp32=cfg.attention_softmax_in_fp32,
                                   segment_ids=segment_ids)
        # a bf16 cache gives a bf16 value product; o_proj takes the compute dtype, as flax casts
        return self.o_proj(out.reshape(B, S, H * D).to(x.dtype))


# --------------------------------------------------------------------------
# MLP, layer, model
# --------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU: fc1 → (gate, up) halves → silu(gate)·up → fc2 (gpt.py:822)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        pdt = DTYPES[cfg.params_dtype]
        hidden, ffn = cfg.hidden_size, cfg.ffn_hidden_size
        self.fc1 = dense_layer(cfg.quantization, (hidden,), (2 * ffn,), pdt)
        self.fc2 = dense_layer(cfg.quantization, (ffn,), (hidden,), pdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(F.silu(gate) * up)


class TransformerLayer(nn.Module):
    """Pre-norm attention and MLP with residuals (gpt.py:1065)."""

    def __init__(self, cfg: GPTConfig, ring=None):
        super().__init__()
        pdt = DTYPES[cfg.params_dtype]
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.layernorm_epsilon, pdt)
        self.attention = Attention(cfg, ring)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.layernorm_epsilon, pdt)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                seg_ranges: Optional[torch.Tensor] = None,
                pos_ranges: Optional[torch.Tensor] = None, kv_cache=None,
                decode_index=None, kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attention(self.input_norm(x), positions, segment_ids, seg_ranges,
                               pos_ranges, kv_cache, decode_index, kv_valid)
        return x + self.mlp(self.post_attn_norm(x))


class GPTModel(nn.Module):
    """The model (gpt.py:1131). forward(tokens [B, S], positions, segment_ids)
    → logits [B, S, V] fp32, or with output_hidden=True the final-norm hidden
    states [B, S, D] in the compute dtype (the fused-CE training path applies
    the head inside the loss). `positions` [B, S] (default 0 .. S-1) and
    `segment_ids` [B, S] (0 = padding) are a packed batch's. With cp_size > 1
    the model takes `ring` (`ops/ring_attention.py`: a `LocalRing(cp)`, the
    default, where the model sees the whole sequence; a `ProcessGroupRing`
    where it sees this rank's shard) and the positions of a zig-zag-ordered
    sequence (GPTTrainModule reorders).

    Serving passes `kv_caches` (`init_kv_caches`' pair of stacked sides, or
    views of it such as one slot's), `decode_index` (an int, or a [B]
    tensor of per-slot rows) and `kv_valid` [B, T]; the model writes each
    layer's k and v into its view of the caches in place and returns
    (logits, kv_caches). With `quantization="int8_ptq"` every projection is
    a QuantDense (`ops/quant.py`), and so is an untied head."""

    def __init__(self, cfg: GPTConfig, ring=None):
        super().__init__()
        check_supported(cfg)
        if cfg.cp_size > 1 and ring is None:
            ring = LocalRing(cfg.cp_size)
        if (ring.size if ring is not None else 1) != cfg.cp_size:
            raise ValueError(f"a ring of {ring.size} ranks for cp_size {cfg.cp_size}")
        self.cfg = cfg
        self.ring = ring
        pdt = DTYPES[cfg.params_dtype]
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=pdt))
        self.layers = nn.ModuleList(TransformerLayer(cfg, ring) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.layernorm_epsilon, pdt)
        if not cfg.share_embeddings_and_output_weights:
            # int8-resident where the config serves int8; the training modes
            # keep the head full-precision (gpt.py:1319-1327)
            self.lm_head = dense_layer("int8_ptq" if cfg.quantization == "int8_ptq" else None,
                                       (cfg.hidden_size,), (cfg.vocab_size,), pdt)

    def uses_ring(self, S: int, segment_ids) -> bool:
        """Whether attention takes the ring, under JAX's conditions
        (gpt.py:591-599): cp > 1, no segment ids, and shards (S // cp tokens
        of the global sequence) a multiple of 128; no cache, softcapping,
        sink or chunk reaches here (`check_supported`). S is what the model
        sees: the whole sequence with every rank held here, a shard
        otherwise. With cp > 1 any other batch raises where JAX would take
        attention by index over the whole sequence: GPTTrainModule has
        reordered it zig-zag (or cut it into shards), which that would mask
        wrongly."""
        ring = self.ring
        if ring is None:
            return False
        if segment_ids is None and S % ring.held == 0 and (S // ring.held) % 128 == 0:
            return True
        raise NotImplementedError(
            f"context parallelism needs the ring: no segment ids and shards of a multiple of "
            f"128 tokens (got {S} tokens over {ring.held} held ranks, segment_ids "
            f"{segment_ids is not None})")

    def head_weight(self) -> torch.Tensor:
        """The LM head as [V, D] (the tied embedding or lm_head's weight), for
        the training loss's fused cross-entropy."""
        if self.cfg.share_embeddings_and_output_weights:
            return self.embedding
        return self.lm_head.weight

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                output_hidden: bool = False, kv_caches=None, decode_index=None,
                kv_valid: Optional[torch.Tensor] = None):
        cfg = self.cfg
        S = tokens.shape[1]
        if kv_caches is not None and self.ring is not None:
            raise NotImplementedError("a KV cache with context parallelism is not ported")
        if positions is None:
            positions = torch.arange(S, device=tokens.device)
        seg_ranges = pos_ranges = None
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
            if cfg.attention_backend == "flash" and S % 128 == 0 and segment_ids.is_cuda:
                seg_ranges = seg_tile_ranges(segment_ids)  # once for every layer's K8-K10
        if self.uses_ring(S, segment_ids):
            # once for every layer's K11-K13: the tile ranges of each held rank's positions
            pos = (positions[0] if positions.dim() == 2 else positions).to(torch.int32)
            pos_ranges = torch.stack([pos_tile_ranges(p) for p in pos.view(self.ring.held, -1)])
        # the gather runs in the parameter dtype, so the embedding's gradient
        # is an fp32 scatter-add, as in JAX (gpt.py:1177)
        x = F.embedding(tokens, self.embedding).to(DTYPES[cfg.compute_dtype])
        remat = cfg.remat == "full" and torch.is_grad_enabled() and kv_caches is None
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(layer, x, positions, segment_ids, seg_ranges, pos_ranges,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                cache = None if kv_caches is None else cache_map(lambda c: c[i], kv_caches)
                x = layer(x, positions, segment_ids, seg_ranges, pos_ranges, cache,
                          decode_index, kv_valid)
        x = self.final_norm(x)
        if not output_hidden:
            x = (self.lm_head(x) if hasattr(self, "lm_head")
                 else F.linear(x, self.embedding.to(x.dtype))).float()
        return x if kv_caches is None else (x, kv_caches)


def init_parameters(model: nn.Module, generator: torch.Generator, std: float) -> None:
    """JAX's initialisers (gpt.py:_init): normal(std) for every kernel and the
    embedding, ones for the RMSNorm scales; an int8_ptq model's `qkernel`
    zeros and `scale` ones (quant.py:176-179). The values cannot match
    jax.random's; tests carry weights across instead."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.is_floating_point():
                p.zero_()
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)


def build_model(cfg: GPTConfig, device: torch.device, seed: int, ring=None) -> GPTModel:
    """A GPTModel on `device` (allocated there, never on the host first) with
    parameters drawn from `seed` by a generator on that device; `ring` as
    GPTModel takes it."""
    with torch.device("meta"):
        model = GPTModel(cfg, ring)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_parameters(model, gen, cfg.init_method_std)
    return model
