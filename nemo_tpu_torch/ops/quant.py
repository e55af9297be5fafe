"""Quantised GEMMs (counterpart of nemo_tpu/ops/quant.py): the training
modes fp8, fp8_e4m3 and int8, and int8 post-training quantization for
serving.

**Training modes** (quant.py:48-126, 129-210), current scaling, no amax
history and no host sync:
- `quantize(x, dtype)` (quant.py:48): amax of `x.float()` over the whole
  tensor, scale = max(amax, 1e-12) / dtype_max, then clip(x / scale), a
  round for int8, and the cast; returns (q, scale) with x ≈ q · scale.
- `quant_matmul(x, w, mode, out_dtype)` (quant.py:72): [.., K] @ [K, N]
  with quantised operands, a `torch.autograd.Function` (`QuantMatmul`)
  whose residuals are the quantised operands and their scales. The forward
  is e4m3 × e4m3 (fp8 modes) or int8 × int8 → int32, times sx · sw, cast
  to `out_dtype` (`_qdot`, 62). The fp8 backward quantises the incoming
  gradient to e5m2 ("fp8", the hybrid recipe) or e4m3 ("fp8_e4m3"): dgrad
  qg @ qwᵀ · (sg · sw) in x's dtype, wgrad qxᵀ @ qg · (sx · sg) in w's
  (95-126). The int8 backward is a bf16 straight-through step against the
  dequantised operands (100-112), products in fp32 cast to those dtypes.
- `TrainingQuantDense` (quant.py:129): a `Dense` (the JAX tree's `kernel`,
  fp32, `jax_kernel_shape`) whose product is `quant_matmul`. The weight is
  quantised from the fp32 parameter, as JAX passes the `param_dtype`
  kernel (191-194); activations from the compute dtype. A contraction over
  several JAX axes (o_proj's (H, dh)) is flattened as JAX flattens it.

The products, like JAX's `lax.dot_general` outside any Pallas kernel, are
PyTorch's quantised GEMMs on the card: `fp8_mm` is `torch._scaled_mm`
(tensor-wise scales folded into its epilogue, fast accumulation off; the
second operand column-major, every dimension a multiple of 16; it is given
e4m3 × e4m3 in the forward and e5m2 × e4m3 in dgrad and in wgrad, which is
computed as dwᵀ = qgᵀ @ qx: never e5m2 × e5m2, which it refuses), `int8_mm` is
`torch._int_mm`, and `f32_mm` (the int8 backward's bf16 products) is
`torch.mm(..., out_dtype=torch.float32)`; `fp8_mm` counts its launches in
`.launches`. A CPU tensor takes the plain version (`fp8_mm_plain`:
`qx.float() @ qw.float()` times the scales; `int8_mm_plain`: the int8
product, exact in float64, as int32); a CUDA tensor launches the library
call or raises, never the plain version.

**Serving.** `QuantDense` in mode "int8_ptq" (quant.py:130-199): the weight
is held as an int8 `qkernel` [in, out] and a per-output-channel fp32
`scale` [out] (W8A16). A call dequantises on read, in JAX's steps and
dtypes: `x @ qkernel.to(x.dtype)` (a result in the compute dtype) times
`scale.to(that dtype)` (quant.py:180-185). The product is a plain
`torch.matmul`, as JAX computes it outside any Pallas kernel. `jax_shapes`
gives the JAX tree's shapes of both leaves (`qkernel` contract + features,
`scale` (1,) * len(contract) + features), for `interop/jax_params.py`.
- `dense_layer` (201): a Dense, a TrainingQuantDense or a QuantDense, by
  `cfg.quantization`.
- `quantize_params_int8` / `dequantize_params` (216, 300): weight-only int8
  of a JAX-layout tree, per last-axis channel, and back.
- `ptq_convert_params` (236) and `ptq_params_for_serving` (280): a trained
  JAX-layout tree onto the `quantization="int8_ptq"` model's tree, every
  `qkernel` the per-channel int8 of its sibling `kernel` (amax over exactly
  the axes its `scale` holds as 1), every other leaf copied.

Trees are nested dicts of tensors (numpy arrays are taken as CPU tensors);
the results are tensors on the inputs' device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Path_ = Tuple[str, ...]


class Dense(nn.Linear):
    """A bias-free Linear whose weight (held in `params_dtype`) is cast to the
    input's dtype at each use, as flax's DenseGeneral casts its kernel;
    `jax_kernel_shape` is the kernel's shape in the JAX tree (e.g. q_proj's
    [D, heads, head_dim]), for `interop/jax_params.py`."""

    def __init__(self, in_features: int, out_features: int, jax_kernel_shape=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=False, dtype=dtype)
        self.jax_kernel_shape = tuple(jax_kernel_shape or (in_features, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype))


# --------------------------------------------------------------------------
# Training modes: quantize, the products, quant_matmul, TrainingQuantDense
# --------------------------------------------------------------------------

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
TRAINING_MODES = ("fp8", "fp8_e4m3", "int8")


def _dtype_max(dtype: torch.dtype) -> float:
    return 127.0 if dtype == torch.int8 else float(torch.finfo(dtype).max)


def quantize(x: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale), x ≈ q.float() · scale: symmetric per-tensor quantization
    with current scaling (quant.py:48), in JAX's steps: x / scale in fp32
    (a division, as JAX divides), clipped to ±dtype_max, rounded half to even
    for int8, cast. `scale` is an fp32 0-d tensor on x's device."""
    maxval = _dtype_max(dtype)
    # the max of |x| is exact in x's own dtype: one pass, no fp32 copy
    amax = torch.linalg.vector_norm(x, ord=math.inf).float()
    # a divisor on the device: CUDA divides by a host scalar as a product with
    # its reciprocal, one ulp off the division that JAX (and the CPU) make
    scale = torch.clamp_min(amax, 1e-12) / torch.full((), maxval, device=x.device)
    y = x.float() / scale
    y.clamp_(-maxval, maxval)
    if dtype == torch.int8:
        y.round_()
    return y.to(dtype), scale


def _col_major(t: torch.Tensor) -> torch.Tensor:
    """A 2-d tensor with the same values laid out column-major."""
    return t if t.stride() == (1, t.shape[0]) else t.t().contiguous().t()


def fp8_mm_plain(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """`fp8_mm`'s plain version, JAX's `_qdot`: the fp8 values' product in
    fp32, times (sa · sb) in fp32, cast to `out_dtype`."""
    return ((a.float() @ b.float()) * (sa * sb)).to(out_dtype)


def fp8_mm(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """a [M, K] @ b [K, N] of fp8 tensors times the tensor-wise scales sa · sb,
    in `out_dtype`: `torch._scaled_mm` on the card (scales in its epilogue,
    fast accumulation off), the plain version on the CPU."""
    if a.device.type == "cpu":
        return fp8_mm_plain(a, b, sa, sb, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"fp8_mm: tensors on {a.device}")
    out = torch._scaled_mm(a.contiguous(), _col_major(b), sa.reshape(()), sb.reshape(()),
                           out_dtype=out_dtype, use_fast_accum=False)
    fp8_mm.launches += 1
    return out


fp8_mm.launches = 0


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`int8_mm`'s plain version: the int8 product, exact in float64 (|sums|
    stay below 2^53 for any K this takes), as int32."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] of int8 tensors → int32: `torch._int_mm` on the
    card, the plain version on the CPU."""
    if a.device.type == "cpu":
        return int8_mm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_mm: tensors on {a.device}")
    return torch._int_mm(a.contiguous(), b)


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 tensors with an fp32 result (JAX's
    preferred_element_type=float32): `torch.mm(out_dtype=torch.float32)` on
    the card; on the CPU the same product of the values made fp32 (bf16
    products are exact in fp32)."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    if a.device.type != "cuda":
        raise ValueError(f"f32_mm: tensors on {a.device}")
    return torch.mm(a, b, out_dtype=torch.float32)


class QuantMatmul(torch.autograd.Function):
    """quant_matmul's custom VJP (quant.py:72-126) over 2-d x [M, K] and
    w [K, N]."""

    @staticmethod
    def forward(ctx, x, w, mode, out_dtype):
        fwd_q = torch.int8 if mode == "int8" else E4M3
        qx, sx = quantize(x, fwd_q)
        qw, sw = quantize(w, fwd_q)
        if mode == "int8":
            y = (int8_mm(qx, qw).float() * (sx * sw)).to(out_dtype)
        else:
            y = fp8_mm(qx, qw, sx, sw, out_dtype)
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.mode, ctx.dtypes = mode, (x.dtype, w.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        if ctx.mode == "int8":
            gb = g.to(torch.bfloat16)
            wdq = (qw.float() * sw).to(torch.bfloat16)
            xdq = (qx.float() * sx).to(torch.bfloat16)
            dx = f32_mm(gb, wdq.t())
            dw = f32_mm(gb.t(), xdq).t()  # dwᵀ, row-major as a Linear weight
            return dx.to(x_dtype), dw.to(w_dtype), None, None
        qg, sg = quantize(g.contiguous(), E4M3 if ctx.mode == "fp8_e4m3" else E5M2)
        dx = fp8_mm(qg, qw.t(), sg, sw, x_dtype)
        # dwᵀ [N, K] = qgᵀ @ qx: e5m2 × e4m3 and a row-major dwᵀ (the torch
        # layout of a Linear weight), where qxᵀ @ qg would be e4m3 × e5m2
        dw = fp8_mm(qg.t(), qx, sg, sx, w_dtype).t()
        return dx, dw, None, None


def quant_matmul(x: torch.Tensor, w: torch.Tensor, mode: str = "fp8",
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[.., K] @ [K, N] with quantised operands (quant.py:72). mode: "fp8"
    (e4m3 forward, e5m2 gradients) | "fp8_e4m3" (e4m3 everywhere) | "int8"
    (int8 forward, bf16 backward). Differentiable in x and w."""
    if mode not in TRAINING_MODES:
        raise ValueError(f"quant_matmul: mode {mode!r} is not one of {TRAINING_MODES}")
    y = QuantMatmul.apply(x.reshape(-1, x.shape[-1]), w, mode, out_dtype)
    return y.view(*x.shape[:-1], w.shape[1])


class TrainingQuantDense(Dense):
    """QuantDense in a training mode (quant.py:129, modes fp8, fp8_e4m3,
    int8): a Dense, with its fp32 `kernel` and `jax_kernel_shape`, whose
    product is `quant_matmul(x, kernel, mode, x.dtype)` on the fp32 weight."""

    def __init__(self, in_features: int, out_features: int, jax_kernel_shape=None,
                 dtype: torch.dtype = torch.float32, mode: str = "fp8"):
        super().__init__(in_features, out_features, jax_kernel_shape, dtype)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_matmul(x, self.weight.t(), self.mode, x.dtype)


class QuantDense(nn.Module):
    """The int8-resident serving Dense (mode "int8_ptq", quant.py:130):
    `qkernel` int8 [in, out], `scale` fp32 [out]. As in JAX a fresh one is
    zeros and ones; its values come from `ptq_params_for_serving`."""

    def __init__(self, contract: Sequence[int], features: Sequence[int]):
        super().__init__()
        contract, features = tuple(contract), tuple(features)
        n_in, n_out = math.prod(contract), math.prod(features)
        self.qkernel = nn.Parameter(torch.zeros(n_in, n_out, dtype=torch.int8),
                                    requires_grad=False)
        self.scale = nn.Parameter(torch.ones(n_out), requires_grad=False)
        self.jax_shapes = {"qkernel": contract + features,
                           "scale": (1,) * len(contract) + features}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.matmul(x, self.qkernel.to(x.dtype))
        return acc * self.scale.to(acc.dtype)


def dense_layer(quantization: Optional[str], contract: Sequence[int],
                features: Sequence[int], dtype: torch.dtype) -> nn.Module:
    """A Dense from `contract` to `features` (the JAX kernel's axes); a
    TrainingQuantDense where the config trains quantised (fp8, fp8_e4m3,
    int8), a QuantDense where it serves int8 (quant.py:201)."""
    if quantization == "int8_ptq":
        return QuantDense(contract, features)
    shape = (math.prod(contract), math.prod(features), tuple(contract) + tuple(features), dtype)
    if quantization in TRAINING_MODES:
        return TrainingQuantDense(*shape, mode=quantization)
    if quantization:
        raise NotImplementedError(f"quantization={quantization!r} is not ported")
    return Dense(*shape)


# --------------------------------------------------------------------------
# PTQ of a JAX-layout parameter tree
# --------------------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _unflatten(flat: Mapping[Path_, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    return tree


def _int8_channels(k: torch.Tensor, reduce: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, fp32 scale) of `k` in fp32, amax over `reduce` kept as size
    1: scale = max(amax, 1e-12) / 127, q = clip(round(k / scale), ±127)."""
    k = k.float()
    amax = k.abs().amax(dim=tuple(reduce), keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8), scale


def quantize_params_int8(params: Mapping[str, Any], min_size: int = 1 << 16) -> Dict[str, Any]:
    """Weight-only int8 (quant.py:216): every floating leaf of at least 2
    axes and `min_size` elements becomes {"q": int8, "scale": fp32}, amax
    over every axis but the last."""
    from nemo_tpu_torch.interop.jax_params import _flatten

    out = {}
    for path, leaf in _flatten(params).items():
        x = _tensor(leaf)
        if x.dim() < 2 or x.numel() < min_size or not x.is_floating_point():
            out[path] = x
            continue
        q, scale = _int8_channels(x, range(x.dim() - 1))
        out[path] = {"q": q, "scale": scale}
    return _unflatten(out)


def dequantize_params(params: Mapping[str, Any], dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, Any]:
    """The inverse of `quantize_params_int8` (quant.py:300): (q · scale) in
    `dtype`."""
    def walk(node):
        if isinstance(node, Mapping):
            if set(node) == {"q", "scale"}:
                return (_tensor(node["q"]).float() * _tensor(node["scale"])).to(dtype)
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node)
    return walk(params)


def ptq_convert_params(src_params: Mapping[str, Any],
                       target: Mapping[Path_, Tuple[Tuple[int, ...], torch.dtype]]
                       ) -> Dict[str, Any]:
    """A trained tree onto an int8_ptq model's tree (quant.py:236).
    `target` maps each path of that tree to its (shape, dtype)
    (`interop/jax_params.py:jax_leaf_specs` of the int8_ptq model): every
    `qkernel` takes the int8 of its sibling `kernel` in `src_params`, its
    `scale` amax/127 over exactly the axes `scale` holds as 1 (so
    scan-stacked layers keep per-layer scales); every other leaf is copied
    in the target's dtype."""
    from nemo_tpu_torch.interop.jax_params import _flatten

    flat_src = _flatten(src_params)
    out: Dict[Path_, Any] = {}
    for path, (shape, dtype) in target.items():
        if path[-1] == "qkernel":
            scale_path = path[:-1] + ("scale",)
            reduce = [i for i, d in enumerate(target[scale_path][0]) if d == 1]
            k = _tensor(flat_src[path[:-1] + ("kernel",)])
            out[path], out[scale_path] = _int8_channels(k, reduce)
        elif path[-1] == "scale" and path[:-1] + ("qkernel",) in target:
            continue  # written beside its qkernel
        else:
            out[path] = _tensor(flat_src[path]).to(dtype)
    return _unflatten(out)


def ptq_params_for_serving(cfg, params: Mapping[str, Any]):
    """(cfg, trained JAX-layout tree) → (cfg with quantization="int8_ptq",
    its int8-resident tree) (quant.py:280), for GenerationEngine and
    ContinuousBatchingEngine."""
    from nemo_tpu_torch.interop.jax_params import jax_leaf_specs
    from nemo_tpu_torch.models.llm.gpt import GPTModel

    cfg_q = dataclasses.replace(cfg, quantization="int8_ptq")
    with torch.device("meta"):
        model = GPTModel(cfg_q)
    return cfg_q, ptq_convert_params(params, jax_leaf_specs(model))
