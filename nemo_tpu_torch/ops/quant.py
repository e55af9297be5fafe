"""int8 post-training quantization for serving (counterpart of the serving
half of nemo_tpu/ops/quant.py).

- `QuantDense` in mode "int8_ptq" (quant.py:130-199): the weight is held as
  an int8 `qkernel` [in, out] and a per-output-channel fp32 `scale` [out]
  (W8A16). A call dequantises on read, in JAX's steps and dtypes:
  `x @ qkernel.to(x.dtype)` (a result in the compute dtype) times
  `scale.to(that dtype)` (quant.py:180-185). The product is a plain
  `torch.matmul`, as JAX computes it outside any Pallas kernel.
  `jax_shapes` gives the JAX tree's shapes of both leaves (`qkernel`
  contract + features, `scale` (1,) * len(contract) + features), for
  `interop/jax_params.py`.
- `dense_layer` (201): a Dense or a QuantDense, by `cfg.quantization`.
- `quantize_params_int8` / `dequantize_params` (216, 300): weight-only int8
  of a JAX-layout tree, per last-axis channel, and back.
- `ptq_convert_params` (236) and `ptq_params_for_serving` (280): a trained
  JAX-layout tree onto the `quantization="int8_ptq"` model's tree, every
  `qkernel` the per-channel int8 of its sibling `kernel` (amax over exactly
  the axes its `scale` holds as 1), every other leaf copied.

Trees are nested dicts of tensors (numpy arrays are taken as CPU tensors);
the results are tensors on the inputs' device. The training fake-quant
modes (fp8, int8, quant_matmul) are not ported: `models/llm/gpt.py:
check_supported` refuses them.
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
    """A Dense from `contract` to `features` (the JAX kernel's axes), or a
    QuantDense where the config serves int8 (quant.py:201)."""
    if quantization == "int8_ptq":
        return QuantDense(contract, features)
    if quantization:
        raise NotImplementedError(f"quantization={quantization!r} is not ported")
    return Dense(math.prod(contract), math.prod(features), tuple(contract) + tuple(features),
                 dtype)


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
