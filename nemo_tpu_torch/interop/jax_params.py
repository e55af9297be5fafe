"""Carry the JAX model's variables into the port's modules.

`load_jax_variables(model, variables)` takes `{"params": …, "batch_stats": …}`
as nested dicts of numpy arrays (what `jax.device_get(m.variables)` gives) and
fills the port's parameters, whose names mirror the JAX tree. Only layouts
change:

- Dense kernel [in, out] → Linear weight [out, in]; a 1×1 conv kernel
  [1, in, out] (the CTC head's `proj`) → Linear weight [out, in]
- Conv2d kernel HWIO → OIHW; Conv1d kernel [k, in/g, out] → [out, in/g, k]
- LayerNorm / BatchNorm `scale`, `bias` → `weight`, `bias`; BatchNorm
  `batch_stats` `mean`, `var` → `running_mean`, `running_var`
- any other parameter (`pos_bias_u`, `pos_bias_v`, `linear_pos.kernel`) as is

It is strict: a key the port needs and the tree lacks, or a key of the tree
that the port does not take, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

Path_ = Tuple[str, ...]


def _flatten(tree: Mapping[str, Any], prefix: Path_ = ()) -> Dict[Path_, np.ndarray]:
    out: Dict[Path_, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _conv_layout(kernel: np.ndarray, mod: nn.Module) -> np.ndarray:
    if isinstance(mod, nn.Linear):
        return (kernel[0] if kernel.ndim == 3 else kernel).T
    if isinstance(mod, nn.Conv2d):
        return kernel.transpose(3, 2, 0, 1)
    if isinstance(mod, nn.Conv1d):
        return kernel.transpose(2, 1, 0)
    return kernel


_NORM_NAMES = {"weight": "scale", "bias": "bias"}


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill `model` in place from the JAX variables; returns `model`."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"load_jax_variables: unknown collections {sorted(unknown)}")
    params = _flatten(variables.get("params", {}))
    stats = _flatten(variables.get("batch_stats", {}))
    missing = []

    def take(tree: Dict[Path_, np.ndarray], path: Path_):
        if path not in tree:
            missing.append("/".join(path))
            return None
        return tree.pop(path)

    def assign(target: torch.Tensor, value: np.ndarray, path: Path_) -> None:
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_variables: {'/'.join(path)} has shape "
                             f"{value.shape}, the port expects {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(value)))  # a writable copy

    for name, mod in model.named_modules():
        prefix = tuple(name.split(".")) if name else ()
        norm = isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d))
        for pname, p in mod.named_parameters(recurse=False):
            if norm:
                jname = _NORM_NAMES[pname]
            elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)) and pname == "weight":
                jname = "kernel"
            else:
                jname = pname
            path = prefix + (jname,)
            value = take(params, path)
            if value is not None:
                if jname == "kernel":
                    value = _conv_layout(value, mod)
                assign(p, value, path)
        if isinstance(mod, nn.BatchNorm1d):
            for buf, jname in (("running_mean", "mean"), ("running_var", "var")):
                value = take(stats, prefix + (jname,))
                if value is not None:
                    assign(getattr(mod, buf), value, prefix + (jname,))
    if missing:
        raise KeyError(f"load_jax_variables: missing from the JAX tree: {missing}")
    left = ["params/" + "/".join(k) for k in params] + ["batch_stats/" + "/".join(k) for k in stats]
    if left:
        raise ValueError(f"load_jax_variables: keys the port does not take: {left}")
    return model
