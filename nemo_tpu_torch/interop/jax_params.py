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

`export_jax_variables(model, values)` is the inverse: the port's variables
(or any tensors keyed by their state names, such as gradients) as the JAX
tree of fp32 numpy arrays, strict in the same way. `model_variables(model)`
lists those variables by state name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

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


def _entries(model: nn.Module) -> Iterator[Tuple[str, torch.Tensor, nn.Module, str, Path_]]:
    """(state name, tensor, owning module, JAX collection, JAX path) of every
    variable of the JAX tree: the parameters and the BatchNorm running stats."""
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
            yield ".".join(prefix + (pname,)), p, mod, "params", prefix + (jname,)
        if isinstance(mod, nn.BatchNorm1d):
            for buf, jname in (("running_mean", "mean"), ("running_var", "var")):
                yield (".".join(prefix + (buf,)), getattr(mod, buf), mod, "batch_stats",
                       prefix + (jname,))


def model_variables(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's tensors of the JAX variables, by state name: every
    parameter and BatchNorm running stat (what the JAX package differentiates
    in calibration)."""
    return {key: t for key, t, *_ in _entries(model)}


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill `model` in place from the JAX variables; returns `model`."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"load_jax_variables: unknown collections {sorted(unknown)}")
    trees = {c: _flatten(variables.get(c, {})) for c in ("params", "batch_stats")}
    missing = []
    for _, target, mod, collection, path in _entries(model):
        if path not in trees[collection]:
            missing.append("/".join(path))
            continue
        value = trees[collection].pop(path)
        if path[-1] == "kernel":
            value = _conv_layout(value, mod)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_variables: {'/'.join(path)} has shape "
                             f"{value.shape}, the port expects {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(value)))  # a writable copy
    if missing:
        raise KeyError(f"load_jax_variables: missing from the JAX tree: {missing}")
    left = [f"{c}/" + "/".join(k) for c, tree in trees.items() for k in tree]
    if left:
        raise ValueError(f"load_jax_variables: keys the port does not take: {left}")
    return model


def _jax_layout(value: np.ndarray, mod: nn.Module) -> np.ndarray:
    """The inverse of `_conv_layout`."""
    if isinstance(mod, nn.Linear):
        return value.T[None] if getattr(mod, "jax_conv1x1", False) else value.T
    if isinstance(mod, nn.Conv2d):
        return value.transpose(2, 3, 1, 0)
    if isinstance(mod, nn.Conv1d):
        return value.transpose(2, 1, 0)
    return value


def export_jax_variables(model: nn.Module, values: Optional[Mapping[str, torch.Tensor]] = None
                         ) -> Dict[str, Any]:
    """The inverse of `load_jax_variables`: {"params": …, "batch_stats": …} as
    nested dicts of fp32 numpy arrays in the JAX layout. `values` maps the
    state names of `model_variables` (e.g.
    `encoder.layer0.conv.norm.running_mean`) to tensors of their shapes, such
    as gradients; by default the model's own. Strict: a name of `values`
    that is no such variable, or a variable missing from `values`, raises."""
    entries = {key: rest for key, *rest in _entries(model)}
    values = model_variables(model) if values is None else values
    missing = sorted(set(entries) - set(values))
    if missing:
        raise KeyError(f"export_jax_variables: missing from the values: {missing}")
    unknown = sorted(set(values) - set(entries))
    if unknown:
        raise ValueError(f"export_jax_variables: not variables of the model: {unknown}")
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in values.items():
        target, mod, collection, path = entries[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"export_jax_variables: {key} has shape {tuple(value.shape)}, "
                             f"the model's is {tuple(target.shape)}")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            arr = _jax_layout(arr, mod)
        node = tree[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree
