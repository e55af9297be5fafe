"""Carry the JAX model's variables into the port's modules.

`load_jax_variables(model, variables)` takes `{"params": …, "batch_stats": …}`
as nested dicts of numpy arrays (what `jax.device_get(m.variables)` gives) or
of tensors (copied on their device, never through the host) and fills the
port's parameters, whose names mirror the JAX tree. Only layouts change:

- Dense kernel [in, out] → Linear weight [out, in]; a 1×1 conv kernel
  [1, in, out] (the CTC head's `proj`) and a DenseGeneral kernel with
  split axes (GPT's q_proj [D, heads, head_dim], o_proj [heads, head_dim,
  D]) likewise, flattened to [in, out] first
- Conv2d kernel HWIO → OIHW; Conv1d kernel [k, in/g, out] → [out, in/g, k]
  (dilated or not)
- flax ConvTranspose kernel [k, in, out] → ConvTranspose1d weight [in,
  out, k] flipped along k (HiFi-GAN's upsampling: flax's VALID transposed
  convolution, cropped by (k - r) // 2, correlates with the kernel as it
  is, torch's with it reversed)
- nn.Embed `embedding` → Embedding `weight` (FastPitch's symbols)
- LayerNorm / BatchNorm `scale`, `bias` → `weight`, `bias`; BatchNorm
  `batch_stats` `mean`, `var` → `running_mean`, `running_var`
- any other parameter (`pos_bias_u`, `pos_bias_v`, `linear_pos.kernel`,
  GPT's and the RNNT prediction net's `embedding`, RMSNorm `scale`) as is
- the RNNT prediction net's LSTM (flax's OptimizedLSTMCell) as eight
  Linear layers named as its Dense leaves: `lstm{i}/{ii,if,ig,io}/kernel`
  (no bias) and `lstm{i}/{hi,hf,hg,ho}/{kernel,bias}`; the joint's three
  Dense layers as Linear layers
- an int8_ptq GPT model's QuantDense leaves (`ops/quant.py`): `qkernel`
  (int8, contract + features in JAX, [in, out] in the port) and `scale`
  ((1,) * len(contract) + features in JAX, [out] in the port), reshaped
  only, the int8 kept int8
- a training-mode GPT model's `ops/quant.py:TrainingQuantDense` leaves
  (fp8, fp8_e4m3, int8): a Dense's `kernel`, in the same layout
- a GPT model's layers (a ModuleList, `layers.{i}`) come from the scanned
  tree (`layers/...`, each leaf with a leading layer axis) or the unrolled
  one (`layer{i}/...`); export writes the form of the model's config
  (`scan_layers`)

It is strict: a key the port needs and the tree lacks, or a key of the tree
that the port does not take, raises.

`jax_leaf_groups(model)` gives an optimizer that keeps statistics on the
JAX tree's leaves (`core/optim.py:ClippedAdafactor`) each leaf's path and
shape and the parameters it is made of, for both layer layouts.

`export_jax_variables(model, values)` is the inverse: the port's variables
(or any tensors keyed by their state names, such as gradients) as the JAX
tree of fp32 numpy arrays, strict in the same way. `model_variables(model)`
lists those variables by state name.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.ops.quant import QuantDense

Path_ = Tuple[str, ...]


def _flatten(tree: Mapping[str, Any], prefix: Path_ = ()) -> Dict[Path_, Any]:
    """Leaves by path: tensors as they are, anything else as a numpy array."""
    out: Dict[Path_, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _gpt_layers(model: nn.Module) -> Optional[str]:
    """The JAX tree's layout of a GPT model's layers: "stacked" where the
    JAX model stacks them with nn.scan (gpt.py:172; no per-layer MLP
    choice), else "unrolled"; None for any other model."""
    cfg = getattr(model, "cfg", None)
    if not isinstance(cfg, GPTConfig):
        return None
    return "stacked" if cfg.scan_layers and cfg.moe_first_k_dense == 0 else "unrolled"


def _conv_layout(kernel, mod: nn.Module):
    """A JAX kernel (numpy array or tensor) in the port's layout."""
    axes = None
    if isinstance(mod, nn.Linear):
        if math.prod(kernel.shape) != mod.in_features * mod.out_features:
            return kernel  # the shape check below names it
        return kernel.reshape(mod.in_features, mod.out_features).T
    if isinstance(mod, nn.ConvTranspose1d):
        if isinstance(kernel, torch.Tensor):
            return kernel.flip(0).permute(1, 2, 0)
        return kernel[::-1].transpose(1, 2, 0)
    if isinstance(mod, nn.Conv2d):
        axes = (3, 2, 0, 1)
    elif isinstance(mod, nn.Conv1d):
        axes = (2, 1, 0)
    if axes is None:
        return kernel
    return kernel.permute(axes) if isinstance(kernel, torch.Tensor) else kernel.transpose(axes)


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
            elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)) \
                    and pname == "weight":
                jname = "kernel"
            elif isinstance(mod, nn.Embedding):
                jname = "embedding"
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
    if _gpt_layers(model):
        trees["params"] = _per_layer(trees["params"], len(model.layers))
    missing = []
    for _, target, mod, collection, path in _entries(model):
        if path not in trees[collection]:
            missing.append("/".join(path))
            continue
        value = trees[collection].pop(path)
        if path[-1] == "kernel":
            value = _conv_layout(value, mod)
        elif isinstance(mod, QuantDense) and math.prod(value.shape) == target.numel():
            value = value.reshape(tuple(target.shape))
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_variables: {'/'.join(path)} has shape "
                             f"{value.shape}, the port expects {tuple(target.shape)}")
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                target.copy_(value)
            else:
                target.copy_(torch.from_numpy(np.array(value)))  # a writable copy
    if missing:
        raise KeyError(f"load_jax_variables: missing from the JAX tree: {missing}")
    left = [f"{c}/" + "/".join(k) for c, tree in trees.items() for k in tree]
    if left:
        raise ValueError(f"load_jax_variables: keys the port does not take: {left}")
    return model


def _per_layer(tree: Dict[Path_, np.ndarray], n_layers: int) -> Dict[Path_, np.ndarray]:
    """A JAX GPT tree's layers as the port's `layers/{i}/...` paths: from the
    scanned form (`layers/...`, leading layer axis) or the unrolled one
    (`layer{i}/...`)."""
    out: Dict[Path_, np.ndarray] = {}
    for path, value in tree.items():
        if path[0] == "layers":
            if value.shape[:1] != (n_layers,):
                raise ValueError(f"load_jax_variables: {'/'.join(path)} has shape {value.shape}, "
                                 f"the port expects a leading layer axis of {n_layers}")
            for i in range(n_layers):
                out[("layers", str(i)) + path[1:]] = value[i]
        elif re.fullmatch(r"layer\d+", path[0]):
            out[("layers", path[0][len("layer"):]) + path[1:]] = value
        else:
            out[path] = value
    return out


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Nested dicts of one structure → one nested dict of stacked leaves."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else (torch.stack if isinstance(v, torch.Tensor) else np.stack)([t[k] for t in trees])
            for k, v in trees[0].items()}


def _jax_layout(value, mod: nn.Module):
    """The inverse of `_conv_layout` (numpy array or tensor)."""
    axes = None
    if isinstance(mod, nn.Linear):
        if getattr(mod, "jax_conv1x1", False):
            return value.T[None]
        return value.T.reshape(getattr(mod, "jax_kernel_shape", value.T.shape))
    if isinstance(mod, nn.ConvTranspose1d):
        if isinstance(value, torch.Tensor):
            return value.permute(2, 0, 1).flip(0)
        return value.transpose(2, 0, 1)[::-1]
    if isinstance(mod, nn.Conv2d):
        axes = (2, 3, 1, 0)
    elif isinstance(mod, nn.Conv1d):
        axes = (2, 1, 0)
    if axes is None:
        return value
    return value.permute(axes) if isinstance(value, torch.Tensor) else value.transpose(axes)


def export_jax_variables(model: nn.Module, values: Optional[Mapping[str, torch.Tensor]] = None,
                         as_tensors: bool = False) -> Dict[str, Any]:
    """The inverse of `load_jax_variables`: {"params": …, "batch_stats": …} as
    nested dicts of fp32 numpy arrays in the JAX layout, or with `as_tensors`
    of fp32 tensors on the values' device (no copy through the host). `values`
    maps the state names of `model_variables` (e.g.
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
        dtype = torch.float32 if value.is_floating_point() else value.dtype  # int8 stays int8
        arr = value.detach().to(dtype) if as_tensors else value.detach().to(
            "cpu", dtype).numpy()
        if path[-1] == "kernel":
            arr = _jax_layout(arr, mod)
        elif isinstance(mod, QuantDense):
            arr = arr.reshape(mod.jax_shapes[path[-1]])
        node = tree[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr.contiguous() if as_tensors else np.ascontiguousarray(arr)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    layout = _gpt_layers(model)
    if layout:
        layers = tree["params"].pop("layers")
        per_layer = [layers[str(i)] for i in range(len(layers))]
        if layout == "stacked":
            tree["params"]["layers"] = _stack(per_layer)
        else:
            tree["params"].update({f"layer{i}": t for i, t in enumerate(per_layer)})
    return tree


def jax_leaf_specs(model: nn.Module) -> Dict[Path_, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every leaf of a GPT model's JAX "params" tree, by path,
    in the layout `export_jax_variables` writes (the model may sit on the
    meta device): what `jax.eval_shape` of the JAX model's init gives."""
    specs = {}
    for key, target, mod, collection, path in _entries(model):
        if collection != "params":
            continue
        shape = tuple(target.shape)
        if path[-1] == "kernel":
            shape = tuple(getattr(mod, "jax_kernel_shape", shape[::-1]))
        elif isinstance(mod, QuantDense):
            shape = tuple(mod.jax_shapes[path[-1]])
        specs[path] = (shape, target.dtype)
    layout = _gpt_layers(model)
    if not layout:
        return specs
    out = {}
    n = len(model.layers)
    for path, (shape, dtype) in specs.items():
        if path[0] != "layers":
            out[path] = (shape, dtype)
        elif layout == "stacked":
            if path[1] == "0":
                out[("layers",) + path[2:]] = ((n,) + shape, dtype)
        else:
            out[(f"layer{path[1]}",) + path[2:]] = (shape, dtype)
    return out


class LeafGroup(NamedTuple):
    """One leaf of the JAX "params" tree as the port's parameters make it up.
    `index`: the positions in `list(model.parameters())` of its parts, layer
    by layer; `part_shape`: each part's shape in the JAX layout (a Linear
    weight [out, in] as `weight.t().reshape(part_shape)`, where `transposed`;
    any other as `reshape(part_shape)`); `stacked`: the parts are stacked on a
    new leading axis (the layers under nn.scan), so `shape` is (len(index),)
    + part_shape, else `shape` is part_shape and there is one part."""
    path: Path_
    shape: Tuple[int, ...]
    part_shape: Tuple[int, ...]
    index: Tuple[int, ...]
    transposed: bool
    stacked: bool


def jax_leaf_groups(model: nn.Module) -> List[LeafGroup]:
    """Every leaf of the model's JAX "params" tree (the paths and shapes of
    `jax_leaf_specs`, in the layer layout of the model's config) with the
    trainable parameters it is made of. Raises for an int8_ptq model's
    QuantDense and for convolution kernels, which no optimizer here trains."""
    position = {id(p): i for i, p in enumerate(model.parameters())}
    parts: Dict[Path_, Tuple[Tuple[int, ...], int, bool]] = {}
    for key, target, mod, collection, path in _entries(model):
        if collection != "params":
            continue
        if isinstance(mod, (QuantDense, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            raise NotImplementedError(f"jax_leaf_groups: {key} ({type(mod).__name__})")
        transposed = isinstance(mod, nn.Linear) and path[-1] == "kernel"
        shape = (tuple(getattr(mod, "jax_kernel_shape", target.shape[::-1])) if transposed
                 else tuple(target.shape))
        parts[path] = (shape, position[id(target)], transposed)
    layout = _gpt_layers(model)
    groups: Dict[Path_, List[Tuple[Tuple[int, ...], int, bool]]] = {}
    for path, part in parts.items():
        if layout and path[0] == "layers":
            path = (("layers",) + path[2:] if layout == "stacked"
                    else (f"layer{path[1]}",) + path[2:])
        groups.setdefault(path, []).append(part)
    out = []
    for path, members in groups.items():
        stacked = path[0] == "layers" and layout == "stacked"
        part_shape, _, transposed = members[0]
        shape = (len(members),) + part_shape if stacked else part_shape
        out.append(LeafGroup(path, shape, part_shape, tuple(i for _, i, _ in members), transposed,
                             stacked))
    return out
