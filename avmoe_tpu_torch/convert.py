"""Load the JAX package's variables into the port.

`load_jax_variables(model, variables)` takes `{"params": ..., "batch_stats":
...}` as nested dicts of numpy arrays (the flax tree of the matching JAX
module) and fills the port's parameters and persistent buffers. The port's
modules are named after the flax tree, so module path "a.b.c" reads the
flax subtree a/b/c, and only the leaf layout differs:

  * nn.Linear        weight (out, in)  <- kernel (in, out) transposed
  * nn.Conv2d        weight OIHW       <- kernel HWIO
  * LayerNorm        weight <- scale; BatchNorm also running_mean/var <- mean/var
  * LSTMCell         weight_ih / weight_hh / bias <- ii..io / hi..ho kernels
                     transposed and hi..ho biases, gates in the order i, f, g, o
                     (flax's nn.RNN keeps its cell's scope: QstEncoder's LSTM
                     is question_encoder/lstm, as the port names it)
  * nn.Embedding     weight <- embedding (vocab, features)
  * anything else    same name, same layout (GroupedDense (g, i, o) kernels,
                     MHA (C, H, D) / (H, D, C) kernels, raw flax params)

Every port tensor must be set and every flax leaf used, except the subtrees
a module lists in its `flax_off_path` (HTS-AT's norm, tscam_conv, head,
which the AVE forward never reads); anything else raises.

`export_jax_variables(model)` is the way back: the port's parameters and
running statistics as a flax tree of numpy arrays (optionally only the
trainable parameters), for comparing the two packages' states after
training.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Set, Tuple

import numpy as np
import torch
from torch import nn

from avmoe_tpu_torch.heads.common import LSTMCell
from avmoe_tpu_torch.ops.norm import BatchNorm, LayerNorm
from avmoe_tpu_torch.train.freeze import FROZEN_SCOPES, is_trainable_path

Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


class _Source:
    """The flax leaves, keyed (collection, *path), with a record of use."""

    def __init__(self, variables: Mapping):
        self.leaves: Dict[Path, np.ndarray] = {}
        for col in ("params", "batch_stats"):
            for path, v in _flatten(variables.get(col, {})).items():
                self.leaves[(col,) + path] = v
        extra = set(variables) - {"params", "batch_stats"}
        if extra:
            raise ValueError(f"unexpected variable collections {sorted(extra)}")
        self.used: Set[Path] = set()

    def take(self, col: str, path: Path) -> np.ndarray:
        key = (col,) + path
        if key not in self.leaves:
            raise KeyError(f"flax leaf {'/'.join(key)} not found")
        self.used.add(key)
        return self.leaves[key]


def _value(mod: nn.Module, name: str, prefix: Path, src: _Source) -> np.ndarray:
    p = lambda *leaf: src.take("params", prefix + leaf)
    if isinstance(mod, nn.Linear):
        return p("kernel").T if name == "weight" else p("bias")
    if isinstance(mod, nn.Conv2d):
        return p("kernel").transpose(3, 2, 0, 1) if name == "weight" else p("bias")
    if isinstance(mod, nn.Embedding):
        return p("embedding")
    if isinstance(mod, (LayerNorm, BatchNorm)):
        if name == "running_mean":
            return src.take("batch_stats", prefix + ("mean",))
        if name == "running_var":
            return src.take("batch_stats", prefix + ("var",))
        return p("scale") if name == "weight" else p("bias")
    if isinstance(mod, LSTMCell):
        if name == "weight_ih":
            return np.concatenate([p(f"i{g}", "kernel").T for g in "ifgo"], axis=0)
        if name == "weight_hh":
            return np.concatenate([p(f"h{g}", "kernel").T for g in "ifgo"], axis=0)
        return np.concatenate([p(f"h{g}", "bias") for g in "ifgo"], axis=0)
    return p(name)


def _port_tensors(mod: nn.Module) -> Iterable[Tuple[str, torch.Tensor]]:
    yield from mod.named_parameters(recurse=False)
    for name, buf in mod.named_buffers(recurse=False):
        if name not in mod._non_persistent_buffers_set:
            yield name, buf


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill `model` from the flax variables of the matching JAX module."""
    src = _Source(variables)
    off_path = set()
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for sub in getattr(mod, "flax_off_path", ()):
            off_path.add(prefix + (sub,))
        for name, tensor in _port_tensors(mod):
            value = _value(mod, name, prefix, src)
            full = ".".join(prefix + (name,))
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{full}: flax value {value.shape} vs port {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(tensor.dtype))

    def off(key: Path) -> bool:
        return any(key[1:1 + len(o)] == o for o in off_path)

    unused = sorted("/".join(k) for k in set(src.leaves) - src.used if not off(k))
    if unused:
        raise ValueError(f"{len(unused)} flax leaves unused by the port: {unused[:10]}")


def _leaves(mod: nn.Module, name: str, value: np.ndarray) -> Iterable[Tuple[str, Path, np.ndarray]]:
    """(collection, leaf path under the module, array) of one port tensor:
    the inverse of `_value`."""
    if isinstance(mod, nn.Linear):
        yield "params", ("kernel",) if name == "weight" else ("bias",), (
            value.T if name == "weight" else value)
    elif isinstance(mod, nn.Conv2d):
        yield "params", ("kernel",) if name == "weight" else ("bias",), (
            value.transpose(2, 3, 1, 0) if name == "weight" else value)
    elif isinstance(mod, nn.Embedding):
        yield "params", ("embedding",), value
    elif isinstance(mod, (LayerNorm, BatchNorm)) and name in ("running_mean", "running_var"):
        yield "batch_stats", ("mean",) if name == "running_mean" else ("var",), value
    elif isinstance(mod, (LayerNorm, BatchNorm)):
        yield "params", ("scale",) if name == "weight" else ("bias",), value
    elif isinstance(mod, LSTMCell):
        for gate, part in zip("ifgo", np.split(value, 4, axis=0)):
            if name == "weight_ih":
                yield "params", (f"i{gate}", "kernel"), part.T
            elif name == "weight_hh":
                yield "params", (f"h{gate}", "kernel"), part.T
            else:
                yield "params", (f"h{gate}", "bias"), part
    else:
        yield "params", (name,), value


@torch.no_grad()
def export_jax_variables(model: nn.Module, trainable_only: bool = False,
                         frozen_scopes: Tuple[str, ...] = FROZEN_SCOPES) -> Dict[str, Dict]:
    """{"params": ..., "batch_stats": ...} of the port as nested dicts of
    float32 numpy arrays in the flax layout; with trainable_only, the params
    are those `train/freeze.py` trains with `frozen_scopes` (the batch stats
    are all kept)."""

    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for name, tensor in _port_tensors(mod):
            value = tensor.detach().float().cpu().numpy()
            for col, leaf, arr in _leaves(mod, name, value):
                path = prefix + leaf
                if (col == "params" and trainable_only
                        and not is_trainable_path(path, frozen_scopes)):
                    continue
                node = out[col]
                for part in path[:-1]:
                    node = node.setdefault(part, {})
                node[path[-1]] = np.ascontiguousarray(arr)
    return out
