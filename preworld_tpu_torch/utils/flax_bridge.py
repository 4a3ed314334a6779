"""Flax parameter trees -> the port's PyTorch parameters.

The port's module and parameter names mirror the flax tree, so a flax leaf
`(module, ..., leaf)` is the PyTorch name `module. ... .<leaf>` with:

  kernel (Dense, (in, out))         -> weight (out, in)
  kernel (Conv, (*k, in, out))      -> weight (out, in, *k), spatial order kept
  scale  (LayerNorm / BatchNorm)    -> weight
  bias                              -> bias
  relative_position_bias_table      -> relative_position_bias_table
  batch_stats mean / var            -> running_mean / running_var

This is the inverse direction of `preworld_tpu/utils/torch_port.py`; a
reference mmcv checkpoint reaches the port as `convert_full_model` (which
gives flax trees of numpy arrays) followed by `load_flax_params`. The port
keeps its parameters and BatchNorm statistics in f32, so a loaded tree
keeps every bit. `torch_state` is the reverse view, {torch name: array},
the same keys `flax_to_torch_state` gives, so a stepped port compares with
stepped flax trees (params, batch_stats, EMA) key by key.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"scale": "weight", "bias": "bias", "kernel": "weight",
         "mean": "running_mean", "var": "running_var"}


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def torch_name(path: Tuple[str, ...]) -> str:
    return ".".join(path[:-1] + (_LEAF.get(path[-1], path[-1]),))


def torch_value(path: Tuple[str, ...], value) -> np.ndarray:
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if path[-1] == "kernel":
        if arr.ndim == 2:
            return arr.T.copy()
        nd = arr.ndim
        return np.transpose(arr, (nd - 1, nd - 2) + tuple(range(nd - 2))).copy()
    return arr


def flax_to_torch_state(params: Mapping, batch_stats: Mapping = None
                        ) -> Dict[str, np.ndarray]:
    """Flat {torch name: array} from flax params (+ batch_stats)."""
    out: Dict[str, np.ndarray] = {}
    trees = [params] + ([batch_stats] if batch_stats else [])
    for tree in trees:
        for path, v in _walk(tree):
            name = torch_name(path)
            if name in out:
                raise ValueError(f"two flax leaves map to {name}")
            out[name] = torch_value(path, v)
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping,
                     batch_stats: Mapping = None):
    """Copy flax params (+ batch_stats) into `model`.

    Raises on a leaf with no counterpart or of the wrong shape, and on a
    model tensor that no leaf covers (BatchNorm's num_batches_tracked
    counters excepted). Returns the names loaded.
    """
    state = model.state_dict()
    flat = flax_to_torch_state(params, batch_stats)
    unknown = sorted(set(flat) - set(state))
    if unknown:
        raise KeyError(f"flax leaves with no port tensor: {unknown[:10]}")
    bad = [(k, v.shape, tuple(state[k].shape)) for k, v in flat.items()
           if tuple(v.shape) != tuple(state[k].shape)]
    if bad:
        raise ValueError(f"shape mismatches: {bad[:10]}")
    missing = sorted(k for k in state if k not in flat
                     and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"port tensors with no flax leaf: {missing[:10]}")
    with torch.no_grad():
        for k, v in flat.items():
            state[k].copy_(torch.from_numpy(v))
    return sorted(flat)


def torch_state(model: torch.nn.Module, params: Mapping = None
                ) -> Dict[str, np.ndarray]:
    """Flat {torch name: f32 array} of the model's parameters (or of
    `params`, a {name: tensor} dict such as an EMA) and BatchNorm running
    statistics; no step counters."""
    tensors = dict(model.named_parameters()) if params is None else dict(params)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            tensors[name] = buf
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in tensors.items()}
