"""Python-file config system with `_base_` inheritance and CLI overrides.

A copy of `preworld_tpu/utils/config.py` (which imports no jax, but is
reached through `preworld_tpu/__init__`), so the port reads the same
config files without importing the JAX package.

Surface parity with the reference's mmcv Config usage
(`tools/train.py:88-97,126-146` + `mmdet3d/utils/patch.py:111-123`):
  * configs are python files assigning plain values/dicts;
  * `_base_ = ['./x.py', ...]` deep-merges parents (derived wins);
  * `${a.b.c}` strings interpolate other config values;
  * `--cfg-options a.b.c=val` dotted overrides with literal-eval parsing.

No registry dispatch: model construction from a config happens in
`preworld_tpu_torch.train.builder` with explicit code.
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, Dict, Optional, Sequence


class Config:
    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = data or {}

    # -- access ---------------------------------------------------------
    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            v = self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return v

    def __getitem__(self, key):
        return self._data[key]

    def __contains__(self, key):
        return key in self._data

    def get(self, key, default=None):
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def __repr__(self):
        return f"Config({self._data!r})"

    # -- loading --------------------------------------------------------
    @classmethod
    def fromfile(cls, path: str) -> "Config":
        data = _load_py(os.path.abspath(path))
        data = _interpolate(data, data)
        return cls(data)

    def merge_from_options(self, options: Sequence[str]) -> "Config":
        """Apply 'a.b.c=value' overrides (value parsed by literal_eval)."""
        for opt in options:
            key, _, raw = opt.partition("=")
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                val = raw
            node = self._data
            parts = key.strip().split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
        return self


def _load_py(path: str) -> Dict[str, Any]:
    ns: Dict[str, Any] = {"__file__": path}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), ns)
    data = {
        k: v
        for k, v in ns.items()
        if not k.startswith("_") and not callable(v) and not _is_module(v)
    }
    bases = ns.get("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        bpath = os.path.join(os.path.dirname(path), b)
        merged = _deep_merge(merged, _load_py(bpath))
    return _deep_merge(merged, data)


def _is_module(v) -> bool:
    import types

    return isinstance(v, types.ModuleType)


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_INTERP = re.compile(r"^\$\{([\w.]+)\}$")


def _lookup(data: Dict, dotted: str):
    node: Any = data
    for p in dotted.split("."):
        node = node[p]
    return node


def _interpolate(obj, root):
    if isinstance(obj, dict):
        return {k: _interpolate(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_interpolate(v, root) for v in obj]
    if isinstance(obj, str):
        m = _INTERP.match(obj)
        if m:
            return _lookup(root, m.group(1))
    return obj
