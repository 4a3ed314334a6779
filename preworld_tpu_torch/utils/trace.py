"""The program's own spans and counters, off unless a caller turns them on.

    from preworld_tpu_torch.utils import trace
    trace.enable(True)
    with torch.profiler.profile(...) as prof:
        model.predict(batch)        # opens pw.predict, pw.image_backbone ...
    trace.enable(False)
    trace.counters                  # {"upload_bytes": ...}

`span(name)`, or the decorator `spanned(name)`, opens
`torch.profiler.record_function("pw." + name)` while tracing is on, so
the range lands in the profiler's host timeline beside the kernels it
launches (tied to them by their correlation ids); off, it returns one
shared no-op context. A range carries no id: a request is the
interval of its root span (`predict`, `predict_sequential`,
`train_step`), its parts the spans nested in it on its thread.
`render.backward` runs on the autograd engine's thread on the card.

`count(name, n)` adds n to `counters[name]` while tracing is on. Tracing
is turned on by the caller that profiles: `train.loop.train_epochs` for
the iterations of `profile_dir`, and the benchmark's span tool
(`benchmark/spans.py`). Nothing reads the environment.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

PREFIX = "pw."

counters: Dict[str, int] = {}
_on = False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str):
    """A context manager: the profiler range `pw.<name>` while tracing is
    on, else the shared no-op `OFF`."""
    if not _on:
        return OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: the function's call inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add n to `counters[name]` while tracing is on."""
    if _on:
        counters[name] = counters.get(name, 0) + n


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


def reset() -> None:
    """Clear the counters."""
    counters.clear()
