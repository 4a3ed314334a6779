"""The port's forward FLOP count, the same integer on the CPU and the card.

`torch.utils.flop_counter.FlopCounterMode` counts the dense products and
convolutions that reach aten (`mm`, `bmm`, `addmm`, `convolution`,
attention), 2 FLOPs a multiply-add, and nothing else: no elementwise
operation, normalisation, softmax, gather or scatter. The hand-written
kernels launch through ctypes (`ops/_cuda.py`), which the counter cannot
see, so each forward kernel wrapper adds to `_cuda.flops`, at every
launch, what the counter counts for its plain twin at the launch's shapes
(the `*_flops` functions of `ops/`): the qkv, QK^T, PV and proj products
of K1, fc1 and fc2 of K2, QK^T and PV of K5 / K6, and 0 for K3, K4 and K7,
whose plain twins are gathers, elementwise sums and index adds. On the CPU
the wrappers run their plain twins, which the counter sees, and
`_cuda.flops` stays 0; on the card the kernels' share comes from
`_cuda.flops`. The sum is the same on both devices when the model takes
the same routes, which it chooses by shape.

This is not XLA's count (`tools/get_flops.py` in the JAX package): XLA
counts every elementwise operation too, and it counts the TPU-only
reformulations, such as `ops/conv3d.py::conv3d_zfold`, which computes a
3-D convolution as a z-banded 2-D one with exact-zero taps.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..ops import _cuda


def _key(t: torch.Tensor):
    return t.device, t.untyped_storage().data_ptr()


class _ParameterReads(TorchDispatchMode):
    """Records which of `params` ({storage key: name}) an operation read."""

    def __init__(self, params: Dict[tuple, str]):
        super().__init__()
        self.params, self.read = params, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and _key(t) in self.params:
                self.read.add(self.params[_key(t)])
        return func(*args, **kwargs)


def count_flops(fn: Callable[[], object], model: torch.nn.Module) -> Dict:
    """Run `fn()` once under `torch.no_grad()` with the launch and FLOP
    counters reset, and count its FLOPs and the parameters of `model` it
    reads. Returns:

      flops         aten_flops + kernel_flops, the forward count;
      aten_flops    FlopCounterMode's total, by op in `aten_by_op`;
      kernel_flops  the sum of `_cuda.flops` (0 on the CPU);
      kernels       {wrapper: {"launches", "flops"}} of each launched
                    kernel;
      params        the elements of the parameters `fn` read: those that a
                    flax `init` of the same call creates (it creates a
                    module's parameters only when the call reaches it);
      params_built  the elements of every parameter of `model`;
      unread        the names of the parameters `fn` did not read.
    """
    names = {_key(p): n for n, p in model.named_parameters()}
    _cuda.reset_launches()
    counter = FlopCounterMode(display=False)
    reads = _ParameterReads(names)
    with torch.no_grad(), counter, reads:
        fn()
    aten = int(counter.get_total_flops())
    by_op = counter.get_flop_counts().get("Global", {})
    kernels = {k: {"launches": n, "flops": _cuda.flops[k]}
               for k, n in _cuda.launches.items() if n}
    kernel_flops = sum(v["flops"] for v in kernels.values())
    params = dict(model.named_parameters())
    return {
        "flops": aten + kernel_flops, "aten_flops": aten,
        "aten_by_op": {str(op): int(v) for op, v in by_op.items()},
        "kernel_flops": kernel_flops, "kernels": kernels,
        "params": sum(params[n].numel() for n in reads.read),
        "params_built": sum(p.numel() for p in params.values()),
        "unread": sorted(set(params) - reads.read),
    }


def count_forward(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                  **predict_kw) -> Dict:
    """`count_flops` of one `model.predict(batch, **predict_kw)`: the
    forward FLOPs of an inference request and the parameters it reads."""
    return count_flops(lambda: model.predict(batch, **predict_kw), model)
