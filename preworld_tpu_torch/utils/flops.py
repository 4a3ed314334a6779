"""The port's FLOP, byte and transcendental counts, the same integers on the
CPU and the card.

FLOPs. `torch.utils.flop_counter.FlopCounterMode` counts the dense
products and convolutions that reach aten (`mm`, `bmm`, `addmm`,
`convolution`, attention), 2 FLOPs a multiply-add, and nothing else: no
elementwise operation, normalisation, softmax, gather or scatter. The
hand-written kernels launch through ctypes (`ops/_cuda.py`), which the
counter cannot see, so each kernel wrapper adds to `_cuda.flops`, at every
launch, what the counter counts for its plain twin at the launch's shapes
(the `*_flops` and `*_bwd_flops` functions of `ops/`): the qkv, QK^T, PV
and proj products of K1, fc1 and fc2 of K2, QK^T and PV of K5 / K6, each
backward's rerun forward and its two products per forward product, and 0
for K3, K4 and K7, whose plain twins are gathers, elementwise sums and
index adds. On the CPU the wrappers run their plain twins, which the
counter sees, and `_cuda.flops` stays 0; on the card the kernels' share
comes from `_cuda.flops`. The sum is the same on both devices when the
model takes the same routes, which it chooses by shape.

Bytes accessed: XLA's definition, adapted to eager torch (`_BytesAccessed`).
Each dispatched aten op counts the bytes of each tensor it reads plus each
tensor it writes, a tensor counting min(elements x element size, its
storage's bytes), so an expanded view counts its storage and a slice its
own elements. Views and metadata ops (outputs that alias an input without
writing it) and allocations (`empty*`) count 0; an in-place op counts its
read and its write (a fill or a copy does not read what it overwrites); a
copy between the host and the card counts 0 (not device memory traffic);
a normalisation counts its output and not the statistics it returns for
a backward (the CPU and cuDNN return different ones). A hand-written
kernel counts as one custom call, as XLA counts a `pallas_call`: its
operands as passed plus its result (the wrapper's `*_bytes`), and no op
inside the wrapper counts, on either device: not the casts, allocations
and K4's sort around a launch on the card, not the plain twin on the CPU.
So the CPU and the card give the same integer where the model takes the
same routes. That is XLA's definition, not the card's traffic: K2's
(M, 4C) hidden, for one, goes through device memory on the card and is not
in the count, and the eager ops are not fused, so each writes and rereads
what XLA's fusions keep on chip.

Transcendentals: one per output element of exp, exp2, expm1, log, log1p,
log2, sigmoid, tanh, erf, sqrt, rsqrt, pow with a non-integer exponent,
`_softmax` / `_log_softmax` and `gelu`; a kernel wrapper adds its
`*_transcendentals`, the count of its plain twin.

`count_flops` counts a forward (FLOPs, bytes, transcendentals);
`count_step` the FLOPs of a loss and its backward. Bytes and
transcendentals stay forward-only, as in the JAX tools.

This is not XLA's count (`tools/get_flops.py` in the JAX package): XLA
counts every elementwise operation as FLOPs too, fuses, and counts the
TPU-only reformulations, such as `ops/conv3d.py::conv3d_zfold`, which
computes a 3-D convolution as a z-banded 2-D one with exact-zero taps.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..ops import _cuda

# ops that only allocate
_ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                          "new_empty_strided", "empty_permuted"})
# ops whose output aliases an input that their schema does not mark
_METADATA = frozenset({"_unsafe_view", "resize_", "set_", "resize_as_"})
# in-place ops that overwrite `self` without reading it
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_",
                         "bernoulli_", "random_", "exponential_"})
# normalisations: the output counts, the saved statistics do not
_NORMS = frozenset({"native_batch_norm", "cudnn_batch_norm",
                    "miopen_batch_norm", "_native_batch_norm_legit",
                    "_native_batch_norm_legit_no_training",
                    "_batch_norm_with_update", "_batch_norm_no_update",
                    "native_layer_norm", "native_group_norm"})
_TRANSCENDENTAL = frozenset({"exp", "exp2", "expm1", "log", "log1p", "log2",
                             "sigmoid", "tanh", "erf", "sqrt", "rsqrt",
                             "_softmax", "_log_softmax", "gelu", "pow"})


def _name(func) -> str:
    return func.overloadpacket.__name__


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one dispatched aten op reads plus writes (module doc)."""
    name = _name(func)
    schema = func._schema
    if name in _ALLOCATIONS or name in _METADATA or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in schema.returns):
        return 0
    reads = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
    writes = _tensors(out)
    if name in ("_to_copy", "copy_") and reads and writes:
        src = reads[-1] if name == "copy_" else reads[0]
        if src.device != writes[0].device:
            return 0
    if name in _WRITE_ONLY:
        reads = reads[1:]
    if name in _NORMS:
        writes = writes[:1]
    return sum(map(_cuda.tensor_bytes, reads)) + \
        sum(map(_cuda.tensor_bytes, writes))


def op_transcendentals(func, args, out) -> int:
    """One per output element of the transcendental functions (module
    doc)."""
    name = _name(func).rstrip("_")
    if name not in _TRANSCENDENTAL:
        return 0
    if name == "pow" and len(args) > 1 and not isinstance(
            args[1], torch.Tensor) and float(args[1]).is_integer():
        return 0
    first = _tensors(out)
    return first[0].numel() if first else 0


class _BytesAccessed(TorchDispatchMode):
    """Counts each aten op's bytes (by op) and transcendentals outside the
    kernel wrappers' scopes (`_cuda.counted`)."""

    def __init__(self):
        super().__init__()
        self.by_op = collections.Counter()
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _cuda.in_kernel():
            n = op_bytes(func, args, kwargs, out)
            if n:
                self.by_op[str(func)] += n
            self.transcendentals += op_transcendentals(func, args, out)
        return out


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


def _flop_keys(counter: FlopCounterMode) -> Dict:
    """FLOP keys of a finished count: aten's, by op, and the kernels'."""
    aten = int(counter.get_total_flops())
    by_op = counter.get_flop_counts().get("Global", {})
    kernels = {k: {"launches": n, "flops": _cuda.flops[k],
                   "bytes": _cuda.bytes[k],
                   "transcendentals": _cuda.transcendentals[k]}
               for k, n in _cuda.launches.items() if n}
    kernel_flops = sum(v["flops"] for v in kernels.values())
    return {"flops": aten + kernel_flops, "aten_flops": aten,
            "aten_by_op": {str(op): int(v) for op, v in by_op.items()},
            "kernel_flops": kernel_flops, "kernels": kernels}


def count_flops(fn: Callable[[], object], model: torch.nn.Module) -> Dict:
    """Run `fn()` once under `torch.no_grad()` with the kernel counts reset,
    and count its FLOPs, bytes and transcendentals and the parameters of
    `model` it reads. Returns:

      flops            aten_flops + kernel_flops, the forward count;
      aten_flops       FlopCounterMode's total, by op in `aten_by_op`;
      kernel_flops     the sum of `_cuda.flops` (0 on the CPU);
      bytes            aten_bytes + kernel_bytes, the bytes accessed;
      aten_bytes       the aten ops' bytes outside the kernel wrappers, by
                       op in `bytes_by_op`;
      kernel_bytes     the kernel calls' bytes, by wrapper in
                       `bytes_by_kernel` (on both devices);
      transcendentals  the aten ops' and the kernel calls' transcendentals;
      kernels          {wrapper: {"launches", "flops", "bytes",
                       "transcendentals"}} of each launched kernel (none on
                       the CPU);
      params           the elements of the parameters `fn` read: those that a
                       flax `init` of the same call creates (it creates a
                       module's parameters only when the call reaches it);
      params_built     the elements of every parameter of `model`;
      unread           the names of the parameters `fn` did not read.
    """
    names = {_key(p): n for n, p in model.named_parameters()}
    _cuda.reset_launches()
    counter = FlopCounterMode(display=False)
    reads = _ParameterReads(names)
    accessed = _BytesAccessed()
    _cuda.set_counting(True)
    try:
        with torch.no_grad(), counter, reads, accessed:
            fn()
    finally:
        _cuda.set_counting(False)
    res = _flop_keys(counter)
    aten_bytes = sum(accessed.by_op.values())
    kernel_bytes = sum(_cuda.bytes.values())
    params = dict(model.named_parameters())
    res.update(
        bytes=aten_bytes + kernel_bytes, aten_bytes=aten_bytes,
        kernel_bytes=kernel_bytes,
        bytes_by_op=dict(accessed.by_op.most_common()),
        bytes_by_kernel={k: v for k, v in _cuda.bytes.items() if v},
        transcendentals=accessed.transcendentals
        + sum(_cuda.transcendentals.values()),
        params=sum(params[n].numel() for n in reads.read),
        params_built=sum(p.numel() for p in params.values()),
        unread=sorted(set(params) - reads.read))
    return res


def count_forward(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                  **predict_kw) -> Dict:
    """`count_flops` of one `model.predict(batch, **predict_kw)`: the
    forward FLOPs, bytes and transcendentals of an inference request and
    the parameters it reads."""
    return count_flops(lambda: model.predict(batch, **predict_kw), model)


def loss_backward(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                  generator: torch.Generator, **loss_kw) -> Callable[[], None]:
    """A `count_step` fn: `model.loss` in train mode and the backward of the
    sum of its dict, as `train.make_train_step` takes them (no optimizer)."""
    def run():
        model.train()
        losses = model.loss(batch, generator, **loss_kw)
        sum(losses[k] for k in sorted(losses)).backward()
    return run


def count_step(fn: Callable[[], object], model: torch.nn.Module) -> Dict:
    """Run `fn()`, one loss and its backward, once with gradients on and the
    kernel counts reset (the model's gradients cleared first), and count
    its FLOPs: the aten ops' forward and backward and every kernel's
    (forward and backward wrappers, `_cuda.flops`). Bytes and
    transcendentals are not counted (forward-only, as in the JAX tools).
    Returns `count_flops`' FLOP keys and `params_with_grad`, the elements of
    the parameters of `model` the backward reached."""
    model.zero_grad(set_to_none=True)
    _cuda.reset_launches()
    counter = FlopCounterMode(display=False)
    with torch.enable_grad(), counter:
        fn()
    res = _flop_keys(counter)
    res["params_with_grad"] = sum(p.numel() for p in model.parameters()
                                  if p.grad is not None)
    return res
