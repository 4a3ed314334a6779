"""Shared building blocks, channel-last at every public boundary.

Counterpart of `preworld_tpu/models/layers.py`. Submodule and parameter
names mirror the flax tree (`Conv_0`, `BatchNorm_0`, `Dense_0`, ...), so a
flax leaf path maps to a PyTorch parameter name by joining with dots (see
`utils/flax_bridge.py`). Convolutions run on a channels-first view of the
channel-last tensor (a permuted view, no copy); 3-D convolutions keep the
caller's spatial axis order.

Parameters stay float32 (flax's `param_dtype`); `Linear`, `Conv2d`,
`Conv3d`, `LayerNorm` and the BatchNorms cast them to the input's dtype at
use, as flax's `dtype` does, so a module fed bf16 computes in bf16 while
the optimizer updates f32 master weights. `BatchNorm*d` in train mode
normalises with the batch statistics and folds the BIASED batch variance
into `running_var` (flax `nn.BatchNorm`, momentum 0.9 = torch momentum
0.1); torch's own folds the unbiased one. Inside a recompute of
`torch.utils.checkpoint` (`recompute_context`) the running statistics are
not folded again.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntOrTuple = Union[int, Tuple[int, ...]]

_RECOMPUTING = [False]


@contextlib.contextmanager
def recompute_context():
    """Marks a checkpoint recompute: BatchNorm does not fold its batch
    statistics into the running ones a second time."""
    prev = _RECOMPUTING[0]
    _RECOMPUTING[0] = True
    try:
        yield
    finally:
        _RECOMPUTING[0] = prev


def _at(t: Optional[torch.Tensor], x: torch.Tensor):
    return None if t is None else t.to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, _at(self.weight, x), _at(self.bias, x))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, _at(self.weight, x), _at(self.bias, x))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(x, _at(self.weight, x), _at(self.bias, x))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _at(self.weight, x),
                            _at(self.bias, x), self.eps)


class _FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm with flax's train-mode running update (see module doc)."""

    def forward(self, x):
        self._check_input_dim(x)
        w, b = _at(self.weight, x), _at(self.bias, x)
        if not self.training:
            return F.batch_norm(x, _at(self.running_mean, x),
                                _at(self.running_var, x), w, b, False, 0.0,
                                self.eps)
        if not _RECOMPUTING[0]:
            with torch.no_grad():
                dims = [d for d in range(x.dim()) if d != 1]
                var, mean = torch.var_mean(x.float(), dim=dims,
                                           correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, w, b, True, 0.0, self.eps)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


def _tuple(v: IntOrTuple, n: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def to_cf(x: torch.Tensor) -> torch.Tensor:
    """Channel-last -> channels-first view."""
    return x.movedim(-1, 1)


def to_cl(x: torch.Tensor) -> torch.Tensor:
    """Channels-first -> channel-last view."""
    return x.movedim(1, -1)


class ConvNormAct(nn.Module):
    """Conv (+BN) (+act) on channel-last input; rank from `ndim`.

    Padding is the JAX package's "SAME", spelled out torch-symmetric:
    dilation * (k - 1) // 2 per side.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: IntOrTuple, strides: IntOrTuple = 1,
                 dilation: IntOrTuple = 1, use_bias: bool = False,
                 norm: Optional[str] = "bn",
                 act: Optional[Callable] = F.relu, ndim: int = 2):
        super().__init__()
        ks = _tuple(kernel_size, ndim)
        ndim = len(ks)
        st = _tuple(strides, ndim)
        dl = _tuple(dilation, ndim)
        pad = tuple(dl[i] * (ks[i] - 1) // 2 for i in range(ndim))
        conv = {2: Conv2d, 3: Conv3d}[ndim]
        self.Conv_0 = conv(in_channels, features, ks, st, pad, dl,
                           bias=use_bias)
        if norm == "bn":
            bn = {2: BatchNorm2d, 3: BatchNorm3d}[ndim]
            self.BatchNorm_0 = bn(features, eps=1e-5)
        elif norm is not None:
            raise ValueError(f"unsupported norm {norm!r}")
        self.norm = norm
        self.act = act

    def forward(self, x):
        y = self.Conv_0(to_cf(x))
        if self.norm == "bn":
            y = self.BatchNorm_0(y)
        if self.act is not None:
            y = self.act(y)
        return to_cl(y)


class BasicBlock(nn.Module):
    """Two convs + residual (2-D or 3-D by `ndim`), optional projection."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 downsample: bool = False, downsample_kernel: int = 3,
                 downsample_norm: bool = True, ndim: int = 2):
        super().__init__()
        if downsample:
            self.downsample = ConvNormAct(
                in_channels, features, downsample_kernel, strides=strides,
                norm="bn" if downsample_norm else None, act=None,
                use_bias=not downsample_norm, ndim=ndim)
        else:
            self.downsample = None
        self.conv1 = ConvNormAct(in_channels, features, 3, strides=strides,
                                 ndim=ndim)
        self.conv2 = ConvNormAct(features, features, 3, act=None, ndim=ndim)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class Mlp(nn.Module):
    """fc -> relu -> fc."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = Linear(in_features, hidden)
        self.Dense_1 = Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class SELayer(nn.Module):
    """Channel gating of (B, H, W, C) by an external (B, C) embedding."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = Linear(channels, channels)
        self.Dense_1 = Linear(channels, channels)

    def forward(self, x, x_se):
        g = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(x_se))))
        return x * g[:, None, None, :]


class MlpSequence(nn.Module):
    """Linear -> Softplus -> Linear (-> Softplus)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 final_softplus: bool = False):
        super().__init__()
        self.Dense_0 = Linear(in_features, hidden)
        self.Dense_1 = Linear(hidden, out)
        self.final_softplus = final_softplus

    def forward(self, x):
        x = self.Dense_1(F.softplus(self.Dense_0(x)))
        return F.softplus(x) if self.final_softplus else x


def upsample(x: torch.Tensor, scale: Union[int, Sequence[int]],
             align_corners: bool = True) -> torch.Tensor:
    """Channel-last bilinear (4-D) / trilinear (5-D) upsample by integer
    factors, torch `nn.Upsample(align_corners=...)` semantics."""
    nsp = x.dim() - 2
    scale = _tuple(scale, nsp)
    size = [int(x.shape[1 + i] * f) for i, f in enumerate(scale)]
    mode = {2: "bilinear", 3: "trilinear"}[nsp]
    y = F.interpolate(to_cf(x), size=size, mode=mode,
                      align_corners=align_corners)
    return to_cl(y)
