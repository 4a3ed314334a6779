"""Shared building blocks, channel-last at every public boundary.

Counterpart of `preworld_tpu/models/layers.py`. Submodule and parameter
names mirror the flax tree (`Conv_0`, `BatchNorm_0`, `Dense_0`, ...), so a
flax leaf path maps to a PyTorch parameter name by joining with dots (see
`utils/flax_bridge.py`). Convolutions run on a channels-first view of the
channel-last tensor (a permuted view, no copy); 3-D convolutions keep the
caller's spatial axis order. BatchNorm runs in eval mode (running stats).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntOrTuple = Union[int, Tuple[int, ...]]


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
        conv = {2: nn.Conv2d, 3: nn.Conv3d}[ndim]
        self.Conv_0 = conv(in_channels, features, ks, st, pad, dl,
                           bias=use_bias)
        if norm == "bn":
            bn = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[ndim]
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
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class SELayer(nn.Module):
    """Channel gating of (B, H, W, C) by an external (B, C) embedding."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels)
        self.Dense_1 = nn.Linear(channels, channels)

    def forward(self, x, x_se):
        g = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(x_se))))
        return x * g[:, None, None, :]


class MlpSequence(nn.Module):
    """Linear -> Softplus -> Linear (-> Softplus)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 final_softplus: bool = False):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, out)
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
