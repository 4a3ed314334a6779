"""Plain building blocks of the reference: channel-last, float32, no kernels.

Every module keeps the parameter names of the measured program's modules,
so one state dict serves both. `Linear`, `Conv2d` and `Conv3d` can fake a
lower precision (`quant`, set by `model.set_precision`): their input,
weight and output are rounded to float8 e4m3 with one scale per tensor,
the product taken in f32, and in the backward each gradient crossing
them to float8 e5m2. That is the output check's control, never the
reference. With 'bf16' they are rounded to bfloat16 both ways instead:
the configuration's own precision, a witness for what rounding alone
does to a number.
BatchNorm in train mode normalises with the batch statistics and leaves
the running statistics alone: no output here reads them afterwards.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntOrTuple = Union[int, Tuple[int, ...]]

FP8_MAX = 448.0  # largest finite float8 e4m3fn
FP8_GRAD_MAX = 57344.0  # largest finite float8 e5m2


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _RoundBf16(torch.autograd.Function):
    """x and its gradient rounded to bfloat16 (kept in float32)."""

    @staticmethod
    def forward(ctx, x):
        return x.bfloat16().float()

    @staticmethod
    def backward(ctx, g):
        return g.bfloat16().float()


class _Round(torch.autograd.Function):
    """Forward: x rounded to float8 e4m3fn at one scale for the tensor;
    backward: the incoming gradient rounded to float8 e5m2 the same way
    (the usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x.float(), torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g.float(), torch.float8_e5m2, FP8_GRAD_MAX)


def lower(x: torch.Tensor, mode) -> torch.Tensor:
    """x in the precision `mode` (None: as it is; 'fp8'; 'bf16')."""
    if mode is None:
        return x
    return (_RoundBf16 if mode == "bf16" else _Round).apply(x)


class Linear(nn.Linear):
    quant = None

    def forward(self, x):
        q = self.quant
        if q:
            return lower(F.linear(lower(x, q), lower(self.weight, q),
                                  self.bias), q)
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    quant = None

    def forward(self, x):
        q = self.quant
        if q:
            return lower(self._conv_forward(lower(x, q),
                                            lower(self.weight, q),
                                            self.bias), q)
        return self._conv_forward(x, self.weight, self.bias)


class Conv3d(nn.Conv3d):
    quant = None

    def forward(self, x):
        q = self.quant
        if q:
            return lower(self._conv_forward(lower(x, q),
                                            lower(self.weight, q),
                                            self.bias), q)
        return self._conv_forward(x, self.weight, self.bias)


class _BatchNorm(nn.modules.batchnorm._BatchNorm):
    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BatchNorm1d(_BatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_BatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BatchNorm, nn.BatchNorm3d):
    pass


def _tuple(v: IntOrTuple, n: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def to_cf(x):
    return x.movedim(-1, 1)


def to_cl(x):
    return x.movedim(1, -1)


class ConvNormAct(nn.Module):
    """Conv (+BN) (+act) on channel-last input, "SAME" padding."""

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
            self.BatchNorm_0 = {2: BatchNorm2d, 3: BatchNorm3d}[ndim](
                features, eps=1e-5)
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
    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 downsample: bool = False, downsample_kernel: int = 3,
                 downsample_norm: bool = True, ndim: int = 2):
        super().__init__()
        self.downsample = None
        if downsample:
            self.downsample = ConvNormAct(
                in_channels, features, downsample_kernel, strides=strides,
                norm="bn" if downsample_norm else None, act=None,
                use_bias=not downsample_norm, ndim=ndim)
        self.conv1 = ConvNormAct(in_channels, features, 3, strides=strides,
                                 ndim=ndim)
        self.conv2 = ConvNormAct(features, features, 3, act=None, ndim=ndim)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = Linear(in_features, hidden)
        self.Dense_1 = Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class SELayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = Linear(channels, channels)
        self.Dense_1 = Linear(channels, channels)

    def forward(self, x, x_se):
        g = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(x_se))))
        return x * g[:, None, None, :]


class MlpSequence(nn.Module):
    def __init__(self, in_features: int, hidden: int, out: int,
                 final_softplus: bool = False):
        super().__init__()
        self.Dense_0 = Linear(in_features, hidden)
        self.Dense_1 = Linear(hidden, out)
        self.final_softplus = final_softplus

    def forward(self, x):
        x = self.Dense_1(F.softplus(self.Dense_0(x)))
        return F.softplus(x) if self.final_softplus else x


def upsample(x, scale: Union[int, Sequence[int]], align_corners=True):
    """Channel-last bilinear / trilinear upsample by integer factors."""
    nsp = x.dim() - 2
    scale = _tuple(scale, nsp)
    size = [int(x.shape[1 + i] * f) for i, f in enumerate(scale)]
    mode = {2: "bilinear", 3: "trilinear"}[nsp]
    return to_cl(F.interpolate(to_cf(x), size=size, mode=mode,
                               align_corners=align_corners))


class CustomResNet(nn.Module):
    def __init__(self, in_channels: int, num_layer: Sequence[int],
                 num_channels: Sequence[int], stride: Sequence[int],
                 backbone_output_ids: Sequence[int], ndim: int = 3):
        super().__init__()
        self.num_layer = tuple(num_layer)
        self.backbone_output_ids = tuple(backbone_output_ids)
        cin = in_channels
        for i, (n, c, s) in enumerate(zip(num_layer, num_channels, stride)):
            setattr(self, f"layer{i}_block0",
                    BasicBlock(cin, c, strides=s, downsample=True, ndim=ndim))
            for j in range(1, n):
                setattr(self, f"layer{i}_block{j}", BasicBlock(c, c, ndim=ndim))
            cin = c

    def forward(self, x):
        feats = []
        for i, n in enumerate(self.num_layer):
            for j in range(n):
                x = getattr(self, f"layer{i}_block{j}")(x)
            if i in self.backbone_output_ids:
                feats.append(x)
        return tuple(feats)


class FPN_LSS(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv0 = ConvNormAct(in_channels, out_channels, 3)
        self.conv1 = ConvNormAct(out_channels, out_channels, 3)

    def forward(self, feats):
        x2, x1 = feats
        x = torch.cat([x2, upsample(x1, 2)], dim=-1)
        return self.conv1(self.conv0(x))


class LSSFPN3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.fuse = ConvNormAct(in_channels, out_channels, (1, 1, 1))

    def forward(self, feats):
        x8, x16, x32 = feats
        return self.fuse(torch.cat([x8, upsample(x16, 2), upsample(x32, 4)],
                                   dim=-1))


class OccHead(nn.Module):
    def __init__(self, in_channels: int, out_channel: int):
        super().__init__()
        mid = in_channels // 2
        self.occ_conv = ConvNormAct(in_channels, mid, (3, 3, 3))
        self.soft_w0 = ConvNormAct(mid, mid // 2, (1, 1, 1))
        self.soft_w1 = Conv3d(mid // 2, 1, 1, bias=False)
        self.pred0 = ConvNormAct(mid, mid // 2, (1, 1, 1))
        self.pred1 = Conv3d(mid // 2, out_channel, 1, bias=False)

    def forward(self, x):
        x = self.occ_conv(x)
        w = to_cl(self.soft_w1(to_cf(self.soft_w0(x))))
        x = x * torch.softmax(w, dim=-1)
        return to_cl(self.pred1(to_cf(self.pred0(x))))


class TinyBackbone(nn.Module):
    """The small conv backbone of the program's test configurations."""

    def __init__(self, channels: Tuple[int, int] = (32, 64)):
        super().__init__()
        self.stem = ConvNormAct(3, 16, 3, strides=4)
        self.s8 = ConvNormAct(16, channels[0], 3, strides=2)
        self.s16 = ConvNormAct(channels[0], channels[0], 3, strides=2)
        self.s32 = ConvNormAct(channels[0], channels[1], 3, strides=2)

    def forward(self, x, stage0_only: bool = False, drops=None):
        c0 = self.stem(x)
        if stage0_only:
            return (c0,)
        c2 = self.s16(self.s8(c0))
        return (c0, c2, self.s32(c2))
