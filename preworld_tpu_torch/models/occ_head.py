"""Occupancy prediction head on (B, X, Y, Z, C), and the forecasting
model's voxel downscale.

Counterpart of `preworld_tpu/models/occ_head.py` (`OccHead`,
`DownScale3D`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv3d, ConvNormAct, to_cf, to_cl


class OccHead(nn.Module):
    def __init__(self, in_channels: int = 32, out_channel: int = 18,
                 soft_weights: bool = True):
        super().__init__()
        mid = in_channels // 2
        self.soft_weights = soft_weights
        self.occ_conv = ConvNormAct(in_channels, mid, (3, 3, 3))
        if soft_weights:
            self.soft_w0 = ConvNormAct(mid, mid // 2, (1, 1, 1))
            self.soft_w1 = Conv3d(mid // 2, 1, 1, bias=False)
        self.pred0 = ConvNormAct(mid, mid // 2, (1, 1, 1))
        self.pred1 = Conv3d(mid // 2, out_channel, 1, bias=False)

    def forward(self, voxel_feats):
        """(B, X, Y, Z, C) -> logits (B, X, Y, Z, out_channel)."""
        x = self.occ_conv(voxel_feats)
        if self.soft_weights:
            # single level: a softmax over one channel, i.e. a gate of ones
            w = to_cl(self.soft_w1(to_cf(self.soft_w0(x))))
            x = x * torch.softmax(w, dim=-1)
        y = self.pred0(x)
        return to_cl(self.pred1(to_cf(y)))


class DownScale3D(nn.Module):
    """Three 2x2x2 stride-2 convolutions with bias, then the mean over X, Y
    and Z: (B, X, Y, Z, C) -> (B, 4C), f32. Counterpart of the JAX
    `DownScale3D`, whose flax convolutions pad "SAME": an odd axis gets one
    zero plane after the data (ceil(n / 2) outputs), which `_pad_same`
    spells out. At the flagship grid (200 -> 100 -> 50 -> 25, 16 -> 8 -> 4
    -> 2) no axis is odd; at the tiny test grid (20x20x8) the third
    convolution meets X = Y = 5."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.down1 = Conv3d(in_dim, in_dim * 2, 2, 2)
        self.down2 = Conv3d(in_dim * 2, in_dim * 4, 2, 2)
        self.down3 = Conv3d(in_dim * 4, in_dim * 4, 2, 2)

    def forward(self, feats):
        x = to_cf(feats)
        for conv in (self.down1, self.down2, self.down3):
            x = conv(_pad_same(x))
        return x.mean(dim=(2, 3, 4))


def _pad_same(x: torch.Tensor) -> torch.Tensor:
    """Channels-first (B, C, X, Y, Z): one zero plane after each odd spatial
    axis, flax's "SAME" for a 2-wide kernel at stride 2."""
    pad = []
    for n in reversed(x.shape[2:]):
        pad += [0, n % 2]
    return F.pad(x, pad) if any(pad) else x
