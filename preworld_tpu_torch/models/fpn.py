"""Image neck FPN_LSS and voxel neck LSSFPN3D (channel-last).

Counterpart of `preworld_tpu/models/fpn.py`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import ConvNormAct, upsample


class FPN_LSS(nn.Module):
    """Upsample the deep feature x2, concat with the shallow one, two convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv0 = ConvNormAct(in_channels, out_channels, 3)
        self.conv1 = ConvNormAct(out_channels, out_channels, 3)

    def forward(self, feats):
        x2, x1 = feats[0], feats[1]
        x1 = upsample(x1, self.scale_factor, align_corners=True)
        x = torch.cat([x2, x1], dim=-1)
        return self.conv1(self.conv0(x))


class LSSFPN3D(nn.Module):
    """Trilinear-upsample three voxel scales (1x, 1/2, 1/4), concat, 1x1x1
    fuse to out_channels."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.fuse = ConvNormAct(in_channels, out_channels, (1, 1, 1))

    def forward(self, feats):
        x8, x16, x32 = feats
        x16 = upsample(x16, 2, align_corners=True)
        x32 = upsample(x32, 4, align_corners=True)
        return self.fuse(torch.cat([x8, x16, x32], dim=-1))
