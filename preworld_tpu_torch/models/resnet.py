"""CustomResNet (2-D BEV encoder) and CustomResNet3D (voxel encoder),
channel-last.

Counterpart of `preworld_tpu/models/resnet.py`: one module for both conv
ranks. `CustomResNet3D` (the BEV encoder backbone and the `pre_process`
net) is `CustomResNet` with `ndim=3`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .layers import BasicBlock


class CustomResNet(nn.Module):
    """Stacked BasicBlock stages (2-D or 3-D by `ndim`); returns the
    requested stages."""

    def __init__(self, in_channels: int, num_layer: Sequence[int] = (2, 2, 2),
                 num_channels: Sequence[int] = (160, 320, 640),
                 stride: Sequence[int] = (2, 2, 2),
                 backbone_output_ids: Sequence[int] = (0, 1, 2),
                 ndim: int = 2):
        super().__init__()
        self.num_layer = tuple(num_layer)
        self.backbone_output_ids = tuple(backbone_output_ids)
        cin = in_channels
        for i, (n, c, s) in enumerate(zip(num_layer, num_channels, stride)):
            setattr(self, f"layer{i}_block0",
                    BasicBlock(cin, c, strides=s, downsample=True, ndim=ndim))
            for j in range(1, n):
                setattr(self, f"layer{i}_block{j}",
                        BasicBlock(c, c, ndim=ndim))
            cin = c

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        feats = []
        for i, n in enumerate(self.num_layer):
            for j in range(n):
                x = getattr(self, f"layer{i}_block{j}")(x)
            if i in self.backbone_output_ids:
                feats.append(x)
        return tuple(feats)


class CustomResNet3D(CustomResNet):
    """CustomResNet on (B, X, Y, Z, C) input: 3-D convolutions."""

    def __init__(self, in_channels: int, num_layer: Sequence[int] = (2, 2, 2),
                 num_channels: Sequence[int] = (160, 320, 640),
                 stride: Sequence[int] = (2, 2, 2),
                 backbone_output_ids: Sequence[int] = (0, 1, 2)):
        super().__init__(in_channels, num_layer, num_channels, stride,
                         backbone_output_ids, ndim=3)
