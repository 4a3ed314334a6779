"""Occupancy prediction head on (B, X, Y, Z, C).

Counterpart of `preworld_tpu/models/occ_head.py` (`OccHead`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import ConvNormAct, to_cf, to_cl


class OccHead(nn.Module):
    def __init__(self, in_channels: int = 32, out_channel: int = 18,
                 soft_weights: bool = True):
        super().__init__()
        mid = in_channels // 2
        self.soft_weights = soft_weights
        self.occ_conv = ConvNormAct(in_channels, mid, (3, 3, 3))
        if soft_weights:
            self.soft_w0 = ConvNormAct(mid, mid // 2, (1, 1, 1))
            self.soft_w1 = nn.Conv3d(mid // 2, 1, 1, bias=False)
        self.pred0 = ConvNormAct(mid, mid // 2, (1, 1, 1))
        self.pred1 = nn.Conv3d(mid // 2, out_channel, 1, bias=False)

    def forward(self, voxel_feats):
        """(B, X, Y, Z, C) -> logits (B, X, Y, Z, out_channel)."""
        x = self.occ_conv(voxel_feats)
        if self.soft_weights:
            # single level: a softmax over one channel, i.e. a gate of ones
            w = to_cl(self.soft_w1(to_cf(self.soft_w0(x))))
            x = x * torch.softmax(w, dim=-1)
        y = self.pred0(x)
        return to_cl(self.pred1(to_cf(y)))
