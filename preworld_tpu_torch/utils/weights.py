"""Seeded random weights for runs without a checkpoint (benchmarks and the
card's smoke checks)."""

from __future__ import annotations

import torch
import torch.nn as nn


def init_weights(model: nn.Module, seed: int, fan_in: bool = False) -> None:
    """Fill `model` in place from a host generator seeded `seed`: N(0, 0.02)
    for every parameter (or N(0, 1/sqrt(fan_in)) for weight matrices and
    kernels when `fan_in`), norm scales 1 + N(0, 0.02), BatchNorm running
    means N(0, 0.02) and POSITIVE running variances U(0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=gen) * std + mean)

    norms = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, norms):
                draw(m.weight, 0.02, 1.0)
                draw(m.bias, 0.02)
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    draw(m.running_mean, 0.02)
                    m.running_var.copy_(
                        torch.rand(m.running_var.shape, generator=gen) + 0.5)
                continue
            for p in m.parameters(recurse=False):
                std = 0.02
                if fan_in and p.dim() >= 2:
                    std = p[0].numel() ** -0.5
                draw(p, std)
