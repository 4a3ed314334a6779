"""The train step's update in plain PyTorch: clip by global norm, AdamW,
and the parameters' moving average (EMA).

The gradient is scaled by clip / norm once its global norm reaches
`clip`; AdamW (b1 0.9, b2 0.999, eps 1e-8) adds weight decay times the
parameter to the bias-corrected direction and steps by the learning rate
of the step count before the step: linear warm-up from base_lr *
warmup_ratio over `warmup_iters`, then base_lr. A parameter with no
gradient takes a zero one, so weight decay still moves it.
"""

from __future__ import annotations

import math
from typing import List

import torch


class AdamW:
    def __init__(self, params: List[torch.Tensor], lr: float,
                 weight_decay: float, clip: float, warmup_iters: int,
                 warmup_ratio: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.warmup_iters, self.warmup_ratio = warmup_iters, warmup_ratio
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def rate(self, step: int) -> float:
        r = self.warmup_ratio + (1 - self.warmup_ratio) * min(
            step, self.warmup_iters) / self.warmup_iters
        return self.lr * r

    @torch.no_grad()
    def step(self) -> List[torch.Tensor]:
        """One update; returns the clipped gradients it applied."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(norm >= self.clip, self.clip / norm,
                            torch.ones_like(norm))
        grads = [g * scale for g in grads]
        lr = self.rate(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.add_(upd, alpha=-lr)
        return grads



class EMA:
    """The parameters' moving average, updated after each step: at update
    u, counted on from `init_updates`, avg = d avg + (1 - d) p with the
    ramped decay d = decay (1 - exp(-u / 2000))."""

    def __init__(self, params: List[torch.Tensor], decay: float,
                 init_updates: int):
        self.params, self.decay, self.updates = params, decay, init_updates
        self.avg = [p.detach().clone() for p in params]

    @torch.no_grad()
    def update(self) -> None:
        self.updates += 1
        d = self.decay * (1.0 - math.exp(-self.updates / 2000.0))
        for a, p in zip(self.avg, self.params):
            a.mul_(d).add_(p, alpha=1.0 - d)
