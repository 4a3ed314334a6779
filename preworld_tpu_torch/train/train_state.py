"""Train state: global-norm clip + AdamW + MEGVII-style EMA.

Counterpart of `preworld_tpu/train/train_state.py`, with optax's arithmetic
spelled out in PyTorch:

  * `make_optimizer`: `optax.chain(clip_by_global_norm(5), adamw(lr_schedule,
    weight_decay=1e-2))`. The clip scales every gradient by 5 / norm when
    the global norm is 5 or more (optax's formula: no +1e-6, unlike
    `torch.nn.utils.clip_grad_norm_`); AdamW (b1 0.9, b2 0.999, eps 1e-8)
    adds the decoupled decay wd * p to the bias-corrected Adam direction and
    scales by -lr, with lr evaluated at the step count BEFORE its increment,
    as optax's `scale_by_schedule` does. A parameter that got no gradient
    takes a zero one, as `jax.grad` gives it, so weight decay still moves it.
  * `lr_schedule`: linear warmup over 200 iterations from ratio 1e-3, then
    step decays.
  * `ema_decay_schedule`: d = decay * (1 - exp(-u / 2000)), u counting from
    the config's `ema.init_updates`; the EMA covers the parameters, not the
    BatchNorm statistics.

PyTorch modules are mutable, so the state holds the model (parameters and
BatchNorm statistics) and the optimizer and is updated in place; the step
function still returns (state, metrics).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence

import torch


def lr_schedule(base_lr: float = 1e-4, warmup_iters: int = 200,
                warmup_ratio: float = 1e-3, decay_steps: Sequence[int] = (),
                decay_rate: float = 0.1) -> Callable[[int], float]:
    def fn(step: int) -> float:
        lr = base_lr * (warmup_ratio + (1 - warmup_ratio)
                        * min(step, warmup_iters) / warmup_iters)
        for s in decay_steps:
            if step >= s:
                lr *= decay_rate
        return lr

    return fn


class ClippedAdamW(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm, adamw) over one parameter group.
    `step()` returns the global gradient norm before the clip (a 0-d f32
    tensor on the parameters' device; no host sync)."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-2, clip_norm: float = 5.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(weight_decay=weight_decay))
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        """One clipped AdamW update of every parameter, with multi-tensor
        (`torch._foreach_*`) launches."""
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
                 for p in params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # optax: g / norm * clip_norm once norm >= clip_norm
        scale = torch.where(norm >= self.clip_norm, norm / self.clip_norm,
                            torch.ones_like(norm))
        grads = torch._foreach_div(grads, scale)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        wd = self.param_groups[0]["weight_decay"]
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p, dtype=torch.float32)
                self.state[p]["nu"] = torch.zeros_like(p, dtype=torch.float32)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - self.b2)
        den = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mus, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm


def make_optimizer(params, base_lr: float = 1e-4, weight_decay: float = 1e-2,
                   clip_norm: float = 5.0, warmup_iters: int = 200,
                   decay_steps: Sequence[int] = ()) -> ClippedAdamW:
    return ClippedAdamW(params, lr_schedule(base_lr, warmup_iters,
                                            decay_steps=decay_steps),
                        weight_decay=weight_decay, clip_norm=clip_norm)


def ema_decay_schedule(updates: int, decay: float = 0.999) -> float:
    """MEGVII ramped momentum: d = decay * (1 - e^{-u/2000})."""
    return decay * (1.0 - math.exp(-updates / 2000.0))


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: ClippedAdamW
    ema_params: Dict[str, torch.Tensor]
    ema_updates: int


def create_train_state(model: torch.nn.Module, optimizer: ClippedAdamW,
                       init_ema_updates: int = 0) -> TrainState:
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params=ema, ema_updates=init_ema_updates)


def eval_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The EMA once training has stepped, the raw parameters otherwise."""
    if state.step > 0:
        return state.ema_params
    return {n: p.detach() for n, p in state.model.named_parameters()}


def make_train_step(ema_decay: float = 0.999):
    """(state, batch, generator) -> (state, metrics): the model's loss dict
    in train mode with masks from `generator`, backward, clip + AdamW, EMA.
    metrics: each loss, `loss_total` and the pre-clip `grad_norm`, as 0-d
    tensors on the model's device."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        losses = model.loss(batch, generator)
        total = sum(losses[k] for k in sorted(losses))
        total.backward()
        grad_norm = opt.step()
        d = ema_decay_schedule(state.ema_updates + 1, ema_decay)
        with torch.no_grad():
            named = list(model.named_parameters())
            ema = [state.ema_params[n] for n, _ in named]
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [p for _, p in named], alpha=1.0 - d)
        state.step += 1
        state.ema_updates += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step
