"""Training (pretrain and finetune): config -> model, optimizer, EMA and the
train step."""

from .builder import build_model
from .train_state import (
    ClippedAdamW,
    TrainState,
    create_train_state,
    ema_decay_schedule,
    eval_params,
    lr_schedule,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "ClippedAdamW",
    "TrainState",
    "build_model",
    "create_train_state",
    "ema_decay_schedule",
    "eval_params",
    "lr_schedule",
    "make_optimizer",
    "make_train_step",
]
