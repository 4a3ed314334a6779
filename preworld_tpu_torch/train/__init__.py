"""Training (pretrain and finetune): config -> model, optimizer, EMA and the
train step; the epoch loop, checkpoints and the mIoU evaluation."""

from .builder import build_model
from .checkpoints import (
    checkpoint_path,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .evaluate import (
    evaluate_miou,
    evaluate_miou_temporal,
    model_predict_fn,
    rank_padded_indices,
)
from .loop import maybe_resume, train_epochs
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
    "checkpoint_path",
    "create_train_state",
    "ema_decay_schedule",
    "eval_params",
    "evaluate_miou",
    "evaluate_miou_temporal",
    "latest_step",
    "lr_schedule",
    "make_optimizer",
    "make_train_step",
    "maybe_resume",
    "model_predict_fn",
    "rank_padded_indices",
    "restore_checkpoint",
    "save_checkpoint",
    "train_epochs",
]
