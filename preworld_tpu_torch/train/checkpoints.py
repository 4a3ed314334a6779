"""Checkpoints of the train state: save, find the latest, restore.

Counterpart of `preworld_tpu/train/checkpoints.py` (orbax there). A
checkpoint is one `torch.save` file per step, `<ckpt_dir>/<step>.pt`,
holding plain dicts of tensors and numbers only, so that
`torch.load(..., weights_only=True)` reads it:

  * `model`: `model.state_dict()`, the f32 parameters and every buffer
    (BatchNorm `running_mean` / `running_var` / `num_batches_tracked`);
  * `optimizer`: AdamW's `mu` / `nu` by parameter name and its step
    `count`, which the lr schedule and the bias correction read
    (`ClippedAdamW.count` is a plain attribute, not in
    `Optimizer.state_dict()`);
  * `ema_params`, `ema_updates` and `step`.

The newest `max_to_keep` files are kept, as orbax keeps them. A file is
written under a temporary name and then renamed, so a run cut while saving
leaves the previous checkpoint readable. One process writes a path: with
several, `train_epochs` saves on rank 0 alone and the others wait.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from .train_state import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                 os.listdir(ckpt_dir)) if m)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step}.pt")


def state_dict(state: TrainState) -> Dict:
    """The checkpoint's contents: tensors, ints and plain dicts only."""
    opt = state.optimizer
    named = list(state.model.named_parameters())
    moments = {k: {n: opt.state[p][k] for n, p in named if opt.state[p]}
               for k in ("mu", "nu")}
    return {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": {"count": int(opt.count), **moments},
        "ema_params": dict(state.ema_params),
        "ema_updates": int(state.ema_updates),
    }


def load_state_dict(state: TrainState, ckpt: Dict) -> TrainState:
    """Copy a checkpoint's contents into `state` (its model, optimizer and
    EMA keep their tensors and devices) and return it."""
    state.model.load_state_dict(ckpt["model"])
    opt, saved = state.optimizer, ckpt["optimizer"]
    opt.count = int(saved["count"])
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            if n in saved["mu"]:
                opt.state[p] = {
                    k: torch.empty_like(p, dtype=torch.float32).copy_(
                        saved[k][n]) for k in ("mu", "nu")}
            else:
                opt.state.pop(p, None)
        for n, e in state.ema_params.items():
            e.copy_(ckpt["ema_params"][n])
    state.step = int(ckpt["step"])
    state.ema_updates = int(ckpt["ema_updates"])
    return state


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    max_to_keep: int = 3) -> str:
    """Write `state` as step `step` and drop all but the newest
    `max_to_keep` checkpoints; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(state_dict(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> Optional[TrainState]:
    """Load step `step` (the latest by default) into `state`, the template,
    whose model sets the device the tensors are loaded to. None when
    `ckpt_dir` holds no checkpoint."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    device = next(state.model.parameters()).device
    ckpt = torch.load(checkpoint_path(ckpt_dir, step), map_location=device,
                      weights_only=True)
    return load_state_dict(state, ckpt)
