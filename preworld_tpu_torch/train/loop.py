"""Epoch-based training loop: logging, checkpointing, eval.

Counterpart of `preworld_tpu/train/loop.py`, which replaces the
reference's mmcv EpochBasedRunner + hooks (`mmdet3d/apis/train.py:180-319`):
the lr schedule, grad clip and EMA live in `ClippedAdamW` and the
`TrainState`; this loop is thin glue around the train step with host-side
logging and checkpoints. Each batch moves to the model's device; a
`torch.Generator` takes the place of the JAX loop's `rng`. There is no
`shard_fn` (the loader gives each rank its rows, and the render takes its
rays, `parallel.shard_batch`) and no `donate` (an XLA knob). With a mesh of
several processes, rank 0 alone logs, writes metrics.jsonl and saves the
checkpoint, and every rank waits for the save; `maybe_resume` restores the
step rank 0 finds on every rank.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.synthetic import to_device
from ..utils import trace
from .checkpoints import latest_step, restore_checkpoint, save_checkpoint

logger = logging.getLogger("preworld_tpu_torch")


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch as tensors on `device`, less the keys that
    start with `__` (host-side metadata such as `__bda_flips`)."""
    return to_device({k: v for k, v in batch.items()
                      if not k.startswith("__")}, device)


def train_epochs(
    state,
    train_step: Optional[Callable],
    loader,
    max_epochs: int,
    work_dir: str,
    log_interval: int = 50,
    checkpoint_interval: int = 1,
    generator: Optional[torch.Generator] = None,
    start_epoch: int = 0,
    eval_fn: Optional[Callable] = None,
    set_epoch_hooks: Iterable[Callable] = (),
    step_factory: Optional[Callable] = None,
    max_iters_per_epoch: Optional[int] = None,
    profile_dir: Optional[str] = None,
    mesh=None,
):
    """Run epochs `start_epoch` .. `max_epochs` - 1; returns the final
    state.

    train_step: (state, batch, generator) -> (state, metrics), the metrics
    0-d tensors; they are read on the host only every `log_interval`
    iterations, so the loop adds no synchronisation per step.
    set_epoch_hooks: callables(epoch), e.g. rollout-curriculum control
    (reference `CustomSetEpochInfoHook`).
    step_factory: optional callable(epoch) -> train_step, for
    epoch-dependent step functions.
    profile_dir: a `torch.profiler` trace of iterations 8-11 of the first
    epoch, written there as a Chrome trace, with the program's spans
    (`utils.trace`) on for those iterations.
    Each record of metrics.jsonl gives, beside `time_per_iter`,
    `data_wait`: the host seconds an iteration spent waiting on the
    loader's next batch, averaged over the records' iterations.
    mesh: the step's `parallel` mesh; its rank 0 writes the records, the
    checkpoints and the profile.
    """
    main = mesh is None or mesh.rank == 0
    os.makedirs(work_dir, exist_ok=True)
    generator = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    device = next(state.model.parameters()).device
    step_fn = train_step
    log_path = os.path.join(work_dir, "metrics.jsonl") if main else os.devnull
    with open(log_path, "a") as metrics_log:
        for epoch in range(start_epoch, max_epochs):
            if step_factory is not None:
                step_fn = step_factory(epoch)
            loader.set_epoch(epoch)
            for hook in set_epoch_hooks:
                hook(epoch)
            t_iter = time.time()
            prof = None
            wait = 0.0
            t_wait = time.perf_counter()
            for it, batch in enumerate(loader):
                wait += time.perf_counter() - t_wait
                if max_iters_per_epoch is not None \
                        and it >= max_iters_per_epoch:
                    break
                if profile_dir and main and epoch == start_epoch and it == 8:
                    prof = torch.profiler.profile(activities=_activities(
                        device))
                    prof.start()
                    trace.enable(True)
                if prof is not None and it == 12:
                    _stop_profile(prof, profile_dir)
                    prof = None
                state, metrics = step_fn(state, batch_to(batch, device),
                                         generator)
                if (it + 1) % log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t_iter) / log_interval
                    t_iter = time.time()
                    rec = {
                        "epoch": epoch,
                        "iter": it + 1,
                        "time_per_iter": round(dt, 3),
                        "data_wait": round(wait / log_interval, 4),
                        **{k: round(v, 5) for k, v in metrics.items()},
                    }
                    wait = 0.0
                    if main:
                        logger.info(json.dumps(rec))
                    metrics_log.write(json.dumps(rec) + "\n")
                    metrics_log.flush()
                t_wait = time.perf_counter()
            if prof is not None:
                _stop_profile(prof, profile_dir)
            if (epoch + 1) % checkpoint_interval == 0:
                if main:
                    save_checkpoint(os.path.join(work_dir, "checkpoints"),
                                    state, int(state.step))
                _barrier(mesh)
            if eval_fn is not None:
                results = eval_fn(state)
                if main:
                    logger.info("eval@epoch%d: %s", epoch, results)
                metrics_log.write(
                    json.dumps({"epoch": epoch, "eval": results}) + "\n")
                metrics_log.flush()
    return state


def _barrier(mesh) -> None:
    if mesh is not None and mesh.world > 1:
        dist.barrier()


def _agree(mesh, device, *values: int):
    """Rank 0's `values` on every rank of `mesh` (one broadcast)."""
    if mesh is None or mesh.world == 1:
        return values
    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return tuple(t.tolist())


def _activities(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _stop_profile(prof, profile_dir: str) -> None:
    trace.enable(False)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profile written to %s", path)


def maybe_resume(state, work_dir: str, resume_from: Optional[str] = None,
                 mesh=None):
    """Resume the train state from a checkpoint. Returns (state, resumed).
    With a mesh of several processes, every rank restores the checkpoint
    that rank 0 finds (the work dir is shared).

    With `resume_from` set, honours the explicit path (reference
    `--resume-from`, `tools/train.py:148-156` + `utils/patch.py:56-99`):
    either a work_dir (containing `checkpoints/`) or a checkpoint directory
    itself; raises FileNotFoundError if nothing restorable is found there
    (an explicit path silently falling back would break the pretrain ->
    finetune handoff). Otherwise auto-resumes from the latest checkpoint in
    `work_dir/checkpoints` (`--auto-resume`, `utils/patch.py:56-72`)."""
    cands = ((os.path.join(resume_from, "checkpoints"), resume_from)
             if resume_from else (os.path.join(work_dir, "checkpoints"),))
    found = next(((i, step) for i, step in enumerate(map(latest_step, cands))
                  if step is not None), (-1, -1))
    device = next(state.model.parameters()).device
    i, step = _agree(mesh, device, *found)
    if i >= 0:
        return restore_checkpoint(cands[i], state, step), True
    if resume_from:
        raise FileNotFoundError(
            f"--resume-from {resume_from}: no checkpoint found "
            "(looked in ./checkpoints and the path itself)")
    return state, False
