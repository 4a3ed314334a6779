"""Batched occupancy evaluation.

Counterpart of `preworld_tpu/train/evaluate.py`, which replaces the
reference's distributed test loop + rank gather (`mmdet3d/apis/test.py:
63-195`). Predictions run batched on the model's device with the EMA
weights (`eval_params`), and the per-horizon confusion histograms are
summed across processes at the end, one all-reduce of a (C, C) f64 array,
where the JAX package gathers across hosts: over a `parallel` mesh's data
group when a mesh is given (its seq replicas hold the same samples, which
then count once), else over the default process group when
`torch.distributed` runs more than one process (gloo on the CPU).

The model predicts through `torch.func.functional_call`, so the training
parameters, their gradients, the optimizer and the BatchNorm buffers are
never written; the model is put in eval mode for the predictions and given
back each module's mode as it found it.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import collate
from ..metrics import MetricMIoU, MetricMIoUTemporal
from .loop import batch_to
from .train_state import eval_params

INFER_KEYS = (
    "imgs", "sensor2egos", "ego2globals", "intrins",
    "post_rots", "post_trans", "bda", "ego_states",
)


def _world(mesh=None) -> tuple:
    """(rank, world, group) the samples are strided over: the mesh's data
    group, else the default process group, else (0, 1, None)."""
    if mesh is not None:
        return mesh.data_rank, mesh.n_data, mesh.data_group
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), None
    return 0, 1, None


def rank_padded_indices(n: int, rank: Optional[int] = None,
                        world: Optional[int] = None):
    """Per-process sample indices for multi-process eval, padded to EQUAL
    length across processes.

    Every process must run the same number of batches, or the short ranks
    reach the histogram's all-reduce while the long ranks still predict
    (the reference pads the same way — DistributedSampler's round-up,
    `apis/test.py:63-80`). Each process gets exactly ceil(n/world) entries:
    its rank-strided real indices followed by repeats of its last real
    index flagged valid=False, so the repeats run inference but are never
    scored.

    Yields (index, valid). Attach the flag to each sample dict as
    `"_valid"` — `_batched` strips it and excludes padding from n_valid.
    """
    if rank is None or world is None:
        r, w, _ = _world()
        rank = r if rank is None else rank
        world = w if world is None else world
    per = -(-n // world) if n > 0 else 0
    real = list(range(rank, n, world))
    pad_src = real[-1] if real else 0
    for j in range(per):
        if j < len(real):
            yield real[j], True
        else:
            yield pad_src, False


def _batched(samples: Iterable[Dict[str, np.ndarray]], batch_size: int):
    """Yield (collated_batch, n_valid) with the final batch padded by
    repeating its last sample, so every batch has `batch_size` rows.

    Samples may carry a `_valid` bool (multi-process padding from
    rank_padded_indices); it is stripped before collation and excluded
    from n_valid. Invalid samples must trail valid ones within a batch —
    true by construction, since padding is appended at stream end."""
    chunk = []
    n_valid = 0
    for s in samples:
        s = dict(s)
        if s.pop("_valid", True):
            n_valid += 1
        chunk.append(s)
        if len(chunk) == batch_size:
            yield collate(chunk), n_valid
            chunk, n_valid = [], 0
    if chunk:
        chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
        yield collate(chunk), n_valid


def all_hosts_sum(hist: np.ndarray, mesh=None) -> np.ndarray:
    """Sum a process-local array across the processes of `_world(mesh)`
    (an f64 all-reduce); the input itself with one process."""
    _, world, group = _world(mesh)
    if world == 1:
        return hist
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.as_tensor(np.asarray(hist, np.float64), device=dev)
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


class _Predictor(torch.nn.Module):
    """`model.predict` as a module's forward, for `functional_call`."""

    def __init__(self, model: torch.nn.Module, **predict_kwargs):
        super().__init__()
        self.model = model
        self.predict_kwargs = predict_kwargs

    def forward(self, batch):
        return self.model.predict(batch, **self.predict_kwargs)


def model_predict_fn(model: torch.nn.Module, **predict_kwargs) -> Callable:
    """(params, batch) -> model.predict(batch, **predict_kwargs) with
    `params` in place of the model's parameters and its own buffers, in
    eval mode."""
    wrapper = _Predictor(model, **predict_kwargs)

    def predict_fn(params, batch):
        modes = [(m, m.training) for m in model.modules()]
        model.eval()
        try:
            with torch.no_grad():
                return torch.func.functional_call(
                    wrapper, {f"model.{n}": p for n, p in params.items()},
                    (batch,), strict=False)
        finally:
            for m, training in modes:
                m.training = training

    return predict_fn


def _device(model, device):
    if device is not None:
        return torch.device(device)
    if model is not None:
        return next(model.parameters()).device
    return torch.device("cuda")


def evaluate_miou(
    model,
    state,
    samples: Iterable[Dict[str, np.ndarray]],
    num_classes: int = 18,
    use_image_mask: bool = True,
    batch_size: Optional[int] = None,
    predict_fn: Optional[Callable] = None,
    dump_fn: Optional[Callable[[int, np.ndarray], None]] = None,
    fscore_metric=None,
    device=None,
    mesh=None,
) -> Dict:
    """Run 3-D occ mIoU over `samples` (dicts of per-sample arrays).

    `samples` are THIS PROCESS's samples (rank-strided upstream when
    several processes evaluate, like the training loader: by the mesh's
    data rank when the processes form a `parallel` mesh, which is then
    passed as `mesh`); `batch_size` is
    the per-process batch and defaults to 1. Samples must carry
    `voxel_semantics` (+ optional masks) for scoring; inference uses only
    INFER_KEYS, moved to `device` (the model's by default).

    `predict_fn(params, batch)` -> {"semantic_occ": (B, X, Y, Z)} replaces
    the model's predict; `params` is `eval_params(state)`, the EMA once the
    state has stepped.

    `fscore_metric`: optional `MetricFScore` scored on the same predictions
    (the reference's `--eval mIoU` runs both metrics together,
    `occ_metrics.py:322-410`); its results merge into the returned dict.
    """
    batch_size = batch_size or 1
    device = _device(model, device)
    params = eval_params(state)
    predict_fn = predict_fn or model_predict_fn(model)

    metric = MetricMIoU(num_classes=num_classes, use_image_mask=use_image_mask)
    seen = 0
    for batch, n_valid in _batched(samples, batch_size):
        infer = batch_to({k: v for k, v in batch.items() if k in INFER_KEYS},
                         device)
        out = predict_fn(params, infer)
        occ = out["semantic_occ"].cpu().numpy()
        for j in range(n_valid):
            if dump_fn is not None:
                dump_fn(seen + j, occ[j])
            if "voxel_semantics" in batch:
                metric.add_batch(
                    occ[j],
                    batch["voxel_semantics"][j],
                    batch.get("mask_lidar", [None] * batch_size)[j],
                    batch.get("mask_camera", [None] * batch_size)[j],
                )
                if fscore_metric is not None:
                    fscore_metric.add_batch(
                        occ[j],
                        batch["voxel_semantics"][j],
                        batch.get("mask_lidar", [None] * batch_size)[j],
                        batch.get("mask_camera", [None] * batch_size)[j],
                    )
        seen += n_valid
    metric.hist = all_hosts_sum(metric.hist, mesh)
    results = metric.count_miou()
    if fscore_metric is not None:
        # per-sample means: sum the (weighted) accumulators across processes
        sums = all_hosts_sum(np.asarray([
            fscore_metric.tot_acc, fscore_metric.tot_cmpl,
            fscore_metric.tot_f1, float(fscore_metric.cnt),
        ]), mesh)
        fscore_metric.tot_acc, fscore_metric.tot_cmpl, \
            fscore_metric.tot_f1 = sums[0], sums[1], sums[2]
        fscore_metric.cnt = int(sums[3])
        results.update(fscore_metric.count_fscore())
    return results


def evaluate_miou_temporal(
    model,
    state,
    samples: Iterable[Dict[str, np.ndarray]],
    rollout_steps: Sequence[int] = (0, 1, 3, 5),
    num_classes: int = 18,
    batch_size: Optional[int] = None,
    predict_fn: Optional[Callable] = None,
    device=None,
    mesh=None,
) -> Dict:
    """Batched 4-D forecasting eval (reference serial loop:
    `mmdet3d/apis/test.py:198-259`).

    `samples` are THIS PROCESS's samples (`mesh` as in `evaluate_miou`);
    each dict carries INFER_KEYS plus
    per-horizon GT under `gt_h{0..3}` (horizon h <-> rollout step
    rollout_steps[h] <-> output key `semantic_occ_{step}s`).
    """
    batch_size = batch_size or 1
    device = _device(model, device)
    params = eval_params(state)
    predict_fn = predict_fn or model_predict_fn(model)

    metric = MetricMIoUTemporal(num_classes=num_classes)
    for batch, n_valid in _batched(samples, batch_size):
        infer = batch_to({k: v for k, v in batch.items() if k in INFER_KEYS},
                         device)
        out = predict_fn(params, infer)
        preds = {
            h: out[f"semantic_occ_{s}s"].cpu().numpy()
            for h, s in zip(MetricMIoUTemporal.HORIZONS, rollout_steps)
        }
        for j in range(n_valid):
            metric.add_batch(
                {h: p[j] for h, p in preds.items()},
                {h: batch[f"gt_h{h}"][j]
                 for h in MetricMIoUTemporal.HORIZONS
                 if f"gt_h{h}" in batch},
            )
    for h in metric.hists:
        metric.hists[h] = all_hosts_sum(metric.hists[h], mesh)
    metric.cnt = int(all_hosts_sum(np.asarray([metric.cnt]), mesh)[0])
    return metric.count_miou()
