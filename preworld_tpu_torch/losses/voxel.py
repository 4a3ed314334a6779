"""3-D occupancy losses: CE, semantic / geometric scal, Lovasz, focal.

Counterpart of `preworld_tpu/losses/voxel.py`, plain PyTorch, with the same
static-shape formulation: ignored voxels get zero weight instead of being
compacted away. Logits are channel-last (B, X, Y, Z, C) float; targets
(B, X, Y, Z) integer. Also the class-weight tables of
`preworld_tpu/models/nerf_head.py` (`nusc_class_weights`,
`voxel_class_weights`).

Under an active mesh (`parallel.use_mesh`) each loss is of the global
batch, whose rows the data group's ranks hold (the JAX losses under jit on
a batch sharded over 'data'): the statistics that span the batch (a
normaliser, the scal losses' per-class sums, Lovasz's one sort over every
voxel) are summed or gathered over the data group with gradient, and the
value is returned at `replica_share()`, so that the ranks' values add up
to it (`parallel` invariant 1). Without a mesh each is the single-process
function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import batch_sums, gather_rows, replica_share
from ..parallel.mesh import current_mesh

# occ3d-nuscenes class frequencies (`preworld_tpu/models/nerf_head.py`)
NUSC_CLASS_FREQUENCIES = np.array(
    [
        1163161, 2309034, 188743, 2997643, 20317180, 852476, 243808, 2457947,
        497017, 2731022, 7224789, 214411435, 5565043, 63191967, 76098082,
        128860031, 141625221, 2307405309,
    ],
    np.float64,
)
# nuPlan 12-class CE weights: placeholder classes zeroed
# (`preworld_tpu/data/nuplan.py`)
NUPLAN_CLASS_WEIGHT_MASK = np.array([1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 0],
                                    np.float32)


def nusc_class_weights(num: int = 17) -> np.ndarray:
    """1 / log(freq + 0.001) balance weights."""
    return (1.0 / np.log(NUSC_CLASS_FREQUENCIES[:num] + 0.001)).astype(np.float32)


def voxel_class_weights(num_classes: int, balance: bool = True) -> np.ndarray:
    """Per-class CE weights with the empty class zeroed: the nuScenes
    log-balance profile for 18 classes when `balance`, the nuPlan mask for
    12, else uniform over the non-empty classes."""
    if num_classes == 12:
        return NUPLAN_CLASS_WEIGHT_MASK.copy()
    if balance and num_classes == 18:
        w = nusc_class_weights(17)
    else:
        n = num_classes - 1
        w = np.ones(n, np.float32) / n
    return np.concatenate([w, np.zeros(1, np.float32)])


def _valid_mask(target, ignore_index, camera_mask):
    m = (target != ignore_index).float()
    if camera_mask is not None:
        m = m * camera_mask.float()
    return m


def ce_ssc_loss(logits, target, class_weights, ignore_index: int = 255):
    """Weighted CE: sum(w_t * ce) / sum(w_t) over valid voxels."""
    C = logits.shape[-1]
    m = (target != ignore_index).float()
    t = target.clamp(0, C - 1).long()
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, t[..., None])[..., 0]
    w = class_weights[t] * m
    num, den = batch_sums((ce * w).sum(), w.sum())
    return num / den.clamp_min(1e-8) * replica_share()


def _bce_of_ratio(r):
    """binary_cross_entropy(r, 1) = -log(r), clamped as torch does."""
    return -torch.log(r.clamp(1e-12, 1.0))


def _class_masks(C, target, camera_mask, ignore_index):
    """(m (P, 1) f32, [t = c] (P, C) bool) over the P voxels."""
    m = _valid_mask(target, ignore_index, camera_mask).reshape(-1, 1)
    classes = torch.arange(C, device=target.device)
    return m, target.reshape(-1, 1) == classes


class _SemScalSums(torch.autograd.Function):
    """The per-class sums of `sem_scal_loss`, one (C, 4) f32 stack of
    columns (n_fg, nominator, sum_p, n_bg): with p = softmax(logits) and m
    the valid mask, n_fg_c = sum m [t = c], nominator_c = sum m p_c [t = c],
    sum_p_c = sum m p_c and n_bg_c = sum m - n_fg_c, over every voxel at
    once. Only nominator and sum_p depend on the logits, and the backward
    is their closed form dp_c = m (g_nominator_c [t = c] + g_sum_p_c)
    through the softmax recomputed from the logits: it saves only its own
    inputs."""

    @staticmethod
    def forward(ctx, logits, target, camera_mask, ignore_index):
        ctx.ignore_index = ignore_index
        ctx.save_for_backward(logits, target, camera_mask)
        m, is_c = _class_masks(logits.shape[-1], target, camera_mask,
                               ignore_index)
        n_fg = (is_c * m).sum(0)
        p = torch.softmax(logits.reshape(is_c.shape), -1)
        mp = p.to(torch.promote_types(p.dtype, m.dtype)).mul_(m)
        sum_p = mp.sum(0)
        nominator = mp.mul_(is_c).sum(0)
        return torch.stack([n_fg, nominator, sum_p, m.sum() - n_fg], 1)

    @staticmethod
    def backward(ctx, g):
        logits, target, camera_mask = ctx.saved_tensors
        m, is_c = _class_masks(logits.shape[-1], target, camera_mask,
                               ctx.ignore_index)
        g_nominator, g_sum_p = g[:, 1], g[:, 2]
        dp = torch.where(is_c, g_nominator + g_sum_p, g_sum_p).mul_(m)
        p = torch.softmax(logits.reshape(is_c.shape), -1)
        dx = torch._softmax_backward_data(dp.to(p.dtype), p, -1, p.dtype)
        return dx.reshape(logits.shape), None, None, None


def sem_scal_loss(logits, target, ignore_index: int = 255,
                  camera_mask: Optional[torch.Tensor] = None):
    """Class-wise precision / recall / specificity BCE."""
    sums, = batch_sums(_SemScalSums.apply(logits, target, camera_mask,
                                          ignore_index))
    n_fg, nominator, sum_p, n_bg = sums.unbind(1)
    # rows: precision, recall, specificity; each term 0 where its
    # denominator is (recall's where n_fg is, as `present` makes it)
    num = torch.stack([nominator, nominator, n_bg - sum_p + nominator])
    den = torch.stack([sum_p, n_fg, n_bg])
    bce = torch.where(den > 0, _bce_of_ratio(num / den.clamp_min(1e-12)), 0.0)
    present = (n_fg > 0).float()
    loss = (bce.sum(0) * present).sum()
    return loss / present.sum().clamp_min(1.0) * replica_share()


def geo_scal_loss(logits, target, ignore_index: int = 255,
                  non_empty_idx: int = 17,
                  camera_mask: Optional[torch.Tensor] = None):
    """Occupied-vs-free precision / recall / specificity BCE; masks only by
    target != empty (+ camera mask), as the JAX package and its reference
    do."""
    p = torch.softmax(logits, dim=-1)
    empty_probs = p[..., non_empty_idx]
    nonempty_probs = 1.0 - empty_probs
    mask = (target != non_empty_idx).float()
    if camera_mask is not None:
        mask = mask * camera_mask.float()
    intersection, sum_p, n_fg, spec_num, n_bg = batch_sums(
        (mask * nonempty_probs).sum(), nonempty_probs.sum(), mask.sum(),
        ((1.0 - mask) * empty_probs).sum(), (1.0 - mask).sum())
    precision = intersection / sum_p.clamp_min(1e-12)
    recall = intersection / n_fg.clamp_min(1e-12)
    spec = spec_num / n_bg.clamp_min(1e-12)
    return (_bce_of_ratio(precision) + _bce_of_ratio(recall)
            + _bce_of_ratio(spec)) * replica_share()


def _lovasz_grad(gt_sorted):
    """Gradient of the Lovasz extension w.r.t. sorted errors, per row."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp_min(1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def lovasz_softmax_loss(logits, target, ignore_index: int = 17,
                        camera_mask: Optional[torch.Tensor] = None,
                        from_probs: bool = False):
    """Multi-class Lovasz-softmax, classes='present', per_image=False.
    Ignored voxels get zero error and fg = 0, so they sort to the tail and
    add nothing. All classes are sorted at once, one row each; under a
    mesh, over the voxels of the global batch, gathered from the data
    group (each rank's gradient is its own voxels' rows)."""
    C = logits.shape[-1]
    probs = logits if from_probs else torch.softmax(logits, dim=-1)
    probs = probs.reshape(-1, C)
    t = target.reshape(-1)
    valid = t != ignore_index
    if camera_mask is not None:
        valid = valid & camera_mask.reshape(-1).bool()
    mesh = current_mesh()
    if mesh is not None and mesh.data_group is not None:
        at = (mesh.data_group, mesh.data_rank, mesh.n_data)
        probs = gather_rows(probs, *at)
        tv = gather_rows(torch.stack([t.float(), valid.float()], 1), *at)
        t, valid = tv[:, 0].long(), tv[:, 1] > 0
    vf = valid.float()
    classes = torch.arange(C, device=t.device)
    fg = (t[None, :] == classes[:, None]).float() * vf        # (C, P)
    err = (fg - probs.t()).abs() * vf
    err_s, order = torch.sort(err, dim=-1, descending=True)
    fg_s = fg.gather(-1, order)
    present = (fg.sum(-1) > 0).float()
    losses = present * (err_s * _lovasz_grad(fg_s)).sum(-1)
    return losses.sum() / present.sum().clamp_min(1.0) * replica_share()


def distance_weighted_focal_loss(logits, target, class_weights,
                                 ignore_index: int = 255,
                                 camera_mask: Optional[torch.Tensor] = None,
                                 gamma: float = 2.0, alpha: float = 0.25,
                                 loss_weight: float = 100.0):
    """Sigmoid focal CE over valid voxels, weighted by class weight times
    the BEV-distance factor 1 + r / r_max:
    loss = lw * mean_valid(sum_c focal_c * w_c * d)."""
    B, X, Y, Z, C = logits.shape
    dev = logits.device
    xs = torch.arange(X, dtype=torch.float32, device=dev) - X / 2
    ys = torch.arange(Y, dtype=torch.float32, device=dev) - Y / 2
    r = torch.sqrt(xs[:, None] ** 2 + ys[None, :] ** 2)
    dist = (r / r.max() + 1.0)[None, :, :, None]  # (1, X, Y, 1) in [1, 2]
    m = _valid_mask(target, ignore_index, camera_mask)
    t = target.clamp(0, C).long()
    onehot = F.one_hot(t, C + 1).float()[..., :C]
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * onehot + p * (1.0 - onehot)
    focal_w = (alpha * onehot + (1 - alpha) * (1 - onehot)) * pt ** gamma
    bce = logits.clamp_min(0) - logits * onehot + torch.log1p(
        torch.exp(-logits.abs()))
    per_elem = bce * focal_w * class_weights
    per_vox = per_elem.sum(-1) * dist * m
    num, den = batch_sums(per_vox.sum(), m.sum())
    return loss_weight * num / den.clamp_min(1.0) * replica_share()
