"""Occupancy and depth losses of the reference, plain PyTorch.

Finetune: the distance-weighted sigmoid focal loss (gamma 2, alpha 0.25,
weight 100, class weights 1 / log(frequency), empty class 0), the
class-wise semantic scal loss, the geometric scal loss and Lovasz-softmax
(empty class ignored, classes present). Pretrain: BEVDepth's BCE of the
key frame's depth against the min-pooled lidar depth, over pixels with a
depth bin.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NUSC_CLASS_FREQUENCIES = np.array(
    [1163161, 2309034, 188743, 2997643, 20317180, 852476, 243808, 2457947,
     497017, 2731022, 7224789, 214411435, 5565043, 63191967, 76098082,
     128860031, 141625221, 2307405309], np.float64)


def class_weights(num_classes: int) -> np.ndarray:
    w = (1.0 / np.log(NUSC_CLASS_FREQUENCIES[:num_classes - 1] + 0.001))
    return np.concatenate([w, [0.0]]).astype(np.float32)


def focal_loss(logits, target, cw, gamma=2.0, alpha=0.25, weight=100.0):
    B, X, Y, Z, C = logits.shape
    dev = logits.device
    xs = torch.arange(X, dtype=torch.float32, device=dev) - X / 2
    ys = torch.arange(Y, dtype=torch.float32, device=dev) - Y / 2
    r = torch.sqrt(xs[:, None] ** 2 + ys[None, :] ** 2)
    dist = (r / r.max() + 1.0)[None, :, :, None]
    onehot = F.one_hot(target, C).float()
    p = torch.sigmoid(logits)
    pt = (1 - p) * onehot + p * (1 - onehot)
    fw = (alpha * onehot + (1 - alpha) * (1 - onehot)) * pt ** gamma
    bce = F.binary_cross_entropy_with_logits(logits, onehot, reduction="none")
    per_vox = (bce * fw * cw).sum(-1) * dist
    return weight * per_vox.sum() / float(target.numel())


def _nll_ratio(r):
    return -torch.log(r.clamp(1e-12, 1.0))


def sem_scal_loss(logits, target):
    C = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    loss, count = logits.new_zeros(()), 0
    for c in range(C):
        pc = p[..., c]
        is_c = (target == c).float()
        n_fg = is_c.sum()
        if n_fg == 0:
            continue
        nom = (pc * is_c).sum()
        lc = _nll_ratio(nom / n_fg)
        if pc.sum() > 0:
            lc = lc + _nll_ratio(nom / pc.sum())
        n_bg = (1 - is_c).sum()
        if n_bg > 0:
            lc = lc + _nll_ratio(((1 - pc) * (1 - is_c)).sum() / n_bg)
        loss = loss + lc
        count += 1
    return loss / max(count, 1)


def geo_scal_loss(logits, target, empty: int):
    p_empty = torch.softmax(logits, dim=-1)[..., empty]
    p_occ = 1 - p_empty
    m = (target != empty).float()
    inter = (m * p_occ).sum()
    return (_nll_ratio(inter / p_occ.sum()) + _nll_ratio(inter / m.sum())
            + _nll_ratio(((1 - m) * p_empty).sum() / (1 - m).sum()))


def lovasz_softmax(logits, target, ignore: int):
    C = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1).reshape(-1, C)
    t = target.reshape(-1)
    keep = t != ignore
    probs, t = probs[keep], t[keep]
    losses = []
    for c in range(C):
        fg = (t == c).float()
        if fg.sum() == 0:
            continue
        err = (fg - probs[:, c]).abs()
        err_s, order = torch.sort(err, descending=True)
        fg_s = fg[order]
        gts = fg_s.sum()
        inter = gts - fg_s.cumsum(0)
        union = gts + (1 - fg_s).cumsum(0)
        jac = 1 - inter / union
        grad = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append((err_s * grad).sum())
    return torch.stack(losses).mean()


def voxel_losses(logits, target, num_classes: int):
    empty = num_classes - 1
    cw = torch.from_numpy(class_weights(num_classes)).to(logits.device)
    return {
        "loss_voxel_ce": focal_loss(logits, target, cw),
        "loss_voxel_sem": sem_scal_loss(logits, target),
        "loss_voxel_geo": geo_scal_loss(logits, target, empty),
        "loss_voxel_lovasz": lovasz_softmax(logits, target, empty),
    }


def depth_bce_loss(depth, gt, downsample: int, grid, weight: float):
    """depth (B, N, D, Hf, Wf) softmaxed; gt (B, N, H, W), 0 = no lidar."""
    B, N, H, W = gt.shape
    D = grid.num_depth_bins
    x = gt.reshape(B * N, H // downsample, downsample, W // downsample,
                   downsample).permute(0, 1, 3, 2, 4)
    x = x.reshape(-1, downsample * downsample)
    x = torch.where(x == 0, torch.full_like(x, 1e5), x).amin(dim=-1)
    lo, _, step = grid.depth
    idx = (x - (lo - step)) / step
    idx = torch.where((idx < D + 1) & (idx >= 0), idx,
                      torch.zeros_like(idx)).long()
    labels = F.one_hot(idx, D + 1).float()[:, 1:]
    pred = depth.permute(0, 1, 3, 4, 2).reshape(-1, D).clamp(1e-7, 1 - 1e-7)
    fg = labels.amax(dim=1) > 0
    bce = -(labels * torch.log(pred) + (1 - labels) * torch.log(1 - pred))
    return weight * (bce.sum(dim=1) * fg).sum() / fg.sum().clamp_min(1)
