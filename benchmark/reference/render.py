"""Volume rendering of the pretrain stage, plain PyTorch with autograd.

Rays are marched through the unit scene and the contracted background
(DVGO's sampler), oversampled background points are dropped by the
resetting distance accumulator, the density, semantic and colour fields
are sampled trilinearly, alpha = 1 - exp(-softplus(density + shift) *
0.5), the weights are alpha times the exclusive transmittance with the
early exit at 1e-3 and the `fast_color_thres` cut-offs, and the losses
are the scale-invariant log depth, the class-weighted semantic CE, the L1
colour, the last-transmittance entropy and the distortion, each a masked
mean over a scene's rays with depth above 0, averaged over the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .losses import NUSC_CLASS_FREQUENCIES

# the 16-float ray record: pixel (2), depth, semantic, origin (3),
# direction (3), unit direction (3), colour (3)
DEPTH, SEMANTIC = 2, 3
ORIGIN, DIRECTION, COLOR = slice(4, 7), slice(7, 10), slice(13, 16)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    point_cloud_range: Tuple[float, ...]
    radius: float
    step_size: float
    world_len: int
    weight_depth: float
    weight_semantic: float
    weight_color: float
    weight_entropy_last: float
    weight_distortion: float
    fast_color_thres: float
    max_depth: float
    variance_focus: float
    alpha_init: float = 1e-6
    early_exit_thres: float = 1e-3

    @staticmethod
    def from_sizes(s: Dict) -> "RenderConfig":
        return RenderConfig(**{f.name: (tuple(s[f.name])
                                        if f.name == "point_cloud_range"
                                        else s[f.name])
                               for f in dataclasses.fields(RenderConfig)
                               if f.name in s})

    @property
    def bg_len(self) -> float:
        r = self.point_cloud_range
        return ((r[3] - r[0]) // 2 - self.radius) / self.radius

    @property
    def num_inner(self) -> int:
        return int(2 / (2 + 2 * self.bg_len) * self.world_len
                   / self.step_size) + 1

    def t_midpoints(self) -> np.ndarray:
        n_in, n_out = self.num_inner, self.num_inner // 15
        bi = np.linspace(0, 2, n_in + 1, dtype=np.float32)
        bo = 2.0 / np.linspace(1, 1 / 64, n_out + 1, dtype=np.float32)
        return np.concatenate([(bi[1:] + bi[:-1]) * 0.5,
                               (bo[1:] + bo[:-1]) * 0.5])

    def bounds(self):
        r = self.point_cloud_range
        z = (r[5] - r[2]) / (r[3] - r[0])
        b = self.bg_len
        lo = np.array([-1 - b, -1 - b, -z], np.float32)
        return lo, -lo


def _sample_points(o, d, bda, cfg: RenderConfig):
    r = cfg.point_cloud_range
    center = torch.tensor([(r[0] + r[3]) / 2, (r[1] + r[4]) / 2,
                           (r[2] + r[5]) / 2], device=o.device)
    o = (o - center) / cfg.radius
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    t = torch.from_numpy(cfg.t_midpoints()).to(o.device)
    pts = o[:, None] + d[:, None] * t[None, :, None]
    n = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    inner = n <= 1.0
    b = cfg.bg_len
    pts = torch.where(inner, pts, pts / n * ((1 + b) - b / n))
    return torch.einsum("ij,rsj->rsi", bda, pts), inner[..., 0], t


@torch.no_grad()
def _keep_mask(pts, inner, cfg: RenderConfig):
    thres = (2 + 2 * cfg.bg_len) / cfg.world_len * cfg.step_size * 0.95
    dist = torch.linalg.vector_norm(pts[:, 1:] - pts[:, :-1], dim=-1)
    cum = torch.zeros(pts.shape[0], device=pts.device)
    over = []
    for i in range(dist.shape[1]):
        cum = cum + dist[:, i]
        o = cum > thres
        over.append(o)
        cum = torch.where(o, torch.zeros_like(cum), cum)
    over = torch.stack(over, dim=1)
    return torch.cat([inner[:, :1], inner[:, 1:] | over], dim=1)


def render_scene(field, o, d, bda, mask, cfg: RenderConfig):
    """field (C, X, Y, Z): density, semantic logits, colour. Returns the
    rays' depth, semantic, colour, last transmittance and the scene's
    distortion loss."""
    pts, inner, t = _sample_points(o, d, bda, cfg)
    keep = _keep_mask(pts, inner, cfg)
    lo, hi = (torch.from_numpy(a).to(o.device) for a in cfg.bounds())
    g = ((pts - lo) / (hi - lo) * 2 - 1).flip(-1)
    R, S = pts.shape[:2]
    smp = F.grid_sample(field[None], g.reshape(1, R, S, 1, 3),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)[0, ..., 0]  # (C, R, S)
    shift = float(np.log(1 / (1 - cfg.alpha_init) - 1))
    alpha = 1.0 - torch.exp(-F.softplus(smp[0] + shift) * 0.5)
    keep = keep & (alpha > cfg.fast_color_thres)
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    t_ex = torch.cat([torch.ones_like(a[:, :1]),
                      torch.cumprod(1.0 - a, dim=1)[:, :-1]], dim=1)
    w = torch.where(t_ex >= cfg.early_exit_thres, a * t_ex,
                    torch.zeros_like(a))
    t_in = t_ex * (1.0 - a)
    below = t_in < cfg.early_exit_thres
    first = torch.where(below, t_in, torch.full_like(t_in, -float("inf")))
    last = torch.where(below.any(dim=1), first.amax(dim=1), t_in[:, -1])
    live = w > cfg.fast_color_thres
    w = torch.where(live, w, torch.zeros_like(w))
    s = 1.0 - 1.0 / (1.0 + t)
    depth = (w * s).sum(dim=1) * cfg.radius + 1e-7
    sem = torch.einsum("rs,crs->rc", w, smp[1:-3])
    col = torch.einsum("rs,crs->rc", w, smp[-3:])
    # distortion: 2 sum_{i<j} w_i w_j (s_j - s_i) + 1/3 sum w_i^2 / n
    wm = w * mask[:, None]
    pw = torch.cumsum(wm, dim=1) - wm
    pws = torch.cumsum(wm * s, dim=1) - wm * s
    bi = (wm * (s * pw - pws)).sum()
    n_max = (live * mask[:, None]).sum().clamp_min(1.0)
    n_rays = mask.sum().clamp_min(1.0)
    dist = (2.0 * bi + (1.0 / 3.0) / n_max * (wm * wm).sum()) / n_rays
    return depth, sem, col, last, dist


def render_losses(density, semantic, color, rays, bda,
                  cfg: RenderConfig) -> Dict[str, torch.Tensor]:
    """density (B, X, Y, Z), semantic (B, X, Y, Z, 17), color (B, X, Y,
    Z, 3), rays (B, R, 16), bda (B, 3, 3) -> the weighted losses."""
    gt_d = rays[..., DEPTH]
    gt_d = torch.where(gt_d > cfg.max_depth, torch.zeros_like(gt_d), gt_d)
    mask = (gt_d > 0).float()
    n_sem = semantic.shape[-1]
    cw = torch.from_numpy((1.0 / np.log(NUSC_CLASS_FREQUENCIES[:n_sem]
                                        + 0.001)).astype(np.float32)
                          if n_sem == 17 else
                          np.ones(n_sem, np.float32) / n_sem).to(rays.device)
    B = rays.shape[0]
    acc: Dict[str, torch.Tensor] = {}
    for i in range(B):
        field = torch.cat([density[i][..., None], semantic[i], color[i]],
                          dim=-1).permute(3, 0, 1, 2)
        m = mask[i]
        depth, sem, col, last, dist = render_scene(
            field, rays[i, :, ORIGIN], rays[i, :, DIRECTION], bda[i], m, cfg)
        n = m.sum().clamp_min(1.0)
        dl = (torch.log(depth + 1e-7) - torch.log(gt_d[i].clamp_min(1e-8))) * m
        mean_sq, mean = (dl * dl).sum() / n, dl.sum() / n
        tgt = rays[i, :, SEMANTIC].long().clamp(0, n_sem - 1)
        ce = -torch.gather(torch.log_softmax(sem, -1), 1, tgt[:, None])[:, 0]
        wt = cw[tgt] * m
        p = last.clamp(1e-6, 1 - 1e-6)
        ent = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
        scene = {
            "loss_render_depth": cfg.weight_depth * torch.sqrt(
                (mean_sq - cfg.variance_focus * mean * mean).clamp_min(1e-12)),
            "loss_render_semantic": cfg.weight_semantic
            * (ce * wt).sum() / wt.sum().clamp_min(1e-8),
            "loss_render_color": cfg.weight_color
            * ((col - rays[i, :, COLOR]).abs() * m[:, None]).sum() / n,
            "loss_sdf_entropy": cfg.weight_entropy_last * (ent * m).sum() / n,
            "loss_sdf_distortion": cfg.weight_distortion * dist,
        }
        for k, v in scene.items():
            acc[k] = acc.get(k, 0.0) + v
    return {k: v / B for k, v in acc.items()}
