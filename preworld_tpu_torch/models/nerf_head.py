"""Volume-rendering supervision head (parameter-free renderer + losses).

Counterpart of `preworld_tpu/models/nerf_head.py`: `NerfHeadConfig`,
`nusc_class_weights`, `render_scene`, `_weighted_ce`, `_silog` and
`nerf_head_losses`. Rays arrive as a fixed-size (R, 16) array
(`geometry.rays`); the reference's dynamic compactions are masks, and its
`fast_color_thres` cutoffs zero alpha and weights below the threshold.

The density, semantic and colour fields are sampled together as one
(1, 21, X, Y, Z) f32 field with `F.grid_sample` 3-D (trilinear,
align_corners=True, zeros padding) at the normalised points flipped to
(z, y, x): the semantics of the JAX package's oracle `_sample_field`. The
JAX corner-table gather (`ops/field_sample.py`) and its two tuning fields
`table_dtype` and `bwd_live_cap` are TPU layouts of the same exact
function and are not carried over; nor is the ray split over a device mesh.
`F.grid_sample`'s backward adds into the field with atomics, so gradients
differ from run to run in the last bits.

The render keeps the JAX package's residual policy (its
`save_only_these_names("render_sampled", "render_keep")`): autograd saves
the (21, R, S) f32 sampled field and the (R, S) bool keep mask of the
416-step `cumdist_mask` loop, besides the field and the rays; the backward
recomputes the ray geometry (and from it the sampling grid, 12 R S bytes
never kept) and the compositing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry import rays as ray_layout
from ..losses.voxel import nusc_class_weights
from ..ops.render import (
    RaySamplingSpec,
    alpha2weight,
    cumdist_mask,
    raw2alpha,
    sample_ray_points,
)


@dataclasses.dataclass(frozen=True)
class NerfHeadConfig:
    """The JAX `NerfHeadConfig` less `table_dtype` and `bwd_live_cap`.
    ray_chunk > 0 renders the rays in chunks of that many (a memory
    fallback: each chunk's forward and backward intermediates live one at
    a time); 0 renders densely."""

    spec: RaySamplingSpec = RaySamplingSpec()
    use_depth_sup: bool = True
    weight_depth: float = 1.0
    weight_semantic: float = 1.0
    weight_color: float = 1.0
    weight_entropy_last: float = 0.01
    weight_distortion: float = 0.01
    fast_color_thres: float = 1e-7
    balance_cls_weight: bool = True
    max_depth: float = 52.0
    variance_focus: float = 0.85
    ray_chunk: int = 0


def render_scene(density, semantic, color, rays_o, rays_d, bda,
                 cfg: NerfHeadConfig, ray_mask=None) -> Dict[str, torch.Tensor]:
    """Render depth, semantic and colour for R rays against one voxel
    scene: density (X, Y, Z), semantic (X, Y, Z, n), color (X, Y, Z, 3)
    f32; rays_o, rays_d (R, 3); bda (3, 3); ray_mask (R,) f32 or None.
    Returns render_depth (R,), render_semantic (R, n), render_color (R, 3),
    alphainv_last (R,) and the scalar loss_distortion (reduced over the
    masked rays)."""
    R = rays_o.shape[0]
    chunk = min(cfg.ray_chunk, R) if cfg.ray_chunk > 0 else R
    if R % chunk:  # one pass for sizes the chunk does not divide
        chunk = R
    if ray_mask is None:
        ray_mask = torch.ones((R,), dtype=torch.float32, device=rays_o.device)
    field = torch.cat([density[..., None], semantic, color], dim=-1)
    field = field.permute(3, 0, 1, 2)[None].contiguous()  # (1, 21, X, Y, Z)
    parts = [dict(zip(_OUT_KEYS, _RenderRays.apply(
        field, rays_o[i:i + chunk], rays_d[i:i + chunk], bda,
        ray_mask[i:i + chunk], cfg))) for i in range(0, R, chunk)]
    out = {k: (sum(p[k] for p in parts) if k.startswith("dist_")
               else torch.cat([p[k] for p in parts])) for k in _OUT_KEYS}
    # distortion (flatten_eff_distloss): interval 1 / n_max with n_max the
    # surviving supervised samples scene-wide, normalised by the number of
    # supervised rays
    n_max = out.pop("dist_live").clamp_min(1.0)
    n_rays = ray_mask.sum().clamp_min(1.0)
    out["loss_distortion"] = (2.0 * out.pop("dist_bi")
                              + (1.0 / 3.0) / n_max * out.pop("dist_w2")) / n_rays
    return out


_OUT_KEYS = ("render_depth", "render_semantic", "render_color",
             "alphainv_last", "dist_bi", "dist_w2", "dist_live")


class _RenderRays(torch.autograd.Function):
    """The rays' render against a (1, 21, X, Y, Z) field, differentiable
    in the field only (rays, bda and ray mask are data), saving the sampled
    field and the keep mask; returns the `_OUT_KEYS` values."""

    @staticmethod
    def forward(ctx, field, rays_o, rays_d, bda, ray_mask, cfg):
        if any(ctx.needs_input_grad[1:5]):
            raise ValueError("render_scene: rays, bda and ray_mask take no "
                             "gradient")
        pts, inner, t = sample_ray_points(rays_o, rays_d, bda, cfg.spec)
        keep = cumdist_mask(pts, inner, cfg.spec)
        sampled = F.grid_sample(field, _field_grid(pts, cfg.spec),
                                mode="bilinear", padding_mode="zeros",
                                align_corners=True)[0, ..., 0]  # (21, R, S)
        out, _ = _composite(sampled[0], sampled[1:], keep, t, ray_mask, cfg)
        ctx.save_for_backward(field, sampled, keep, rays_o, rays_d, bda,
                              ray_mask)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(out["dist_live"])
        return tuple(out[k] for k in _OUT_KEYS)

    @staticmethod
    def backward(ctx, *grads):
        field, sampled, keep, rays_o, rays_d, bda, ray_mask = ctx.saved_tensors
        spec = ctx.cfg.spec
        g = dict(zip(_OUT_KEYS, grads))
        t = torch.from_numpy(spec.t_midpoints).to(sampled.device)
        with torch.enable_grad():
            dens = sampled[0].detach().requires_grad_(True)
            out, weights = _composite(dens, sampled[1:], keep, t, ray_mask,
                                      ctx.cfg)
            outs, cts = zip(*[(out[k], g[k]) for k in _OUT_KEYS
                              if out[k].requires_grad])
            d_dens, = torch.autograd.grad(outs, dens, cts)
        # the samples' gradient overwrites the saved samples, which nothing
        # reads any more: no second (21, R, S) buffer. Semantic and colour
        # enter the render linearly (sum over s of weights * value), so
        # their rows are weights times the cotangent.
        weights = weights.detach()
        nsem = g["render_semantic"].shape[1]
        sampled[0] = d_dens
        torch.mul(weights[None], g["render_semantic"].t()[..., None],
                  out=sampled[1:1 + nsem])
        torch.mul(weights[None], g["render_color"].t()[..., None],
                  out=sampled[1 + nsem:])
        del out, outs, weights, d_dens
        pts, _, _ = sample_ray_points(rays_o, rays_d, bda, spec)
        d_field, _ = torch.ops.aten.grid_sampler_3d_backward(
            sampled[None, ..., None], field, _field_grid(pts, spec),
            0, 0, True, [True, False])  # bilinear, zeros, align_corners
        return d_field, None, None, None, None, None


def _field_grid(pts, spec):
    """grid_sample's (1, R, S, 1, 3) grid of the normalised points, as
    (z, y, x)."""
    lo = torch.from_numpy(spec.xyz_min).to(pts.device)
    span = torch.from_numpy(spec.xyz_max - spec.xyz_min).to(pts.device)
    pts_norm = (pts - lo) / span * 2.0 - 1.0
    R, S = pts.shape[:2]
    return pts_norm.flip(-1).reshape(1, R, S, 1, 3)


def _composite(dens, values, keep, t, ray_mask, cfg):
    """Depth, semantic and colour of the rays from their sampled density
    (R, S) and semantic + colour values (n + 3, R, S), keep mask (R, S) and
    sample distances t (S,), and the distortion partial sums; and the
    compositing weights (R, S)."""
    spec = cfg.spec
    sem = values[:-3]
    col = values[-3:]

    alpha = raw2alpha(dens, spec.act_shift, interval=0.5)
    if cfg.fast_color_thres > 0:
        keep = keep & (alpha > cfg.fast_color_thres)
    weights, alphainv_last = alpha2weight(alpha, keep, spec.early_exit_thres)
    if cfg.fast_color_thres > 0:
        live = weights > cfg.fast_color_thres
        weights = torch.where(live, weights, torch.zeros_like(weights))
    else:
        live = keep

    s = 1.0 - 1.0 / (1.0 + t)  # (S,)
    render_depth = (weights * s[None, :]).sum(dim=1) * spec.radius + 1e-7
    render_sem = torch.einsum("rs,crs->rc", weights, sem)
    render_col = torch.einsum("rs,crs->rc", weights, col)

    # distortion partial sums (chunk-additive): the bilateral term through
    # prefix sums, so the (S, S) pairwise product never materialises
    w = weights * ray_mask[:, None]
    sb = s[None, :]
    wm = w * sb
    w_prefix = torch.cumsum(w, dim=1) - w
    wm_prefix = torch.cumsum(wm, dim=1) - wm
    return {
        "render_depth": render_depth,
        "render_semantic": render_sem,
        "render_color": render_col,
        "alphainv_last": alphainv_last,
        "dist_bi": (w * (sb * w_prefix - wm_prefix)).sum(),
        "dist_w2": (w * w).sum(),
        "dist_live": (live * ray_mask[:, None]).sum(),
    }, weights


def _weighted_ce(logits, targets, class_w, mask):
    """torch CrossEntropyLoss(weight=w, reduction='mean') with a ray mask:
    sum(w[t] * ce) / sum(w[t]) over masked rays. Labels are clipped before
    the gather: masked rays may carry out-of-range labels."""
    logp = torch.log_softmax(logits, dim=-1)
    t = targets.long().clamp(0, class_w.shape[0] - 1)
    ce = -torch.gather(logp, 1, t[:, None])[:, 0]
    w = class_w[t] * mask
    return (ce * w).sum() / w.sum().clamp_min(1e-8)


def _silog(est, gt, mask, variance_focus: float):
    """Scale-invariant log depth loss, masked."""
    d = (torch.log(est) - torch.log(gt.clamp_min(1e-8))) * mask
    n = mask.sum().clamp_min(1.0)
    mean_sq = (d * d).sum() / n
    mean = d.sum() / n
    return torch.sqrt((mean_sq - variance_focus * mean * mean).clamp_min(1e-12))


def nerf_head_losses(density, semantic, color, rays, bda,
                     cfg: NerfHeadConfig) -> Dict[str, torch.Tensor]:
    """Rendering losses averaged over the batch: density (B, X, Y, Z),
    semantic (B, X, Y, Z, 17), color (B, X, Y, Z, 3); rays (B, R, 16)
    (`geometry.rays` layout); bda (B, 3, 3). Keys: loss_render_depth (with
    `use_depth_sup`), loss_render_semantic, loss_render_color,
    loss_sdf_entropy and loss_sdf_distortion (at weights above 0)."""
    gt_depth = rays[..., ray_layout.DEPTH]
    gt_depth = torch.where(gt_depth > cfg.max_depth,
                           torch.zeros_like(gt_depth), gt_depth)
    gt_sem = rays[..., ray_layout.SEMANTIC]
    gt_color = rays[..., ray_layout.COLOR]
    ray_mask = (gt_depth > 0).float()
    n_sem = semantic.shape[-1]
    class_w = torch.from_numpy(
        nusc_class_weights(n_sem) if cfg.balance_cls_weight and n_sem == 17
        else np.ones(n_sem, np.float32) / n_sem).to(rays.device)

    B = rays.shape[0]
    acc: Dict[str, torch.Tensor] = {}
    for i in range(B):
        out = render_scene(density[i], semantic[i], color[i],
                           rays[i, :, ray_layout.ORIGIN],
                           rays[i, :, ray_layout.DIRECTION], bda[i], cfg,
                           ray_mask[i])
        m = ray_mask[i]
        n = m.sum().clamp_min(1.0)
        losses = {}
        if cfg.use_depth_sup:
            losses["loss_render_depth"] = cfg.weight_depth * _silog(
                out["render_depth"] + 1e-7, gt_depth[i], m, cfg.variance_focus)
        losses["loss_render_semantic"] = cfg.weight_semantic * _weighted_ce(
            out["render_semantic"], gt_sem[i], class_w, m)
        # l1 colour: the sum over channels of the masked mean
        diff = (out["render_color"] - gt_color[i]).abs() * m[:, None]
        losses["loss_render_color"] = cfg.weight_color * (
            diff.sum(dim=0) / n).sum()
        if cfg.weight_entropy_last > 0:
            pout = out["alphainv_last"].clamp(1e-6, 1 - 1e-6)
            ent = -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout))
            losses["loss_sdf_entropy"] = cfg.weight_entropy_last * (
                (ent * m).sum() / n)
        if cfg.weight_distortion > 0:
            losses["loss_sdf_distortion"] = (cfg.weight_distortion
                                             * out["loss_distortion"])
        for k, v in losses.items():
            acc[k] = acc.get(k, 0.0) + v
    return {k: v / B for k, v in acc.items()}
