"""Volume-rendering primitives as dense static-shape PyTorch ops.

Counterpart of `preworld_tpu/ops/render.py` (same names and semantics):
the ray sampler of the render head and the compositing of its DVGO CUDA
kernels, on the full dense (rays, samples) grid with masks instead of the
reference's dynamic compaction.

  raw2alpha     alpha = 1 - exp(-softplus(density + shift) * interval)
  alpha2weight  exclusive cumprod of (1 - alpha) with the reference's early
                exit: sample i is processed iff its exclusive transmittance
                is at least the threshold
  cumdist_mask  the reference's resetting distance accumulator, a loop over
                the samples on (R,) tensors, without gradient (it is a mask)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class RaySamplingSpec:
    """Static ray-marching geometry (the JAX package's fields and
    defaults)."""

    point_cloud_range: Tuple[float, ...] = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
    radius: float = 39.0
    step_size: float = 0.5
    world_len: int = 200
    alpha_init: float = 1e-6
    early_exit_thres: float = 1e-3

    @property
    def scene_center(self) -> np.ndarray:
        lo = np.array(self.point_cloud_range[:3], np.float32)
        hi = np.array(self.point_cloud_range[3:], np.float32)
        return (lo + hi) * 0.5

    @property
    def bg_len(self) -> float:
        xrange = self.point_cloud_range[3] - self.point_cloud_range[0]
        return (xrange // 2 - self.radius) / self.radius

    @property
    def num_inner(self) -> int:
        return int(2 / (2 + 2 * self.bg_len) * self.world_len / self.step_size) + 1

    @property
    def num_outer(self) -> int:
        return self.num_inner // 15

    @property
    def num_samples(self) -> int:
        return self.num_inner + self.num_outer

    @property
    def t_midpoints(self) -> np.ndarray:
        """Sample distances along the unit-normalised ray."""
        b_inner = np.linspace(0, 2, self.num_inner + 1, dtype=np.float32)
        b_outer = 2.0 / np.linspace(1, 1 / 64, self.num_outer + 1,
                                    dtype=np.float32)
        return np.concatenate([(b_inner[1:] + b_inner[:-1]) * 0.5,
                               (b_outer[1:] + b_outer[:-1]) * 0.5])

    @property
    def xyz_min(self) -> np.ndarray:
        """Normalised field bounds."""
        lo = np.array(self.point_cloud_range[:3], np.float32)
        hi = np.array(self.point_cloud_range[3:], np.float32)
        z_ = (hi[2] - lo[2]) / (hi[0] - lo[0])
        b = self.bg_len
        return np.array([-1 - b, -1 - b, -z_], np.float32)

    @property
    def xyz_max(self) -> np.ndarray:
        return -self.xyz_min

    @property
    def act_shift(self) -> float:
        """Density bias shift so that the initial alpha is `alpha_init`."""
        return float(np.log(1 / (1 - self.alpha_init) - 1))

    @property
    def dist_thres(self) -> float:
        """Oversampling threshold of `cumdist_mask`."""
        return (2 + 2 * self.bg_len) / self.world_len * self.step_size * 0.95


def sample_ray_points(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      bda: torch.Tensor, spec: RaySamplingSpec):
    """March rays through the unit scene and the contracted background.

    rays_o, rays_d: (R, 3) key-ego metres; bda: (3, 3). Returns pts (R, S,
    3) normalised and BEV-augmented, inner_mask (R, S) bool, t (S,).
    """
    dev = rays_o.device
    center = torch.from_numpy(spec.scene_center).to(dev)
    o = (rays_o - center) / spec.radius
    d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    t = torch.from_numpy(spec.t_midpoints).to(dev)
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    norm = torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
    inner = norm <= 1.0
    bg = spec.bg_len
    contracted = pts / norm * ((1 + bg) - bg / norm)
    pts = torch.where(inner, pts, contracted)
    pts = torch.einsum("ij,rsj->rsi", bda, pts)
    return pts, inner[..., 0], t


@torch.no_grad()
def cumdist_mask(pts: torch.Tensor, inner_mask: torch.Tensor,
                 spec: RaySamplingSpec) -> torch.Tensor:
    """Keep-mask that drops oversampled (post-contraction bunched) points:
    the inter-sample distance accumulates, and a sample is kept when the
    running sum exceeds the threshold (the sum then resets). The first
    sample follows `inner_mask`; inner points are always kept."""
    dist = torch.linalg.vector_norm(pts[:, 1:] - pts[:, :-1], dim=-1)
    dist = dist.t().contiguous()  # (S - 1, R): one contiguous row per step
    thres = spec.dist_thres
    cum = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    over = torch.empty(dist.shape, dtype=torch.bool, device=pts.device)
    for i in range(dist.shape[0]):
        cum = cum + dist[i]
        over[i] = cum > thres
        cum = cum * (1.0 - over[i].to(cum.dtype))
    return torch.cat([inner_mask[:, :1], inner_mask[:, 1:] | over.t()], dim=1)


def raw2alpha(density: torch.Tensor, shift: float,
              interval: float) -> torch.Tensor:
    """alpha = 1 - exp(-softplus(density + shift) * interval)."""
    return 1.0 - torch.exp(-F.softplus(density + shift) * interval)


def alpha2weight(alpha: torch.Tensor, mask: torch.Tensor,
                 early_exit_thres: float = 1e-3):
    """Dense transmittance compositing with the reference's early exit.

    alpha: (R, S) opacity; mask: (R, S) bool, masked samples contribute
    nothing and pass transmittance through. Returns weights (R, S) = alpha *
    T_exclusive (zero where not processed) and alphainv_last (R,), the
    transmittance after the last processed sample. The exclusive
    transmittance never increases, so the processed samples are a prefix
    and one cumprod gives both (see the JAX docstring).
    """
    a = torch.where(mask, alpha, torch.zeros_like(alpha))
    t_excl = _exclusive_cumprod(1.0 - a)
    live = t_excl >= early_exit_thres
    weights = torch.where(live, a * t_excl, torch.zeros_like(a))
    t_incl = t_excl * (1.0 - a)
    below = t_incl < early_exit_thres
    first_below = torch.where(below, t_incl,
                              torch.full_like(t_incl, float("-inf"))).amax(dim=1)
    alphainv_last = torch.where(below.any(dim=1), first_below, t_incl[:, -1])
    return weights, alphainv_last


def _exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumprod along dim 1 (T[:, 0] = 1)."""
    return torch.cat([torch.ones_like(x[:, :1]),
                      torch.cumprod(x, dim=1)[:, :-1]], dim=1)
