"""Frustum creation and camera -> ego -> voxel coordinate math.

Counterpart of `preworld_tpu/geometry/frustum.py`. `GridConfig` and
`create_frustum` are numpy (identical fields, defaults and values);
`frustum_to_lidar` and `voxel_indices` work on torch tensors and follow the
JAX op order so the f32 voxel ids agree exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Voxel grid + depth-bin configuration: x/y/z and depth are
    (lower, upper, interval) in metres."""

    x: Tuple[float, float, float] = (-40.0, 40.0, 0.4)
    y: Tuple[float, float, float] = (-40.0, 40.0, 0.4)
    z: Tuple[float, float, float] = (-1.0, 5.4, 0.4)
    depth: Tuple[float, float, float] = (1.0, 45.0, 0.5)

    @property
    def lower(self) -> np.ndarray:
        return np.array([self.x[0], self.y[0], self.z[0]], np.float32)

    @property
    def interval(self) -> np.ndarray:
        return np.array([self.x[2], self.y[2], self.z[2]], np.float32)

    @property
    def size(self) -> np.ndarray:
        """Number of voxels along (x, y, z)."""
        return np.array(
            [
                round((self.x[1] - self.x[0]) / self.x[2]),
                round((self.y[1] - self.y[0]) / self.y[2]),
                round((self.z[1] - self.z[0]) / self.z[2]),
            ],
            np.int32,
        )

    @property
    def num_depth_bins(self) -> int:
        lo, hi, step = self.depth
        return int(np.ceil((hi - lo) / step - 1e-6))

    @property
    def num_voxels(self) -> int:
        sx, sy, sz = self.size
        return int(sx) * int(sy) * int(sz)


def create_frustum(grid: GridConfig, input_size: Tuple[int, int],
                   downsample: int) -> np.ndarray:
    """(D, Hf, Wf, 3) float32 template of (u, v, depth) per feature cell:
    pixel coords linspace over the input resolution, depth bins
    arange(lo, hi, step)."""
    h_in, w_in = input_size
    h_feat, w_feat = h_in // downsample, w_in // downsample
    lo, hi, step = grid.depth
    d = np.arange(lo, hi, step, dtype=np.float32)
    num_d = d.shape[0]
    d = np.broadcast_to(d[:, None, None], (num_d, h_feat, w_feat))
    x = np.linspace(0, w_in - 1, w_feat, dtype=np.float32)
    x = np.broadcast_to(x[None, None, :], (num_d, h_feat, w_feat))
    y = np.linspace(0, h_in - 1, h_feat, dtype=np.float32)
    y = np.broadcast_to(y[None, :, None], (num_d, h_feat, w_feat))
    return np.stack([x, y, d], axis=-1)


def frustum_to_lidar(frustum, sensor2ego, cam2img, post_rot, post_tran, bda):
    """Project frustum (u, v, depth) points into (bda-augmented) ego space.

    frustum (D, Hf, Wf, 3); sensor2ego (B, N, 4, 4); cam2img, post_rot
    (B, N, 3, 3); post_tran (B, N, 3); bda (B, 3, 3).
    Returns (B, N, D, Hf, Wf, 3):
      inv(post_rot) @ (p - post_tran), lift (u d, v d, d),
      (sensor2ego[:3, :3] @ inv(cam2img)) @ p + sensor2ego[:3, 3], bda @ p.
    """
    pts = frustum[None, None] - post_tran[:, :, None, None, None, :]
    # inv_ex: linalg.inv would synchronise with the device to check errors
    inv_post = torch.linalg.inv_ex(post_rot).inverse
    pts = torch.einsum("bnij,bndhwj->bndhwi", inv_post, pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = sensor2ego[:, :, :3, :3] @ torch.linalg.inv_ex(cam2img).inverse
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    pts = pts + sensor2ego[:, :, None, None, None, :3, 3]
    pts = torch.einsum("bij,bndhwj->bndhwi", bda, pts)
    return pts


def voxel_indices(coor, grid: GridConfig):
    """(B, N, D, H, W, 3) ego points -> (B, N, D, H, W) int32 flat voxel id,
    rank = b*Z*Y*X + z*Y*X + y*X + x; out-of-range points get the sentinel
    B*Z*Y*X."""
    B = coor.shape[0]
    sx, sy, sz = (int(v) for v in grid.size)

    def const(v):
        # a 0-dim tensor on coor's device made by a fill kernel: no
        # host-to-device copy (which would synchronise), and a true division
        # (CUDA divides by a host scalar through its reciprocal)
        return torch.full((), float(v), dtype=coor.dtype, device=coor.device)

    x, y, z = (
        torch.floor((coor[..., i] - const(grid.lower[i]))
                    / const(grid.interval[i])).to(torch.int32)
        for i in range(3))
    valid = (x >= 0) & (x < sx) & (y >= 0) & (y < sy) & (z >= 0) & (z < sz)
    batch_idx = torch.arange(B, dtype=torch.int32, device=coor.device).reshape(
        (B,) + (1,) * (coor.dim() - 2))
    rank = batch_idx * (sz * sy * sx) + z * (sy * sx) + y * sx + x
    sentinel = B * sz * sy * sx
    return torch.where(valid, rank, torch.full_like(rank, sentinel))


def frustum_pixel_indices(batch: int, num_cams: int, num_depth: int,
                          h_feat: int, w_feat: int) -> np.ndarray:
    """(B, N, D, Hf, Wf) int32 flat (B*N*Hf*Wf) context-pixel index of each
    frustum point."""
    pix = np.arange(batch * num_cams * h_feat * w_feat, dtype=np.int32).reshape(
        batch, num_cams, 1, h_feat, w_feat)
    return np.broadcast_to(
        pix, (batch, num_cams, num_depth, h_feat, w_feat)).copy()
