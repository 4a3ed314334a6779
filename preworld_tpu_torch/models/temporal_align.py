"""Ego-motion alignment of a cached voxel feature (streaming inference).

Counterpart of `preworld_tpu/models/temporal_align.py`: `ego_motion_grid`
and `shift_voxel_feature` warp the previous frame's voxel feature into the
current key ego by the planar (x, y) motion between the two camera-0 poses,
with the BEV augmentation folded into both. The JAX package samples with
its TPU gather `ops/grid_sample.py::grid_sample_2d`; the port calls
`F.grid_sample` (bilinear, zeros padding, align_corners=True), the same
function. Everything here is f32: callers cast the feature to f32 first,
since a bf16 sample would round the bilinear weights.

Voxel grids are channel-last (B, Z, Y, X, C); one warp serves every z
slice (the z row and column of the 4x4 motion are dropped).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.frustum import GridConfig


def ego_motion_grid(curr_s2keyego: torch.Tensor, prev_s2keyego: torch.Tensor,
                    bda: torch.Tensor, grid: GridConfig) -> torch.Tensor:
    """Normalised sampling grid (B, Y, X, 2) that maps each current BEV cell
    into the previous frame's BEV feature.

    curr_s2keyego / prev_s2keyego: (B, N, 4, 4) f32, camera 0 is used;
    bda: (B, 3, 3) f32.
    """
    B = curr_s2keyego.shape[0]
    dev = curr_s2keyego.device
    sx, sy, _ = (int(v) for v in grid.size)
    bda4 = torch.zeros((B, 1, 4, 4), dtype=torch.float32, device=dev)
    bda4[:, :, :3, :3] = bda[:, None]
    bda4[:, :, 3, 3] = 1.0
    c02l0 = bda4 @ curr_s2keyego[:, 0:1]
    c12l0 = bda4 @ prev_s2keyego[:, 0:1]
    # the bda may scale, so a general inverse (inv_ex: no host sync)
    l02l1 = (c02l0 @ torch.linalg.inv_ex(c12l0)[0])[:, 0]  # (B, 4, 4)
    keep = torch.tensor([0, 1, 3], device=dev)
    l02l1 = l02l1[:, keep][:, :, keep]  # (B, 3, 3)
    (ix, iy, _), (lx, ly, _) = grid.interval, grid.lower
    feat2bev = torch.tensor([[ix, 0.0, lx], [0.0, iy, ly], [0.0, 0.0, 1.0]],
                            dtype=torch.float32, device=dev)
    bev2feat = torch.tensor(
        [[1.0 / ix, 0.0, -lx / ix], [0.0, 1.0 / iy, -ly / iy],
         [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    tf = bev2feat @ l02l1 @ feat2bev
    gy, gx = torch.meshgrid(
        torch.arange(sy, dtype=torch.float32, device=dev),
        torch.arange(sx, dtype=torch.float32, device=dev), indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    warped = torch.einsum("bij,pj->bpi", tf, pts)
    norm = torch.tensor([sx - 1.0, sy - 1.0], dtype=torch.float32,
                        device=dev)
    g = warped[..., :2] / norm * 2.0 - 1.0
    return g.reshape(B, sy, sx, 2)


def shift_voxel_feature(feat: torch.Tensor, curr_s2keyego: torch.Tensor,
                        prev_s2keyego: torch.Tensor, bda: torch.Tensor,
                        grid: GridConfig) -> torch.Tensor:
    """Warp a (B, Z, Y, X, C) f32 voxel feature by the planar ego motion of
    `ego_motion_grid`; out-of-grid samples read zeros."""
    B, Z, Y, X, C = feat.shape
    g = ego_motion_grid(curr_s2keyego, prev_s2keyego, bda, grid)
    inp = feat.permute(0, 1, 4, 2, 3).reshape(B, Z * C, Y, X)
    out = F.grid_sample(inp, g, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.reshape(B, Z, C, Y, X).permute(0, 1, 3, 4, 2)
