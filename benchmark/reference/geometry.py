"""Camera geometry of the reference: frustum, voxel ids, pose chains, the
stereo warp grid and cost volume, voxel pooling and the ego-motion warp.

Plain float32 PyTorch (numpy for the static templates). The stereo cost
volume is the grid form: each plane's warp of the current frame's
frustum into the previous image as a normalised grid, bilinear samples of
the previous feature (align_corners, zeros outside), the channel sum of
|current - sample|, plus `bias` where the sample's channel C - 4 reads 0,
then softmax(-cost) over the planes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Grid:
    """x / y / z / depth as (lower, upper, interval) in metres."""

    x: Tuple[float, float, float]
    y: Tuple[float, float, float]
    z: Tuple[float, float, float]
    depth: Tuple[float, float, float]

    @property
    def lower(self):
        return np.array([self.x[0], self.y[0], self.z[0]], np.float32)

    @property
    def interval(self):
        return np.array([self.x[2], self.y[2], self.z[2]], np.float32)

    @property
    def size(self):
        return tuple(int(round((a[1] - a[0]) / a[2]))
                     for a in (self.x, self.y, self.z))

    @property
    def num_depth_bins(self) -> int:
        lo, hi, step = self.depth
        return int(np.ceil((hi - lo) / step - 1e-6))

    @property
    def num_voxels(self) -> int:
        sx, sy, sz = self.size
        return sx * sy * sz


def create_frustum(grid: Grid, input_size, downsample: int) -> np.ndarray:
    """(D, Hf, Wf, 3) f32 (u, v, depth) per feature cell."""
    h_in, w_in = input_size
    hf, wf = h_in // downsample, w_in // downsample
    d = np.arange(*grid.depth, dtype=np.float32)
    D = d.shape[0]
    d = np.broadcast_to(d[:, None, None], (D, hf, wf))
    x = np.broadcast_to(np.linspace(0, w_in - 1, wf, dtype=np.float32)
                        [None, None, :], (D, hf, wf))
    y = np.broadcast_to(np.linspace(0, h_in - 1, hf, dtype=np.float32)
                        [None, :, None], (D, hf, wf))
    return np.stack([x, y, d], axis=-1)


def invert_rigid(m):
    r = m[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., :3, :3] = r
    out[..., :3, 3:] = -r @ m[..., :3, 3:]
    out[..., 3, 3] = 1.0
    return out


def sensor2keyego(s2e, e2g):
    """(B, T, N, 4, 4) -> each sensor in the key frame's (frame 0, camera
    0) ego."""
    return (invert_rigid(e2g[:, 0:1, 0:1]) @ e2g @ s2e).float()


def curr2adjsensor(s2e, e2g, temporal_frames: int):
    """(B, T', N, 4, 4): the sensor of frame t -> the sensor of frame t+1."""
    t = temporal_frames
    return (invert_rigid(e2g[:, 1:t + 1] @ s2e[:, 1:t + 1])
            @ e2g[:, :t] @ s2e[:, :t]).float()


def own_ego(s2e, e2g):
    """One frame's (B, N, 4, 4) poses -> each sensor in that frame's own
    ego (camera 0's)."""
    return (invert_rigid(e2g[:, 0:1]) @ e2g @ s2e).float()


def frustum_to_ego(frustum, s2e, intrin, post_rot, post_tran, bda):
    """(B, N, D, Hf, Wf, 3) ego points of the frustum."""
    pts = frustum[None, None] - post_tran[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", torch.linalg.inv(post_rot),
                       pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    comb = s2e[:, :, :3, :3] @ torch.linalg.inv(intrin)
    pts = torch.einsum("bnij,bndhwj->bndhwi", comb, pts)
    pts = pts + s2e[:, :, None, None, None, :3, 3]
    return torch.einsum("bij,bndhwj->bndhwi", bda, pts)


def voxel_ids(pts, grid: Grid):
    """(B, N, D, H, W) int64 flat ids b*Z*Y*X + z*Y*X + y*X + x, and -1 for
    a point outside the grid."""
    B = pts.shape[0]
    sx, sy, sz = grid.size
    lo = torch.tensor(grid.lower, device=pts.device)
    iv = torch.tensor(grid.interval, device=pts.device)
    ijk = torch.floor((pts - lo) / iv).long()
    x, y, z = ijk.unbind(-1)
    ok = (x >= 0) & (x < sx) & (y >= 0) & (y < sy) & (z >= 0) & (z < sz)
    b = torch.arange(B, device=pts.device).reshape(
        (B,) + (1,) * (pts.dim() - 2))
    rank = b * (sz * sy * sx) + z * (sy * sx) + y * sx + x
    return torch.where(ok, rank, torch.full_like(rank, -1))


def bev_pool(depth, feat, ids, num_voxels: int):
    """Lift-splat: out[v] = sum over points p with id v of depth[p] *
    feat[pixel of p]. depth (B, N, D, Hf, Wf); feat (B, N, Hf, Wf, C);
    ids (B, N, D, Hf, Wf), -1 dropped. -> (num_voxels, C)."""
    C = feat.shape[-1]
    prod = depth[..., None] * feat[:, :, None]  # (B, N, D, Hf, Wf, C)
    prod = prod.reshape(-1, C)
    ids = ids.reshape(-1)
    keep = ids >= 0
    out = torch.zeros((num_voxels, C), dtype=prod.dtype, device=prod.device)
    return out.index_add(0, ids[keep], prod[keep])


def mlp_input(s2keyego, intrin, post_rot, post_tran, bda):
    """The depth net's 27-value camera code, (B, N, 27)."""
    B, N = s2keyego.shape[:2]
    bd = bda[:, None].expand(B, N, 3, 3)
    f = torch.stack([
        intrin[:, :, 0, 0], intrin[:, :, 1, 1], intrin[:, :, 0, 2],
        intrin[:, :, 1, 2], post_rot[:, :, 0, 0], post_rot[:, :, 0, 1],
        post_tran[:, :, 0], post_rot[:, :, 1, 0], post_rot[:, :, 1, 1],
        post_tran[:, :, 1], bd[:, :, 0, 0], bd[:, :, 0, 1], bd[:, :, 1, 0],
        bd[:, :, 1, 1], bd[:, :, 2, 2]], dim=-1)
    return torch.cat([f, s2keyego[:, :, :3, :].reshape(B, N, 12)], dim=-1)


def stereo_grid(frustum, k2s, intrin, post_rot, post_tran, img_hw):
    """(B*N, D, H, W, 2) normalised grid of the current frame's frustum
    points in the previous image; points behind the camera at -2."""
    B, N = k2s.shape[:2]
    D, H, W = frustum.shape[:3]
    hi, wi = img_hw
    pts = frustum[None, None] - post_tran[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", torch.linalg.inv(post_rot),
                       pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    # current image -> current sensor -> previous sensor -> previous image
    m = intrin @ k2s[:, :, :3, :3] @ torch.linalg.inv(intrin)
    t = torch.einsum("bnij,bnj->bni", intrin, k2s[:, :, :3, 3])
    q = torch.einsum("bnij,bndhwj->bndhwi", m, pts) \
        + t[:, :, None, None, None, :]
    z = q[..., 2]
    behind = z < 1e-3
    px, py = q[..., 0] / z, q[..., 1] / z
    pr = post_rot[:, :, None, None, None]
    u = pr[..., 0, 0] * px + pr[..., 0, 1] * py \
        + post_tran[:, :, 0, None, None, None]
    v = pr[..., 1, 0] * px + pr[..., 1, 1] * py \
        + post_tran[:, :, 1, None, None, None]
    gx = torch.where(behind, torch.full_like(u, -2.0), u / (wi - 1) * 2 - 1)
    gy = torch.where(behind, torch.full_like(v, -2.0), v / (hi - 1) * 2 - 1)
    return torch.stack([gx, gy], dim=-1).reshape(B * N, D, H, W, 2)


def stereo_cost_volume(prev, curr, grid, bias: float, chunk: int = 8):
    """softmax(-cost) over D, (B*N, D, H, W): prev / curr (B*N, H, W, C),
    grid (B*N, D, H, W, 2)."""
    BN, H, W, C = curr.shape
    D = grid.shape[1]
    prev_cf = prev.movedim(-1, 1)
    curr_cf = curr.movedim(-1, 1)
    costs = []
    for d0 in range(0, D, chunk):
        g = grid[:, d0:d0 + chunk]
        dc = g.shape[1]
        s = F.grid_sample(prev_cf, g.reshape(BN, dc * H, W, 2),
                          mode="bilinear", padding_mode="zeros",
                          align_corners=True).reshape(BN, C, dc, H, W)
        cost = (curr_cf[:, :, None] - s).abs().sum(dim=1)
        costs.append(cost + (s[:, max(C - 4, 0)] == 0.0).float() * bias)
    return torch.softmax(-torch.cat(costs, dim=1), dim=1)


def ego_motion_warp(feat, curr_s2keyego, prev_s2keyego, bda, grid: Grid):
    """Warp a (B, Z, Y, X, C) voxel feature by the planar motion between
    the two frames' camera-0 poses (bilinear, zeros outside)."""
    B, Z, Y, X, C = feat.shape
    dev = feat.device
    bda4 = torch.zeros((B, 4, 4), device=dev)
    bda4[:, :3, :3] = bda
    bda4[:, 3, 3] = 1.0
    m = (bda4 @ curr_s2keyego[:, 0]) @ torch.linalg.inv(
        bda4 @ prev_s2keyego[:, 0])
    keep = torch.tensor([0, 1, 3], device=dev)
    m = m[:, keep][:, :, keep]
    (ix, iy, _), (lx, ly, _) = grid.interval, grid.lower
    f2b = torch.tensor([[ix, 0, lx], [0, iy, ly], [0, 0, 1]],
                       dtype=torch.float32, device=dev)
    tf = torch.linalg.inv(f2b) @ m @ f2b
    gy, gx = torch.meshgrid(torch.arange(Y, dtype=torch.float32, device=dev),
                            torch.arange(X, dtype=torch.float32, device=dev),
                            indexing="ij")
    p = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    w = torch.einsum("bij,pj->bpi", tf, p)[..., :2]
    g = w / torch.tensor([X - 1.0, Y - 1.0], device=dev) * 2 - 1
    inp = feat.permute(0, 1, 4, 2, 3).reshape(B, Z * C, Y, X)
    out = F.grid_sample(inp, g.reshape(B, Y, X, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.reshape(B, Z, C, Y, X).permute(0, 1, 3, 4, 2)
