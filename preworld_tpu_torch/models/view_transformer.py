"""LSS view transformer: image features -> voxel features via lift-splat.

Counterpart of `preworld_tpu/models/view_transformer.py`:
`get_mlp_input`, `compute_stereo_cost_volume`, `LSSViewTransformer` and
the pretrain stage's depth supervision (`downsampled_gt_depth`,
`depth_bce_loss`).
The stereo cost volume takes the JAX package's routes by feature shape
(`ops.cost_volume_pallas.plane_sweep_supported`): the homography path on
kernel K3, exact for 2-D image post-augs only (`PreWorld` checks the
post-augs with `check_planar_post_aug` once per request on this route and
raises on a 3-D one), else the grid route, `gen_stereo_grid` and the plain
`stereo_cost_volume` (F.grid_sample). The voxel pooling always goes
through K4's wrapper.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.frustum import GridConfig, frustum_pixel_indices
from ..parallel.collectives import batch_sums, replica_share
from ..ops.bev_pool_pallas import bev_pool_fused
from ..ops.cost_volume_pallas import (
    plane_sweep_cost_hom,
    plane_sweep_supported,
)
from ..utils import trace
from .depthnet import (
    DepthNet,
    gen_stereo_grid,
    gen_stereo_homography,
    stereo_cost_volume,
)


def check_planar_post_aug(post_rot: torch.Tensor) -> None:
    """Raise unless every post_rot has third row (0, 0, 1): the per-plane
    homography of K3 is exact only for 2-D image post-augs. Reads the result
    back to the host, so callers run it before queueing device work."""
    row = post_rot[..., 2, :]
    ok = (row[..., 0] == 0) & (row[..., 1] == 0) & (row[..., 2] == 1)
    if not bool(ok.all()):
        raise ValueError(
            "the homography cost volume needs 2-D image post-augs "
            "(post_rots[..., 2, :] == (0, 0, 1))")


@trace.spanned("cost_volume")
def compute_stereo_cost_volume(cv_frustum, cams, stereo, input_size, bias):
    """Temporal-stereo depth probability (B*N, D, Hc, Wc) in the feature
    dtype: softmax over D of -cost, from K3 on per-plane homographies where
    `plane_sweep_supported` holds (2-D image post-augs only; see
    `check_planar_post_aug`), else from the plain grid-sample cost volume
    on `gen_stereo_grid`."""
    dt = stereo["curr_feat"].dtype
    if not plane_sweep_supported(stereo["prev_feat"].shape):
        grid = gen_stereo_grid(
            cv_frustum, stereo["k2s_sensor"], cams["intrin"],
            cams["post_rot"], cams["post_tran"], input_size)
        return stereo_cost_volume(stereo["prev_feat"], stereo["curr_feat"],
                                  grid, bias).to(dt)
    hom = gen_stereo_homography(
        cv_frustum, stereo["k2s_sensor"], cams["intrin"], cams["post_rot"],
        cams["post_tran"], input_size)
    cost = plane_sweep_cost_hom(stereo["prev_feat"].contiguous(),
                                stereo["curr_feat"].contiguous(),
                                hom.contiguous(), bias=float(bias))
    return torch.softmax(-cost, dim=1).to(dt)


def get_mlp_input(sensor2ego, ego2global, intrin, post_rot, post_tran, bda):
    """27-dim camera conditioning vector, (B, N, 27)."""
    B, N = sensor2ego.shape[:2]
    bda_r = bda[:, None].expand(B, N, 3, 3)
    feats = torch.stack([
        intrin[:, :, 0, 0], intrin[:, :, 1, 1], intrin[:, :, 0, 2],
        intrin[:, :, 1, 2], post_rot[:, :, 0, 0], post_rot[:, :, 0, 1],
        post_tran[:, :, 0], post_rot[:, :, 1, 0], post_rot[:, :, 1, 1],
        post_tran[:, :, 1], bda_r[:, :, 0, 0], bda_r[:, :, 0, 1],
        bda_r[:, :, 1, 0], bda_r[:, :, 1, 1], bda_r[:, :, 2, 2],
    ], dim=-1)
    s2e = sensor2ego[:, :, :3, :].reshape(B, N, 12)
    return torch.cat([feats, s2e], dim=-1)


class LSSViewTransformer(nn.Module):
    """BEVStereo-style view transformer.

    forward(x (B, N, Hf, Wf, C_in), cams, cost_volume (B*N, D, Hc, Wc) or
    None for the zero-cost-volume branch, pool_vox (B, N, D, Hf, Wf) voxel
    ids, dropout_scale: the depth net's ASPP dropout mask (B*N, Hf, Wf,
    C_in) in training) -> voxel feats (B, Z, Y, X, C_out), depth (B, N, D,
    Hf, Wf). Differentiable in x and the parameters; the cost volume is an
    input without gradient, as in the JAX package.
    """

    def __init__(self, grid: GridConfig, input_size: Tuple[int, int],
                 downsample: int = 16, in_channels: int = 512,
                 out_channels: int = 32, cv_downsample: int = 4,
                 cost_volume_bias: float = 5.0, aspp_mid_channels: int = 96):
        super().__init__()
        self.grid = grid
        self.input_size = tuple(input_size)
        self.downsample = downsample
        self.cv_downsample = cv_downsample
        self.out_channels = out_channels
        self.cost_volume_bias = cost_volume_bias
        self.D = grid.num_depth_bins
        self.depth_net = DepthNet(
            in_channels, in_channels, out_channels, self.D,
            aspp_mid_channels=aspp_mid_channels, stereo=True)
        self._pix = {}

    def _pixel_indices(self, B, N, Hf, Wf, device):
        key = (B, N, Hf, Wf, str(device))
        if key not in self._pix:
            self._pix[key] = torch.from_numpy(
                frustum_pixel_indices(B, N, self.D, Hf, Wf)).to(device)
        return self._pix[key]

    def forward(self, x, cams, cost_volume, pool_vox, dropout_scale=None):
        B, N, Hf, Wf, C = x.shape
        x = x.reshape(B * N, Hf, Wf, C)
        if cost_volume is None:
            ch = self.input_size[0] // self.cv_downsample
            cw = self.input_size[1] // self.cv_downsample
            cost_volume = torch.zeros((B * N, self.D, ch, cw), dtype=x.dtype,
                                      device=x.device)
        out = self.depth_net(x, cams["mlp_input"].to(x.dtype), cost_volume,
                             dropout_scale)
        depth = torch.softmax(out[..., :self.D], dim=-1)
        feat = out[..., self.D:self.D + self.out_channels]
        depth_bnd = depth.reshape(B, N, Hf, Wf, self.D).permute(0, 1, 4, 2, 3)
        feat = feat.reshape(B, N, Hf, Wf, self.out_channels).contiguous()
        pix = self._pixel_indices(B, N, Hf, Wf, x.device)
        nvox = B * self.grid.num_voxels
        pooled = bev_pool_fused(depth_bnd, feat, pool_vox, pix, nvox)
        sx, sy, sz = (int(v) for v in self.grid.size)
        return pooled.reshape(B, sz, sy, sx, self.out_channels), depth_bnd


def downsampled_gt_depth(gt_depths, downsample: int, grid: GridConfig):
    """Min-pool lidar depth to feature resolution, then one-hot depth bins:
    zeros are missing (1e5 before the min-pool); bin index (d - (lo -
    step)) / step, index 0 for invalid. gt_depths (B, N, H, W) -> (B*N*h*w,
    D) f32."""
    B, N, H, W = gt_depths.shape
    D = grid.num_depth_bins
    x = gt_depths.reshape(B * N, H // downsample, downsample, W // downsample,
                          downsample)
    x = x.permute(0, 1, 3, 2, 4).reshape(-1, downsample * downsample)
    x = torch.where(x == 0.0, torch.full_like(x, 1e5), x)
    x = x.amin(dim=-1)
    lo, _, step = grid.depth
    idx = (x - (lo - step)) / step
    valid = (idx < D + 1) & (idx >= 0.0)
    idx = torch.where(valid, idx, torch.zeros_like(idx)).long()
    return F.one_hot(idx, D + 1).float()[:, 1:]


def depth_bce_loss(depth_pred, gt_depths, downsample: int, grid: GridConfig,
                   weight: float = 0.05):
    """BEVDepth BCE depth supervision: depth_pred (B, N, D, Hf, Wf)
    softmaxed, gt_depths (B, N, H, W) sparse metric depth (0 = missing).
    Computed in f32: in bf16 the upper clamp 1 - 1e-7 rounds to 1, and a
    confident bin on its own label would give 0 * log(0) = NaN. Under a
    mesh, the mean over the global batch's foreground pixels, at
    `replica_share()` (`losses/voxel.py`)."""
    D = grid.num_depth_bins
    labels = downsampled_gt_depth(gt_depths, downsample, grid)
    preds = depth_pred.float().permute(0, 1, 3, 4, 2).reshape(-1, D)
    fg = labels.amax(dim=1) > 0.0
    preds = preds.clamp(1e-7, 1.0 - 1e-7)
    bce = -(labels * torch.log(preds) + (1 - labels) * torch.log(1 - preds))
    bce, n_fg = batch_sums((bce.sum(dim=1) * fg).sum(), fg.sum().float())
    return weight * bce / n_fg.clamp_min(1.0) * replica_share()
