"""Camera-aware DepthNet with ASPP, and the stereo warp geometry.

Counterpart of `preworld_tpu/models/depthnet.py`: `ASPP`, `DepthNet`,
`gen_stereo_grid`, `gen_stereo_homography` and the plain
`stereo_cost_volume` (grid_sample with align_corners=True, zeros padding).
Channel-last.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BasicBlock, ConvNormAct, Mlp, SELayer, to_cf, to_cl


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (dilations 1, 6, 12, 18 + global)."""

    def __init__(self, inplanes: int, mid_channels: int = 256):
        super().__init__()
        for i, d in enumerate((1, 6, 12, 18)):
            setattr(self, f"aspp{i + 1}", ConvNormAct(
                inplanes, mid_channels, 1 if d == 1 else 3, dilation=d))
        self.global_branch = ConvNormAct(inplanes, mid_channels, 1)
        self.proj = ConvNormAct(5 * mid_channels, inplanes, 1)

    def forward(self, x):
        branches = [getattr(self, f"aspp{i}")(x) for i in range(1, 5)]
        gap = self.global_branch(x.mean(dim=(1, 2), keepdim=True))
        branches.append(gap.expand(*branches[0].shape[:-1], gap.shape[-1]))
        return self.proj(torch.cat(branches, dim=-1))


def _stereo_coeffs(k2s_sensor, intrins, post_rots, post_trans):
    """Per-(b, n) affine coefficients shared by the grid and homography
    forms: L (B, N, 3, 4), S (B, N, 3, 4), t1 (B, N, 3)."""
    rots = k2s_sensor[:, :, :3, :3]
    trans = k2s_sensor[:, :, :3, 3]
    # inv_ex: linalg.inv would synchronise with the device to check errors
    inv_post = torch.linalg.inv_ex(post_rots).inverse
    tp = torch.einsum("bnij,bnj->bni", inv_post, post_trans)
    L = torch.cat([inv_post, -tp[..., None]], dim=-1)
    M = intrins @ rots @ torch.linalg.inv_ex(intrins).inverse
    t1 = torch.einsum("bnij,bnj->bni", intrins, trans)
    S = torch.einsum("bnik,bnkj->bnij", M[:, :, :, :2], L[:, :, :2, :])
    S = torch.cat([S[..., :3], (S[..., 3] + M[:, :, :, 2])[..., None]], -1)
    return L, S, t1


def gen_stereo_grid(frustum, k2s_sensor, intrins, post_rots, post_trans,
                    img_size_hw):
    """(B*N, D*H, W, 2) normalised warp grid of the current frame's
    cv-frustum into the previous image; behind-camera points at -2."""
    B, N = k2s_sensor.shape[:2]
    D, H, W = frustum.shape[:3]
    hi, wi = img_size_hw
    L, S, t1 = _stereo_coeffs(k2s_sensor, intrins, post_rots, post_trans)
    u, v, dd = frustum[..., 0], frustum[..., 1], frustum[..., 2]

    def affine(c):
        c = c[:, :, None, None, None, :]
        return c[..., 0] * u + c[..., 1] * v + c[..., 2] * dd + c[..., 3]

    qz = affine(L[:, :, 2])
    z = qz * affine(S[:, :, 2]) + t1[:, :, 2, None, None, None]
    x = qz * affine(S[:, :, 0]) + t1[:, :, 0, None, None, None]
    y = qz * affine(S[:, :, 1]) + t1[:, :, 1, None, None, None]
    neg_mask = z < 1e-3
    x = x / z
    y = y / z
    sx, sy = 2.0 / (wi - 1.0), 2.0 / (hi - 1.0)

    def c2(i, j):
        return post_rots[:, :, i, j][:, :, None, None, None]

    tx = (post_trans[:, :, 0] * sx - 1.0)[:, :, None, None, None]
    ty = (post_trans[:, :, 1] * sy - 1.0)[:, :, None, None, None]
    px = (c2(0, 0) * x + c2(0, 1) * y) * sx + tx
    py = (c2(1, 0) * x + c2(1, 1) * y) * sy + ty
    px = torch.where(neg_mask, torch.full_like(px, -2.0), px)
    py = torch.where(neg_mask, torch.full_like(py, -2.0), py)
    return torch.stack([px, py], dim=-1).reshape(B * N, D * H, W, 2)


def gen_stereo_homography(frustum, k2s_sensor, intrins, post_rots,
                          post_trans, img_size_hw):
    """(B*N, D, 3, 3) f32 per-plane homographies equivalent to
    `gen_stereo_grid` for 2-D post-augs (post_rots third row (0, 0, 1)):
    output feature-pixel (w, h, 1) -> previous feature-pixel homogeneous
    coordinates; z < 1e-3 marks behind-camera samples."""
    B, N = k2s_sensor.shape[:2]
    D, Hf, Wf = frustum.shape[:3]
    hi, wi = img_size_hw
    L, S, t1 = _stereo_coeffs(k2s_sensor, intrins, post_rots, post_trans)
    dd = frustum[:, 0, 0, 2].float()
    qzc = L[:, :, 2, 2][..., None] * dd + L[:, :, 2, 3][..., None]

    def hrow(i):
        a = qzc * S[:, :, i, 0][..., None]
        b = qzc * S[:, :, i, 1][..., None]
        c = (qzc * (S[:, :, i, 2][..., None] * dd + S[:, :, i, 3][..., None])
             + t1[:, :, i][..., None])
        return torch.stack([a, b, c], dim=-1)

    Hx, Hy, Hz = hrow(0), hrow(1), hrow(2)
    ax = (Wf - 1.0) / (wi - 1.0)
    ay = (Hf - 1.0) / (hi - 1.0)

    def pc(i, j):
        return post_rots[:, :, i, j][..., None, None]

    ptx = post_trans[:, :, 0][..., None, None]
    pty = post_trans[:, :, 1][..., None, None]
    Gx = ax * (pc(0, 0) * Hx + pc(0, 1) * Hy + ptx * Hz)
    Gy = ay * (pc(1, 0) * Hx + pc(1, 1) * Hy + pty * Hz)
    G = torch.stack([Gx, Gy, Hz], dim=-2)
    u0 = frustum[0, 0, 0, 0]
    su = (frustum[0, 0, 1, 0] - u0) if Wf > 1 else torch.ones_like(u0)
    v0 = frustum[0, 0, 0, 1]
    sv = (frustum[0, 1, 0, 1] - v0) if Hf > 1 else torch.ones_like(u0)
    zero, one = torch.zeros_like(u0), torch.ones_like(u0)
    T = torch.stack([
        torch.stack([su, zero, u0]),
        torch.stack([zero, sv, v0]),
        torch.stack([zero, zero, one]),
    ])
    return (G @ T).reshape(B * N, D, 3, 3).float()


def stereo_cost_volume(prev_feat, curr_feat, grid, bias: float,
                       depth_chunk: int = 8):
    """Plain abs-diff plane-sweep cost from a (B*N, D*H, W, 2) grid, as
    softmax(-cost) over D: (B*N, D, H, W). prev/curr (B*N, H, W, C)."""
    BN, H, W, C = curr_feat.shape
    D = grid.shape[1] // H
    prev_nchw = to_cf(prev_feat)
    curr_nchw = to_cf(curr_feat)
    costs = []
    g = grid.reshape(BN, D, H, W, 2)
    for d0 in range(0, D, depth_chunk):
        gc = g[:, d0:d0 + depth_chunk]
        dc = gc.shape[1]
        warped = F.grid_sample(prev_nchw, gc.reshape(BN, dc * H, W, 2),
                               mode="bilinear", padding_mode="zeros",
                               align_corners=True)
        warped = warped.reshape(BN, C, dc, H, W)
        diff = (curr_nchw[:, :, None] - warped).abs().sum(dim=1)
        invalid = warped[:, max(C - 4, 0)] == 0.0
        costs.append(diff + invalid.to(diff.dtype) * bias)
    return torch.softmax(-torch.cat(costs, dim=1), dim=1)


class DepthNet(nn.Module):
    """27-dim camera-conditioned depth + context head with the stereo
    cost-volume branch; (B*N, Hf, Wf, in) -> (B*N, Hf, Wf, D + C_ctx)."""

    def __init__(self, in_channels: int, mid_channels: int,
                 context_channels: int, depth_channels: int,
                 aspp_mid_channels: int = 96, stereo: bool = True):
        super().__init__()
        self.stereo = stereo
        self.mlp_bn = nn.BatchNorm1d(27, eps=1e-5)
        self.reduce_conv = ConvNormAct(in_channels, mid_channels, 3,
                                       use_bias=True)
        self.context_mlp = Mlp(27, mid_channels, mid_channels)
        self.context_se = SELayer(mid_channels)
        self.context_conv = nn.Conv2d(mid_channels, context_channels, 1)
        self.depth_mlp = Mlp(27, mid_channels, mid_channels)
        self.depth_se = SELayer(mid_channels)
        in_ch = mid_channels
        if stereo:
            for i in range(2):
                setattr(self, f"cost_volumn_net{i}", ConvNormAct(
                    depth_channels, depth_channels, 3, strides=2,
                    use_bias=True, act=None))
            in_ch = mid_channels + depth_channels
        self.depth_block0 = BasicBlock(
            in_ch, mid_channels, downsample=in_ch != mid_channels,
            downsample_kernel=1, downsample_norm=False)
        self.depth_block1 = BasicBlock(mid_channels, mid_channels)
        self.depth_block2 = BasicBlock(mid_channels, mid_channels)
        self.aspp = ASPP(mid_channels, aspp_mid_channels)
        self.depth_pred = nn.Conv2d(mid_channels, depth_channels, 1)

    def forward(self, x, mlp_input, cost_volume: Optional[torch.Tensor] = None):
        mlp_input = self.mlp_bn(mlp_input.reshape(-1, mlp_input.shape[-1]))
        x = self.reduce_conv(x)
        context = self.context_se(x, self.context_mlp(mlp_input))
        context = to_cl(self.context_conv(to_cf(context)))
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        if self.stereo:
            cv = cost_volume.permute(0, 2, 3, 1)  # (BN, H, W, D)
            cv = self.cost_volumn_net1(self.cost_volumn_net0(cv))
            depth = torch.cat([depth, cv], dim=-1)
        depth = self.depth_block2(self.depth_block1(self.depth_block0(depth)))
        depth = self.aspp(depth)
        depth = to_cl(self.depth_pred(to_cf(depth)))
        return torch.cat([depth, context], dim=-1)
