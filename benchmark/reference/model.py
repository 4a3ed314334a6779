"""The reference PreWorld: the occupancy model in plain float32 PyTorch.

The same mathematics as the published model at the configuration's
sizes, with no kernel, no cache of the program's and no mixed precision:
the 3-frame stereo loop (`voxel_feat`), one streaming step from three
frames' inputs (`stream_voxel_feat`), the occupancy logits, and the loss
of either train stage (`loss`). Parameter and buffer names equal the
measured program's, so that one state dict made by the benchmark loads
into both.

Training follows the published recipe: only the key frame takes
gradients; the stereo-reference frame and the adjacent frame run without
gradient (BatchNorm still on batch statistics); the cost volume takes no
gradient; stochastic depth and the ASPP dropout come from a host
`torch.Generator` in the program's order of draws: for frames 2, 1, 0 the
backbone's masks (stage 0 only on frame 2), then on frames 1 and 0 the
dropout mask. `checkpoint_backbone` recomputes each image backbone pass
in the backward, to fit the float32 step on one card; it changes no value.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from . import geometry as geo
from .layers import (
    BasicBlock,
    BatchNorm1d,
    Conv2d,
    Conv3d,
    ConvNormAct,
    CustomResNet,
    FPN_LSS,
    LSSFPN3D,
    Linear,
    Mlp,
    MlpSequence,
    OccHead,
    SELayer,
    TinyBackbone,
    lower,
    to_cf,
    to_cl,
)
from .losses import depth_bce_loss, voxel_losses
from .render import RenderConfig, render_losses
from .swin import SwinTransformer


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The sizes and switches of one configuration file of the benchmark
    (`from_sizes` reads them)."""

    grid: geo.Grid
    input_size: Tuple[int, int]
    num_cams: int
    temporal_frames: int
    extra_ref_frames: int
    backbone: str
    swin_embed_dims: int
    swin_depths: Tuple[int, ...]
    swin_num_heads: Tuple[int, ...]
    swin_window: int
    neck_out_channels: int
    num_trans_channels: int
    num_classes: int
    out_dim: int
    if_render: bool
    if_post_finetune: bool
    use_lss_depth_loss: bool
    depth_loss_weight: float
    render: RenderConfig

    @property
    def num_frames(self) -> int:
        return self.temporal_frames + self.extra_ref_frames

    @staticmethod
    def from_sizes(s: Dict) -> "RefConfig":
        g = s["grid"]
        return RefConfig(
            grid=geo.Grid(tuple(g["x"]), tuple(g["y"]), tuple(g["z"]),
                          tuple(g["depth"])),
            input_size=tuple(s["input_size"]), num_cams=s["num_cams"],
            temporal_frames=s["temporal_frames"],
            extra_ref_frames=s["extra_ref_frames"], backbone=s["backbone"],
            swin_embed_dims=s["swin_embed_dims"],
            swin_depths=tuple(s["swin_depths"]),
            swin_num_heads=tuple(s["swin_num_heads"]),
            swin_window=s["swin_window"],
            neck_out_channels=s["neck_out_channels"],
            num_trans_channels=s["num_trans_channels"],
            num_classes=s["num_classes"], out_dim=s["out_dim"],
            if_render=s["if_render"], if_post_finetune=s["if_post_finetune"],
            use_lss_depth_loss=s["use_lss_depth_loss"],
            depth_loss_weight=s["depth_loss_weight"],
            render=RenderConfig.from_sizes(s["render"]))


class ASPP(nn.Module):
    dropout_rate = 0.5

    def __init__(self, inplanes: int, mid: int):
        super().__init__()
        for i, d in enumerate((1, 6, 12, 18)):
            setattr(self, f"aspp{i + 1}", ConvNormAct(
                inplanes, mid, 1 if d == 1 else 3, dilation=d))
        self.global_branch = ConvNormAct(inplanes, mid, 1)
        self.proj = ConvNormAct(5 * mid, inplanes, 1)

    def forward(self, x, drop=None):
        br = [getattr(self, f"aspp{i}")(x) for i in range(1, 5)]
        gap = self.global_branch(x.mean(dim=(1, 2), keepdim=True))
        br.append(gap.expand(*br[0].shape[:-1], gap.shape[-1]))
        y = self.proj(torch.cat(br, dim=-1))
        return y if drop is None else y * drop.to(y.device)


class DepthNet(nn.Module):
    def __init__(self, channels: int, context: int, depth: int):
        super().__init__()
        self.mlp_bn = BatchNorm1d(27, eps=1e-5)
        self.reduce_conv = ConvNormAct(channels, channels, 3, use_bias=True)
        self.context_mlp = Mlp(27, channels, channels)
        self.context_se = SELayer(channels)
        self.context_conv = Conv2d(channels, context, 1)
        self.depth_mlp = Mlp(27, channels, channels)
        self.depth_se = SELayer(channels)
        for i in range(2):
            setattr(self, f"cost_volumn_net{i}", ConvNormAct(
                depth, depth, 3, strides=2, use_bias=True, act=None))
        self.depth_block0 = BasicBlock(channels + depth, channels,
                                       downsample=True, downsample_kernel=1,
                                       downsample_norm=False)
        self.depth_block1 = BasicBlock(channels, channels)
        self.depth_block2 = BasicBlock(channels, channels)
        self.aspp = ASPP(channels, 96)
        self.depth_pred = Conv2d(channels, depth, 1)

    def forward(self, x, mlp_in, cost_volume, drop=None):
        m = self.mlp_bn(mlp_in.reshape(-1, mlp_in.shape[-1]))
        x = self.reduce_conv(x)
        ctx = to_cl(self.context_conv(to_cf(
            self.context_se(x, self.context_mlp(m)))))
        d = self.depth_se(x, self.depth_mlp(m))
        cv = self.cost_volumn_net1(self.cost_volumn_net0(
            cost_volume.permute(0, 2, 3, 1)))
        d = torch.cat([d, cv], dim=-1)
        d = self.depth_block2(self.depth_block1(self.depth_block0(d)))
        d = to_cl(self.depth_pred(to_cf(self.aspp(d, drop))))
        return torch.cat([d, ctx], dim=-1)


class ViewTransformer(nn.Module):
    def __init__(self, c: RefConfig):
        super().__init__()
        self.D = c.grid.num_depth_bins
        self.depth_net = DepthNet(c.neck_out_channels, c.num_trans_channels,
                                  self.D)


class PreWorldRef(nn.Module):
    downsample = 16
    cv_downsample = 4
    cost_volume_bias = 5.0

    def __init__(self, cfg: RefConfig, checkpoint_backbone: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.checkpoint_backbone = checkpoint_backbone
        if c.backbone == "swin":
            self.img_backbone = SwinTransformer(
                c.input_size, c.swin_embed_dims, c.swin_depths,
                c.swin_num_heads, c.swin_window)
            e = c.swin_embed_dims
            neck_in = e * 4 + e * 8
        else:
            self.img_backbone = TinyBackbone()
            neck_in = 96
        self.img_neck = FPN_LSS(neck_in, c.neck_out_channels)
        self.view_transformer = ViewTransformer(c)
        nt = c.num_trans_channels
        self.pre_process = CustomResNet(nt, (1,), (nt,), (1,), (0,))
        self.bev_backbone = CustomResNet(nt * c.temporal_frames, (1, 2, 4),
                                         (nt, nt * 2, nt * 4), (1, 2, 2),
                                         (0, 1, 2))
        self.bev_neck = LSSFPN3D(nt * 7, nt)
        self.final_conv = ConvNormAct(nt, c.out_dim, (3, 3, 3),
                                      use_bias=True, norm=None)
        self.occupancy_head = OccHead(c.out_dim, c.num_classes)
        self.density_mlp = MlpSequence(c.out_dim, c.out_dim * 2, 2,
                                       final_softplus=True)
        self.semantic_mlp = MlpSequence(c.out_dim, c.out_dim * 2,
                                        c.num_classes - 1)
        self.color_mlp = MlpSequence(c.out_dim, c.out_dim * 2, 3)
        self.register_buffer("pool_frustum", torch.from_numpy(
            geo.create_frustum(c.grid, c.input_size, self.downsample)),
            persistent=False)
        self.register_buffer("cv_frustum", torch.from_numpy(
            geo.create_frustum(c.grid, c.input_size, self.cv_downsample)),
            persistent=False)

    @classmethod
    def from_sizes(cls, sizes: Dict, **kw) -> "PreWorldRef":
        """The model of a benchmark configuration's `sizes`."""
        return cls(RefConfig.from_sizes(sizes), **kw)

    def set_precision(self, mode: str) -> None:
        set_precision(self, mode)

    # ------------------------------------------------------------ parts

    def _backbone(self, x, stage0_only, gen):
        drops = None
        if gen is not None and self.cfg.backbone == "swin":
            drops = self.img_backbone.draw_drop_scales(x.shape[0], gen,
                                                       stage0_only)
        if self.checkpoint_backbone and torch.is_grad_enabled():
            return checkpoint(self.img_backbone, x, stage0_only, drops,
                              use_reentrant=False)
        return self.img_backbone(x, stage0_only, drops)

    def _dropout(self, B, N, gen):
        if gen is None:
            return None
        c = self.cfg
        keep = 1.0 - ASPP.dropout_rate
        shape = (B * N, c.input_size[0] // self.downsample,
                 c.input_size[1] // self.downsample, c.neck_out_channels)
        return (torch.rand(shape, generator=gen) < keep).float() / keep

    def _lift(self, feat, cams, cost_volume, ids, drop):
        """Depth net, depth softmax and pooling -> (voxel (B, Z, Y, X, C),
        depth (B, N, D, Hf, Wf))."""
        c = self.cfg
        B, N, Hf, Wf, C = feat.shape
        out = self.view_transformer.depth_net(
            feat.reshape(B * N, Hf, Wf, C), cams["mlp_input"], cost_volume,
            drop)
        D = self.view_transformer.D
        depth = torch.softmax(out[..., :D], dim=-1)
        ctx = out[..., D:D + c.num_trans_channels]
        depth = depth.reshape(B, N, Hf, Wf, D).permute(0, 1, 4, 2, 3)
        ctx = ctx.reshape(B, N, Hf, Wf, -1)
        pooled = geo.bev_pool(depth, ctx, ids, B * c.grid.num_voxels)
        sx, sy, sz = c.grid.size
        return pooled.reshape(B, sz, sy, sx, -1), depth

    def _encode(self, imgs, gen):
        B, N = imgs.shape[:2]
        feats = self._backbone(imgs.reshape(B * N, *imgs.shape[2:]), False,
                               gen)
        neck = self.img_neck(feats[1:])
        return neck.reshape(B, N, *neck.shape[1:]), feats[0]

    def _bev_encode(self, feats):
        x = torch.cat(feats, dim=-1)
        x = self.bev_neck(self.bev_backbone(x))
        return self.final_conv(x).permute(0, 3, 2, 1, 4)

    def _cost_volume(self, prev, curr, k2s, cams):
        grid = geo.stereo_grid(self.cv_frustum, k2s, cams["intrin"],
                               cams["post_rot"], cams["post_tran"],
                               self.cfg.input_size)
        return geo.stereo_cost_volume(prev, curr, grid,
                                      self.cost_volume_bias)

    # ------------------------------------------------------------ paths

    def voxel_feat(self, batch, gen: Optional[torch.Generator] = None):
        """The 3-frame loop -> (voxel feats (B, X, Y, Z, out_dim), key-frame
        depth). gen: training (masks drawn, key frame only with grad)."""
        c = self.cfg
        imgs = batch["imgs"]
        B, T, N = imgs.shape[:3]
        s2k = geo.sensor2keyego(batch["sensor2egos"], batch["ego2globals"])
        c2a = geo.curr2adjsensor(batch["sensor2egos"], batch["ego2globals"],
                                 c.temporal_frames)
        prev = None
        bev = []
        depth_key = None
        for fid in range(c.num_frames - 1, -1, -1):
            x = imgs[:, fid]
            if fid >= c.temporal_frames:
                with torch.no_grad():
                    prev = self._backbone(x.reshape(B * N, *x.shape[2:]),
                                          True, gen)[0]
                continue
            cams = {"intrin": batch["intrins"][:, fid],
                    "post_rot": batch["post_rots"][:, fid],
                    "post_tran": batch["post_trans"][:, fid],
                    "bda": batch["bda"],
                    "mlp_input": geo.mlp_input(
                        s2k[:, 0], batch["intrins"][:, fid],
                        batch["post_rots"][:, fid],
                        batch["post_trans"][:, fid], batch["bda"])}
            ctx = torch.enable_grad() if fid == 0 and gen is not None \
                else torch.no_grad()
            with ctx:
                feat, stereo = self._encode(x, gen)
                stereo = stereo.detach()
                with torch.no_grad():
                    cv = self._cost_volume(prev, stereo, c2a[:, fid], cams)
                    ids = geo.voxel_ids(geo.frustum_to_ego(
                        self.pool_frustum, s2k[:, fid], cams["intrin"],
                        cams["post_rot"], cams["post_tran"], cams["bda"]),
                        c.grid)
                drop = self._dropout(B, N, gen)
                voxel, depth = self._lift(feat, cams, cv, ids, drop)
                voxel = self.pre_process(voxel)[0]
            if fid == 0:
                depth_key = depth
            bev.append(voxel)
            prev = stereo
        return self._bev_encode(bev), depth_key

    def stream_voxel_feat(self, frames: Sequence[Dict[str, torch.Tensor]],
                          first: Dict[str, torch.Tensor]):
        """One streaming step from three consecutive frames' inputs, oldest
        first (each one frame: imgs (B, N, H, W, 3), the camera tensors
        without a frame axis, bda): frame t-1's voxel feature (its cost
        volume against frame t-2's stage-0 feature), warped by the ego
        motion into frame t's ego, beside frame t's (cost volume against
        frame t-1). The rig is fixed, so the pooling's voxel ids are those
        of the stream's first frame (`first`) in its own ego, for every
        frame, as a stream computes them once."""
        f2, f1, f0 = frames
        ids = self.stream_ids(first)
        v1, st1 = self.stream_frame(f1, self.stage0(f2), f2, ids)
        return self.stream_step(f0, f1, v1, st1, ids)

    def stream_ids(self, first):
        return geo.voxel_ids(geo.frustum_to_ego(
            self.pool_frustum, geo.own_ego(first["sensor2egos"],
                                           first["ego2globals"]),
            first["intrins"], first["post_rots"], first["post_trans"],
            first["bda"]), self.cfg.grid)

    def stage0(self, f):
        x = f["imgs"]
        return self._backbone(x.reshape(-1, *x.shape[2:]), True, None)[0]

    def stream_frame(self, f, prev_feat, prev_f, ids):
        """One frame's voxel feature (after pre_process) and stage-0
        feature, its cost volume against the previous frame's."""
        s2e, e2g = f["sensor2egos"], f["ego2globals"]
        s2k = geo.own_ego(s2e, e2g)
        cams = {"intrin": f["intrins"], "post_rot": f["post_rots"],
                "post_tran": f["post_trans"], "bda": f["bda"],
                "mlp_input": geo.mlp_input(s2k, f["intrins"], f["post_rots"],
                                           f["post_trans"], f["bda"])}
        feat, stereo = self._encode(f["imgs"], None)
        k2s = (geo.invert_rigid(prev_f["ego2globals"] @ prev_f["sensor2egos"])
               @ e2g @ s2e)
        cv = self._cost_volume(prev_feat, stereo, k2s.float(), cams)
        voxel, _ = self._lift(feat, cams, cv, ids, None)
        return self.pre_process(voxel)[0], stereo

    def stream_step(self, f0, f1, v1, st1, ids):
        """The work of one streaming step: frame t's voxel feature against
        frame t-1's stage-0 feature, frame t-1's voxel feature warped into
        frame t's ego, the BEV encoder."""
        v0, _ = self.stream_frame(f0, st1, f1, ids)
        key_inv = geo.invert_rigid(f0["ego2globals"][:, 0:1])
        prev_pose = (key_inv @ f1["ego2globals"] @ f1["sensor2egos"]).float()
        v1 = geo.ego_motion_warp(v1, geo.own_ego(f0["sensor2egos"],
                                                 f0["ego2globals"]),
                                 prev_pose, f0["bda"], self.cfg.grid)
        return self._bev_encode([v1, v0])

    def occupancy_logits(self, vf):
        return self.occupancy_head(vf)

    def loss(self, batch, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """The train stage's weighted losses (call in train mode)."""
        c = self.cfg
        vf, depth = self.voxel_feat(batch, gen)
        losses = {}
        if c.if_post_finetune:
            losses.update(voxel_losses(self.occupancy_logits(vf),
                                       batch["voxel_semantics"].long(),
                                       c.num_classes))
        if c.if_render:
            density = self.density_mlp(vf)[..., 0]
            losses.update(render_losses(density, self.semantic_mlp(vf),
                                        self.color_mlp(vf), batch["rays"],
                                        batch["bda"], c.render))
        if c.use_lss_depth_loss:
            losses["loss_lss_depth"] = depth_bce_loss(
                depth, batch["gt_depth"], self.downsample, c.grid,
                c.depth_loss_weight)
        return losses


LOW_PRECISION = ("img_backbone", "img_neck", "view_transformer",
                 "pre_process", "bev_backbone", "bev_neck")


def set_precision(model: PreWorldRef, mode: str) -> None:
    """'f32': the reference. 'fp8': the control, the parts the
    configuration computes in bfloat16 computed in float8: every product's
    operands and result, and every module's output there (the residual
    streams, norms, activations), rounded to float8 e4m3, and the
    gradients through them to e5m2. 'bf16': the same parts rounded to
    bfloat16 both ways (a witness, `control.py`)."""
    for h in model.__dict__.pop("_round_hooks", []):
        h.remove()
    hooks = []
    for name in LOW_PRECISION:
        for m in getattr(model, name).modules():
            if isinstance(m, (Linear, Conv2d, Conv3d)):
                m.quant = None if mode == "f32" else mode
            elif mode != "f32":
                hooks.append(m.register_forward_hook(_round_output(mode)))
    model.__dict__["_round_hooks"] = hooks


def _round_output(mode: str):
    def hook(module, args, out):
        if isinstance(out, tuple):
            return tuple(lower(o, mode) if o.is_floating_point() else o
                         for o in out)
        return lower(out, mode) if out.is_floating_point() else out
    return hook
