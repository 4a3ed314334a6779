"""PreWorld: the occupancy world model, inference and both train stages.

Counterpart of `preworld_tpu/models/preworld.py`: `PreWorldConfig`,
`TinyBackbone`, and `PreWorld.extract_voxel_feat` / `predict` /
`predict_attributes` / `occupancy_logits` / `loss` (the 3-frame stereo loop
with `align_after_vt=False`). `loss` covers the finetune stage's four voxel
losses (`if_post_finetune`), the pretrain stage's render losses
(`if_render`, `models/nerf_head.py`) and its LSS depth loss
(`use_lss_depth_loss`); streaming and `align_after_vt` are not ported yet.

Batch layout (torch tensors on one device, channel-last):
  imgs (B, T, N, H, W, 3); sensor2egos, ego2globals (B, T, N, 4, 4);
  intrins, post_rots (B, T, N, 3, 3); post_trans (B, T, N, 3); bda (B, 3, 3);
  training: voxel_semantics (B, X, Y, Z) int; rays (B, R, 16) f32
  (`geometry.rays`); gt_depth (B, N, H, W) f32.
Parameters are f32. The backbone, necks, view transformer and BEV encoder
compute in `cfg.dtype` (weights cast at use, `models/layers.py`);
`final_conv` and the heads compute in f32.

Training (`train=True`): only the key frame carries gradients. The stereo
reference frame and the adjacent frame run under `torch.no_grad()` (the JAX
package's `stop_gradient`), their BatchNorms still on batch statistics and
folding them in the JAX call order; the stereo cost volume is computed
without gradient. Stochastic depth masks and the depth net's ASPP dropout
masks come from the caller's `torch.Generator`, drawn on the host. With
`cfg.remat`, `torch.utils.checkpoint` recomputes the image backbone, the
view transformer and the two 3-D ResNets in the backward, the segments of
the JAX package's `nn.remat`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..geometry.frustum import (
    GridConfig,
    create_frustum,
    frustum_to_lidar,
    voxel_indices,
)
from ..geometry.transforms import curr2adjsensor_chain, sensor2keyego_chain
from ..losses.voxel import (
    ce_ssc_loss,
    distance_weighted_focal_loss,
    geo_scal_loss,
    lovasz_softmax_loss,
    sem_scal_loss,
    voxel_class_weights,
)
from .fpn import FPN_LSS, LSSFPN3D
from .layers import ConvNormAct, MlpSequence, recompute_context
from .nerf_head import NerfHeadConfig, nerf_head_losses
from .occ_head import OccHead
from .resnet import CustomResNet3D
from .swin import SwinTransformer
from ..ops.cost_volume_pallas import plane_sweep_supported
from .view_transformer import (
    LSSViewTransformer,
    check_planar_post_aug,
    compute_stereo_cost_volume,
    depth_bce_loss,
    get_mlp_input,
)


@dataclasses.dataclass(frozen=True)
class PreWorldConfig:
    """The JAX package's `PreWorldConfig` fields and defaults; `dtype` is a
    torch dtype, and `nerf` the port's `NerfHeadConfig` (the JAX one less
    its two TPU gather fields)."""

    grid: GridConfig = GridConfig()
    input_size: Tuple[int, int] = (512, 1408)
    num_cams: int = 6
    temporal_frames: int = 2
    extra_ref_frames: int = 1
    backbone: str = "swin"  # 'swin' | 'tiny'
    swin_embed_dims: int = 128
    swin_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin_num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    swin_window: int = 12
    neck_out_channels: int = 512
    num_trans_channels: int = 32
    num_classes: int = 18
    out_dim: int = 32
    test_threshold: float = 8.5
    empty_idx: int = 17
    # stage switches and loss weights
    if_pretrain: bool = False
    if_render: bool = True
    if_post_finetune: bool = False
    use_lss_depth_loss: bool = True
    depth_loss_weight: float = 0.05
    weight_voxel_ce: float = 1.0
    weight_voxel_sem_scal: float = 1.0
    weight_voxel_geo_scal: float = 1.0
    weight_voxel_lovasz: float = 1.0
    use_focal_loss: bool = True
    balance_cls_weight: bool = True
    nerf: NerfHeadConfig = NerfHeadConfig()
    # recompute the backbone / view transformer / 3-D ResNet activations in
    # the backward instead of keeping them
    remat: bool = False
    dtype: Any = torch.float32

    @property
    def num_frames(self) -> int:
        return self.temporal_frames + self.extra_ref_frames


class TinyBackbone(nn.Module):
    """Small conv backbone for tests: stem at /4, then /8, /16, /32."""

    def __init__(self, channels: Tuple[int, int] = (32, 64)):
        super().__init__()
        self.stem = ConvNormAct(3, 16, 3, strides=4)
        self.s8 = ConvNormAct(16, channels[0], 3, strides=2)
        self.s16 = ConvNormAct(channels[0], channels[0], 3, strides=2)
        self.s32 = ConvNormAct(channels[0], channels[1], 3, strides=2)

    def forward(self, x, stage0_only: bool = False):
        c0 = self.stem(x)
        if stage0_only:
            return (c0,)
        c2 = self.s16(self.s8(c0))
        return (c0, c2, self.s32(c2))


class PreWorld(nn.Module):
    def __init__(self, cfg: PreWorldConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.backbone == "swin":
            self.img_backbone = SwinTransformer(
                c.input_size, embed_dims=c.swin_embed_dims,
                depths=c.swin_depths, num_heads=c.swin_num_heads,
                window_size=c.swin_window, return_stereo_feat=True)
            e = c.swin_embed_dims
            neck_in = e * 4 + e * 8
            stereo_channels = e
        else:
            self.img_backbone = TinyBackbone()
            neck_in = 32 + 64
            stereo_channels = 16
        self.img_neck = FPN_LSS(neck_in, c.neck_out_channels)
        self.view_transformer = LSSViewTransformer(
            c.grid, c.input_size, downsample=16,
            in_channels=c.neck_out_channels, out_channels=c.num_trans_channels,
            cost_volume_bias=5.0)
        cv_down = self.view_transformer.cv_downsample
        # the stereo cost volume's route (K3 or the grid route), fixed by
        # the stage-0 feature shape
        self.stereo_on_plane_sweep = plane_sweep_supported(
            (1, c.input_size[0] // cv_down, c.input_size[1] // cv_down,
             stereo_channels))
        # f32 frustum templates: pooling resolution and cost-volume resolution
        self.register_buffer(
            "pool_frustum",
            torch.from_numpy(create_frustum(c.grid, c.input_size, 16)),
            persistent=False)
        self.register_buffer(
            "cv_frustum",
            torch.from_numpy(create_frustum(
                c.grid, c.input_size, self.view_transformer.cv_downsample)),
            persistent=False)
        nt = c.num_trans_channels
        self.pre_process = CustomResNet3D(
            nt, num_layer=(1,), num_channels=(nt,), stride=(1,),
            backbone_output_ids=(0,))
        self.bev_backbone = CustomResNet3D(
            nt * c.temporal_frames, num_layer=(1, 2, 4),
            num_channels=(nt, nt * 2, nt * 4), stride=(1, 2, 2),
            backbone_output_ids=(0, 1, 2))
        self.bev_neck = LSSFPN3D(nt * 7, nt)
        self.final_conv = ConvNormAct(nt, c.out_dim, (3, 3, 3), use_bias=True,
                                      norm=None)
        self.occupancy_head = OccHead(c.out_dim, c.num_classes)
        self.density_mlp = MlpSequence(c.out_dim, c.out_dim * 2, 2,
                                       final_softplus=True)
        self.semantic_mlp = MlpSequence(c.out_dim, c.out_dim * 2,
                                        c.num_classes - 1)
        self.color_mlp = MlpSequence(c.out_dim, c.out_dim * 2, 3)

    def _segment(self, fn, *args, **kwargs):
        """fn(*args, **kwargs), under `checkpoint` when `cfg.remat` and a
        gradient is being recorded."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn(*args, **kwargs)
        return checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), recompute_context()),
            **kwargs)

    def _backbone(self, x, stage0_only, generator):
        """Image backbone on (B*N, H, W, 3), stochastic depth drawn from
        `generator` (Swin, training)."""
        if generator is None or self.cfg.backbone != "swin":
            return self._segment(self.img_backbone, x, stage0_only)
        drops = self.img_backbone.draw_drop_scales(x.shape[0], generator,
                                                   stage0_only)
        return self._segment(self.img_backbone, x, stage0_only, drops)

    def _encode_image(self, imgs, generator=None):
        """(B, N, H, W, 3) -> ((B, N, hf, wf, C_neck), stereo feat)."""
        B, N = imgs.shape[:2]
        feats = self._backbone(imgs.reshape(B * N, *imgs.shape[2:]), False,
                               generator)
        neck = self.img_neck(feats[1:])
        return neck.reshape(B, N, *neck.shape[1:]), feats[0]

    def _aspp_dropout(self, B, N, generator):
        """The depth net's ASPP dropout mask, scaled by 1 / keep, drawn on
        the host; None when not training or at rate 0."""
        aspp = self.view_transformer.depth_net.aspp
        if generator is None or aspp.dropout_rate == 0.0:
            return None
        c = self.cfg
        keep = 1.0 - aspp.dropout_rate
        shape = (B * N, c.input_size[0] // self.view_transformer.downsample,
                 c.input_size[1] // self.view_transformer.downsample,
                 c.neck_out_channels)
        return (torch.rand(shape, generator=generator) < keep).float() / keep

    def extract_voxel_feat(self, batch: Dict[str, torch.Tensor],
                           train: bool = False,
                           generator: Optional[torch.Generator] = None):
        """3-frame stereo loop + BEV encoder -> voxel feats (B, X, Y, Z,
        out_dim) f32 and key-frame depth (B, N, D, hf, wf) f32.

        train: draw stochastic-depth and dropout masks from `generator` (a
        host generator, required) and keep gradients for the key frame only.
        BatchNorm follows the module's train / eval mode.
        """
        c = self.cfg
        imgs = batch["imgs"].to(c.dtype)
        B, T, N = imgs.shape[:3]
        if T != c.num_frames:
            raise ValueError(f"expected {c.num_frames} frames, got {T}")
        if train and generator is None:
            raise ValueError("train=True needs a torch.Generator")
        gen = generator if train else None
        if self.stereo_on_plane_sweep:
            check_planar_post_aug(batch["post_rots"])
        s2keyego = sensor2keyego_chain(batch["sensor2egos"],
                                       batch["ego2globals"])
        curr2adj = curr2adjsensor_chain(batch["sensor2egos"],
                                        batch["ego2globals"],
                                        c.temporal_frames)
        stereo_feat_prev = None
        bev_feats = []
        depth_key = None
        for fid in range(c.num_frames - 1, -1, -1):
            frame_imgs = imgs[:, fid]
            if fid >= c.temporal_frames:  # stereo-only reference frame
                x = frame_imgs.reshape(B * N, *frame_imgs.shape[2:])
                with torch.no_grad():
                    stereo_feat_prev = self._backbone(x, True, gen)[0]
                continue
            grads = contextlib.nullcontext() if fid == 0 else torch.no_grad()
            with grads:
                voxel, depth, stereo_feat = self._frame(
                    batch, fid, frame_imgs, s2keyego, curr2adj,
                    stereo_feat_prev, gen)
            if fid == 0:
                depth_key = depth
            bev_feats.append(voxel)
            stereo_feat_prev = stereo_feat
        x = torch.cat(bev_feats, dim=-1)  # [adj, key]
        x = self.bev_neck(self._segment(self.bev_backbone, x))
        x = self.final_conv(x.float())
        # (B, Z, Y, X, C) -> (B, X, Y, Z, C)
        voxel_feats = x.permute(0, 3, 2, 1, 4)
        return voxel_feats, depth_key.float()

    def _frame(self, batch, fid, frame_imgs, s2keyego, curr2adj,
               stereo_feat_prev, gen):
        """One temporal frame: image encoder, stereo cost volume, view
        transformer and pre-process net -> (voxel feat, depth, stage-0
        stereo feat)."""
        c = self.cfg
        B, N = frame_imgs.shape[:2]
        cams = {
            "sensor2keyego": s2keyego[:, fid],
            "intrin": batch["intrins"][:, fid],
            "post_rot": batch["post_rots"][:, fid],
            "post_tran": batch["post_trans"][:, fid],
            "bda": batch["bda"],
            # the mlp input always takes the KEY frame pose
            "mlp_input": get_mlp_input(
                s2keyego[:, 0], batch["ego2globals"][:, 0],
                batch["intrins"][:, fid], batch["post_rots"][:, fid],
                batch["post_trans"][:, fid], batch["bda"]),
        }
        feat, stereo_feat = self._encode_image(frame_imgs, gen)
        stereo_feat = stereo_feat.detach()
        with torch.no_grad():
            cost_volume = None
            if stereo_feat_prev is not None:
                cost_volume = compute_stereo_cost_volume(
                    self.cv_frustum, cams,
                    {"prev_feat": stereo_feat_prev,
                     "curr_feat": stereo_feat,
                     "k2s_sensor": curr2adj[:, fid]},
                    c.input_size, self.view_transformer.cost_volume_bias)
            pool_vox = voxel_indices(
                frustum_to_lidar(self.pool_frustum, cams["sensor2keyego"],
                                 cams["intrin"], cams["post_rot"],
                                 cams["post_tran"], cams["bda"]),
                c.grid)
        drop = self._aspp_dropout(B, N, gen)
        if drop is not None:
            drop = drop.to(feat.device, non_blocking=True)
        voxel, depth = self._segment(self.view_transformer, feat, cams,
                                     cost_volume, pool_vox, drop)
        voxel = self._segment(self.pre_process, voxel)[0]
        return voxel, depth, stereo_feat

    def predict_attributes(self, voxel_feats):
        density = self.density_mlp(voxel_feats)[..., 0]
        return density, self.semantic_mlp(voxel_feats), \
            self.color_mlp(voxel_feats)

    def occupancy_logits(self, voxel_feats):
        return self.occupancy_head(voxel_feats)

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Stage-dependent loss dict, each loss times its weight. Call in
        train mode.

        if_post_finetune: focal (or CE), semantic scal, geometric scal and
        Lovasz on the occupancy logits. if_render: the render head's losses
        on the density, semantic and colour fields (f32) along
        `batch["rays"]`. use_lss_depth_loss: BCE of the key frame's depth
        against `batch["gt_depth"]`."""
        c = self.cfg
        voxel_feats, depth = self.extract_voxel_feat(batch, train=True,
                                                     generator=generator)
        losses: Dict[str, torch.Tensor] = {}
        if c.if_post_finetune:
            logits = self.occupancy_logits(voxel_feats)
            target = batch["voxel_semantics"].long()
            cls_w = torch.from_numpy(voxel_class_weights(
                c.num_classes, c.balance_cls_weight)).to(logits.device)
            if c.use_focal_loss:
                ce = distance_weighted_focal_loss(logits, target, cls_w)
            else:
                ce = ce_ssc_loss(logits, target, cls_w)
            losses["loss_voxel_ce"] = c.weight_voxel_ce * ce
            losses["loss_voxel_sem"] = c.weight_voxel_sem_scal * \
                sem_scal_loss(logits, target)
            losses["loss_voxel_geo"] = c.weight_voxel_geo_scal * \
                geo_scal_loss(logits, target, non_empty_idx=c.empty_idx)
            losses["loss_voxel_lovasz"] = c.weight_voxel_lovasz * \
                lovasz_softmax_loss(logits, target, ignore_index=c.empty_idx)
        if c.if_render:
            density, semantic, color = self.predict_attributes(voxel_feats)
            losses.update(nerf_head_losses(density, semantic, color,
                                           batch["rays"], batch["bda"],
                                           c.nerf))
        if c.use_lss_depth_loss:
            losses["loss_lss_depth"] = depth_bce_loss(
                depth, batch["gt_depth"], self.view_transformer.downsample,
                c.grid, weight=c.depth_loss_weight)
        return losses

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{'semantic_occ', 'geo_occ'}: (B, X, Y, Z) int32 in [0, 17]."""
        c = self.cfg
        voxel_feats, _ = self.extract_voxel_feat(batch)
        empty = c.num_classes - 1
        if not c.if_post_finetune:
            density, semantic, _ = self.predict_attributes(voxel_feats)
            occupied = density > c.test_threshold
            occ = torch.where(occupied, semantic.argmax(-1), empty)
            geo = torch.where(occupied, 0, empty)
        else:
            occ = self.occupancy_logits(voxel_feats).argmax(-1)
            geo = torch.where(occ != c.empty_idx, 0, empty)
        return {"semantic_occ": occ.to(torch.int32),
                "geo_occ": geo.to(torch.int32)}
