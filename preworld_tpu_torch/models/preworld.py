"""PreWorld: the occupancy world model, inference slice.

Counterpart of `preworld_tpu/models/preworld.py`: `PreWorldConfig`,
`TinyBackbone`, and `PreWorld.extract_voxel_feat` / `predict` /
`predict_attributes` / `occupancy_logits` (the 3-frame stereo loop with
`align_after_vt=False`). Streaming, `align_after_vt`, the losses and the
render head are not ported yet.

Batch layout (torch tensors on one device, channel-last):
  imgs (B, T, N, H, W, 3); sensor2egos, ego2globals (B, T, N, 4, 4);
  intrins, post_rots (B, T, N, 3, 3); post_trans (B, T, N, 3); bda (B, 3, 3).
The backbone, necks, view transformer and BEV encoder run in `cfg.dtype`;
`final_conv` and the heads run in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from ..geometry.frustum import (
    GridConfig,
    create_frustum,
    frustum_to_lidar,
    voxel_indices,
)
from ..geometry.transforms import curr2adjsensor_chain, sensor2keyego_chain
from .fpn import FPN_LSS, LSSFPN3D
from .layers import ConvNormAct, MlpSequence
from .occ_head import OccHead
from .resnet import CustomResNet3D
from .swin import SwinTransformer
from .view_transformer import (
    LSSViewTransformer,
    check_planar_post_aug,
    compute_stereo_cost_volume,
    get_mlp_input,
)


@dataclasses.dataclass(frozen=True)
class PreWorldConfig:
    """The JAX package's `PreWorldConfig` fields and defaults, less the
    training-only ones (loss weights, render head, remat); `dtype` is a
    torch dtype."""

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
    if_post_finetune: bool = False
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
        else:
            self.img_backbone = TinyBackbone()
            neck_in = 32 + 64
        self.img_neck = FPN_LSS(neck_in, c.neck_out_channels)
        self.view_transformer = LSSViewTransformer(
            c.grid, c.input_size, downsample=16,
            in_channels=c.neck_out_channels, out_channels=c.num_trans_channels,
            cost_volume_bias=5.0)
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
        for m in (self.img_backbone, self.img_neck, self.view_transformer,
                  self.pre_process, self.bev_backbone, self.bev_neck):
            m.to(c.dtype)

    def _encode_image(self, imgs):
        """(B, N, H, W, 3) -> ((B, N, hf, wf, C_neck), stereo feat)."""
        B, N = imgs.shape[:2]
        feats = self.img_backbone(imgs.reshape(B * N, *imgs.shape[2:]))
        neck = self.img_neck(feats[1:])
        return neck.reshape(B, N, *neck.shape[1:]), feats[0]

    def extract_voxel_feat(self, batch: Dict[str, torch.Tensor]):
        """3-frame stereo loop + BEV encoder -> voxel feats (B, X, Y, Z,
        out_dim) f32 and key-frame depth (B, N, D, hf, wf) f32."""
        c = self.cfg
        imgs = batch["imgs"].to(c.dtype)
        B, T, N = imgs.shape[:3]
        if T != c.num_frames:
            raise ValueError(f"expected {c.num_frames} frames, got {T}")
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
                stereo_feat_prev = self.img_backbone(x, stage0_only=True)[0]
                continue
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
            feat, stereo_feat = self._encode_image(frame_imgs)
            cost_volume = None
            if stereo_feat_prev is not None:
                cost_volume = compute_stereo_cost_volume(
                    self.cv_frustum, cams,
                    {"prev_feat": stereo_feat_prev, "curr_feat": stereo_feat,
                     "k2s_sensor": curr2adj[:, fid]},
                    c.input_size, self.view_transformer.cost_volume_bias)
            pool_vox = voxel_indices(
                frustum_to_lidar(self.pool_frustum, cams["sensor2keyego"],
                                 cams["intrin"], cams["post_rot"],
                                 cams["post_tran"], cams["bda"]),
                c.grid)
            voxel, depth = self.view_transformer(feat, cams, cost_volume,
                                                 pool_vox)
            voxel = self.pre_process(voxel)[0]
            if fid == 0:
                depth_key = depth
            bev_feats.append(voxel)
            stereo_feat_prev = stereo_feat
        x = torch.cat(bev_feats, dim=-1)  # [adj, key]
        x = self.bev_neck(self.bev_backbone(x))
        x = self.final_conv(x.float())
        # (B, Z, Y, X, C) -> (B, X, Y, Z, C)
        voxel_feats = x.permute(0, 3, 2, 1, 4)
        return voxel_feats, depth_key.float()

    def predict_attributes(self, voxel_feats):
        density = self.density_mlp(voxel_feats)[..., 0]
        return density, self.semantic_mlp(voxel_feats), \
            self.color_mlp(voxel_feats)

    def occupancy_logits(self, voxel_feats):
        return self.occupancy_head(voxel_feats)

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
