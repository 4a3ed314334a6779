"""PreWorld: the occupancy world model, inference and both train stages.

Counterpart of `preworld_tpu/models/preworld.py`: `PreWorldConfig`,
`TinyBackbone`, and `PreWorld.extract_voxel_feat` / `predict` (the 3-frame
stereo loop, with the reference's test-time `align_after_vt` as an option)
/ `predict_attributes` / `occupancy_logits` / `loss`, and streaming
inference, `init_sequential_cache` / `predict_sequential` (one new frame a
step, the previous voxel feature ego-aligned from a cache). `loss` covers
the finetune stage's four voxel losses (`if_post_finetune`), the pretrain
stage's render losses (`if_render`, `models/nerf_head.py`) and its LSS
depth loss (`use_lss_depth_loss`).

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
masks come from the caller's host `torch.Generator`, in the stereo loop's
order of draws; `models/mask_plan.py` draws a step's masks ahead on a host
worker thread from a copy of the generator's state while the card runs
the step before, and uses them only when the caller's generator is in that
state, so they are the masks inline draws give. Under a mesh
(`parallel.use_mesh`) each rank draws the global batch's masks and keeps
its rows, and the losses are its shares of the global batch's. With
`cfg.remat`, `torch.utils.checkpoint` recomputes the image backbone, the
view transformer and the two 3-D ResNets in the backward, the segments of
the JAX package's `nn.remat`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..geometry.frustum import (
    GridConfig,
    create_frustum,
    frustum_to_lidar,
    voxel_indices,
)
from ..geometry.transforms import (
    curr2adjsensor_chain,
    invert_rigid,
    sensor2keyego_chain,
)
from ..losses.voxel import (
    ce_ssc_loss,
    distance_weighted_focal_loss,
    geo_scal_loss,
    lovasz_softmax_loss,
    sem_scal_loss,
    voxel_class_weights,
)
from ..parallel.mesh import data_rows, draw_rows
from ..utils import trace
from .fpn import FPN_LSS, LSSFPN3D
from .layers import ConvNormAct, MlpSequence, recompute_context
from .mask_plan import Draw, MaskPlanner, StepDraws
from .nerf_head import NerfHeadConfig, nerf_head_losses
from .occ_head import OccHead
from .resnet import CustomResNet3D
from .swin import SwinTransformer
from .temporal_align import shift_voxel_feature
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
        self._mask_plan = MaskPlanner()

    def _segment(self, fn, *args, **kwargs):
        """fn(*args, **kwargs), under `checkpoint` when `cfg.remat` and a
        gradient is being recorded."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn(*args, **kwargs)
        return checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), recompute_context()),
            **kwargs)

    def _drop_path_on(self) -> bool:
        return self.cfg.backbone == "swin" \
            and self.img_backbone.drop_path_rate > 0

    def _mask_draws(self, rows: int) -> List[Draw]:
        """The host draws of a train-mode forward over `rows` (B*N) images
        a frame, in the stereo loop's order: on each frame from the last,
        the Swin's stochastic-depth scales (stage 0 only on a stereo-only
        frame), then on a temporal frame the ASPP dropout mask; none at
        rate 0. Under a mesh each is this rank's rows of the global
        batch's draw; the mesh is read here, on the caller's thread."""
        c = self.cfg
        mesh_rows = data_rows()
        out: List[Draw] = []
        rate = self.view_transformer.depth_net.aspp.dropout_rate
        shape = (c.input_size[0] // self.view_transformer.downsample,
                 c.input_size[1] // self.view_transformer.downsample,
                 c.neck_out_channels)
        for fid in range(c.num_frames - 1, -1, -1):
            stage0_only = fid >= c.temporal_frames
            if self._drop_path_on():
                out.append(_drop_path_draw(self.img_backbone, rows,
                                           stage0_only, mesh_rows))
            if not stage0_only and rate != 0.0:
                out.append(_aspp_draw(rows, shape, 1.0 - rate, mesh_rows))
        return out

    @trace.spanned("image_backbone")
    def _backbone(self, x, stage0_only, draws: Optional[StepDraws]):
        """Image backbone on (B*N, H, W, 3), stochastic depth from `draws`
        (Swin, training)."""
        if draws is None or not self._drop_path_on():
            return self._segment(self.img_backbone, x, stage0_only)
        with trace.span("masks"):
            drops = draws.take(("drop_path", stage0_only))
        return self._segment(self.img_backbone, x, stage0_only, drops)

    def _encode_image(self, imgs, draws=None):
        """(B, N, H, W, 3) -> ((B, N, hf, wf, C_neck), stereo feat)."""
        B, N = imgs.shape[:2]
        feats = self._backbone(imgs.reshape(B * N, *imgs.shape[2:]), False,
                               draws)
        with trace.span("view_transformer"):
            neck = self.img_neck(feats[1:])
        return neck.reshape(B, N, *neck.shape[1:]), feats[0]

    def _aspp_dropout(self, draws: Optional[StepDraws], device):
        """The depth net's ASPP dropout mask on `device` in `cfg.dtype`,
        scaled by 1 / keep; None when not training or at rate 0. The mask
        comes from `draws` as bool on the host (under a mesh, this rank's
        rows of the global batch's draw), drawn ahead from the host
        generator's own stream (`models/mask_plan.py`) so that the CPU and
        card runs of a step see the same masks, and is uploaded here,
        asynchronously from pinned memory on a card, and scaled there:
        `mask * (1 / keep)` with 1 / keep rounded from float32 to the
        dtype, the same numbers as the f32 mask `(u < keep) / keep` cast to
        it."""
        aspp = self.view_transformer.depth_net.aspp
        if draws is None or aspp.dropout_rate == 0.0:
            return None
        dtype = self.cfg.dtype
        scale = float((torch.ones((), dtype=torch.float32)
                       / (1.0 - aspp.dropout_rate)).to(dtype))
        with trace.span("masks"):
            kept = draws.take("aspp")
            return kept.to(device, non_blocking=True).to(dtype).mul_(scale)

    def extract_voxel_feat(self, batch: Dict[str, torch.Tensor],
                           train: bool = False,
                           generator: Optional[torch.Generator] = None,
                           align_after_vt: bool = False):
        """3-frame stereo loop + BEV encoder -> voxel feats (B, X, Y, Z,
        out_dim) f32 and key-frame depth (B, N, D, hf, wf) f32.

        train: draw stochastic-depth and dropout masks from `generator` (a
        host generator, required) and keep gradients for the key frame only.
        The masks are those of inline draws from the generator in the loop's
        order, bit for bit, and the generator ends where those draws leave
        it; a worker thread draws them a step ahead where it can
        (`models/mask_plan.py`): the step that follows on the generator's
        state finds them drawn. BatchNorm follows the module's train / eval
        mode.
        align_after_vt: the reference's test-time protocol: pool the
        adjacent frame into its own ego, then warp its voxel feature to the
        key ego (`shift_voxel_feature`); by default it is pooled into the
        key ego directly.
        """
        c = self.cfg
        imgs = batch["imgs"].to(c.dtype)
        B, T, N = imgs.shape[:3]
        if T != c.num_frames:
            raise ValueError(f"expected {c.num_frames} frames, got {T}")
        if train and generator is None:
            raise ValueError("train=True needs a torch.Generator")
        draws = self._mask_plan.step(
            generator, self._mask_draws(B * N),
            imgs.device.type == "cuda") if train else None
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
                    stereo_feat_prev = self._backbone(x, True, draws)[0]
                continue
            grads = contextlib.nullcontext() if fid == 0 else torch.no_grad()
            own_ego = align_after_vt and fid != 0
            with grads:
                voxel, depth, stereo_feat = self._frame(
                    batch, fid, frame_imgs, s2keyego, curr2adj,
                    stereo_feat_prev, draws, own_ego)
                if own_ego:
                    with trace.span("geometry"):
                        voxel = shift_voxel_feature(
                            voxel.float(), s2keyego[:, 0], s2keyego[:, fid],
                            batch["bda"].float(), c.grid).to(voxel.dtype)
            if fid == 0:
                depth_key = depth
            bev_feats.append(voxel)
            stereo_feat_prev = stereo_feat
        return self._bev_encode(bev_feats), depth_key.float()

    @trace.spanned("bev_encoder")
    def _bev_encode(self, bev_feats):
        """[adjacent, key] voxel feats (B, Z, Y, X, C) -> BEV encoder and
        final_conv -> (B, X, Y, Z, out_dim) f32."""
        x = torch.cat(bev_feats, dim=-1)
        x = self.bev_neck(self._segment(self.bev_backbone, x))
        x = self.final_conv(x.float())
        return x.permute(0, 3, 2, 1, 4)

    def _frame(self, batch, fid, frame_imgs, s2keyego, curr2adj,
               stereo_feat_prev, draws, own_ego=False):
        """One temporal frame: image encoder, stereo cost volume, view
        transformer and pre-process net -> (voxel feat, depth, stage-0
        stereo feat). own_ego: pool into the frame's own ego instead of the
        key ego (the cost volume and the mlp input keep the key pose)."""
        c = self.cfg
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
        feat, stereo_feat = self._encode_image(frame_imgs, draws)
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
            with trace.span("geometry"):
                s2pool = cams["sensor2keyego"]
                if own_ego:
                    s2pool = _own_ego(batch["sensor2egos"][:, fid],
                                      batch["ego2globals"][:, fid])
                pool_vox = voxel_indices(
                    frustum_to_lidar(self.pool_frustum, s2pool,
                                     cams["intrin"], cams["post_rot"],
                                     cams["post_tran"], cams["bda"]),
                    c.grid)
        with trace.span("view_transformer"):
            drop = self._aspp_dropout(draws, feat.device)
            voxel, depth = self._segment(self.view_transformer, feat, cams,
                                         cost_volume, pool_vox, drop)
        with trace.span("bev_encoder"):
            voxel = self._segment(self.pre_process, voxel)[0]
        return voxel, depth, stereo_feat

    def predict_attributes(self, voxel_feats):
        density = self.density_mlp(voxel_feats)[..., 0]
        return density, self.semantic_mlp(voxel_feats), \
            self.color_mlp(voxel_feats)

    @trace.spanned("bev_encoder")
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
            losses.update(self._voxel_losses(
                self.occupancy_logits(voxel_feats),
                batch["voxel_semantics"].long()))
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

    def _voxel_losses(self, logits, target, suffix: str = ""):
        """The four weighted voxel losses of `logits` (B, X, Y, Z, C) f32
        against `target` (B, X, Y, Z) int64, each key ending in `suffix`:
        focal (or CE), semantic scal, geometric scal and Lovasz."""
        c = self.cfg
        cls_w = torch.from_numpy(voxel_class_weights(
            c.num_classes, c.balance_cls_weight)).to(logits.device)
        if c.use_focal_loss:
            ce = distance_weighted_focal_loss(logits, target, cls_w)
        else:
            ce = ce_ssc_loss(logits, target, cls_w)
        return {
            "loss_voxel_ce" + suffix: c.weight_voxel_ce * ce,
            "loss_voxel_sem" + suffix: c.weight_voxel_sem_scal
            * sem_scal_loss(logits, target),
            "loss_voxel_geo" + suffix: c.weight_voxel_geo_scal
            * geo_scal_loss(logits, target, non_empty_idx=c.empty_idx),
            "loss_voxel_lovasz" + suffix: c.weight_voxel_lovasz
            * lovasz_softmax_loss(logits, target, ignore_index=c.empty_idx),
        }

    def _occupancy(self, voxel_feats):
        """The inference head: (semantic_occ, geo_occ), (B, X, Y, Z) int32
        in [0, 17]."""
        c = self.cfg
        empty = c.num_classes - 1
        if not c.if_post_finetune:
            density, semantic, _ = self.predict_attributes(voxel_feats)
            occupied = density > c.test_threshold
            occ = torch.where(occupied, semantic.argmax(-1), empty)
            geo = torch.where(occupied, 0, empty)
        else:
            occ = self.occupancy_logits(voxel_feats).argmax(-1)
            geo = torch.where(occ != c.empty_idx, 0, empty)
        return occ.to(torch.int32), geo.to(torch.int32)

    @torch.no_grad()
    @trace.spanned("predict")
    def predict(self, batch: Dict[str, torch.Tensor],
                align_after_vt: bool = False) -> Dict[str, torch.Tensor]:
        """{'semantic_occ', 'geo_occ'}: (B, X, Y, Z) int32 in [0, 17].
        align_after_vt: see `extract_voxel_feat`."""
        voxel_feats, _ = self.extract_voxel_feat(
            batch, align_after_vt=align_after_vt)
        occ, geo = self._occupancy(voxel_feats)
        return {"semantic_occ": occ, "geo_occ": geo}

    # ------------------------------------------------ streaming inference

    @torch.no_grad()
    def init_sequential_cache(self, batch: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
        """The cache before the first streaming step, on the batch's
        device: zero `bev_feat` (B, Z, Y, X, num_trans_channels) and
        `stereo_feat` (B*N, H/4, W/4, C0) in `cfg.dtype`, the frame's poses,
        and `pool_vox`, the pooling's voxel ids, computed once from this
        frame and reused every step (the rig is fixed and sensor2keyego is
        ego-relative). batch: one frame, imgs (B, N, H, W, 3) and the
        camera tensors without the frame axis."""
        c = self.cfg
        B, N = batch["imgs"].shape[:2]
        dev = batch["imgs"].device
        sx, sy, sz = (int(v) for v in c.grid.size)
        down = self.view_transformer.cv_downsample
        c0 = c.swin_embed_dims if c.backbone == "swin" else 16
        pool_vox = voxel_indices(
            frustum_to_lidar(self.pool_frustum,
                             _own_ego(batch["sensor2egos"],
                                      batch["ego2globals"]),
                             batch["intrins"], batch["post_rots"],
                             batch["post_trans"], batch["bda"]),
            c.grid)
        return {
            "bev_feat": torch.zeros((B, sz, sy, sx, c.num_trans_channels),
                                    dtype=c.dtype, device=dev),
            "stereo_feat": torch.zeros(
                (B * N, c.input_size[0] // down, c.input_size[1] // down, c0),
                dtype=c.dtype, device=dev),
            "sensor2egos": batch["sensor2egos"],
            "ego2globals": batch["ego2globals"],
            "pool_vox": pool_vox,
        }

    @torch.no_grad()
    def sequential_voxel_feat(self, batch: Dict[str, torch.Tensor],
                              cache: Dict[str, torch.Tensor]):
        """One streaming step up to the heads -> (voxel feats (B, X, Y, Z,
        out_dim) f32, new cache). Encodes only the new frame; its stereo
        reference is the cached stage-0 feature (zeros on the first step,
        which still runs the cost volume), its pooling takes the cached
        `pool_vox`, and the cached voxel feature, warped from the previous
        key ego into this one, is its adjacent frame. The new cache holds
        this step's voxel feature before any warp."""
        c = self.cfg
        imgs = batch["imgs"].to(c.dtype)
        if self.stereo_on_plane_sweep:
            check_planar_post_aug(batch["post_rots"])
        s2e, e2g = batch["sensor2egos"], batch["ego2globals"]
        key_inv = invert_rigid(e2g[:, 0:1])
        s2keyego = (key_inv @ e2g @ s2e).float()
        prev_pose = cache["ego2globals"] @ cache["sensor2egos"]
        cams = {
            "intrin": batch["intrins"], "post_rot": batch["post_rots"],
            "post_tran": batch["post_trans"], "bda": batch["bda"],
            "mlp_input": get_mlp_input(
                s2keyego, e2g, batch["intrins"], batch["post_rots"],
                batch["post_trans"], batch["bda"]),
        }
        feat, stereo_feat = self._encode_image(imgs)
        cost_volume = compute_stereo_cost_volume(
            self.cv_frustum, cams,
            {"prev_feat": cache["stereo_feat"], "curr_feat": stereo_feat,
             # current sensor -> previous sensor
             "k2s_sensor": (invert_rigid(prev_pose) @ e2g @ s2e).float()},
            c.input_size, self.view_transformer.cost_volume_bias)
        with trace.span("view_transformer"):
            voxel, _ = self.view_transformer(feat, cams, cost_volume,
                                             cache["pool_vox"])
        with trace.span("bev_encoder"):
            voxel = self.pre_process(voxel)[0]
        with trace.span("geometry"):
            shifted_prev = shift_voxel_feature(
                cache["bev_feat"].float(), s2keyego,
                (key_inv @ prev_pose).float(), batch["bda"].float(),
                c.grid).to(voxel.dtype)
        new_cache = {"bev_feat": voxel, "stereo_feat": stereo_feat,
                     "sensor2egos": s2e, "ego2globals": e2g,
                     "pool_vox": cache["pool_vox"]}
        return self._bev_encode([shifted_prev, voxel]), new_cache

    @torch.no_grad()
    @trace.spanned("predict_sequential")
    def predict_sequential(self, batch: Dict[str, torch.Tensor],
                           cache: Dict[str, torch.Tensor]):
        """One streaming step -> ({'semantic_occ'}, new cache); see
        `sequential_voxel_feat`."""
        voxel_feats, new_cache = self.sequential_voxel_feat(batch, cache)
        return {"semantic_occ": self._occupancy(voxel_feats)[0]}, new_cache


def _own_ego(sensor2egos, ego2globals):
    """One frame's (B, N, 4, 4) poses -> each sensor in that frame's own
    key ego (camera 0's ego), f32."""
    return (invert_rigid(ego2globals[:, 0:1]) @ ego2globals
            @ sensor2egos).float()


def _drop_path_draw(backbone: SwinTransformer, rows: int, stage0_only: bool,
                    mesh_rows: Tuple[int, int]) -> Draw:
    """The Swin's stochastic-depth scales of one frame."""
    return Draw(("drop_path", stage0_only),
                ("drop_path", rows, mesh_rows, stage0_only,
                 backbone.drop_path_rate, backbone.depths),
                lambda gen, _: backbone.draw_drop_scales(
                    rows, gen, stage0_only, mesh_rows))


def _aspp_draw(rows: int, shape: Tuple[int, int, int], keep: float,
               mesh_rows: Tuple[int, int]) -> Draw:
    """The ASPP dropout mask of one frame, `u < keep` for u uniform, as
    bool into the draw's buffer."""
    def draw(gen, out):
        u = draw_rows(lambda n: torch.rand((n, *shape), generator=gen), rows,
                      mesh_rows)
        return torch.lt(u, keep, out=out)

    return Draw("aspp", ("aspp", rows, mesh_rows, shape, keep), draw,
                (rows, *shape))
