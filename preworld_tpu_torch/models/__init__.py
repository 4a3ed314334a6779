from ..losses.voxel import nusc_class_weights
from .bevstereo_occ import BEVStereoOCC
from .depthnet import ASPP, DepthNet, gen_stereo_grid, stereo_cost_volume
from .fpn import FPN_LSS, LSSFPN3D
from .layers import BasicBlock, ConvNormAct, Mlp, MlpSequence, SELayer, upsample
from .nerf_head import NerfHeadConfig, nerf_head_losses, render_scene
from .occ_head import DownScale3D, OccHead
from .preworld import PreWorld, PreWorldConfig, TinyBackbone
from .preworld_traj import PreWorld4DTraj, l2_traj_loss, rollout_curriculum
from .resnet import CustomResNet, CustomResNet3D
from .swin import SwinTransformer
from .temporal_align import ego_motion_grid, shift_voxel_feature
from .view_transformer import (
    LSSViewTransformer,
    depth_bce_loss,
    downsampled_gt_depth,
    get_mlp_input,
)

__all__ = [
    "ASPP", "BEVStereoOCC", "BasicBlock", "ConvNormAct", "CustomResNet",
    "CustomResNet3D", "DepthNet", "DownScale3D", "FPN_LSS", "LSSFPN3D",
    "LSSViewTransformer", "Mlp", "MlpSequence", "NerfHeadConfig", "OccHead",
    "PreWorld", "PreWorld4DTraj", "PreWorldConfig", "SELayer",
    "SwinTransformer", "TinyBackbone", "depth_bce_loss",
    "downsampled_gt_depth", "ego_motion_grid", "gen_stereo_grid",
    "get_mlp_input", "l2_traj_loss", "nerf_head_losses",
    "nusc_class_weights", "render_scene", "rollout_curriculum",
    "shift_voxel_feature", "stereo_cost_volume", "upsample",
]
