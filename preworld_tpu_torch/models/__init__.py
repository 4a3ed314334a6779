from .bevstereo_occ import BEVStereoOCC
from .preworld import PreWorld, PreWorldConfig, TinyBackbone
from .preworld_traj import PreWorld4DTraj, l2_traj_loss, rollout_curriculum
from .swin import SwinTransformer

__all__ = ["BEVStereoOCC", "PreWorld", "PreWorld4DTraj", "PreWorldConfig",
           "SwinTransformer", "TinyBackbone", "l2_traj_loss",
           "rollout_curriculum"]
