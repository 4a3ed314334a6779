from .loader import DataLoader, collate
from .nuplan import NUPLAN_GRID_CONFIG, NuPlanOccDataset
from .nuscenes import (
    DEFAULT_CAMS,
    DYNAMIC_CLASSES,
    NUSC_CLASS_NUMS,
    NuScenesOccDataset,
    wrs_dataset_balance_weight,
)
from .nuscenes_traj import NuScenesOccTrajDataset, flatten_ego_state
from .synthetic import (
    camera_rig,
    frame_batch,
    synthetic_batch,
    tiny_config,
    tiny_nerf_config,
    to_device,
)

__all__ = ["DEFAULT_CAMS", "DYNAMIC_CLASSES", "DataLoader",
           "NUPLAN_GRID_CONFIG", "NUSC_CLASS_NUMS", "NuPlanOccDataset",
           "NuScenesOccDataset", "NuScenesOccTrajDataset", "camera_rig",
           "collate", "flatten_ego_state", "frame_batch",
           "synthetic_batch", "tiny_config", "tiny_nerf_config", "to_device",
           "wrs_dataset_balance_weight"]
