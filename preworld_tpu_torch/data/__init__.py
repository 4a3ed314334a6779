from .synthetic import (
    camera_rig,
    frame_batch,
    synthetic_batch,
    tiny_config,
    tiny_nerf_config,
    to_device,
)

__all__ = ["camera_rig", "frame_batch", "synthetic_batch", "tiny_config",
           "tiny_nerf_config", "to_device"]
