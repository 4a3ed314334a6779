from .frustum import (
    GridConfig,
    create_frustum,
    frustum_pixel_indices,
    frustum_to_lidar,
    voxel_indices,
)
from .rays import RAY_DIM, build_rays, get_rays, weighted_ray_sample
from .transforms import (
    bda_matrix,
    curr2adjsensor_chain,
    invert_rigid,
    sensor2keyego_chain,
)

__all__ = [
    "GridConfig",
    "RAY_DIM",
    "bda_matrix",
    "build_rays",
    "create_frustum",
    "curr2adjsensor_chain",
    "frustum_pixel_indices",
    "frustum_to_lidar",
    "get_rays",
    "invert_rigid",
    "sensor2keyego_chain",
    "voxel_indices",
    "weighted_ray_sample",
]
