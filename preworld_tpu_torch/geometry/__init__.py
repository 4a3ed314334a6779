from .frustum import (
    GridConfig,
    create_frustum,
    frustum_pixel_indices,
    frustum_to_lidar,
    voxel_indices,
)
from .transforms import curr2adjsensor_chain, invert_rigid, sensor2keyego_chain

__all__ = [
    "GridConfig",
    "create_frustum",
    "curr2adjsensor_chain",
    "frustum_pixel_indices",
    "frustum_to_lidar",
    "invert_rigid",
    "sensor2keyego_chain",
    "voxel_indices",
]
