from .frustum import (
    GridConfig,
    create_frustum,
    frustum_pixel_indices,
    frustum_to_lidar,
    voxel_indices,
)
from .transforms import (
    bda_matrix,
    curr2adjsensor_chain,
    invert_rigid,
    sensor2keyego_chain,
)

__all__ = [
    "GridConfig",
    "bda_matrix",
    "create_frustum",
    "curr2adjsensor_chain",
    "frustum_pixel_indices",
    "frustum_to_lidar",
    "invert_rigid",
    "sensor2keyego_chain",
    "voxel_indices",
]
