"""The render head's ray record.

Counterpart of the layout of `preworld_tpu/geometry/rays.py`: a batch
carries its rays as a fixed-size (B, R, RAY_DIM) f32 array, one 16-float
record per ray,

    [u, v, depth, seg, rays_o(3), rays_d(3), viewdirs(3), rgb(3)]

(pixel, lidar depth, semantic label, origin, direction, unit direction,
colour). The lidar ray builders of the JAX module wait for the data
pipeline.
"""

RAY_DIM = 16
PIXEL = slice(0, 2)
DEPTH = 2
SEMANTIC = 3
ORIGIN = slice(4, 7)
DIRECTION = slice(7, 10)
UNIT_DIRECTION = slice(10, 13)
COLOR = slice(13, 16)
