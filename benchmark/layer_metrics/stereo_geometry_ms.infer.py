"""Stereo and geometry time: kernels inside a frame but outside every module
range (the K3 cost volume, frustum and voxel ids, the streaming warp).

Device ms a frame of the kernels whose launches the host issued inside the
module ranges outside of the traced span."""

LAYER = "stereo and geometry"
UNIT = "ms"
MOVES = "occ_frames_per_s"
RANGES = ('outside',)


def read(s):
    ms = s.get("range_ms", {})
    if not any(r in ms for r in RANGES):
        return None
    return sum(ms.get(r, 0.0) for r in RANGES) / s["frames"]
