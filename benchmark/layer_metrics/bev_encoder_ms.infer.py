"""BEV encoder and heads time (the 3-D ResNets, LSSFPN3D, final_conv, the occupancy head).

Device ms a frame of the kernels whose launches the host issued inside the
module ranges pre_process, bev_backbone, bev_neck, final_conv, occupancy_head of the traced span."""

LAYER = "BEV encoder and heads"
UNIT = "ms"
MOVES = "occ_frames_per_s"
RANGES = ('pre_process', 'bev_backbone', 'bev_neck', 'final_conv', 'occupancy_head')


def read(s):
    ms = s.get("range_ms", {})
    if not any(r in ms for r in RANGES):
        return None
    return sum(ms.get(r, 0.0) for r in RANGES) / s["frames"]
