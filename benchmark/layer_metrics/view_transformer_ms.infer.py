"""Neck, depth net and lift-splat time (FPN_LSS, DepthNet with ASPP, K4).

Device ms a frame of the kernels whose launches the host issued inside the
module ranges img_neck, view_transformer of the traced span."""

LAYER = "neck, depth net, lift-splat"
UNIT = "ms"
MOVES = "occ_frames_per_s"
RANGES = ('img_neck', 'view_transformer')


def read(s):
    ms = s.get("range_ms", {})
    if not any(r in ms for r in RANGES):
        return None
    return sum(ms.get(r, 0.0) for r in RANGES) / s["frames"]
