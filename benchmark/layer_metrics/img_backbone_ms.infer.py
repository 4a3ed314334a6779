"""Image backbone time (Swin-B's K1 / K2 blocks, patch embed and merging).

Device ms a frame of the kernels whose launches the host issued inside the
module ranges img_backbone of the traced span."""

LAYER = "image backbone"
UNIT = "ms"
MOVES = "occ_frames_per_s"
RANGES = ('img_backbone',)


def read(s):
    ms = s.get("range_ms", {})
    if not any(r in ms for r in RANGES):
        return None
    return sum(ms.get(r, 0.0) for r in RANGES) / s["frames"]
