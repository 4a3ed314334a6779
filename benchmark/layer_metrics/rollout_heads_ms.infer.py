"""Occupancy head time of a forecasting request: its passes over the key
frame's and each future step's grid (7 at num_future 6).

Device ms a request of the kernels whose launches the host issued inside
the module range occupancy_head of the traced span."""

LAYER = "BEV encoder and heads"
UNIT = "ms"
MOVES = "occ_frames_per_s"
RANGES = ('occupancy_head',)


def read(s):
    ms = s.get("range_ms", {})
    if not any(r in ms for r in RANGES):
        return None
    return sum(ms.get(r, 0.0) for r in RANGES) / s["frames"]
