"""Forecast rollout time (the ego MLPs, the per-voxel fusion MLP, the
strided 3-D convs that pool the grid, the waypoint head).

Device ms a request of the kernels whose launches the host issued inside
the module ranges plan_head, fusion_head, downscale, ego_fusion_head,
traj_head of the traced span, over all the request's future steps (the
concatenation and the residual add around the fusion MLP launch outside
them)."""

LAYER = "forecast rollout"
UNIT = "ms"
MOVES = "occ_frames_per_s"
RANGES = ('plan_head', 'fusion_head', 'downscale', 'ego_fusion_head',
          'traj_head')


def read(s):
    ms = s.get("range_ms", {})
    if not any(r in ms for r in RANGES):
        return None
    return sum(ms.get(r, 0.0) for r in RANGES) / s["frames"]
