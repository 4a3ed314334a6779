"""Rigid-transform chains: sensor -> key-ego and curr -> adjacent-sensor.

Counterpart of `preworld_tpu/geometry/transforms.py` for torch tensors.
"""

from __future__ import annotations

import torch


def invert_rigid(mat):
    """Invert a (..., 4, 4) rigid transform exactly (R^T, -R^T t)."""
    r = mat[..., :3, :3]
    t = mat[..., :3, 3:]
    r_inv = r.transpose(-1, -2)
    out = torch.zeros_like(mat)
    out[..., :3, :3] = r_inv
    out[..., :3, 3:] = -r_inv @ t
    out[..., 3, 3] = 1.0
    return out


def sensor2keyego_chain(sensor2egos, ego2globals):
    """(B, T, N, 4, 4) poses -> each (frame, cam) sensor in the key frame's
    ego (frame 0, cam 0): inv(ego2global[key]) @ ego2global @ sensor2ego."""
    global2keyego = invert_rigid(ego2globals[:, 0:1, 0:1])
    out = global2keyego @ ego2globals @ sensor2egos
    return out.to(torch.float32)


def curr2adjsensor_chain(sensor2egos, ego2globals, temporal_frames: int):
    """(B, temporal_frames, N, 4, 4): frame-t sensor -> frame-(t+1) sensor,
    inv(ego2global_adj @ sensor2ego_adj) @ ego2global_curr @ sensor2ego_curr."""
    curr_s2e = sensor2egos[:, :temporal_frames]
    curr_e2g = ego2globals[:, :temporal_frames]
    adj_s2e = sensor2egos[:, 1:temporal_frames + 1]
    adj_e2g = ego2globals[:, 1:temporal_frames + 1]
    out = invert_rigid(adj_e2g @ adj_s2e) @ curr_e2g @ curr_s2e
    return out.to(torch.float32)
