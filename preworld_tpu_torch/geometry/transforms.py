"""Rigid-transform chains: sensor -> key-ego and curr -> adjacent-sensor,
and the BEV-augmentation matrix.

Counterpart of `preworld_tpu/geometry/transforms.py`: the chains on torch
tensors, `bda_matrix` in numpy for the data pipeline.
"""

from __future__ import annotations

import numpy as np
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


def bda_matrix(rotate_angle_deg: float = 0.0, scale_ratio: float = 1.0,
               flip_dx: bool = False, flip_dy: bool = False) -> np.ndarray:
    """BEV-augmentation 3x3 f32 matrix: rotation about z, a uniform 3-axis
    scale, then the x / y flips, composed as flip @ scale @ rot
    (`bev_transform`, reference `loading.py:1174-1204`)."""
    ang = np.deg2rad(rotate_angle_deg)
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0],
                    [0, 0, 1]], np.float32)
    scale = np.eye(3, dtype=np.float32) * scale_ratio
    flip = np.eye(3, dtype=np.float32)
    if flip_dx:
        flip[0, 0] = -1.0
    if flip_dy:
        flip[1, 1] = -1.0
    return (flip @ scale @ rot).astype(np.float32)
