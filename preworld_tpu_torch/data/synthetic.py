"""Synthetic predict batches (numpy) for tests and the card smoke run.

Counterpart of the predict keys of `preworld_tpu/data/synthetic.py`: for
the same config and seed, `synthetic_batch` returns arrays byte-identical
to the JAX package's `synthetic_batch(..., with_labels=False)`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.frustum import GridConfig
from ..models.preworld import PreWorldConfig


def tiny_config(input_size: Tuple[int, int] = (64, 128), num_cams: int = 2,
                grid: Optional[GridConfig] = None, **overrides) -> PreWorldConfig:
    """A miniature PreWorldConfig (tiny backbone, small grid), the same
    sizes as the JAX package's `tiny_config`."""
    grid = grid or GridConfig(
        x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8), z=(-1.0, 5.4, 0.8),
        depth=(1.0, 9.0, 0.5),
    )
    defaults = dict(grid=grid, input_size=input_size, num_cams=num_cams,
                    backbone="tiny", neck_out_channels=64,
                    num_trans_channels=16, out_dim=16)
    defaults.update(overrides)
    return PreWorldConfig(**defaults)


def camera_rig(num_cams: int, input_size) -> Dict[str, np.ndarray]:
    """Outward-facing ring of pinhole cameras at ego height 1.5 m."""
    H, W = input_size
    s2e = np.zeros((num_cams, 4, 4), np.float32)
    intrin = np.zeros((num_cams, 3, 3), np.float32)
    f = W * 0.8
    for n in range(num_cams):
        a = 2 * np.pi * n / num_cams
        # camera convention: +z forward, +x right, +y down
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([-np.sin(a), np.cos(a), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        s2e[n, :3, :3] = np.stack([right, down, fwd], axis=1)
        s2e[n, :3, 3] = [0.0, 0.0, 1.5]
        s2e[n, 3, 3] = 1.0
        intrin[n] = [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]
    return {"sensor2ego": s2e, "intrin": intrin}


def synthetic_batch(cfg: PreWorldConfig, batch_size: int = 1,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Random-but-consistent predict inputs: normal images, the camera
    ring, an ego driving forward 0.4 m per frame back in time, identity
    post-augs and BEV augmentation."""
    rng = np.random.default_rng(seed)
    H, W = cfg.input_size
    B, T, N = batch_size, cfg.num_frames, cfg.num_cams
    rig = camera_rig(N, cfg.input_size)
    imgs = rng.normal(0, 1, (B, T, N, H, W, 3)).astype(np.float32)
    sensor2egos = np.broadcast_to(
        rig["sensor2ego"][None, None], (B, T, N, 4, 4)).copy()
    ego2globals = np.broadcast_to(
        np.eye(4, dtype=np.float32), (B, T, N, 4, 4)).copy()
    for t in range(T):
        ego2globals[:, t, :, 0, 3] = -0.4 * t
    intrins = np.broadcast_to(rig["intrin"][None, None], (B, T, N, 3, 3)).copy()
    post_rots = np.broadcast_to(
        np.eye(3, dtype=np.float32), (B, T, N, 3, 3)).copy()
    post_trans = np.zeros((B, T, N, 3), np.float32)
    bda = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    return {"imgs": imgs, "sensor2egos": sensor2egos,
            "ego2globals": ego2globals, "intrins": intrins,
            "post_rots": post_rots, "post_trans": post_trans, "bda": bda}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
