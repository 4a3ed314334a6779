"""Synthetic batches (numpy) for tests and the card smoke run.

Counterpart of `preworld_tpu/data/synthetic.py`: for the same config,
seed, ray count and horizon, `synthetic_batch` returns arrays byte-identical
to the JAX package's `synthetic_batch`, with the training keys
`voxel_semantics`, `mask_camera`, `gt_depth` and the render rays `rays`
when `with_labels`, and the forecasting keys `ego_states`,
`temporal_semantics`, `temporal_rays` and `temporal_trajs` when also
`with_traj`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.frustum import GridConfig
from ..geometry.rays import RAY_DIM
from ..models.nerf_head import NerfHeadConfig
from ..models.preworld import PreWorldConfig
from ..ops.render import RaySamplingSpec
from ..utils import trace


def tiny_config(input_size: Tuple[int, int] = (64, 128), num_cams: int = 2,
                grid: Optional[GridConfig] = None, **overrides) -> PreWorldConfig:
    """A miniature PreWorldConfig (tiny backbone, small grid, short rays),
    the same sizes as the JAX package's `tiny_config`."""
    grid = grid or GridConfig(
        x=(-8.0, 8.0, 0.8), y=(-8.0, 8.0, 0.8), z=(-1.0, 5.4, 0.8),
        depth=(1.0, 9.0, 0.5),
    )
    defaults = dict(grid=grid, input_size=input_size, num_cams=num_cams,
                    backbone="tiny", neck_out_channels=64,
                    num_trans_channels=16, out_dim=16,
                    nerf=tiny_nerf_config())
    defaults.update(overrides)
    return PreWorldConfig(**defaults)


def tiny_nerf_config() -> NerfHeadConfig:
    """`tiny_config`'s render head: rays over the 16 m x 16 m grid."""
    spec = RaySamplingSpec(point_cloud_range=(-8.0, -8.0, -1.0, 8.0, 8.0, 5.4),
                           radius=7.0, step_size=0.5, world_len=20)
    return NerfHeadConfig(spec=spec, max_depth=10.0)


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
                    num_rays: int = 512, seed: int = 0,
                    with_labels: bool = True, with_traj: bool = False,
                    num_future: int = 6) -> Dict[str, np.ndarray]:
    """Random-but-consistent inputs: normal images, the camera ring, an
    ego driving forward 0.4 m per frame back in time, identity post-augs
    and BEV augmentation; with `with_labels`, uniform random occupancy
    classes, a 70 % camera mask, a 10 % sparse lidar depth map and
    `num_rays` render rays per sample; with `with_traj` too, the ego state
    N(0, 1) (B, 21), `num_future` frames of future occupancy classes, the
    key frame's rays repeated per future frame and N(0, 1) waypoints (B,
    num_future, 2), drawn after the rays. The arguments take the JAX
    function's order and defaults; an inference batch passes
    `with_labels=False`."""
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
    batch = {"imgs": imgs, "sensor2egos": sensor2egos,
             "ego2globals": ego2globals, "intrins": intrins,
             "post_rots": post_rots, "post_trans": post_trans, "bda": bda}
    if not with_labels:
        return batch
    sx, sy, sz = (int(v) for v in cfg.grid.size)
    sem = rng.integers(0, cfg.num_classes, (B, sx, sy, sz))
    batch["voxel_semantics"] = sem.astype(np.int32)
    batch["mask_camera"] = rng.uniform(size=sem.shape) > 0.3
    batch["gt_depth"] = np.where(
        rng.uniform(size=(B, N, H, W)) > 0.9,
        rng.uniform(1.5, 20.0, (B, N, H, W)), 0.0).astype(np.float32)
    rays = np.zeros((B, num_rays, RAY_DIM), np.float32)
    rays[..., 0] = rng.integers(0, W, (B, num_rays))
    rays[..., 1] = rng.integers(0, H, (B, num_rays))
    rays[..., 2] = rng.uniform(1.0, 9.0, (B, num_rays))  # depth
    # semantic: only the num_classes - 1 semantic classes reach a pixel
    rays[..., 3] = rng.integers(0, cfg.num_classes - 1, (B, num_rays))
    origins = rng.uniform(-1.0, 1.0, (B, num_rays, 3))
    origins[..., 2] = 1.5
    dirs = rng.normal(size=(B, num_rays, 3))
    dirs[..., 2] *= 0.1
    rays[..., 4:7] = origins
    rays[..., 7:10] = dirs
    rays[..., 10:13] = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays[..., 13:16] = rng.uniform(0, 1, (B, num_rays, 3))
    batch["rays"] = rays
    if with_traj:
        batch["ego_states"] = rng.normal(0, 1, (B, 21)).astype(np.float32)
        batch["temporal_semantics"] = rng.integers(
            0, cfg.num_classes, (B, num_future, sx, sy, sz)).astype(np.int32)
        batch["temporal_rays"] = np.broadcast_to(
            rays[:, None], (B, num_future, num_rays, RAY_DIM)).copy()
        batch["temporal_trajs"] = rng.normal(
            0, 1, (B, num_future, 2)).astype(np.float32)
    return batch


FRAME_KEYS = ("imgs", "sensor2egos", "ego2globals", "intrins", "post_rots",
              "post_trans")


def frame_batch(batch, t: int):
    """Frame `t` of a multi-frame batch (numpy arrays or tensors), as one
    streaming step takes it: the frame axis dropped, `bda` kept."""
    out = {k: batch[k][:, t] for k in FRAME_KEYS}
    out["bda"] = batch["bda"]
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors on `device`, under the span `upload`,
    counting the bytes handed over (`upload_bytes`). For a CUDA device each
    key is copied into pinned memory and sent on asynchronously. Then:
    every byte has left the caller's arrays when the call returns
    (`pin_memory()` copies synchronously); the tensors are ready in
    current-stream order; a pinned block is not reused until its copy's
    event has passed (the caching host allocator's guarantee); shapes and
    dtypes are those of `torch.from_numpy(np.ascontiguousarray(v))`, so a
    0-d array arrives as shape (1,)."""
    device = torch.device(device)
    out = {}
    with trace.span("upload"):
        for k, v in batch.items():
            a = np.ascontiguousarray(v)
            trace.count("upload_bytes", a.nbytes)
            t = torch.from_numpy(a)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out
