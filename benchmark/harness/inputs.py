"""Weights and traffic, both drawn from the run's seed.

Weights: one state dict for the program and the reference, drawn on the
run's device from one `torch.Generator` in one call and cut into the
entries of the reference's state dict (names and shapes from a model
built on the meta device). Products' weights are N(0, 1) times
gain / sqrt(fan in) (gain sqrt(2) for convolutions, 1 for linear
layers), norm scales 1 + 0.1 N(0, 1), biases and the relative-position
tables 0.02 N(0, 1), BatchNorm running means 0.1 N(0, 1) and running
variances 1 + 0.1 |N(0, 1)|.

Traffic: one general generator (`Traffic`, made by `make_traffic`) reads
a mix file of `benchmark/traffic/` and builds host inputs as the data pipeline hands
them over: numpy arrays, images float32 and normalised. A pool of camera
images is drawn once; the requests (or frames, or batches) take their
images from a ring of distinct sets built from the pool, so that no two
consecutive ones are equal, and their poses from one continuous drive:
the ego advances a step drawn from `ego_step_m` and turns by a yaw drawn
from `yaw_deg` each frame. Every seed gives the same shapes; only values
and the order of images differ.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

MASK64 = (1 << 63) - 1


def seed_of(seed: int, *salt: int) -> int:
    """A 63-bit seed for torch from the run's seed and a salt."""
    return int(np.random.SeedSequence([seed & ((1 << 64) - 1), *salt])
               .generate_state(1, np.uint64)[0]) & MASK64


def make_state_dict(meta_model: torch.nn.Module, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    sd = meta_model.state_dict()
    floats = [k for k, v in sd.items() if v.is_floating_point()]
    total = sum(sd[k].numel() for k in floats)
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 1))
    flat = torch.randn(total, generator=g, device=device)
    out, i = {}, 0
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        z = flat[i:i + v.numel()].view(v.shape)
        i += v.numel()
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            z.mul_(0.1)
        elif leaf == "running_var":
            z.abs_().mul_(0.1).add_(1.0)
        elif v.dim() >= 2 and leaf == "weight":
            fan_in = v.numel() // v.shape[0]
            gain = math.sqrt(2.0) if v.dim() > 2 else 1.0
            z.mul_(gain / math.sqrt(fan_in))
        elif leaf == "weight":
            z.mul_(0.1).add_(1.0)
        else:
            z.mul_(0.02)
        out[k] = z
    return out


def camera_rig(num_cams: int, input_size):
    """An outward-facing ring of pinhole cameras at 1.5 m, focal length
    0.8 W (nuScenes' front camera: 0.79 W at 1408 wide)."""
    H, W = input_size
    s2e = np.zeros((num_cams, 4, 4), np.float32)
    intrin = np.zeros((num_cams, 3, 3), np.float32)
    f = W * 0.8
    for n in range(num_cams):
        a = 2 * np.pi * n / num_cams
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([-np.sin(a), np.cos(a), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        s2e[n, :3, :3] = np.stack([right, down, fwd], axis=1)
        s2e[n, :3, 3] = [0.0, 0.0, 1.5]
        s2e[n, 3, 3] = 1.0
        intrin[n] = [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]
    return s2e, intrin


def drive(rng: np.random.Generator, n: int, step_m, yaw_deg) -> np.ndarray:
    """(n, 4, 4) f32 ego-to-global poses of one continuous drive."""
    x = y = 0.0
    h = rng.uniform(-np.pi, np.pi)
    out = np.zeros((n, 4, 4), np.float32)
    for k in range(n):
        c, s = math.cos(h), math.sin(h)
        out[k] = [[c, -s, 0, x], [s, c, 0, y], [0, 0, 1, 0], [0, 0, 0, 1]]
        d = rng.uniform(*step_m)
        x, y = x + d * c, y + d * s
        h += math.radians(rng.uniform(*yaw_deg))
    return out


class Traffic:
    """Host inputs of one cell: `mix` is the traffic file's dict, `sizes`
    the configuration's, `batch` the samples of a request or a step."""

    def __init__(self, mix: Dict, sizes: Dict, seed: int, batch: int = 1,
                 labels=(), rays_per_sample: int = 0, device="cpu"):
        self.mix, self.sizes, self.batch = mix, sizes, batch
        self.labels, self.rays = tuple(labels), rays_per_sample
        self.rng = np.random.default_rng([seed & ((1 << 64) - 1), 2])
        H, W = sizes["input_size"]
        self.N = sizes["num_cams"]
        self.T = sizes["temporal_frames"] + sizes["extra_ref_frames"]
        g = torch.Generator(device=device)
        g.manual_seed(seed_of(seed, 3))
        self.pool = torch.randn((mix["image_pool"], H, W, 3), generator=g,
                                device=device).cpu().numpy()
        self.s2e, self.intrin = camera_rig(self.N, (H, W))
        n_poses = mix["max_frames"] + self.T
        self.drives = [drive(self.rng, n_poses, mix["ego_step_m"],
                             mix["yaw_deg"]) for _ in range(batch)]
        self.ring = [self._images() for _ in range(mix["ring"])]
        self.label_ring = [self._labels() for _ in range(mix["ring"])] \
            if self.labels else None

    def _images(self) -> np.ndarray:
        """(B, frames, N, H, W, 3) drawn from the pool; (B, N, H, W, 3)
        where the mix's `inputs` are single frames."""
        one = self.mix.get("inputs") == "frame"
        per = 1 if one else self.T
        idx = self.rng.integers(0, len(self.pool), self.batch * per * self.N)
        imgs = self.pool[idx].reshape(self.batch, per, self.N,
                                      *self.pool.shape[1:])
        return imgs[:, 0] if one else imgs

    def _cams(self, poses: np.ndarray) -> Dict[str, np.ndarray]:
        """Camera tensors for per-sample pose stacks (B, T, 4, 4)."""
        B, T = poses.shape[:2]
        N = self.N
        e2g = np.broadcast_to(poses[:, :, None], (B, T, N, 4, 4)).copy()
        return {
            "sensor2egos": np.broadcast_to(self.s2e, (B, T, N, 4, 4)).copy(),
            "ego2globals": e2g,
            "intrins": np.broadcast_to(self.intrin, (B, T, N, 3, 3)).copy(),
            "post_rots": np.broadcast_to(np.eye(3, dtype=np.float32),
                                         (B, T, N, 3, 3)).copy(),
            "post_trans": np.zeros((B, T, N, 3), np.float32),
        }

    def _labels(self) -> Dict[str, np.ndarray]:
        """Labels of one batch. Each sample is a scene of its own: a share
        of free voxels drawn from `free_share`, the other classes' mix from
        a Dirichlet of concentration `class_concentration`, the lidar's
        share of pixels from `lidar_share`; its rays' semantic classes
        follow its scene's mix."""
        s, rng, B, mix = self.sizes, self.rng, self.batch, self.mix
        g = s["grid"]
        shape = tuple(int(round((a[1] - a[0]) / a[2]))
                      for a in (g["x"], g["y"], g["z"]))
        H, W = s["input_size"]
        n = s["num_classes"]
        out = {k: [] for k in self.labels}
        for _ in range(B):
            free = rng.uniform(*mix["free_share"])
            w = rng.dirichlet(np.full(n - 1, mix["class_concentration"]))
            if "voxel_semantics" in self.labels:
                p = np.append(w * (1.0 - free), free)
                out["voxel_semantics"].append(rng.choice(
                    n, size=shape, p=p / p.sum()).astype(np.int32))
            if "mask_camera" in self.labels:
                out["mask_camera"].append(rng.uniform(size=shape) > 0.3)
            if "gt_depth" in self.labels:
                lo, hi = g["depth"][0], g["depth"][1]
                share = rng.uniform(*mix["lidar_share"])
                out["gt_depth"].append(np.where(
                    rng.uniform(size=(self.N, H, W)) < share,
                    rng.uniform(lo + 0.5, hi - 1.0, (self.N, H, W)),
                    0.0).astype(np.float32))
            if "rays" in self.labels:
                R = self.rays
                rays = np.zeros((R, 16), np.float32)
                rays[:, 0] = rng.integers(0, W, R)
                rays[:, 1] = rng.integers(0, H, R)
                rays[:, 2] = rng.uniform(1.0, 45.0, R)
                rays[:, 3] = rng.choice(n - 1, size=R, p=w / w.sum())
                o = rng.uniform(-1.0, 1.0, (R, 3))
                o[:, 2] = 1.5
                d = rng.normal(size=(R, 3))
                d[:, 2] *= 0.1
                rays[:, 4:7] = o
                rays[:, 7:10] = d
                rays[:, 10:13] = d / np.linalg.norm(d, axis=-1, keepdims=True)
                rays[:, 13:16] = rng.uniform(0, 1, (R, 3))
                out["rays"].append(rays)
        return {k: np.stack(v) for k, v in out.items()}

    def poses(self, k: int) -> np.ndarray:
        """(B, T, 4, 4): the key frame at drive step k + T - 1, then the
        earlier frames."""
        top = k + self.T - 1
        return np.stack([d[top - np.arange(self.T)] for d in self.drives])

    def request(self, k: int) -> Dict[str, np.ndarray]:
        """Request / batch k: a T-frame input (plus the labels)."""
        out = {"imgs": self.ring[k % len(self.ring)]}
        out.update(self._cams(self.poses(k)))
        out["bda"] = np.broadcast_to(np.eye(3, dtype=np.float32),
                                     (self.batch, 3, 3)).copy()
        if self.label_ring is not None:
            out.update(self.label_ring[k % len(self.ring)])
        return out

    def frame(self, k: int) -> Dict[str, np.ndarray]:
        """Streaming frame k: one frame's input at drive step k."""
        poses = np.stack([d[k] for d in self.drives])[:, None]
        cams = {key: v[:, 0] for key, v in self._cams(poses).items()}
        out = {"imgs": self.ring[k % len(self.ring)]}
        out.update(cams)
        out["bda"] = np.broadcast_to(np.eye(3, dtype=np.float32),
                                     (self.batch, 3, 3)).copy()
        return out


def make_traffic(config: Dict, mix: Dict, seed: int, device) -> Traffic:
    """The cell's traffic. The batch is the mix's `batch`: a number
    (default 1), or "train", the configuration's training batch: its
    `train.batch` samples with `train.labels` and `train.rays` rays a
    sample."""
    batch = mix.get("batch", 1)
    if batch != "train":
        return Traffic(mix, config["sizes"], seed, batch=int(batch),
                       device=device)
    t = config["train"]
    return Traffic(mix, config["sizes"], seed, batch=t["batch"],
                   labels=t["labels"], rays_per_sample=t.get("rays", 0),
                   device=device)


def sample_indices(seed: int, count: int, lo: int, hi: int) -> List[int]:
    """`count` distinct window indices in [lo, hi), drawn from the seed."""
    rng = np.random.default_rng([seed & ((1 << 64) - 1), 4])
    return sorted(int(i) for i in rng.choice(np.arange(lo, hi), count,
                                             replace=False))
